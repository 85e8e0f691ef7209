// Kernel F: masked multi-head attention, softmax(q kT / sqrt(D), masked keys
// -> -1e9) v, fused so that the (Nq, Nk) logits never reach device memory.
//
// Replaces the Pallas TPU kernel airslam_tpu/ops/attention.py:_flash_kernel
// (flash_mha), which LightGlue's self and cross blocks call with
// use_flash=True: 36 calls per match, q/k/v (H=4, N=400, D=64). The TPU
// kernel holds one head's whole K and V in VMEM and runs one program per
// head; a Hopper block has at most 227 KB of shared memory (one head's K and
// V in f32 at the engine's limit N=1024 are 512 KB), so here K and V pass
// through shared memory in tiles of 64 keys and the softmax is the online
// form: a running row maximum m and row sum l in f32, the accumulator
// rescaled by exp(m_old - m_new) at every tile.
//
// What it computes is the TPU kernel's arithmetic (attention.py:49-61):
//   k in q's type (the wrapper casts); logits = (q . k) in f32, divided by
//   sqrt(D) in f32; masked keys REPLACED by -1e9 (not -inf: a row whose keys
//   are all masked gives the plain mean of v); p = exp(logits - max); the row
//   sum is taken over the unrounded p; p is rounded to v's type before the
//   second product; the division by the row sum comes last; output in q's
//   type. bf16 operands are widened to f32 and multiplied there, which is
//   exact for bf16 x bf16, so one code path serves f32 and bf16. With the
//   online form the bf16 rounding of p happens against the running maximum
//   instead of the final one; that is the only place where the result can
//   leave the plain version by more than f32 rounding.
//
// Layout: q, k, v are (B, H, N, D) views given by element strides (batch,
// head, row; the last dimension contiguous), so the transposed views that
// LightGlue's heads_first makes of (B, N, H*D) projections are read in place.
// The mask is (B, Nk) bytes, shared by the heads. The output is written as
// (B, Nq, H, D), which is the layout the block's merge wants next.
//
// Grid: (ceil(Nq / 16), H, B); 4 warps per block, 4 query rows per warp.
// Within a warp a lane owns keys lane and lane + 32 of the tile for the
// logits, and output columns lane, lane + 32, ... for the second product;
// p reaches the other lanes by shuffle. Every sum runs in a fixed order (a
// serial chain over D, a butterfly over the lanes, a serial chain over the
// keys), so two runs give the same bits.
//
// Bound on the H100 at the path's shape (B=2, H=4, N=400, D=64): 1.6 MB of
// bf16 operands and 0.33 GFLOP, i.e. about 0.5 us of memory traffic and less
// of tensor-core time; in f32 about 5 us of CUDA-core time. This kernel runs
// its products on the CUDA cores out of shared memory and is nowhere near
// either: it is the simple version. Tensor cores (mma/wgmma), vector loads
// and a pipeline over the tiles are what a faster one needs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 4;            // warps per block
constexpr int kRows = 4;             // query rows per warp
constexpr int kBQ = kWarps * kRows;  // query rows per block
constexpr int kBK = 64;              // keys per shared-memory tile: 2 per lane
constexpr float kMasked = -1e9f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and widened back
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// butterfly sum: a + b is commutative in floating point, so every lane ends
// with the same bits
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const unsigned char* mask;  // (B, Nk) bytes or null
  void* out;                  // (B, Nq, H, D) contiguous, q's type
  int heads, nq, nk;
  long long q_sb, q_sh, q_sn;  // element strides: batch, head, row
  long long k_sb, k_sh, k_sn;
  long long v_sb, v_sh, v_sn;
  long long m_sb;              // mask batch stride
};

// TQ: type of q, k and the output; TV: type of v
template <typename TQ, typename TV, int D>
__global__ void __launch_bounds__(kWarps * 32) flash_kernel(const Args a) {
  constexpr int DL = D / 32;  // output columns per lane
  static_assert(D % 32 == 0, "head dimension must be a multiple of 32");
  __shared__ __align__(16) float q_s[kBQ][D];
  __shared__ float k_s[D][kBK + 1];  // transposed; +1: conflict-free stores
  __shared__ float v_s[kBK][D];
  __shared__ int state_s[kBK];  // 1 live, 0 masked, 2 beyond Nk

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kBQ;
  const TQ* q = static_cast<const TQ*>(a.q) + b * a.q_sb + h * a.q_sh;
  const TQ* k = static_cast<const TQ*>(a.k) + b * a.k_sb + h * a.k_sh;
  const TV* v = static_cast<const TV*>(a.v) + b * a.v_sb + h * a.v_sh;
  const unsigned char* mask = a.mask ? a.mask + b * a.m_sb : nullptr;

  // the block's query rows; rows beyond Nq repeat the last one, never stored
  for (int i = tid; i < kBQ * D; i += kWarps * 32) {
    const int r = i / D, d = i % D;
    const int row = min(row0 + r, a.nq - 1);
    q_s[r][d] = to_f(q[row * a.q_sn + d]);
  }

  float m[kRows], l[kRows], acc[kRows][DL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < DL; ++c) acc[r][c] = 0.0f;
  }
  const float scale = sqrtf(static_cast<float>(D));

  for (int k0 = 0; k0 < a.nk; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kBK * D; i += kWarps * 32) {
      const int j = i / D, d = i % D;
      const int key = k0 + j;
      float kv = 0.0f, vv = 0.0f;
      if (key < a.nk) {
        kv = to_f(k[key * a.k_sn + d]);
        vv = to_f(v[key * a.v_sn + d]);
      }
      k_s[d][j] = kv;
      v_s[j][d] = vv;
    }
    if (tid < kBK) {
      const int key = k0 + tid;
      state_s[tid] = key >= a.nk ? 2 : ((mask != nullptr && mask[key] == 0) ? 0 : 1);
    }
    __syncthreads();

    // logits of this warp's rows against the lane's two keys, serial over D
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float ka[4], kb[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ka[e] = k_s[d + e][lane];
        kb[e] = k_s[d + e][lane + 32];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(&q_s[warp * kRows + r][d]);
        s[r][0] = fmaf(qv.x, ka[0], s[r][0]);
        s[r][1] = fmaf(qv.x, kb[0], s[r][1]);
        s[r][0] = fmaf(qv.y, ka[1], s[r][0]);
        s[r][1] = fmaf(qv.y, kb[1], s[r][1]);
        s[r][0] = fmaf(qv.z, ka[2], s[r][0]);
        s[r][1] = fmaf(qv.z, kb[2], s[r][1]);
        s[r][0] = fmaf(qv.w, ka[3], s[r][0]);
        s[r][1] = fmaf(qv.w, kb[3], s[r][1]);
      }
    }

    // online softmax per row
    const int st0 = state_s[lane], st1 = state_s[lane + 32];
    float p[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float s0 = st0 == 1 ? s[r][0] / scale : (st0 == 0 ? kMasked : -CUDART_INF_F);
      const float s1 = st1 == 1 ? s[r][1] / scale : (st1 == 0 ? kMasked : -CUDART_INF_F);
      // key 0 lies in the first tile, so m_new is finite from there on
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s0, s1)));
      const float alpha = expf(m[r] - m_new);  // 0 at the first tile
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DL; ++c) acc[r][c] *= alpha;
      p[r][0] = round_to<TV>(p0);
      p[r][1] = round_to<TV>(p1);
    }

    // acc += p . v, serial over the tile's keys
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll 4
      for (int jj = 0; jj < 32; ++jj) {
        const int j = half * 32 + jj;
        float vv[DL];
#pragma unroll
        for (int c = 0; c < DL; ++c) vv[c] = v_s[j][lane + 32 * c];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float pj = __shfl_sync(kFull, p[r][half], jj);
#pragma unroll
          for (int c = 0; c < DL; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
        }
      }
    }
  }

  TQ* out = static_cast<TQ*>(a.out);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + warp * kRows + r;
    if (row >= a.nq) continue;
    TQ* o = out + ((static_cast<long long>(b) * a.nq + row) * a.heads + h) * D;
#pragma unroll
    for (int c = 0; c < DL; ++c) o[lane + 32 * c] = from_f<TQ>(acc[r][c] / l[r]);
  }
}

template <typename TQ, typename TV>
int launch(const Args& a, int batch, int d, cudaStream_t s) {
  const dim3 grid((a.nq + kBQ - 1) / kBQ, a.heads, batch);
  const dim3 block(kWarps * 32);
  if (d == 64)
    flash_kernel<TQ, TV, 64><<<grid, block, 0, s>>>(a);
  else if (d == 32)
    flash_kernel<TQ, TV, 32><<<grid, block, 0, s>>>(a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H, Nq, D), k and v (B, H, Nk, D) by element strides (batch, head, row;
// last dimension contiguous), q and k of one type, mask (B, Nk) bytes or
// null, out (B, Nq, H, D) contiguous in q's type; D is 32 or 64. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a size it does not take.
extern "C" int airslam_flash_mha(const void* q, const void* k, const void* v,
                                 const void* mask, void* out, int batch, int heads,
                                 int nq, int nk, int d, int qk_bf16, int v_bf16,
                                 long long q_sb, long long q_sh, long long q_sn,
                                 long long k_sb, long long k_sh, long long k_sn,
                                 long long v_sb, long long v_sh, long long v_sn,
                                 long long m_sb, void* stream) {
  if (batch <= 0 || heads <= 0 || nq <= 0) return 0;
  if (nk <= 0 || batch > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = static_cast<const unsigned char*>(mask);
  a.out = out;
  a.heads = heads;
  a.nq = nq;
  a.nk = nk;
  a.q_sb = q_sb; a.q_sh = q_sh; a.q_sn = q_sn;
  a.k_sb = k_sb; a.k_sh = k_sh; a.k_sn = k_sn;
  a.v_sb = v_sb; a.v_sh = v_sh; a.v_sn = v_sn;
  a.m_sb = m_sb;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qk_bf16)
    return v_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(a, batch, d, s)
                  : launch<__nv_bfloat16, float>(a, batch, d, s);
  return v_bf16 ? launch<float, __nv_bfloat16>(a, batch, d, s)
                : launch<float, float>(a, batch, d, s);
}
