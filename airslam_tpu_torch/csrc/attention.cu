// Kernel F: masked multi-head attention, softmax(q kT / sqrt(D), masked keys
// -> -1e9) v, fused so that the (Nq, Nk) logits never reach device memory.
//
// Replaces the Pallas TPU kernel airslam_tpu/ops/attention.py:_flash_kernel
// (flash_mha), which LightGlue's self and cross blocks call with
// use_flash=True: 36 calls per match, q/k/v (H=4, N=400, D=64). The TPU
// kernel holds one head's whole K and V in VMEM and runs one program per
// head; a Hopper block has at most 227 KB of shared memory, so here K and V
// pass through shared memory in tiles of 64 keys and the softmax is the
// online form: a running row maximum m and row sum l in f32, the accumulator
// rescaled by exp(m_old - m_new) at every tile.
//
// What it computes is the TPU kernel's arithmetic (attention.py:49-61):
//   k in q's type (the wrapper casts); logits = (q . k) accumulated in f32,
//   divided by sqrt(D) in f32 (for D = 64 a multiply by 0.125, the same
//   bits); masked keys REPLACED by -1e9 (not -inf: a row whose keys are all
//   masked gives the plain mean of v), keys beyond Nk -inf; p = exp(logits -
//   max); the row sum is taken over the unrounded p; p is rounded to v's type
//   before the second product; the division by the row sum comes last; output
//   in q's type. With the online form the rounding of p happens against the
//   running maximum instead of the final one: the only place where the result
//   can leave the plain version by more than f32 rounding.
//
// Layout: q, k, v are (B, H, N, D) views given by element strides (batch,
// head, row; the last dimension contiguous), so the transposed views that
// LightGlue's heads_first makes of (B, N, H*D) projections are read in place.
// Every row must start on 16 bytes (the wrapper checks it and copies a view
// that does not). The mask is (B, Nk) bytes, shared by the heads. The output
// is written as (B, Nq, H, D), the layout the block's merge wants next.
//
// Two routes, chosen by the operand types:
//
// * bf16 q, k and v (what LightGlue's bf16 program runs): tensor cores,
//   mma.sync m16n8k16 bf16 -> f32. One warp owns 16 query rows and keeps
//   their Q fragments in registers for the whole key loop; a block holds
//   kMmaWarps such warps (4, the fastest of 1-4 at the path's shape in
//   chip_smoke.py's sweep: the warps of a block share each K/V tile's
//   loads, and the time is one block's chain over the tiles, not the
//   number of blocks in flight). S = Q K^T of a 64-key tile is 4 x 8 MMAs (D = 64),
//   the online softmax runs on the accumulator fragment in f32, and p is
//   rounded to bf16 in registers and used directly as the A operand of the
//   PV product (the C layout of m16n8k16 is the A layout of the next one).
//   K and V tiles come from global memory by 16-byte cp.async into an
//   XOR-swizzled shared layout read with ldmatrix (.trans for V), two stages:
//   tile t+1 loads while tile t is multiplied.
// * f32 q/k (with f32 or bf16 v), or bf16 q/k with f32 v: full f32 products
//   on the CUDA cores (the TPU kernel runs f32 at Precision.HIGHEST; no
//   TF32). 16 query rows per block of 128 threads; a thread computes a 2 x 4
//   micro-tile of S (keys kg, kg+16, ...) and a 2 x D/16 micro-tile of the
//   output from 16-byte shared-memory reads, p passes through shared memory
//   within the half-warp that owns the rows; the same two-stage cp.async
//   pipeline over the key tiles.
//
// Every sum runs in a fixed order (fixed MMA and serial chains, butterflies
// over the lanes that share a row), no atomics, no split over keys: two runs
// give the same bits.
//
// Bound on the H100 at the path's shape (B=2, H=4, N=400, D=64): 1.6 MB of
// bf16 operands and 0.33 GFLOP, i.e. about 0.5 us of memory traffic and
// less of tensor-core time; in f32 about 5 us of CUDA-core time. At this
// size neither is reached: the time is each block's dependent chain over 7
// key tiles plus the launch, which is what the pipeline and the tensor cores
// shorten.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;             // keys per shared-memory tile
constexpr int kMmaWarps = 4;        // bf16 route: warps (x 16 query rows) per block, by sweep
constexpr int kSimtThreads = 128;   // f32 route: threads per block
constexpr int kSimtRows = 16;       // f32 route: query rows per block
constexpr float kMasked = -1e9f;
constexpr unsigned kFull = 0xffffffffu;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// x rounded to T and widened back
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

// logits / sqrt(D) in f32; 1/8 is exact, so for D = 64 the multiply gives
// the bits of the division
template <int D>
__device__ __forceinline__ float scaled(float s) {
  if constexpr (D == 64) return s * 0.125f;
  else return s / sqrtf(static_cast<float>(D));
}

// key state in a tile: 1 live, 0 masked, -1 beyond Nk
__device__ __forceinline__ float logit_of(float s, int state) {
  return state > 0 ? s : (state == 0 ? kMasked : -CUDART_INF_F);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (nothing is read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

__device__ __forceinline__ int key_state(const Args& a, const unsigned char* mask, int key) {
  return key >= a.nk ? -1 : ((mask != nullptr && mask[key] == 0) ? 0 : 1);
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                          uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr)
               : "memory");
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Element offset of 16-byte chunk `ch` of row `row` in a (kBK, D) bf16 tile.
// The chunk index is XOR-ed with a function of the row so that the 8 rows
// one ldmatrix phase reads (the same logical chunk) fall on 8 different bank
// groups: rows of 128 bytes (D = 64) use row & 7, rows of 64 bytes (D = 32)
// share a 128-byte line in pairs and use (row >> 1) & 3.
template <int D>
__device__ __forceinline__ int swz(int row, int ch) {
  constexpr int kCpr = D / 8;  // chunks per row
  return row * D + ((ch ^ ((row / (8 / kCpr)) % kCpr)) * 8);
}

template <int D, int W>
__global__ void __launch_bounds__(W * 32) flash_mma_kernel(const Args a) {
  static_assert(D == 32 || D == 64, "head dimension 32 or 64");
  constexpr int kNT = W * 32;
  constexpr int kCpr = D / 8;   // 16-byte chunks per row
  constexpr int kKS = D / 16;   // k-steps of Q K^T; pairs of 8-column tiles of O
  constexpr int kSPT = (kBK + kNT - 1) / kNT;  // key states per thread and tile
  __shared__ __align__(128) bf16 k_s[2][kBK * D];
  __shared__ __align__(128) bf16 v_s[2][kBK * D];
  __shared__ signed char st_s[2][kBK];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;  // fragment row group, column pair
  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * (16 * W) + warp * 16;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.v_sb + h * a.v_sh;
  const unsigned char* mask = a.mask ? a.mask + b * a.m_sb : nullptr;

  auto load_tile = [&](int stage, int k0) {
    for (int i = tid; i < kBK * kCpr; i += kNT) {
      const int r = i / kCpr, ch = i % kCpr;
      const bool ok = k0 + r < a.nk;
      const long long key = ok ? k0 + r : 0;
      cp_async16(&k_s[stage][swz<D>(r, ch)], k + key * a.k_sn + ch * 8, ok);
      cp_async16(&v_s[stage][swz<D>(r, ch)], v + key * a.v_sn + ch * 8, ok);
    }
    cp_async_commit();
  };

  load_tile(0, 0);
  for (int j = tid; j < kBK; j += kNT) st_s[0][j] = key_state(a, mask, j);

  // the warp's Q fragments (A layout: rows g and g + 8, columns 2c, 2c + 1
  // and 2c + 8, 2c + 9 of each 16-wide k-step); rows beyond Nq repeat the
  // last one and are never stored
  uint32_t qa[kKS][4];
  {
    const long long ra = min(row0 + g, a.nq - 1), rb = min(row0 + g + 8, a.nq - 1);
    const uint32_t* qra = reinterpret_cast<const uint32_t*>(q + ra * a.q_sn);
    const uint32_t* qrb = reinterpret_cast<const uint32_t*>(q + rb * a.q_sn);
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      qa[kk][0] = qra[8 * kk + c];
      qa[kk][1] = qrb[8 * kk + c];
      qa[kk][2] = qra[8 * kk + 4 + c];
      qa[kk][3] = qrb[8 * kk + 4 + c];
    }
  }

  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.0f, 0.0f};
  float o[2 * kKS][4];
#pragma unroll
  for (int j = 0; j < 2 * kKS; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;

  // ldmatrix.x4: lanes 8i..8i+7 address the rows of matrix i
  const int mi = lane >> 3, mr = lane & 7;
  const int ntiles = (a.nk + kBK - 1) / kBK;
  for (int t = 0; t < ntiles; ++t) {
    const int cur = t & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    const bool more = t + 1 < ntiles;
    signed char nxt[kSPT];
    if (more) {  // overlaps the products of tile t
      load_tile(cur ^ 1, (t + 1) * kBK);
#pragma unroll
      for (int i = 0; i < kSPT; ++i) {
        const int j = tid + i * kNT;
        if (j < kBK) nxt[i] = key_state(a, mask, (t + 1) * kBK + j);
      }
    }

    // S = Q K^T: 8 tiles of 8 keys; matrices 0/1: keys 16jj + 0..7 at
    // chunks 2kk / 2kk + 1, matrices 2/3: keys 16jj + 8..15
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int row = 16 * jj + (mi >> 1) * 8 + mr;
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_u32(&k_s[cur][swz<D>(row, 2 * kk + (mi & 1))]), b0, b1, b2, b3);
        mma_bf16(s[2 * jj], qa[kk], b0, b1);
        mma_bf16(s[2 * jj + 1], qa[kk], b2, b3);
      }
    }

    // online softmax on the fragment: s[j][0..1] is row g, s[j][2..3] row
    // g + 8, keys 8j + 2c and 8j + 2c + 1; the 4 lanes of a quad share a row
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int st = st_s[cur][8 * j + 2 * c + e];
        s[j][e] = logit_of(scaled<D>(s[j][e]), st);
        s[j][2 + e] = logit_of(scaled<D>(s[j][2 + e]), st);
        mx[0] = fmaxf(mx[0], s[j][e]);
        mx[1] = fmaxf(mx[1], s[j][2 + e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      // key 0 lies in the first tile, so the maximum is finite from there on
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);  // 0 at the first tile
      m[r] = m_new;
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = expf(s[j][e] - m[0]);
        s[j][2 + e] = expf(s[j][2 + e] - m[1]);
        sum[0] += s[j][e];
        sum[1] += s[j][2 + e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // a + b is commutative: every lane of the quad ends with the same bits
      sum[r] += __shfl_xor_sync(kFull, sum[r], 1);
      sum[r] += __shfl_xor_sync(kFull, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int j = 0; j < 2 * kKS; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += p V: p rounded to bf16 is the A operand of keys 16kk..16kk + 15;
    // V by ldmatrix.trans, matrices 0/1: keys +0..7 / +8..15 at chunk 2dp,
    // matrices 2/3 at chunk 2dp + 1
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kKS; ++dp) {
        const int row = 16 * kk + (mi & 1) * 8 + mr;
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(smem_u32(&v_s[cur][swz<D>(row, 2 * dp + (mi >> 1))]), b0, b1, b2, b3);
        mma_bf16(o[2 * dp], pa, b0, b1);
        mma_bf16(o[2 * dp + 1], pa, b2, b3);
      }
    }
    if (more) {
#pragma unroll
      for (int i = 0; i < kSPT; ++i) {
        const int j = tid + i * kNT;
        if (j < kBK) st_s[cur ^ 1][j] = nxt[i];
      }
    }
  }

  bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= a.nq) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(
        out + ((static_cast<long long>(b) * a.nq + row) * a.heads + h) * D);
#pragma unroll
    for (int j = 0; j < 2 * kKS; ++j)
      dst[4 * j + c] = pack_bf16(o[j][2 * r] / l[r], o[j][2 * r + 1] / l[r]);
  }
}

// ---------------------------------------------------------------------------
// f32 route: CUDA cores, register micro-tiles
// ---------------------------------------------------------------------------

// 16-byte chunks of a row are read as 4 or 8 widened values
__device__ __forceinline__ void widen(const float* p, float* x, int n) {
  for (int i = 0; i < n; i += 4) {
    const float4 u = *reinterpret_cast<const float4*>(p + i);
    x[i] = u.x;
    x[i + 1] = u.y;
    x[i + 2] = u.z;
    x[i + 3] = u.w;
  }
}
__device__ __forceinline__ void widen(const bf16* p, float* x, int n) {
  for (int i = 0; i < n; i += 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p + i);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
    x[i] = __low2float(lo);
    x[i + 1] = __high2float(lo);
    x[i + 2] = __low2float(hi);
    x[i + 3] = __high2float(hi);
  }
}

// padded row length (elements) of a shared tile: 16 bytes more than D, so
// that the rows 8 lanes read at one column fall on different bank groups
template <typename T, int D>
__host__ __device__ constexpr int padded() { return D + 16 / static_cast<int>(sizeof(T)); }

template <typename TQ, typename TV, int D>
__host__ __device__ constexpr int simt_smem_bytes() {
  return 4 * (kSimtRows * D + kSimtRows * kBK) +
         2 * kBK * (padded<TQ, D>() * static_cast<int>(sizeof(TQ)) +
                    padded<TV, D>() * static_cast<int>(sizeof(TV))) +
         2 * kBK;
}

// TQ: type of q, k and the output; TV: type of v
template <typename TQ, typename TV, int D>
__global__ void __launch_bounds__(kSimtThreads) flash_simt_kernel(const Args a) {
  static_assert(D == 32 || D == 64, "head dimension 32 or 64");
  static_assert(kSimtThreads == 8 * kSimtRows, "a half-warp per pair of rows");
  constexpr int kKP = padded<TQ, D>(), kVP = padded<TV, D>();
  constexpr int kEQ = 16 / sizeof(TQ), kEV = 16 / sizeof(TV);  // elements per chunk
  constexpr int kDC = D / 16;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);      // (16, D), widened
  float* p_s = q_s + kSimtRows * D;                  // (16, kBK), p in v's precision
  TQ* k_s = reinterpret_cast<TQ*>(p_s + kSimtRows * kBK);  // 2 stages of (kBK, kKP)
  TV* v_s = reinterpret_cast<TV*>(k_s + 2 * kBK * kKP);    // 2 stages of (kBK, kVP)
  signed char* st_s = reinterpret_cast<signed char*>(v_s + 2 * kBK * kVP);  // (2, kBK)

  const int tid = threadIdx.x;
  const int rp = tid >> 4, kg = tid & 15;  // rows 2rp, 2rp + 1; keys kg + 16i; columns kg·kDC
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kSimtRows;
  const TQ* q = static_cast<const TQ*>(a.q) + b * a.q_sb + h * a.q_sh;
  const TQ* k = static_cast<const TQ*>(a.k) + b * a.k_sb + h * a.k_sh;
  const TV* v = static_cast<const TV*>(a.v) + b * a.v_sb + h * a.v_sh;
  const unsigned char* mask = a.mask ? a.mask + b * a.m_sb : nullptr;

  auto load_tile = [&](int stage, int k0) {
    for (int i = tid; i < kBK * (D / kEQ); i += kSimtThreads) {
      const int r = i / (D / kEQ), ch = i % (D / kEQ);
      const bool ok = k0 + r < a.nk;
      const long long key = ok ? k0 + r : 0;
      cp_async16(k_s + (stage * kBK + r) * kKP + ch * kEQ, k + key * a.k_sn + ch * kEQ, ok);
    }
    for (int i = tid; i < kBK * (D / kEV); i += kSimtThreads) {
      const int r = i / (D / kEV), ch = i % (D / kEV);
      const bool ok = k0 + r < a.nk;
      const long long key = ok ? k0 + r : 0;
      cp_async16(v_s + (stage * kBK + r) * kVP + ch * kEV, v + key * a.v_sn + ch * kEV, ok);
    }
    cp_async_commit();
  };

  load_tile(0, 0);
  if (tid < kBK) st_s[tid] = key_state(a, mask, tid);
  // the block's query rows, widened; rows beyond Nq repeat the last one
  for (int i = tid; i < kSimtRows * (D / kEQ); i += kSimtThreads) {
    const int r = i / (D / kEQ), ch = i % (D / kEQ);
    const long long row = min(row0 + r, a.nq - 1);
    widen(q + row * a.q_sn + ch * kEQ, q_s + r * D + ch * kEQ, kEQ);
  }

  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.0f, 0.0f};
  float acc[2][kDC];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < kDC; ++j) acc[r][j] = 0.0f;

  const int ntiles = (a.nk + kBK - 1) / kBK;
  for (int t = 0; t < ntiles; ++t) {
    const int cur = t & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t is in; every thread is done with tile t - 1
    const bool more = t + 1 < ntiles;
    int nxt = 0;
    if (more) {  // overlaps the products of tile t
      load_tile(cur ^ 1, (t + 1) * kBK);
      if (tid < kBK) nxt = key_state(a, mask, (t + 1) * kBK + tid);
    }
    const TQ* kt = k_s + cur * kBK * kKP;
    const TV* vt = v_s + cur * kBK * kVP;

    // logits of rows 2rp, 2rp + 1 against keys kg + 16i, serial over D
    float s[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r) s[r][0] = s[r][1] = s[r][2] = s[r][3] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 qa = *reinterpret_cast<const float4*>(q_s + (2 * rp) * D + d);
      const float4 qb = *reinterpret_cast<const float4*>(q_s + (2 * rp + 1) * D + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float kv[4];
        widen(kt + (kg + 16 * i) * kKP + d, kv, 4);
        s[0][i] = fmaf(qa.x, kv[0], s[0][i]);
        s[1][i] = fmaf(qb.x, kv[0], s[1][i]);
        s[0][i] = fmaf(qa.y, kv[1], s[0][i]);
        s[1][i] = fmaf(qb.y, kv[1], s[1][i]);
        s[0][i] = fmaf(qa.z, kv[2], s[0][i]);
        s[1][i] = fmaf(qb.z, kv[2], s[1][i]);
        s[0][i] = fmaf(qa.w, kv[3], s[0][i]);
        s[1][i] = fmaf(qb.w, kv[3], s[1][i]);
      }
    }

    // online softmax; the 16 lanes of a half-warp share the two rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[r][i] = logit_of(scaled<D>(s[r][i]), st_s[cur * kBK + kg + 16 * i]);
        mx = fmaxf(mx, s[r][i]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m[r], mx);  // finite from the first tile on
      const float alpha = expf(m[r] - m_new);
      m[r] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(s[r][i] - m_new);
        sum += p;
        p_s[(2 * rp + r) * kBK + kg + 16 * i] = round_to<TV>(p);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int j = 0; j < kDC; ++j) acc[r][j] *= alpha;
    }
    __syncwarp();  // p of the half-warp's rows is in p_s

    // acc += p v over the tile's keys, serial
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      const float4 pa = *reinterpret_cast<const float4*>(p_s + (2 * rp) * kBK + j);
      const float4 pb = *reinterpret_cast<const float4*>(p_s + (2 * rp + 1) * kBK + j);
      const float p0[4] = {pa.x, pa.y, pa.z, pa.w}, p1[4] = {pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float vv[kDC < 4 ? 4 : kDC];
        if constexpr (kDC >= 4) {
          widen(vt + (j + e) * kVP + kg * kDC, vv, kDC);
        } else {
#pragma unroll
          for (int c = 0; c < kDC; ++c) vv[c] = to_f(vt[(j + e) * kVP + kg * kDC + c]);
        }
#pragma unroll
        for (int c = 0; c < kDC; ++c) {
          acc[0][c] = fmaf(p0[e], vv[c], acc[0][c]);
          acc[1][c] = fmaf(p1[e], vv[c], acc[1][c]);
        }
      }
    }
    if (more && tid < kBK) st_s[(cur ^ 1) * kBK + tid] = static_cast<signed char>(nxt);
  }

  TQ* out = static_cast<TQ*>(a.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 2 * rp + r;
    if (row >= a.nq) continue;
    TQ* o = out + ((static_cast<long long>(b) * a.nq + row) * a.heads + h) * D + kg * kDC;
#pragma unroll
    for (int c = 0; c < kDC; ++c) o[c] = from_f<TQ>(acc[r][c] / l[r]);
  }
}

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------

struct Plan {
  const void* fn;
  int threads, smem, rows;  // threads and dynamic shared bytes per block, query rows per block
};

template <int D, int W>
Plan mma_plan() {
  return {reinterpret_cast<const void*>(&flash_mma_kernel<D, W>), 32 * W, 0, 16 * W};
}

template <typename TQ, typename TV, int D>
Plan simt_plan() {
  return {reinterpret_cast<const void*>(&flash_simt_kernel<TQ, TV, D>), kSimtThreads,
          simt_smem_bytes<TQ, TV, D>(), kSimtRows};
}

template <int D>
Plan plan_d(int qk_bf16, int v_bf16, int warps) {
  if (qk_bf16 && v_bf16) {
    switch (warps) {
      case 1: return mma_plan<D, 1>();
      case 2: return mma_plan<D, 2>();
      case 3: return mma_plan<D, 3>();
      case 4: return mma_plan<D, 4>();
      default: return {nullptr, 0, 0, 0};
    }
  }
  if (qk_bf16) return simt_plan<bf16, float, D>();
  return v_bf16 ? simt_plan<float, bf16, D>() : simt_plan<float, float, D>();
}

// warps: query tiles of 16 rows per block on the bf16 route (0: the default)
Plan plan(int qk_bf16, int v_bf16, int d, int warps) {
  if (warps == 0) warps = kMmaWarps;
  if (d == 64) return plan_d<64>(qk_bf16, v_bf16, warps);
  if (d == 32) return plan_d<32>(qk_bf16, v_bf16, warps);
  return {nullptr, 0, 0, 0};
}

}  // namespace

// q (B, H, Nq, D), k and v (B, H, Nk, D) by element strides (batch, head, row;
// last dimension contiguous, every row on 16 bytes), q and k of one type,
// mask (B, Nk) bytes or null, out (B, Nq, H, D) contiguous in q's type; D is
// 32 or 64. q_warps: 16-row query tiles per block on the bf16 route (1-4; 0
// takes the default). Returns cudaGetLastError(), or cudaErrorInvalidValue
// for a size it does not take.
extern "C" int airslam_flash_mha(const void* q, const void* k, const void* v,
                                 const void* mask, void* out, int batch, int heads,
                                 int nq, int nk, int d, int qk_bf16, int v_bf16,
                                 long long q_sb, long long q_sh, long long q_sn,
                                 long long k_sb, long long k_sh, long long k_sn,
                                 long long v_sb, long long v_sh, long long v_sn,
                                 long long m_sb, int q_warps, void* stream) {
  if (batch <= 0 || heads <= 0 || nq <= 0) return 0;
  if (nk <= 0 || batch > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan(qk_bf16, v_bf16, d, q_warps);
  if (p.fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
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
  if (p.smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(p.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((nq + p.rows - 1) / p.rows, heads, batch);
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchKernel(p.fn, grid, dim3(p.threads), args, p.smem,
                                         static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// What the compiler gave the instantiation a launch with these types, D and
// q_warps runs: out = {registers per thread, static shared bytes, dynamic
// shared bytes, local (spill) bytes per thread, threads per block, query
// rows per block}. Returns a CUDA error code.
extern "C" int airslam_flash_mha_attributes(int qk_bf16, int v_bf16, int d, int q_warps,
                                            int* out) {
  const Plan p = plan(qk_bf16, v_bf16, d, q_warps);
  if (p.fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, p.fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = p.smem;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = p.threads;
  out[5] = p.rows;
  return 0;
}
