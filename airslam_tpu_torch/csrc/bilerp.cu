// Kernels B and T, and loi_features, their redesign for the H100: bilinear
// point sampling of (H, W, C) feature maps with the stage-1 LOI head's corner
// arithmetic.
//
// Replace the Pallas TPU kernels airslam_tpu/ops/bilerp_pallas.py:_kernel
// (bilerp_points, row-major (N, C) output; the LOI endpoint/junction features
// on the 128-channel LOI map) and :_kernel_t (bilerp_points_t, channel-major
// (C, N) output; the thin/aux interior features on the 4-channel maps). On
// the TPU both run as one-hot MXU contractions over a VMEM-resident map; here
// they are gathers: each output reads 4 taps.
//
// Bound on the H100: neither is near a roofline. B at the frontend's shape
// (300 points x 128 bf16 channels) moves ~0.46 MB, T (15,360 points x 4
// channels) ~0.86 MB; both are a few hundred ns of memory traffic, so launch
// latency bounds them, and the head that called them once per view paid a
// launch for every step around them too (junction offsets, index clamp, row
// gathers, the interior ramps, permutes, concatenations, casts).
//
// loi_features is the design for that bound: the stage-1 head's whole
// sampling for every view of a frame in ONE launch, written straight into
// the MLP's input row (V, L, 2*128 + 2*4*T) in the head's dtype:
//   columns [0, 128) endpoint 1, [128, 256) endpoint 2 (the LOI map at the
//   clamped pair_idx junctions - 0.5), 256 + c*T + t thin, 256 + 4*T + c*T + t
//   aux (the 4-channel maps at the interior points of lines / prop_lines).
// One warp per line, kLoiWarps lines per block (chip_smoke.py sweeps 1-8:
// within 3 % of each other). The endpoint lanes cover 2 x 128 channels in
// 16-byte chunks (8 bf16 or 4 f32 channels a tap); lane t < T forms interior
// point t in registers and reads each tap's 4 channels in one 8- or 16-byte
// load. Neighbouring lanes write neighbouring columns. What is left after
// the launch is a chain of dependent loads (pair index -> junction -> taps;
// segment -> taps); issuing the interior lanes' segment loads ahead of the
// endpoints' chain was measured and gained nothing. The taps' arithmetic is
// B's and T's (make_taps, combine below), so the fused kernel gives their
// results, not an approximation of them.
//
// B and T stay as entry points with the same vector loads: B one thread per
// (point, 16-byte chunk of channels), T one thread per point with one load
// per tap per 4 channels, wherever C and the map's alignment allow it; the
// scalar forms (one thread per (point, channel) / per point and channel)
// take the rest.
//
// Arithmetic (bilerp_pallas.py:53-76, :135-157):
//   x0 = clip(floor x, 0, W-1), x1 = clip(x0 + 1, 0, W-1), likewise y;
//   weights (x1 - x), (x - x0) UNclamped, so total weight is 0 at the far
//   border; when x0 == x1 the two taps ADD into one weight (same for y);
//   for bf16 maps the y weights are rounded to bf16 (the TPU kernel's
//   bf16 one-hot row matrix) and everything accumulates in f32; x weights
//   stay f32. Compiled with -fmad=false (ops/cuda_build.py): every product
//   and sum is rounded on its own, as in the plain versions, so the kernels
//   give their bits (with contraction, points beyond the border, whose
//   unclamped weights extrapolate, drifted past 1e-5 from the plain version).
//   loi_features forms the interior points s0*t_fwd + s2*t_rev - 0.5 with
//   explicitly rounded intrinsics, since one ulp there can move a floor.
//
// loi_features_backward (kernel B+T', below) is loi_features' gradient for
// training: f32 maps; the LOI map's gradient written once by the blocks
// that own its rows, the thin / aux maps' by 16-byte vector reductions, the
// ramps' from each interior sample's coordinate derivative.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLoiC = 128;    // LOI map channels (models/plnet.py LOI_DIM)
constexpr int kIntC = 4;      // thin / aux map channels
constexpr int kLoiWarps = 4;  // default lines (one warp each) per block of loi_features
constexpr int kLoiMaxWarps = 8;
constexpr int kThreads = 256; // block of B and T

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// the two bf16 values packed in a 32-bit word, widened exactly
__device__ __forceinline__ float lo_bf16(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// N consecutive channels of one texel in one load (16 or 8 bytes)
template <typename T, int N>
struct Chunk;
template <>
struct Chunk<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
};
template <>
struct Chunk<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = lo_bf16(a.x); v[1] = hi_bf16(a.x); v[2] = lo_bf16(a.y); v[3] = hi_bf16(a.y);
  }
};
template <>
struct Chunk<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    v[0] = lo_bf16(a.x); v[1] = hi_bf16(a.x); v[2] = lo_bf16(a.y); v[3] = hi_bf16(a.y);
    v[4] = lo_bf16(a.z); v[5] = hi_bf16(a.z); v[6] = lo_bf16(a.w); v[7] = hi_bf16(a.w);
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(b))) << 16);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// N consecutive outputs in 16-byte (or, 4 bf16, 8-byte) stores
template <int N>
__device__ __forceinline__ void store_chunk(float* p, const float* v) {
#pragma unroll
  for (int k = 0; k < N; k += 4)
    *reinterpret_cast<float4*>(p + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
}
template <int N>
__device__ __forceinline__ void store_chunk(__nv_bfloat16* p, const float* v) {
  if constexpr (N == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  } else {
#pragma unroll
    for (int k = 0; k < N; k += 8)
      *reinterpret_cast<uint4*>(p + k) =
          make_uint4(pack_bf16(v[k], v[k + 1]), pack_bf16(v[k + 2], v[k + 3]),
                     pack_bf16(v[k + 4], v[k + 5]), pack_bf16(v[k + 6], v[k + 7]));
  }
}

template <typename T>
__device__ __forceinline__ float row_weight(float w) { return w; }
template <>
__device__ __forceinline__ float row_weight<__nv_bfloat16>(float w) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

struct Taps {
  int y0, y1, x0, x1;
  float wy0, wy1, wx0, wx1;
};

template <typename T>
__device__ __forceinline__ Taps make_taps(float x, float y, int h, int w) {
  const float x0f = fminf(fmaxf(floorf(x), 0.0f), static_cast<float>(w - 1));
  const float x1f = fminf(fmaxf(x0f + 1.0f, 0.0f), static_cast<float>(w - 1));
  const float y0f = fminf(fmaxf(floorf(y), 0.0f), static_cast<float>(h - 1));
  const float y1f = fminf(fmaxf(y0f + 1.0f, 0.0f), static_cast<float>(h - 1));
  Taps t;
  t.x0 = static_cast<int>(x0f);
  t.x1 = static_cast<int>(x1f);
  t.y0 = static_cast<int>(y0f);
  t.y1 = static_cast<int>(y1f);
  float wy0 = y1f - y, wy1 = y - y0f;
  if (t.y0 == t.y1) { wy0 = wy0 + wy1; wy1 = 0.0f; }
  float wx0 = x1f - x, wx1 = x - x0f;
  if (t.x0 == t.x1) { wx0 = wx0 + wx1; wx1 = 0.0f; }
  t.wy0 = row_weight<T>(wy0);
  t.wy1 = row_weight<T>(wy1);
  t.wx0 = wx0;
  t.wx1 = wx1;
  return t;
}

// one channel from its taps (y0, x0), (y1, x0), (y0, x1), (y1, x1)
__device__ __forceinline__ float combine(const Taps& t, float f00, float f10, float f01,
                                         float f11) {
  const float a = t.wy0 * f00 + t.wy1 * f10;
  const float b = t.wy0 * f01 + t.wy1 * f11;
  return a * t.wx0 + b * t.wx1;
}

template <typename T>
__device__ __forceinline__ float sample(const T* __restrict__ f, const Taps& t,
                                        int w, int c, int ch) {
  const long long r0 = static_cast<long long>(t.y0) * w;
  const long long r1 = static_cast<long long>(t.y1) * w;
  return combine(t, load(f + (r0 + t.x0) * c + ch), load(f + (r1 + t.x0) * c + ch),
                 load(f + (r0 + t.x1) * c + ch), load(f + (r1 + t.x1) * c + ch));
}

// channels [ch0, ch0 + N): one load per tap
template <typename T, int N>
__device__ __forceinline__ void sample_chunk(const T* __restrict__ f, const Taps& t, int w,
                                             int c, int ch0, float* out) {
  const long long r0 = static_cast<long long>(t.y0) * w;
  const long long r1 = static_cast<long long>(t.y1) * w;
  float f00[N], f10[N], f01[N], f11[N];
  Chunk<T, N>::load(f + (r0 + t.x0) * c + ch0, f00);
  Chunk<T, N>::load(f + (r1 + t.x0) * c + ch0, f10);
  Chunk<T, N>::load(f + (r0 + t.x1) * c + ch0, f01);
  Chunk<T, N>::load(f + (r1 + t.x1) * c + ch0, f11);
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = combine(t, f00[k], f10[k], f01[k], f11[k]);
}

// Scalar forms, any C and alignment.
// CHANNEL_MAJOR = false: kernel B, out (N, C), one thread per (point, channel).
// CHANNEL_MAJOR = true:  kernel T, out (C, N), one thread per point.
template <typename T, bool CHANNEL_MAJOR>
__global__ void bilerp_kernel(const T* __restrict__ f,
                              const float* __restrict__ xs,
                              const float* __restrict__ ys,
                              float* __restrict__ out, int n, int h, int w,
                              int c) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (CHANNEL_MAJOR) {
    if (i >= n) return;
    const Taps t = make_taps<T>(__ldg(xs + i), __ldg(ys + i), h, w);
    for (int ch = 0; ch < c; ++ch) out[ch * static_cast<long long>(n) + i] = sample(f, t, w, c, ch);
  } else {
    if (i >= static_cast<long long>(n) * c) return;
    const int p = static_cast<int>(i / c);
    const int ch = static_cast<int>(i - static_cast<long long>(p) * c);
    const Taps t = make_taps<T>(__ldg(xs + p), __ldg(ys + p), h, w);
    out[i] = sample(f, t, w, c, ch);
  }
}

// Kernel B, C a multiple of N = 16 bytes of channels: one thread per (point,
// chunk), the taps computed once per chunk, one 16-byte load per tap.
template <typename T, int N>
__global__ void bilerp_rows_vec(const T* __restrict__ f, const float* __restrict__ xs,
                                const float* __restrict__ ys, float* __restrict__ out,
                                int n, int h, int w, int c) {
  const int chunks = c / N;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(n) * chunks) return;
  const int p = static_cast<int>(i / chunks);
  const int ch0 = static_cast<int>(i - static_cast<long long>(p) * chunks) * N;
  const Taps t = make_taps<T>(__ldg(xs + p), __ldg(ys + p), h, w);
  float v[N];
  sample_chunk<T, N>(f, t, w, c, ch0, v);
  store_chunk<N>(out + static_cast<long long>(p) * c + ch0, v);
}

// Kernel T, C a multiple of 4: one thread per point, one load per tap per
// 4 channels, each channel's plane written coalesced.
template <typename T>
__global__ void bilerp_cols_vec(const T* __restrict__ f, const float* __restrict__ xs,
                                const float* __restrict__ ys, float* __restrict__ out,
                                int n, int h, int w, int c) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Taps t = make_taps<T>(__ldg(xs + i), __ldg(ys + i), h, w);
  for (int ch0 = 0; ch0 < c; ch0 += 4) {
    float v[4];
    sample_chunk<T, 4>(f, t, w, c, ch0, v);
#pragma unroll
    for (int k = 0; k < 4; ++k) out[(ch0 + k) * static_cast<long long>(n) + i] = v[k];
  }
}

template <typename T>
void launch(const void* fmap, const float* x, const float* y, float* out,
            int n, int h, int w, int c, bool channel_major, cudaStream_t s) {
  constexpr int N = 16 / sizeof(T);
  const T* f = static_cast<const T*>(fmap);
  const bool aligned = reinterpret_cast<uintptr_t>(fmap) % 16 == 0;
  auto blocks = [](long long work) {
    return static_cast<unsigned>((work + kThreads - 1) / kThreads);
  };
  if (channel_major) {
    if (aligned && c % 4 == 0)
      bilerp_cols_vec<T><<<blocks(n), kThreads, 0, s>>>(f, x, y, out, n, h, w, c);
    else
      bilerp_kernel<T, true><<<blocks(n), kThreads, 0, s>>>(f, x, y, out, n, h, w, c);
  } else {
    if (aligned && c % N == 0)
      bilerp_rows_vec<T, N><<<blocks(static_cast<long long>(n) * (c / N)), kThreads, 0, s>>>(
          f, x, y, out, n, h, w, c);
    else
      bilerp_kernel<T, false><<<blocks(static_cast<long long>(n) * c), kThreads, 0, s>>>(
          f, x, y, out, n, h, w, c);
  }
}

// loi_features: one warp per (view, line). Maps (V, H, W, 128) and
// (V, H, W, 4) in T on 16 bytes; junc_xy (V, J, 2), lines / prop_lines
// (V, L, 4), t_fwd / t_rev (nt,) f32; pair_idx (V, L, 2) int64; out
// (V, L, 256 + 8 * nt) in TO.
template <typename T, typename TO>
__global__ void __launch_bounds__(kLoiMaxWarps * 32)
loi_features_kernel(const T* __restrict__ loi, const T* __restrict__ thin,
                    const T* __restrict__ aux, const float* __restrict__ junc_xy,
                    const long long* __restrict__ pair_idx, const float* __restrict__ lines,
                    const float* __restrict__ prop_lines, const float* __restrict__ t_fwd,
                    const float* __restrict__ t_rev, TO* __restrict__ out, int n_views,
                    int n_lines, int n_junc, int h, int w, int nt) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= static_cast<long long>(n_views) * n_lines) return;
  const long long view = row / n_lines;
  const long long texels = static_cast<long long>(h) * w;
  TO* o = out + row * (2 * kLoiC + 2 * kIntC * nt);

  // endpoints: the LOI map at each endpoint junction, 16-byte chunks
  constexpr int N = 16 / sizeof(T);
  constexpr int kChunks = kLoiC / N;  // per endpoint
  const T* f = loi + view * texels * kLoiC;
  for (int i = lane; i < 2 * kChunks; i += 32) {
    const int e = i / kChunks;
    const int ch0 = (i - e * kChunks) * N;
    long long j = __ldg(pair_idx + row * 2 + e);
    j = j < 0 ? 0 : (j >= n_junc ? n_junc - 1 : j);
    const float* p = junc_xy + (view * n_junc + j) * 2;
    const Taps t = make_taps<T>(__ldg(p) - 0.5f, __ldg(p + 1) - 0.5f, h, w);
    float v[N];
    sample_chunk<T, N>(f, t, w, kLoiC, ch0, v);
    store_chunk<N>(o + e * kLoiC + ch0, v);
  }

  // interior point `lane` of the junction line (thin) and of the proposal
  // (aux), channel-major columns
  if (lane < nt) {
    const float tf = __ldg(t_fwd + lane), tr = __ldg(t_rev + lane);
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const float* s = (b == 0 ? lines : prop_lines) + row * 4;
      const T* fm = (b == 0 ? thin : aux) + view * texels * kIntC;
      const float x = __fsub_rn(__fadd_rn(__fmul_rn(__ldg(s), tf), __fmul_rn(__ldg(s + 2), tr)), 0.5f);
      const float y = __fsub_rn(__fadd_rn(__fmul_rn(__ldg(s + 1), tf), __fmul_rn(__ldg(s + 3), tr)), 0.5f);
      const Taps t = make_taps<T>(x, y, h, w);
      float v[kIntC];
      sample_chunk<T, kIntC>(fm, t, w, kIntC, 0, v);
      TO* ob = o + 2 * kLoiC + b * kIntC * nt + lane;
#pragma unroll
      for (int c = 0; c < kIntC; ++c) store(ob + c * nt, v[c]);
    }
  }
}

const void* loi_kernel(int is_bf16, int out_bf16) {
  using bf = __nv_bfloat16;
  if (is_bf16)
    return out_bf16 ? reinterpret_cast<const void*>(&loi_features_kernel<bf, bf>)
                    : reinterpret_cast<const void*>(&loi_features_kernel<bf, float>);
  return out_bf16 ? reinterpret_cast<const void*>(&loi_features_kernel<float, bf>)
                  : reinterpret_cast<const void*>(&loi_features_kernel<float, float>);
}

template <typename T, typename TO>
void launch_loi(const void* loi, const void* thin, const void* aux, const float* junc_xy,
                const long long* pair_idx, const float* lines, const float* prop_lines,
                const float* t_fwd, const float* t_rev, void* out, int v, int l, int j, int h,
                int w, int nt, int warps, cudaStream_t s) {
  const long long rows = static_cast<long long>(v) * l;
  const unsigned blocks = static_cast<unsigned>((rows + warps - 1) / warps);
  loi_features_kernel<T, TO><<<blocks, warps * 32, 0, s>>>(
      static_cast<const T*>(loi), static_cast<const T*>(thin), static_cast<const T*>(aux),
      junc_xy, pair_idx, lines, prop_lines, t_fwd, t_rev, static_cast<TO*>(out), v, l, j, h, w,
      nt);
}

// loi_features_backward (B+T'): the gradient of loi_features for training,
// f32 maps only. No TPU kernel has it: the JAX trainer takes it from XLA's
// autodiff of the einsum sampler (airslam_tpu/models/plnet.py:428-491).
//
// The row's gradient g flows
//   - into the maps: each sample's four taps receive (g * wx) * wy (the
//     plain version's autograd order): the endpoints into d_loi through the
//     clamped pair_idx junctions, the interior points into d_thin / d_aux;
//   - into t_fwd / t_rev: point t sits at x = s0*t_fwd[t] + s2*t_rev[t] - 0.5
//     (likewise y with s1, s3), and with the forward's unclamped weights
//       d/dx = sum_c g_c (b_c - a_c),  a = wy0 f00 + wy1 f10, b = wy0 f01 + wy1 f11,
//       d/dy = sum_c g_c (wx0 (f10 - f00) + wx1 (f11 - f01)),
//     zero along an axis whose two taps clamp onto one texel (floor and clip
//     carry no gradient; the merged weights' derivatives cancel), so
//       d t_fwd[t] += dx s0 + dy s1,  d t_rev[t] += dx s2 + dy s3.
// Junctions, lines and proposals are data: no gradient.
//
// Bound: d_loi, V x H x W x 128 floats (67.1 MB at the training shape, 8
// views of 128 x 128), dwarfs everything else the call reads or writes (the
// row gradient 2.6 MB, d_thin / d_aux 4.2 MB), so one write of d_loi at the
// card's memory rate is the floor. What replaces the memset and the atomics
// on d_loi (the earlier design zeroed all five outputs, then scattered 2.6 M
// scalar atomicAdds; the zeroing of d_loi alone took 95 % of the bound):
//   - tile owners: the grid's last blocks each OWN one tile of one view's
//     d_loi, `tile` texels (default kBwdTile: one texel row). An owner
//     scans the view's 2 x L endpoint references (line l, endpoint e; index
//     2l + e) in passes of kSegment, each thread's loads issued together,
//     forms their taps, and lists in shared memory, in index order (a ballot
//     and a prefix over the block's warps), those with a tap in its tile;
//     it stages the first kStaged entries' 512-byte gradient rows in shared
//     memory. Then warp k takes the tile's texels k, k + 8, ...: lane c
//     holds channels 4c..4c+3 of the texel in registers, finds the list's
//     entries with a tap there 32 at a time (ballot), adds their
//     (g * wx) * wy in list order (a merged pair's second weight is 0, so
//     picking the tap's one weight is exact), and stores the texel's 512
//     bytes, zeros included, one 16-byte store a lane;
//   - so d_loi needs no atomics: each texel has one owner thread, which
//     writes it once (a tile touched by more than kSegment references is
//     read back and added to by the same threads on each further pass), and
//     its sums run in list order, so d_loi is the same bits from call to
//     call and for every tile size. A tile that many endpoints share makes
//     its owner slow, not wrong;
//   - the interior points take the grid's first blocks, one thread per
//     (view, line, branch, point), so that their latency hides under the
//     owners' stores: each tap's four channels go to d_thin / d_aux in one
//     16-byte vector reduction (sm_90's float4 atomicAdd, REDG.E.ADD.F32x4)
//     into the one buffer the wrapper zeroes for d_thin, d_aux, d_t_fwd and
//     d_t_rev (4.2 MB, the call's only memset); the ramps' sums gather per
//     block in shared memory, then one atomicAdd per block and ramp entry.
//     Those sums' order still varies from run to run.
// A call is one zero fill and one launch. What bounds it now is how fast
// the owners keep the memory busy: each owner scans and lists before its
// first store, four blocks fit a SM (64 registers, 45 KB of shared
// memory), and the interior blocks hold slots at the start, so d_loi
// streams out slower than a plain zero fill of its size (chip_smoke.py
// prints both, and sweeps the tile size). One-row tiles, staged gradient
// rows and interior blocks first were the fastest of the variants tried on
// the card (tiles of 16 texels to 16 rows, interior blocks last, one
// prefix for a whole pass, grouped gradient loads, cp.async staging, fewer
// registers by launch bounds).

constexpr int kBwdThreads = 256;  // block of loi_features_backward, both roles
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kSegment = 1024;    // endpoint references a tile owner lists per pass
constexpr int kRefsPerThread = kSegment / kBwdThreads;
constexpr int kStaged = 32;       // listed references whose gradient rows a pass stages
constexpr int kBwdTile = 128;     // default texels of d_loi a tile owner writes
constexpr int kBwdMaxTile = 2048;

struct TileList {  // one pass's references that touch the owner's tile, in index order
  int ref[kSegment];  // 2 * line + endpoint
  int ys[kSegment], xs[kSegment];  // y0 | y1 << 16, x0 | x1 << 16
  float wy0[kSegment], wy1[kSegment], wx0[kSegment], wx1[kSegment];
};

__device__ __forceinline__ int lo16(int v) { return v & 0xffff; }
__device__ __forceinline__ int hi16(int v) { return v >> 16; }

__device__ __forceinline__ bool inside(int v, int lo, int hi) { return v >= lo && v < hi; }

// The texels [y_lo, y_hi) x [x_lo, x_hi) of view `view` of d_loi, every one
// written once.
__device__ __forceinline__ void own_loi_tile(const float* __restrict__ grad,
                                             const float* __restrict__ junc_xy,
                                             const long long* __restrict__ pair_idx,
                                             float* __restrict__ d_loi, int view, int y_lo,
                                             int y_hi, int x_lo, int x_hi, int n_lines,
                                             int n_junc, int h, int w, int row_len,
                                             TileList& list, float4 (*staged)[32],
                                             int* counts) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_refs = 2 * n_lines;
  const int cols = x_hi - x_lo, texels = (y_hi - y_lo) * cols;
  const long long* pairs = pair_idx + static_cast<long long>(view) * n_refs;
  const float* junc = junc_xy + static_cast<long long>(view) * n_junc * 2;
  const float* g_view = grad + static_cast<long long>(view) * n_lines * row_len + lane * 4;
  float* out = d_loi + static_cast<long long>(view) * h * w * kLoiC + lane * 4;
  int seg = 0;
  do {
    const int end = min(seg + kSegment, n_refs);
    // this thread's references of the pass, their loads issued together
    long long j[kRefsPerThread];
    float jx[kRefsPerThread], jy[kRefsPerThread];
#pragma unroll
    for (int u = 0; u < kRefsPerThread; ++u) {
      const int i = seg + u * kBwdThreads + tid;
      j[u] = i < end ? __ldg(pairs + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < kRefsPerThread; ++u) {
      const long long c = j[u] < 0 ? 0 : (j[u] >= n_junc ? n_junc - 1 : j[u]);
      const bool live = seg + u * kBwdThreads + tid < end;
      jx[u] = live ? __ldg(junc + 2 * c) : 0.0f;
      jy[u] = live ? __ldg(junc + 2 * c + 1) : 0.0f;
    }
    int n = 0;  // entries listed in this pass, the same in every thread
#pragma unroll
    for (int u = 0; u < kRefsPerThread; ++u) {
      const int i = seg + u * kBwdThreads + tid;
      const Taps t = make_taps<float>(jx[u] - 0.5f, jy[u] - 0.5f, h, w);
      const bool hit = i < end && (inside(t.y0, y_lo, y_hi) || inside(t.y1, y_lo, y_hi)) &&
                       (inside(t.x0, x_lo, x_hi) || inside(t.x1, x_lo, x_hi));
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) counts[warp] = __popc(mask);
      __syncthreads();
      int at = n + __popc(mask & ((1u << lane) - 1u)), total = 0;
#pragma unroll
      for (int k = 0; k < kBwdWarps; ++k) {
        at += k < warp ? counts[k] : 0;
        total += counts[k];
      }
      if (hit) {
        list.ref[at] = i;
        list.ys[at] = t.y0 | (t.y1 << 16);
        list.xs[at] = t.x0 | (t.x1 << 16);
        list.wy0[at] = t.wy0;
        list.wy1[at] = t.wy1;
        list.wx0[at] = t.wx0;
        list.wx1[at] = t.wx1;
      }
      n += total;
      __syncthreads();  // counts and the list are complete
      if (seg + (u + 1) * kBwdThreads >= end) break;
    }
    // the first kStaged entries' gradient rows, their loads issued together
    float4 gv[kStaged / kBwdWarps];
#pragma unroll
    for (int u = 0; u < kStaged / kBwdWarps; ++u) {
      const int e = warp + u * kBwdWarps, r = e < n ? list.ref[e] : 0;
      if (e < n)
        gv[u] = __ldg(reinterpret_cast<const float4*>(
            g_view + static_cast<long long>(r >> 1) * row_len + (r & 1) * kLoiC));
    }
#pragma unroll
    for (int u = 0; u < kStaged / kBwdWarps; ++u)
      if (warp + u * kBwdWarps < n) staged[warp + u * kBwdWarps][lane] = gv[u];
    __syncthreads();
    for (int q = warp; q < texels; q += kBwdWarps) {
      const int y = y_lo + q / cols, x = x_lo + q % cols;
      float* o = out + (static_cast<long long>(y) * w + x) * kLoiC;
      float4 acc = seg == 0 ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                            : *reinterpret_cast<const float4*>(o);
      for (int b = 0; b < n; b += 32) {
        const int k = b + lane;
        bool m = false;
        if (k < n) {
          const int ys = list.ys[k], xs = list.xs[k];
          m = (lo16(ys) == y || hi16(ys) == y) && (lo16(xs) == x || hi16(xs) == x);
        }
        unsigned bits = __ballot_sync(0xffffffffu, m);
        while (bits) {
          const int e = b + __ffs(bits) - 1;
          bits &= bits - 1u;
          const int r = list.ref[e];
          const float4 g = e < kStaged
                               ? staged[e][lane]
                               : __ldg(reinterpret_cast<const float4*>(
                                     g_view + static_cast<long long>(r >> 1) * row_len +
                                     (r & 1) * kLoiC));
          // this row's weight: exact, since a merged pair's second weight is 0
          const float wr = lo16(list.ys[e]) == y ? list.wy0[e] : list.wy1[e];
          const int xs = list.xs[e];
          if (lo16(xs) == x) {
            const float wx = list.wx0[e];
            acc.x += (g.x * wx) * wr;
            acc.y += (g.y * wx) * wr;
            acc.z += (g.z * wx) * wr;
            acc.w += (g.w * wx) * wr;
          }
          if (hi16(xs) == x && hi16(xs) != lo16(xs)) {  // likewise wx1
            const float wx = list.wx1[e];
            acc.x += (g.x * wx) * wr;
            acc.y += (g.y * wx) * wr;
            acc.z += (g.z * wx) * wr;
            acc.w += (g.w * wx) * wr;
          }
        }
      }
      *reinterpret_cast<float4*>(o) = acc;
    }
    seg += kSegment;
    __syncthreads();  // the next pass rebuilds the list
  } while (seg < n_refs);
}

// 16 bytes added to global memory in one vector reduction (sm_90)
__device__ __forceinline__ void add4(float* p, float a, float b, float c, float d) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(a, b, c, d));
}

// One interior point per thread: i = (row * 2 + branch) * nt + t.
__device__ __forceinline__ void interior_point(
    const float* __restrict__ grad, const float* __restrict__ thin, const float* __restrict__ aux,
    const float* __restrict__ lines, const float* __restrict__ prop_lines,
    const float* __restrict__ t_fwd, const float* __restrict__ t_rev, float* __restrict__ d_thin,
    float* __restrict__ d_aux, long long i, int n_lines, int h, int w, int nt, int row_len,
    float (*acc)[32]) {
  const int t = static_cast<int>(i % nt);
  const long long rb = i / nt;
  const int b = static_cast<int>(rb & 1);
  const long long row = rb >> 1;
  const long long view = row / n_lines;
  const long long texels = static_cast<long long>(h) * w;
  const float tf = __ldg(t_fwd + t), tr = __ldg(t_rev + t);
  const float* s = (b == 0 ? lines : prop_lines) + row * 4;
  const float s0 = __ldg(s), s1 = __ldg(s + 1), s2 = __ldg(s + 2), s3 = __ldg(s + 3);
  const float x = __fsub_rn(__fadd_rn(__fmul_rn(s0, tf), __fmul_rn(s2, tr)), 0.5f);
  const float y = __fsub_rn(__fadd_rn(__fmul_rn(s1, tf), __fmul_rn(s3, tr)), 0.5f);
  const Taps tp = make_taps<float>(x, y, h, w);
  const long long r0 = static_cast<long long>(tp.y0) * w, r1 = static_cast<long long>(tp.y1) * w;
  const float* gb = grad + row * row_len + 2 * kLoiC + b * kIntC * nt + t;
  float gc[kIntC];
#pragma unroll
  for (int c = 0; c < kIntC; ++c) gc[c] = __ldg(gb + c * nt);
  float* dm = (b == 0 ? d_thin : d_aux) + view * texels * kIntC;
  float g0[kIntC], g1[kIntC];
#pragma unroll
  for (int c = 0; c < kIntC; ++c) {
    g0[c] = gc[c] * tp.wx0;
    g1[c] = gc[c] * tp.wx1;
  }
  // a merged pair's second weight is 0: its tap would add zeros
  add4(dm + (r0 + tp.x0) * kIntC, g0[0] * tp.wy0, g0[1] * tp.wy0, g0[2] * tp.wy0, g0[3] * tp.wy0);
  if (tp.y1 != tp.y0)
    add4(dm + (r1 + tp.x0) * kIntC, g0[0] * tp.wy1, g0[1] * tp.wy1, g0[2] * tp.wy1,
         g0[3] * tp.wy1);
  if (tp.x1 != tp.x0) {
    add4(dm + (r0 + tp.x1) * kIntC, g1[0] * tp.wy0, g1[1] * tp.wy0, g1[2] * tp.wy0,
         g1[3] * tp.wy0);
    if (tp.y1 != tp.y0)
      add4(dm + (r1 + tp.x1) * kIntC, g1[0] * tp.wy1, g1[1] * tp.wy1, g1[2] * tp.wy1,
           g1[3] * tp.wy1);
  }
  const float* fm = (b == 0 ? thin : aux) + view * texels * kIntC;
  float f00[kIntC], f10[kIntC], f01[kIntC], f11[kIntC];
  Chunk<float, kIntC>::load(fm + (r0 + tp.x0) * kIntC, f00);
  Chunk<float, kIntC>::load(fm + (r1 + tp.x0) * kIntC, f10);
  Chunk<float, kIntC>::load(fm + (r0 + tp.x1) * kIntC, f01);
  Chunk<float, kIntC>::load(fm + (r1 + tp.x1) * kIntC, f11);
  float dx = 0.0f, dy = 0.0f;
#pragma unroll
  for (int c = 0; c < kIntC; ++c) {
    const float a = tp.wy0 * f00[c] + tp.wy1 * f10[c];
    const float bb = tp.wy0 * f01[c] + tp.wy1 * f11[c];
    dx += gc[c] * (bb - a);
    dy += gc[c] * (tp.wx0 * (f10[c] - f00[c]) + tp.wx1 * (f11[c] - f01[c]));
  }
  if (tp.x0 == tp.x1) dx = 0.0f;
  if (tp.y0 == tp.y1) dy = 0.0f;
  atomicAdd(&acc[0][t], dx * s0 + dy * s1);
  atomicAdd(&acc[1][t], dx * s2 + dy * s3);
}

// Blocks [0, interior_blocks): the interior points; the rest: one tile of
// d_loi each, `tile` texels (a part of a row, or whole rows), view-major.
__global__ void __launch_bounds__(kBwdThreads)
loi_features_backward_kernel(const float* __restrict__ grad, const float* __restrict__ thin,
                             const float* __restrict__ aux, const float* __restrict__ junc_xy,
                             const long long* __restrict__ pair_idx,
                             const float* __restrict__ lines, const float* __restrict__ prop_lines,
                             const float* __restrict__ t_fwd, const float* __restrict__ t_rev,
                             float* __restrict__ d_loi, float* __restrict__ d_thin,
                             float* __restrict__ d_aux, float* __restrict__ d_tf,
                             float* __restrict__ d_tr, int n_views, int n_lines, int n_junc,
                             int h, int w, int nt, int tile, int interior_blocks) {
  __shared__ TileList list;
  __shared__ float4 staged[kStaged][32];  // the listed references' gradient rows
  __shared__ int counts[kBwdWarps];
  __shared__ float acc[2][32];  // this block's d t_fwd, d t_rev
  const int row_len = 2 * kLoiC + 2 * kIntC * nt;
  if (static_cast<int>(blockIdx.x) >= interior_blocks) {
    const int cols = min(tile, w), rows = max(1, tile / w);
    const int tiles_x = (w + cols - 1) / cols, tiles = tiles_x * ((h + rows - 1) / rows);
    const int b = blockIdx.x - interior_blocks, k = b % tiles;
    const int y_lo = k / tiles_x * rows, x_lo = k % tiles_x * cols;
    own_loi_tile(grad, junc_xy, pair_idx, d_loi, b / tiles, y_lo, min(y_lo + rows, h), x_lo,
                 min(x_lo + cols, w), n_lines, n_junc, h, w, row_len, list, staged, counts);
    return;
  }
  if (threadIdx.x < 64) acc[threadIdx.x >> 5][threadIdx.x & 31] = 0.0f;
  __syncthreads();
  const long long i = static_cast<long long>(blockIdx.x) * kBwdThreads + threadIdx.x;
  if (i < static_cast<long long>(n_views) * n_lines * 2 * nt)
    interior_point(grad, thin, aux, lines, prop_lines, t_fwd, t_rev, d_thin, d_aux, i, n_lines,
                   h, w, nt, row_len, acc);
  __syncthreads();
  if (threadIdx.x < nt) {
    atomicAdd(d_tf + threadIdx.x, acc[0][threadIdx.x]);
    atomicAdd(d_tr + threadIdx.x, acc[1][threadIdx.x]);
  }
}

__global__ void empty_kernel() {}

}  // namespace

// fmap (H, W, C) f32 or bf16, x/y (N,) f32, out (N, C) or (C, N) f32, all
// contiguous on the current device. Returns cudaGetLastError().
extern "C" int airslam_bilerp(const void* fmap, int is_bf16, const float* x,
                              const float* y, float* out, int n, int h, int w,
                              int c, int channel_major, void* stream) {
  if (n == 0 || c == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch<__nv_bfloat16>(fmap, x, y, out, n, h, w, c, channel_major != 0, s);
  else
    launch<float>(fmap, x, y, out, n, h, w, c, channel_major != 0, s);
  return static_cast<int>(cudaGetLastError());
}

// loi_features, shapes as loi_features_kernel's note; every operand
// contiguous on the current device, the maps on 16 bytes, 1 <= nt <= 32,
// j >= 1; warps: lines per block, 1-8 (0: kLoiWarps). Returns
// cudaGetLastError().
extern "C" int airslam_loi_features(const void* loi, const void* thin, const void* aux,
                                    int is_bf16, const float* junc_xy,
                                    const long long* pair_idx, const float* lines,
                                    const float* prop_lines, const float* t_fwd,
                                    const float* t_rev, void* out, int out_bf16, int v, int l,
                                    int j, int h, int w, int nt, int warps, void* stream) {
  if (v == 0 || l == 0) return 0;
  if (warps == 0) warps = kLoiWarps;
  if (j < 1 || nt < 1 || nt > 32 || warps < 1 || warps > kLoiMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (is_bf16 && out_bf16)
    launch_loi<bf, bf>(loi, thin, aux, junc_xy, pair_idx, lines, prop_lines, t_fwd, t_rev, out,
                       v, l, j, h, w, nt, warps, s);
  else if (is_bf16)
    launch_loi<bf, float>(loi, thin, aux, junc_xy, pair_idx, lines, prop_lines, t_fwd, t_rev,
                          out, v, l, j, h, w, nt, warps, s);
  else if (out_bf16)
    launch_loi<float, bf>(loi, thin, aux, junc_xy, pair_idx, lines, prop_lines, t_fwd, t_rev,
                          out, v, l, j, h, w, nt, warps, s);
  else
    launch_loi<float, float>(loi, thin, aux, junc_xy, pair_idx, lines, prop_lines, t_fwd, t_rev,
                             out, v, l, j, h, w, nt, warps, s);
  return static_cast<int>(cudaGetLastError());
}

// loi_features_backward: grad (V, L, 256 + 8 * nt) f32 on 16 bytes, the
// forward's f32 operands (thin / aux maps on 16 bytes; the LOI map is not
// read), and the outputs: d_loi (V, H, W, 128) on 16 bytes, written whole
// (it need not be zeroed), and the ZEROED d_thin / d_aux (V, H, W, 4) on 16
// bytes and d_tf / d_tr (nt,). Every operand contiguous on the current
// device, 1 <= nt <= 32, j >= 1, h and w below 32768; tile: texels of d_loi
// a block owns, 1-2048 (0: kBwdTile; a tile is a part of a row, or whole
// rows). Returns cudaGetLastError().
extern "C" int airslam_loi_features_backward(const float* grad, const float* thin,
                                             const float* aux, const float* junc_xy,
                                             const long long* pair_idx, const float* lines,
                                             const float* prop_lines, const float* t_fwd,
                                             const float* t_rev, float* d_loi, float* d_thin,
                                             float* d_aux, float* d_tf, float* d_tr, int v, int l,
                                             int j, int h, int w, int nt, int tile,
                                             void* stream) {
  if (v == 0 || l == 0) return 0;
  if (tile == 0) tile = kBwdTile;
  if (j < 1 || nt < 1 || nt > 32 || h >= 32768 || w >= 32768 || tile < 1 ||
      tile > kBwdMaxTile || l > 0x3fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long points = static_cast<long long>(v) * l * 2 * nt;
  const long long interior = (points + kBwdThreads - 1) / kBwdThreads;
  const int cols = tile < w ? tile : w, rows = tile / w > 1 ? tile / w : 1;
  const long long tiles = static_cast<long long>((w + cols - 1) / cols) * ((h + rows - 1) / rows);
  const long long blocks = interior + v * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  loi_features_backward_kernel<<<static_cast<unsigned>(blocks), kBwdThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      grad, thin, aux, junc_xy, pair_idx, lines, prop_lines, t_fwd, t_rev, d_loi, d_thin, d_aux,
      d_tf, d_tr, v, l, j, h, w, nt, tile, static_cast<int>(interior));
  return static_cast<int>(cudaGetLastError());
}

// Registers, static shared and local bytes, threads per block of
// loi_features_backward (cudaFuncGetAttributes).
extern "C" int airslam_loi_features_backward_attributes(int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, &loi_features_backward_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = kBwdThreads;
  return 0;
}

// Registers, static shared and local bytes, threads per block of the
// loi_features instantiation for these types (cudaFuncGetAttributes).
extern "C" int airslam_loi_features_attributes(int is_bf16, int out_bf16, int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, loi_kernel(is_bf16, out_bf16));
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = kLoiWarps * 32;
  return 0;
}

// An empty kernel: the launch floor that B, T and loi_features sit at,
// timed beside them by chip_smoke.py.
extern "C" int airslam_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
