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
// training: f32 maps, atomicAdd scatter into the map gradients, the ramps'
// gradient from each interior sample's coordinate derivative.

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
// One warp per (view, line), as the forward. The row's gradient g flows
//   - into the maps: each sample's four taps receive (g * wx) * wy (the
//     plain version's autograd order) by atomicAdd into zeroed (V, H, W, C)
//     maps: the endpoints into d_loi through the clamped pair_idx junctions
//     (lanes over 2 x 32 chunks of 4 channels, a 16-byte load of g each),
//     the interior points into d_thin / d_aux (lane t < nt, point t);
//   - into t_fwd / t_rev: point t sits at x = s0*t_fwd[t] + s2*t_rev[t] - 0.5
//     (likewise y with s1, s3), and with the forward's unclamped weights
//       d/dx = sum_c g_c (b_c - a_c),  a = wy0 f00 + wy1 f10, b = wy0 f01 + wy1 f11,
//       d/dy = sum_c g_c (wx0 (f10 - f00) + wx1 (f11 - f01)),
//     zero along an axis whose two taps clamp onto one texel (floor and clip
//     carry no gradient; the merged weights' derivatives cancel), so
//       d t_fwd[t] += dx s0 + dy s1,  d t_rev[t] += dx s2 + dy s3,
//     summed over both branches, the block's lines in shared memory, then
//     one atomicAdd per block and ramp entry.
// Junctions, lines and proposals are data: no gradient. Bound: the dense map gradients the
// wrapper zeroes dwarf what the kernel touches (V x 128^2 x 136 floats
// against a few taps per sample), so the memset, not the kernel, is the
// floor of the whole backward.
__global__ void __launch_bounds__(kLoiMaxWarps * 32)
loi_features_backward_kernel(const float* __restrict__ grad, const float* __restrict__ thin,
                             const float* __restrict__ aux, const float* __restrict__ junc_xy,
                             const long long* __restrict__ pair_idx,
                             const float* __restrict__ lines, const float* __restrict__ prop_lines,
                             const float* __restrict__ t_fwd, const float* __restrict__ t_rev,
                             float* __restrict__ d_loi, float* __restrict__ d_thin,
                             float* __restrict__ d_aux, float* __restrict__ d_tf,
                             float* __restrict__ d_tr, int n_views, int n_lines, int n_junc,
                             int h, int w, int nt) {
  __shared__ float acc[2][32];  // this block's d t_fwd, d t_rev
  for (int i = threadIdx.x; i < 64; i += blockDim.x) acc[i >> 5][i & 31] = 0.0f;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row < static_cast<long long>(n_views) * n_lines) {
    const long long view = row / n_lines;
    const long long texels = static_cast<long long>(h) * w;
    const float* g = grad + row * (2 * kLoiC + 2 * kIntC * nt);

    constexpr int kChunks = kLoiC / 4;  // per endpoint
    float* dm = d_loi + view * texels * kLoiC;
    for (int i = lane; i < 2 * kChunks; i += 32) {
      const int e = i / kChunks;
      const int ch0 = (i - e * kChunks) * 4;
      long long j = __ldg(pair_idx + row * 2 + e);
      j = j < 0 ? 0 : (j >= n_junc ? n_junc - 1 : j);
      const float* p = junc_xy + (view * n_junc + j) * 2;
      const Taps t = make_taps<float>(__ldg(p) - 0.5f, __ldg(p + 1) - 0.5f, h, w);
      const float4 gv = __ldg(reinterpret_cast<const float4*>(g + e * kLoiC + ch0));
      const float gc[4] = {gv.x, gv.y, gv.z, gv.w};
      const long long r0 = static_cast<long long>(t.y0) * w, r1 = static_cast<long long>(t.y1) * w;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float g0 = gc[c] * t.wx0, g1 = gc[c] * t.wx1;
        atomicAdd(dm + (r0 + t.x0) * kLoiC + ch0 + c, g0 * t.wy0);
        atomicAdd(dm + (r1 + t.x0) * kLoiC + ch0 + c, g0 * t.wy1);
        atomicAdd(dm + (r0 + t.x1) * kLoiC + ch0 + c, g1 * t.wy0);
        atomicAdd(dm + (r1 + t.x1) * kLoiC + ch0 + c, g1 * t.wy1);
      }
    }

    if (lane < nt) {
      const float tf = __ldg(t_fwd + lane), tr = __ldg(t_rev + lane);
      float dtf = 0.0f, dtr = 0.0f;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const float* s = (b == 0 ? lines : prop_lines) + row * 4;
        const float s0 = __ldg(s), s1 = __ldg(s + 1), s2 = __ldg(s + 2), s3 = __ldg(s + 3);
        const float x = __fsub_rn(__fadd_rn(__fmul_rn(s0, tf), __fmul_rn(s2, tr)), 0.5f);
        const float y = __fsub_rn(__fadd_rn(__fmul_rn(s1, tf), __fmul_rn(s3, tr)), 0.5f);
        const Taps t = make_taps<float>(x, y, h, w);
        const long long r0 = static_cast<long long>(t.y0) * w, r1 = static_cast<long long>(t.y1) * w;
        const float* gb = g + 2 * kLoiC + b * kIntC * nt + lane;
        float gc[kIntC];
#pragma unroll
        for (int c = 0; c < kIntC; ++c) gc[c] = __ldg(gb + c * nt);
        float* dmi = (b == 0 ? d_thin : d_aux) + view * texels * kIntC;
#pragma unroll
        for (int c = 0; c < kIntC; ++c) {
          const float g0 = gc[c] * t.wx0, g1 = gc[c] * t.wx1;
          atomicAdd(dmi + (r0 + t.x0) * kIntC + c, g0 * t.wy0);
          atomicAdd(dmi + (r1 + t.x0) * kIntC + c, g0 * t.wy1);
          atomicAdd(dmi + (r0 + t.x1) * kIntC + c, g1 * t.wy0);
          atomicAdd(dmi + (r1 + t.x1) * kIntC + c, g1 * t.wy1);
        }
        const float* fm = (b == 0 ? thin : aux) + view * texels * kIntC;
        float f00[kIntC], f10[kIntC], f01[kIntC], f11[kIntC];
        Chunk<float, kIntC>::load(fm + (r0 + t.x0) * kIntC, f00);
        Chunk<float, kIntC>::load(fm + (r1 + t.x0) * kIntC, f10);
        Chunk<float, kIntC>::load(fm + (r0 + t.x1) * kIntC, f01);
        Chunk<float, kIntC>::load(fm + (r1 + t.x1) * kIntC, f11);
        float dx = 0.0f, dy = 0.0f;
#pragma unroll
        for (int c = 0; c < kIntC; ++c) {
          const float a = t.wy0 * f00[c] + t.wy1 * f10[c];
          const float bb = t.wy0 * f01[c] + t.wy1 * f11[c];
          dx += gc[c] * (bb - a);
          dy += gc[c] * (t.wx0 * (f10[c] - f00[c]) + t.wx1 * (f11[c] - f01[c]));
        }
        if (t.x0 == t.x1) dx = 0.0f;
        if (t.y0 == t.y1) dy = 0.0f;
        dtf += dx * s0 + dy * s1;
        dtr += dx * s2 + dy * s3;
      }
      atomicAdd(&acc[0][lane], dtf);
      atomicAdd(&acc[1][lane], dtr);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nt; i += blockDim.x) {
    atomicAdd(d_tf + i, acc[0][i]);
    atomicAdd(d_tr + i, acc[1][i]);
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
// read), and the zeroed outputs d_loi (V, H, W, 128), d_thin / d_aux
// (V, H, W, 4), d_tf / d_tr (nt,). Every operand contiguous on the
// current device, 1 <= nt <= 32, j >= 1. Returns cudaGetLastError().
extern "C" int airslam_loi_features_backward(const float* grad, const float* thin,
                                             const float* aux, const float* junc_xy,
                                             const long long* pair_idx, const float* lines,
                                             const float* prop_lines, const float* t_fwd,
                                             const float* t_rev, float* d_loi, float* d_thin,
                                             float* d_aux, float* d_tf, float* d_tr, int v, int l,
                                             int j, int h, int w, int nt, void* stream) {
  if (v == 0 || l == 0) return 0;
  if (j < 1 || nt < 1 || nt > 32) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(v) * l;
  const unsigned blocks = static_cast<unsigned>((rows + kLoiWarps - 1) / kLoiWarps);
  loi_features_backward_kernel<<<blocks, kLoiWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      grad, thin, aux, junc_xy, pair_idx, lines, prop_lines, t_fwd, t_rev, d_loi, d_thin, d_aux,
      d_tf, d_tr, v, l, j, h, w, nt);
  return static_cast<int>(cudaGetLastError());
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
