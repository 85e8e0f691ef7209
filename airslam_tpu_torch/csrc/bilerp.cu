// Kernels B and T: bilinear point sampling of an (H, W, C) feature map with
// the stage-1 LOI head's corner arithmetic.
//
// Replace the Pallas TPU kernels airslam_tpu/ops/bilerp_pallas.py:_kernel
// (bilerp_points, row-major (N, C) output; the LOI endpoint/junction features
// on the 128-channel LOI map) and :_kernel_t (bilerp_points_t, channel-major
// (C, N) output; the thin/aux interior features on the 4-channel maps). On
// the TPU both run as one-hot MXU contractions over a VMEM-resident map; here
// they are plain gathers: each output reads 4 taps per channel.
//
// Bound on the H100: neither is near a roofline. B at the frontend's shape
// (300 points x 128 bf16 channels) moves ~0.46 MB, T (15,360 points x 4
// channels) ~0.86 MB; both are a few hundred ns of memory traffic, so launch
// latency bounds them. Design for that: one launch per call, no shared memory,
// no staging; B runs one thread per (point, channel) so neighbouring threads
// read neighbouring channels (coalesced bf16 rows) and write the (N, C) row
// coalesced; T runs one thread per point over the map's C contiguous channels
// and writes each channel's plane coalesced.
//
// Arithmetic (bilerp_pallas.py:53-76, :135-157):
//   x0 = clip(floor x, 0, W-1), x1 = clip(x0 + 1, 0, W-1), likewise y;
//   weights (x1 - x), (x - x0) UNclamped, so total weight is 0 at the far
//   border; when x0 == x1 the two taps ADD into one weight (same for y);
//   for bf16 maps the y weights are rounded to bf16 (the TPU kernel's
//   bf16 one-hot row matrix) and everything accumulates in f32; x weights
//   stay f32. FMA contraction is allowed (agreement with the plain version
//   is within 1e-5).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
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

template <typename T>
__device__ __forceinline__ float sample(const T* __restrict__ f, const Taps& t,
                                        int w, int c, int ch) {
  const long long r0 = static_cast<long long>(t.y0) * w;
  const long long r1 = static_cast<long long>(t.y1) * w;
  const float a = t.wy0 * load(f + (r0 + t.x0) * c + ch) +
                  t.wy1 * load(f + (r1 + t.x0) * c + ch);
  const float b = t.wy0 * load(f + (r0 + t.x1) * c + ch) +
                  t.wy1 * load(f + (r1 + t.x1) * c + ch);
  return a * t.wx0 + b * t.wx1;
}

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

template <typename T>
void launch(const void* fmap, const float* x, const float* y, float* out,
            int n, int h, int w, int c, bool channel_major, cudaStream_t s) {
  const int threads = 256;
  const long long work = channel_major ? n : static_cast<long long>(n) * c;
  const unsigned blocks = static_cast<unsigned>((work + threads - 1) / threads);
  const T* f = static_cast<const T*>(fmap);
  if (channel_major)
    bilerp_kernel<T, true><<<blocks, threads, 0, s>>>(f, x, y, out, n, h, w, c);
  else
    bilerp_kernel<T, false><<<blocks, threads, 0, s>>>(f, x, y, out, n, h, w, c);
}

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
