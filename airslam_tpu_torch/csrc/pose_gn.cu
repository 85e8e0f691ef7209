// Kernel P: the whole F=1 pose-only tracking solve in one launch.
//
// Replaces the Pallas TPU kernel airslam_tpu/backend/pose_gn_pallas.py:_kernel
// (wrapper pose_only_fast_pallas). It computes what that kernel computes:
// `rounds` rounds of `iters` Levenberg-Marquardt iterations over stereo point
// rows (3 residuals) and Plücker line rows (4 residuals) with the landmarks
// fixed; Huber weights; the analytic 6-column pose Jacobian (right-multiplied
// body-frame update, twb += Rwb·dt, Rwb <- Rwb·Exp(dr)); λ·I damping with the
// `< 1e-10 -> +1` diagonal repair; an unrolled 6×6 Cholesky solve; a trial
// cost with a strict `<` accept (λ/3, ν = 2) or reject (λ·ν, 2ν); every round
// restarts from the initial pose with the masks the previous round's chi²
// relabel produced (over the full base masks, points also need depth > 0).
//
// What bounds it on an H100: neither bytes nor operations (about 27 KB of
// operands and well under a megaflop per iteration) but latency: a chain of
// dependent block-wide reductions. The design keeps that chain inside one
// thread block per problem (blockIdx.x is the problem index) and keeps it
// short:
// - one walk over the rows per pose: at every pose the solve evaluates, the
//   Huber cost and the undamped H, b come out of the same pass as 28 sums
//   reduced together. A trial that is accepted hands its H, b to the next
//   iteration; a rejected one leaves the previous H, b, which belong to the
//   same pose and so are the same numbers. A round is one pass at its start
//   pose plus one per iteration, and the whole solve rounds·(iters+1)+1
//   reductions (34 at 3 × 10);
// - one __syncthreads per reduction: the shared scratch is double-buffered,
//   the 28 sums go down each warp by shuffles, and after the barrier lane i
//   of every warp adds column i of the kWarps partials in warp order and the
//   28 totals reach the other lanes by shuffle (no second barrier, 8 shared
//   reads per lane);
// - operands staged once into shared memory; thread i owns point rows i,
//   i+NT, … and line rows from the other end of the block; every thread
//   holds the same H, b, pose, λ, ν and cost in registers and runs the 6×6
//   solve (one reciprocal per pivot), the retraction (sincosf) and the
//   accept redundantly, with no broadcast. The reduction order is fixed: two
//   runs give the same bits. Global memory is read once and written once;
//   nothing returns to the host inside the solve. The block size NT is a
//   template parameter (64, 128 or 256 threads; 256, the fastest in
//   chip_smoke.py's sweep at both shapes, is the default);
// - a link's time is its longest thread's rows, and the longest row is a
//   line's: its Jacobian would divide by the guarded norms 60 times, so it
//   takes one reciprocal per norm and multiplies (the residuals and the cost
//   keep their divisions).

// Arithmetic: IEEE sqrtf and division, sincosf, no fast-math. FMA
// contraction is left ON (nvcc's default): the accept test compares f32 sums
// whose order already differs from the plain version's tensor reductions, so
// bit-equality with it is out of reach with or without contraction, and a
// fused multiply-add rounds once where the unfused pair rounds twice, which
// keeps the f32 solve closer to the f64 reference it is gated against. A
// fixed pose (pose_free = 0) still comes back bit-unchanged: every Jacobian
// column is exactly 0, so dx = 0, Exp(0) = I and R·I, t + R·0 are exact under
// either rounding.
//
// Masks are floats multiplied in, as in the reference; rows are exactly the
// np and nl the caller passes (no lane padding), so nothing unread is weighed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDefaultThreads = 256;  // block size of a launch that names none
constexpr int kMaxWarps = 8;           // warps of the largest block (256 threads)
constexpr int kAcc = 28;  // 21 upper entries of H + 6 of b + the robust cost
constexpr float kEps = 1e-4f;  // lie._EPS (IMU_EPS, include/imu.h:20)

struct V3 {
  float x, y, z;
};

struct Params {
  float fx, fy, cx, cy, bf;
  float mono_point, stereo_point, mono_line, stereo_line;
  float lam0, nu0;
  int rounds, iters;
};

struct Cam {
  float Rcb[9];
  V3 tcb;
  float fx, fy, cx, cy, bf, bb;
  V3 kv;
};

struct Pose {
  float R[9];
  V3 t;
};

struct CamPose {  // Rcw = Rcb·Rᵀ, tcw = tcb − Rcw·t
  float Rcw[9];
  V3 tcw;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
// a × e_k for the canonical basis (the Jacobian columns of Exp at 0)
__device__ __forceinline__ V3 cross_e(V3 a, int k) {
  if (k == 0) return v3(0.0f, a.z, -a.y);
  if (k == 1) return v3(-a.z, 0.0f, a.x);
  return v3(a.y, -a.x, 0.0f);
}
// A·v and Aᵀ·v for a row-major 3×3
__device__ __forceinline__ V3 mv(const float* A, V3 v) {
  return v3(A[0] * v.x + A[1] * v.y + A[2] * v.z, A[3] * v.x + A[4] * v.y + A[5] * v.z,
            A[6] * v.x + A[7] * v.y + A[8] * v.z);
}
__device__ __forceinline__ V3 mtv(const float* A, V3 v) {
  return v3(A[0] * v.x + A[3] * v.y + A[6] * v.z, A[1] * v.x + A[4] * v.y + A[7] * v.z,
            A[2] * v.x + A[5] * v.y + A[8] * v.z);
}
__device__ __forceinline__ V3 col(const float* A, int c) { return v3(A[c], A[3 + c], A[6 + c]); }

__device__ __forceinline__ CamPose camera_of(const Cam& cam, const Pose& p) {
  CamPose cp;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      cp.Rcw[3 * i + j] = cam.Rcb[3 * i] * p.R[3 * j] + cam.Rcb[3 * i + 1] * p.R[3 * j + 1] +
                          cam.Rcb[3 * i + 2] * p.R[3 * j + 2];
  cp.tcw = cam.tcb - mv(cp.Rcw, p.t);
  return cp;
}

// Rodrigues with the series switch of lie.so3_exp
__device__ __forceinline__ void so3_exp(V3 v, float* E) {
  float theta = sqrtf(v.x * v.x + v.y * v.y + v.z * v.z);
  bool small = theta < kEps;
  float st = small ? 1.0f : theta;
  float sn, cs;
  sincosf(st, &sn, &cs);
  float a = small ? 1.0f : sn / st;
  float b = small ? 0.5f : (1.0f - cs) / (st * st);
  float O[9] = {0.0f, -v.z, v.y, v.z, 0.0f, -v.x, -v.y, v.x, 0.0f};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float o2 = O[3 * i] * O[j] + O[3 * i + 1] * O[3 + j] + O[3 * i + 2] * O[6 + j];
      E[3 * i + j] = (i == j ? 1.0f : 0.0f) + a * O[3 * i + j] + b * o2;
    }
}

// gn.solve_spd_small for n = 6: unrolled Cholesky, forward and back solves,
// with one reciprocal per pivot (multiplied where the plain version divides)
__device__ __forceinline__ void chol_solve6(const float (*H)[6], const float* b, float* x) {
  float L[6][6], inv[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = H[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - L[j][k] * L[j][k];
    float d = sqrtf(s);
    L[j][j] = d;
    inv[j] = 1.0f / d;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float t = H[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t = t - L[i][k] * L[j][k];
      L[i][j] = t * inv[j];
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s * inv[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * x[k];
    x[i] = s * inv[i];
  }
}

__device__ __forceinline__ float huber_w(float chi2, float d2) {
  return chi2 <= d2 ? 1.0f : sqrtf(d2 / fmaxf(chi2, 1e-12f));
}
__device__ __forceinline__ float huber_cost(float chi2, float d2, float active) {
  float lin = 2.0f * sqrtf(d2 * fmaxf(chi2, 1e-12f)) - d2;
  return active > 0.5f ? (chi2 <= d2 ? chi2 : lin) : 0.0f;
}

// Sum N ≤ 32 per-thread values over the block in a fixed order; every thread
// ends with the same totals. `red` holds 2·kMaxWarps·N floats, used in turns
// (`phase`): a thread reaches the next reduction's writes to one half only
// after the barrier of the reduction between, which every reader of that half
// passed after its reads, so one barrier per reduction is enough.
template <int NT, int N>
__device__ __forceinline__ void block_sum(float* acc, float* red, int& phase) {
  static_assert(N <= 32, "one lane per total");
  constexpr int kWarps = NT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* buf = red + phase * (kMaxWarps * N);
  phase ^= 1;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float v = acc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) buf[warp * N + i] = v;
  }
  __syncthreads();
  // lane i adds column i over the warps, in warp order
  float tot = 0.0f;
  if (lane < N) {
    tot = buf[lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) tot += buf[w * N + lane];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = __shfl_sync(0xffffffffu, tot, i);
}

// One problem's operands in shared memory (structure of arrays).
struct Rows {
  int np, nl;
  const float *P, *OB, *p_base;  // 3·np, 3·np, np
  float* p_m;                    // np, the round's active mask
  const float *LN, *LO, *l_base, *l_st, *l_sig;  // 6·nl, 8·nl, nl, nl, nl
  float* l_m;                                    // nl
};

struct PointRow {
  float r0, r1, r2;  // obs − projection
  V3 pc;             // camera-frame point
  float zi;          // guarded 1/z
  bool guard;        // |z| < 1e-9
  float st, thr;     // stereo flag, chi² threshold
};

__device__ __forceinline__ V3 load3(const float* a, int n, int i) {
  return v3(a[i], a[n + i], a[2 * n + i]);
}

__device__ __forceinline__ PointRow point_vals(const Rows& s, int i, const Cam& cam,
                                               const CamPose& cp, const Params& prm) {
  PointRow o;
  V3 ob = load3(s.OB, s.np, i);
  o.pc = mv(cp.Rcw, load3(s.P, s.np, i)) + cp.tcw;
  o.guard = fabsf(o.pc.z) < 1e-9f;
  o.zi = 1.0f / (o.guard ? 1e-9f : o.pc.z);
  float u = o.pc.x * o.zi * cam.fx + cam.cx;
  float v = o.pc.y * o.zi * cam.fy + cam.cy;
  float ur = u - cam.bf * o.zi;
  o.r0 = ob.x - u;
  o.r1 = ob.y - v;
  o.r2 = ob.z - ur;
  bool stereo = ob.z >= 0.0f;
  o.st = stereo ? 1.0f : 0.0f;
  o.thr = stereo ? prm.stereo_point : prm.mono_point;
  return o;
}

__device__ __forceinline__ float point_chi2(const PointRow& o, float m) {
  return o.r0 * o.r0 * m + o.r1 * o.r1 * m + o.r2 * o.r2 * (m * o.st);
}

struct LineRow {
  float l0, l1, l2, n, ns;    // left image line and its guarded norm
  float m0, m1, m2, nr, nrs;  // right image line
  V3 wc, dc;                  // camera-frame moment and direction
  float e0, e1, e2, e3;
  float lo[8];
  float st, thr, sig;
};

__device__ __forceinline__ LineRow line_vals(const Rows& s, int j, const Cam& cam,
                                             const CamPose& cp, const Params& prm) {
  LineRow o;
  const int nl = s.nl;
  V3 lw = v3(s.LN[j], s.LN[nl + j], s.LN[2 * nl + j]);
  V3 ld = v3(s.LN[3 * nl + j], s.LN[4 * nl + j], s.LN[5 * nl + j]);
#pragma unroll
  for (int k = 0; k < 8; ++k) o.lo[k] = s.LO[k * nl + j];
  o.dc = mv(cp.Rcw, ld);
  o.wc = mv(cp.Rcw, lw) + cross(cp.tcw, o.dc);
  o.l0 = cam.fy * o.wc.x;
  o.l1 = cam.fx * o.wc.y;
  o.l2 = dot(cam.kv, o.wc);
  o.n = sqrtf(o.l0 * o.l0 + o.l1 * o.l1);
  o.ns = o.n < 1e-12f ? 1e-12f : o.n;
  o.e0 = (o.lo[0] * o.l0 + o.lo[1] * o.l1 + o.l2) / o.ns;
  o.e1 = (o.lo[2] * o.l0 + o.lo[3] * o.l1 + o.l2) / o.ns;
  V3 wr = v3(o.wc.x, o.wc.y + cam.bb * o.dc.z, o.wc.z - cam.bb * o.dc.y);
  o.m0 = cam.fy * wr.x;
  o.m1 = cam.fx * wr.y;
  o.m2 = dot(cam.kv, wr);
  o.nr = sqrtf(o.m0 * o.m0 + o.m1 * o.m1);
  o.nrs = o.nr < 1e-12f ? 1e-12f : o.nr;
  o.e2 = (o.lo[4] * o.m0 + o.lo[5] * o.m1 + o.m2) / o.nrs;
  o.e3 = (o.lo[6] * o.m0 + o.lo[7] * o.m1 + o.m2) / o.nrs;
  o.st = s.l_st[j];
  o.thr = o.st > 0.5f ? prm.stereo_line : prm.mono_line;
  o.sig = s.l_sig[j];
  return o;
}

__device__ __forceinline__ float line_chi2(const LineRow& o, float m) {
  float mst = m * o.st;
  return (o.e0 * o.e0 * m + o.e1 * o.e1 * m + o.e2 * o.e2 * mst + o.e3 * o.e3 * mst) * o.sig;
}

// acc[0..20] += w·JᵀJ (upper triangle, row-major), acc[21..26] += w·Jᵀr
template <int R>
__device__ __forceinline__ void accumulate(float* acc, float w, const float (*J)[R],
                                           const float* r) {
  int idx = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int c = a; c < 6; ++c) {
      float d = 0.0f;
#pragma unroll
      for (int q = 0; q < R; ++q) d += J[a][q] * J[c][q];
      acc[idx++] += w * d;
    }
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    float d = 0.0f;
#pragma unroll
    for (int q = 0; q < R; ++q) d += J[a][q] * r[q];
    acc[21 + a] += w * d;
  }
}

// One pass over this thread's rows at `pose`: the undamped normal equations
// (acc[0..26]) and the robust cost of the active rows (acc[27]), the cost
// summed in the order the separate cost pass used (points, then lines).
template <int NT>
__device__ void rows_eval(const Rows& s, const Cam& cam, const Pose& pose, const Params& prm,
                          float pose_free, float* acc) {
  const CamPose cp = camera_of(cam, pose);
  const V3 tb = mtv(pose.R, pose.t);
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;

  for (int i = threadIdx.x; i < s.np; i += NT) {
    PointRow o = point_vals(s, i, cam, cp, prm);
    float m = s.p_m[i];
    float mst = m * o.st;
    float chi2 = point_chi2(o, m);
    acc[27] += huber_cost(chi2, o.thr, m);
    float w = huber_w(chi2, o.thr) * m;
    float dzi_dz = o.guard ? 0.0f : -o.zi * o.zi;
    V3 pb = mtv(pose.R, load3(s.P, s.np, i) - pose.t);  // body-frame point
    float rr[3] = {o.r0 * m, o.r1 * m, o.r2 * mst};
    float J[6][3];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      V3 dpc = k < 3 ? mv(cam.Rcb, cross_e(pb, k)) : neg(col(cam.Rcb, k - 3));
      // residual = obs − projection, so J = −d(projection)
      float dzi = dzi_dz * dpc.z;
      float du = cam.fx * (dpc.x * o.zi + o.pc.x * dzi);
      float dv = cam.fy * (dpc.y * o.zi + o.pc.y * dzi);
      float dur = du - cam.bf * dzi;
      J[k][0] = (-du) * m * pose_free;
      J[k][1] = (-dv) * m * pose_free;
      J[k][2] = (-dur) * mst * pose_free;
    }
    accumulate<3>(acc, w, J, rr);
  }

  for (int j = NT - 1 - threadIdx.x; j < s.nl; j += NT) {
    LineRow o = line_vals(s, j, cam, cp, prm);
    const int nl = s.nl;
    float m = s.l_m[j];
    float mst = m * o.st;
    float chi2 = line_chi2(o, m);
    acc[27] += huber_cost(chi2, o.thr, m);
    float w = huber_w(chi2, o.thr) * m * o.sig;
    V3 wb = mtv(pose.R, v3(s.LN[j], s.LN[nl + j], s.LN[2 * nl + j]));
    V3 db = mtv(pose.R, v3(s.LN[3 * nl + j], s.LN[4 * nl + j], s.LN[5 * nl + j]));
    float er[4] = {o.e0 * m, o.e1 * m, o.e2 * mst, o.e3 * mst};
    // the Jacobian's divisions by the guarded norms as products with one
    // reciprocal each (the residuals and the cost above keep theirs)
    const float ins = 1.0f / o.ns, inrs = 1.0f / o.nrs;
    const float inn = 1.0f / fmaxf(o.n, 1e-30f), innr = 1.0f / fmaxf(o.nr, 1e-30f);
    float J[6][4];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      V3 dd, dwc;
      if (k < 3) {
        dd = mv(cam.Rcb, cross_e(db, k));
        V3 dtcw = neg(mv(cam.Rcb, cross_e(tb, k)));
        dwc = mv(cam.Rcb, cross_e(wb, k)) + cross(dtcw, o.dc) + cross(cp.tcw, dd);
      } else {
        dd = v3(0.0f, 0.0f, 0.0f);
        dwc = cross(neg(col(cam.Rcb, k - 3)), o.dc);
      }
      float dl0 = cam.fy * dwc.x, dl1 = cam.fx * dwc.y, dl2 = dot(cam.kv, dwc);
      float dns = o.n < 1e-12f ? 0.0f : (o.l0 * dl0 + o.l1 * dl1) * inn;
      float de0 = (o.lo[0] * dl0 + o.lo[1] * dl1 + dl2) * ins - o.e0 * dns * ins;
      float de1 = (o.lo[2] * dl0 + o.lo[3] * dl1 + dl2) * ins - o.e1 * dns * ins;
      V3 dwr = v3(dwc.x, dwc.y + cam.bb * dd.z, dwc.z - cam.bb * dd.y);
      float dm0 = cam.fy * dwr.x, dm1 = cam.fx * dwr.y, dm2 = dot(cam.kv, dwr);
      float dnr = o.nr < 1e-12f ? 0.0f : (o.m0 * dm0 + o.m1 * dm1) * innr;
      float de2 = (o.lo[4] * dm0 + o.lo[5] * dm1 + dm2) * inrs - o.e2 * dnr * inrs;
      float de3 = (o.lo[6] * dm0 + o.lo[7] * dm1 + dm2) * inrs - o.e3 * dnr * inrs;
      J[k][0] = de0 * m * pose_free;
      J[k][1] = de1 * m * pose_free;
      J[k][2] = de2 * mst * pose_free;
      J[k][3] = de3 * mst * pose_free;
    }
    accumulate<4>(acc, w, J, er);
  }
}

template <int NT>
__global__ void __launch_bounds__(NT)
pose_gn_kernel(const float* __restrict__ points, const float* __restrict__ pobs,
               const uint8_t* __restrict__ pmask, int np, const float* __restrict__ lines,
               const float* __restrict__ lobs, const uint8_t* __restrict__ lstereo,
               const uint8_t* __restrict__ lmask, const float* __restrict__ lsigma, int nl,
               const float* __restrict__ Rwb, const float* __restrict__ twb,
               const uint8_t* __restrict__ pose_fixed, const float* __restrict__ Rcb,
               const float* __restrict__ tcb, Params prm, float* __restrict__ pose_out,
               uint8_t* __restrict__ pin_out, uint8_t* __restrict__ lin_out,
               int* __restrict__ ninl_out) {
  static_assert(NT % 32 == 0 && NT / 32 <= kMaxWarps, "block of whole warps, at most 256");
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int prob = blockIdx.x;
  points += (size_t)prob * np * 3;
  pobs += (size_t)prob * np * 3;
  pmask += (size_t)prob * np;
  lines += (size_t)prob * nl * 6;
  lobs += (size_t)prob * nl * 8;
  lstereo += (size_t)prob * nl;
  lmask += (size_t)prob * nl;
  lsigma += (size_t)prob * nl;

  float* sP = smem;
  float* sOB = sP + 3 * np;
  float* sPbase = sOB + 3 * np;
  float* sPm = sPbase + np;
  float* sLN = sPm + np;
  float* sLO = sLN + 6 * nl;
  float* sLbase = sLO + 8 * nl;
  float* sLst = sLbase + nl;
  float* sLsig = sLst + nl;
  float* sLm = sLsig + nl;
  float* red = sLm + nl;  // 2·kMaxWarps·kAcc

  // stage the operands: (n, c) rows in global memory -> c planes of n
  for (int idx = tid; idx < 3 * np; idx += NT) {
    int i = idx / 3, c = idx - 3 * i;
    sP[c * np + i] = points[idx];
    sOB[c * np + i] = pobs[idx];
  }
  for (int i = tid; i < np; i += NT) {
    float m = pmask[i] ? 1.0f : 0.0f;
    sPbase[i] = m;
    sPm[i] = m;
  }
  for (int idx = tid; idx < 6 * nl; idx += NT) {
    int j = idx / 6, c = idx - 6 * j;
    sLN[c * nl + j] = lines[idx];
  }
  for (int idx = tid; idx < 8 * nl; idx += NT) {
    int j = idx / 8, c = idx - 8 * j;
    sLO[c * nl + j] = lobs[idx];
  }
  for (int j = tid; j < nl; j += NT) {
    float m = lmask[j] ? 1.0f : 0.0f;
    sLbase[j] = m;
    sLm[j] = m;
    sLst[j] = lstereo[j] ? 1.0f : 0.0f;
    sLsig[j] = lsigma[j];
  }
  __syncthreads();

  Rows s;
  s.np = np;
  s.nl = nl;
  s.P = sP;
  s.OB = sOB;
  s.p_base = sPbase;
  s.p_m = sPm;
  s.LN = sLN;
  s.LO = sLO;
  s.l_base = sLbase;
  s.l_st = sLst;
  s.l_sig = sLsig;
  s.l_m = sLm;

  Cam cam;
#pragma unroll
  for (int i = 0; i < 9; ++i) cam.Rcb[i] = Rcb[i];
  cam.tcb = v3(tcb[0], tcb[1], tcb[2]);
  cam.fx = prm.fx;
  cam.fy = prm.fy;
  cam.cx = prm.cx;
  cam.cy = prm.cy;
  cam.bf = prm.bf;
  cam.bb = prm.bf / prm.fx;
  cam.kv = v3(-prm.fy * prm.cx, -prm.fx * prm.cy, prm.fx * prm.fy);

  Pose pose0;
#pragma unroll
  for (int i = 0; i < 9; ++i) pose0.R[i] = Rwb[prob * 9 + i];
  pose0.t = v3(twb[prob * 3], twb[prob * 3 + 1], twb[prob * 3 + 2]);
  const float pose_free = pose_fixed[prob] ? 0.0f : 1.0f;

  Pose pose = pose0;
  float n_in = 0.0f;
  int phase = 0;  // which half of `red` the next reduction writes
  for (int round = 0; round < prm.rounds; ++round) {
    pose = pose0;
    float lam = prm.lam0, nu = prm.nu0;
    // H (upper), Jᵀr and the cost at `pose`
    float acc[kAcc];
    rows_eval<NT>(s, cam, pose, prm, pose_free, acc);
    block_sum<NT, kAcc>(acc, red, phase);
    for (int it = 0; it < prm.iters; ++it) {
      float H[6][6], b[6], dx[6];
      int idx = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int c = a; c < 6; ++c) {
          H[a][c] = acc[idx];
          H[c][a] = acc[idx];
          ++idx;
        }
        b[a] = -acc[21 + a];
      }
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        H[a][a] = H[a][a] + lam;
        H[a][a] = H[a][a] + (H[a][a] < 1e-10f ? 1.0f : 0.0f);
      }
      chol_solve6(H, b, dx);

      // retract: R2 = R·Exp(dx[0:3]), t2 = t + R·dx[3:6]
      Pose trial;
      float E[9];
      so3_exp(v3(dx[0], dx[1], dx[2]), E);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          trial.R[3 * i + j] = pose.R[3 * i] * E[j] + pose.R[3 * i + 1] * E[3 + j] +
                               pose.R[3 * i + 2] * E[6 + j];
      trial.t = pose.t + mv(pose.R, v3(dx[3], dx[4], dx[5]));

      // the trial's cost, and its H and b for the next iteration if accepted
      float tr[kAcc];
      rows_eval<NT>(s, cam, trial, prm, pose_free, tr);
      block_sum<NT, kAcc>(tr, red, phase);
      if (tr[27] < acc[27]) {  // uniform across the block
        pose = trial;
        lam = lam / 3.0f;
        nu = 2.0f;
#pragma unroll
        for (int i = 0; i < kAcc; ++i) acc[i] = tr[i];
      } else {  // H and b at `pose` stay as they are
        lam = lam * nu;
        nu = nu * 2.0f;
      }
    }

    // relabel over the FULL base observation set; each thread rewrites the
    // masks of the rows it owns and is the only reader of them
    const CamPose cp = camera_of(cam, pose);
    n_in = 0.0f;
    for (int i = tid; i < np; i += NT) {
      PointRow o = point_vals(s, i, cam, cp, prm);
      float base = s.p_base[i];
      float in = (point_chi2(o, base) <= o.thr && o.pc.z > 0.0f && base > 0.5f) ? 1.0f : 0.0f;
      s.p_m[i] = in;
      n_in += in;
    }
    for (int j = NT - 1 - tid; j < nl; j += NT) {
      LineRow o = line_vals(s, j, cam, cp, prm);
      float base = s.l_base[j];
      float in = (line_chi2(o, base) <= o.thr && base > 0.5f) ? 1.0f : 0.0f;
      s.l_m[j] = in;
      n_in += in;
    }
  }

  block_sum<NT, 1>(&n_in, red, phase);  // counts up to np + nl are exact in f32
  for (int i = tid; i < np; i += NT) pin_out[(size_t)prob * np + i] = s.p_m[i] > 0.5f;
  for (int j = NT - 1 - tid; j < nl; j += NT)
    lin_out[(size_t)prob * nl + j] = s.l_m[j] > 0.5f;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 9; ++i) pose_out[prob * 12 + i] = pose.R[i];
    pose_out[prob * 12 + 9] = pose.t.x;
    pose_out[prob * 12 + 10] = pose.t.y;
    pose_out[prob * 12 + 11] = pose.t.z;
    ninl_out[prob] = (int)(n_in + 0.5f);
  }
}

using KernelFn = decltype(&pose_gn_kernel<256>);

// the instantiation for a block of `threads` (0: the default), or null
KernelFn kernel_for(int threads) {
  switch (threads == 0 ? kDefaultThreads : threads) {
    case 64: return pose_gn_kernel<64>;
    case 128: return pose_gn_kernel<128>;
    case 256: return pose_gn_kernel<256>;
    default: return nullptr;
  }
}

}  // namespace

// Shared-memory bytes one problem of np points and nl lines needs.
extern "C" int airslam_pose_gn_smem_bytes(int np, int nl) {
  return (int)sizeof(float) * (8 * np + 18 * nl + 2 * kMaxWarps * kAcc);
}

// Launch on `stream`: `n_problems` problems of np points and nl lines each,
// their arrays stacked along a leading axis; Rcb/tcb are shared; `threads`
// is the block size (64, 128 or 256; 0 takes the default). Returns the CUDA
// error code of the launch (0 = success).
extern "C" int airslam_pose_gn(const void* points, const void* pobs, const void* pmask, int np,
                               const void* lines, const void* lobs, const void* lstereo,
                               const void* lmask, const void* lsigma, int nl, const void* Rwb,
                               const void* twb, const void* pose_fixed, const void* Rcb,
                               const void* tcb, float fx, float fy, float cx, float cy, float bf,
                               float mono_point, float stereo_point, float mono_line,
                               float stereo_line, float lam0, float nu0, int rounds, int iters,
                               int n_problems, void* pose_out, void* pin_out, void* lin_out,
                               void* ninl_out, int threads, void* stream) {
  const KernelFn kernel = kernel_for(threads);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  Params prm{fx, fy, cx, cy, bf, mono_point, stereo_point, mono_line, stereo_line,
             lam0, nu0, rounds, iters};
  const int smem = airslam_pose_gn_smem_bytes(np, nl);
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<n_problems, threads == 0 ? kDefaultThreads : threads, smem, (cudaStream_t)stream>>>(
      (const float*)points, (const float*)pobs, (const uint8_t*)pmask, np, (const float*)lines,
      (const float*)lobs, (const uint8_t*)lstereo, (const uint8_t*)lmask, (const float*)lsigma, nl,
      (const float*)Rwb, (const float*)twb, (const uint8_t*)pose_fixed, (const float*)Rcb,
      (const float*)tcb, prm, (float*)pose_out, (uint8_t*)pin_out, (uint8_t*)lin_out,
      (int*)ninl_out);
  return (int)cudaGetLastError();
}

// What the compiler gave the block size's instantiation: out = {registers
// per thread, static shared bytes, dynamic shared bytes for np points and nl
// lines, local (spill) bytes per thread, threads per block}. Returns a CUDA
// error code.
extern "C" int airslam_pose_gn_attributes(int threads, int np, int nl, int* out) {
  const KernelFn kernel = kernel_for(threads);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = airslam_pose_gn_smem_bytes(np, nl);
  out[3] = (int)attr.localSizeBytes;
  out[4] = threads == 0 ? kDefaultThreads : threads;
  return 0;
}
