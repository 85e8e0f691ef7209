"""Kernel P: the whole F=1 pose-only tracking solve (``csrc/pose_gn.cu``).

Replaces the Pallas TPU kernel ``airslam_tpu/backend/pose_gn_pallas.py:_kernel``
and its wrapper ``pose_only_fast_pallas``: ``rounds`` × ``iters`` LM
iterations with Huber weights, the analytic 6-column pose Jacobian of point
rows (3) and line rows (4), λ·I damping, an unrolled 6×6 Cholesky, the
right-multiplied SO3 update, a trial-cost accept and the chi² relabel between
rounds, all in one launch. What bounds it on the H100 and what the design
does about it is noted in the CUDA source.

:func:`pose_only_fast` is the wrapper: a problem whose tensors lie on the CPU
takes :func:`pose_only_fast_plain`, the plain tensor version with the
kernel's analytic Jacobians; a problem on a CUDA device launches the kernel
or raises. Both return what ``windows._pose_only_fast`` returns:
``(problem', point_inlier (P, 1), line_inlier (L, 1), num_inliers)``.

The guards carry derivative choices, as ``jacfwd`` through a ``where`` does:
the derivative of the guarded ``1/z`` is 0 where ``|z| < 1e-9``, and those of
the guarded line norms are 0 where the norm is ``< 1e-12``. The masks are
floats multiplied in, and ``pose_free`` multiplies every Jacobian column, so
a fixed pose comes back unchanged.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from airslam_tpu_torch.backend import gn
from airslam_tpu_torch.core import lie
from airslam_tpu_torch.ops import cuda_build

MAX_SHARED_BYTES = 232448  # shared memory one block can use on an H100


def _unit_cross(v: torch.Tensor) -> torch.Tensor:
    """(N, 3) -> (N, 3, 3) with [n, k] = v[n] × e_k (the Jacobian columns of
    Exp at 0)."""
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    return torch.linalg.cross(v[:, None, :].expand(-1, 3, 3), eye.expand(v.shape[0], 3, 3),
                              dim=-1)


class _Vision:
    """Residuals, chi², robust cost and the damped-free normal equations of
    the point and line rows at a pose (``_VisionCtx`` of the Pallas kernel,
    on (N,) tensors)."""

    def __init__(self, problem, intr, cfg):
        dtype, dev = problem.points.dtype, problem.points.device
        self.P = problem.points
        self.OB = problem.point_obs[:, 0, :]
        is_stereo = self.OB[:, 2] >= 0
        self.p_st = is_stereo.to(dtype)
        self.pthr = self.p_st * cfg.stereo_point + (1.0 - self.p_st) * cfg.mono_point
        self.LW, self.LD = problem.lines[:, 0:3], problem.lines[:, 3:6]
        self.LO = problem.line_obs[:, 0, :]
        self.l_st = problem.line_obs_stereo[:, 0].to(dtype)
        self.lthr = self.l_st * cfg.stereo_line + (1.0 - self.l_st) * cfg.mono_line
        self.lsig = problem.line_obs_sigma[:, 0]
        self.Rcb, self.tcb = problem.Rcb, problem.tcb
        self.fx, self.fy, self.cx, self.cy, self.bf = (
            float(intr.fx), float(intr.fy), float(intr.cx), float(intr.cy), float(intr.bf))
        self.kv = torch.tensor([-self.fy * self.cx, -self.fx * self.cy, self.fx * self.fy],
                               dtype=dtype, device=dev)
        self.bb = self.bf / self.fx
        self.pose_free = (~problem.pose_fixed[0]).to(dtype)

    def camera_of(self, R, t):
        Rcw = self.Rcb @ R.T
        return Rcw, self.tcb - Rcw @ t

    def point_vals(self, Rcw, tcw):
        pc = self.P @ Rcw.T + tcw
        z = pc[:, 2]
        guard = z.abs() < 1e-9
        zi = 1.0 / torch.where(guard, torch.full_like(z, 1e-9), z)
        u = pc[:, 0] * zi * self.fx + self.cx
        v = pc[:, 1] * zi * self.fy + self.cy
        ur = u - self.bf * zi
        return self.OB - torch.stack([u, v, ur], -1), pc, guard, zi

    def _image_line(self, w):
        l0, l1 = self.fy * w[:, 0], self.fx * w[:, 1]
        n = torch.sqrt(l0 * l0 + l1 * l1)
        return l0, l1, w @ self.kv, n, torch.where(n < 1e-12, torch.full_like(n, 1e-12), n)

    def _right_moment(self, w, d):
        return torch.stack([w[..., 0], w[..., 1] + self.bb * d[..., 2],
                            w[..., 2] - self.bb * d[..., 1]], -1)

    def line_vals(self, Rcw, tcw):
        dc = self.LD @ Rcw.T
        wc = self.LW @ Rcw.T + torch.linalg.cross(tcw.expand_as(dc), dc, dim=-1)
        left = self._image_line(wc)
        right = self._image_line(self._right_moment(wc, dc))
        LO = self.LO
        e = torch.stack([
            (LO[:, 0] * left[0] + LO[:, 1] * left[1] + left[2]) / left[4],
            (LO[:, 2] * left[0] + LO[:, 3] * left[1] + left[2]) / left[4],
            (LO[:, 4] * right[0] + LO[:, 5] * right[1] + right[2]) / right[4],
            (LO[:, 6] * right[0] + LO[:, 7] * right[1] + right[2]) / right[4]], -1)
        return e, left, right, wc, dc

    def rows(self, p_m, l_m):
        """Row masks: the stereo rows carry mask · stereo flag."""
        pst, lst = p_m * self.p_st, l_m * self.l_st
        return torch.stack([p_m, p_m, pst], -1), torch.stack([l_m, l_m, lst, lst], -1)

    def chi2_of(self, R, t, p_m, l_m):
        Rcw, tcw = self.camera_of(R, t)
        prow, lrow = self.rows(p_m, l_m)
        r, pc, _, _ = self.point_vals(Rcw, tcw)
        e = self.line_vals(Rcw, tcw)[0]
        return (r * r * prow).sum(-1), (e * e * lrow).sum(-1) * self.lsig, pc[:, 2]

    def cost_of(self, R, t, p_m, l_m):
        pchi2, lchi2, _ = self.chi2_of(R, t, p_m, l_m)
        return (gn._huber_cost(pchi2, self.pthr, p_m > 0.5)
                + gn._huber_cost(lchi2, self.lthr, l_m > 0.5))

    def normal_equations(self, R, t, p_m, l_m):
        """H (6, 6) and b (6,) of the weighted rows at (R, t), undamped."""
        Rcb, fx, fy, bf = self.Rcb, self.fx, self.fy, self.bf
        Rcw, tcw = self.camera_of(R, t)
        prow, lrow = self.rows(p_m, l_m)
        zeros3 = torch.zeros((3, 3), dtype=R.dtype, device=R.device)

        # -- point rows: residual = obs − projection, so J = −d(projection)
        r, pc, guard, zi = self.point_vals(Rcw, tcw)
        pchi2 = (r * r * prow).sum(-1)
        pw = _huber_w(pchi2, self.pthr) * p_m
        dzi_dz = torch.where(guard, torch.zeros_like(zi), -zi * zi)
        pb = (self.P - t) @ R  # body-frame point Rᵀ(P − t)
        n = pb.shape[0]
        dpc = torch.cat([_unit_cross(pb) @ Rcb.T, (-Rcb.T).expand(n, 3, 3)], 1)  # (N, 6, 3)
        dzi = dzi_dz[:, None] * dpc[..., 2]
        du = fx * (dpc[..., 0] * zi[:, None] + pc[:, 0, None] * dzi)
        dv = fy * (dpc[..., 1] * zi[:, None] + pc[:, 1, None] * dzi)
        dur = du - bf * dzi
        pJ = -torch.stack([du, dv, dur], -1) * prow[:, None, :] * self.pose_free

        # -- line rows
        e, left, right, wc, dc = self.line_vals(Rcw, tcw)
        lchi2 = (e * e * lrow).sum(-1) * self.lsig
        lw = _huber_w(lchi2, self.lthr) * l_m * self.lsig
        m = dc.shape[0]
        db, wb, tb = self.LD @ R, self.LW @ R, R.T @ t
        dd = torch.cat([_unit_cross(db) @ Rcb.T, zeros3.expand(m, 3, 3)], 1)  # (L, 6, 3)
        dtcw = torch.cat([-(_unit_cross(tb[None])[0] @ Rcb.T), -Rcb.T], 0)  # (6, 3)
        dwc = (torch.cat([_unit_cross(wb) @ Rcb.T, zeros3.expand(m, 3, 3)], 1)
               + torch.linalg.cross(dtcw.expand(m, 6, 3), dc[:, None, :].expand(m, 6, 3), dim=-1)
               + torch.linalg.cross(tcw.expand(m, 6, 3), dd, dim=-1))

        def d_errors(dw, image_line, ea, eb, oa, ob):
            l0, l1, _, nrm, ns = (v[:, None] for v in image_line)
            dl0, dl1, dl2 = fy * dw[..., 0], fx * dw[..., 1], dw @ self.kv
            dns = torch.where(nrm < 1e-12, torch.zeros_like(dl0),
                              (l0 * dl0 + l1 * dl1) / torch.clamp(nrm, min=1e-30))
            return tuple((self.LO[:, o, None] * dl0 + self.LO[:, o + 1, None] * dl1 + dl2) / ns
                         - ee[:, None] * dns / ns for o, ee in ((oa, ea), (ob, eb)))

        de0, de1 = d_errors(dwc, left, e[:, 0], e[:, 1], 0, 2)
        de2, de3 = d_errors(self._right_moment(dwc, dd), right, e[:, 2], e[:, 3], 4, 6)
        lJ = torch.stack([de0, de1, de2, de3], -1) * lrow[:, None, :] * self.pose_free

        H = (torch.einsum("n,nar,ncr->ac", pw, pJ, pJ)
             + torch.einsum("n,nar,ncr->ac", lw, lJ, lJ))
        b = -(torch.einsum("n,nar,nr->a", pw, pJ, r * prow)
              + torch.einsum("n,nar,nr->a", lw, lJ, e * lrow))
        return H, b


def _huber_w(chi2, delta2):
    return torch.where(chi2 <= delta2, torch.ones_like(chi2),
                       torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))


def pose_only_fast_plain(problem: gn.BAProblem, intr, cfg: gn.BAConfig = gn.BAConfig(),
                         rounds: int = 3, iters: int = 10):
    """Plain tensor version of kernel P (any float dtype, any device): the
    kernel's residuals, analytic Jacobian columns, damping, unrolled Cholesky,
    accept rule and relabel. No value is read back to the host."""
    from airslam_tpu_torch.backend.windows import POSE_LM_LAM0, POSE_LM_NU0

    dtype, dev = problem.points.dtype, problem.points.device
    vis = _Vision(problem, intr, cfg)
    p_base = problem.point_obs_mask[:, 0].to(dtype)
    l_base = problem.line_obs_mask[:, 0].to(dtype)
    R0, t0 = problem.frames.Rwb[0], problem.frames.twb[0]
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    p_m, l_m = p_base, l_base
    R, t = R0, t0
    for _ in range(rounds):
        R, t = R0, t0
        lam = torch.full((), POSE_LM_LAM0, dtype=dtype, device=dev)
        nu = torch.full((), POSE_LM_NU0, dtype=dtype, device=dev)
        cost = vis.cost_of(R, t, p_m, l_m)
        for _ in range(iters):
            H, b = vis.normal_equations(R, t, p_m, l_m)
            H = H + lam * eye6
            H = H + torch.diag((torch.diagonal(H) < 1e-10).to(dtype))
            dx = gn.solve_spd_small(H, b)
            R2 = R @ lie.so3_exp(dx[0:3])
            t2 = t + R @ dx[3:6]
            new_cost = vis.cost_of(R2, t2, p_m, l_m)
            accept = new_cost < cost
            R = torch.where(accept, R2, R)
            t = torch.where(accept, t2, t)
            lam = torch.where(accept, lam / 3.0, lam * nu)
            nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
            cost = torch.where(accept, new_cost, cost)
        # relabel over the FULL base observation set
        pchi2, lchi2, pz = vis.chi2_of(R, t, p_base, l_base)
        p_m = ((pchi2 <= vis.pthr) & (pz > 0) & (p_base > 0.5)).to(dtype)
        l_m = ((lchi2 <= vis.lthr) & (l_base > 0.5)).to(dtype)

    p_in, l_in = p_m > 0.5, l_m > 0.5
    out = problem._replace(frames=problem.frames._replace(Rwb=R[None], twb=t[None]))
    return out, p_in[:, None], l_in[:, None], p_in.sum() + l_in.sum()


@functools.cache
def _fns():
    """(launch, shared-memory bytes of one problem) of the built library."""
    lib = cuda_build.library("pose_gn")
    fn, smem = lib.airslam_pose_gn, lib.airslam_pose_gn_smem_bytes
    ptr, f32, i32 = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    fn.argtypes = ([ptr] * 3 + [i32] + [ptr] * 5 + [i32] + [ptr] * 5 + [f32] * 11
                   + [i32] * 3 + [ptr] * 4 + [i32, ptr])
    fn.restype = i32
    smem.argtypes, smem.restype = [i32, i32], i32
    return fn, smem


def kernel_attributes(threads: int = 0, npts: int = 256, nlns: int = 1) -> dict:
    """What the compiler gave the kernel's instantiation for a block of
    ``threads`` (0: the default), with the dynamic shared memory of a
    problem of ``npts`` points and ``nlns`` lines (``cudaFuncGetAttributes``)."""
    fn = cuda_build.library("pose_gn").airslam_pose_gn_attributes
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    err = fn(threads, npts, nlns, out)
    if err:
        raise RuntimeError(f"pose_only_fast attributes: CUDA error {err}")
    return dict(zip(("registers", "static_smem", "dynamic_smem", "local_bytes", "threads"), out))


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float32 and t.is_contiguous() else t.float().contiguous()


def _flag(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.bool and t.is_contiguous() else t.bool().contiguous()


def _operands(problem: gn.BAProblem) -> list:
    """The kernel's 13 operands in its order and types: no-ops for a float32
    problem (the builder's template), so every one is read where the problem
    keeps it."""
    return [_f32(problem.points), _f32(problem.point_obs), _flag(problem.point_obs_mask),
            _f32(problem.lines), _f32(problem.line_obs), _flag(problem.line_obs_stereo),
            _flag(problem.line_obs_mask), _f32(problem.line_obs_sigma),
            _f32(problem.frames.Rwb), _f32(problem.frames.twb), _flag(problem.pose_fixed),
            _f32(problem.Rcb), _f32(problem.tcb)]


def _launch(ops: list, npts: int, nlns: int, n_problems: int, intr, cfg: gn.BAConfig,
            rounds: int, iters: int, threads: int = 0):
    """One launch over ``n_problems`` problems of ``npts`` points and
    ``nlns`` lines whose operands (:func:`_operands`, every array but Rcb and
    tcb stacked on a leading axis) lie on one CUDA device. Returns pose
    (n, 12) float32, point and line inlier flags (n, npts), (n, nlns) and
    counts (n,) int32."""
    from airslam_tpu_torch.backend.windows import POSE_LM_LAM0, POSE_LM_NU0

    if threads not in (0, 64, 128, 256):
        raise ValueError(f"pose_only_fast: threads={threads} (0, 64, 128 or 256)")
    launch, smem_bytes = _fns()
    smem = smem_bytes(npts, nlns)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"pose_only_fast: {npts} points and {nlns} lines need {smem} bytes "
                         f"of shared memory (> {MAX_SHARED_BYTES})")
    dev = ops[0].device
    pose = torch.empty((n_problems, 12), dtype=torch.float32, device=dev)
    pin = torch.empty((n_problems, npts), dtype=torch.bool, device=dev)
    lin = torch.empty((n_problems, nlns), dtype=torch.bool, device=dev)
    count = torch.empty(n_problems, dtype=torch.int32, device=dev)
    p = [a.data_ptr() for a in ops]
    with torch.cuda.device(dev):
        err = launch(p[0], p[1], p[2], npts, p[3], p[4], p[5], p[6], p[7], nlns,
                    p[8], p[9], p[10], p[11], p[12],
                    float(intr.fx), float(intr.fy), float(intr.cx), float(intr.cy),
                    float(intr.bf), cfg.mono_point, cfg.stereo_point, cfg.mono_line,
                    cfg.stereo_line, POSE_LM_LAM0, POSE_LM_NU0, rounds, iters, n_problems,
                    pose.data_ptr(), pin.data_ptr(), lin.data_ptr(), count.data_ptr(), threads,
                    torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"pose_only_fast kernel launch failed: CUDA error {err}")
    return pose, pin, lin, count


def pose_only_fast(problem: gn.BAProblem, intr, cfg: gn.BAConfig = gn.BAConfig(),
                   rounds: int = 3, iters: int = 10):
    """Kernel P: solve the F=1 vision pose-only problem. A CPU problem runs
    the plain version; a CUDA problem is ONE kernel launch (float32, on the
    current stream, no synchronisation) and counts it."""
    if problem.imu is not None or problem.frames.Rwb.shape[0] != 1:
        raise ValueError("pose_only_fast solves the F=1 problem without IMU factors")
    if rounds < 1 or iters < 0:
        raise ValueError(f"pose_only_fast: rounds={rounds} (>= 1), iters={iters} (>= 0)")
    dev = problem.points.device
    if dev.type == "cpu":
        return pose_only_fast_plain(problem, intr, cfg, rounds, iters)
    leaves = (problem.points, problem.point_obs, problem.point_obs_mask, problem.lines,
              problem.line_obs, problem.line_obs_stereo, problem.line_obs_mask,
              problem.line_obs_sigma, problem.frames.Rwb, problem.frames.twb,
              problem.pose_fixed, problem.Rcb, problem.tcb)
    if dev.type != "cuda" or any(t.device != dev for t in leaves):
        raise ValueError(f"pose_only_fast: problem on {sorted({str(t.device) for t in leaves})}; "
                         "all of it must be on one CUDA device")
    npts, nlns = problem.points.shape[0], problem.lines.shape[0]
    if (problem.point_obs.shape != (npts, 1, 3) or problem.line_obs.shape != (nlns, 1, 8)
            or problem.lines.shape != (nlns, 6) or problem.points.shape != (npts, 3)):
        raise ValueError("pose_only_fast: points (P, 3), point_obs (P, 1, 3), lines (L, 6), "
                         "line_obs (L, 1, 8) expected")
    pose, pin, lin, count = _launch(_operands(problem), npts, nlns, 1, intr, cfg, rounds, iters)
    pose_only_fast.launches += 1
    dtype = problem.points.dtype
    out = problem._replace(frames=problem.frames._replace(
        Rwb=pose[0, 0:9].view(1, 3, 3).to(dtype), twb=pose[0, 9:12].view(1, 3).to(dtype)))
    return out, pin[0, :, None], lin[0, :, None], count[0]


pose_only_fast.launches = 0
