"""Optimization windows: the reference's g2o entry points on the batched LM
core.

Port of ``airslam_tpu/backend/windows.py``: :func:`local_ba` (:39-76) ↔
``LocalmapOptimization`` (g2o_optimization.cc:79-444): robust optimize(5) →
chi² outlier gating (+ depth-positive check for points) → non-robust
optimize(15) on the inliers → final inlier flags; the LM schedule constants
(:34-35), ``_pose6_residuals`` (:79-116, the ``vmap(jacfwd)`` form on
``torch.func``), ``_pose_only_fast`` (:119-207), ``_pose_only_general``
(:450-482) and the dispatch of ``pose_only_optimization`` (:379-446) ↔
``FrameOptimization`` (g2o_optimization.cc:446-898): landmarks fixed,
``rounds`` × ``iters`` LM iterations with per-round chi² relabeling;
``_pose_only_fast_vi`` (:210-378), the F=2 VI tracking solve; and the
visual-inertial initialization (:599-755) ↔ ``IMUInitialization``
(g2o_optimization.cc:900-1082) with its closed-form seeds
:func:`compute_gyr_bias` / :func:`compute_velocity`
(g2o_optimization.cc:1136-1229).

An F=1 vision problem goes to the whole-solver CUDA kernel
(``backend/pose_gn.py``) when its tensors are on a CUDA device, and to that
kernel's plain version when they are on the CPU. ``_pose_only_fast`` is the
autodiff form of the same solve: the independent check on the kernel's
analytic Jacobian columns. The VI tracking layout goes to
``_pose_only_fast_vi`` (plain PyTorch: the JAX package has no kernel for it);
any other problem to the general dense solver. :func:`pose_graph_optimization`
(:490-~560) ↔ the refinement's pose graph (map_refiner.cc:463-591): a dense
LM over 6F unknowns with relative-pose residuals.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from airslam_tpu_torch.backend import gn
from airslam_tpu_torch.backend import residuals as res
from airslam_tpu_torch.core import lie

# LM damping schedule shared by the autodiff solver below, the plain version
# and the CUDA kernel (backend/pose_gn.py): all three read these.
POSE_LM_LAM0 = 1e-5 * 100.0  # g2o: tau * max(diag(H)); diag ~O(1e2)
POSE_LM_NU0 = 2.0


def local_ba(problem: gn.BAProblem, intr, cfg: gn.BAConfig = gn.BAConfig(),
             iters1: int = 5, iters2: int = 15, early_exit: float = 0.0, mesh=None):
    """Two-stage sliding-window BA with chi² gating. Returns
    (problem, point_inlier (P, F), line_inlier (L, F)).

    ``early_exit`` > 0 (opt-in): end either LM stage when an accepted step's
    relative improvement drops below it (see gn.optimize). ``mesh``
    (``parallel/mesh.py``): both LM stages with the landmarks sharded over
    its dp devices (``gn.landmark_shards``); the gates are per observation
    and run on the problem's device."""
    problem = gn.optimize(problem, intr, cfg, iters1, robust=True, early_exit=early_exit,
                          mesh=mesh)
    dtype = problem.points.dtype

    # gate outliers (g2o_optimization.cc:350-385)
    pchi2, depth_ok = gn.point_chi2(problem, intr)
    is_stereo = problem.point_obs[..., 2] >= 0
    pthr = gn._thresholds(is_stereo, cfg.stereo_point, cfg.mono_point, dtype)
    p_in = (pchi2 <= pthr) & depth_ok & problem.point_obs_mask
    lchi2 = gn.line_chi2(problem, intr)
    lthr = gn._thresholds(problem.line_obs_stereo, cfg.stereo_line, cfg.mono_line, dtype)
    l_in = (lchi2 <= lthr) & problem.line_obs_mask

    gated = problem._replace(point_obs_mask=p_in, line_obs_mask=l_in)
    gated = gn.optimize(gated, intr, cfg, iters2, robust=False, early_exit=early_exit,
                        mesh=mesh)

    # final inlier flags (g2o_optimization.cc:389-407) on the original masks
    final = gated._replace(point_obs_mask=problem.point_obs_mask,
                           line_obs_mask=problem.line_obs_mask)
    pchi2, depth_ok = gn.point_chi2(final, intr)
    point_inlier = (pchi2 <= pthr) & depth_ok & problem.point_obs_mask
    lchi2 = gn.line_chi2(final, intr)
    line_inlier = (lchi2 <= lthr) & problem.line_obs_mask
    return final, point_inlier, line_inlier


def _pose6_residuals(problem: gn.BAProblem, intr, Rwb, twb, with_jac: bool):
    """Point/line residuals + 6-dof pose Jacobians of the F=1 pose-only
    problem (landmarks fixed). Returns (pr (P,3), pz (P,), pJ (P,3,6),
    lr (L,4), lJ (L,4,6)); the Jacobians are zero without ``with_jac``."""
    dtype, dev = problem.points.dtype, problem.points.device

    def residuals(d6, line_or_point, obs, is_point):
        R2, t2 = res.retract_pose(Rwb, twb, d6)
        Rcw, tcw = res.pose_to_camera(R2, t2, problem.Rcb, problem.tcb)
        if is_point:
            return res.point_residual(Rcw, tcw, line_or_point, obs, intr)
        r = res.line_residual(Rcw, tcw, line_or_point, obs, intr)
        return r, r.new_zeros(())  # lines carry no depth

    def one(is_point):
        def fn(landmark, obs):
            def f(d6):
                r, z = residuals(d6, landmark, obs, is_point)
                return r, (r, z)

            if with_jac:
                J, (r, z) = torch.func.jacfwd(f, has_aux=True)(
                    torch.zeros(6, dtype=dtype, device=dev))
                # under vmap a 0-d tangent times a Python float is promoted
                # to float64; the Jacobian goes back to the problem's dtype
                J = J.to(dtype)
            else:
                r, z = f(torch.zeros(6, dtype=dtype, device=dev))[1]
                J = torch.zeros((r.shape[0], 6), dtype=dtype, device=dev)
            return (r, z, J) if is_point else (r, J)

        return fn

    pr, pz, pJ = torch.func.vmap(one(True))(problem.points, problem.point_obs[:, 0, :])
    lr, lJ = torch.func.vmap(one(False))(problem.lines, problem.line_obs[:, 0, :])
    return pr, pz, pJ, lr, lJ


def _pose_only_fast(problem, intr, cfg, rounds: int, iters: int):
    """F=1, landmarks fixed, no IMU: residuals, Huber weights, LM damping
    schedule and per-round relabeling of the general solver, assembled as one
    damped 6×6 system per iteration, with ``jacfwd`` Jacobians. Returns
    (problem', point_inlier (P,1), line_inlier (L,1), num_inliers)."""
    dtype = problem.points.dtype
    frames0 = problem.frames
    base_p_mask = problem.point_obs_mask[:, 0]
    base_l_mask = problem.line_obs_mask[:, 0]
    is_stereo = problem.point_obs[:, 0, 2] >= 0
    l_stereo = problem.line_obs_stereo[:, 0]

    pthr = gn._thresholds(is_stereo, cfg.stereo_point, cfg.mono_point, dtype)
    lthr = gn._thresholds(l_stereo, cfg.stereo_line, cfg.mono_line, dtype)
    lsigma = problem.line_obs_sigma[:, 0]
    pose_free = (~problem.pose_fixed[0]).to(dtype)
    eye6 = torch.eye(6, dtype=dtype, device=pthr.device)

    def masks_rows(p_mask, l_mask):
        prow = torch.stack([p_mask, p_mask, p_mask & is_stereo], -1).to(dtype)
        lrow = torch.stack([l_mask, l_mask, l_mask & l_stereo, l_mask & l_stereo],
                           -1).to(dtype)
        return prow, lrow

    def chi2_of(Rwb, twb, prow, lrow):
        pr, pz, _, lr, _ = _pose6_residuals(problem, intr, Rwb, twb, False)
        return (pr * pr * prow).sum(-1), (lr * lr * lrow).sum(-1) * lsigma, pz

    def cost_of(Rwb, twb, p_mask, l_mask):
        pchi2, lchi2, _ = chi2_of(Rwb, twb, *masks_rows(p_mask, l_mask))
        return gn._huber_cost(pchi2, pthr, p_mask) + gn._huber_cost(lchi2, lthr, l_mask)

    def run_round(Rwb, twb, p_mask, l_mask):
        prow, lrow = masks_rows(p_mask, l_mask)
        R, t = Rwb, twb
        lam = torch.full((), POSE_LM_LAM0, dtype=dtype, device=pthr.device)
        nu = torch.full((), POSE_LM_NU0, dtype=dtype, device=pthr.device)
        cost = cost_of(R, t, p_mask, l_mask)
        for _ in range(iters):
            pr, _, pJ, lr, lJ = _pose6_residuals(problem, intr, R, t, True)
            pchi2 = (pr * pr * prow).sum(-1)
            pw = res.huber_weight(pchi2, pthr) * p_mask
            lchi2 = (lr * lr * lrow).sum(-1) * lsigma
            lw = res.huber_weight(lchi2, lthr) * l_mask * lsigma
            pJ = pJ * prow[..., None] * pose_free
            lJ = lJ * lrow[..., None] * pose_free
            H = (torch.einsum("k,kri,krj->ij", pw, pJ, pJ)
                 + torch.einsum("k,kri,krj->ij", lw, lJ, lJ))
            b = -(torch.einsum("k,kri,kr->i", pw, pJ, pr * prow)
                  + torch.einsum("k,kri,kr->i", lw, lJ, lr * lrow))
            H = H + lam * eye6
            diag = torch.diagonal(H)
            H = H + torch.diag((diag < 1e-10).to(dtype))
            dx = gn.solve_spd_small(H, b)
            R2, t2 = res.retract_pose(R, t, dx)
            new_cost = cost_of(R2, t2, p_mask, l_mask)
            accept = new_cost < cost
            R = torch.where(accept, R2, R)
            t = torch.where(accept, t2, t)
            lam = torch.where(accept, lam / 3.0, lam * nu)
            nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
            cost = torch.where(accept, new_cost, cost)
        # relabel over the FULL base observation set
        pchi2, lchi2, pz = chi2_of(R, t, *masks_rows(base_p_mask, base_l_mask))
        p_in = (pchi2 <= pthr) & (pz > 0) & base_p_mask
        l_in = (lchi2 <= lthr) & base_l_mask
        return R, t, p_in, l_in

    p_mask, l_mask = base_p_mask, base_l_mask
    for _ in range(rounds):
        R, t, p_mask, l_mask = run_round(frames0.Rwb[0], frames0.twb[0], p_mask, l_mask)

    out = problem._replace(frames=frames0._replace(Rwb=R[None], twb=t[None]))
    return out, p_mask[:, None], l_mask[:, None], p_mask.sum() + l_mask.sum()


def _pose_only_fast_vi(problem, intr, cfg, rounds: int, iters: int):
    """VI tracking specialization: F=2 with frame 0 the FIXED last keyframe
    and frame 1 the current frame (pose + velocity + bias free, 15 dof), one
    IMU factor 0→1, gravity fixed (the reference's FrameOptimization keeps
    the gravity-direction vertex fixed, g2o_optimization.cc:446-898). One
    damped 15×15 system per LM iteration, solved by ``gn.solve_spd`` (one
    Cholesky: the unrolled scalar form the JAX package uses would be about
    1,400 tiny launches per iteration on the card). Returns (problem',
    point_inlier (P,2), line_inlier (L,2), num_inliers)."""
    dtype = problem.points.dtype
    dev = problem.points.device
    fr0 = problem.frames
    imu = problem.imu
    cur = 1
    base_p_mask = problem.point_obs_mask[:, cur]
    base_l_mask = problem.line_obs_mask[:, cur]
    is_stereo = problem.point_obs[:, cur, 2] >= 0
    l_stereo = problem.line_obs_stereo[:, cur]
    pthr = gn._thresholds(is_stereo, cfg.stereo_point, cfg.mono_point, dtype)
    lthr = gn._thresholds(l_stereo, cfg.stereo_line, cfg.mono_line, dtype)
    lsigma = problem.line_obs_sigma[:, cur]
    pose_free = (~problem.pose_fixed[cur]).to(dtype)
    vel_free = (~problem.vel_fixed[cur]).to(dtype)
    col_free = torch.cat([pose_free.expand(6), vel_free.expand(9)])
    Ri, ti, vi = fr0.Rwb[0], fr0.twb[0], fr0.vel[0]
    bgi, bai = fr0.bg[0], fr0.ba[0]
    info9 = imu.info[0] * cfg.imu_info_scale
    imu_mask = imu.mask[0].to(dtype)
    info_walk = imu.info_walk[0] * imu_mask
    big_info0 = torch.block_diag(info9, info_walk)
    pre = (imu.dR[0], imu.dV[0], imu.dP[0], imu.JRg[0], imu.JVg[0], imu.JVa[0],
           imu.JPg[0], imu.JPa[0], imu.bg_lin[0], imu.ba_lin[0], imu.dT[0])
    eye15 = torch.eye(15, dtype=dtype, device=dev)
    # the F=1 residual helper on the current column's observations
    p1 = problem._replace(point_obs=problem.point_obs[:, cur:cur + 1],
                          line_obs=problem.line_obs[:, cur:cur + 1])

    def masks_rows(p_mask, l_mask):
        prow = torch.stack([p_mask, p_mask, p_mask & is_stereo], -1).to(dtype)
        lrow = torch.stack([l_mask, l_mask, l_mask & l_stereo, l_mask & l_stereo],
                           -1).to(dtype)
        return prow, lrow

    def imu_residual_15(R, t, v, bg, ba, with_jac):
        def f(d15):
            Rj2, tj2 = res.retract_pose(R, t, d15[0:6])
            bgj2 = bg + d15[9:12]
            baj2 = ba + d15[12:15]
            r9 = res.imu_residual(Ri, ti, vi, Rj2, tj2, v + d15[6:9], bgj2, baj2, *pre,
                                  problem.Rwg, problem.g_value)
            r = torch.cat([r9, bgj2 - bgi, baj2 - bai])
            return r, r

        if with_jac:
            J, (r, _) = gn._jac_with_value(f, 15, dtype, dev)
            return r, J.to(dtype) * col_free[None, :]
        return f(torch.zeros(15, dtype=dtype, device=dev))[0], None

    def cost_of(R, t, v, bg, ba, p_mask, l_mask):
        pr, _, _, lr, _ = _pose6_residuals(p1, intr, R, t, False)
        prow, lrow = masks_rows(p_mask, l_mask)
        pchi2 = (pr * pr * prow).sum(-1)
        lchi2 = (lr * lr * lrow).sum(-1) * lsigma
        cost = gn._huber_cost(pchi2, pthr, p_mask) + gn._huber_cost(lchi2, lthr, l_mask)
        ir, _ = imu_residual_15(R, t, v, bg, ba, False)
        r9, rw = ir[:9], ir[9:]
        c_imu = r9 @ info9 @ r9
        return (cost + gn._huber_cost(c_imu[None], 16.92, imu.mask[0:1])
                + rw @ info_walk @ rw)

    def run_round(R, t, v, bg, ba, p_mask, l_mask):
        prow, lrow = masks_rows(p_mask, l_mask)
        lam = torch.full((), POSE_LM_LAM0, dtype=dtype, device=dev)
        nu = torch.full((), POSE_LM_NU0, dtype=dtype, device=dev)
        cost = cost_of(R, t, v, bg, ba, p_mask, l_mask)
        for _ in range(iters):
            pr, _, pJ6, lr, lJ6 = _pose6_residuals(p1, intr, R, t, True)
            pchi2 = (pr * pr * prow).sum(-1)
            pw = res.huber_weight(pchi2, pthr) * p_mask
            lchi2 = (lr * lr * lrow).sum(-1) * lsigma
            lw = res.huber_weight(lchi2, lthr) * l_mask * lsigma
            pJ6 = pJ6 * prow[..., None] * pose_free
            lJ6 = lJ6 * lrow[..., None] * pose_free
            H6 = (torch.einsum("k,kri,krj->ij", pw, pJ6, pJ6)
                  + torch.einsum("k,kri,krj->ij", lw, lJ6, lJ6))
            b6 = -(torch.einsum("k,kri,kr->i", pw, pJ6, pr * prow)
                   + torch.einsum("k,kri,kr->i", lw, lJ6, lr * lrow))
            H = torch.zeros((15, 15), dtype=dtype, device=dev)
            H[:6, :6] = H6
            b = torch.zeros(15, dtype=dtype, device=dev)
            b[:6] = b6

            ir, iJ = imu_residual_15(R, t, v, bg, ba, True)
            r9 = ir[:9]
            c_imu = r9 @ info9 @ r9
            wi = res.huber_weight(c_imu[None], torch.full((1,), 16.92, dtype=dtype,
                                                          device=dev))[0] * imu_mask
            big_info = big_info0.clone()
            big_info[:9, :9] = info9 * wi
            JtW = iJ.T @ big_info  # (15, 15)
            H = H + JtW @ iJ
            b = b - JtW @ ir

            H = H + lam * eye15
            H = H + torch.diag((torch.diagonal(H) < 1e-10).to(dtype))
            dx = gn.solve_spd(H, b)
            R2, t2 = res.retract_pose(R, t, dx[0:6])
            v2, bg2, ba2 = v + dx[6:9], bg + dx[9:12], ba + dx[12:15]
            new_cost = cost_of(R2, t2, v2, bg2, ba2, p_mask, l_mask)
            accept = new_cost < cost

            def pick(a, b2):
                return torch.where(accept, a, b2)

            R, t, v, bg, ba = pick(R2, R), pick(t2, t), pick(v2, v), pick(bg2, bg), pick(ba2, ba)
            lam = pick(lam / 3.0, lam * nu)
            nu = pick(torch.full_like(nu, 2.0), nu * 2.0)
            cost = pick(new_cost, cost)
        # relabel over the FULL base observation set
        pr, pz, _, lr, _ = _pose6_residuals(p1, intr, R, t, False)
        prow, lrow = masks_rows(base_p_mask, base_l_mask)
        p_in = ((pr * pr * prow).sum(-1) <= pthr) & (pz > 0) & base_p_mask
        l_in = ((lr * lr * lrow).sum(-1) * lsigma <= lthr) & base_l_mask
        return R, t, v, bg, ba, p_in, l_in

    p_mask, l_mask = base_p_mask, base_l_mask
    v, bg, ba = fr0.vel[cur], fr0.bg[cur], fr0.ba[cur]
    for _ in range(rounds):
        # per-round reset re-seeds the pose; velocity/bias keep running
        R, t, v, bg, ba, p_mask, l_mask = run_round(
            fr0.Rwb[cur], fr0.twb[cur], v, bg, ba, p_mask, l_mask)

    new_frames = gn.FrameStates(
        Rwb=torch.stack([fr0.Rwb[0], R]), twb=torch.stack([fr0.twb[0], t]),
        vel=torch.stack([fr0.vel[0], v]), bg=torch.stack([fr0.bg[0], bg]),
        ba=torch.stack([fr0.ba[0], ba]))
    out = problem._replace(frames=new_frames)
    p_in2 = torch.stack([torch.zeros_like(p_mask), p_mask], -1)
    l_in2 = torch.stack([torch.zeros_like(l_mask), l_mask], -1)
    return out, p_in2, l_in2, p_mask.sum() + l_mask.sum()


def pose_only_optimization(problem: gn.BAProblem, intr, cfg: gn.BAConfig = gn.BAConfig(),
                           rounds: int = 3, iters: int = 10,
                           vi_tracking: Optional[bool] = None):
    """Pose-only optimization: all landmarks fixed. Per round: reset the pose
    to the initial estimate (``current_frame->setEstimate(current_pose)``,
    g2o_optimization.cc:730), optimize with the Huber kernel on the currently
    active observations, then relabel by chi². Returns (problem,
    point_inlier, line_inlier, num_inliers).

    Dispatch:
    - the vision F=1 problem: one launch of the whole-solver kernel on a CUDA
      device, the kernel's plain version on the CPU;
    - the VI tracking layout (F=2, one IMU factor 0→1, frame 0 fixed with
      frame 1's pose free): :func:`_pose_only_fast_vi` (15×15);
    - anything else: the general dense solver.

    ``vi_tracking``: ``True`` asserts the tracking layout without reading the
    fix pattern back from the device (raises ValueError on a problem that is
    not F=2 with one IMU factor), ``False`` forces the general solver,
    ``None`` inspects the fix pattern's values."""
    problem = problem._replace(point_fixed=torch.ones_like(problem.point_fixed),
                               line_fixed=torch.ones_like(problem.line_fixed))
    F = problem.frames.Rwb.shape[0]
    if problem.imu is None and F == 1:
        from airslam_tpu_torch.backend import pose_gn

        return pose_gn.pose_only_fast(problem, intr, cfg, rounds=rounds, iters=iters)
    vi_shape = problem.imu is not None and F == 2 and problem.imu.idx_i.shape[0] == 1
    if vi_tracking and not vi_shape:
        raise ValueError(
            "vi_tracking=True requires F=2 with exactly one IMU factor "
            f"(got F={F}, imu={'yes' if problem.imu is not None else 'no'})")
    if vi_shape and vi_tracking is None:
        pf = problem.pose_fixed.tolist()
        vf = problem.vel_fixed.tolist()
        ij = (int(problem.imu.idx_i[0]), int(problem.imu.idx_j[0]))
        vi_tracking = pf[0] and not pf[1] and vf[0] and ij == (0, 1)
    if vi_shape and vi_tracking:
        return _pose_only_fast_vi(problem, intr, cfg, rounds=rounds, iters=iters)
    return _pose_only_general(problem, intr, cfg, rounds=rounds, iters=iters)


def _pose_only_general(problem: gn.BAProblem, intr, cfg: gn.BAConfig = gn.BAConfig(),
                       rounds: int = 3, iters: int = 10):
    """The pose-only rounds on the general dense solver, for any number of
    frames (the caller fixes the landmarks)."""
    frames0 = problem.frames
    base_p_mask = problem.point_obs_mask
    base_l_mask = problem.line_obs_mask
    dtype = problem.points.dtype
    is_stereo = problem.point_obs[..., 2] >= 0
    pthr = gn._thresholds(is_stereo, cfg.stereo_point, cfg.mono_point, dtype)
    lthr = gn._thresholds(problem.line_obs_stereo, cfg.stereo_line, cfg.mono_line, dtype)

    p_in, l_in = base_p_mask, base_l_mask
    for _ in range(rounds):
        # reset only the pose (the reference re-seeds the pose vertex; the
        # velocity/bias vertices keep their running estimates)
        problem = problem._replace(
            frames=problem.frames._replace(Rwb=frames0.Rwb, twb=frames0.twb))
        problem = gn.optimize(problem, intr, cfg, iters, robust=True)
        # relabel over the FULL base observation set (the reference refreshes
        # outlier edges with computeError() before re-testing chi², so gated
        # observations can return — g2o_optimization.cc:735-739)
        probe = problem._replace(point_obs_mask=base_p_mask, line_obs_mask=base_l_mask)
        pchi2, depth_ok = gn.point_chi2(probe, intr)
        p_in = (pchi2 <= pthr) & depth_ok & base_p_mask
        l_in = (gn.line_chi2(probe, intr) <= lthr) & base_l_mask
        problem = problem._replace(point_obs_mask=p_in, line_obs_mask=l_in)

    out = problem._replace(point_obs_mask=base_p_mask, line_obs_mask=base_l_mask)
    return out, p_in, l_in, p_in.sum() + l_in.sum()


# ---------------------------------------------------------------------------
# Pose graph
# ---------------------------------------------------------------------------


class PoseGraphProblem(NamedTuple):
    Rwb: torch.Tensor  # (F, 3, 3)
    twb: torch.Tensor  # (F, 3)
    fixed: torch.Tensor  # (F,) bool
    edge_i: torch.Tensor  # (E,) int64
    edge_j: torch.Tensor  # (E,)
    R_meas: torch.Tensor  # (E, 3, 3) relative T_i⁻¹ T_j measurement
    t_meas: torch.Tensor  # (E, 3)
    mask: torch.Tensor  # (E,) bool


def _pose_graph_cost(p: PoseGraphProblem, Rwb, twb):
    i, j = p.edge_i, p.edge_j
    r = torch.func.vmap(res.relative_pose_residual)(Rwb[i], twb[i], Rwb[j], twb[j],
                                                    p.R_meas, p.t_meas)
    return torch.where(p.mask, (r * r).sum(-1), torch.zeros_like(r[:, 0])).sum()


def pose_graph_optimization(p: PoseGraphProblem, iterations: int = 20) -> PoseGraphProblem:
    """Dense LM over 6F unknowns with relative-pose residuals, the first
    pose(s) held by ``fixed``; accept/reject on the device, no read-back
    inside the loop. Each edge's 12×12 block goes into the (6F)² system by
    one ``index_add_`` over a flattened index, in a fixed order
    (``gn.deterministic``)."""
    f = p.Rwb.shape[0]
    D = f * 6
    dtype, dev = p.twb.dtype, p.twb.device
    free = (~p.fixed).to(dtype)
    i, j = p.edge_i, p.edge_j
    ar = torch.arange(6, device=dev)
    cols = torch.cat([i[:, None] * 6 + ar, j[:, None] * 6 + ar], dim=1)  # (E, 12)
    key = (cols[:, :, None] * D + cols[:, None, :]).reshape(-1)
    cm = torch.cat([free[i][:, None].expand(-1, 6), free[j][:, None].expand(-1, 6)], dim=1)
    w = p.mask.to(dtype)

    def edge(Ri, ti, Rj, tj, Rm, tm):
        def fe(delta):
            Ri2, ti2 = res.retract_pose(Ri, ti, delta[0:6])
            Rj2, tj2 = res.retract_pose(Rj, tj, delta[6:12])
            r = res.relative_pose_residual(Ri2, ti2, Rj2, tj2, Rm, tm)
            return r, r

        J, (r, _) = gn._jac_with_value(fe, 12, dtype, dev)
        return r, J.to(dtype)

    def solve_once(Rwb, twb, lam):
        r, J = torch.func.vmap(edge)(Rwb[i], twb[i], Rwb[j], twb[j], p.R_meas, p.t_meas)
        J = J * cm[:, None, :] * w[:, None, None]
        r = r * w[:, None]
        Hk = torch.einsum("eri,erj->eij", J, J)
        bk = -torch.einsum("eri,er->ei", J, r)
        H = torch.zeros(D * D, dtype=dtype, device=dev)
        b = torch.zeros(D, dtype=dtype, device=dev)
        with gn.deterministic():
            H.index_add_(0, key, Hk.reshape(-1))
            b.index_add_(0, cols.reshape(-1), bk.reshape(-1))
        H = H.reshape(D, D) + torch.diag(lam * torch.ones(D, dtype=dtype, device=dev))
        H = H + torch.diag((torch.diagonal(H) < 1e-10).to(dtype))
        dx = gn.solve_spd(H, b).reshape(f, 6)
        # a factorization that failed gives NaN: the cost gate rejects the
        # step, and zeroing keeps the rejected candidate finite
        dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))
        return torch.func.vmap(res.retract_pose)(Rwb, twb, dx)

    with gn.full_f32():
        Rwb, twb = p.Rwb, p.twb
        cost = _pose_graph_cost(p, Rwb, twb)
        lam = torch.full((), 1e-5, dtype=cost.dtype, device=dev)
        nu = torch.full((), 2.0, dtype=cost.dtype, device=dev)
        two = torch.full_like(nu, 2.0)
        for _ in range(iterations):
            Rn, tn = solve_once(Rwb, twb, lam)
            new_cost = _pose_graph_cost(p, Rn, tn)
            accept = new_cost < cost
            Rwb = torch.where(accept, Rn, Rwb)
            twb = torch.where(accept, tn, twb)
            lam = torch.where(accept, lam / 3.0, lam * nu)
            nu = torch.where(accept, two, nu * 2.0)
            cost = torch.where(accept, new_cost, cost)
    return p._replace(Rwb=Rwb, twb=twb)


# ---------------------------------------------------------------------------
# Visual-inertial initialization
# ---------------------------------------------------------------------------


def compute_gyr_bias(Rwb_seq, dR_seq, JRg_seq):
    """Closed-form gyro bias from rotation alignment least squares
    (``ComputeGyrBias``, g2o_optimization.cc:1136-1156): for consecutive
    frames minimize |Log(dRᵀ · Rᵢᵀ Rⱼ) − JRg·bg|²."""
    e = lie.so3_log(dR_seq.mT @ Rwb_seq[:-1].mT @ Rwb_seq[1:])  # (K, 3)
    H = (JRg_seq.mT @ JRg_seq).sum(0)
    g = (JRg_seq.mT @ e[..., None])[..., 0].sum(0)
    return torch.linalg.solve(H + 1e-12 * torch.eye(3, dtype=H.dtype, device=H.device), g)


def compute_velocity(Rwb_seq, twb_seq, dP_seq, dV_seq, dT_seq, g_value):
    """Closed-form velocities + gravity from the linear system over
    preintegrated deltas (``ComputeVelocity``, g2o_optimization.cc:1171-1229).

    Unknowns: per-frame velocity (3F) + gravity vector (3). Equations per
    interval k: position and velocity preintegration constraints. Returns
    (velocities (F, 3), gravity (3,)). The system is assembled on the host
    from one pull of the inputs and solved by least squares on their device.
    """
    f = Rwb_seq.shape[0]
    n = 3 * f + 3
    dtype, dev = twb_seq.dtype, twb_seq.device
    R, t, dP, dV, dT = (a.detach().cpu().double().numpy()
                        for a in (Rwb_seq, twb_seq, dP_seq, dV_seq, dT_seq))
    eye = np.eye(3)
    rows, rhs = [], []
    for i in range(f - 1):
        # position: t_{i+1} = t_i + v_i dT + ½ g dT² + R_i dP
        A_p = np.zeros((3, n))
        A_p[:, 3 * i: 3 * i + 3] = eye * dT[i]
        A_p[:, 3 * f: 3 * f + 3] = 0.5 * dT[i] ** 2 * eye
        # velocity: v_{i+1} = v_i + g dT + R_i dV
        A_v = np.zeros((3, n))
        A_v[:, 3 * i: 3 * i + 3] = -eye
        A_v[:, 3 * (i + 1): 3 * (i + 1) + 3] = eye
        A_v[:, 3 * f: 3 * f + 3] = -dT[i] * eye
        rows.extend([A_p, A_v])
        rhs.extend([t[i + 1] - t[i] - R[i] @ dP[i], R[i] @ dV[i]])
    A = torch.as_tensor(np.concatenate(rows), device=dev).to(dtype)
    bb = torch.as_tensor(np.concatenate(rhs), device=dev).to(dtype)
    x = torch.linalg.lstsq(A, bb[:, None]).solution[:, 0]
    return x[: 3 * f].reshape(f, 3), x[3 * f:]


def imu_initialization(Rwb, twb, vel0, bg0, ba0, Rwg0, preint: dict, g_value: float,
                       prior_bg, prior_ba, iterations: int = 200,
                       info_prior_gyr: float = 1e2, info_prior_acc: float = 1e5):
    """Visual-inertial initialization (``IMUInitialization``,
    g2o_optimization.cc:900-1082): optimize per-frame velocities, ONE shared
    gyr/acc bias pair (with priors 1e2 / 1e5) and the 2-dof gravity
    direction, with all poses fixed, by ``iterations`` LM steps (the
    reference's budget: 200, g2o_optimization.cc:1027). ``preint``: dict of
    stacked (F-1, …) preintegration tensors dR, dV, dP, JRg, JVg, JVa, JPg,
    JPa, dT, info (9, 9); the linearization bias is (bg0, ba0). Accept/reject
    and the damping stay on the device: the loop reads nothing back. Returns
    (velocities (F, 3), bg, ba, Rwg)."""
    f = Rwb.shape[0]
    n = 3 * f + 6 + 2  # velocities | bg | ba | gravity tangent
    dtype, dev = twb.dtype, twb.device
    keys = ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa")
    per = (Rwb[:-1], twb[:-1], Rwb[1:], twb[1:]) + tuple(preint[k] for k in keys) + (preint["dT"],)
    info = preint["info"]

    def rwg_of(x):
        return Rwg0 @ lie.so3_exp(torch.cat([x[3 * f + 6:], x.new_zeros(1)]))

    def residuals(x):
        vels = x[: 3 * f].reshape(f, 3)
        bg = x[3 * f: 3 * f + 3]
        ba = x[3 * f + 3: 3 * f + 6]
        Rwg = rwg_of(x)

        def one(Ri, ti, Rj, tj, dR, dV, dP, JRg, JVg, JVa, JPg, JPa, dT, vi, vj):
            return res.imu_residual(Ri, ti, vi, Rj, tj, vj, bg, ba, dR, dV, dP,
                                    JRg, JVg, JVa, JPg, JPa, bg0, ba0, dT, Rwg, g_value)

        r = torch.func.vmap(one)(*per, vels[:-1], vels[1:])  # (K, 9)
        return r, bg - prior_bg, ba - prior_ba

    def cost(x):
        r, rbg, rba = residuals(x)
        return (torch.einsum("ki,kij,kj->", r, info, r)
                + info_prior_gyr * rbg @ rbg + info_prior_acc * rba @ rba)

    eye = torch.eye(n, dtype=dtype, device=dev)
    prior_diag = torch.zeros(n, dtype=dtype, device=dev)
    prior_diag[3 * f: 3 * f + 3] = info_prior_gyr
    prior_diag[3 * f + 3: 3 * f + 6] = info_prior_acc

    def solve(x, lam):
        J = torch.func.jacfwd(lambda y: residuals(y)[0])(x)  # (K, 9, n)
        r, rbg, rba = residuals(x)
        JtW = torch.einsum("krc,krs->ksc", J, info)
        H = torch.einsum("ksc,ksd->cd", JtW, J) + torch.diag(prior_diag)
        b = -torch.einsum("ksc,ks->c", JtW, r)
        b = b - torch.cat([x.new_zeros(3 * f), info_prior_gyr * rbg, info_prior_acc * rba,
                           x.new_zeros(2)])
        dx = gn.solve_spd(H + lam * eye, b)
        # the cost gate rejects a non-finite candidate; zeroing keeps the
        # candidate itself finite
        return x + torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))

    with gn.full_f32():
        x = torch.cat([vel0.reshape(-1), bg0, ba0, torch.zeros(2, dtype=dtype, device=dev)])
        lam = torch.full((), 1e-4, dtype=dtype, device=dev)
        nu = torch.full((), 2.0, dtype=dtype, device=dev)
        c = cost(x)
        for _ in range(iterations):
            cand = solve(x, lam)
            c2 = cost(cand)
            accept = c2 < c
            x = torch.where(accept, cand, x)
            lam = torch.where(accept, lam / 3.0, lam * nu)
            nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
            c = torch.where(accept, c2, c)
    return x[: 3 * f].reshape(f, 3), x[3 * f: 3 * f + 3], x[3 * f + 3: 3 * f + 6], rwg_of(x)


def gravity_to_rwg(gravity):
    """Rotation aligning the world z-down gravity to the estimated gravity
    direction (the Rwg convention of VertexGDirection / map.cc:1168-1200), in
    ``gravity``'s dtype."""
    dtype, dev = gravity.dtype, gravity.device
    gI = torch.tensor([0.0, 0.0, -1.0], dtype=dtype, device=dev)
    gn_ = gravity / torch.linalg.norm(gravity)
    v = torch.linalg.cross(gI, gn_)
    s = torch.linalg.norm(v)
    c = torch.dot(gI, gn_)
    vhat = lie.hat(v)
    eye = torch.eye(3, dtype=dtype, device=dev)
    R = eye + vhat + vhat @ vhat * ((1 - c) / torch.clamp(s * s, min=1e-12))
    return torch.where(s < 1e-8, eye, R)
