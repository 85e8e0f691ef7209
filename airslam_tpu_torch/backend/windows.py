"""Optimization windows: the reference's g2o entry points on the batched LM
core, for vision-only problems.

Port of ``airslam_tpu/backend/windows.py``: :func:`local_ba` (:39-76) ↔
``LocalmapOptimization`` (g2o_optimization.cc:79-444): robust optimize(5) →
chi² outlier gating (+ depth-positive check for points) → non-robust
optimize(15) on the inliers → final inlier flags; the LM schedule constants
(:34-35), ``_pose6_residuals`` (:79-116, the ``vmap(jacfwd)`` form on
``torch.func``), ``_pose_only_fast`` (:119-207), ``_pose_only_general``
(:450-482) and the dispatch of ``pose_only_optimization`` (:379-446) ↔
``FrameOptimization`` (g2o_optimization.cc:446-898): landmarks fixed,
``rounds`` × ``iters`` LM iterations with per-round chi² relabeling.

An F=1 vision problem goes to the whole-solver CUDA kernel
(``backend/pose_gn.py``) when its tensors are on a CUDA device, and to that
kernel's plain version when they are on the CPU. ``_pose_only_fast`` is the
autodiff form of the same solve: the independent check on the kernel's
analytic Jacobian columns. Any other vision problem goes to the general dense
solver. The VI tracking solve, the pose graph and the IMU initialization are
not ported yet.
"""

from __future__ import annotations

import torch

from airslam_tpu_torch.backend import gn
from airslam_tpu_torch.backend import residuals as res

# LM damping schedule shared by the autodiff solver below, the plain version
# and the CUDA kernel (backend/pose_gn.py): all three read these.
POSE_LM_LAM0 = 1e-5 * 100.0  # g2o: tau * max(diag(H)); diag ~O(1e2)
POSE_LM_NU0 = 2.0


def local_ba(problem: gn.BAProblem, intr, cfg: gn.BAConfig = gn.BAConfig(),
             iters1: int = 5, iters2: int = 15, early_exit: float = 0.0):
    """Two-stage sliding-window BA with chi² gating. Returns
    (problem, point_inlier (P, F), line_inlier (L, F)).

    ``early_exit`` > 0 (opt-in): end either LM stage when an accepted step's
    relative improvement drops below it (see gn.optimize)."""
    problem = gn.optimize(problem, intr, cfg, iters1, robust=True, early_exit=early_exit)
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
    gated = gn.optimize(gated, intr, cfg, iters2, robust=False, early_exit=early_exit)

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


def pose_only_optimization(problem: gn.BAProblem, intr, cfg: gn.BAConfig = gn.BAConfig(),
                           rounds: int = 3, iters: int = 10):
    """Pose-only optimization: all landmarks fixed. Per round: reset the pose
    to the initial estimate (``current_frame->setEstimate(current_pose)``,
    g2o_optimization.cc:730), optimize with the Huber kernel on the currently
    active observations, then relabel by chi². Returns (problem,
    point_inlier, line_inlier, num_inliers).

    The vision F=1 problem is one launch of the whole-solver kernel on a CUDA
    device and the kernel's plain version on the CPU; any other vision problem
    goes to the general dense solver."""
    if problem.imu is not None:
        raise NotImplementedError(
            "pose-only optimization with an IMU factor (windows._pose_only_fast_vi) "
            "belongs to the stereo-inertial slice (ROADMAP queue 3)")
    problem = problem._replace(point_fixed=torch.ones_like(problem.point_fixed),
                               line_fixed=torch.ones_like(problem.line_fixed))
    if problem.frames.Rwb.shape[0] == 1:
        from airslam_tpu_torch.backend import pose_gn

        return pose_gn.pose_only_fast(problem, intr, cfg, rounds=rounds, iters=iters)
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
