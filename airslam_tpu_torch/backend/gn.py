"""Batched Levenberg-Marquardt bundle adjustment with Schur-complement
elimination.

Port of ``airslam_tpu/backend/gn.py`` (which replaces g2o's sparse optimizer,
``LocalmapOptimization``/``FrameOptimization`` in
src/g2o_optimization/g2o_optimization.cc). The problem is a dense fixed-shape
grid:

- observations live on (landmark, frame) grids: a landmark is seen at most
  once per frame, so a (P, F) mask describes the topology;
- per-observation Jacobians come from ``vmap(jacfwd)`` over the grid
  (``torch.func``), exact and batched;
- the points' 3×3 blocks are inverted in closed form and their Schur
  complement is a handful of contractions; each line is eliminated by four
  Householder reflections of its weighted rows (:func:`_line_system`), which
  stays exact where a line's rows are far larger than the rest of the window;
- the reduced camera system is solved dense, by Cholesky: F·6 dims for a
  vision-only window, F·15 + 2 with IMU factors (pose, velocity and biases
  per frame, and the 2-dof gravity direction);
- fixed vertices are handled by masking their Jacobian columns and pinning
  the diagonal, so one shape serves every fix pattern.

LM damping/accept logic follows g2o's Levenberg strategy (λ ← λ/3 on accept,
λ ← λ·ν, ν ← 2ν on reject). Robust weighting: Huber with δ² = the chi²
threshold. The chi²-gating schedule (optimize(5) → drop outlier observations →
optimize(15)) is driven by ``backend/windows.py``.

The IMU factors' residuals come from ``vmap(jacfwd)`` over the factors,
and each factor's 15/15/2 sub-blocks go into the (F, 15, F, 15) frame block
grid by one-hot contractions, as in the JAX package. Nothing in the LM loop reads a value back to the host: accept/reject are
``torch.where`` on device scalars (only ``early_exit`` reads one flag per
step). Matrix products run in full float32 (TF32 off, see :func:`full_f32`).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from airslam_tpu_torch.backend import residuals as res
from airslam_tpu_torch.core import lie
from airslam_tpu_torch.parallel.mesh import even_bounds, reduce_sum
from airslam_tpu_torch.utils.timing import span

POSE_DIM = 6
# Smallest |det| admitted by the closed-form block inverses; far below any
# legitimate damped-SPD determinant (λ floor ≥ 1e-5 ⇒ det ≥ 1e-15) yet keeps
# 1/det finite in float32's subnormal range.
_DET_FLOOR = 1e-30
VEL_DIM = 3
BIAS_DIM = 6
FRAME_DIM = POSE_DIM + VEL_DIM + BIAS_DIM  # 15
GRAV_DIM = 2

@contextlib.contextmanager
def full_f32():
    """Float32 matrix products of the backend in full precision: TF32 is
    switched OFF for the block and the caller's setting restored after it (a
    TF32 product keeps ~3 decimal digits, too few for the normal equations)."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms on for the block, the caller's
    setting restored after: ``index_add_`` on a CUDA tensor then sums in a
    fixed (sorted-key) order instead of by atomics, so two runs give the same
    bits. Wraps only scatter-adds (a cuBLAS product under the switch needs a
    workspace setting)."""
    before = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before, warn_only=warn)


class FrameStates(NamedTuple):
    Rwb: torch.Tensor  # (F, 3, 3)
    twb: torch.Tensor  # (F, 3)
    vel: torch.Tensor  # (F, 3)
    bg: torch.Tensor  # (F, 3)
    ba: torch.Tensor  # (F, 3)


class IMUFactors(NamedTuple):
    """K preintegration factors; factor k links frames idx_i[k] → idx_j[k]."""

    idx_i: torch.Tensor  # (K,) int32
    idx_j: torch.Tensor  # (K,)
    dR: torch.Tensor  # (K, 3, 3)
    dV: torch.Tensor  # (K, 3)
    dP: torch.Tensor  # (K, 3)
    JRg: torch.Tensor  # (K, 3, 3)
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    bg_lin: torch.Tensor  # (K, 3) linearization gyro bias
    ba_lin: torch.Tensor  # (K, 3)
    dT: torch.Tensor  # (K,)
    info: torch.Tensor  # (K, 9, 9) PSD-projected inverse preintegration covariance
    info_walk: torch.Tensor  # (K, 6, 6) bias random-walk information (gyr then acc)
    mask: torch.Tensor  # (K,) bool


class BAProblem(NamedTuple):
    frames: FrameStates
    pose_fixed: torch.Tensor  # (F,) bool
    vel_fixed: torch.Tensor  # (F,) bool (velocity + biases)
    points: torch.Tensor  # (P, 3)
    point_fixed: torch.Tensor  # (P,) bool
    point_obs: torch.Tensor  # (P, F, 3) — (u, v, u_r); u_r < 0 ⇒ mono
    point_obs_mask: torch.Tensor  # (P, F) bool
    lines: torch.Tensor  # (L, 6) Plücker (w, d)
    line_fixed: torch.Tensor  # (L,) bool
    line_obs: torch.Tensor  # (L, F, 8)
    line_obs_stereo: torch.Tensor  # (L, F) bool
    line_obs_mask: torch.Tensor  # (L, F) bool
    line_obs_sigma: torch.Tensor  # (L, F) information scale (pixel_sigma, map.cc:724)
    Rwg: torch.Tensor  # (3, 3) gravity direction
    gravity_free: torch.Tensor  # () float — 1.0 optimizes gravity, 0.0 pins it
    imu: Optional[IMUFactors]
    # camera
    Rcb: torch.Tensor  # (3, 3)
    tcb: torch.Tensor  # (3,)
    g_value: float = 9.81  # gravity magnitude (camera.cc g_value)


class BAConfig(NamedTuple):
    """Chi² thresholds (OptimizationConfig, read_configs.h / vo_euroc.yaml)."""

    mono_point: float = 50.0
    stereo_point: float = 75.0
    mono_line: float = 50.0
    stereo_line: float = 75.0
    line_sigma: float = 0.5  # pixel_sigma information scale ("rate" in cfg)
    imu_info_scale: float = 1e-2  # g2o_optimization.cc:321


_BOOL_LEAVES = ("pose_fixed", "vel_fixed", "point_fixed", "point_obs_mask",
                "line_fixed", "line_obs_stereo", "line_obs_mask", "mask")
_INDEX_LEAVES = ("idx_i", "idx_j")


def problem_from_numpy(problem, dtype=torch.float32, device="cpu") -> BAProblem:
    """A ``BAProblem`` of tensors from one whose leaves are numpy arrays (or
    anything ``np.asarray`` reads, e.g. the JAX package's problem pulled to the
    host): float leaves in ``dtype``, masks as bool, factor indices as int64,
    on ``device``. The leaves are matched by field name, the IMU factors'
    too."""

    def leaf(name, value):
        a = np.asarray(value)
        if name in _BOOL_LEAVES:
            return torch.as_tensor(a.astype(bool), device=device)
        if name in _INDEX_LEAVES:
            return torch.as_tensor(a.astype(np.int64), device=device)
        return torch.as_tensor(a.astype(np.float64), device=device).to(dtype)

    def leaves(container, cls):
        return cls(*(leaf(n, getattr(container, n)) for n in cls._fields))

    imu = getattr(problem, "imu", None)
    fields = {n: leaf(n, getattr(problem, n)) for n in BAProblem._fields
              if n not in ("frames", "imu", "g_value")}
    return BAProblem(frames=leaves(problem.frames, FrameStates),
                     imu=None if imu is None else leaves(imu, IMUFactors),
                     g_value=float(np.asarray(problem.g_value)), **fields)


def _jac_with_value(f, n, dtype=None, device=None):
    """Forward-mode Jacobian at zero + primal value, for f: (n,) -> (out, aux).
    ``dtype`` types the tangent seed."""
    zero = torch.zeros((n,), dtype=dtype, device=device)

    def split(delta):
        out = f(delta)
        return out[0], out

    return torch.func.jacfwd(split, has_aux=True)(zero)


def solve_spd_small(H, b):
    """Solve ``H x = b`` for a small (n ≤ ~16) symmetric positive-definite
    ``H`` by a fully unrolled Cholesky factorization on scalar elements — the
    arithmetic, in the order, of the tracking kernel's 6×6 solve. The damped
    LM Hessian is SPD by construction (JᵀWJ + λI, λ > 0), so no pivoting."""
    n = H.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = H[j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(s)
        L[j][j] = d
        inv = 1.0 / d
        for i in range(j + 1, n):
            t = H[i, j]
            for k in range(j):
                t = t - L[i][k] * L[j][k]
            L[i][j] = t * inv
    y = [None] * n  # forward: L y = b
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n  # back: Lᵀ x = y
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x)


def _huber_cost(chi2, delta2, active):
    lin = 2.0 * torch.sqrt(delta2 * torch.clamp(chi2, min=1e-12)) - delta2
    zero = torch.zeros_like(chi2)
    return torch.where(active, torch.where(chi2 <= delta2, chi2, lin), zero).sum()


# ---------------------------------------------------------------------------
# residual/jacobian evaluation over the dense grids
# ---------------------------------------------------------------------------


def _grid(one, landmarks, obs, Rwb, twb):
    """``one(R, t, landmark, obs)`` over the (landmark, frame) grid: the outer
    map runs over the landmarks and their observation rows, the inner over
    the frames."""

    def over_frames(landmark, obs_row):
        return torch.func.vmap(lambda R, t, o: one(R, t, landmark, o))(Rwb, twb, obs_row)

    return torch.func.vmap(over_frames)(landmarks, obs)


def _point_grid_residuals(problem: BAProblem, intr, with_jac: bool):
    """Returns r (P,F,3), row_mask (P,F,3), depth_ok (P,F) and, with
    ``with_jac``, Jc (P,F,3,6), Jp (P,F,3,3) (else None, None)."""
    fr = problem.frames
    dtype, dev = problem.points.dtype, problem.points.device

    def one(Rwb, twb, point, obs):
        def f(delta):
            R2, t2 = res.retract_pose(Rwb, twb, delta[0:6])
            Rcw, tcw = res.pose_to_camera(R2, t2, problem.Rcb, problem.tcb)
            return res.point_residual(Rcw, tcw, point + delta[6:9], obs, intr)

        if with_jac:
            J, (r, z) = _jac_with_value(f, 9, dtype, dev)
            return r, z, J.to(dtype)
        return f(torch.zeros(9, dtype=dtype, device=dev))

    out = _grid(one, problem.points, problem.point_obs, fr.Rwb, fr.twb)
    r, z = out[0], out[1]
    Jc, Jp = (out[2][..., 0:6], out[2][..., 6:9]) if with_jac else (None, None)
    m = problem.point_obs_mask
    is_stereo = problem.point_obs[..., 2] >= 0
    row_mask = torch.stack([m, m, m & is_stereo], dim=-1).to(r.dtype)
    return r, row_mask, z > 0, Jc, Jp


def _line_grid_residuals(problem: BAProblem, intr, with_jac: bool):
    """Returns r (L,F,4), row_mask (L,F,4) and, with ``with_jac``,
    Jc (L,F,4,6), Jl (L,F,4,4) (else None, None)."""
    fr = problem.frames
    dtype, dev = problem.lines.dtype, problem.lines.device

    def one(Rwb, twb, line, obs):
        def f(delta):
            R2, t2 = res.retract_pose(Rwb, twb, delta[0:6])
            Rcw, tcw = res.pose_to_camera(R2, t2, problem.Rcb, problem.tcb)
            line2 = lie.line_orthonormal_oplus(line, delta[6:10])
            r = res.line_residual(Rcw, tcw, line2, obs, intr)
            return r, r

        if with_jac:
            J, (r, _) = _jac_with_value(f, 10, dtype, dev)
            return r, J.to(dtype)
        return (f(torch.zeros(10, dtype=dtype, device=dev))[0],)

    out = _grid(one, problem.lines, problem.line_obs, fr.Rwb, fr.twb)
    r = out[0]
    Jc, Jl = (out[1][..., 0:6], out[1][..., 6:10]) if with_jac else (None, None)
    m, st = problem.line_obs_mask, problem.line_obs_mask & problem.line_obs_stereo
    row_mask = torch.stack([m, m, st, st], dim=-1).to(r.dtype)
    return r, row_mask, Jc, Jl


def _imu_residuals(problem: BAProblem, with_jac: bool):
    return imu_residuals(problem.frames, problem.imu, problem.Rwg, with_jac, problem.g_value)


def imu_residuals(fr: FrameStates, imu: IMUFactors, Rwg, with_jac: bool, g_value=9.81):
    """Residuals (K, 15) = the 9-d preintegration residual and the 6-d bias
    random walk, and with ``with_jac`` their Jacobians (K, 15, 32) (else
    None). Delta layout per factor: (frame_i 15 | frame_j 15 | gravity 2).
    The frames' states are gathered per factor before the map over the
    factors."""
    dtype, dev = fr.twb.dtype, fr.twb.device
    ii, jj = imu.idx_i.long(), imu.idx_j.long()
    per_factor = (fr.Rwb[ii], fr.twb[ii], fr.vel[ii], fr.bg[ii], fr.ba[ii],
                  fr.Rwb[jj], fr.twb[jj], fr.vel[jj], fr.bg[jj], fr.ba[jj],
                  imu.dR, imu.dV, imu.dP, imu.JRg, imu.JVg, imu.JVa, imu.JPg, imu.JPa,
                  imu.bg_lin, imu.ba_lin, imu.dT)

    def one(Ri, ti, vi, bgi, bai, Rj, tj, vj, bgj, baj, *pre):
        def f(delta):
            di, dj, dg = delta[0:15], delta[15:30], delta[30:32]
            Ri2, ti2 = res.retract_pose(Ri, ti, di[0:6])
            Rj2, tj2 = res.retract_pose(Rj, tj, dj[0:6])
            bgj2 = bgj + dj[9:12]
            baj2 = baj + dj[12:15]
            Rwg2 = Rwg @ lie.so3_exp(torch.cat([dg, dg.new_zeros(1)]))
            r9 = res.imu_residual(Ri2, ti2, vi + di[6:9], Rj2, tj2, vj + dj[6:9], bgj2, baj2,
                                  *pre, Rwg2, g_value)
            # bias random walk: bg_j − bg_i, ba_j − ba_i (EdgeGyr/EdgeAcc)
            r = torch.cat([r9, bgj2 - (bgi + di[9:12]), baj2 - (bai + di[12:15])])
            return r, r

        if with_jac:
            J, (r, _) = _jac_with_value(f, 32, dtype, dev)
            return r, J.to(dtype)
        return (f(torch.zeros(32, dtype=dtype, device=dev))[0],)

    out = torch.func.vmap(one)(*per_factor)
    return out[0], (out[1] if with_jac else None)


# ---------------------------------------------------------------------------
# chi² and robust cost
# ---------------------------------------------------------------------------


def point_chi2(problem: BAProblem, intr):
    """Per-observation chi² (P, F) + depth-positive flag, for gating/inliers
    (mono: 2 rows, stereo: 3 — e->chi2() with identity information)."""
    r, row_mask, depth_ok, _, _ = _point_grid_residuals(problem, intr, with_jac=False)
    return (r * r * row_mask).sum(-1), depth_ok


def line_chi2(problem: BAProblem, intr, sigma=None):
    """Per-observation chi² with the per-observation information scale
    (``sigma`` overrides; default = problem.line_obs_sigma)."""
    r, row_mask, _, _ = _line_grid_residuals(problem, intr, with_jac=False)
    s = problem.line_obs_sigma if sigma is None else sigma
    return (r * r * row_mask).sum(-1) * s


def _floor_det(det):
    """|det| floored away from zero, sign kept (sign(0) → +): a near-singular
    block under tiny LM damping would otherwise give inf/NaN in float32 and
    poison the Schur complement."""
    return torch.where(det >= 0, det.clamp(min=_DET_FLOOR), det.clamp(max=-_DET_FLOOR))


def inv3_spd(A):
    """Closed-form (adjugate) inverse of (..., 3, 3) SPD blocks: exact,
    branch-free, elementwise. The blocks are SPD by construction (JᵀWJ + λI),
    so there is no pivoting concern."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = e * i - f * h
    c01 = c * h - b * i
    c02 = b * f - c * e
    c10 = f * g - d * i
    c11 = a * i - c * g
    c12 = c * d - a * f
    c20 = d * h - e * g
    c21 = b * g - a * h
    c22 = a * e - b * d
    det = _floor_det(a * c00 + b * c10 + c * c20)
    inv = torch.stack([
        torch.stack([c00, c01, c02], dim=-1),
        torch.stack([c10, c11, c12], dim=-1),
        torch.stack([c20, c21, c22], dim=-1),
    ], dim=-2)
    return inv / det[..., None, None]


def _inv2(A):
    det = _floor_det(A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0])
    inv = torch.stack([
        torch.stack([A[..., 1, 1], -A[..., 0, 1]], dim=-1),
        torch.stack([-A[..., 1, 0], A[..., 0, 0]], dim=-1),
    ], dim=-2)
    return inv / det[..., None, None]


def inv4_spd(A):
    """(..., 4, 4) SPD inverse via 2×2 block inversion (Schur on the trailing
    2×2) with closed-form 2×2 inverses."""
    P = A[..., :2, :2]
    Q = A[..., :2, 2:]
    R = A[..., 2:, 2:]
    Pi = _inv2(P)
    PiQ = Pi @ Q
    S = R - Q.mT @ PiQ
    Si = _inv2(S)
    TL = Pi + PiQ @ Si @ PiQ.mT
    TR = -PiQ @ Si
    top = torch.cat([TL, TR], dim=-1)
    bot = torch.cat([TR.mT, Si], dim=-1)
    return torch.cat([top, bot], dim=-2)


def solve_spd(H, b):
    """Solve ``H x = b`` for a symmetric positive-definite ``H`` via Cholesky
    and two triangular solves. ``cholesky_ex`` leaves its status on the
    device (plain ``cholesky`` reads it back to the host on every call); a
    factorization that failed gives NaN, which the LM cost gate rejects."""
    L, info = torch.linalg.cholesky_ex((H + H.mT) * 0.5)
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]
    return torch.where((info > 0)[..., None], torch.full_like(x, float("nan")), x)


def _thresholds(flag, hi: float, lo: float, dtype):
    """``hi`` where ``flag`` else ``lo``, as a tensor of ``dtype``."""
    return torch.where(flag, torch.full((), hi, dtype=dtype, device=flag.device),
                       torch.full((), lo, dtype=dtype, device=flag.device))


def _point_cost(problem: BAProblem, intr, cfg: BAConfig, robust: bool):
    pchi2, _ = point_chi2(problem, intr)
    is_stereo = problem.point_obs[..., 2] >= 0
    pthr = _thresholds(is_stereo, cfg.stereo_point, cfg.mono_point, pchi2.dtype)
    active_p = problem.point_obs_mask
    if robust:
        return _huber_cost(pchi2, pthr, active_p)
    return torch.where(active_p, pchi2, torch.zeros_like(pchi2)).sum()


def _line_cost(problem: BAProblem, intr, cfg: BAConfig, robust: bool):
    lchi2 = line_chi2(problem, intr)
    lthr = _thresholds(problem.line_obs_stereo, cfg.stereo_line, cfg.mono_line, lchi2.dtype)
    active_l = problem.line_obs_mask
    if robust:
        return _huber_cost(lchi2, lthr, active_l)
    return torch.where(active_l, lchi2, torch.zeros_like(lchi2)).sum()


def total_cost(problem: BAProblem, intr, cfg: BAConfig, robust: bool, mesh=None):
    """The LM cost. With a ``mesh`` each landmark shard's point and line
    terms are computed on its device and summed on the problem's; the IMU
    terms, frame-only, once."""
    pshards, lshards = landmark_shards(problem, mesh)
    dev = problem.points.device
    cost = (reduce_sum([_point_cost(s, intr, cfg, robust) for s in pshards], dev)
            + reduce_sum([_line_cost(s, intr, cfg, robust) for s in lshards], dev))
    if problem.imu is not None:
        with span("lm.imu"):
            r, _ = _imu_residuals(problem, with_jac=False)
            r9, rw = r[:, :9], r[:, 9:]
            m = problem.imu.mask
            c_imu = torch.einsum("ki,kij,kj->k", r9, problem.imu.info * cfg.imu_info_scale, r9)
            c_walk = torch.einsum("ki,kij,kj->k", rw, problem.imu.info_walk, rw)
            if robust:
                # Huber delta² = 16.92 on the 9-d residual (g2o_optimization.cc:321)
                cost = cost + _huber_cost(c_imu, 16.92, m)
            else:
                cost = cost + torch.where(m, c_imu, torch.zeros_like(c_imu)).sum()
            cost = cost + torch.where(m, c_walk, torch.zeros_like(c_walk)).sum()
    return cost


# ---------------------------------------------------------------------------
# landmark shards over a device mesh (parallel/mesh.py)
# ---------------------------------------------------------------------------

_POINT_LEAVES = ("points", "point_fixed", "point_obs", "point_obs_mask")
_LINE_LEAVES = ("lines", "line_fixed", "line_obs", "line_obs_stereo", "line_obs_mask",
                "line_obs_sigma")


def _frame_leaves_on(problem: BAProblem, device) -> dict:
    """The leaves every landmark shard reads (frames, fixes, camera) on
    ``device``."""
    return {"frames": FrameStates(*(t.to(device) for t in problem.frames)),
            "pose_fixed": problem.pose_fixed.to(device), "Rcb": problem.Rcb.to(device),
            "tcb": problem.tcb.to(device)}


def landmark_shards(problem: BAProblem, mesh=None):
    """(point shards, line shards): each a ``BAProblem`` on one dp device of
    ``mesh`` holding the frames and camera and a contiguous slice of one
    landmark family with its observation rows (the JAX package's
    ``shard_problem``: landmark-major arrays over dp, the rest replicated). A
    family whose count dp does not divide is one shard on the problem's
    device. Without a mesh: the problem itself, once per family."""
    if mesh is None:
        return [problem], [problem]
    devs = mesh.dp_devices()

    def family(leaves, n):
        bounds = even_bounds(n, len(devs))
        out = []
        for (lo, hi), dev in zip(bounds, devs if len(bounds) > 1 else [problem.points.device]):
            fields = {k: getattr(problem, k)[lo:hi].to(dev) for k in leaves}
            out.append(problem._replace(**_frame_leaves_on(problem, dev), **fields))
        return out

    return (family(_POINT_LEAVES, problem.points.shape[0]),
            family(_LINE_LEAVES, problem.lines.shape[0]))


# ---------------------------------------------------------------------------
# normal equations assembly + Schur solve
# ---------------------------------------------------------------------------


def _damped_landmarks(Hb, k: int, lam):
    """Landmark blocks + λI, an unseen landmark's block pinned to identity."""
    eye = torch.eye(k, dtype=Hb.dtype, device=Hb.device)
    unseen = (torch.einsum("nii->n", Hb) < 1e-10).to(Hb.dtype)
    return Hb + lam * eye + eye * unseen[:, None, None]


def _schur_terms(W, Hinv, b, f: int):
    """The landmark family's Schur complement onto the pose rows: Y = W·Hinv
    per landmark, then ONE real contraction over (landmark, landmark-dof).
    Returns (S (6F, 6F), bs (F, 6))."""
    Y = (W[..., :, None] * Hinv[:, None, None, :, :]).sum(dim=3)
    n = f * POSE_DIM
    return torch.einsum("pfac,pgdc->fagd", Y, W).reshape(n, n), (Y * b[:, None, None, :]).sum(
        dim=(0, 3))


def _point_system(problem: BAProblem, intr, cfg: BAConfig, lam, robust: bool):
    """The point family's share of one LM solve: its reduced pose system
    H (6F, 6F) = blockdiag(Hcc) − S and right side (F, 6) = bc − bs, and
    (W, Hinv, b) for the back-substitution."""
    dtype = problem.points.dtype
    r, row_mask, _, Jc, Jp = _point_grid_residuals(problem, intr, True)
    is_stereo = problem.point_obs[..., 2] >= 0
    thr = _thresholds(is_stereo, cfg.stereo_point, cfg.mono_point, dtype)
    chi2 = (r * r * row_mask).sum(-1)
    w = res.huber_weight(chi2, thr) if robust else torch.ones_like(chi2)
    w = w * problem.point_obs_mask
    # zero out fixed-pose columns / fixed-point columns
    pose_free = (~problem.pose_fixed).to(dtype)  # (F,)
    Jc = Jc * row_mask[..., None] * pose_free[None, :, None, None]
    point_free = (~problem.point_fixed).to(dtype)
    Jp = Jp * row_mask[..., None] * point_free[:, None, None, None]
    rw = r * row_mask
    wJc = Jc * w[..., None, None]  # (P, F, 3, 6)
    wJp = Jp * w[..., None, None]  # (P, F, 3, 3)

    Hcc = (wJc[..., :, None] * Jc[..., None, :]).sum(dim=(0, 2))
    bc = -(wJc * rw[..., None]).sum(dim=(0, 2))
    Hpp = (wJp[..., :, None] * Jp[..., None, :]).sum(dim=(1, 2))
    bp = -(wJp * rw[..., None]).sum(dim=(1, 2))
    Wcp = (wJc[..., :, None] * Jp[..., None, :]).sum(dim=2)  # (P,F,6,3)
    Hpp_inv = inv3_spd(_damped_landmarks(Hpp, 3, lam.to(problem.points.device)))
    S, bs = _schur_terms(Wcp, Hpp_inv, bp, problem.frames.Rwb.shape[0])
    return _blockdiag(Hcc) - S, bc - bs, (Wcp, Hpp_inv, bp)


def _line_system(problem: BAProblem, intr, cfg: BAConfig, lam, robust: bool):
    """The line family's share of one LM solve, as :func:`_point_system`'s:
    (H (6F, 6F), right side (F, 6), (R, C1, r1) for the back-substitution).

    Each line's weighted rows [A | C | r] (A its 4 columns, C the window's
    pose columns, rows of every frame that sees it, then the damping rows
    sqrt(λ)·I) are reduced by four Householder reflections to
    [[R, C1, r1], [0, C2, r2]]: the reduced system is C2ᵀC2 and −C2ᵀr2,
    equal in exact arithmetic to blockdiag(Hcc) − W (Hll + λI)⁻¹ Wᵀ. A line
    whose estimate passes near a camera centre projects to a line of
    almost no normal and has rows up to 1e12; formed as normal equations,
    its Hll and its Schur term cancel to rounding noise of ~1e8 in the pose
    blocks and the reduced system turns indefinite. The reflections
    project those rows out before any product is formed."""
    dtype = problem.lines.dtype
    lr, lrow_mask, LJc, LJl = _line_grid_residuals(problem, intr, True)
    lthr = _thresholds(problem.line_obs_stereo, cfg.stereo_line, cfg.mono_line, dtype)
    lchi2 = (lr * lr * lrow_mask).sum(-1) * problem.line_obs_sigma
    lw = res.huber_weight(lchi2, lthr) if robust else torch.ones_like(lchi2)
    lw = lw * problem.line_obs_mask * problem.line_obs_sigma
    pose_free = (~problem.pose_fixed).to(dtype)
    LJc = LJc * lrow_mask[..., None] * pose_free[None, :, None, None]
    line_free = (~problem.line_fixed).to(dtype)
    LJl = LJl * lrow_mask[..., None] * line_free[:, None, None, None]
    sw = torch.sqrt(lw)[..., None]  # (L, F, 1): each row's square-root weight
    n_l, f = LJl.shape[0], LJl.shape[1]
    dev = LJl.device
    A = (LJl * sw[..., None]).reshape(n_l, 4 * f, 4)
    # frame g's rows touch frame g's pose columns only
    C = torch.einsum("lgrc,gh->lgrhc", LJc * sw[..., None],
                     torch.eye(f, dtype=dtype, device=dev)).reshape(n_l, 4 * f, 6 * f)
    r = (lr * lrow_mask * sw).reshape(n_l, 4 * f, 1)
    # the damping rows; an unseen or fixed line pinned as _damped_landmarks does
    unseen = ((A * A).sum(dim=(1, 2)) < 1e-10).to(dtype)
    damp = torch.sqrt(lam.to(dev) + unseen)[:, None, None] * torch.eye(
        4, 4 + 6 * f + 1, dtype=dtype, device=dev)
    W = torch.cat([torch.cat([A, C, r], dim=2), damp], dim=1)  # (L, 4F + 4, 4 + 6F + 1)
    rows = torch.arange(W.shape[1], device=dev)
    ks = torch.arange(4, device=dev)[:, None]
    below, at = (rows >= ks).to(dtype), (rows == ks).to(dtype)  # (4, rows)
    for k in range(4):
        x = W[:, :, k] * below[k]
        norm = torch.linalg.vector_norm(x, dim=1)
        # the reflection maps x onto alpha·e_k, alpha of the sign opposite x_k's;
        # |v|² = 2|x|(|x| + |x_k|) > 0, as the damping rows leave no column
        # without a part on or below row k
        alpha = torch.where(x[:, k] < 0, norm, -norm)
        v = x - alpha[:, None] * at[k]
        bv = v * (2.0 / (v * v).sum(1, keepdim=True))
        W = W - bv[:, :, None] * (v[:, :, None] * W).sum(1, keepdim=True)
    C2, r2 = W[:, 4:, 4:-1], W[:, 4:, -1]
    H = torch.einsum("lmi,lmj->ij", C2, C2)
    b = -torch.einsum("lmi,lm->i", C2, r2).reshape(f, POSE_DIM)
    return H, b, (W[:, :4, :4], W[:, :4, 4:-1], W[:, :4, -1])


def _line_back_substitute(back, dxc):
    """The lines' step from the pose step: R dl = −(r1 + C1 dxc)."""
    R, C1, r1 = back
    g = -(r1 + (C1 * dxc.to(C1.device).reshape(1, 1, -1)).sum(-1))
    return torch.linalg.solve_triangular(R, g[..., None], upper=True)[..., 0]


def _back_substitute(back, dxc):
    """A landmark family's step from the pose step: Hinv (b − Wᵀ dxc)."""
    W, Hinv, b = back
    g = b - (W * dxc.to(W.device)[None, :, :, None]).sum(dim=(1, 2))
    return (Hinv * g[:, None, :]).sum(dim=2)


def _assemble_and_solve(problem: BAProblem, intr, cfg: BAConfig, lam, robust: bool,
                        mesh=None):
    """One damped LM solve. Returns (dx_frames (F,15), dRwg tangent (2,),
    dpoints (P,3), dlines (L,4)).

    Vision-only: velocity/bias rows are touched ONLY by IMU factors, so the
    reduced system is the F·6 pose block (exact, the dropped rows carry no
    coupling), and gravity has no gradient. With IMU factors the system is
    the (F, 15, F, 15) frame block grid plus the 2-dof gravity border.

    With a ``mesh`` (:func:`landmark_shards`) each landmark shard's blocks,
    Schur terms and back-substitution run on its device; their sums meet on
    the problem's device in shard order, where the damped solve runs once.
    The IMU blocks and the gravity border are added once.

    Traced as two spans: ``lm.assemble`` (the reduced system) and
    ``lm.solve`` (the damped solve and the back-substitution)."""
    f = problem.frames.Rwb.shape[0]
    dtype, dev = problem.points.dtype, problem.points.device

    with span("lm.assemble"):
        # The landmark-family contractions are tiny (residual rows 3/4, dof
        # 3/4/6) and batched over the grid: they are written as
        # broadcast-multiply-reduce, as in the JAX package.
        pshards, lshards = landmark_shards(problem, mesh)
        pts = [_point_system(s, intr, cfg, lam, robust) for s in pshards]
        lns = [_line_system(s, intr, cfg, lam, robust) for s in lshards]

        def total(fam, i):
            return reduce_sum([t[i] for t in fam], dev)

        Hv = total(pts, 0) + total(lns, 0)  # (6F, 6F): the landmarks eliminated
        bv = total(pts, 1) + total(lns, 1)  # (F, 6)

        if problem.imu is not None:
            with span("lm.imu"):
                Hff, bf, Hfg, Hgg, bg_grav = _imu_blocks(problem, cfg, Hv, bv, robust)
            # densify (pure layout) with the gravity border
            n = f * FRAME_DIM
            Hfg2 = Hfg.reshape(n, GRAV_DIM)
            H = torch.cat([torch.cat([Hff.reshape(n, n), Hfg2], dim=1),
                           torch.cat([Hfg2.T, Hgg], dim=1)])
            b = torch.cat([bf.reshape(-1), bg_grav])
        else:
            H = Hv
            b = bv.reshape(-1)

    with span("lm.solve"):
        dx = solve_spd(_damped_pinned(H, lam), b)
        if problem.imu is not None:
            dx_frames = dx[:n].reshape(f, FRAME_DIM)
            dg = dx[n:]
            dxc = dx_frames[:, :POSE_DIM]
        else:
            dxc = dx.reshape(f, POSE_DIM)
            dx_frames = torch.cat(
                [dxc, torch.zeros((f, FRAME_DIM - POSE_DIM), dtype=dtype, device=dev)], dim=1)
            dg = torch.zeros(GRAV_DIM, dtype=dtype, device=dev)

        # -- back-substitute landmarks ------------------------------------
        dp = torch.cat([_back_substitute(t[2], dxc).to(dev) for t in pts])
        dl = torch.cat([_line_back_substitute(t[2], dxc).to(dev) for t in lns])
    return dx_frames, dg, dp, dl


def _damped_pinned(H, lam):
    """H + λI, then every diagonal entry still under 1e-10 (a fixed or
    unobserved dof) pinned by adding 1."""
    H = H + torch.diag(lam * torch.ones(H.shape[0], dtype=H.dtype, device=H.device))
    return H + torch.diag((torch.diagonal(H) < 1e-10).to(H.dtype))


def _imu_blocks(problem: BAProblem, cfg: BAConfig, Hv, bv, robust: bool):
    """The VI system in block layout: the frame block grid Hff (F, 15, F, 15)
    holding the vision system on the poses (Hv (6F, 6F), bv (F, 6), the
    landmarks eliminated) and every IMU factor's 15/15 sub-blocks, its right
    side bf (F, 15), the gravity border Hfg (F, 15, 2), Hgg (2, 2) and its
    right side (2,). Each factor's sub-blocks go into frames i and j by
    one-hot contractions (no scatter), with the columns of fixed poses, fixed
    velocity/bias and a pinned gravity masked."""
    f = bv.shape[0]
    dtype, dev = bv.dtype, bv.device
    FD = FRAME_DIM
    Hff = torch.zeros((f, FD, f, FD), dtype=dtype, device=dev)
    Hff[:, :POSE_DIM, :, :POSE_DIM] += Hv.reshape(f, POSE_DIM, f, POSE_DIM)
    bf = torch.zeros((f, FD), dtype=dtype, device=dev)
    bf[:, :POSE_DIM] += bv

    imu = problem.imu
    ir, iJ = _imu_residuals(problem, True)  # (K, 15), (K, 15, 32)
    k = ir.shape[0]
    info9 = imu.info * cfg.imu_info_scale
    if robust:
        c_imu = torch.einsum("ki,kij,kj->k", ir[:, :9], info9, ir[:, :9])
        wi = res.huber_weight(c_imu, torch.full_like(c_imu, 16.92))
    else:
        wi = torch.ones(k, dtype=dtype, device=dev)
    wi = wi * imu.mask
    # information for all 15 residual rows: blockdiag(info9·w, info_walk)
    big_info = torch.zeros((k, 15, 15), dtype=dtype, device=dev)
    big_info[:, :9, :9] = info9 * wi[:, None, None]
    big_info[:, 9:15, 9:15] = imu.info_walk * imu.mask[:, None, None].to(dtype)

    # column masks: fixed frames / fixed vel+bias / fixed gravity
    ii, jj = imu.idx_i.long(), imu.idx_j.long()
    frame_cols = torch.cat([(~problem.pose_fixed).to(dtype)[:, None].expand(f, POSE_DIM),
                            (~problem.vel_fixed).to(dtype)[:, None].expand(f, FD - POSE_DIM)],
                           dim=1)  # (F, 15)
    g_cols = (problem.gravity_free * torch.ones(GRAV_DIM, dtype=dtype, device=dev)).expand(k, -1)
    iJ = iJ * torch.cat([frame_cols[ii], frame_cols[jj], g_cols], dim=1)[:, None, :]

    JtW = torch.einsum("krc,krs->ksc", iJ, big_info)  # (K, 15, 32)
    Hk = torch.einsum("ksc,ksd->kcd", JtW, iJ)  # (K, 32, 32)
    bk = -torch.einsum("ksc,ks->kc", JtW, ir)  # (K, 32)

    oh_i = torch.nn.functional.one_hot(ii, f).to(dtype)  # (K, F)
    oh_j = torch.nn.functional.one_hot(jj, f).to(dtype)
    Hii, Hij, Hjj = Hk[:, :FD, :FD], Hk[:, :FD, FD:2 * FD], Hk[:, FD:2 * FD, FD:2 * FD]
    # Hk is symmetric (JᵀWJ with symmetric W): the (j,i) placement is the
    # transpose of the (i,j) one
    Tij = torch.einsum("kf,kab,kg->fagb", oh_i, Hij, oh_j)
    Hff = Hff + (torch.einsum("kf,kab,kg->fagb", oh_i, Hii, oh_i)
                 + Tij + Tij.permute(2, 3, 0, 1)
                 + torch.einsum("kf,kab,kg->fagb", oh_j, Hjj, oh_j))
    Hfg = (torch.einsum("kf,kac->fac", oh_i, Hk[:, :FD, 2 * FD:])
           + torch.einsum("kf,kac->fac", oh_j, Hk[:, FD:2 * FD, 2 * FD:]))
    Hgg = Hk[:, 2 * FD:, 2 * FD:].sum(0)
    bf = bf + (torch.einsum("kf,ka->fa", oh_i, bk[:, :FD])
               + torch.einsum("kf,ka->fa", oh_j, bk[:, FD:2 * FD]))
    return Hff, bf, Hfg, Hgg, bk[:, 2 * FD:].sum(0)


def _blockdiag(blocks):
    """(F, k, k) -> (F*k, F*k) block-diagonal."""
    f, k, _ = blocks.shape
    eye = torch.eye(f, dtype=blocks.dtype, device=blocks.device)
    return torch.einsum("fg,fij->figj", eye, blocks).reshape(f * k, f * k)


def apply_update(problem: BAProblem, dx_frames, dg, dp, dl) -> BAProblem:
    fr = problem.frames
    Rwb, twb = torch.func.vmap(res.retract_pose)(fr.Rwb, fr.twb, dx_frames[:, 0:6])
    new_frames = FrameStates(
        Rwb=Rwb,
        twb=twb,
        vel=fr.vel + dx_frames[:, 6:9],
        bg=fr.bg + dx_frames[:, 9:12],
        ba=fr.ba + dx_frames[:, 12:15],
    )
    dg_eff = dg * problem.gravity_free
    Rwg = problem.Rwg @ lie.so3_exp(torch.cat([dg_eff, dg_eff.new_zeros(1)]))
    new_lines = torch.func.vmap(lie.line_orthonormal_oplus)(problem.lines, dl)
    return problem._replace(frames=new_frames, points=problem.points + dp,
                            lines=new_lines, Rwg=Rwg)


# ---------------------------------------------------------------------------
# LM loop
# ---------------------------------------------------------------------------


def optimize(problem: BAProblem, intr, cfg: BAConfig, iterations: int, robust: bool = True,
             tau: float = 1e-5, early_exit: float = 0.0, mesh=None) -> BAProblem:
    """Run ``iterations`` LM steps (g2o Levenberg strategy) and return the
    updated problem. Accept/reject and the damping schedule stay on the
    device.

    ``early_exit`` (opt-in — deviates from g2o's fixed schedule): when > 0,
    stop once an accepted step improves the cost by less than ``early_exit``
    relative; this reads one flag per step back to the host. 0.0 keeps the
    reference's iteration counts. ``mesh``: the landmarks sharded over its
    dp devices (:func:`landmark_shards`).

    Each iteration is an ``lm.step`` span holding ``lm.assemble`` and
    ``lm.solve`` (:func:`_assemble_and_solve`) and ``lm.cost`` (the update,
    the candidate's cost, the accept and damping picks)."""
    with full_f32():
        cost = total_cost(problem, intr, cfg, robust, mesh)
        # g2o: tau * max(diag(H)); diag ~O(1e2) for pixel terms
        lam = torch.full((), tau * 100.0, dtype=cost.dtype, device=cost.device)
        nu = torch.full((), 2.0, dtype=cost.dtype, device=cost.device)
        two = torch.full_like(nu, 2.0)

        for _ in range(iterations):
            with span("lm.step"):
                dxf, dg, dp, dl = _assemble_and_solve(problem, intr, cfg, lam, robust, mesh)
                with span("lm.cost"):
                    cand = apply_update(problem, dxf, dg, dp, dl)
                    new_cost = total_cost(cand, intr, cfg, robust, mesh)
                    accept = new_cost < cost  # False for a NaN candidate

                    def pick(a, b):
                        return torch.where(accept, a, b)

                    if early_exit > 0.0:
                        converged = accept & (cost - new_cost < early_exit * cost.clamp(min=1e-12))
                    problem = problem._replace(
                        frames=FrameStates(*(pick(a, b) for a, b in zip(cand.frames,
                                                                        problem.frames))),
                        points=pick(cand.points, problem.points),
                        lines=pick(cand.lines, problem.lines),
                        Rwg=pick(cand.Rwg, problem.Rwg))
                    # g2o-style damping adaptation (simplified gain ratio)
                    lam = pick(lam / 3.0, lam * nu)
                    nu = pick(two, nu * 2.0)
                    cost = pick(new_cost, cost)
                if early_exit > 0.0 and bool(converged):
                    break
    return problem
