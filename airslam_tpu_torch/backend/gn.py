"""Problem containers and small solvers of the Gauss-Newton/LM backend.

Port of the F=1 (per-frame tracking) part of ``airslam_tpu/backend/gn.py``:
``FrameStates``, ``IMUFactors``, ``BAProblem``, ``BAConfig`` (:53-118) as
``NamedTuple``s of tensors, ``_jac_with_value`` (:158-171, on
``torch.func.jacfwd``), ``solve_spd_small`` (:360-398) and ``_huber_cost``
(:401-403). The dense (landmark × frame) grids, ``_assemble_and_solve`` and
``optimize`` belong to the window backend and are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

POSE_DIM = 6


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
                "line_fixed", "line_obs_stereo", "line_obs_mask")


def problem_from_numpy(problem, dtype=torch.float32, device="cpu") -> BAProblem:
    """A ``BAProblem`` of tensors from one whose leaves are numpy arrays (or
    anything ``np.asarray`` reads, e.g. the JAX package's problem pulled to the
    host): float leaves in ``dtype``, masks as bool, on ``device``. The leaves
    are matched by field name; the IMU factors are not carried (the F=1
    tracking problem has none)."""
    if getattr(problem, "imu", None) is not None:
        raise NotImplementedError(
            "IMU factors belong to the stereo-inertial slice (ROADMAP queue 3)")

    def leaf(name, value):
        a = np.asarray(value)
        if name in _BOOL_LEAVES:
            return torch.as_tensor(a.astype(bool), device=device)
        return torch.as_tensor(a.astype(np.float64), device=device).to(dtype)

    frames = FrameStates(*(leaf(n, getattr(problem.frames, n)) for n in FrameStates._fields))
    fields = {n: leaf(n, getattr(problem, n)) for n in BAProblem._fields
              if n not in ("frames", "imu", "g_value")}
    return BAProblem(frames=frames, imu=None, g_value=float(np.asarray(problem.g_value)),
                     **fields)


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
