"""Residual functions for the Gauss-Newton/LM backend.

Port of ``airslam_tpu/backend/residuals.py`` (whole file). They reproduce the
error definitions of the reference's g2o edges:

- point reprojection (mono 2-d / stereo 3-d with u_r = u_l − bf/z):
  ``EdgeSE3ProjectPoint`` / ``EdgeSE3ProjectStereoPoint``
  (src/g2o_optimization/edge_project_point.cc:23-123)
- Plücker line projection (normalized point-to-line distance of both observed
  endpoints; stereo adds a baseline-shifted right-camera copy):
  ``EdgeSE3ProjectLine`` / ``EdgeStereoSE3ProjectLine``
  (src/g2o_optimization/edge_project_line.cc:23-90)
- 9-d IMU preintegration residual: ``EdgeIMU``
  (src/g2o_optimization/edge_imu.cc:57-101)
- 6-d SE3 relative pose: ``EdgeRelativePose``
  (src/g2o_optimization/edge_relative_pose.cc:17-26)

Tangent-space conventions: poses are body-frame (Rwb, twb) with the 6-d update
of ``VIPose::Update`` (vertex_vi_pose.cc:69-97): twb += Rwb·dt, Rwb ←
Rwb·Exp(dr); points, velocities and biases are additive.

Each function takes ONE observation (unbatched tensors); callers batch with
``torch.func.vmap`` and differentiate with ``torch.func.jacfwd``. The guarded
denominators are ``torch.where`` selections, so the derivative at a guard is
the selected constant's (zero), as under ``jax.jacfwd``. ``intr`` is any
object with scalar ``fx, fy, cx, cy, bf`` (``core.camera.Intrinsics``).
"""

from __future__ import annotations

import torch

from airslam_tpu_torch.core import lie


def retract_pose(Rwb, twb, delta6):
    """VIPose::Update convention (vertex_vi_pose.cc:69-97)."""
    return Rwb @ lie.so3_exp(delta6[0:3]), twb + Rwb @ delta6[3:6]


def pose_to_camera(Rwb, twb, Rcb, tcb):
    """Body-frame state -> (Rcw, tcw). vertex_vi_pose.cc:83-85."""
    Rcw = Rcb @ Rwb.T
    return Rcw, tcb - Rcw @ twb


def _guard(x, eps):
    """``x`` with magnitudes under ``eps`` replaced by the constant ``eps``."""
    return torch.where(x.abs() < eps, torch.full_like(x, eps), x)


def point_residual(Rcw, tcw, point, obs_uvr, intr):
    """3-d stereo residual (obs − [π(p), u_r]) and the depth; mono callers
    mask row 2. obs_uvr = (u_left, v, u_right), edge_project_point.cc:86-123."""
    pc = Rcw @ point + tcw
    z = pc[2]
    z_inv = 1.0 / _guard(z, 1e-9)
    u = pc[0] * z_inv * intr.fx + intr.cx
    v = pc[1] * z_inv * intr.fy + intr.cy
    ur = u - intr.bf * z_inv
    return obs_uvr - torch.stack([u, v, ur]), z


def _project_line(w, intr):
    """Plücker moment -> 2D line coefficients (edge_project_line.cc:37-46):
    l = (fy·w0, fx·w1, Kv·w), Kv = (−fy·cx, −fx·cy, fx·fy)."""
    kv_w = -intr.fy * intr.cx * w[0] - intr.fx * intr.cy * w[1] + intr.fx * intr.fy * w[2]
    return torch.stack([intr.fy * w[0], intr.fx * w[1], kv_w])


def _endpoint_line_error(l2d, x, y):
    n = torch.sqrt(l2d[0] * l2d[0] + l2d[1] * l2d[1])
    return (x * l2d[0] + y * l2d[1] + l2d[2]) / torch.where(
        n < 1e-12, torch.full_like(n, 1e-12), n)


def line_residual(Rcw, tcw, line_w, obs8, intr):
    """4-d stereo line residual; mono callers mask rows 2-3.

    obs8 = left endpoints (x1, y1, x2, y2) + right endpoints. Left rows follow
    edge_project_line.cc:23-35; the right rows use the baseline-shifted pose
    (edge_project_line.cc:70-80), which shifts the moment by t×d with
    t = (−b, 0, 0)."""
    line_c = lie.line_transform(Rcw, tcw, line_w)
    w, d = line_c[0:3], line_c[3:6]
    l_left = _project_line(w, intr)
    e0 = _endpoint_line_error(l_left, obs8[0], obs8[1])
    e1 = _endpoint_line_error(l_left, obs8[2], obs8[3])

    b = intr.bf / intr.fx
    # (−b, 0, 0) × d = (0, b·d2, −b·d1)
    w_r = torch.stack([w[0], w[1] + b * d[2], w[2] - b * d[1]])
    l_right = _project_line(w_r, intr)
    e2 = _endpoint_line_error(l_right, obs8[4], obs8[5])
    e3 = _endpoint_line_error(l_right, obs8[6], obs8[7])
    return torch.stack([e0, e1, e2, e3])


def imu_residual(
    Rwb1, twb1, v1,
    Rwb2, twb2, v2,
    bg2, ba2,
    preint_dR, preint_dV, preint_dP,  # raw deltas at the linearization bias
    JRg, JVg, JVa, JPg, JPa,
    bg_lin, ba_lin,  # bias at which the preintegration was linearized
    dT, Rwg, g_value,
):
    """9-d (er, ev, ep) residual of edge_imu.cc:57-101.

    er = Log( (dR·Exp(JRg δbg))ᵀ · Rwb1ᵀ · Rwb2 )
    ev = Rwb1ᵀ (v2 − v1 − g·dT) − (dV + JVg δbg + JVa δba)
    ep = Rwb1ᵀ (t2 − t1 − v1·dT − ½ g dT²) − (dP + JPg δbg + JPa δba)
    with g = Rwg · (0, 0, −g_value).
    """
    dbg = bg2 - bg_lin
    dba = ba2 - ba_lin
    dR_corr = preint_dR @ lie.so3_exp(JRg @ dbg)
    dV_corr = preint_dV + JVg @ dbg + JVa @ dba
    dP_corr = preint_dP + JPg @ dbg + JPa @ dba

    g = Rwg[:, 2] * (-g_value)
    er = lie.so3_log(dR_corr.T @ Rwb1.T @ Rwb2)
    ev = Rwb1.T @ (v2 - v1 - g * dT) - dV_corr
    ep = Rwb1.T @ (twb2 - twb1 - v1 * dT - 0.5 * g * dT * dT) - dP_corr
    return torch.cat([er, ev, ep])


def relative_pose_residual(Rwb1, twb1, Rwb2, twb2, R12_meas, t12_meas):
    """6-d relative pose residual (edge_relative_pose.cc:17-26):
    T_err = T12_meas⁻¹ · (T1⁻¹ · T2), residual = (Log R_err, t_err)."""
    R12 = Rwb1.T @ Rwb2
    t12 = Rwb1.T @ (twb2 - twb1)
    return torch.cat([lie.so3_log(R12_meas.T @ R12), R12_meas.T @ (t12 - t12_meas)])


def huber_weight(chi2, delta2):
    """Reweighting of g2o's RobustKernelHuber with delta = sqrt(thr):
    w = 1 if chi2 <= delta², else delta/sqrt(chi2)."""
    safe = torch.clamp(chi2, min=1e-12)
    return torch.where(chi2 <= delta2, torch.ones_like(chi2), torch.sqrt(delta2 / safe))
