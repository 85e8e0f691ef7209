"""Numeric validation printers.

Port of ``airslam_tpu/backend/validate.py`` (the reference's ``Validate*``
debug functions, g2o_optimization.cc:1158-1429): residual statistics of a
problem before/after optimization, and the frame-chain IMU checks. They
print one line each under the JAX package's labels and return the same
dict keys. The problem may live on any device; the statistics are taken on
the host in the problem's type.
"""

from __future__ import annotations

import numpy as np
import torch

from airslam_tpu_torch.backend import gn


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _line(tag: str, label: str, stats: dict) -> None:
    print(f"[{tag}{':' + label if label else ''}] " +
          " ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                   for k, v in stats.items()))


def validate_reprojection(problem: gn.BAProblem, intr, label: str = "") -> dict:
    """Chi² statistics of all active point/line observations."""
    pchi2, depth_ok = gn.point_chi2(problem, intr)
    pmask = _np(problem.point_obs_mask)
    p = _np(pchi2)[pmask]
    lchi2 = _np(gn.line_chi2(problem, intr, 1.0))[_np(problem.line_obs_mask)]
    stats = dict(
        n_point_obs=int(pmask.sum()),
        point_chi2_mean=float(p.mean()) if len(p) else 0.0,
        point_chi2_max=float(p.max()) if len(p) else 0.0,
        depth_violations=int((~_np(depth_ok))[pmask].sum()),
        n_line_obs=len(lchi2),
        line_chi2_mean=float(lchi2.mean()) if len(lchi2) else 0.0,
    )
    _line("validate", label, stats)
    return stats


def validate_imu(problem: gn.BAProblem, label: str = "") -> dict:
    """9-d IMU residual norms per factor (ValidateError equivalent)."""
    if problem.imu is None:
        print("[validate] no IMU factors")
        return {}
    r, _ = gn._imu_residuals(problem, with_jac=False)
    r = _np(r)[_np(problem.imu.mask)]
    stats = dict(
        n_factors=len(r),
        er_rms=float(np.sqrt((r[:, 0:3] ** 2).mean())) if len(r) else 0.0,
        ev_rms=float(np.sqrt((r[:, 3:6] ** 2).mean())) if len(r) else 0.0,
        ep_rms=float(np.sqrt((r[:, 6:9] ** 2).mean())) if len(r) else 0.0,
    )
    _line("validate-imu", label, stats)
    return stats

# ---------------------------------------------------------------------------
# Frame-chain validators (ValidateGyrBias / ValidateVelocity /
# ValidateIMUInitialization, g2o_optimization.cc:1158-1429). All take a list
# of keyframes ordered OLDEST FIRST, each frame's ``preintegration`` spanning
# from its predecessor in the list, and the body-from-camera extrinsic Tcb.
# ---------------------------------------------------------------------------


def _chain_states(frames, Tcb):
    Rwb, twb = [], []
    for fr in frames:
        Twb = _np(fr.imu_pose(Tcb))
        Rwb.append(Twb[:3, :3])
        twb.append(Twb[:3, 3])
    return np.asarray(Rwb), np.asarray(twb)


def validate_gyr_bias(frames, Tcb, label: str = "") -> dict:
    """Rotation-alignment residual per interval: delta_r =
    Log(dRᵀ · Rwbᵢᵀ · Rwbⱼ) — near zero iff the preintegrations' gyro bias
    matches the poses (``ValidateGyrBias``, g2o_optimization.cc:1158-1170)."""
    from scipy.spatial.transform import Rotation

    Rwb, _ = _chain_states(frames, Tcb)
    rows = []
    for i in range(len(frames) - 1):
        pre = frames[i + 1].preintegration
        if pre is None:
            continue
        dR = _np(pre.state.dR)
        delta_r = Rotation.from_matrix(dR.T @ Rwb[i].T @ Rwb[i + 1]).as_rotvec()
        rows.append(delta_r)
        print(f"[validate-gyr{':' + label if label else ''}] "
              f"frame_id={frames[i + 1].frame_id} delta_r={delta_r}")
    rows = np.asarray(rows) if rows else np.zeros((0, 3))
    stats = dict(n=len(rows),
                 delta_r_rms=float(np.sqrt((rows ** 2).mean())) if len(rows) else 0.0)
    _line("validate-gyr", label, stats)
    return stats


def validate_velocity(frames, Tcb, gravity, label: str = "") -> dict:
    """Residuals of the velocity/position preintegration equations at the
    frames' stored velocities (``ValidateVelocity``,
    g2o_optimization.cc:1231-1276): per interval,
    ev = v_j − v_i − g·dT − Rᵢ·dV and
    ep = t_j − t_i − v_i·dT − ½·g·dT² − Rᵢ·dP."""
    Rwb, twb = _chain_states(frames, Tcb)
    g = np.asarray(_np(gravity), float)
    evs, eps = [], []
    for i in range(len(frames) - 1):
        pre = frames[i + 1].preintegration
        if pre is None:
            continue
        st = pre.state
        dT = float(st.dT)
        vi, vj = _np(frames[i].velocity), _np(frames[i + 1].velocity)
        ev = vj - vi - g * dT - Rwb[i] @ _np(st.dV)
        ep = twb[i + 1] - twb[i] - vi * dT - 0.5 * g * dT * dT - Rwb[i] @ _np(st.dP)
        evs.append(ev)
        eps.append(ep)
        print(f"[validate-vel{':' + label if label else ''}] "
              f"frame_id={frames[i + 1].frame_id} ev={ev} ep={ep}")
    evs = np.asarray(evs) if evs else np.zeros((0, 3))
    eps = np.asarray(eps) if eps else np.zeros((0, 3))
    stats = dict(
        n=len(evs),
        ev_rms=float(np.sqrt((evs ** 2).mean())) if len(evs) else 0.0,
        ep_rms=float(np.sqrt((eps ** 2).mean())) if len(eps) else 0.0,
    )
    _line("validate-vel", label, stats)
    return stats


def validate_imu_initialization(frames, Tcb, g_value: float,
                                label: str = "") -> dict:
    """Forward-predict each frame's state from its predecessor through the
    preintegration and compare against the stored pose/velocity
    (``ValidateIMUInitialization``, g2o_optimization.cc:1377-1429). Small
    errors ⇒ gravity alignment + velocities + biases are consistent."""
    Rwb, twb = _chain_states(frames, Tcb)
    dv, dp = [], []
    for i in range(len(frames) - 1):
        pre = frames[i + 1].preintegration
        if pre is None:
            continue
        Twb0 = np.eye(4)
        Twb0[:3, :3] = Rwb[i]
        Twb0[:3, 3] = twb[i]
        Twb1, vwb1 = (_np(a) for a in pre.predict(Twb0, _np(frames[i].velocity), g_value))
        vj = _np(frames[i + 1].velocity)
        ev = vj - vwb1
        ep = twb[i + 1] - Twb1[:3, 3]
        dv.append(ev)
        dp.append(ep)
        print(f"[validate-init{':' + label if label else ''}] "
              f"frame_id={frames[i + 1].frame_id} "
              f"vwb={vj} vwb_pred={vwb1} dp={ep}")
    dv = np.asarray(dv) if dv else np.zeros((0, 3))
    dp = np.asarray(dp) if dp else np.zeros((0, 3))
    stats = dict(
        n=len(dv),
        dv_rms=float(np.sqrt((dv ** 2).mean())) if len(dv) else 0.0,
        dp_rms=float(np.sqrt((dp ** 2).mean())) if len(dp) else 0.0,
    )
    _line("validate-init", label, stats)
    return stats
