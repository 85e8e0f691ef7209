"""IMU preintegration (Forster-style) on tensors.

Port of ``airslam_tpu/core/imu.py`` (whole file), which replaces
``src/imu.cc`` / ``include/imu.h``. The per-step update reproduces
``Preinteration::Propagate`` (src/imu.cc:157-210): order of operations matters
(dP/dV updated with the *previous* dR, Jacobians updated before dR), and the
covariance recursion uses the same A/B matrices. The midpoint interpolation of
measurement batches reproduces ``AddBatchData`` (src/imu.cc:218-248).

Measurements are padded to a power-of-two length (8, 16, 32, …) and folded by
a loop over the rows; padded steps carry dt = 0 and a mask, so they are exact
no-ops, including the bias random-walk covariance term (which the reference
adds once per real measurement, src/imu.cc:203). The state is computed in the
caller's dtype on the caller's device; nothing in the fold reads a value back
to the host.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from airslam_tpu_torch import resolve_device
from airslam_tpu_torch.core import lie


class PreintState(NamedTuple):
    """Preintegrated deltas + bias Jacobians + 15x15 covariance."""

    dT: torch.Tensor  # ()
    dR: torch.Tensor  # (3, 3)
    dV: torch.Tensor  # (3,)
    dP: torch.Tensor  # (3,)
    JRg: torch.Tensor  # (3, 3)
    JVg: torch.Tensor  # (3, 3)
    JVa: torch.Tensor  # (3, 3)
    JPg: torch.Tensor  # (3, 3)
    JPa: torch.Tensor  # (3, 3)
    cov: torch.Tensor  # (15, 15)


def init_state(dtype=torch.float64, device="cpu") -> PreintState:
    z3 = torch.zeros(3, dtype=dtype, device=device)
    z33 = torch.zeros((3, 3), dtype=dtype, device=device)
    return PreintState(
        dT=torch.zeros((), dtype=dtype, device=device),
        dR=torch.eye(3, dtype=dtype, device=device),
        dV=z3, dP=z3, JRg=z33, JVg=z33, JVa=z33, JPg=z33, JPa=z33,
        cov=torch.zeros((15, 15), dtype=dtype, device=device),
    )


def propagate_step(state: PreintState, dt, acc_m, gyr_m, bg, ba,
                   noise_diag,  # (6,) [gyr_noise², ×3, acc_noise², ×3]
                   walk_diag,  # (6,)
                   valid) -> PreintState:
    """One measurement update; mirrors src/imu.cc:157-210. ``valid`` (0-d
    bool): a padded step leaves the state as it was."""
    acc = acc_m - ba
    gyr = gyr_m - bg
    dR0 = state.dR
    eye3 = torch.eye(3, dtype=dR0.dtype, device=dR0.device)
    z3 = torch.zeros_like(eye3)

    dP = state.dP + state.dV * dt + 0.5 * (dR0 @ acc) * dt * dt
    dV = state.dV + (dR0 @ acc) * dt

    acc_hat = lie.hat(acc)
    JPa = state.JPa + state.JVa * dt - 0.5 * dR0 * dt * dt
    JPg = state.JPg + state.JVg * dt - 0.5 * (dR0 * dt * dt) @ acc_hat @ state.JRg
    JVa = state.JVa - dR0 * dt
    JVg = state.JVg - (dR0 * dt) @ acc_hat @ state.JRg

    rv = gyr * dt
    delta_r = lie.so3_exp(rv)
    jr = lie.so3_right_jacobian(rv)
    dR = lie.normalize_rotation(dR0 @ delta_r)

    a = torch.cat([
        torch.cat([delta_r.T, z3, z3], dim=1),
        torch.cat([-dR0 * dt @ acc_hat, eye3, z3], dim=1),
        torch.cat([-0.5 * dR0 * dt * dt @ acc_hat, eye3 * dt, eye3], dim=1),
    ])
    b = torch.cat([
        torch.cat([jr * dt, z3], dim=1),
        torch.cat([z3, dR0 * dt], dim=1),
        torch.cat([z3, 0.5 * dR0 * dt * dt], dim=1),
    ])
    cov99 = a @ state.cov[0:9, 0:9] @ a.T + b @ torch.diag(noise_diag) @ b.T
    cov = torch.cat([
        torch.cat([cov99, state.cov[0:9, 9:15]], dim=1),
        torch.cat([state.cov[9:15, 0:9], state.cov[9:15, 9:15] + torch.diag(walk_diag)], dim=1),
    ])

    JRg = delta_r.T @ state.JRg - jr * dt

    new = PreintState(dT=state.dT + dt, dR=dR, dV=dV, dP=dP, JRg=JRg, JVg=JVg, JVa=JVa,
                      JPg=JPg, JPa=JPa, cov=cov)
    return PreintState(*(torch.where(valid, n, o) for n, o in zip(new, state)))


def preintegrate(dts, accs, gyrs, bg, ba, noise_diag, walk_diag,
                 init: Optional[PreintState] = None) -> PreintState:
    """Fold all measurements (dts (N,) padded with zeros, accs/gyrs (N, 3));
    padded dt == 0 steps are no-ops."""
    state = init_state(accs.dtype, accs.device) if init is None else init
    for k in range(dts.shape[0]):
        state = propagate_step(state, dts[k], accs[k], gyrs[k], bg, ba, noise_diag,
                               walk_diag, dts[k] > 0)
    return state


# -- bias-corrected getters (src/imu.cc:250-281) ----------------------------


def delta_rotation(state: PreintState, bg_ref, bg_new):
    ddr = lie.so3_exp(state.JRg @ (bg_new - bg_ref))
    return lie.normalize_rotation(state.dR @ ddr)


def delta_velocity(state, bg_ref, ba_ref, bg_new, ba_new):
    return state.dV + state.JVg @ (bg_new - bg_ref) + state.JVa @ (ba_new - ba_ref)


def delta_position(state, bg_ref, ba_ref, bg_new, ba_new):
    return state.dP + state.JPg @ (bg_new - bg_ref) + state.JPa @ (ba_new - ba_ref)


def predict(state: PreintState, Rwb0, twb0, vwb0, g_value: float):
    """IMU state propagation: src/imu.cc:299-313 (``Preinteration::Predict``)."""
    g = torch.tensor([0.0, 0.0, -g_value], dtype=twb0.dtype, device=twb0.device)
    dT = state.dT
    Rwb1 = lie.normalize_rotation(Rwb0 @ state.dR)
    twb1 = twb0 + vwb0 * dT + 0.5 * dT * dT * g + Rwb0 @ state.dP
    vwb1 = vwb0 + dT * g + Rwb0 @ state.dV
    return Rwb1, twb1, vwb1


# ---------------------------------------------------------------------------
# Host-side measurement accumulator (mirrors Preinteration's list-keeping)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ImuData:
    timestamp: float
    gyr: np.ndarray
    acc: np.ndarray


def midpoint_batch(imu_data, t0: float, t1: float):
    """Convert raw samples spanning [t0, t1] into (dt, acc, gyr) midpoint rows.

    Reproduces the interpolation cases of ``AddBatchData`` (src/imu.cc:218-248).
    Returns float64 numpy arrays of shape (M,), (M, 3), (M, 3).
    """
    dts, accs, gyrs = [], [], []
    n = len(imu_data)
    for i in range(n - 1):
        a, b = imu_data[i], imu_data[i + 1]
        if b.timestamp < t0:
            continue
        if a.timestamp > t1:
            break
        if a.timestamp < t0:
            mid_t = 0.5 * (t0 + b.timestamp)
            dt = b.timestamp - t0
        elif b.timestamp > t1:
            mid_t = 0.5 * (t1 + a.timestamp)
            dt = t1 - a.timestamp
        else:
            mid_t = 0.5 * (a.timestamp + b.timestamp)
            dt = b.timestamp - a.timestamp
        span = b.timestamp - a.timestamp
        w1 = (b.timestamp - mid_t) / span
        w2 = (mid_t - a.timestamp) / span
        gyrs.append(w1 * a.gyr + w2 * b.gyr)
        accs.append(w1 * a.acc + w2 * b.acc)
        dts.append(dt)
    if not dts:
        return (np.zeros((0,), np.float64), np.zeros((0, 3), np.float64),
                np.zeros((0, 3), np.float64))
    return np.asarray(dts), np.asarray(accs), np.asarray(gyrs)


class Preintegration:
    """Host accumulator with the reference's public surface (imu.h:47-88).

    Keeps the raw (dt, acc, gyr) rows (float64 numpy) for repropagation on a
    bias reset; the integration runs through :func:`preintegrate` in ``dtype``
    on ``device`` (``cuda`` unless the caller passes another), over rows
    padded to 8, 16, 32, … so that a sequence meets few distinct lengths. The
    noise values, biases and times stay float64 numpy, as in the JAX package
    (whose map files both packages read)."""

    def __init__(self, noise=(0.0,) * 4, dtype=torch.float64, device=None):
        # noise = (gyr_noise, acc_noise, gyr_walk, acc_walk), already √rate-scaled
        self.dtype = dtype
        self.device = resolve_device(device)
        gn, an, gw, aw = noise
        self.noise_diag = np.array([gn * gn] * 3 + [an * an] * 3, np.float64)
        self.walk_diag = np.array([gw * gw] * 3 + [aw * aw] * 3, np.float64)
        self.bg = np.zeros(3)
        self.ba = np.zeros(3)
        self.dbg = np.zeros(3)
        self.dba = np.zeros(3)
        self.start_time = -1.0
        self.end_time = -1.0
        self._rows_dt = []
        self._rows_acc = []
        self._rows_gyr = []
        self._state: Optional[PreintState] = None

    # -- measurement ingestion ---------------------------------------------

    def add_batch(self, imu_data, t0: float, t1: float):
        if len(imu_data) == 0:
            return
        self.start_time = t0 if self.start_time < 0 else self.start_time
        self.end_time = t1
        dts, accs, gyrs = midpoint_batch(imu_data, t0, t1)
        self._rows_dt.extend(dts.tolist())
        self._rows_acc.extend(np.asarray(accs).reshape(-1, 3))
        self._rows_gyr.extend(np.asarray(gyrs).reshape(-1, 3))
        self._state = None  # lazy recompute

    def valid(self) -> bool:
        return self.start_time >= 0 and self.end_time > self.start_time and len(self._rows_dt) > 0

    def reset(self):
        self.__init__(
            noise=(float(np.sqrt(self.noise_diag[0])), float(np.sqrt(self.noise_diag[3])),
                   float(np.sqrt(self.walk_diag[0])), float(np.sqrt(self.walk_diag[3]))),
            dtype=self.dtype, device=self.device)

    def set_bias(self, bg, ba):
        """SetBias + Repropagate (src/imu.cc:145-155)."""
        self.bg = np.asarray(bg, np.float64)
        self.ba = np.asarray(ba, np.float64)
        self.dbg = np.zeros(3)
        self.dba = np.zeros(3)
        self._state = None

    def update_bias(self, bg_new, ba_new):
        """Linearized bias correction without repropagation (src/imu.cc:151-155)."""
        self.dbg = np.asarray(bg_new, np.float64) - self.bg
        self.dba = np.asarray(ba_new, np.float64) - self.ba

    # -- computation --------------------------------------------------------

    @staticmethod
    def _padded_len(n: int) -> int:
        p = 8
        while p < n:
            p *= 2
        return p

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, np.float64), device=self.device).to(self.dtype)

    @property
    def state(self) -> PreintState:
        if self._state is None:
            n = len(self._rows_dt)
            p = self._padded_len(max(n, 1))
            dts = np.zeros((p,))
            accs = np.zeros((p, 3))
            gyrs = np.zeros((p, 3))
            if n:
                dts[:n] = self._rows_dt
                accs[:n] = np.stack(self._rows_acc)
                gyrs[:n] = np.stack(self._rows_gyr)
            t = self._tensor
            self._state = preintegrate(t(dts), t(accs), t(gyrs), t(self.bg), t(self.ba),
                                       t(self.noise_diag), t(self.walk_diag))
        return self._state

    @property
    def dT(self) -> float:
        return float(self.state.dT)

    def updated_delta(self):
        """(dR, dV, dP) at the linearized updated bias, as numpy arrays of the
        state's dtype."""
        st, t = self.state, self._tensor
        bg, ba = t(self.bg), t(self.ba)
        bg_new, ba_new = t(self.bg + self.dbg), t(self.ba + self.dba)
        return tuple(x.cpu().numpy() for x in (
            delta_rotation(st, bg, bg_new), delta_velocity(st, bg, ba, bg_new, ba_new),
            delta_position(st, bg, ba, bg_new, ba_new)))

    def predict(self, Twb0: np.ndarray, vwb0: np.ndarray, g_value: float):
        """Twb0 (4,4), vwb0 (3,) -> (Twb1, vwb1)."""
        if not self.valid():
            return Twb0.copy(), np.asarray(vwb0).copy()
        dR, dV, dP = self.updated_delta()
        Rwb0 = Twb0[:3, :3]
        twb0 = Twb0[:3, 3]
        g = np.array([0.0, 0.0, -g_value])
        dT = self.dT
        Twb1 = np.eye(4)
        Twb1[:3, :3] = lie.normalize_rotation(self._tensor(Rwb0 @ dR)).cpu().numpy()
        Twb1[:3, 3] = twb0 + vwb0 * dT + 0.5 * dT * dT * g + Rwb0 @ dP
        vwb1 = vwb0 + dT * g + Rwb0 @ dV
        return Twb1, vwb1
