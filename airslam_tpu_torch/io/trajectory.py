"""TUM-format trajectory files (``SaveTumTrajectoryToFile``, utils.cc:281-313).

Port of ``airslam_tpu/io/trajectory.py`` (whole file)."""

from __future__ import annotations

import numpy as np
import torch

from airslam_tpu_torch.core import lie


def save_tum(path: str, trajectory):
    """trajectory: iterable of (timestamp_seconds, Twc 4×4). Writes
    ``timestamp tx ty tz qx qy qz qw`` lines."""
    with open(path, "w") as f:
        for ts, T in trajectory:
            t = T[:3, 3]
            q = lie.rot_to_quat(torch.as_tensor(np.asarray(T[:3, :3], np.float64))).numpy()
            # rot_to_quat gives (w, x, y, z)
            f.write(
                f"{ts:.9f} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}\n"
            )


def load_tum(path: str):
    """Returns [(timestamp, Twc)] parsed from a TUM file."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts, tx, ty, tz, qx, qy, qz, qw = (float(x) for x in line.split()[:8])
            T = np.eye(4)
            T[:3, :3] = lie.quat_to_rot(
                torch.tensor([qw, qx, qy, qz], dtype=torch.float64)).numpy()
            T[:3, 3] = [tx, ty, tz]
            out.append((ts, T))
    return out


def ate_rmse(est, gt, align=True):
    """Absolute trajectory error RMSE with optional Umeyama Sim(3) alignment —
    the metric computed by evo_ape (scripts/evaluation.py:96-99, flags -as)."""
    est_t = np.asarray([T[:3, 3] for _, T in est])
    gt_t = np.asarray([T[:3, 3] for _, T in gt])
    n = min(len(est_t), len(gt_t))
    est_t, gt_t = est_t[:n], gt_t[:n]
    if align and n >= 3:
        mu_e = est_t.mean(0)
        mu_g = gt_t.mean(0)
        E = est_t - mu_e
        G = gt_t - mu_g
        U, S, Vt = np.linalg.svd(G.T @ E / n)
        d = np.sign(np.linalg.det(U @ Vt))
        D = np.diag([1, 1, d])
        R = U @ D @ Vt
        var = (E * E).sum() / n
        s = np.trace(np.diag(S) @ D) / var if var > 0 else 1.0
        est_t = (s * (R @ est_t.T)).T + (mu_g - s * R @ mu_e)
    err = est_t - gt_t
    return float(np.sqrt((err * err).sum(axis=1).mean()))
