"""The map of a map-scale GlobalBA cell, built from the seed.

Copied from ``chip_smoke.map_scale_scene`` (the scene of
``tests/test_global_ba.py::test_map_scale_1000kf_100kpts``), with its sizes
read from the workload file's ``traffic`` block: ``keyframes`` on a circle
of ``radius_m`` with identity rotations, ``points`` points each seen by
``obs_per_point`` consecutive keyframes with exact stereo observations
through the configuration's camera, the poses perturbed by
``pose_noise_m`` and the points by ``point_noise_m`` (standard deviations),
the first keyframe fixed. Every seed gives the same sizes; the seed moves
the points and the perturbations. The truth (``twb``, ``pts``) is the
solve's exact optimum: the observations are exact.
"""

from __future__ import annotations

import numpy as np


def generate(traffic: dict, camera: dict, seed: int) -> dict:
    F, P = int(traffic["keyframes"]), int(traffic["points"])
    obs_per = int(traffic["obs_per_point"])
    fx, fy, cx, cy, bf = (float(camera[k]) for k in ("fx", "fy", "cx", "cy", "bf"))
    rng = np.random.RandomState(int(seed) % 2 ** 32)
    th = np.linspace(0, 2 * np.pi, F, endpoint=False)
    radius = float(traffic["radius_m"])
    twb = np.stack([radius * np.cos(th), radius * np.sin(th), np.zeros(F)], -1)
    pts = twb[rng.randint(0, F, P)] + np.stack(
        [rng.uniform(-3, 3, P), rng.uniform(-3, 3, P), rng.uniform(4, 9, P)], -1)
    anchor = rng.randint(0, F - obs_per, P)
    pidx = np.repeat(np.arange(P, dtype=np.int64), obs_per)
    fidx = (anchor[:, None] + np.arange(obs_per)[None, :]).astype(np.int64).ravel()
    rel = pts[pidx] - twb[fidx]  # identity rotations: camera frame = world
    z = rel[:, 2]
    u = fx * rel[:, 0] / z + cx
    v = fy * rel[:, 1] / z + cy
    ok = (z > 0.5) & (u > -200) & (u < 1000) & (v > -200) & (v < 700)
    twb0 = twb + rng.randn(F, 3) * float(traffic["pose_noise_m"])
    twb0[0] = twb[0]
    pts0 = pts + rng.randn(P, 3) * float(traffic["point_noise_m"])
    pose_fixed = np.zeros(F, bool)
    pose_fixed[0] = True
    return dict(Rwb=np.tile(np.eye(3), (F, 1, 1)), twb=twb, twb0=twb0, pts=pts, pts0=pts0,
                pidx=pidx, fidx=fidx, pobs=np.stack([u, v, u - bf / z], -1), ok=ok,
                pose_fixed=pose_fixed)


def obs_table(pidx: np.ndarray, ok: np.ndarray, n_points: int, width: int) -> np.ndarray:
    """(P, width) observation-index table, padded with the observation count:
    a point keeps its first ``width`` valid observations (the order of
    ``global_ba.build_obs_table``)."""
    n = len(pidx)
    table = np.full((n_points, width), n, np.int64)
    idx = np.nonzero(ok)[0]
    p = pidx[idx]
    order = np.argsort(p, kind="stable")
    idx, p = idx[order], p[order]
    first = np.searchsorted(p, p, side="left")
    slot = np.arange(len(p)) - first
    keep = slot < width
    table[p[keep], slot[keep]] = idx[keep]
    return table


def table_width(pidx: np.ndarray, ok: np.ndarray, n_points: int) -> int:
    """The table width ``Map._sparse_global_ba`` picks: the largest count of
    valid observations of a point, bucketed up to a multiple of 8, at most 64."""
    widest = max(int(np.bincount(pidx[ok], minlength=n_points).max()), 1)
    return min(-(-widest // 8) * 8, 64)
