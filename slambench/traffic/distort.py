"""Frozen copy of the port's distortion of rendered views.

Copied from ``apps/make_synth_dataset_torch.py``'s ``inverse_maps`` and
``distort``; the rectification comes from :mod:`slambench.traffic.rig`
instead of the program's ``Camera``.
"""

from __future__ import annotations

import numpy as np
import torch

from slambench.traffic.rig import rectification


def inverse_maps(camera: dict):
    """For every DISTORTED pixel of each view, where it lands in the
    rectified frame (``cv2.undistortPoints`` through R and P), so that
    sampling the rendered rectified view there gives the raw image whose
    rectification recovers the render. Returns (rectification dict,
    {"cam0": (H, W, 2), "cam1": (H, W, 2)})."""
    import cv2

    rect = rectification(camera)
    # with identical cameras and a pure-x baseline the rectifying rotations
    # are the identity: the rendered camera frame is cam0's
    for k in ("R0", "R1"):
        if np.abs(rect[k] - np.eye(3)).max() >= 1e-6:
            raise ValueError(f"{k} is not the identity:\n{rect[k]}")
    h, w = rect["height"], rect["width"]
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    pix = np.stack([xs, ys], -1).reshape(-1, 1, 2)
    maps = {}
    for side, K, D, Rr, P in (("cam0", rect["K0"], rect["D0"], rect["R0"], rect["P0"]),
                              ("cam1", rect["K1"], rect["D1"], rect["R1"], rect["P1"])):
        m = cv2.undistortPoints(pix, K, D, R=Rr, P=P[:3, :3])
        maps[side] = m.reshape(h, w, 2).astype(np.float32)
    return rect, maps


def distort(img: torch.Tensor, inv_map: torch.Tensor) -> torch.Tensor:
    """Each rectified view (N, H, W) sampled bilinearly at the inverse warp
    (H, W, 2), the border replicated, in exact float arithmetic."""
    m = inv_map.to(img.device)
    n, h, w = img.shape
    x, y = m[..., 0], m[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    flat = img.reshape(n, h * w)

    def tap(yy, xx):
        idx = yy.clamp(0, h - 1).long() * w + xx.clamp(0, w - 1).long()
        return flat[:, idx.reshape(-1)].reshape(n, h, w)

    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bottom = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bottom * fy
