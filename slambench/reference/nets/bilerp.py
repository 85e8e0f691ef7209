"""Plain sampling of the stage-1 LOI head: a copy of ``_corners``,
``bilerp_plain`` and ``loi_features_plain`` of
``airslam_tpu_torch/ops/bilerp.py``, the plain twin of kernel
``loi_features``."""

from __future__ import annotations

import torch


def _corners(n: torch.Tensor, size: int):
    n0 = torch.clamp(torch.floor(n), 0.0, size - 1)
    n1 = torch.clamp(n0 + 1.0, 0.0, size - 1)
    w0 = n1 - n
    w1 = n - n0
    same = n0 == n1
    return (n0.to(torch.int64), n1.to(torch.int64),
            torch.where(same, w0 + w1, w0), torch.where(same, torch.zeros_like(w1), w1))


def bilerp_plain(fmap: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sample ``fmap`` (H, W, C) at ``x``/``y`` (any shape): (..., C) float32."""
    h, w, c = fmap.shape
    shape = x.shape
    x = x.reshape(-1).float()
    y = y.reshape(-1).float()
    x0, x1, wx0, wx1 = _corners(x, w)
    y0, y1, wy0, wy1 = _corners(y, h)
    if fmap.dtype == torch.bfloat16:
        wy0 = wy0.to(torch.bfloat16).float()
        wy1 = wy1.to(torch.bfloat16).float()
    f = fmap.float()
    a = wy0[:, None] * f[y0, x0] + wy1[:, None] * f[y1, x0]
    b = wy0[:, None] * f[y0, x1] + wy1[:, None] * f[y1, x1]
    out = a * wx0[:, None] + b * wx1[:, None]
    return out.reshape(shape + (c,))


def loi_features(loi, loi_thin, loi_aux, junc_xy, pair_idx, lines, prop_lines,
                 t_fwd, t_rev, out_dtype=None) -> torch.Tensor:
    """The stage-1 head's sampling, view by view: the LOI map at each
    junction − 0.5 gathered by the clamped ``pair_idx``, the thin map along
    ``lines`` and the aux map along ``prop_lines``, flattened channel-major."""
    rows = []
    for v in range(loi.shape[0]):
        f_junc = bilerp_plain(loi[v], junc_xy[v, :, 0] - 0.5, junc_xy[v, :, 1] - 0.5)
        idx = pair_idx[v].clamp(0, junc_xy.shape[1] - 1)
        parts = [f_junc[idx[:, 0]], f_junc[idx[:, 1]]]
        for fmap, seg in ((loi_thin[v], lines[v]), (loi_aux[v], prop_lines[v])):
            x = seg[:, 0:1] * t_fwd[None, :] + seg[:, 2:3] * t_rev[None, :] - 0.5
            y = seg[:, 1:2] * t_fwd[None, :] + seg[:, 3:4] * t_rev[None, :] - 0.5
            parts.append(bilerp_plain(fmap, x, y).transpose(1, 2).reshape(seg.shape[0], -1))
        rows.append(torch.cat(parts, dim=-1))
    return torch.stack(rows).to(out_dtype or loi.dtype)
