"""Bilinear sampling: image remap (rectification) and descriptor grid-sample.

Port of ``airslam_tpu/ops/gridsample.py``. :func:`remap` is the plain
PyTorch twin of kernel R (``ops/remap.py``); :func:`sample_descriptors` is
the keypoint descriptor interpolation of ``PLNet::extract_descriptors``.
"""

from __future__ import annotations

import torch


def remap(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear remap: ``out[y, x] = image(grid[y, x, 0], grid[y, x, 1])``.

    ``image``: (H, W) or (H, W, C); ``grid``: (Ho, Wo, 2) with (x, y) source
    coordinates (cv::remap map1/map2 convention). Integer taps clamp to the
    border; fractional weights are NOT clipped (gridsample.py:31-54).
    """
    h, w = image.shape[0], image.shape[1]
    x = grid[..., 0]
    y = grid[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0

    x0i = x0.to(torch.int64).clamp(0, w - 1)
    x1i = (x0i + 1).clamp(0, w - 1)
    y0i = y0.to(torch.int64).clamp(0, h - 1)
    y1i = (y0i + 1).clamp(0, h - 1)

    v00 = image[y0i, x0i]
    v01 = image[y0i, x1i]
    v10 = image[y1i, x0i]
    v11 = image[y1i, x1i]

    if image.ndim == 3:
        wx = wx[..., None]
        wy = wy[..., None]
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def sample_descriptors(desc_map: torch.Tensor, kpts: torch.Tensor,
                       stride: int = 8) -> torch.Tensor:
    """Sample L2-normalized descriptors at keypoint locations.

    ``desc_map``: (C, Hc, Wc) descriptor grid at ``stride``; ``kpts``: (N, 2)
    (x, y) in input-resolution pixels. Returns (N, C), rows L2-normalized.

    The exact align-corners arithmetic of ``extract_descriptors``
    (src/plnet.cpp:369-417): ``sx = 2/(w*s - s/2 - 0.5)``,
    ``bx = (1-s)/(w*s - s/2 - 0.5) - 1`` and the 4-tap scheme whose NE/SW
    corners clamp before the +1 offset.
    """
    c, hc, wc = desc_map.shape
    s = float(stride)
    dx = wc * s - s / 2 - 0.5
    dy = hc * s - s / 2 - 0.5
    sx, bx = 2.0 / dx, (1.0 - s) / dx - 1.0
    sy, by = 2.0 / dy, (1.0 - s) / dy - 1.0

    xn = (kpts[:, 0] * sx + bx + 1.0) * 0.5
    yn = (kpts[:, 1] * sy + by + 1.0) * 0.5
    ix = xn * (wc - 1)
    iy = yn * (hc - 1)

    ix_nw = torch.floor(ix).to(torch.int64).clamp(0, wc - 1)
    iy_nw = torch.floor(iy).to(torch.int64).clamp(0, hc - 1)
    ix_ne = (ix_nw + 1).clamp(0, wc - 1)
    iy_ne = iy_nw
    ix_sw = ix_nw
    iy_sw = (iy_nw + 1).clamp(0, hc - 1)
    ix_se = (ix_nw + 1).clamp(0, wc - 1)
    iy_se = (iy_nw + 1).clamp(0, hc - 1)

    f = ix.dtype
    w_nw = (ix_se.to(f) - ix) * (iy_se.to(f) - iy)
    w_ne = (ix - ix_sw.to(f)) * (iy_sw.to(f) - iy)
    w_sw = (ix_ne.to(f) - ix) * (iy - iy_ne.to(f))
    w_se = (ix - ix_nw.to(f)) * (iy - iy_nw.to(f))

    flat_t = desc_map.reshape(c, hc * wc).t()  # (Hc·Wc, C)

    def gather(yy, xx):
        return flat_t[yy * wc + xx]

    out = (gather(iy_nw, ix_nw) * w_nw[:, None]
           + gather(iy_ne, ix_ne) * w_ne[:, None]
           + gather(iy_sw, ix_sw) * w_sw[:, None]
           + gather(iy_se, ix_se) * w_se[:, None])
    # eps inside the sqrt: far-edge points get exactly-zero weights
    norm = torch.sqrt(torch.sum(out * out, dim=1, keepdim=True) + 1e-24)
    return out / torch.clamp(norm, min=1e-12)
