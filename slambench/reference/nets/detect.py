"""Fixed-shape keypoint decoding (threshold + border + top-k) and NMS.

Port of ``airslam_tpu/ops/detect.py``. ``top_k`` is exact ``torch.topk``:
the JAX ``approx_max_k`` returns exactly ``lax.top_k``'s indices off the TPU.
Ties (only among zero-score, masked slots) may resolve to other indices than
JAX's lowest-index rule; every caller masks those slots.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from slambench.reference.nets.gather import take_rows, take_values


class Keypoints(NamedTuple):
    xy: torch.Tensor  # (K, 2) float — x, y in heatmap pixels
    score: torch.Tensor  # (K,)
    mask: torch.Tensor  # (K,) bool


def top_k(scores: torch.Tensor, k: int):
    """Top-k over a flat score vector, sorted descending. Returns (values,
    int64 indices)."""
    return torch.topk(scores, k, sorted=True)


def topk_grid(masked: torch.Tensor, k: int, cell: int):
    """Two-stage top-k over a non-negative (H, W) plane: top-k cells by cell
    max, then top-k over those cells' pixels (every top-k pixel lives in one
    of them). Returns (scores (k,), flat_idx (k,) row-major into H·W)."""
    h, w = masked.shape
    hc, wc = h // cell, w // cell
    cells = masked.reshape(hc, cell, wc, cell).permute(0, 2, 1, 3)
    cells = cells.reshape(hc * wc, cell * cell)
    cmax = cells.max(dim=1).values
    _, cidx = top_k(cmax, k)
    cand = take_rows(cells, cidx)  # (k, cell²)
    scores, flat = top_k(cand.reshape(-1), k)
    ci = take_values(cidx, flat // (cell * cell))
    within = flat % (cell * cell)
    x = (ci % wc) * cell + within % cell
    y = (ci // wc) * cell + within // cell
    return scores, y * w + x


def topk_keypoints(heat: torch.Tensor, threshold: float, border: int,
                   k: int) -> Keypoints:
    """Top-k pixels above ``threshold`` outside the border. A pixel is kept
    iff ``border <= x <= w - border`` and likewise for y (the upper bound is
    inclusive, src/plnet.cpp:320-331)."""
    h, w = heat.shape
    ys = torch.arange(h, device=heat.device)[:, None]
    xs = torch.arange(w, device=heat.device)[None, :]
    keep = ((heat >= threshold) & (xs >= border) & (xs <= w - border)
            & (ys >= border) & (ys <= h - border))
    masked = torch.where(keep, heat, torch.zeros_like(heat))
    if h % 8 == 0 and w % 8 == 0 and (h // 8) * (w // 8) >= 2 * k:
        scores, idx = topk_grid(masked, k, 8)
    else:
        scores, idx = top_k(masked.reshape(-1), k)
    x = (idx % w).to(heat.dtype)
    y = (idx // w).to(heat.dtype)
    valid = scores > 0
    return Keypoints(xy=torch.stack([x, y], dim=-1),
                     score=torch.where(valid, scores, torch.zeros_like(scores)),
                     mask=valid)


def simple_nms(heat: torch.Tensor, radius: int) -> torch.Tensor:
    """Zero out non-maxima within a (2r+1)² window (-inf padded)."""
    if radius <= 0:
        return heat
    window = 2 * radius + 1
    pooled = F.max_pool2d(heat[None, None], window, stride=1, padding=radius)[0, 0]
    return torch.where(heat == pooled, heat, torch.zeros_like(heat))
