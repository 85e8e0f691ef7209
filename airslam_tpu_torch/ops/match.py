"""Match decoding: mutual argmax with an exp-score threshold.

Port of ``airslam_tpu/ops/match.py:Matches`` / ``mutual_match``
(``filter_matches``, src/light_glue.cpp:214-266). SuperGlue's
``log_sinkhorn`` is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_NEG = -1e9


class Matches(NamedTuple):
    idx1: torch.Tensor  # (…, N0) int64 — index into image-1 keypoints, -1 if none
    score: torch.Tensor  # (…, N0) — exp(log-score) of the match
    mask: torch.Tensor  # (…, N0) bool


def mutual_match(scores: torch.Tensor, mask0: torch.Tensor, mask1: torch.Tensor,
                 threshold: float) -> Matches:
    """Mutual row/col argmax + exp threshold over ``scores`` (…, N0, N1)
    with masks (…, N0) and (…, N1). ``argmax`` takes the first index on ties,
    as JAX does."""
    valid = mask0[..., :, None] & mask1[..., None, :]
    masked = torch.where(valid, scores, torch.full_like(scores, _NEG))
    row_best = masked.argmax(dim=-1)  # (…, N0)
    col_best = masked.argmax(dim=-2)  # (…, N1)
    row_val = masked.max(dim=-1).values
    n0 = scores.shape[-2]
    mutual = torch.gather(col_best, -1, row_best) == torch.arange(n0, device=scores.device)
    score = torch.exp(row_val)
    ok = mutual & (score > threshold) & mask0
    return Matches(idx1=torch.where(ok, row_best, torch.full_like(row_best, -1)),
                   score=torch.where(ok, score, torch.zeros_like(score)),
                   mask=ok)
