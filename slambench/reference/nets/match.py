"""Match decoding and optimal transport.

Port of ``airslam_tpu/ops/match.py``: ``Matches`` / ``mutual_match``
(``filter_matches``, src/light_glue.cpp:214-266) and SuperGlue's log-domain
Sinkhorn ``log_sinkhorn`` (src/super_glue.cpp:369-435).
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


def log_sinkhorn(scores: torch.Tensor, mask0: torch.Tensor, mask1: torch.Tensor,
                 bin_score: torch.Tensor, iters: int) -> torch.Tensor:
    """Log-domain Sinkhorn with a dustbin row and column (SuperGlue's optimal
    transport) over ``scores`` (…, N0, N1) with masks (…, N0) / (…, N1) and
    a scalar ``bin_score``. Returns the (…, N0+1, N1+1) log transport plan;
    the inner (N0, N1) block feeds :func:`mutual_match`. Padded keypoints
    score −1e9 against everything but the dustbin, so the marginals hold for
    any count of real keypoints."""
    n0, n1 = scores.shape[-2:]
    dt = scores.dtype
    m = mask0.to(dt).sum(-1, keepdim=True)  # (…, 1)
    n = mask1.to(dt).sum(-1, keepdim=True)
    neg = torch.full_like(scores, _NEG)
    bin_ = bin_score.to(dt).expand(scores.shape[:-2] + (1,))
    inner = torch.where(mask0[..., :, None] & mask1[..., None, :], scores, neg)
    col = torch.where(mask0, bin_, torch.full_like(bin_, _NEG))[..., :, None]  # (…, N0, 1)
    row = torch.where(mask1, bin_, torch.full_like(bin_, _NEG))[..., None, :]  # (…, 1, N1)
    couplings = torch.cat([torch.cat([inner, col], -1),
                           torch.cat([row, bin_[..., None]], -1)], -2)

    norm = -torch.log(m + n)
    zero = torch.zeros((), dtype=dt, device=scores.device)
    log_mu = torch.cat([torch.where(mask0, zero, zero + _NEG), torch.log(n.clamp(min=1.0))],
                       -1) + norm
    log_nu = torch.cat([torch.where(mask1, zero, zero + _NEG), torch.log(m.clamp(min=1.0))],
                       -1) + norm
    u = torch.zeros(scores.shape[:-2] + (n0 + 1,), dtype=dt, device=scores.device)
    v = torch.zeros(scores.shape[:-2] + (n1 + 1,), dtype=dt, device=scores.device)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(couplings + v[..., None, :], dim=-1)
        v = log_nu - torch.logsumexp(couplings + u[..., :, None], dim=-2)
    z = couplings + u[..., :, None] + v[..., None, :]
    return z - norm[..., None]  # undo the normalization, as SuperGlue does
