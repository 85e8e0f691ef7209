"""Plain multi-head attention: a copy of ``mha`` of
``airslam_tpu_torch/ops/attention.py`` (LightGlue without ``use_flash``)."""

from __future__ import annotations

import math

import torch

_NEG = -1e9


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        kv_mask: torch.Tensor = None) -> torch.Tensor:
    """q: (…, H, Nq, D), k/v: (…, H, Nk, D), kv_mask: (…, Nk) bool."""
    d = q.shape[-1]
    logits = torch.einsum("...hqd,...hkd->...hqk", q, k) / math.sqrt(d)
    if kv_mask is not None:
        logits = torch.where(kv_mask[..., None, None, :], logits,
                             torch.full_like(logits, _NEG))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("...hqk,...hkd->...hqd", w, v)
