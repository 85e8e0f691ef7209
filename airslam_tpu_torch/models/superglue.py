"""SuperGlue feature matcher (the alternative matcher, ``matcher: 1``).

Port of ``airslam_tpu/models/superglue.py``: a keypoint MLP encoder added to
the descriptors, alternating self/cross attentional propagation layers with
residual message MLPs, a final projection and scaled dot-product scores,
then the log-domain Sinkhorn with a learned dustbin score
(``ops/match.log_sinkhorn``) when ``sinkhorn_iterations > 0``. The
attention is the plain ``ops/attention.mha``: the JAX module calls its plain
``mha`` too, which reaches no Pallas kernel. Every function takes any number
of leading batch dimensions: keypoints (…, N, 2), scores (…, N),
descriptors (…, N, dim), masks (…, N).

Numerics follow the flax module: LayerNorm eps 1e-6 in f32, the final
projection and the score matrix in f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from airslam_tpu_torch.ops.attention import mha
from airslam_tpu_torch.ops.match import log_sinkhorn

# The shipped superglue.npz checkpoint is trained THROUGH Sinkhorn with this
# iteration count; inference uses the same so that the exp > 0.2 decode sees
# genuine transport log-probabilities.
SG_SINKHORN_ITERS = 20


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor, dtype) -> torch.Tensor:
    return ln(x.float()).to(dtype)


class KeypointEncoder(nn.Module):
    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        widths = [3, 32, 64, 128, 256]
        self.dtype = dtype
        self.fc = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.ln = nn.ModuleList(nn.LayerNorm(b, eps=1e-6) for b in widths[1:])
        self.out = nn.Linear(widths[-1], dim)

    def forward(self, kpts, scores):
        x = torch.cat([kpts, scores[..., None]], dim=-1).to(self.dtype)
        for fc, ln in zip(self.fc, self.ln):
            x = torch.relu(_layer_norm(ln, fc(x), self.dtype))
        return self.out(x)


class AttentionalPropagation(nn.Module):
    def __init__(self, dim: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.heads = heads
        self.dtype = dtype
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.merge = nn.Linear(dim, dim)
        self.mlp1 = nn.Linear(2 * dim, 2 * dim)
        self.mlp_ln = nn.LayerNorm(2 * dim, eps=1e-6)
        self.mlp2 = nn.Linear(2 * dim, dim)

    def _heads_first(self, t):  # (…, N, H·D) -> (…, H, N, D)
        return t.reshape(*t.shape[:-1], self.heads, -1).transpose(-3, -2)

    def forward(self, x, source, source_mask):
        q = self._heads_first(self.q(x))
        k = self._heads_first(self.k(source))
        v = self._heads_first(self.v(source))
        msg = mha(q, k, v, kv_mask=source_mask).transpose(-3, -2)
        msg = self.merge(msg.reshape(*msg.shape[:-2], -1))
        y = self.mlp1(torch.cat([x, msg], dim=-1))
        y = self.mlp2(torch.relu(_layer_norm(self.mlp_ln, y, self.dtype)))
        return x + y


class SuperGlue(nn.Module):
    """``sinkhorn_iterations``: 0 returns the raw scores (the reference's
    behaviour); the shipped checkpoint wants :data:`SG_SINKHORN_ITERS`.
    ``return_full`` (training only) returns the whole (…, N0+1, N1+1) log
    transport plan, the dustbin row and column included, so that unmatched
    keypoints can be supervised; the parameters are the same."""

    def __init__(self, dim: int = 256, heads: int = 4, gnn_layers: int = 9,
                 sinkhorn_iterations: int = 0, dtype=torch.float32, return_full: bool = False):
        super().__init__()
        self.dim = dim
        self.dtype = dtype
        self.sinkhorn_iterations = sinkhorn_iterations
        self.return_full = return_full
        self.kenc = KeypointEncoder(dim, dtype)
        self.self_layers = nn.ModuleList(AttentionalPropagation(dim, heads, dtype)
                                         for _ in range(gnn_layers))
        self.cross_layers = nn.ModuleList(AttentionalPropagation(dim, heads, dtype)
                                          for _ in range(gnn_layers))
        self.final_proj = nn.Linear(dim, dim)
        self.bin_score = nn.Parameter(torch.ones(()))
        self.to(dtype)
        # LayerNorms and the dustbin stay float32, as in the flax module
        for mod in self.modules():
            if isinstance(mod, nn.LayerNorm):
                mod.float()
        self.bin_score.data = self.bin_score.data.float()

    def forward(self, kpts0, scores0, desc0, mask0, kpts1, scores1, desc1, mask1):
        """Returns the (…, N0, N1) log scores (the inner block of the
        transport plan when Sinkhorn runs; the whole plan with
        ``return_full``)."""
        x0 = desc0.to(self.dtype) + self.kenc(kpts0, scores0)
        x1 = desc1.to(self.dtype) + self.kenc(kpts1, scores1)
        for sb, cb in zip(self.self_layers, self.cross_layers):
            x0 = sb(x0, x0, mask0)
            x1 = sb(x1, x1, mask1)
            x0, x1 = cb(x0, x1, mask1), cb(x1, x0, mask0)
        md0 = self.final_proj(x0).float()
        md1 = self.final_proj(x1).float()
        scores = md0 @ md1.transpose(-1, -2) / math.sqrt(self.dim)
        if self.sinkhorn_iterations > 0:
            z = log_sinkhorn(scores, mask0, mask1, self.bin_score, self.sinkhorn_iterations)
            scores = z if self.return_full else z[..., :-1, :-1]
        return scores
