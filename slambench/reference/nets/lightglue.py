"""LightGlue, plain: a copy of ``airslam_tpu_torch/models/lightglue.py``
without the fused attention and the tensor-parallel split. Learnable-Fourier
rotary encoding on self-attention, bidirectional cross-attention sharing one
similarity matrix, gated token updates, and the final assignment combining
matchability logits with a doubly-log-softmaxed similarity.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from slambench.reference.nets.attention import mha

_NEG = -1e9


def rotate_half_pairs(x):
    """Rotate adjacent (even, odd) feature pairs: (a, b) -> (-b, a)."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def apply_rotary(x, cos, sin):
    """x: (…, H, N, D); cos/sin: (…, N, D) with values repeated per pair."""
    return x * cos[..., None, :, :] + rotate_half_pairs(x) * sin[..., None, :, :]


def _heads_first(t, h):
    """(…, N, H·D) -> (…, H, N, D)."""
    return t.reshape(*t.shape[:-1], h, -1).transpose(-3, -2)


def _merge(t):
    """(…, H, N, D) -> (…, N, H·D)."""
    t = t.transpose(-3, -2)
    return t.reshape(*t.shape[:-2], -1)


class FourierRotary(nn.Module):
    def __init__(self, head_dim: int):
        super().__init__()
        self.freqs = nn.Linear(2, head_dim // 2, bias=False)

    def forward(self, kpts):  # (…, N, 2) normalized coords, f32
        emb = torch.repeat_interleave(self.freqs(kpts), 2, dim=-1)
        return torch.cos(emb), torch.sin(emb)


class TokenUpdate(nn.Module):
    """Gated residual update: x += MLP(LN([x | message]))."""

    def __init__(self, dim: int):
        super().__init__()
        self.ln = nn.LayerNorm(2 * dim, eps=1e-6)
        self.fc1 = nn.Linear(2 * dim, 2 * dim)
        self.fc2 = nn.Linear(2 * dim, dim)

    def forward(self, x, message):
        h = self.ln(torch.cat([x, message], dim=-1).float())
        h = self.fc1(h.to(self.fc1.weight.dtype))
        h = self.fc2(F.gelu(h, approximate="tanh"))
        return x + h.to(x.dtype)


class SelfBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.update = TokenUpdate(dim)

    def _attend(self, qkv, heads, cos, sin, mask):
        q, k, v = (_heads_first(t, heads) for t in qkv.chunk(3, dim=-1))
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
        return _merge(mha(q, k, v, kv_mask=mask))

    def forward(self, x, cos, sin, mask):
        return self.update(x, self.proj(self._attend(self.qkv(x), self.heads, cos, sin, mask)))


class CrossBlock(nn.Module):
    """Bidirectional cross-attention sharing one similarity matrix."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_qk = nn.Linear(dim, dim)
        self.to_v = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)
        self.update = TokenUpdate(dim)

    def _attend(self, qk0, qk1, v0, v1, mask0, mask1, h):
        """Both directions' messages, (…, N, h·D) each."""
        qk0, qk1, v0, v1 = (_heads_first(t, h) for t in (qk0, qk1, v0, v1))
        d = qk0.shape[-1]
        sim = torch.einsum("...hnd,...hmd->...hnm", qk0, qk1) * (1.0 / math.sqrt(d))
        neg = torch.full_like(sim, _NEG)
        att01 = torch.softmax(torch.where(mask1[..., None, None, :], sim, neg), dim=-1)
        att10 = torch.softmax(torch.where(mask0[..., None, :, None], sim, neg), dim=-2)
        m0 = torch.einsum("...hnm,...hmd->...hnd", att01, v1)
        m1 = torch.einsum("...hnm,...hnd->...hmd", att10, v0)
        return _merge(m0), _merge(m1)

    def forward(self, x0, x1, mask0, mask1):
        m0, m1 = self._attend(self.to_qk(x0), self.to_qk(x1), self.to_v(x0), self.to_v(x1),
                              mask0, mask1, self.heads)
        return self.update(x0, self.proj(m0)), self.update(x1, self.proj(m1))


class LightGlue(nn.Module):
    def __init__(self, dim: int = 256, heads: int = 4, layers: int = 9,
                 dtype=torch.float32):
        super().__init__()
        self.dim = dim
        self.dtype = dtype
        self.rotary = FourierRotary(dim // heads)
        self.input_proj = nn.Linear(dim, dim)
        self.self_blocks = nn.ModuleList(SelfBlock(dim, heads)
                                         for _ in range(layers))
        self.cross_blocks = nn.ModuleList(CrossBlock(dim, heads)
                                          for _ in range(layers))
        self.final_proj = nn.Linear(dim, dim)
        self.matchability = nn.Linear(dim, 1)
        # compute dtype everywhere except where the flax module pins f32
        self.to(dtype)
        self.rotary.float()
        self.matchability.float()
        for blk in (*self.self_blocks, *self.cross_blocks):
            blk.update.ln.float()

    def forward(self, kpts0, desc0, mask0, kpts1, desc1, mask1):
        """kpts: (…, N, 2) normalized, desc: (…, N, dim) L2-normalized, mask:
        (…, N) bool. Returns the (…, N0, N1) log-assignment matrix and the
        two matchability logits."""
        cos0, sin0 = (t.to(self.dtype) for t in self.rotary(kpts0.float()))
        cos1, sin1 = (t.to(self.dtype) for t in self.rotary(kpts1.float()))
        x0 = self.input_proj(desc0.to(self.dtype))
        x1 = self.input_proj(desc1.to(self.dtype))
        for sb, cb in zip(self.self_blocks, self.cross_blocks):
            x0 = sb(x0, cos0, sin0, mask0)
            x1 = sb(x1, cos1, sin1, mask1)
            x0, x1 = cb(x0, x1, mask0, mask1)

        md0 = self.final_proj(x0).float()
        md1 = self.final_proj(x1).float()
        sim = md0 @ md1.transpose(-1, -2) / math.sqrt(self.dim)
        z0 = self.matchability(x0.float())[..., 0]
        z1 = self.matchability(x1.float())[..., 0]
        sim_m = torch.where(mask0[..., :, None] & mask1[..., None, :], sim,
                            torch.full_like(sim, _NEG))
        scores = (F.log_softmax(sim_m, dim=-1) + F.log_softmax(sim_m, dim=-2)
                  + F.logsigmoid(z0)[..., :, None] + F.logsigmoid(z1)[..., None, :])
        return scores, z0, z1


def normalize_keypoints(kpts, width, height, scale=0.5):
    """PointMatcher::NormalizeKeypoints (point_matcher.cc:39-49):
    (x - w/2) * scale / max(w, h)."""
    l_inv = scale / max(width, height)
    center = torch.tensor([width / 2.0, height / 2.0], dtype=kpts.dtype,
                          device=kpts.device)
    return (kpts - center) * l_inv
