"""Detector training on synthetic shapes: PLNet stage 0 with the stage-1 LOI
head, SuperPoint, and SuperPoint distilled onto PLNet's descriptor space.

Port of ``airslam_tpu/parallel/train_plnet.py``. Supervision comes from
:mod:`airslam_tpu_torch.frontend.synthgen`'s exact ground truth:

- keypoint head: the 65-way cell cross-entropy on corner cells;
- junction head: BCE heatmap and masked L1 sub-cell offsets at stride 4;
- line-proposal head: endpoint regression (best of 3) and proposal-logit BCE
  on segment-centre cells;
- LOI head (from the imported stage-1 weights): BCE separating true segments
  from corner-pair decoys, sampled on the live maps through
  ``ops.bilerp.loi_features`` and, on the card, its backward kernel B+T′;
- descriptors: InfoNCE over the exact corner correspondences of a pair.

The JAX trainer takes the mean over a ``vmap`` of per-image losses; here the
batch runs through the nets at once, each loss term is computed per image
(a (B,) tensor) and the same means are taken. Every random draw (scenes,
LOI candidates) is an explicit tensor from a ``torch.Generator``, so a test
can hand both packages the same draws. The optimizer is optax's
``chain(clip_by_global_norm(5), adam(lr))`` (:class:`ClippedAdam`); fresh
networks get flax's initialisers (:func:`flax_init_`).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from airslam_tpu_torch.backend.gn import deterministic
from airslam_tpu_torch.frontend import synthgen
from airslam_tpu_torch.ops.gridsample import sample_descriptors
from airslam_tpu_torch.parallel.mesh import dp_gradients, refresh_replicas

SIZE = synthgen.SIZE
GRID8 = SIZE // 8  # 64
GRID4 = SIZE // 4  # 128
NEG_PAIRS = synthgen.MAX_SEGMENTS  # LOI decoys per image (2 × NEG_PAIRS corner pairs)

WEIGHTS = {
    "kp": 1.0, "junc": 1.0, "junc_off": 0.25, "line_reg": 0.1,
    "line_logit": 1.0, "loi": 0.5, "desc": 1.0,
}


class Targets(NamedTuple):
    kp_label: torch.Tensor  # (B, 64, 64) int64 in [0, 64]; 64 = dustbin
    junc_heat: torch.Tensor  # (B, 128, 128) {0, 1}
    junc_off: torch.Tensor  # (B, 128, 128, 2) in [0, 1)
    junc_mask: torch.Tensor  # (B, 128, 128) bool
    line_target: torch.Tensor  # (B, 128, 128, 4) endpoints in 128-grid coords
    line_mask: torch.Tensor  # (B, 128, 128) bool, cells holding a segment centre


def _cells(v: torch.Tensor, size: int) -> torch.Tensor:
    """``clip(v.astype(int32), 0, size - 1)``: truncation toward zero."""
    return torch.clamp(v.to(torch.int64), 0, size - 1)


def _scatter(base: torch.Tensor, flat: torch.Tensor, values: torch.Tensor, reduce: str):
    """``base.at[cells].<reduce>(values)`` on (B, G, G[, K]) grids, with
    ``flat`` (B, N) the cells' row-major indices. ``set`` keeps one of
    colliding writes (``.at[].set`` leaves which undefined), the same one in
    every run: the write runs under deterministic algorithms, where a CUDA
    write's winner would otherwise change from run to run."""
    b = base.shape[0]
    g2 = base.shape[1] * base.shape[2]
    tail = base.shape[3:]
    out = base.reshape((b, g2) + tail).clone()
    if reduce == "set":
        rows = torch.arange(b, device=base.device)[:, None].expand_as(flat)
        with deterministic():
            out[rows, flat] = values
    else:
        idx = flat.reshape(flat.shape + (1,) * len(tail)).expand(flat.shape + tail)
        out.scatter_reduce_(1, idx, values, reduce, include_self=True)
    return out.reshape(base.shape)


def scene_targets(scene: synthgen.Scene) -> Targets:
    """Rasterize the ground truth onto the head grids (train_plnet.py:47)."""
    c, cm = scene.corners, scene.corner_mask
    b, dev = c.shape[0], c.device
    cx = _cells(c[..., 0], SIZE)
    cy = _cells(c[..., 1], SIZE)
    within = (cy % 8) * 8 + cx % 8
    # invalid corners scatter to a dummy cell; min() keeps a deterministic
    # winner on collisions and never lifts the dustbin above a real label
    cell = torch.where(cm, (cy // 8) * GRID8 + cx // 8, GRID8 * GRID8 - 1)
    within = torch.where(cm, within, 64)
    kp_label = _scatter(torch.full((b, GRID8, GRID8), 64, dtype=torch.int64, device=dev),
                        cell, within, "amin")

    jx, jy = c[..., 0] / 4.0, c[..., 1] / 4.0
    jcx = torch.where(cm, _cells(jx, GRID4), GRID4 - 1)
    jcy = torch.where(cm, _cells(jy, GRID4), GRID4 - 1)
    cell4 = jcy * GRID4 + jcx
    zeros = torch.zeros((b, GRID4, GRID4), device=dev)
    heat = _scatter(zeros, cell4, cm.float(), "amax")
    off_v = torch.where(cm[..., None], torch.stack([jx - jcx, jy - jcy], -1), 0.0)
    off = _scatter(torch.zeros((b, GRID4, GRID4, 2), device=dev), cell4, off_v, "set")
    jmask = heat > 0.5

    seg4 = scene.segments / 4.0
    ctr = 0.5 * (seg4[..., 0:2] + seg4[..., 2:4])
    sm = scene.segment_mask
    scx = torch.where(sm, _cells(ctr[..., 0], GRID4), GRID4 - 1)
    scy = torch.where(sm, _cells(ctr[..., 1], GRID4), GRID4 - 1)
    cell_s = scy * GRID4 + scx
    line_t = _scatter(torch.zeros((b, GRID4, GRID4, 4), device=dev), cell_s,
                      torch.where(sm[..., None], seg4, 0.0), "set")
    line_m = _scatter(zeros, cell_s, sm.float(), "amax") > 0.5
    return Targets(kp_label, heat, off, jmask, line_t, line_m)


def _bce(prob, target, pos_weight=1.0, eps=1e-6):
    prob = torch.clamp(prob, eps, 1 - eps)
    return -(pos_weight * target * torch.log(prob) + (1 - target) * torch.log(1 - prob))


def loi_draws(gen: torch.Generator, batch: int, n_corners: int = synthgen.MAX_CORNERS):
    """The random tensors of :func:`detector_loss`'s LOI branch: the jitter
    of the true segments, the decoys' corner indices and the proposals'
    jitter (train_plnet.py:135-182)."""
    s, n = synthgen.MAX_SEGMENTS, 2 * NEG_PAIRS

    def u(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo

    return {"pos_jitter": u((batch, s, 4), -0.4, 0.4),
            "i": torch.randint(0, n_corners, (batch, n), generator=gen, device=gen.device),
            "j": torch.randint(0, n_corners, (batch, n), generator=gen, device=gen.device),
            "prop_jitter": u((batch, s + n, 4), -2.0, 2.0)}


def _seg_pt_dist(p, g):
    """Distance of points p (..., 2) to segments g (..., 4)."""
    a, b = g[..., 0:2], g[..., 2:4]
    d = b - a
    L2 = torch.clamp_min(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1], 1e-6)
    pa = p - a
    t = torch.clamp((pa[..., 0] * d[..., 0] + pa[..., 1] * d[..., 1]) / L2, 0.0, 1.0)
    q = p - (a + t[..., None] * d)
    return torch.sqrt(q[..., 0] ** 2 + q[..., 1] ** 2)


def loi_candidates(scene: synthgen.Scene, draws):
    """The LOI head's training candidates (train_plnet.py:134-182): every
    true segment jittered by ±0.4 cells and random corner pairs, labelled
    positive iff both endpoints lie on one segment (within 1 cell), the band
    between 1 and 2.5 cells left out; the proposals jittered by ±2 cells.
    Returns (cands, props (B, L, 4), labels, valid (B, L)) in 128-grid
    coordinates."""
    seg4 = scene.segments / 4.0
    pos = seg4 + draws["pos_jitter"]
    c4 = scene.corners / 4.0
    i, j = draws["i"], draws["j"]
    ci = torch.gather(c4, 1, i[..., None].expand(-1, -1, 2))
    cj = torch.gather(c4, 1, j[..., None].expand(-1, -1, 2))
    dc = ci - cj
    cm = scene.corner_mask
    rand_valid = (torch.gather(cm, 1, i) & torch.gather(cm, 1, j) & (i != j)
                  & (torch.sqrt(dc[..., 0] ** 2 + dc[..., 1] ** 2) > 4.0))
    cands = torch.cat([pos, torch.cat([ci, cj], dim=-1)], dim=1)
    valid = torch.cat([scene.segment_mask, rand_valid], dim=1)
    # lying-on label: both endpoints on the SAME segment
    c_ = cands[:, :, None, :]
    g_ = seg4[:, None, :, :]
    dmat = torch.maximum(_seg_pt_dist(c_[..., 0:2], g_), _seg_pt_dist(c_[..., 2:4], g_))
    dmat = torch.where(scene.segment_mask[:, None, :], dmat, 1e9)
    dmin = dmat.min(dim=-1).values
    labels = (dmin < 1.0).float()
    valid = valid & ((dmin < 1.0) | (dmin > 2.5))
    return cands, cands + draws["prop_jitter"], labels, valid


def detector_loss(out, tgt: Targets, scene: synthgen.Scene = None, loi=None,
                  draws=None) -> Dict[str, torch.Tensor]:
    """Per-image loss terms, each (B,), from stage-0 outputs and targets
    (train_plnet.py:98). With ``loi`` (a :class:`LoiHeadS1`) and its
    ``draws``, the LOI head's BCE on the scene's candidates."""
    losses = {}
    ce = F.cross_entropy(out["kp_logits"].permute(0, 3, 1, 2), tgt.kp_label, reduction="none")
    losses["kp"] = ce.mean(dim=(1, 2))

    npos = torch.clamp_min(tgt.junc_heat.sum(dim=(1, 2)), 1.0)
    pw = (GRID4 * GRID4 - npos) / npos
    bce = _bce(out["junc_heat"], tgt.junc_heat, pw[:, None, None])
    losses["junc"] = bce.mean(dim=(1, 2)) / (1 + pw) * 2
    off_l1 = torch.abs(out["junc_offset"] - tgt.junc_off).sum(-1)
    losses["junc_off"] = (off_l1 * tgt.junc_mask).sum(dim=(1, 2)) / npos

    pred, logit = out["line_pred"], out["line_logit"]  # (B, 128, 128, 3, 4), (B, 128, 128, 3)
    err = torch.abs(pred - tgt.line_target[..., None, :]).sum(-1)
    best = torch.argmin(err, dim=-1)
    best_err = torch.gather(err, -1, best[..., None])[..., 0]
    lm = tgt.line_mask
    nctr = torch.clamp_min(lm.sum(dim=(1, 2)).float(), 1.0)
    losses["line_reg"] = (best_err * lm).sum(dim=(1, 2)) / nctr
    logit_t = F.one_hot(best, 3).float() * lm[..., None]
    lw = torch.where(lm[..., None], 60.0, 1.0)
    losses["line_logit"] = (F.binary_cross_entropy_with_logits(logit, logit_t, reduction="none")
                            * lw).mean(dim=(1, 2, 3))

    if loi is not None:
        cands, props, labels, valid = loi_candidates(scene, draws)
        score, _ = loi(cands, props, out["loi"], out["loi_thin"], out["loi_aux"])
        bce = _bce(score, labels)
        losses["loi"] = (bce * valid).sum(1) / torch.clamp_min(valid.sum(1).float(), 1.0)
    return losses


def corner_descriptors(desc: torch.Tensor, corners: torch.Tensor) -> torch.Tensor:
    """``sample_descriptors`` of (B, 64, 64, 256) HWC stride-8 maps at
    (B, N, 2) corners, image by image. Returns (B, N, 256)."""
    return torch.stack([sample_descriptors(d.permute(2, 0, 1), c, stride=8)
                        for d, c in zip(desc, corners)])


def descriptor_loss(desc0, desc1, s0: synthgen.Scene, s1: synthgen.Scene,
                    tau: float = 0.1) -> torch.Tensor:
    """InfoNCE over the exact corner correspondences of an affine pair
    (train_plnet.py:192), per image (B,)."""
    d0 = corner_descriptors(desc0, s0.corners)
    d1 = corner_descriptors(desc1, s1.corners)
    m = s0.corner_mask & s1.corner_mask
    b, n = m.shape
    logits = (d0 @ d1.transpose(1, 2)) / tau
    neg = torch.tensor(-1e9, dtype=logits.dtype, device=logits.device)
    logits = torch.where(m[:, None, :], logits, neg)
    labels = torch.arange(n, device=m.device).expand(b, n)
    ce_r = F.cross_entropy(logits.transpose(1, 2), labels, reduction="none")
    ce_c = F.cross_entropy(torch.where(m[:, :, None], logits, neg), labels, reduction="none")
    cnt = torch.clamp_min(m.sum(1).float(), 1.0)
    return ((ce_r + ce_c) * 0.5 * m).sum(1) / cnt


def _mean_terms(total, terms, per_image: bool = False):
    if per_image:
        return total, terms
    return total.mean(), {k: v.mean() for k, v in terms.items()}


def plnet_loss(plnet, loi, s0: synthgen.Scene, s1: synthgen.Scene, draws,
               per_image: bool = False):
    """Mean loss and mean terms of PLNet stage 0 and the LOI head on scenes
    ``s0`` (and the pair's ``s1`` for the descriptor term; None without).
    ``per_image``: the (B,) loss and terms instead of their means."""
    b = s0.image.shape[0]
    imgs = s0.image if s1 is None else torch.cat([s0.image, s1.image])
    out = plnet(imgs[:, None])
    out0 = {k: v[:b] for k, v in out.items()}
    terms = detector_loss(out0, scene_targets(s0), s0, loi, draws)
    if s1 is not None:
        terms["desc"] = descriptor_loss(out["descriptors"][:b], out["descriptors"][b:], s0, s1)
    total = sum(WEIGHTS[k] * v for k, v in terms.items())
    return _mean_terms(total, terms, per_image)


def _kp_ce(logits, labels):
    return F.cross_entropy(logits.permute(0, 3, 1, 2), labels, reduction="none").mean(dim=(1, 2))


def superpoint_loss(sp, s0: synthgen.Scene, s1: synthgen.Scene, per_image: bool = False):
    """SuperPoint: keypoint CE on view 0 and descriptor InfoNCE on the pair
    (train_plnet.py:314-325). ``per_image`` as :func:`plnet_loss`'s."""
    b = s0.image.shape[0]
    out = sp(torch.cat([s0.image, s1.image])[:, None])
    ce = _kp_ce(out["kp_logits"][:b], scene_targets(s0).kp_label)
    dl = descriptor_loss(out["descriptors"][:b], out["descriptors"][b:], s0, s1)
    return _mean_terms(ce + dl, {"kp": ce, "desc": dl}, per_image)


def superpoint_distill_loss(sp, plnet, s0: synthgen.Scene, s1: synthgen.Scene,
                            per_image: bool = False):
    """SuperPoint with its descriptors regressed (cosine) onto the frozen
    PLNet's at the ground-truth corners, plus keypoint CE
    (train_plnet.py:267-297). ``per_image`` as :func:`plnet_loss`'s."""
    b = s0.image.shape[0]
    imgs = torch.cat([s0.image, s1.image])[:, None]
    out = sp(imgs)
    ce = _kp_ce(out["kp_logits"][:b], scene_targets(s0).kp_label)
    with torch.no_grad():
        pl = plnet(imgs)["descriptors"]
    dist = 0.0
    for v, s in ((0, s0), (1, s1)):
        dsp = corner_descriptors(out["descriptors"][v * b:(v + 1) * b], s.corners)
        dpl = corner_descriptors(pl[v * b:(v + 1) * b], s.corners)
        cos = torch.sum(dsp * dpl, dim=-1)
        m = s.corner_mask
        dist = dist + torch.where(m, 1.0 - cos, 0.0).sum(1) / torch.clamp_min(m.sum(1).float(),
                                                                            1.0)
    dist = dist * 0.5
    return _mean_terms(ce + 4.0 * dist, {"kp": ce, "distill": dist}, per_image)


# ---------------------------------------------------------------------------
# optimizer and initialisation
# ---------------------------------------------------------------------------


class ClippedAdam:
    """``optax.chain(clip_by_global_norm(max_norm), adam(lr))``: the global
    norm over every gradient, ``g`` kept where it is below ``max_norm``,
    else ``(g / norm) · max_norm`` (optax's formula, not
    ``clip_grad_norm_``'s), then ``torch.optim.Adam`` with betas (0.9,
    0.999) and eps 1e-8."""

    def __init__(self, params, lr: float = 3e-4, max_norm: float = 5.0):
        self.params = [p for p in params if p.requires_grad]
        self.max_norm = max_norm
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def clip(self) -> torch.Tensor:
        """Clip the gradients in place; returns their global norm before."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < self.max_norm
        for g in grads:
            g.copy_(torch.where(keep, g, (g / norm) * self.max_norm))
        return norm

    def update(self, loss: torch.Tensor) -> torch.Tensor:
        """Backward of ``loss``, clip, one Adam step. Returns the norm."""
        self.adam.zero_grad(set_to_none=True)
        loss.backward()
        return self.step([p.grad for p in self.params])

    def step(self, grads) -> torch.Tensor:
        """Clip ``grads`` (one per parameter, None where none flowed), one
        Adam step. Returns the norm."""
        for p, g in zip(self.params, grads):
            p.grad = g
        norm = self.clip()
        self.adam.step()
        return norm


LECUN_TRUNCATION = 0.87962566103423978  # stddev of a unit normal truncated at ±2


def flax_init_(module: nn.Module, generator: torch.Generator = None) -> nn.Module:
    """flax's default initialisers on every conv, dense and LayerNorm layer:
    kernels ``lecun_normal`` (a normal truncated at ±2 standard deviations,
    variance 1 / fan_in), biases zero (where the layer has one), LayerNorm
    scale 1 and bias 0. Bits cannot match ``jax.random``; the distributions
    do."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / LECUN_TRUNCATION
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
    return module


# ---------------------------------------------------------------------------
# train steps (train_plnet.py:217-339)
# ---------------------------------------------------------------------------


def _step(opt: ClippedAdam, loss, terms):
    opt.update(loss)
    return loss.detach(), {k: v.detach() for k, v in terms.items()}


def _train_step(opt: ClippedAdam, mesh, modules, draw, loss_fn):
    """``train_step(gen, batch) -> (loss, terms)``: ``draw(gen, batch)``
    makes the step's inputs (its draws and the scenes rendered from them, on
    ``gen``'s device), ``loss_fn(modules, inputs)`` the per-image (loss,
    terms), and one clipped Adam update follows. Without a mesh of dp > 1,
    one device's step on the means. Over dp (JAX ``apps/train_plnet.py:97-115``'s
    ``dp`` mesh) the same inputs, bit for bit, are split over the dp devices
    (``mesh.dp_gradients``), the update runs on the primary device and the
    replicas are refreshed."""

    def train_step(gen: torch.Generator, batch: int):
        inputs = draw(gen, batch)
        if mesh is None or mesh.shape["dp"] == 1:
            return _step(opt, *_mean_terms(*loss_fn(modules, inputs)))
        loss, terms, grads = dp_gradients(mesh, modules, opt.params, inputs, batch, loss_fn)
        opt.step(grads)
        refresh_replicas(mesh, modules, opt.params)
        return loss, terms

    return train_step


def make_plnet_train_step(plnet, loi, opt: ClippedAdam, with_desc: bool = True,
                          augment: float = 1.0, mesh=None):
    """Returns ``train_step(gen, batch) -> (loss, terms)``: scenes (pairs
    with descriptors) rendered on ``gen``'s device, the loss, and one
    clipped Adam update of PLNet and the LOI head. ``augment`` is the
    photometric augmentation strength, independent per view (0 disables).
    ``mesh`` (``parallel/mesh.py``): data-parallel over its dp devices
    (:func:`_train_step`); with dp = 1 or None, one device's step."""

    def draw(gen, batch):
        if with_desc:
            s0, s1 = synthgen.render_pair(synthgen.pair_draws(gen, batch, augment=augment),
                                          augment=augment)
        else:
            s0 = synthgen.render_scene(synthgen.scene_draws(gen, batch, augment=augment),
                                       augment=augment)
            s1 = None
        return s0, s1, loi_draws(gen, batch)

    def loss_fn(modules, inputs):
        return plnet_loss(*modules, *inputs, per_image=True)

    return _train_step(opt, mesh, (plnet, loi), draw, loss_fn)


def _pair_scenes(augment: float):
    """``draw`` of the SuperPoint steps: an affine pair's two scenes."""
    return lambda gen, batch: synthgen.render_pair(
        synthgen.pair_draws(gen, batch, augment=augment), augment=augment)


def make_superpoint_distill_step(sp, opt: ClippedAdam, plnet, augment: float = 1.0,
                                 mesh=None):
    """Returns ``train_step(gen, batch)`` of SuperPoint distilled onto the
    frozen ``plnet``'s descriptors. ``mesh`` as in
    :func:`make_plnet_train_step`."""

    def loss_fn(modules, scenes):
        return superpoint_distill_loss(*modules, *scenes, per_image=True)

    return _train_step(opt, mesh, (sp, plnet), _pair_scenes(augment), loss_fn)


def make_superpoint_train_step(sp, opt: ClippedAdam, augment: float = 1.0, mesh=None):
    """Returns ``train_step(gen, batch)`` of SuperPoint: keypoint CE and
    descriptor InfoNCE on affine pairs. ``mesh`` as in
    :func:`make_plnet_train_step`."""

    def loss_fn(modules, scenes):
        return superpoint_loss(*modules, *scenes, per_image=True)

    return _train_step(opt, mesh, (sp,), _pair_scenes(augment), loss_fn)
