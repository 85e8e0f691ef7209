"""Matcher training: LightGlue and SuperGlue on permuted descriptor clouds,
on rendered affine pairs' corners, and on the frozen detector's keypoints.

Port of ``airslam_tpu/parallel/training.py``. Three objectives:

- the permutation trainer: a descriptor cloud re-observed under a known
  permutation plus noise; the matcher maximises the log-assignment of the
  true correspondences;
- the rendered-corner trainer: affine pairs rendered by
  :mod:`airslam_tpu_torch.frontend.synthgen`, described by the frozen PLNet
  at the exact corners (jittered ±1 px); matched corners maximise their
  log-assignment, corners seen in one view their unmatchability. SuperGlue
  trains on the same pairs through its Sinkhorn plan (``return_full``):
  single-view corners maximise their dustbin entry;
- the detector-in-the-loop trainer: the tokens are the frozen PLNet's top-k
  keypoints; mutual nearest neighbours of view 0's detections warped by the
  true affine (within ``MATCH_PX``) are the targets, detections farther than
  ``2·MATCH_PX`` from any cross-view detection the negatives.

The JAX trainer takes the mean over a ``vmap`` of per-pair losses; here the
pairs run through the networks as one batch and the same means are taken.
Every random draw is an explicit tensor from a ``torch.Generator`` (one draw
function per random stage: :func:`perm_draws`, :func:`jitter_draws` and
``synthgen.pair_draws``), so a test can hand both packages the same draws.
PLNet is frozen: the batches are built under ``torch.no_grad`` (the JAX loss
closes over its parameters). The optimizer is ``optax.adam(lr)`` with no
clipping, which is ``torch.optim.Adam``'s arithmetic (:func:`adam`); fresh
matchers get flax's initialisers (:func:`init_train_state`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from airslam_tpu_torch.frontend import synthgen
from airslam_tpu_torch.models.lightglue import normalize_keypoints
from airslam_tpu_torch.models.superglue import SG_SINKHORN_ITERS  # noqa: F401 (re-export)
from airslam_tpu_torch.models.superglue import SuperGlue
from airslam_tpu_torch.ops.detect import topk_keypoints
from airslam_tpu_torch.parallel.mesh import (dp_gradients, refresh_replicas,
                                             shard_lightglue_params, trainable)
from airslam_tpu_torch.parallel.train_plnet import corner_descriptors, flax_init_

K_TOKENS = 256  # detected keypoints per view
MATCH_PX = 3.0  # a detected pair within it is a target; none within twice it, a negative
NORM_SCALE = {False: 0.5, True: 0.7}  # NormalizeKeypoints' scale: LightGlue, SuperGlue


class TrainState(NamedTuple):
    """The JAX ``TrainState`` in PyTorch: the module holds the parameters,
    the optimizer the Adam moments and the step count."""

    model: nn.Module
    opt: torch.optim.Optimizer


def adam(params, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``: betas (0.9, 0.999), eps 1e-8 outside the square
    root, no clipping."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def init_train_state(model: nn.Module, lr: float = 1e-4, seed: int = 0) -> TrainState:
    """flax's initialisers on a fresh LightGlue (``lecun_normal`` kernels,
    zero biases, LayerNorm scale 1 and bias 0; the generator seeded with
    ``seed``) and its Adam."""
    flax_init_(model, torch.Generator().manual_seed(seed))
    return TrainState(model, adam(model.parameters(), lr))


def init_train_state_sg(model: SuperGlue, lr: float = 1e-4, seed: int = 0) -> TrainState:
    """As :func:`init_train_state`, with SuperGlue's ``bin_score`` 1
    (superglue.py:106)."""
    state = init_train_state(model, lr, seed)
    with torch.no_grad():
        model.bin_score.fill_(1.0)
    return state


def _update(state: TrainState, loss: torch.Tensor) -> torch.Tensor:
    state.opt.zero_grad(set_to_none=True)
    loss.backward()
    state.opt.step()
    return loss.detach()


def _where_mean(mask, v):
    """``sum(where(mask, v, 0)) / max(sum(mask), 1)`` over the last axis."""
    return (torch.where(mask, v, torch.zeros_like(v)).sum(-1)
            / torch.clamp_min(mask.sum(-1).to(v.dtype), 1.0))


# ---------------------------------------------------------------------------
# the permutation trainer (training.py:28-86)
# ---------------------------------------------------------------------------


def perm_draws(gen: torch.Generator, batch: int, n: int, dim: int = 256):
    """The random tensors of :func:`make_batch`: keypoints in [-0.5, 0.5),
    normal descriptors, a uniform permutation per pair and the noise."""
    def rand(*shape):
        return torch.rand(shape, generator=gen, device=gen.device)

    return {"kpts0": rand(batch, n, 2) - 0.5,
            "desc0": torch.randn((batch, n, dim), generator=gen, device=gen.device),
            "perm": torch.argsort(rand(batch, n), dim=-1),
            "noise": torch.randn((batch, n, dim), generator=gen, device=gen.device)}


def _unit(x):
    return x / torch.linalg.norm(x, dim=-1, keepdim=True)


def _take(x, idx):
    """``take_along_axis(x, idx[..., None], axis=1)`` for (B, N, C) ``x``."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def make_batch(d, noise: float = 0.05):
    """Synthetic supervision: (kpts0, desc0, kpts1, desc1, perm) with unit
    descriptors; view 1 is view 0 permuted, its descriptors perturbed."""
    kpts0, perm = d["kpts0"], d["perm"]
    desc0 = _unit(d["desc0"])
    desc1 = _unit(_take(desc0, perm) + noise * d["noise"])
    return kpts0, desc0, _take(kpts0, perm), desc1, perm


def match_loss(model, kpts0, desc0, kpts1, desc1, perm, per_pair: bool = False):
    """−mean log-assignment of the true correspondences, the mean over the
    batch of each pair's mean (``per_pair``: the (B,) pair means)."""
    mask = torch.ones(kpts0.shape[:-1], dtype=torch.bool, device=kpts0.device)
    scores, _, _ = model(kpts0, desc0, mask, kpts1, desc1, mask)
    true = torch.gather(scores, -1, perm[..., None])[..., 0]
    loss = -true.mean(-1)
    return loss if per_pair else loss.mean()


def make_train_step(state: TrainState, mesh=None):
    """Returns ``train_step(batch) -> loss``: the loss of a
    :func:`make_batch` batch and one Adam update. ``mesh``
    (``parallel/mesh.py``, JAX ``dryrun_multichip`` step (e)): the batch
    split over dp (``mesh.dp_gradients``, one replica of the model per dp
    device, the gradients summed on the primary) and each attention block's
    heads over tp (``mesh.shard_lightglue_params``)."""
    if mesh is None or mesh.size == 1:
        def train_step(batch):
            return _update(state, match_loss(state.model, *batch))

        return train_step

    shard_lightglue_params(state.model, mesh)
    modules = (state.model,)
    params = trainable(modules)

    def loss_fn(reps, shard):
        return match_loss(reps[0], *shard, per_pair=True), {}

    def train_step(batch):
        loss, _, grads = dp_gradients(mesh, modules, params, tuple(batch),
                                      batch[0].shape[0], loss_fn)
        for p, g in zip(params, grads):
            p.grad = g
        state.opt.step()
        refresh_replicas(mesh, modules, params)
        return loss

    return train_step


# ---------------------------------------------------------------------------
# the rendered-corner trainer (training.py:93-176)
# ---------------------------------------------------------------------------


def _heat_at(heat: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Nearest-pixel heatmap values of (B, H, W) maps at (B, N, 2) points,
    rounded half to even as ``jnp.round``: the detector's per-keypoint score
    at training time."""
    b, h, w = heat.shape
    x = torch.clamp(torch.round(pts[..., 0]).to(torch.int64), 0, w - 1)
    y = torch.clamp(torch.round(pts[..., 1]).to(torch.int64), 0, h - 1)
    return torch.gather(heat.reshape(b, -1), 1, y * w + x)


def _describe(plnet, s0: synthgen.Scene, s1: synthgen.Scene):
    """PLNet on both views of B pairs as one batch of 2B images: heatmaps
    (2B, H, W) and descriptor maps (2B, H/8, W/8, 256), view 0 first."""
    out = plnet(torch.cat([s0.image, s1.image])[:, None])
    return out["scores"], out["descriptors"]


def jitter_draws(gen: torch.Generator, batch: int):
    """The random tensor of :func:`make_rendered_batch`: each view's ±1 px
    jitter of the sampling locations, (B, 2, MAX_CORNERS, 2)."""
    u = torch.rand((batch, 2, synthgen.MAX_CORNERS, 2), generator=gen, device=gen.device)
    return torch.clamp_min(u * 2.0 - 1.0, -1.0)


def rendered_draws(gen: torch.Generator, batch: int, augment: float = 1.0):
    """The draws of one :func:`make_rendered_batch`: the pair, then the
    jitter."""
    return {"pair": synthgen.pair_draws(gen, batch, augment=augment),
            "jitter": jitter_draws(gen, batch)}


def _normalize(xy, size, superglue):
    return normalize_keypoints(xy, size, size, NORM_SCALE[superglue])


@torch.no_grad()
def rendered_batch(plnet, s0: synthgen.Scene, s1: synthgen.Scene, jitter: torch.Tensor,
                   superglue: bool = False):
    """The batch of rendered pairs (training.py:106-138): (k0, d0, m0, k1,
    d1, m1, both, only0, only1), each with a leading B; the token count is
    the static corner budget. For SuperGlue (``superglue``) the keypoints
    are normalised at scale 0.7 instead of 0.5, and each view's heatmap
    scores follow its keypoints (its keypoint encoder reads them)."""
    b, size = s0.image.shape[0], s0.image.shape[-1]
    heat, desc = _describe(plnet, s0, s1)
    c0 = s0.corners + jitter[:, 0]
    c1 = s1.corners + jitter[:, 1]
    d0 = corner_descriptors(desc[:b], c0)
    d1 = corner_descriptors(desc[b:], c1)
    m0, m1 = s0.corner_mask, s1.corner_mask
    k0, k1 = _normalize(c0, size, superglue), _normalize(c1, size, superglue)
    tail = (m0 & m1, m0 & ~m1, m1 & ~m0)
    if superglue:
        return (k0, _heat_at(heat[:b], c0), d0, m0, k1, _heat_at(heat[b:], c1), d1, m1) + tail
    return (k0, d0, m0, k1, d1, m1) + tail


def make_rendered_batch(plnet, draws, superglue: bool = False, augment: float = 1.0):
    """:func:`rendered_batch` of the pairs rendered from ``draws``
    (:func:`rendered_draws`)."""
    s0, s1 = synthgen.render_pair(draws["pair"], augment=augment)
    return rendered_batch(plnet, s0, s1, draws["jitter"], superglue)


def rendered_match_loss(model, batch):
    """Matched corners' diagonal log-assignment, single-view corners'
    log-sigmoid unmatchability; the mean over the batch."""
    k0, d0, m0, k1, d1, m1, both, only0, only1 = batch
    scores, z0, z1 = model(k0, d0, m0, k1, d1, m1)
    l_match = -_where_mean(both, torch.diagonal(scores, dim1=-2, dim2=-1))
    l_un0 = -_where_mean(only0, F.logsigmoid(-z0))
    l_un1 = -_where_mean(only1, F.logsigmoid(-z1))
    return (l_match + 0.5 * (l_un0 + l_un1)).mean()


def make_rendered_train_step(state: TrainState, plnet, augment: float = 1.0):
    """Returns ``train_step(gen, batch) -> loss``: ``batch`` pairs rendered
    on ``gen``'s device, the LightGlue loss and one Adam update."""
    def train_step(gen: torch.Generator, batch: int):
        data = make_rendered_batch(plnet, rendered_draws(gen, batch, augment), augment=augment)
        return _update(state, rendered_match_loss(state.model, data))

    return train_step


# ---------------------------------------------------------------------------
# SuperGlue on the same rendered pairs, through its Sinkhorn plan
# (training.py:179-233)
# ---------------------------------------------------------------------------


def _plan_loss(z, l_match, un0, un1):
    """``l_match + 0.5·(l_un0 + l_un1)`` with the unmatched terms on the
    dustbin column and row of the (B, N+1, N+1) plan ``z``."""
    l_un0 = -_where_mean(un0, z[..., :-1, -1])
    l_un1 = -_where_mean(un1, z[..., -1, :-1])
    return (l_match + 0.5 * (l_un0 + l_un1)).mean()


def rendered_match_loss_sg(model: SuperGlue, batch):
    """Full-plan supervision: matched corners maximise their diagonal
    transport log-probability, single-view corners their dustbin entry."""
    k0, s0, d0, m0, k1, s1, d1, m1, both, only0, only1 = batch
    z = model(k0, s0, d0, m0, k1, s1, d1, m1)
    l_match = -_where_mean(both, torch.diagonal(z[..., :-1, :-1], dim1=-2, dim2=-1))
    return _plan_loss(z, l_match, only0, only1)


def make_rendered_train_step_sg(state: TrainState, plnet, augment: float = 1.0):
    """As :func:`make_rendered_train_step` for SuperGlue (``return_full``):
    keypoints normalised at scale 0.7, with heatmap scores."""
    def train_step(gen: torch.Generator, batch: int):
        data = make_rendered_batch(plnet, rendered_draws(gen, batch, augment), superglue=True,
                                   augment=augment)
        return _update(state, rendered_match_loss_sg(state.model, data))

    return train_step


# ---------------------------------------------------------------------------
# detector-in-the-loop training (training.py:238-338)
# ---------------------------------------------------------------------------


@torch.no_grad()
def detected_batch(plnet, s0: synthgen.Scene, s1: synthgen.Scene, A: torch.Tensor,
                   t: torch.Tensor, superglue: bool = False):
    """The batch of the frozen detector's top-``K_TOKENS`` keypoints on B
    pairs related by the affines (A, t) (training.py:247-297): (k0, [s0,]
    d0, m0, k1, [s1,] d1, m1, tgt, neg0, neg1), the scores and scale as in
    :func:`rendered_batch`. ``tgt[i]`` is view 1's matching token of view
    0's token i or −1; ``neg0``/``neg1`` flag tokens with no cross-view
    detection within ``2·MATCH_PX`` (the grey zone between, typically
    duplicate detections of a matched corner, is left out)."""
    b, size = s0.image.shape[0], s0.image.shape[-1]
    heat, desc = _describe(plnet, s0, s1)
    kps = [topk_keypoints(h, 0.004, 4, K_TOKENS) for h in heat]
    xy, score, mask = (torch.stack([getattr(k, f) for k in kps]) for f in ("xy", "score", "mask"))
    xy0, xy1, m0, m1 = xy[:b], xy[b:], mask[:b], mask[b:]
    d0 = corner_descriptors(desc[:b], xy0)
    d1 = corner_descriptors(desc[b:], xy1)

    p0w = synthgen._affine_points(xy0, A, t)  # XLA's arithmetic for p @ A.T + t
    diff = p0w[:, :, None, :] - xy1[:, None, :, :]
    d2 = diff[..., 0] ** 2 + diff[..., 1] ** 2
    d2 = torch.where(m0[:, :, None] & m1[:, None, :], d2, torch.full_like(d2, 1e12))
    j_of_i = torch.argmin(d2, dim=2)  # the first minimum, as jnp.argmin
    i_of_j = torch.argmin(d2, dim=1)
    best0 = torch.amin(d2, dim=2)
    best1 = torch.amin(d2, dim=1)
    ar = torch.arange(K_TOKENS, device=xy.device)
    mutual = torch.gather(i_of_j, 1, j_of_i) == ar
    matched = mutual & (best0 < MATCH_PX ** 2) & m0
    tgt = torch.where(matched, j_of_i, torch.full_like(j_of_i, -1))
    far2 = (2.0 * MATCH_PX) ** 2
    neg0 = m0 & (best0 > far2)
    neg1 = m1 & (best1 > far2)

    k0, k1 = _normalize(xy0, size, superglue), _normalize(xy1, size, superglue)
    if superglue:
        return k0, score[:b], d0, m0, k1, score[b:], d1, m1, tgt, neg0, neg1
    return k0, d0, m0, k1, d1, m1, tgt, neg0, neg1


def make_detected_batch(plnet, draws, superglue: bool = False, augment: float = 1.0):
    """:func:`detected_batch` of the pairs rendered from ``draws``
    (``synthgen.pair_draws``; its ``view`` sets the curriculum)."""
    s0, s1, A, t = synthgen.render_pair_with_affine(draws, augment=augment)
    return detected_batch(plnet, s0, s1, A, t, superglue)


def _target_scores(scores, tgt):
    return torch.gather(scores, -1, torch.clamp_min(tgt, 0)[..., None])[..., 0]


def detected_match_loss(model, batch):
    """Targets' log-assignment, negatives' log-sigmoid unmatchability."""
    k0, d0, m0, k1, d1, m1, tgt, neg0, neg1 = batch
    scores, z0, z1 = model(k0, d0, m0, k1, d1, m1)
    l_match = -_where_mean(tgt >= 0, _target_scores(scores, tgt))
    l0 = -_where_mean(neg0, F.logsigmoid(-z0))
    l1 = -_where_mean(neg1, F.logsigmoid(-z1))
    return (l_match + 0.5 * (l0 + l1)).mean()


def detected_match_loss_sg(model: SuperGlue, batch):
    """Targets' transport log-probability, negatives' dustbin entries."""
    k0, s0, d0, m0, k1, s1, d1, m1, tgt, neg0, neg1 = batch
    z = model(k0, s0, d0, m0, k1, s1, d1, m1)
    l_match = -_where_mean(tgt >= 0, _target_scores(z[..., :-1, :-1], tgt))
    return _plan_loss(z, l_match, neg0, neg1)


def make_detected_train_step(state: TrainState, plnet, augment: float = 1.0,
                             view: float = 1.0):
    """Returns ``train_step(gen, batch) -> loss`` on the detector's
    keypoints; the affine strength of each pair is drawn in [1, ``view``].
    SuperGlue (a :class:`SuperGlue` model) gets scale-0.7 keypoints with
    scores and the plan's loss."""
    superglue = isinstance(state.model, SuperGlue)
    loss = detected_match_loss_sg if superglue else detected_match_loss

    def train_step(gen: torch.Generator, batch: int):
        data = make_detected_batch(
            plnet, synthgen.pair_draws(gen, batch, augment=augment, view=view), superglue,
            augment)
        return _update(state, loss(state.model, data))

    return train_step
