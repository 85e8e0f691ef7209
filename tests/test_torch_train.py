"""The port's detector trainer (``airslam_tpu_torch/parallel/train_plnet.py``,
``apps/train_plnet_torch.py``) against the JAX one, on the CPU in float32.

JAX runs as its trainer does (float32, no x64); its random draws are rebuilt
from the same keys (``scripts/make_torch_oracle.py``'s ``jax_*_draws``) and
handed to the port. Gates: targets exact (offsets ≤ 1e-6 on cells written
once); loss terms ≤ 1e-5 relative on seeded network outputs; the LOI head's
endpoint path and its gradients (maps, ramps, dense weights) ≤ 1e-5 of each
leaf's largest value against ``jax.grad``; one clipped-Adam step ≤ 1e-7
against optax; whole train steps from the shipped checkpoints at 512²,
batch 1: loss terms ≤ 1e-4 relative and every gradient ≤ 1e-4 relative L2;
flax's initialisers' per-layer standard deviation within 5 %; the CLI's
checkpoints load bit-exactly in the JAX package.
"""

import importlib.util
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from airslam_tpu.frontend import synthgen as JS
from airslam_tpu.models import plnet as jplnet
from airslam_tpu.models import weights as jw
from airslam_tpu.models.superpoint import SuperPoint as JSuperPoint
from airslam_tpu.parallel import train_plnet as jtp
from airslam_tpu_torch.frontend import synthgen as TS
from airslam_tpu_torch.models import weights as wio
from airslam_tpu_torch.models.plnet import LoiHeadS1, PLNet
from airslam_tpu_torch.models.superpoint import SuperPoint
from airslam_tpu_torch.ops import bilerp
from airslam_tpu_torch.parallel import train_plnet as tp

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CKPT = os.path.join(REPO, "airslam_tpu", "checkpoints")


def _oracle_script():
    spec = importlib.util.spec_from_file_location(
        "make_torch_oracle", os.path.join(REPO, "scripts", "make_torch_oracle.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MTO = _oracle_script()


@pytest.fixture(autouse=True)
def _jax_f32():
    with jax.enable_x64(False):  # the trainer's precision; conftest turns x64 on
        yield


def _t(a, batch=True):
    """numpy/JAX → torch (a copy), int32 → int64, with a batch of one."""
    if isinstance(a, dict):
        return {k: _t(v, batch) for k, v in a.items()}
    a = np.array(a)
    t = torch.as_tensor(a.astype(np.int64) if a.dtype == np.int32 else a)
    return t[None] if batch else t


def _scene(s):
    return TS.Scene(*(_t(getattr(s, f)) for f in TS.Scene._fields))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return np.linalg.norm(got - want) / den if den > 0 else np.linalg.norm(got)


@pytest.fixture(scope="module")
def shipped():
    return {"s0": jw.load_params(os.path.join(JAX_CKPT, "plnet_s0.npz")),
            "sp": jw.load_params(os.path.join(JAX_CKPT, "superpoint.npz"))}


# ---------------------------------------------------------------------------
# targets and losses
# ---------------------------------------------------------------------------


def _hits(cells, g):
    return np.bincount(cells.reshape(-1), minlength=g * g).reshape(g, g)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scene_targets(seed):
    """Labels, heatmap and masks exact; offsets and line targets ≤ 1e-6 on
    the cells written once (``.at[].set`` keeps no defined winner where
    writes collide: those cells are counted and left out)."""
    with jax.enable_x64(False):
        s = JS.render_scene(jax.random.PRNGKey(seed), augment=1.0)
        want = jtp.scene_targets(s)
    got = tp.scene_targets(_scene(s))
    for f in ("kp_label", "junc_heat", "junc_mask", "line_mask"):
        np.testing.assert_array_equal(getattr(got, f)[0].numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    c, cm = np.asarray(s.corners), np.asarray(s.corner_mask)
    jc = np.where(cm[:, None], np.clip((c / 4.0).astype(np.int32), 0, 127), 127)
    seg4 = np.asarray(s.segments) / 4.0
    ctr = 0.5 * (seg4[:, 0:2] + seg4[:, 2:4])
    sm = np.asarray(s.segment_mask)
    sc = np.where(sm[:, None], np.clip(ctr.astype(np.int32), 0, 127), 127)
    collided = 0
    for f, cells in (("junc_off", jc), ("line_target", sc)):
        hits = _hits(cells[:, 1] * 128 + cells[:, 0], 128)
        once = hits == 1
        collided += int((hits > 1).sum())
        a, b = getattr(got, f)[0].numpy(), np.asarray(getattr(want, f))
        np.testing.assert_allclose(a[once], b[once], rtol=0, atol=1e-6, err_msg=f)
        np.testing.assert_array_equal(a[hits == 0], 0.0)
        assert once.sum() > 0
    assert collided >= 1  # the dummy cell of the invalid entries, at least


def _plnet_outputs(rng, b):
    """Seeded stage-0 outputs at the real grids (numpy, NHWC)."""
    cy, cx = np.meshgrid(np.arange(128) + 0.5, np.arange(128) + 0.5, indexing="ij")
    center = np.stack([cx, cy, cx, cy], -1)[:, :, None, :]
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
    f = np.float32
    return [{"kp_logits": (rng.randn(64, 64, 65) * 2).astype(f),
             "junc_heat": sig(rng.randn(128, 128) * 3).astype(f),
             "junc_offset": sig(rng.randn(128, 128, 2)).astype(f),
             "line_pred": (center + rng.randn(128, 128, 3, 4) * 8).astype(f),
             "line_logit": rng.randn(128, 128, 3).astype(f),
             "loi": rng.randn(128, 128, 128).astype(f),
             "loi_thin": rng.randn(128, 128, 4).astype(f),
             "loi_aux": rng.randn(128, 128, 4).astype(f)} for _ in range(b)]


def _stack(dicts):
    return {k: torch.as_tensor(np.stack([d[k] for d in dicts])) for k in dicts[0]}


def _stack_scenes(scenes):
    return TS.Scene(*(torch.cat([getattr(s, f) for s in scenes]) for f in TS.Scene._fields))


@pytest.mark.parametrize("seed", [0, 1])
def test_detector_loss(seed, shipped):
    """Every term, the LOI branch included (its candidates from the rebuilt
    draws), on seeded outputs for two scenes in one batch against the JAX
    loss image by image: ≤ 1e-5 relative."""
    rng = np.random.RandomState(seed)
    keys = jax.random.split(jax.random.PRNGKey(10 + seed), 2)
    scenes, draws, want = [], [], []
    outs = _plnet_outputs(rng, 2)
    for key, out in zip(keys, outs):
        ks, kl = jax.random.split(key)
        s = JS.render_scene(ks, augment=1.0)
        want.append(jtp.detector_loss({k: jnp.asarray(v) for k, v in out.items()},
                                      jtp.scene_targets(s), kl,
                                      loi_apply=jplnet.LoiHeadS1().apply,
                                      loi_params=shipped["s0"]["loi"], scene=s))
        scenes.append(_scene(s))
        draws.append(_t(MTO.jax_loi_draws(kl)))
    scene = _stack_scenes(scenes)
    head = LoiHeadS1()
    head.load_state_dict(wio.loi_s1_from_flax(shipped["s0"]["loi"]))
    got = tp.detector_loss(_stack(outs), tp.scene_targets(scene), scene, head,
                           {k: torch.cat([d[k] for d in draws]) for k in draws[0]})
    assert set(got) == set(want[0])
    for k, v in got.items():
        for i in range(2):
            w = float(want[i][k])
            assert abs(float(v[i].detach()) - w) <= 1e-5 * abs(w), (k, i, float(v[i].detach()), w)


@pytest.mark.parametrize("seed", [0, 1])
def test_descriptor_loss(seed):
    """InfoNCE over a JAX-rendered pair's corners on seeded unit descriptor
    maps: ≤ 1e-5 relative."""
    rng = np.random.RandomState(seed)
    s0, s1 = JS.render_pair(jax.random.PRNGKey(20 + seed), augment=1.0)
    d = rng.randn(2, 64, 64, 256).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = float(jtp.descriptor_loss(jnp.asarray(d[0]), jnp.asarray(d[1]), s0, s1))
    got = tp.descriptor_loss(torch.as_tensor(d[:1]), torch.as_tensor(d[1:]), _scene(s0),
                             _scene(s1))
    assert got.shape == (1,) and abs(float(got[0]) - want) <= 1e-5 * abs(want)


# ---------------------------------------------------------------------------
# the LOI head's endpoint path and its gradients
# ---------------------------------------------------------------------------


def _loi_problem(rng, n_views=1):
    return chip_smoke.train_loi_inputs(rng, n_views, "cpu")


def test_loi_head_endpoint_path_and_gradients(shipped):
    """The head called without junctions (training's path) on 165 lines on
    and beyond the borders: scores against the JAX head's endpoint path, and
    the gradients of a weighted score sum with respect to the three maps,
    ``t_fwd``, ``t_rev`` and the dense weights against ``jax.grad``, each
    ≤ 1e-5 of the leaf's largest value; two views in one call against
    ``jax.vmap``."""
    rng = np.random.RandomState(0)
    loi, thin, aux, _, _, lines, props, _, _ = _loi_problem(rng, 2)
    w = rng.randn(2, lines.shape[1]).astype(np.float32)
    params = shipped["s0"]["loi"]
    jhead = jplnet.LoiHeadS1()

    def jloss(p, maps, v):
        score, _ = jhead.apply(p, jnp.asarray(lines[v].numpy()), jnp.asarray(props[v].numpy()),
                               *maps)
        return jnp.sum(score * w[v]), score

    head = LoiHeadS1()
    head.load_state_dict(wio.loi_s1_from_flax(params))
    maps_t = [t.clone().requires_grad_(True) for t in (loi, thin, aux)]
    score, _ = head(lines, props, *maps_t)
    (score * torch.as_tensor(w)).sum().backward()
    grads_t = {"maps": [m.grad.numpy() for m in maps_t],
               "params": wio.loi_s1_to_flax({n: p.grad for n, p in head.named_parameters()})}
    for v in range(2):
        maps = [jnp.asarray(t[v].detach().numpy()) for t in (loi, thin, aux)]
        (_, jscore), (gp, gm) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
            params, maps, v)
        np.testing.assert_allclose(score[v].detach().numpy(), np.asarray(jscore), rtol=0,
                                   atol=1e-5)
        for a, b in zip(grads_t["maps"], gm):
            a, b = a[v], np.asarray(b)
            assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
        # the dense weights and ramps accumulate over both views
        if v == 0:
            acc = jax.tree_util.tree_map(np.asarray, gp)
        else:
            acc = jax.tree_util.tree_map(lambda x, y: x + np.asarray(y), acc, gp)
    want, got = MTO.flat_tree(acc), MTO.flat_tree(grads_t["params"])
    assert want.keys() == got.keys()
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= 1e-5 * np.abs(want[k]).max(), k
    assert np.abs(want["params/t_fwd"]).max() > 0 and np.abs(want["params/t_rev"]).max() > 0


def test_loi_features_backward_plain_on_the_cpu():
    """On the CPU the backward wrapper is its plain version: autograd
    through ``loi_features_plain``, and the autograd function behind
    ``loi_features`` is not taken there."""
    ops = _loi_problem(np.random.RandomState(1), 2)
    grad = torch.randn(2, 165, 496, generator=torch.Generator().manual_seed(0))
    full = bilerp.loi_features_backward(grad, *ops)
    want = bilerp.loi_features_backward_plain(grad, *ops)
    for a, b in zip(full, want):
        assert torch.equal(a, b)
    leaves = [t.clone().requires_grad_(True) for t in (ops[0], ops[1], ops[2], ops[7], ops[8])]
    bilerp.loi_features(leaves[0], leaves[1], leaves[2], *ops[3:7], leaves[3],
                        leaves[4]).backward(grad)
    for leaf, b in zip(leaves, want):
        assert torch.equal(leaf.grad, b)


def _jax_loi_rows(ops):
    """``loi_features``' rows with the JAX package's sampler
    (``plnet._onnx_bilerp``, f32 einsum), as a function of the three maps
    and the two ramps, for ``jax.vjp``."""
    _, _, _, junc, pairs, lines, props, _, _ = (np.asarray(t) for t in ops)
    idx = np.clip(pairs, 0, junc.shape[1] - 1)

    def rows(loi, thin, aux, t_fwd, t_rev):
        out = []
        for v in range(loi.shape[0]):
            f_junc = jplnet._onnx_bilerp(loi[v], junc[v, :, 0] - 0.5, junc[v, :, 1] - 0.5)
            parts = [f_junc[idx[v, :, 0]], f_junc[idx[v, :, 1]]]
            for fmap, seg in ((thin[v], lines[v]), (aux[v], props[v])):
                x = seg[:, 0:1] * t_fwd[None] + seg[:, 2:3] * t_rev[None] - 0.5
                y = seg[:, 1:2] * t_fwd[None] + seg[:, 3:4] * t_rev[None] - 0.5
                parts.append(jplnet._onnx_bilerp(fmap, x, y).transpose(0, 2, 1)
                             .reshape(seg.shape[0], -1))
            out.append(jnp.concatenate(parts, axis=-1))
        return jnp.stack(out)

    return rows


@pytest.mark.parametrize("case", list(chip_smoke.LOI_BACKWARD_CASES))
def test_loi_features_backward_on_crowded_endpoints_equals_jax_autodiff(case):
    """The inputs that stress kernel B+T′'s tile owners on the card
    (``chip_smoke.crowded_loi_inputs``: 600 lines' endpoints on one texel
    row, every endpoint on one texel, lines beyond every border): the
    backward's plain version, which the kernel is held to there, against
    ``jax.vjp`` of the JAX sampler's rows, the map gradients within 1e-5 of
    the largest |gradient| and the ramps' within 1e-4 of theirs."""
    rng = np.random.RandomState(3)
    ops = chip_smoke.crowded_loi_inputs(rng, 2, "cpu", case)
    grad = rng.randn(2, ops[5].shape[1], 496).astype(np.float32)
    got = bilerp.loi_features_backward(torch.as_tensor(grad), *ops)
    leaves = [jnp.asarray(ops[k].numpy()) for k in (0, 1, 2, 7, 8)]
    _, vjp = jax.vjp(_jax_loi_rows(ops), *leaves)
    want = vjp(jnp.asarray(grad))
    for a, b, tol in zip(got, want, (1e-5,) * 3 + (1e-4,) * 2):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= tol * np.abs(b).max()
    assert float(got[0].abs().max()) > 0 and float(got[3].abs().max()) > 0


# ---------------------------------------------------------------------------
# optimizer and initialisation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [0.1, 10.0], ids=["unclipped", "clipped"])
def test_clipped_adam_matches_optax(scale):
    """Two steps of ``optax.chain(clip_by_global_norm(5), adam(3e-4))`` on a
    small tree, gradients whose global norm is below or above 5: ≤ 1e-7."""
    rng = np.random.RandomState(int(scale * 10))
    params = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    steps = [{k: (rng.randn(*v.shape) * scale).astype(np.float32) for k, v in params.items()}
             for _ in range(2)]
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(3e-4))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp_ = {k: torch.nn.Parameter(torch.as_tensor(v.copy())) for k, v in params.items()}
    opt = tp.ClippedAdam(tp_.values(), lr=3e-4)
    for g in steps:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp_.items():
            p.grad = torch.as_tensor(g[k].copy())
        norm = opt.clip()
        opt.adam.step()
        assert abs(float(norm) - float(optax.global_norm(g))) <= 1e-6 * float(norm)
    for k, p in tp_.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=0, atol=1e-7)


@pytest.mark.parametrize("model", ["plnet", "superpoint"])
def test_flax_initialisers(model):
    """Fresh networks: every kernel's standard deviation within 5 % of the
    flax initialisation's (lecun_normal), every bias zero, as the JAX CLI
    initialises them (``apps/train_plnet.py:64-95``)."""
    dummy = jnp.zeros((1, 64, 64, 1), jnp.float32)
    if model == "plnet":
        want = MTO.flat_tree(jplnet.PLNet().init(jax.random.PRNGKey(0), dummy))
        net = tp.flax_init_(PLNet(), torch.Generator().manual_seed(0))
        got = MTO.flat_tree(wio.plnet_to_flax(net.state_dict()))
    else:
        want = MTO.flat_tree(JSuperPoint().init(jax.random.PRNGKey(0), dummy))
        net = tp.flax_init_(SuperPoint(), torch.Generator().manual_seed(0))
        got = MTO.flat_tree(wio.superpoint_to_flax(net.state_dict()))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        if k.endswith("bias"):
            assert not got[k].any() and not want[k].any(), k
        else:
            ratio = got[k].std() / want[k].std()
            assert abs(ratio - 1) <= 0.05, (k, ratio)
            fan_in = int(np.prod(want[k].shape[:-1]))
            assert np.abs(got[k]).max() <= 2 * np.sqrt(1 / fan_in) / tp.LECUN_TRUNCATION + 1e-7


# ---------------------------------------------------------------------------
# whole train steps from the shipped checkpoints
# ---------------------------------------------------------------------------


def _flax_grads(nets):
    if "sp" in nets:
        return MTO.flat_tree(wio.superpoint_to_flax(
            {n: p.grad for n, p in nets["sp"].named_parameters()}))
    return MTO.flat_tree({
        "plnet": wio.plnet_to_flax({n: p.grad for n, p in nets["plnet"].named_parameters()}),
        "loi": wio.loi_s1_to_flax({n: p.grad for n, p in nets["loi"].named_parameters()})})


def _check_step(jterms, jgrads, port_loss, nets, tol=1e-4):
    loss, terms = port_loss()
    assert set(terms) == set(jterms)
    for k, v in terms.items():
        w = float(jterms[k])
        assert abs(float(v.detach()) - w) <= 1e-4 * abs(w), (k, float(v), w)
    for net in nets.values():
        net.zero_grad(set_to_none=True)
    loss.backward()
    got, want = _flax_grads(nets), MTO.flat_tree(jgrads)
    assert got.keys() == want.keys()
    gaps = {k: _rel(got[k], want[k]) for k in want}
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= tol, (worst, gaps[worst])
    return got


@pytest.mark.parametrize("mode", ["plnet", "superpoint", "distill"])
def test_train_step_from_the_shipped_checkpoints(mode, shipped):
    """One step at 512², batch 1, augment 1, from the shipped checkpoints.
    The port renders the pair from the rebuilt draws: its loss terms
    ≤ 1e-4 relative of the JAX step's. On the JAX-rendered scenes with
    their images rounded to 16 bits, as the train oracle stores them (handed
    to both; XLA rounds the render of a jitted step otherwise, and the first
    conv's gradient carries such differences at 1e-3; on the unrounded
    images of the distill pair a near-tie moves conv3a's bias gradient by
    4.4e-4 between any two float32 programs, 1.3e-6 on the rounded ones),
    every gradient leaf
    ≤ 1e-4 relative L2 and each leaf's
    one-step clipped-Adam update ≤ 1e-2 relative L2 of optax's where JAX's
    gradient is nonzero; where it is zero the
    port's gradient stays within ``TRAIN_GATES["dead_grad"]`` of the leaf's
    rms, as in phase ``train``."""
    t0 = time.perf_counter()
    key = jax.random.PRNGKey({"plnet": 0, "superpoint": 1, "distill": 1}[mode])
    if mode == "plnet":
        kd, kl = jax.random.split(key)
        js0, js1 = JS.render_pair(kd, augment=1.0)
        params = shipped["s0"]
        def fn(p, a, b):
            return MTO.jax_plnet_terms(p, a, b, kl)
        plnet, loi = PLNet(), LoiHeadS1()
        plnet.load_state_dict(wio.plnet_from_flax(params["plnet"]))
        loi.load_state_dict(wio.loi_s1_from_flax(params["loi"]))
        nets = {"plnet": plnet, "loi": loi}
        draws = _t(MTO.jax_loi_draws(kl))
        pd = _t(MTO.jax_pair_draws(kd, augment=1.0))

        def port_loss(s0, s1):
            return tp.plnet_loss(plnet, loi, s0, s1, draws)
    else:
        js0, js1 = JS.render_pair(key, augment=1.0)
        params = shipped["sp"]
        sp = SuperPoint()
        sp.load_state_dict(wio.superpoint_from_flax(params))
        nets = {"sp": sp}
        pd = _t(MTO.jax_pair_draws(key, augment=1.0))
        if mode == "superpoint":
            fn = MTO.jax_superpoint_terms

            def port_loss(s0, s1):
                return tp.superpoint_loss(sp, s0, s1)
        else:
            def fn(p, a, b):
                return MTO.jax_distill_terms(p, shipped["s0"]["plnet"], a, b)
            frozen = PLNet()
            frozen.load_state_dict(wio.plnet_from_flax(shipped["s0"]["plnet"]))
            frozen.requires_grad_(False)

            def port_loss(s0, s1):
                return tp.superpoint_distill_loss(sp, frozen, s0, s1)
    step = jax.jit(jax.value_and_grad(fn, has_aux=True))
    (_, jterms), _ = step(params, js0, js1)

    # the port's own render from the rebuilt draws
    s0, s1 = TS.render_pair(pd, augment=1.0)
    loss, terms = port_loss(s0, s1)
    for k, v in terms.items():
        w = float(jterms[k])
        assert abs(float(v.detach()) - w) <= 1e-4 * abs(w), (k, float(v), w)
    # the JAX-rendered scenes, images rounded to 16 bits as the oracle stores
    # them
    js0, js1 = (MTO.quantized(s)[0] for s in (js0, js1))
    (_, jterms), jgrads = step(params, js0, js1)
    got = _check_step(jterms, jgrads, lambda: port_loss(_scene(js0), _scene(js1)), nets)

    # one clipped-Adam step against optax from these gradients
    new = MTO.flat_tree(MTO.jax_adam_step(params, jgrads))
    old = MTO.flat_tree(params)
    params_t = [p for net in nets.values() for p in net.parameters()]
    opt = tp.ClippedAdam(params_t, lr=3e-4)
    opt.clip()
    opt.adam.step()
    after = (MTO.flat_tree(wio.superpoint_to_flax(sp.state_dict())) if mode != "plnet" else
             MTO.flat_tree({"plnet": wio.plnet_to_flax(plnet.state_dict()),
                            "loi": wio.loi_s1_to_flax(loi.state_dict())}))
    jg = MTO.flat_tree(jgrads)
    for k in new:
        keep = jg[k] != 0
        assert _rel((after[k] - old[k])[keep], (new[k] - old[k])[keep]) <= 1e-2, k
        rms = np.linalg.norm(jg[k]) / np.sqrt(jg[k].size)
        dead = np.abs(np.asarray(got[k])[jg[k] == 0]).max(initial=0.0)
        assert dead <= chip_smoke.TRAIN_GATES["dead_grad"] * rms, (k, dead / rms)
    assert time.perf_counter() - t0 < 120


# ---------------------------------------------------------------------------
# the CLI and its checkpoints
# ---------------------------------------------------------------------------


def _cli():
    sys.path.insert(0, os.path.join(REPO, "apps"))
    import train_plnet_torch

    return train_plnet_torch


def _listing(path):
    return sorted((n, os.stat(os.path.join(path, n)).st_mtime_ns) for n in os.listdir(path))


@pytest.mark.parametrize("mode", ["plnet", "superpoint", "distill"])
def test_cli_checkpoint_loads_in_the_jax_package(mode, tmp_path, monkeypatch):
    """``apps/train_plnet_torch.py --device cpu --steps 2 --batch 1`` writes
    its checkpoint in ``--out``; the JAX ``load_params`` and the JAX
    ``FeatureDetector`` read it through ``AIRSLAM_CHECKPOINT_DIR``, bit-equal
    to the port's modules after the round trip; nothing is written under
    the JAX package's checkpoint folder, and the default ``--out`` is a
    folder git ignores."""
    from airslam_tpu.frontend.detector import DetectorConfig, FeatureDetector

    cli = _cli()
    before = _listing(JAX_CKPT)
    flags = {"plnet": [], "superpoint": ["--model", "superpoint"],
             "distill": ["--model", "superpoint", "--distill"]}[mode]
    rec = cli.main(flags + ["--device", "cpu", "--steps", "2", "--batch", "1",
                            "--out", str(tmp_path), "--log_every", "1"])
    assert len(rec["losses"]) == 2 and np.isfinite(rec["losses"]).all()
    name = "plnet_s0.npz" if mode == "plnet" else "superpoint.npz"
    assert rec["ckpt"] == str(tmp_path / name) and os.listdir(tmp_path) == [name]
    assert _listing(JAX_CKPT) == before

    written = MTO.flat_tree(jw.load_params(rec["ckpt"]))
    tree = wio.load_npz(rec["ckpt"])
    if mode == "plnet":
        net, loi = PLNet(), LoiHeadS1()
        net.load_state_dict(wio.plnet_from_flax(tree["plnet"]))
        loi.load_state_dict(wio.loi_s1_from_flax(tree["loi"]))
        back = {"plnet": wio.plnet_to_flax(net.state_dict()),
                "loi": wio.loi_s1_to_flax(loi.state_dict())}
        assert len(written) == 58
    else:
        net = SuperPoint()
        net.load_state_dict(wio.superpoint_from_flax(tree))
        back = wio.superpoint_to_flax(net.state_dict())
        assert len(written) == 24
    back = MTO.flat_tree(back)
    assert back.keys() == written.keys()
    for k in written:
        assert written[k].dtype == np.float32 and np.array_equal(back[k], written[k]), k

    monkeypatch.setenv("AIRSLAM_CHECKPOINT_DIR", str(tmp_path))
    det_params, _ = jw.load_default_frontend(use_superpoint=mode != "plnet")
    if mode == "plnet":
        loaded = MTO.flat_tree({"plnet": det_params["plnet"], "loi": det_params["loi"]})
    else:
        loaded = MTO.flat_tree(det_params["superpoint"])
    assert loaded.keys() == written.keys()
    for k in written:
        assert np.array_equal(np.asarray(loaded[k]), written[k]), k
    det = FeatureDetector(DetectorConfig(use_superpoint=mode != "plnet"), params=det_params)
    assert det.params is det_params

    default = cli.parse_args([]).out
    assert os.path.abspath(default) != os.path.abspath(JAX_CKPT)
    assert os.path.relpath(default, REPO) + "/" in open(os.path.join(REPO, ".gitignore")).read()
