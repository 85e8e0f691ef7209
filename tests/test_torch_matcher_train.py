"""The port's matcher trainer (``airslam_tpu_torch/parallel/training.py``,
``apps/train_matcher_torch.py``) against the JAX one, on the CPU in float32.

JAX runs as its trainer does (float32, no x64); its draws are rebuilt from
the same keys (``scripts/make_torch_oracle.py``'s ``jax_*_draws``) and handed
to the port (the ``view``-widened pair's render against JAX is
``tests/test_torch_synthgen.py::test_render_pair_with_affine_view``, where
the JAX render is already compiled). Gates: the ``view`` draws' ranges per
pair; the permutation batch ≤ 1e-6; at small width (2 layers, dim 64, a JAX init
converted) each loss ≤ 1e-5 relative and each leaf's gradient ≤ 1e-4
relative L2, and the port's Adam on JAX's gradients within 1e-7 of optax's;
the toy trainer below 0.8 of its first loss within 30 steps; against
``tests/data/torch_matcher_oracle.npz`` (the JAX trainer's step on stored
pairs) the batch builders, every mode's stored step and the
wide-viewpoint pairs under phase ``matcher``'s gates (``chip_smoke``'s
functions on the CPU); the checkpoint
converters bit-exact; the CLI's checkpoints load in the JAX package, whose
forward on them equals the port's within 1e-5 of its largest value.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from airslam_tpu.models import weights as jw
from airslam_tpu.models.lightglue import LightGlue as JLightGlue
from airslam_tpu.models.superglue import SuperGlue as JSuperGlue
from airslam_tpu.parallel import training as jt
from airslam_tpu_torch.frontend import synthgen as TS
from airslam_tpu_torch.models import weights as wio
from airslam_tpu_torch.models.lightglue import LightGlue
from airslam_tpu_torch.models.superglue import SuperGlue
from airslam_tpu_torch.parallel import training as tr

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CKPT = os.path.join(REPO, "airslam_tpu", "checkpoints")
CPU = torch.device("cpu")


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


def _t(d):
    """Nested numpy/JAX draws → torch, with a batch of one."""
    if isinstance(d, dict):
        return {k: _t(v) for k, v in d.items()}
    return torch.as_tensor(np.array(d))[None]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return np.linalg.norm(got - want) / den if den > 0 else np.linalg.norm(got)


# ---------------------------------------------------------------------------
# the view curriculum
# ---------------------------------------------------------------------------


def test_pair_draws_view_ranges():
    """The port's own ``pair_draws(view=2)``: each pair's strength v in
    [1, 2), its rotation within ±0.35·v, scale within 1 ± 0.15·v and shift
    within ±40·v, pairs beyond the ``view = 1`` ranges among them; at view 1
    the defaults' ranges and v = 1."""
    gen = torch.Generator().manual_seed(0)
    a = TS.pair_draws(gen, 64, view=2.0)["affine"]
    v = a["v"]
    assert v.shape == (64,) and float(v.min()) >= 1.0 and float(v.max()) < 2.0
    assert torch.all(a["theta"].abs() <= 0.35 * v)
    assert torch.all((a["scale"] - 1.0).abs() <= 0.15 * v + 1e-7)
    assert torch.all(a["shift"].abs() <= 40.0 * v[:, None])
    assert bool((a["theta"].abs() > 0.35).any()) and bool((a["shift"].abs() > 40.0).any())
    b = TS.pair_draws(gen, 64)["affine"]
    assert torch.all(b["v"] == 1.0) and torch.all(b["theta"].abs() <= 0.35)
    assert float(b["scale"].min()) >= 0.85 and float(b["scale"].max()) <= 1.15


# ---------------------------------------------------------------------------
# the permutation trainer
# ---------------------------------------------------------------------------


def test_make_batch_against_jax():
    """``make_batch`` from the rebuilt JAX draws (uniform keypoints, normal
    descriptors, a permutation per pair, the noise) against the JAX batch:
    ≤ 1e-6, the permutation equal."""
    key = jax.random.PRNGKey(2)
    want = jt.make_batch(key, 3, 20)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    draws = {"kpts0": jax.random.uniform(k1, (3, 20, 2), minval=-0.5, maxval=0.5),
             "desc0": jax.random.normal(k2, (3, 20, 256)),
             "perm": jax.vmap(lambda k: jax.random.permutation(k, 20))(jax.random.split(k3, 3)),
             "noise": jax.random.normal(k4, (3, 20, 256))}
    got = tr.make_batch({k: torch.as_tensor(np.array(v)).long() if k == "perm" else
                         torch.as_tensor(np.array(v)) for k, v in draws.items()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    draws = tr.perm_draws(torch.Generator().manual_seed(0), 2, 20)
    assert sorted(draws["perm"][1].tolist()) == list(range(20))
    assert float(draws["kpts0"].min()) >= -0.5 and float(draws["kpts0"].max()) < 0.5


def _small_lightglue(n=24):
    jm = JLightGlue(dim=64, heads=4, layers=2)
    k = jnp.zeros((n, 2), jnp.float32)
    d = jnp.zeros((n, 64), jnp.float32)
    m = jnp.ones((n,), bool)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), k, d, m, k, d, m)
    params = jax.tree_util.tree_map(np.asarray, params)
    model = LightGlue(dim=64, heads=4, layers=2)
    model.load_state_dict(wio.lightglue_from_flax(params))
    return jm, params, model, wio.lightglue_to_flax


def _small_superglue(n=24):
    jm = JSuperGlue(dim=64, heads=4, gnn_layers=2, sinkhorn_iterations=jt.SG_SINKHORN_ITERS,
                    return_full=True)
    k = jnp.zeros((n, 2), jnp.float32)
    s = jnp.zeros((n,), jnp.float32)
    d = jnp.zeros((n, 64), jnp.float32)
    m = jnp.ones((n,), bool)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), k, s, d, m, k, s, d, m)
    params = jax.tree_util.tree_map(np.asarray, params)
    model = SuperGlue(dim=64, heads=4, gnn_layers=2, sinkhorn_iterations=tr.SG_SINKHORN_ITERS,
                      return_full=True)
    model.load_state_dict(wio.superglue_from_flax(params))
    return jm, params, model, wio.superglue_to_flax


def _port_grads(model, to_flax):
    return MTO.flat_tree(to_flax({n: p.grad for n, p in model.named_parameters()}))


def _check_loss_and_grads(jloss, params, port_loss, model, to_flax):
    """The JAX loss and gradient against the port's: ≤ 1e-5 relative loss,
    every leaf's gradient ≤ 1e-4 relative L2; SuperGlue's key biases (a zero
    gradient in exact arithmetic, ``chip_smoke.null_leaves``) within
    ``MATCHER_GATES["null_grad"]`` of their key kernel's gradient norm in
    both packages. Returns JAX's gradients."""
    want, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    model.zero_grad(set_to_none=True)
    loss = port_loss()
    loss.backward()
    assert abs(float(loss.detach()) - float(want)) <= 1e-5 * abs(float(want))
    got, jg = _port_grads(model, to_flax), MTO.flat_tree(jgrads)
    assert got.keys() == jg.keys()
    null = chip_smoke.null_leaves(jg)
    for grads in (got, jg):
        for leaf in null:
            assert chip_smoke.null_grad_ratio(grads, leaf) <= chip_smoke.MATCHER_GATES["null_grad"]
    gaps = {k: _rel(got[k], jg[k]) for k in jg if k not in null}
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= 1e-4, (worst, gaps[worst])
    return jgrads


def test_permutation_step_against_jax():
    """``match_loss`` and its gradient at small width on a permutation
    batch against JAX; then one Adam step of the port's ``adam`` on JAX's
    gradients against ``optax.adam`` (no clipping) within 1e-7."""
    jm, params, model, to_flax = _small_lightglue()
    batch = tr.make_batch(tr.perm_draws(torch.Generator().manual_seed(3), 2, 24, dim=64))
    jb = [jnp.asarray(b.numpy()) for b in batch]
    jgrads = _check_loss_and_grads(lambda p: jt.match_loss(jm, p, *jb), params,
                                   lambda: tr.match_loss(model, *batch), model, to_flax)
    lr = 2e-4
    tx = optax.adam(lr)
    updates, _ = tx.update(jgrads, tx.init(params), params)
    want = MTO.flat_tree(optax.apply_updates(params, updates))
    opt = tr.adam(model.parameters(), lr)
    grads = wio.lightglue_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        p.grad = grads[name]
    opt.step()
    got = MTO.flat_tree(to_flax(model.state_dict()))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-7, err_msg=k)


def test_toy_trainer_reduces_loss():
    """tests/test_parallel.py::test_training_reduces_loss on the port:
    LightGlue dim 64, 2 layers, flax's initialisers, Adam 3e-4, batches of
    4 × 16 (64-dimensional descriptors): the 30th loss below 0.8 of the
    first."""
    model = LightGlue(dim=64, heads=4, layers=2)
    state = tr.init_train_state(model, lr=3e-4, seed=0)
    step = tr.make_train_step(state)
    gen = torch.Generator().manual_seed(0)
    losses = [float(step(tr.make_batch(tr.perm_draws(gen, 4, 16, dim=64)))) for _ in range(30)]
    assert losses[-1] < losses[0] * 0.8, f"no learning: {losses[0]:.3f} -> {losses[-1]:.3f}"


# ---------------------------------------------------------------------------
# the four losses at small width
# ---------------------------------------------------------------------------


def _random_batch(rng, tokens, arch, b=2, n=24, dim=64):
    """A seeded batch of the trainer's tuple for ``tokens``/``arch``:
    normalised keypoints, unit descriptors, masks with padding, and the
    supervision (matched/one-view flags, or targets and negatives)."""
    f = np.float32
    k = [(rng.rand(b, n, 2) - 0.5).astype(f) for _ in range(2)]
    d = [rng.randn(b, n, dim).astype(f) for _ in range(2)]
    d = [x / np.linalg.norm(x, axis=-1, keepdims=True) for x in d]
    m = [rng.rand(b, n) < 0.85 for _ in range(2)]
    s = [rng.rand(b, n).astype(f) for _ in range(2)]
    if tokens == "corners":
        tail = (m[0] & m[1], m[0] & ~m[1], m[1] & ~m[0])
    else:
        tgt = np.where(m[0] & (rng.rand(b, n) < 0.6), rng.randint(0, n, (b, n)), -1)
        tgt = np.where(np.take_along_axis(m[1], np.maximum(tgt, 0), 1), tgt, -1).astype(np.int32)
        tail = (tgt, m[0] & (tgt < 0) & (rng.rand(b, n) < 0.5), m[1] & (rng.rand(b, n) < 0.3))
    if arch == "superglue":
        return (k[0], s[0], d[0], m[0], k[1], s[1], d[1], m[1]) + tail
    return (k[0], d[0], m[0], k[1], d[1], m[1]) + tail


JAX_LOSSES = {("lightglue", "corners"): jt.rendered_match_loss,
              ("superglue", "corners"): jt.rendered_match_loss_sg,
              ("lightglue", "detected"): jt.detected_match_loss,
              ("superglue", "detected"): jt.detected_match_loss_sg}


@pytest.mark.parametrize("mode", chip_smoke.MATCHER_MODES)
def test_losses_small_width(mode):
    """Each mode's loss and gradient at small width (2 layers, dim 64, a
    JAX init converted; SuperGlue with 20 Sinkhorn iterations and the whole
    plan) on a seeded batch with padded tokens: ≤ 1e-5 relative loss, every
    leaf's gradient ≤ 1e-4 relative L2."""
    arch, tokens = mode.split("_")
    jm, params, model, to_flax = (_small_lightglue if arch == "lightglue" else _small_superglue)()
    batch = _random_batch(np.random.RandomState(len(mode)), tokens, arch)
    jb = tuple(jnp.asarray(a) for a in batch)
    tb = tuple(chip_smoke._tensor(a, CPU) for a in batch)
    _check_loss_and_grads(lambda p: JAX_LOSSES[arch, tokens](jm, p, jb), params,
                          lambda: chip_smoke.matcher_loss(arch, tokens)(model, tb), model,
                          to_flax)


# ---------------------------------------------------------------------------
# full width against the stored JAX step
# ---------------------------------------------------------------------------


def test_stored_steps_and_batches():
    """Phase ``matcher``'s stored-step and batch-builder gates on the CPU:
    every mode's step from the shipped checkpoints on the stored JAX batch
    (loss ≤ 1e-4 relative, each leaf's gradient ≤ 1e-3 relative L2, Adam's
    update ≤ 1e-2 where JAX's gradient is nonzero), then the port's batch
    builders on the stored 16-bit images (corner tokens and masks exact,
    descriptors and scores ≤ 1e-5, the detected tokens as sets)."""
    report = chip_smoke.matcher_oracle_steps(CPU)
    assert set(report) == set(chip_smoke.MATCHER_MODES)
    batches = chip_smoke.matcher_batch_gaps(CPU)
    assert batches["detected"]["share"] >= chip_smoke.MATCHER_GATES["token_share"]


def test_wide_viewpoint_gate():
    """Phase ``matcher``'s wide-viewpoint gate on the CPU: the three pairs
    of ``tests/test_trained_detector.py::test_wide_viewpoint_matching``
    rendered by the port from the stored JAX draws, the port's detector and
    the shipped LightGlue: the JAX test's gates and each count within 5 %
    of the JAX count."""
    from airslam_tpu_torch.frontend.detector import DetectorConfig, FeatureDetector

    detector = FeatureDetector(DetectorConfig(use_superpoint=False), device=CPU)
    counts, precs, jax_counts = chip_smoke.wide_viewpoint_gate(CPU, detector)
    assert len(counts) == len(jax_counts) == 3 and len(precs) == 3


@pytest.mark.parametrize("arch", ["lightglue", "superglue"])
def test_to_flax_round_trip(arch):
    """The shipped tree through ``*_from_flax`` and ``*_to_flax``: the same
    keys (205 / 273 arrays), shapes and dtypes, and the same bits."""
    tree = wio.load_npz(os.path.join(JAX_CKPT, f"{arch}.npz"))
    if arch == "lightglue":
        model = LightGlue()
        model.load_state_dict(wio.lightglue_from_flax(tree))
        back = MTO.flat_tree(wio.lightglue_to_flax(model.state_dict()))
    else:
        model = SuperGlue(sinkhorn_iterations=20)
        model.load_state_dict(wio.superglue_from_flax(tree))
        back = MTO.flat_tree(wio.superglue_to_flax(model.state_dict()))
    want = MTO.flat_tree(tree)
    assert back.keys() == want.keys() and len(want) == {"lightglue": 205, "superglue": 273}[arch]
    for k in want:
        assert back[k].dtype == want[k].dtype and back[k].shape == want[k].shape, k
        assert np.array_equal(back[k], want[k]), k


@pytest.mark.parametrize("arch", ["lightglue", "superglue"])
def test_matcher_initialisers(arch):
    """Fresh matchers at full width (one layer: the initialisers depend on
    each layer's shape, not on the depth): every kernel's standard deviation
    within 5 % of the flax initialisation's (lecun_normal, the JAX CLI's
    init), biases 0, LayerNorm scales 1, SuperGlue's ``bin_score`` 1."""
    n = 8
    k, d, m = jnp.zeros((n, 2)), jnp.zeros((n, 256)), jnp.ones((n,), bool)
    if arch == "lightglue":
        want = MTO.flat_tree(jax.jit(JLightGlue(layers=1).init)(jax.random.PRNGKey(0),
                                                                k, d, m, k, d, m))
        model = LightGlue(layers=1)
        tr.init_train_state(model, seed=0)
        got = MTO.flat_tree(wio.lightglue_to_flax(model.state_dict()))
    else:
        s = jnp.zeros((n,))
        want = MTO.flat_tree(jax.jit(JSuperGlue(gnn_layers=1, sinkhorn_iterations=20).init)(
            jax.random.PRNGKey(0), k, s, d, m, k, s, d, m))
        model = SuperGlue(gnn_layers=1, sinkhorn_iterations=20)
        with torch.no_grad():
            model.bin_score.fill_(3.0)
        tr.init_train_state_sg(model, seed=0)
        got = MTO.flat_tree(wio.superglue_to_flax(model.state_dict()))
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].shape == want[key].shape, key
        if key.endswith("kernel") and want[key].size > 64:
            ratio = got[key].std() / want[key].std()
            assert abs(ratio - 1) <= 0.05, (key, ratio)
        elif not key.endswith("kernel"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# ---------------------------------------------------------------------------
# the CLI and its checkpoints
# ---------------------------------------------------------------------------


def _cli():
    sys.path.insert(0, os.path.join(REPO, "apps"))
    import train_matcher_torch

    return train_matcher_torch


@pytest.mark.parametrize("arch,tokens", [("lightglue", "corners"), ("superglue", "detected")])
def test_cli_checkpoint_loads_in_the_jax_package(arch, tokens, tmp_path):
    """``apps/train_matcher_torch.py --device cpu --steps 2 --batch 1``
    writes its checkpoint in ``--out`` (nothing under the JAX package's
    folder); the JAX ``load_params`` reads it with the shipped tree's keys,
    and the JAX module's forward on it equals the port's within 1e-5 of
    the output's largest magnitude (scores up to 64 on 32 random tokens;
    measured: 3.8e-6)."""
    cli = _cli()
    before = sorted(os.listdir(JAX_CKPT))
    flags = ["--arch", arch, "--tokens", tokens] + (["--view", "2"] if tokens == "detected"
                                                    else [])
    rec = cli.main(flags + ["--device", "cpu", "--steps", "2", "--batch", "1",
                            "--out", str(tmp_path), "--log_every", "1"])
    assert len(rec["losses"]) == 2 and np.isfinite(rec["losses"]).all()
    assert rec["ckpt"] == str(tmp_path / f"{arch}.npz") and os.listdir(tmp_path) == [f"{arch}.npz"]
    assert sorted(os.listdir(JAX_CKPT)) == before
    params = jw.load_params(rec["ckpt"])
    shipped = MTO.flat_tree(jw.load_params(os.path.join(JAX_CKPT, f"{arch}.npz")))
    assert MTO.flat_tree(params).keys() == shipped.keys()

    rng = np.random.RandomState(7)
    batch = _random_batch(rng, "corners", arch, b=1, n=32, dim=256)
    args = [a[0] for a in batch[:8 if arch == "superglue" else 6]]
    tree = wio.load_npz(rec["ckpt"])
    if arch == "lightglue":
        model = LightGlue()
        model.load_state_dict(wio.lightglue_from_flax(tree))
        want = jax.jit(JLightGlue().apply)(params, *(jnp.asarray(a) for a in args))
    else:
        model = SuperGlue(sinkhorn_iterations=20)
        model.load_state_dict(wio.superglue_from_flax(tree))
        want = (jax.jit(JSuperGlue(sinkhorn_iterations=20).apply)(
            params, *(jnp.asarray(a) for a in args)),)
    with torch.no_grad():
        got = model(*(torch.as_tensor(a) for a in args))
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()

    default = cli.parse_args([]).out
    assert os.path.relpath(default, REPO) + "/" in open(os.path.join(REPO, ".gitignore")).read()
