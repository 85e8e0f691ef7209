"""The port's data-parallel trainers: the dp ``plnet`` step
(``parallel/train_plnet.make_plnet_train_step(mesh=...)``) against the
port's single-device step, and the dp/tp LightGlue step
(``parallel/training.make_train_step(state, mesh)``) against the JAX
``make_train_step`` under its 8-device mesh (``__graft_entry__`` dry run,
step (e)).

The ``plnet`` comparison runs the networks in float64: in float32 the two
layouts differ by the order of the weight gradients' sums over 512² pixels
(about 1e-5 relative L2, the noise of a float32 sum of that length), which
is not what the test looks for. Its mesh is ``cpu`` and ``cpu:1``: two mesh
entries in one memory, so the second shard runs on a copy of the networks
that must be refreshed after every step, as on two cards; a stale copy would
show at the second step."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from airslam_tpu.models.lightglue import LightGlue as JLightGlue
from airslam_tpu.parallel import mesh as jmesh
from airslam_tpu.parallel import training as jt
from airslam_tpu_torch.models import weights as wio
from airslam_tpu_torch.models.lightglue import LightGlue
from airslam_tpu_torch.models.plnet import LoiHeadS1, PLNet
from airslam_tpu_torch.parallel import mesh as tmesh
from airslam_tpu_torch.parallel import train_plnet as tp
from airslam_tpu_torch.parallel import training as tr

torch.set_num_threads(2)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return np.linalg.norm(got - want) / den if den > 0 else np.linalg.norm(got)


def _plnet_run(mesh, steps=2, batch=2):
    """``steps`` plnet steps (no descriptor pair, seeded init, float64
    networks); per step (loss, clipped gradients)."""
    plnet, loi = PLNet(dtype=torch.float64), LoiHeadS1(dtype=torch.float64)
    tp.flax_init_(plnet, torch.Generator().manual_seed(0))
    loi.load_state_dict(wio.loi_s1_from_flax(wio.load_npz(wio.checkpoint_path("plnet_s1.npz"))))
    plnet.train()
    loi.train()
    opt = tp.ClippedAdam(list(plnet.parameters()) + list(loi.parameters()), 3e-4)
    step = tp.make_plnet_train_step(plnet, loi, opt, with_desc=False, mesh=mesh)
    gen = torch.Generator().manual_seed(0)
    out = []
    for _ in range(steps):
        loss, terms = step(gen, batch)
        out.append((float(loss), {k: float(v) for k, v in terms.items()},
                    [None if p.grad is None else p.grad.clone() for p in opt.params]))
    return out, (plnet, loi)


def test_dp_plnet_steps_match_the_single_device_steps():
    """Two data-parallel steps over a mesh of 2 (a batch of 2: one image per
    shard, each through its own replica) against the port's single-device
    steps: the loss and terms within 1e-6 relative, every leaf's gradient
    within 1e-5 relative L2, at each step; the copies on the second entry
    hold the updated parameters."""
    mesh = tmesh.make_mesh(tp=1, devices=["cpu", "cpu:1"])
    (single, _), (dp, modules) = _plnet_run(None), _plnet_run(mesh)
    for (l1, t1, g1), (l2, t2, g2) in zip(single, dp):
        assert abs(l2 - l1) <= 1e-6 * abs(l1)
        assert t1.keys() == t2.keys()
        for k in t1:
            assert abs(t2[k] - t1[k]) <= 1e-6 * max(abs(t1[k]), 1e-12)
        assert [a is None for a in g1] == [b is None for b in g2]
        worst = max(_rel(b.numpy(), a.numpy()) for a, b in zip(g1, g2) if a is not None)
        assert worst <= 1e-5, worst
    copies = tmesh.module_replicas(mesh, modules, torch.device("cpu", 1))
    assert len(copies) == 2 and all(c is not m for c, m in zip(copies, modules))
    for c, m in zip(copies, modules):
        for p, q in zip(c.parameters(), m.parameters()):
            assert p.data_ptr() != q.data_ptr() and torch.equal(p, q)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_dp_tp_lightglue_step_against_jax():
    """One LightGlue step (dim 64, 4 heads, 2 layers, 8 permuted pairs of 16
    keypoints) on the 8-entry mesh, dp 4 × tp 2 (each block's heads split
    over the tp pair, the batch over dp), against the JAX step under its
    mesh (``shard_lightglue_params``, ``batch_sharding``) on the same numpy
    batch: the loss within 1e-5 relative, the gradients within 1e-4 relative
    L2 leaf by leaf, and the Adam update within 1e-4 relative L2 on the
    entries whose JAX gradient exceeds 1e-3 of its leaf's rms (below it the
    sign of a float32-noise gradient sets Adam's first step: the key third of
    the self-attention ``qkv`` bias has a zero gradient in exact
    arithmetic)."""
    lr, n, dim = 1e-3, 16, 64
    batch = tr.make_batch(tr.perm_draws(torch.Generator().manual_seed(3), 8, n, dim=dim))
    with jax.enable_x64(False):
        jm = JLightGlue(dim=dim, heads=4, layers=2)
        k, d, m = jnp.zeros((n, 2)), jnp.zeros((n, dim)), jnp.ones((n,), bool)
        params = jax.tree_util.tree_map(
            np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), k, d, m, k, d, m))
        jb = tuple(jnp.asarray(b.numpy()) for b in batch)
        jgrads = jax.jit(jax.grad(lambda p: jt.match_loss(jm, p, *jb)))(params)
        mesh = jmesh.make_mesh(8)
        tx = optax.adam(lr)
        state = jt.TrainState(jmesh.shard_lightglue_params(params, mesh),
                              jax.device_put(tx.init(params), jmesh.replicated(mesh)),
                              jnp.zeros((), jnp.int32))
        sharded = tuple(jax.device_put(b, jmesh.batch_sharding(mesh)) for b in jb)
        with mesh:
            state2, jloss = jax.jit(jt.make_train_step(jm, tx))(state, sharded)
        want = _flat(jax.tree_util.tree_map(np.asarray, state2.params))
    jg, before = _flat(jax.tree_util.tree_map(np.asarray, jgrads)), _flat(params)

    model = LightGlue(dim=dim, heads=4, layers=2)
    model.load_state_dict(wio.lightglue_from_flax(params))
    tmesh8 = tmesh.make_mesh(devices=["cpu"] * 8)
    loss = tr.make_train_step(tr.TrainState(model, tr.adam(model.parameters(), lr)),
                              tmesh8)(batch)
    assert tmesh8.shape == {"dp": 4, "tp": 2}
    assert all(len(row) == 2 for blk in model.self_blocks for row in blk.tp_rows)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    got = _flat(wio.lightglue_to_flax({n_: p.detach() for n_, p in model.state_dict().items()}))
    grads = _flat(wio.lightglue_to_flax({n_: p.grad for n_, p in model.named_parameters()}))
    assert got.keys() == want.keys() == jg.keys()
    for key in jg:
        assert _rel(grads[key], jg[key]) <= 1e-4, key
        g = jg[key]
        sure = np.abs(g) > 1e-3 * np.sqrt(np.mean(g * g))
        assert _rel((got[key] - before[key])[sure], (want[key] - before[key])[sure]) <= 1e-4, key
