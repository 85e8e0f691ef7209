"""The port's multi-device BA and mesh (``airslam_tpu_torch/parallel/``)
against the JAX package's on the 8-device CPU mesh that tests/conftest.py
forces, and ``entry.dryrun_multichip`` on a CPU mesh.

The port's mesh is 8 × ``cpu`` (``make_mesh(devices=[cpu] * 8)``): one
process, each shard's work on its entry's device, the partial sums reduced on
the primary in shard order. The BAs run in float64 and are held within 1e-8
(m, and absolute for the points) with equal inlier flags, as
tests/test_parallel.py holds the JAX sharded BA to its single-device run."""

import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import __graft_entry__ as graft
from airslam_tpu.backend import gn as jgn
from airslam_tpu.parallel import mesh as jmesh
from airslam_tpu.parallel import sharded_ba as jsharded
from airslam_tpu_torch import entry
from airslam_tpu_torch.backend import gn as tgn
from airslam_tpu_torch.backend import global_ba as tgba
from airslam_tpu_torch.backend import windows as twin
from airslam_tpu_torch.core.camera import Intrinsics
from airslam_tpu_torch.parallel import mesh as tmesh
from airslam_tpu_torch.parallel import sharded_ba as tsharded
from tests import test_global_ba as jtest_gba
from tests.synthetic import build_problem, make_point_scene

torch.set_num_threads(2)
TOL = 1e-8
CPU8 = ["cpu"] * 8


def _intr(ji):
    return Intrinsics(float(ji.fx), float(ji.fy), float(ji.cx), float(ji.cy), float(ji.bf),
                      ji.width, ji.height)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().cpu().numpy(), np.asarray(j), atol=tol, rtol=0)


def _perturbed(seed, f=4, p=64):
    """tests/test_parallel.py:21's and tests/test_global_ba.py:65's scene."""
    rng = np.random.RandomState(seed)
    scene = make_point_scene(f=f, p=p, rng=rng)
    Rp, tp = scene["Rwb"].copy(), scene["twb"].copy()
    for i in range(1, f):
        Rp[i] = Rp[i] @ Rotation.from_rotvec(rng.randn(3) * 0.02).as_matrix()
        tp[i] = tp[i] + rng.randn(3) * 0.05
    pts0 = scene["points"] + rng.randn(p, 3) * 0.05
    return scene, build_problem(scene, Rwb=Rp, twb=tp, points=pts0)


def test_make_mesh_shapes_and_real_devices():
    """The JAX mesh's shapes from a device list; over real devices a mesh
    larger than the cards raises (no virtual mesh unless asked for)."""
    assert tmesh.make_mesh(devices=CPU8).shape == dict(jmesh.make_mesh(8).shape) \
        == {"dp": 4, "tp": 2}
    assert tmesh.make_mesh(tp=1, devices=CPU8).shape == dict(jmesh.make_mesh(8, tp=1).shape) \
        == {"dp": 8, "tp": 1}
    assert tmesh.make_mesh(devices=["cpu"] * 3).shape == {"dp": 3, "tp": 1}
    m = tmesh.make_mesh(devices=CPU8)
    assert m.size == 8 and m.primary == torch.device("cpu") and len(m.dp_devices()) == 4
    with pytest.raises(ValueError):
        tmesh.make_mesh(tp=3, devices=CPU8)
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="virtual mesh"):
            tmesh.make_mesh(2)
    # the placement helpers: axis 0 over dp, for a tensor and a tree
    x = torch.arange(8.0)
    assert [t.tolist() for t in tmesh.batch_sharding(m, x)] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    trees = tmesh.shard_batch(m, {"a": (x, None), "b": x[:, None]}, 8)
    assert [t["a"][0].tolist() for t in trees] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert trees[3]["a"][1] is None and trees[3]["b"].tolist() == [[6.0], [7.0]]
    with pytest.raises(ValueError):
        tmesh.shard_batch(m, (x, x[:5]), 8)
    assert tmesh.split_sizes(5, 4) == [2, 1, 1, 1]
    assert tmesh.even_bounds(64, 8)[1] == (8, 16) and tmesh.even_bounds(10, 4) == [(0, 10)]


def test_sharded_window_ba_against_jax():
    """The landmark-sharded window BA (tests/test_parallel.py:21's scene,
    float64) against the JAX ``sharded_global_ba`` on its 8-device mesh."""
    scene, prob = _perturbed(0)
    jout, jp_in, _ = jsharded.sharded_global_ba(prob, scene["intr"], jgn.BAConfig(),
                                                jmesh.make_mesh(8, tp=1), iters1=3, iters2=5)
    tprob = tgn.problem_from_numpy(prob, torch.float64)
    shards = tsharded.shard_problem(tprob, tmesh.make_mesh(tp=1, devices=CPU8))
    assert [s.points.shape[0] for s in shards[0]] == [8] * 8 and len(shards[1]) == 1
    tout, tp_in, tl_in = tsharded.sharded_global_ba(tprob, _intr(scene["intr"]), tgn.BAConfig(),
                                                    tmesh.make_mesh(tp=1, devices=CPU8),
                                                    iters1=3, iters2=5)
    _close(tout.frames.twb, jout.frames.twb)
    _close(tout.frames.Rwb, jout.frames.Rwb)
    _close(tout.points, jout.points)
    np.testing.assert_array_equal(tp_in.numpy(), np.asarray(jp_in))
    assert np.abs(tout.frames.twb.numpy() - scene["twb"]).max() < 1e-3


def test_sharded_sparse_ba_against_jax():
    """Observations and landmarks sharded (tests/test_global_ba.py:65's
    scene, float64, chunk 32) against the JAX ``sharded_sparse_global_ba``:
    each shard holds its landmarks' observations, re-indexed."""
    scene, prob = _perturbed(5)
    sp = jtest_gba._dense_to_sparse(prob)
    jmesh8 = jmesh.make_mesh(8, tp=1)
    jout, jp_in, _ = jsharded.sharded_sparse_global_ba(sp, scene["intr"], jgn.BAConfig(),
                                                       jmesh8, iters1=3, iters2=5, chunk=32)
    tsp = tgba.problem_from_numpy(sp, torch.float64)
    mesh = tmesh.make_mesh(tp=1, devices=CPU8)
    layout = tsharded.shard_sparse_problem(tsp, mesh)
    parts = layout.points.parts
    assert [(lo, hi) for _, lo, hi, *_ in parts] == [(8 * i, 8 * i + 8) for i in range(8)]
    assert sum(len(p[3]) for p in parts) == tsp.pobs.shape[0]
    for _, lo, _, sel, lidx, table, _ in parts:  # each shard's observations are its own
        np.testing.assert_array_equal(tsp.pobs_pidx[sel].numpy() - lo, lidx.numpy())
        assert int(table.max()) == len(sel)  # the local padding index
    tout, tp_in, _ = tsharded.sharded_sparse_global_ba(tsp, _intr(scene["intr"]),
                                                       tgn.BAConfig(), mesh, iters1=3, iters2=5,
                                                       chunk=32)
    _close(tout.twb, jout.twb)
    _close(tout.Rwb, jout.Rwb)
    _close(tout.points, jout.points)
    np.testing.assert_array_equal(tp_in.numpy(), np.asarray(jp_in))


def test_sharded_vi_window_counts_imu_once():
    """The JAX dry run's production window (F = 15, P = 256, L = 32, frames
    10-14 free with the IMU chain of ``__graft_entry__._synthetic_imu_chain``)
    sharded over 8 against the port's single-device window, float64: an IMU
    block added once per shard would show here."""
    rng = np.random.RandomState(0)
    scene = make_point_scene(f=15, p=256, rng=rng)
    fixed = np.arange(15) < 10
    lines = np.tile(np.asarray([1.0, 0, 0, 0, 1.0, 0]), (32, 1))
    prob = build_problem(scene, pose_fixed=fixed, lines=lines)
    prob = prob._replace(imu=graft._synthetic_imu_chain(np.arange(10, 14), np.arange(11, 15),
                                                        jnp.float64),
                         vel_fixed=jnp.asarray(fixed))
    tprob = tgn.problem_from_numpy(prob, torch.float64)
    intr = _intr(scene["intr"])
    ref, rp_in, _ = twin.local_ba(tprob, intr, iters1=1, iters2=2)
    out, p_in, _ = tsharded.sharded_global_ba(tprob, intr, tgn.BAConfig(),
                                              tmesh.make_mesh(tp=1, devices=CPU8),
                                              iters1=1, iters2=2)
    for a, b in zip(out.frames, ref.frames):
        _close(a, b.numpy())
    _close(out.points, ref.points.numpy())
    np.testing.assert_array_equal(p_in.numpy(), rp_in.numpy())
    # the IMU factors moved the free frames' velocities
    assert float(out.frames.vel[10:].abs().max()) > 1e-6


def test_mesh_none_and_one_device_are_the_direct_call():
    """``mesh=None`` is the direct call, and a one-device mesh computes the
    same bits (one shard, no copies), for the window and the sparse BA."""
    scene, prob = _perturbed(0)
    tprob = tgn.problem_from_numpy(prob, torch.float32)
    intr = _intr(scene["intr"])
    one = tmesh.make_mesh(devices=["cpu"])
    direct = twin.local_ba(tprob, intr, iters1=2, iters2=2)
    for mesh in (None, one):
        got = twin.local_ba(tprob, intr, iters1=2, iters2=2, mesh=mesh)
        for a, b in zip(jtu.tree_leaves(got), jtu.tree_leaves(direct)):
            assert torch.equal(a, b) if torch.is_tensor(a) else a == b
    sp = tgba.dense_to_sparse(tprob)
    direct = tgba.global_ba(sp, intr, iters1=2, iters2=2, chunk=32)
    for mesh in (None, one):
        got = tgba.global_ba(sp, intr, iters1=2, iters2=2, chunk=32, mesh=mesh)
        for a, b in zip(jtu.tree_leaves(got), jtu.tree_leaves(direct)):
            assert torch.equal(a, b) if torch.is_tensor(a) else a == b


def test_dryrun_multichip_on_a_cpu_mesh(capsys):
    """``entry.dryrun_multichip(4, device="cpu")`` at its small shapes: every
    step's line, each gap within its gate."""
    gaps = entry.dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out
    for line in ("dryrun sparse-globalba OK", "dryrun window-ba OK",
                 "dryrun sharded-detect OK", "dryrun mesh-pipeline OK", "dryrun_multichip OK"):
        assert line in out, out
    assert "{'dp': 2, 'tp': 2}" in out
    assert set(gaps) == {"sparse-globalba", "window-ba", "sharded-detect", "mesh-pipeline",
                         "matcher-step"}
    assert entry.dryrun_mesh(3, device="cpu") == [torch.device("cpu")] * 3
