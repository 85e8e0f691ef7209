"""The port's map-scale BA (``airslam_tpu_torch/backend/global_ba.py``) and
pose graph (``backend/windows.pose_graph_optimization``) against the JAX
package's, float64 on both sides (JAX x64), on the scenes of
tests/test_global_ba.py made from the same numpy seeds.

Tolerance 1e-7 (m for positions and points, absolute for rotations and
velocities) throughout: the same arithmetic in float64, summed in other
orders; the port's sparse solver is also held to its own dense window solver
within 1e-7, as the JAX package's test holds its pair."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

from airslam_tpu.backend import gn as jgn
from airslam_tpu.backend import global_ba as jgba
from airslam_tpu.backend import windows as jwin
from airslam_tpu_torch.backend import gn as tgn
from airslam_tpu_torch.backend import global_ba as tgba
from airslam_tpu_torch.backend import windows as twin
from airslam_tpu_torch.core.camera import Intrinsics
from tests import test_global_ba as jtest
from tests.synthetic import build_problem, default_intrinsics, make_point_scene

torch.set_num_threads(2)
TOL = 1e-7


def _intr(ji=None):
    ji = ji or default_intrinsics()
    return Intrinsics(float(ji.fx), float(ji.fy), float(ji.cx), float(ji.cy), float(ji.bf),
                      ji.width, ji.height)


def _perturbed(seed, f, p, rot=0.02, trans=0.05, **scene_kw):
    rng = np.random.RandomState(seed)
    scene = make_point_scene(f=f, p=p, rng=rng, **scene_kw)
    Rp, tp = scene["Rwb"].copy(), scene["twb"].copy()
    for i in range(1, f):
        Rp[i] = Rp[i] @ Rotation.from_rotvec(rng.randn(3) * rot).as_matrix()
        tp[i] = tp[i] + rng.randn(3) * trans
    pts0 = scene["points"] + rng.randn(p, 3) * 0.05
    return scene, build_problem(scene, Rwb=Rp, twb=tp, points=pts0)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().cpu().numpy(), np.asarray(j), atol=tol, rtol=0)


def test_sparse_matches_dense_and_jax():
    scene, prob = _perturbed(0, 5, 80)
    intr = _intr(scene["intr"])
    jsp = jgba.dense_to_sparse(prob, max_obs=16, dtype=jnp.float64)
    jout, jp_in, _ = jgba.global_ba(jsp, scene["intr"], jgn.BAConfig(), iters1=4, iters2=8,
                                   chunk=32)
    tprob = tgn.problem_from_numpy(prob, torch.float64)
    tsp = tgba.dense_to_sparse(tprob, max_obs=16)
    tout, tp_in, _ = tgba.global_ba(tsp, intr, tgn.BAConfig(), iters1=4, iters2=8, chunk=32)
    # the port's conversion is the JAX package's
    _close(tsp.pobs, jsp.pobs, 0)
    np.testing.assert_array_equal(tsp.point_obs_table.numpy(), np.asarray(jsp.point_obs_table))
    _close(tout.twb, jout.twb)
    _close(tout.Rwb, jout.Rwb)
    _close(tout.points, jout.points)
    np.testing.assert_array_equal(tp_in.numpy(), np.asarray(jp_in))
    # and the port's sparse solver lands on its dense window solver
    dense, dp_in, _ = twin.local_ba(tprob, intr, iters1=4, iters2=8)
    _close(tout.twb, dense.frames.twb.numpy())
    _close(tout.points, dense.points.numpy())
    grid = np.zeros(tprob.point_obs_mask.shape, bool)
    grid[tsp.pobs_pidx.numpy(), tsp.pobs_fidx.numpy()] = tp_in.numpy()
    assert np.array_equal(grid, dp_in.numpy() & tprob.point_obs_mask.numpy())


def test_sparse_gates_outliers():
    rng = np.random.RandomState(1)
    scene = make_point_scene(f=6, p=60, rng=rng)
    obs = scene["obs"].copy()
    bad = rng.choice(60, 6, replace=False)
    obs[bad, 2, 0] += 90.0
    prob = build_problem(dict(scene, obs=obs))
    jsp = jgba.dense_to_sparse(prob, dtype=jnp.float64)
    jout, jp_in, _ = jgba.global_ba(jsp, scene["intr"], jgn.BAConfig(), iters1=3, iters2=5,
                                   chunk=32)
    tsp = tgba.problem_from_numpy(jsp)
    tout, tp_in, _ = tgba.global_ba(tsp, _intr(scene["intr"]), tgn.BAConfig(), iters1=3,
                                   iters2=5, chunk=32)
    np.testing.assert_array_equal(tp_in.numpy(), np.asarray(jp_in))
    pidx, fidx = tsp.pobs_pidx.numpy(), tsp.pobs_fidx.numpy()
    expect = ~(np.isin(pidx, bad) & (fidx == 2))
    np.testing.assert_array_equal(tp_in.numpy(), expect)
    _close(tout.twb, jout.twb)
    _close(tout.points, jout.points)


def test_sparse_imu_refines_velocities_matches_jax():
    """The 15-dof VI system with poses fixed: the port's sparse solve equals
    the JAX one, and its own dense window solve within the JAX test's 1e-5."""
    from tests.synthetic import make_imu_sequence
    from tests.test_vio import _keyframe_preints

    seq = make_imu_sequence(duration=3.0)
    kf_idx, preints = _keyframe_preints(seq, 150)
    f = len(kf_idx)
    imu = jtest._imu_factors_from_preints(preints)
    vel_noisy = seq["vel"][kf_idx] + np.random.RandomState(0).randn(f, 3) * 0.3
    cfg_j, cfg_t = jgn.BAConfig(imu_info_scale=1.0), tgn.BAConfig(imu_info_scale=1.0)
    jsp = jgba.SparseBAProblem(
        Rwb=jnp.asarray(seq["Rwb"][kf_idx]), twb=jnp.asarray(seq["pos"][kf_idx]),
        pose_fixed=jnp.ones(f, bool), Rcb=jnp.eye(3), tcb=jnp.zeros(3),
        vel=jnp.asarray(vel_noisy), bg=jnp.zeros((f, 3)), ba=jnp.zeros((f, 3)),
        vel_fixed=jnp.zeros(f, bool), Rwg=jnp.eye(3), imu=imu, **jtest._empty_visual(f))
    jout = jgba.optimize(jsp, default_intrinsics(), cfg_j, 15, robust=False, chunk=32)
    tsp = tgba.problem_from_numpy(jsp)
    tout = tgba.optimize(tsp, _intr(), cfg_t, 15, robust=False, chunk=32)
    _close(tout.vel, jout.vel)
    _close(tout.bg, jout.bg)
    _close(tout.ba, jout.ba)
    assert np.abs(tout.vel.numpy() - seq["vel"][kf_idx]).max() < 0.05

    P = 4
    frames = tgn.FrameStates(Rwb=tsp.Rwb, twb=tsp.twb, vel=tsp.vel, bg=tsp.bg, ba=tsp.ba)
    dense = tgn.BAProblem(
        frames=frames, pose_fixed=torch.ones(f, dtype=torch.bool),
        vel_fixed=torch.zeros(f, dtype=torch.bool), points=torch.zeros((P, 3), dtype=torch.float64),
        point_fixed=torch.ones(P, dtype=torch.bool),
        point_obs=torch.cat([torch.zeros((P, f, 2)), -torch.ones((P, f, 1))], -1).double(),
        point_obs_mask=torch.zeros((P, f), dtype=torch.bool),
        lines=torch.tensor([[1.0, 0, 0, 0, 1.0, 0]], dtype=torch.float64),
        line_fixed=torch.ones(1, dtype=torch.bool), line_obs=torch.zeros((1, f, 8)).double(),
        line_obs_stereo=torch.zeros((1, f), dtype=torch.bool),
        line_obs_mask=torch.zeros((1, f), dtype=torch.bool),
        line_obs_sigma=torch.ones((1, f), dtype=torch.float64),
        Rwg=torch.eye(3, dtype=torch.float64), gravity_free=torch.zeros((), dtype=torch.float64),
        imu=tsp.imu, Rcb=torch.eye(3, dtype=torch.float64), tcb=torch.zeros(3).double())
    dense_out = tgn.optimize(dense, _intr(), cfg_t, 15, robust=False)
    _close(tout.vel, dense_out.frames.vel.numpy(), 1e-5)
    _close(tout.bg, dense_out.frames.bg.numpy(), 1e-5)


def test_sparse_vi_vision_plus_imu():
    """tests/test_global_ba.py's combined scene (points + IMU chain), its
    problem built as that test builds it, through both solvers."""
    from tests.synthetic import make_imu_sequence
    from tests.test_vio import _keyframe_preints

    seq = make_imu_sequence(duration=3.0)
    kf_idx, preints = _keyframe_preints(seq, 100)
    f = len(kf_idx)
    rng = np.random.RandomState(3)
    imu = jtest._imu_factors_from_preints(preints)
    Rwb_t, twb_t = seq["Rwb"][kf_idx], seq["pos"][kf_idx]
    intr = default_intrinsics()
    fx, fy, cx, cy, bf = (float(intr.fx), float(intr.fy), float(intr.cx), float(intr.cy),
                          float(intr.bf))
    P, mid = 120, f // 2
    pb = np.stack([rng.uniform(-4, 4, P), rng.uniform(-3, 3, P), rng.uniform(4, 11, P)], -1)
    pts = pb @ Rwb_t[mid].T + twb_t[mid]
    pidx, fidx, rows = [], [], []
    for k in range(f):
        rel = (pts - twb_t[k]) @ Rwb_t[k]
        z = rel[:, 2]
        u, v = fx * rel[:, 0] / z + cx, fy * rel[:, 1] / z + cy
        ok = (z > 0.5) & (u > 0) & (u < 752) & (v > 0) & (v < 480)
        for j in np.nonzero(ok)[0]:
            pidx.append(j)
            fidx.append(k)
            rows.append([u[j], v[j], u[j] - bf / z[j]])
    n = len(rows)
    pidx, fidx = np.asarray(pidx, np.int32), np.asarray(fidx, np.int32)
    table = jgba.build_obs_table(P, pidx, np.ones(n, bool), n, 16)
    np.testing.assert_array_equal(tgba.build_obs_table(P, pidx, np.ones(n, bool), n, 16), table)
    Rwb0, twb0 = Rwb_t.copy(), twb_t + rng.randn(f, 3) * 0.05
    for i in range(1, f):
        Rwb0[i] = Rwb0[i] @ Rotation.from_rotvec(rng.randn(3) * 0.01).as_matrix()
    twb0[0] = twb_t[0]
    vel0 = seq["vel"][kf_idx] + rng.randn(f, 3) * 0.3
    vel0[0] = seq["vel"][kf_idx[0]]
    pts0 = pts + rng.randn(P, 3) * 0.05
    fixed = np.zeros(f, bool)
    fixed[0] = True
    dummy = jtest._empty_visual(f)
    jsp = jgba.SparseBAProblem(
        Rwb=jnp.asarray(Rwb0), twb=jnp.asarray(twb0), pose_fixed=jnp.asarray(fixed),
        points=jnp.asarray(pts0), pobs_pidx=jnp.asarray(pidx), pobs_fidx=jnp.asarray(fidx),
        pobs=jnp.asarray(np.asarray(rows)), pobs_mask=jnp.ones(n, bool),
        point_obs_table=jnp.asarray(table),
        **{k: dummy[k] for k in ("lines", "lobs_lidx", "lobs_fidx", "lobs", "lobs_stereo",
                                 "lobs_mask", "lobs_sigma", "line_obs_table")},
        Rcb=jnp.eye(3), tcb=jnp.zeros(3), vel=jnp.asarray(vel0), bg=jnp.zeros((f, 3)),
        ba=jnp.zeros((f, 3)), vel_fixed=jnp.asarray(fixed), Rwg=jnp.eye(3), imu=imu)
    jout, jp_in, _ = jgba.global_ba(jsp, intr, jgn.BAConfig(), iters1=8, iters2=10, chunk=64)
    tout, tp_in, _ = tgba.global_ba(tgba.problem_from_numpy(jsp), _intr(), tgn.BAConfig(),
                                   iters1=8, iters2=10, chunk=64)
    _close(tout.twb, jout.twb)
    _close(tout.vel, jout.vel)
    _close(tout.points, jout.points)
    np.testing.assert_array_equal(tp_in.numpy(), np.asarray(jp_in))
    assert np.abs(tout.twb.numpy() - twb_t).mean() < 0.05 * np.abs(twb0 - twb_t).mean()


def test_schur_max_obs_cap_accuracy():
    """Every table width of tests/test_global_ba.py's cap study (8, 16, 32
    and the map's auto rule) gives the JAX package's result; the auto width
    covers the best-observed point and lands on the dense solver."""
    scene, prob = _perturbed(3, 20, 64, rot=0.01, trans=0.03,
                             point_range=((-4, 4), (-2.5, 2.5), (6, 18)))
    intr = _intr(scene["intr"])
    n_obs = np.asarray(prob.point_obs_mask).sum(axis=1)
    assert n_obs.max() > 16
    from airslam_tpu_torch.slam.map import _bucket

    auto = min(_bucket(int(n_obs.max()), 8), 64)
    assert auto >= n_obs.max()
    tprob = tgn.problem_from_numpy(prob, torch.float64)
    for cap in (8, 16, 32, auto):
        jout, _, _ = jgba.global_ba(jgba.dense_to_sparse(prob, max_obs=cap, dtype=jnp.float64),
                                    scene["intr"], jgn.BAConfig(), iters1=4, iters2=8, chunk=32)
        tout, _, _ = tgba.global_ba(tgba.dense_to_sparse(tprob, max_obs=cap), intr,
                                    tgn.BAConfig(), iters1=4, iters2=8, chunk=32)
        _close(tout.twb, jout.twb)
        _close(tout.points, jout.points)
    dense, _, _ = twin.local_ba(tprob, intr, iters1=4, iters2=8)
    err_dense = np.abs(dense.frames.twb.numpy() - scene["twb"]).max()
    assert np.abs(tout.twb.numpy() - scene["twb"]).max() < max(10.0 * err_dense, 1e-8)


def test_early_exit_lm_parity_and_convergence():
    """The opt-in early exit of the window LM: the port's schedules (full and
    early-exit) equal the JAX package's, and both reach the truth."""
    scene, prob = _perturbed(4, 5, 60)
    intr = _intr(scene["intr"])
    tprob = tgn.problem_from_numpy(prob, torch.float64)
    for early in (0.0, 1e-8):
        jout, _, _ = jwin.local_ba(prob, scene["intr"], iters1=5, iters2=15, early_exit=early)
        tout, _, _ = twin.local_ba(tprob, intr, iters1=5, iters2=15, early_exit=early)
        _close(tout.frames.twb, jout.frames.twb)
        assert np.abs(tout.frames.twb.numpy() - scene["twb"]).max() < 1e-3


def _pose_graph_case(seed, f=8, loop=True):
    rng = np.random.RandomState(seed)
    R = np.stack([Rotation.from_rotvec(rng.randn(3) * 0.2).as_matrix() for _ in range(f)])
    t = rng.randn(f, 3)
    ei, ej = list(range(f - 1)), list(range(1, f))
    if loop:
        ei, ej = ei + [0, 2], ej + [f - 1, f - 2]
    Rm = np.stack([R[a].T @ R[b] @ Rotation.from_rotvec(rng.randn(3) * 0.01).as_matrix()
                   for a, b in zip(ei, ej)])
    tm = np.stack([R[a].T @ (t[b] - t[a]) + rng.randn(3) * 0.02 for a, b in zip(ei, ej)])
    fixed = np.zeros(f, bool)
    fixed[0] = True
    mask = np.ones(len(ei), bool)
    mask[1] = False  # a masked edge contributes nothing
    R0 = np.stack([R[k] @ Rotation.from_rotvec(rng.randn(3) * 0.05).as_matrix()
                   for k in range(f)])
    return jwin.PoseGraphProblem(
        Rwb=jnp.asarray(R0), twb=jnp.asarray(t + rng.randn(f, 3) * 0.2),
        fixed=jnp.asarray(fixed), edge_i=jnp.asarray(ei, jnp.int32),
        edge_j=jnp.asarray(ej, jnp.int32), R_meas=jnp.asarray(Rm), t_meas=jnp.asarray(tm),
        mask=jnp.asarray(mask))


@pytest.mark.parametrize("seed,loop", [(0, True), (1, True), (2, False)])
def test_pose_graph_matches_jax(seed, loop):
    jp = _pose_graph_case(seed, loop=loop)
    jo = jwin.pose_graph_optimization(jp, iterations=20)
    tp = twin.PoseGraphProblem(
        Rwb=torch.as_tensor(np.asarray(jp.Rwb)), twb=torch.as_tensor(np.asarray(jp.twb)),
        fixed=torch.as_tensor(np.asarray(jp.fixed)),
        edge_i=torch.as_tensor(np.asarray(jp.edge_i, np.int64)),
        edge_j=torch.as_tensor(np.asarray(jp.edge_j, np.int64)),
        R_meas=torch.as_tensor(np.asarray(jp.R_meas)),
        t_meas=torch.as_tensor(np.asarray(jp.t_meas)), mask=torch.as_tensor(np.asarray(jp.mask)))
    to = twin.pose_graph_optimization(tp, iterations=20)
    _close(to.twb, jo.twb)
    _close(to.Rwb, jo.Rwb)
    np.testing.assert_array_equal(to.twb[0].numpy(), np.asarray(jp.twb)[0])  # fixed
    c0 = float(twin._pose_graph_cost(tp, tp.Rwb, tp.twb))
    assert float(twin._pose_graph_cost(tp, to.Rwb, to.twb)) < c0


def test_map_scale_scene_solves_as_the_jax_solver():
    """The stored map-scale scene generator (``chip_smoke.map_scale_scene``)
    is tests/test_global_ba.py's, and at a small size the port's 3-iteration
    sparse solve (chunk 4096, the JAX test's) equals the JAX one."""
    import chip_smoke

    sc = chip_smoke.map_scale_scene(40, 600)
    tsp = chip_smoke.map_scale_problem(sc, torch.float64, "cpu")
    jsp = jgba.SparseBAProblem(**{k: jnp.asarray(getattr(tsp, k).numpy())
                                  for k in tgba.SparseBAProblem._fields[:19]})
    intr = default_intrinsics(jnp.float64)
    jout = jgba.optimize(jsp, intr, jgn.BAConfig(), iterations=3, robust=False, chunk=4096)
    tout = tgba.optimize(tsp, _intr(), tgn.BAConfig(), iterations=3, robust=False, chunk=4096)
    _close(tout.twb, jout.twb)
    _close(tout.points, jout.points)
    c0 = float(tgba._total_cost(tsp, _intr(), tgn.BAConfig(), False))
    c1 = float(tgba._total_cost(tout, _intr(), tgn.BAConfig(), False))
    assert c1 < 1e-3 * c0
