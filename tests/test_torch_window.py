"""The window backend of the port against the JAX package's on the CPU:
``backend/gn.py`` (grids, closed-form inverses, one LM step, ``optimize``),
``backend/windows.py`` (``local_ba``, ``_pose_only_general``),
``backend/triangulate.py`` and the rest of ``frontend/lines.py``. Both sides
run float64 on the same numpy-seeded problems (those of tests/test_backend.py);
each test states its tolerance. One test runs the port in float32, as on the
card, against the f64 JAX result at the ``PARITY_TPU.json`` gates."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from airslam_tpu.backend import gn as jgn
from airslam_tpu.backend import triangulate as jtri
from airslam_tpu.backend import windows as jwindows
from airslam_tpu.core import lie as jlie
from airslam_tpu.frontend import lines as jlines
from airslam_tpu_torch.backend import gn, triangulate, windows
from airslam_tpu_torch.core.camera import Intrinsics
from airslam_tpu_torch.frontend import lines
from tests.synthetic import build_problem, default_intrinsics, make_point_scene

torch.set_num_threads(2)
F64 = torch.float64


def _t(a, dtype=F64):
    a = np.asarray(a)
    return torch.as_tensor(a) if a.dtype == bool else torch.as_tensor(a.astype(np.float64)).to(dtype)


def _intr(jintr):
    return Intrinsics(*(float(getattr(jintr, k)) for k in ("fx", "fy", "cx", "cy", "bf")))


def _gap(a, b):
    return float(np.abs(np.asarray(a, np.float64) - b.double().numpy()).max())


def _scene_with_line(seed=4, f=3, p=50):
    """tests/test_backend.py::test_local_ba_with_lines's problem: a point
    scene and one perturbed stereo line seen from every frame."""
    rng = np.random.RandomState(seed)
    scene = make_point_scene(f=f, p=p, rng=rng)
    p1, p2 = np.array([0.5, -1.0, 6.0]), np.array([1.5, 1.0, 6.5])
    line_true = np.asarray(jlie.line_from_endpoints(jnp.asarray(p1), jnp.asarray(p2)))
    line_obs = np.zeros((1, f, 8))
    fx, fy, cx, cy, bf = 450.0, 450.0, 376.0, 240.0, 45.0
    for i in range(f):
        Rcw = scene["Rcb"] @ scene["Rwb"][i].T
        tcw = scene["tcb"] - Rcw @ scene["twb"][i]
        for k, pt in enumerate([p1, p2]):
            pc = Rcw @ pt + tcw
            line_obs[0, i, 2 * k] = pc[0] / pc[2] * fx + cx
            line_obs[0, i, 2 * k + 1] = pc[1] / pc[2] * fy + cy
            qc = pc - np.array([bf / fx, 0, 0])
            line_obs[0, i, 4 + 2 * k] = qc[0] / qc[2] * fx + cx
            line_obs[0, i, 4 + 2 * k + 1] = qc[1] / qc[2] * fy + cy
    line0 = np.asarray(jlie.line_orthonormal_oplus(
        jnp.asarray(line_true), jnp.asarray([0.02, -0.03, 0.01, 0.02])))
    twb0 = scene["twb"].copy()
    twb0[1:] += rng.randn(f - 1, 3) * 0.03
    pts0 = scene["points"] + rng.randn(p, 3) * 0.05
    prob = build_problem(scene, twb=twb0, points=pts0, lines=line0[None], line_obs=line_obs,
                         line_obs_mask=np.ones((1, f), bool), line_obs_stereo=np.ones((1, f), bool),
                         line_fixed=np.zeros(1, bool))
    return prob, scene


def _perturbed(seed, f, p, outliers=0):
    """tests/test_backend.py's local-BA problems: poses and points perturbed,
    optionally ``outliers`` observations of frame 1 corrupted by 80 px."""
    rng = np.random.RandomState(seed)
    scene = make_point_scene(f=f, p=p, rng=rng)
    Rwb0, twb0 = scene["Rwb"].copy(), scene["twb"].copy()
    for i in range(1, f):
        Rwb0[i] = Rwb0[i] @ Rotation.from_rotvec(rng.randn(3) * 0.02).as_matrix()
        twb0[i] = twb0[i] + rng.randn(3) * 0.05
    pts0 = scene["points"] + rng.randn(p, 3) * 0.1
    if outliers:
        obs = scene["obs"].copy()
        obs[rng.choice(p, outliers, replace=False), 1, 0] += 80.0
        scene = dict(scene, obs=obs)
    return build_problem(scene, Rwb=Rwb0, twb=twb0, points=pts0), scene


def _port(prob, dtype=F64):
    return gn.problem_from_numpy(prob, dtype=dtype)


# ---------------------------------------------------------------------------
# closed-form inverses and the SPD solve: 1e-10
# ---------------------------------------------------------------------------


def _spd(rng, batch, n):
    a = rng.randn(*batch, n, n)
    return a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(n)


@pytest.mark.parametrize("name,n", [("inv3_spd", 3), ("_inv2", 2), ("inv4_spd", 4)])
def test_closed_form_inverses_vs_jax(name, n):
    A = _spd(np.random.RandomState(n), (7, 5), n)
    got = getattr(gn, name)(_t(A))
    assert _gap(getattr(jgn, name)(jnp.asarray(A)), got) <= 1e-10
    np.testing.assert_allclose(got.numpy() @ A, np.broadcast_to(np.eye(n), A.shape), atol=1e-9)


def test_inverse_of_a_singular_block_is_finite():
    """|det| is floored at 1e-30 with its sign kept, on both sides."""
    A = np.zeros((2, 3, 3))
    A[1] = -np.eye(3) * 1e-12
    got = gn.inv3_spd(_t(A))
    assert bool(torch.isfinite(got).all())
    assert _gap(jgn.inv3_spd(jnp.asarray(A)), got) <= 1e-10 * float(got.abs().max())
    assert gn._DET_FLOOR == jgn._DET_FLOOR == 1e-30


def test_solve_spd_vs_jax_and_nan_when_not_positive_definite():
    rng = np.random.RandomState(0)
    H, b = _spd(rng, (), 90), rng.randn(90)
    got = gn.solve_spd(_t(H), _t(b))
    assert _gap(jgn.solve_spd(jnp.asarray(H), jnp.asarray(b)), got) <= 1e-10
    np.testing.assert_allclose(H @ got.numpy(), b, atol=1e-9)
    bad = gn.solve_spd(_t(-np.eye(4)), _t(np.ones(4)))
    assert bool(torch.isnan(bad).all())  # the LM cost gate rejects such a step


# ---------------------------------------------------------------------------
# grids: residuals, Jacobians, chi²: 1e-9
# ---------------------------------------------------------------------------


def test_grid_residuals_and_jacobians_vs_jax():
    prob, scene = _scene_with_line()
    ours, intr = _port(prob), _intr(scene["intr"])
    want = jgn._point_grid_residuals(prob, scene["intr"], True)
    got = gn._point_grid_residuals(ours, intr, True)
    for w, g, name in zip(want, got, ("r", "row_mask", "depth_ok", "Jc", "Jp")):
        assert g.shape == np.asarray(w).shape, name
        assert _gap(w, g) <= 1e-9, name
    want = jgn._line_grid_residuals(prob, scene["intr"], True)
    got = gn._line_grid_residuals(ours, intr, True)
    for w, g, name in zip(want, got, ("r", "row_mask", "Jc", "Jl")):
        assert g.shape == np.asarray(w).shape, name
        assert _gap(w, g) <= 1e-9, name
    assert gn._point_grid_residuals(ours, intr, False)[3] is None
    pchi2, depth_ok = gn.point_chi2(ours, intr)
    jp, jd = jgn.point_chi2(prob, scene["intr"])
    assert _gap(jp, pchi2) <= 1e-9 and np.array_equal(np.asarray(jd), depth_ok.numpy())
    assert _gap(jgn.line_chi2(prob, scene["intr"]), gn.line_chi2(ours, intr)) <= 1e-9
    assert _gap(jgn.line_chi2(prob, scene["intr"], 0.3), gn.line_chi2(ours, intr, 0.3)) <= 1e-9


def test_f32_problem_keeps_f32_grids():
    prob, scene = _scene_with_line()
    ours = _port(prob, torch.float32)
    out = gn._point_grid_residuals(ours, _intr(scene["intr"]), True)
    assert {t.dtype for t in (out[0], out[1], out[3], out[4])} == {torch.float32}
    assert gn._line_grid_residuals(ours, _intr(scene["intr"]), True)[3].dtype == torch.float32


# ---------------------------------------------------------------------------
# one LM step, the cost, the update: 1e-8
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("robust", [True, False])
def test_assemble_and_solve_step_vs_jax(robust):
    prob, scene = _scene_with_line()
    ours, intr, cfg = _port(prob), _intr(scene["intr"]), gn.BAConfig()
    lam = 1e-3
    want = jgn._assemble_and_solve(prob, scene["intr"], jgn.BAConfig(), lam, robust)
    got = gn._assemble_and_solve(ours, intr, cfg, torch.tensor(lam, dtype=F64), robust)
    for w, g, name in zip(want, got, ("dx_frames", "dg", "dp", "dl")):
        assert g.shape == np.asarray(w).shape, name
        assert _gap(w, g) <= 1e-8, name
    assert float(got[0][0].abs().max()) == 0.0  # the fixed frame does not move
    assert _gap(jgn.total_cost(prob, scene["intr"], jgn.BAConfig(), robust),
                gn.total_cost(ours, intr, cfg, robust)) <= 1e-8
    cand = gn.apply_update(ours, *got)
    jcand = jgn.apply_update(prob, *want)
    assert _gap(jcand.frames.Rwb, cand.frames.Rwb) <= 1e-8
    assert _gap(jcand.points, cand.points) <= 1e-8 and _gap(jcand.lines, cand.lines) <= 1e-8
    blocks = np.random.RandomState(1).randn(3, 6, 6)
    assert _gap(jgn._blockdiag(jnp.asarray(blocks)), gn._blockdiag(_t(blocks))) == 0.0


def test_imu_branch_raises_and_names_its_queue():
    """The IMU branch runs (it raised until the stereo-inertial slice): the
    line scene with IMU factors between consecutive frames, velocities and
    biases free, one step and the cost against the JAX package's to 1e-8,
    the system grown from F·6 to F·15 + 2 dims."""
    prob, scene = _scene_with_line()
    f = prob.frames.Rwb.shape[0]
    rng = np.random.RandomState(2)
    k = f - 1
    imu = jgn.IMUFactors(
        idx_i=jnp.arange(k, dtype=jnp.int32), idx_j=jnp.arange(1, f, dtype=jnp.int32),
        dR=jnp.asarray(np.tile(np.eye(3), (k, 1, 1))), dV=jnp.asarray(rng.randn(k, 3) * 0.01),
        dP=jnp.asarray(rng.randn(k, 3) * 0.05),
        JRg=jnp.asarray(rng.randn(k, 3, 3) * 0.01), JVg=jnp.asarray(rng.randn(k, 3, 3) * 0.01),
        JVa=jnp.asarray(rng.randn(k, 3, 3) * 0.01), JPg=jnp.asarray(rng.randn(k, 3, 3) * 0.01),
        JPa=jnp.asarray(rng.randn(k, 3, 3) * 0.01),
        bg_lin=jnp.zeros((k, 3)), ba_lin=jnp.zeros((k, 3)), dT=jnp.full((k,), 0.25),
        info=jnp.asarray(np.tile(np.eye(9) * 50.0, (k, 1, 1))),
        info_walk=jnp.asarray(np.tile(np.eye(6) * 1e2, (k, 1, 1))), mask=jnp.ones(k, bool))
    prob = prob._replace(imu=imu, vel_fixed=jnp.zeros(f, bool))
    ours, intr, cfg = _port(prob), _intr(scene["intr"]), gn.BAConfig()
    # the JAX reference compiled whole: one XLA program, not one per operation
    want = jax.jit(jgn._assemble_and_solve, static_argnums=(4,))(
        prob, scene["intr"], jgn.BAConfig(), 1e-3, True)
    got = gn._assemble_and_solve(ours, intr, cfg, torch.tensor(1e-3, dtype=F64), True)
    for w, g, name in zip(want, got, ("dx_frames", "dg", "dp", "dl")):
        assert g.shape == np.asarray(w).shape, name
        assert _gap(w, g) <= 1e-8, name
    assert float(got[0][:, 6:].abs().max()) > 0  # velocities and biases move
    c_want = float(jax.jit(jgn.total_cost, static_argnums=(3,))(
        prob, scene["intr"], jgn.BAConfig(), True))
    assert abs(float(gn.total_cost(ours, intr, cfg, True)) - c_want) <= 1e-8 * c_want
    assert (gn.POSE_DIM, gn.FRAME_DIM, gn.GRAV_DIM) == (jgn.POSE_DIM, jgn.FRAME_DIM, jgn.GRAV_DIM)


# ---------------------------------------------------------------------------
# local_ba: poses 1e-6, points 1e-5, inlier grids equal
# ---------------------------------------------------------------------------


def _assert_local_ba(got, want, t_tol=1e-6, p_tol=1e-5):
    (out, p_in, l_in), (jout, jp_in, jl_in) = got, want
    assert _gap(jout.frames.twb, out.frames.twb) <= t_tol
    assert _gap(jout.frames.Rwb, out.frames.Rwb) <= t_tol
    assert _gap(jout.points, out.points) <= p_tol
    assert _gap(jout.lines, out.lines) <= p_tol
    assert np.array_equal(np.asarray(jp_in), p_in.numpy())
    assert np.array_equal(np.asarray(jl_in), l_in.numpy())


@pytest.mark.parametrize("case", ["converges", "outliers", "lines"])
@pytest.mark.parametrize("early_exit", [0.0, 1e-4], ids=["fixed-schedule", "early-exit"])
def test_local_ba_vs_jax(case, early_exit):
    if case == "converges":
        prob, scene = _perturbed(1, 4, 60)
    elif case == "outliers":
        prob, scene = _perturbed(2, 3, 50, outliers=5)
    else:
        prob, scene = _scene_with_line()
    want = jwindows.local_ba(prob, scene["intr"], early_exit=early_exit)
    got = windows.local_ba(_port(prob), _intr(scene["intr"]), early_exit=early_exit)
    _assert_local_ba(got, want)
    if case == "outliers":  # the 80 px observations are gated out
        mask = np.asarray(prob.point_obs_mask)
        assert int(got[1].sum()) < int(mask.sum())
    if case == "lines":
        assert bool(got[2].all())
        assert float(gn.line_chi2(got[0], _intr(scene["intr"]), 1.0).max()) < 1e-6


def test_optimize_early_exit_stops_early():
    """With ``early_exit`` the loop ends once an accepted step gains less
    than the tolerance: the same result as JAX's while_loop, in fewer steps."""
    prob, scene = _perturbed(1, 4, 60)
    ours, intr = _port(prob), _intr(scene["intr"])
    steps = []
    solve = gn._assemble_and_solve

    def counting(*a, **k):
        steps.append(1)
        return solve(*a, **k)

    gn._assemble_and_solve = counting
    try:
        out = gn.optimize(ours, intr, gn.BAConfig(), 15, robust=True, early_exit=1e-3)
    finally:
        gn._assemble_and_solve = solve
    assert 1 <= len(steps) < 15
    jout = jgn.optimize(prob, scene["intr"], jgn.BAConfig(), 15, robust=True, early_exit=1e-3)
    assert _gap(jout.frames.twb, out.frames.twb) <= 1e-6


def test_local_ba_f32_vs_jax_f64_at_the_parity_gates():
    """The card's configuration: the port in float32 against the f64 JAX
    solve (PARITY_TPU.json ``local_ba_*``: t ≤ 0.02, points ≤ 0.05, inlier
    agreement ≥ 0.98)."""
    prob, scene = _perturbed(2, 3, 50, outliers=5)
    jout, jp_in, _ = jwindows.local_ba(prob, scene["intr"])
    out, p_in, _ = windows.local_ba(_port(prob, torch.float32), _intr(scene["intr"]))
    assert out.points.dtype == torch.float32
    assert _gap(jout.frames.twb, out.frames.twb) <= 0.02
    assert _gap(jout.points, out.points) <= 0.05
    assert float((np.asarray(jp_in) == p_in.numpy()).mean()) >= 0.98


# ---------------------------------------------------------------------------
# pose-only on the general solver (F = 2)
# ---------------------------------------------------------------------------


def test_pose_only_general_f2_vs_jax():
    """tests/test_backend.py::test_pose_only_fast_matches_general's problem:
    F = 2 (a second, fixed frame without observations) goes to the general
    dense solver; poses 1e-8, inlier flags and count equal; and it lands
    where the F = 1 path (the tracking kernel's plain version) lands."""
    rng = np.random.RandomState(3)
    K = 64
    jintr = default_intrinsics()
    pts = rng.randn(K, 3) * 2 + [0, 0, 8]
    xi = np.array([0.02, -0.03, 0.01, 0.05, -0.04, 0.06])
    Rwb_t, twb_t = Rotation.from_rotvec(xi[:3]).as_matrix(), xi[3:]
    pc = (pts - twb_t) @ Rwb_t
    fx, fy, cx, cy, bf = (float(getattr(jintr, k)) for k in ("fx", "fy", "cx", "cy", "bf"))
    u = pc[:, 0] / pc[:, 2] * fx + cx
    v = pc[:, 1] / pc[:, 2] * fy + cy
    obs = np.stack([u, v, np.where(np.arange(K) % 2 == 0, u - bf / pc[:, 2], -1.0)], -1)
    bad = rng.choice(K, K // 5, replace=False)
    obs[bad, :2] += rng.randn(len(bad), 2) * 40

    def build(F):
        obs_f = np.zeros((K, F, 3))
        obs_f[:, :, 2] = -1.0
        obs_f[:, 0] = obs
        mask_f = np.zeros((K, F), bool)
        mask_f[:, 0] = True
        return jgn.BAProblem(
            frames=jgn.FrameStates(
                Rwb=jnp.asarray(np.stack([np.eye(3)] * F)), twb=jnp.zeros((F, 3)),
                vel=jnp.zeros((F, 3)), bg=jnp.zeros((F, 3)), ba=jnp.zeros((F, 3))),
            pose_fixed=jnp.asarray([False] + [True] * (F - 1)), vel_fixed=jnp.ones(F, bool),
            points=jnp.asarray(pts), point_fixed=jnp.ones(K, bool),
            point_obs=jnp.asarray(obs_f), point_obs_mask=jnp.asarray(mask_f),
            lines=jnp.asarray([[1.0, 0, 0, 0, 1.0, 0]]), line_fixed=jnp.ones(1, bool),
            line_obs=jnp.zeros((1, F, 8)), line_obs_stereo=jnp.zeros((1, F), bool),
            line_obs_mask=jnp.zeros((1, F), bool), line_obs_sigma=jnp.full((1, F), 0.5),
            Rwg=jnp.eye(3), gravity_free=jnp.asarray(0.0), imu=None,
            Rcb=jnp.eye(3), tcb=jnp.zeros(3))

    intr = _intr(jintr)
    jo, jp_in, _, jn = jwindows.pose_only_optimization(build(2), jintr)
    o2, p_in2, l_in2, n2 = windows.pose_only_optimization(_port(build(2)), intr)
    assert _gap(jo.frames.twb, o2.frames.twb) <= 1e-8 and _gap(jo.frames.Rwb, o2.frames.Rwb) <= 1e-8
    assert np.array_equal(np.asarray(jp_in), p_in2.numpy()) and int(jn) == int(n2)
    assert p_in2.shape == (K, 2) and l_in2.shape == (1, 2)
    o1, p_in1, _, n1 = windows.pose_only_optimization(_port(build(1)), intr)
    assert float((o1.frames.twb[0] - o2.frames.twb[0]).abs().max()) <= 1e-6
    assert int(n1) == int(n2) and torch.equal(p_in1[:, 0], p_in2[:, 0])
    assert float(np.linalg.norm(o2.frames.twb[0].numpy() - twb_t)) < 1e-6


# ---------------------------------------------------------------------------
# triangulation and line fits
# ---------------------------------------------------------------------------


def test_triangulate_points_batch_vs_jax():
    """1e-9; a single view and two views on one ray are refused."""
    rng = np.random.RandomState(0)
    B, N = 32, 8
    jintr = default_intrinsics()
    X = rng.randn(B, 3) * 1.5 + [0, 0, 7]
    Rcw = np.stack([[Rotation.from_rotvec(rng.randn(3) * 0.05).as_matrix() for _ in range(N)]
                    for _ in range(B)])
    tcw = rng.randn(B, N, 3) * 0.4
    pc = np.einsum("bnij,bj->bni", Rcw, X) + tcw
    uv = np.stack([pc[..., 0] / pc[..., 2] * 450 + 376, pc[..., 1] / pc[..., 2] * 450 + 240], -1)
    mask = rng.rand(B, N) < 0.7
    mask[:, :2] = True
    mask[0] = [True] + [False] * (N - 1)  # one view
    Rcw[1], tcw[1], mask[1] = Rcw[1, 0], tcw[1, 0], True  # the same view eight times
    uv[1] = uv[1, 0]
    jx, jok = jtri.triangulate_points_batch(jnp.asarray(Rcw), jnp.asarray(tcw), jnp.asarray(uv),
                                            jnp.asarray(mask), jintr)
    x, ok = triangulate.triangulate_points_batch(_t(Rcw), _t(tcw), _t(uv), _t(mask), _intr(jintr))
    assert np.array_equal(np.asarray(jok), ok.numpy())
    assert not ok[0] and not ok[1] and int(ok.sum()) == B - 2
    good = ok.numpy()
    assert np.abs(np.asarray(jx)[good] - x.numpy()[good]).max() <= 1e-9
    assert np.abs(x.numpy()[good] - X[good]).max() <= 1e-6
    one = triangulate.triangulate_point(_t(Rcw[5]), _t(tcw[5]), _t(uv[5]), _t(mask[5]),
                                        _intr(jintr))
    assert float((one[0] - x[5]).abs().max()) <= 1e-12 and bool(one[1])


def _line_points(rng, n, noise=0.01, outliers=0):
    p0, d = rng.normal(size=3), rng.normal(size=3)
    d /= np.linalg.norm(d)
    pts = p0 + rng.uniform(-2.0, 2.0, size=n)[:, None] * d + noise * rng.normal(size=(n, 3))
    if outliers:
        pts[:outliers] += rng.uniform(1.0, 2.0, size=(outliers, 3))
    return pts


def _same_segment(a, b, tol):
    """Endpoints agree in either order (an eigenvector's sign is free)."""
    return min(np.abs(a - b).max(), np.abs(np.concatenate([a[3:], a[:3]]) - b).max()) <= tol


def test_fit_lines_batch_vs_jax():
    """The batch of tests/test_line_fit_batch.py: ok flags equal, endpoints
    1e-9 up to their order; a degenerate row (one point) is refused."""
    rng = np.random.default_rng(0)
    P, B = 64, 8
    buf, mask = np.zeros((B, P, 3)), np.zeros((B, P), bool)
    for b in range(B):
        n = int(rng.integers(2, P)) if b else 1
        buf[b, :n] = _line_points(rng, n, outliers=(n // 8 if b % 2 else 0))
        mask[b, :n] = True
    jends, jok = jtri.fit_lines_batch(jnp.asarray(buf), jnp.asarray(mask))
    ends, ok = triangulate.fit_lines_batch(_t(buf), _t(mask))
    assert np.array_equal(np.asarray(jok), ok.numpy()) and not ok[0] and int(ok.sum()) == B - 1
    for b in range(1, B):
        assert _same_segment(ends[b].numpy(), np.asarray(jends)[b], 1e-9), b
    cart, inl, ok1 = triangulate.fit_line_huber(_t(buf[3]), _t(mask[3]))
    jcart, jinl, _ = jtri.fit_line_huber(jnp.asarray(buf[3]), jnp.asarray(mask[3]))
    assert bool(ok1) and np.array_equal(np.asarray(jinl), inl.numpy())
    assert _gap(jcart[:3], cart[:3]) <= 1e-9
    assert min(_gap(jcart[3:], cart[3:]), _gap(-jcart[3:], cart[3:])) <= 1e-9
    e1 = triangulate.extreme_projections(cart, _t(buf[3]), inl)
    assert _same_segment(e1.numpy(), ends[3].numpy(), 1e-12)


def test_fit_lines_padding_does_not_matter():
    rng = np.random.default_rng(2)
    pts = _line_points(rng, 20)
    for P in (32, 64):
        buf, mask = np.zeros((1, P, 3)), np.zeros((1, P), bool)
        buf[0, :20], mask[0, :20] = pts, True
        ends, ok = triangulate.fit_lines_batch(_t(buf), _t(mask))
        assert bool(ok[0])
        if P == 32:
            first = ends[0].numpy()
    assert _same_segment(ends[0].numpy(), first, 1e-12)


# ---------------------------------------------------------------------------
# frontend/lines.py: two-view triangulation, Point2DTo3D, endpoint trims: 1e-9
# ---------------------------------------------------------------------------


def _two_views(rng, n):
    jintr = default_intrinsics()
    P1 = rng.randn(n, 3) + [0, 0, 6]
    P2 = P1 + rng.randn(n, 3) * 0.8
    poses = []
    for _ in range(2):
        R = np.stack([Rotation.from_rotvec(rng.randn(3) * 0.1).as_matrix() for _ in range(n)])
        poses.append((R, rng.randn(n, 3) * 0.5))

    def seg(R, t):
        out = []
        for P in (P1, P2):
            pc = np.einsum("nji,nj->ni", R, P - t)
            out += [pc[:, 0] / pc[:, 2] * 450 + 376, pc[:, 1] / pc[:, 2] * 450 + 240]
        return np.stack(out, -1)

    return jintr, P1, P2, poses, [seg(*p) for p in poses]


def test_triangulate_two_views_vs_jax():
    rng = np.random.RandomState(5)
    jintr, P1, P2, ((R1, t1), (R2, t2)), (l1, l2) = _two_views(rng, 12)
    l2[0], R2[0], t2[0] = l1[0], R1[0], t1[0]  # the same view twice: parallel planes
    jl, jdeg = jlines.triangulate_two_views(*(jnp.asarray(a) for a in (l1, R1, t1, l2, R2, t2)),
                                            jintr)
    ln, deg = lines.triangulate_two_views(*(_t(a) for a in (l1, R1, t1, l2, R2, t2)),
                                          _intr(jintr))
    assert np.array_equal(np.asarray(jdeg), deg.numpy()) and bool(deg[0]) and not bool(deg[1:].any())
    assert np.abs(np.asarray(jl)[1:] - ln.numpy()[1:]).max() <= 1e-9
    # the triangulated line passes through both 3D endpoints
    for P in (P1, P2):
        w, d = ln[1:, :3].numpy(), ln[1:, 3:].numpy()
        assert np.abs(np.cross(P[1:], d) - w).max() <= 1e-6


def test_point_2d_to_3d_vs_jax():
    rng = np.random.RandomState(6)
    a1, a2 = rng.randn(9, 3), rng.randn(9, 3)
    u1, u2 = rng.rand(9, 2) * 100, rng.rand(9, 2) * 100
    u2[0] = u1[0]  # a zero-length anchor: the guarded denominator
    p = rng.rand(9, 2) * 100
    want = jlines.point_2d_to_3d(*(jnp.asarray(a) for a in (a1, a2, u1, u2, p)))
    got = lines.point_2d_to_3d(*(_t(a) for a in (a1, a2, u1, u2, p)))
    assert np.abs(np.asarray(want)[1:] - got.numpy()[1:]).max() <= 1e-9
    assert np.allclose(np.asarray(want)[0], got.numpy()[0], rtol=1e-9)


def test_endpoint_trims_vs_jax():
    """The tensor form, its numpy twin and the row-batched numpy form against
    the JAX package's three, 1e-9; the trimmed endpoints reproject onto the
    observed ones."""
    rng = np.random.RandomState(7)
    n = 10
    jintr = default_intrinsics()
    p1, p2 = np.array([0.5, -1.0, 6.0]), np.array([1.5, 1.0, 6.5])
    line = np.asarray(jlie.line_from_endpoints(jnp.asarray(p1), jnp.asarray(p2)))
    Rwc = np.stack([Rotation.from_rotvec(rng.randn(3) * 0.05).as_matrix() for _ in range(n)])
    twc = rng.randn(n, 3) * 0.3
    Rcw = np.swapaxes(Rwc, -1, -2)
    tcw = -np.einsum("nij,nj->ni", Rcw, twc)
    obs = []
    for P in (p1, p2):
        pc = np.einsum("nij,j->ni", Rcw, P) + tcw
        obs += [pc[:, 0] / pc[:, 2] * 450 + 376, pc[:, 1] / pc[:, 2] * 450 + 240]
    obs = np.stack(obs, -1)
    cam = (450.0, 450.0, 376.0, 240.0)
    want = np.asarray(jlines.endpoint_trim(jnp.asarray(line), jnp.asarray(obs), jnp.asarray(Rcw),
                                           jnp.asarray(tcw), jintr))
    got = lines.endpoint_trim(_t(line), _t(obs), _t(Rcw), _t(tcw), _intr(jintr)).numpy()
    assert np.abs(got - want).max() <= 1e-9
    assert np.abs(got - np.concatenate([p1, p2])).max() <= 1e-6
    got_np = lines.endpoint_trim_np(line, obs, Rcw, tcw, *cam)
    assert np.abs(got_np - jlines.endpoint_trim_np(line, obs, Rcw, tcw, *cam)).max() <= 1e-12
    assert np.abs(got_np - got).max() <= 1e-9
    d = (p2 - p1) / np.linalg.norm(p2 - p1)
    p0 = np.cross(d, np.cross(p1, d))
    rows = lines.endpoint_trim_rows_np(np.tile(p0, (n, 1)), np.tile(d, (n, 1)), obs, Rcw, tcw, *cam)
    jrows = jlines.endpoint_trim_rows_np(np.tile(p0, (n, 1)), np.tile(d, (n, 1)), obs, Rcw, tcw,
                                         *cam)
    assert np.abs(rows - jrows).max() <= 1e-12 and np.abs(rows - got_np).max() <= 1e-9
