"""The port's tracking backend on the CPU against the JAX package, on the
same inputs made from a seed with numpy: Lie helpers, residuals with their
guards, the unrolled SPD solve, the autodiff pose Jacobians, the autodiff
pose-only solver, and the plain version of the whole-solver kernel (analytic
Jacobians) against the JAX scan solver and the Pallas kernel in interpret
mode. Tolerances are stated per test."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airslam_tpu.backend import gn as jgn
from airslam_tpu.backend import residuals as jres
from airslam_tpu.backend import windows as jwindows
from airslam_tpu.backend.pose_gn_pallas import pose_only_fast_pallas
from airslam_tpu.core import lie as jlie
from airslam_tpu_torch.backend import gn, pose_gn, windows
from airslam_tpu_torch.backend import residuals as res
from airslam_tpu_torch.core import lie
from airslam_tpu_torch.core.camera import Intrinsics
import chip_smoke
from tests.synthetic import default_intrinsics
from tests.test_pose_gn_pallas import _tracking_problem

torch.set_num_threads(2)
F64 = torch.float64


def _t(a, dtype=F64):
    return torch.as_tensor(np.array(a, np.float64)).to(dtype)


def _intr(jintr):
    return Intrinsics(*(float(getattr(jintr, k)) for k in ("fx", "fy", "cx", "cy", "bf")))


def _both(seed, dtype=jnp.float64, **kw):
    """The JAX tracking problem of tests/test_pose_gn_pallas.py and the
    port's copy of it (same numpy leaves)."""
    prob, jintr, twb_true = _tracking_problem(np.random.RandomState(seed), dtype=dtype, **kw)
    tdtype = F64 if dtype == jnp.float64 else torch.float32
    return prob, jintr, gn.problem_from_numpy(prob, dtype=tdtype), _intr(jintr), twb_true


# ---------------------------------------------------------------------------
# lie: 1e-12 in f64 (same formulas, same series switch)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [1e-6, 5e-5, 2e-4, 0.3, 2.5])
def test_so3_exp_log_vs_jax(scale):
    """Both sides of the ``_EPS = 1e-4`` series switch."""
    rng = np.random.RandomState(0)
    for _ in range(5):
        v = rng.randn(3)
        v = v / np.linalg.norm(v) * scale
        R = lie.so3_exp(_t(v))
        np.testing.assert_allclose(R.numpy(), np.asarray(jlie.so3_exp(jnp.asarray(v))),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(lie.so3_log(R).numpy(),
                                   np.asarray(jlie.so3_log(jnp.asarray(R.numpy()))),
                                   rtol=0, atol=1e-12)
    assert lie._EPS == jlie._EPS == 1e-4


def test_line_helpers_vs_jax():
    rng = np.random.RandomState(1)
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.randn(3) * 0.4)))
    t = rng.randn(3)
    p1, p2 = rng.randn(3) + [0, 0, 5], rng.randn(3) + [0, 0, 6]
    line = np.asarray(jlie.line_from_endpoints(jnp.asarray(p1), jnp.asarray(p2)))
    np.testing.assert_allclose(lie.line_from_endpoints(_t(p1), _t(p2)).numpy(), line,
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        lie.line_transform(_t(R), _t(t), _t(line)).numpy(),
        np.asarray(jlie.line_transform(jnp.asarray(R), jnp.asarray(t), jnp.asarray(line))),
        rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        lie.line_normalize(_t(line)).numpy(),
        np.asarray(jlie.line_normalize(jnp.asarray(line))), rtol=0, atol=1e-12)


def test_lie_module_vs_jax():
    """Every other function of the module on random inputs (1e-12; the
    quaternion round trip and the orthonormal line update included)."""
    rng = np.random.RandomState(4)
    v, t, p = rng.randn(3) * 0.5, rng.randn(3), rng.randn(3)
    R = np.asarray(jlie.so3_exp(jnp.asarray(v)))
    R2 = np.asarray(jlie.so3_exp(jnp.asarray(rng.randn(3) * 0.3)))
    line = np.asarray(jlie.line_from_endpoints(jnp.asarray(p), jnp.asarray(p + rng.randn(3))))
    q = np.asarray(jlie.rot_to_quat(jnp.asarray(R)))
    cases = {
        "hat": (v,), "so3_right_jacobian": (v,), "so3_right_jacobian_inv": (v,),
        "normalize_rotation": (R + 1e-3 * rng.randn(3, 3),), "se3_matrix": (R, t),
        "se3_inverse": (R, t), "se3_compose": (R, t, R2, p), "se3_apply": (R, t, p),
        "quat_to_rot": (q,), "rot_to_quat": (R,), "line_to_cartesian": (line,),
        "line_orthonormal_oplus": (line, rng.randn(4) * 0.1), "line_point_distance": (line, p),
    }
    small = rng.randn(3)
    small *= 5e-5 / np.linalg.norm(small)
    for name, args in list(cases.items()) + [("so3_right_jacobian", (small,)),
                                              ("so3_right_jacobian_inv", (small,))]:
        want = getattr(jlie, name)(*(jnp.asarray(a) for a in args))
        got = getattr(lie, name)(*(_t(a) for a in args))
        if not isinstance(want, tuple):
            want, got = (want,), (got,)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12, err_msg=name)
    np.testing.assert_allclose(lie.vee(lie.hat(_t(v))).numpy(), v, atol=0)


# ---------------------------------------------------------------------------
# residuals: 1e-10 in f64, the guards hit on purpose
# ---------------------------------------------------------------------------


def test_point_residual_vs_jax_with_depth_guard():
    jintr = default_intrinsics(jnp.float64)
    intr = _intr(jintr)
    rng = np.random.RandomState(2)
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.randn(3) * 0.1)))
    t = rng.randn(3) * 0.1
    obs = np.array([300.0, 200.0, 290.0])
    # an ordinary point under a general pose; then, under the identity pose
    # (so that z is exact), one on the camera plane (|z| < 1e-9 → 1e-9), one
    # just inside the guard on either side and one just outside it
    cases = [(R, t, rng.randn(3) + [0, 0, 6])]
    for z in (0.0, 5e-10, -5e-10, 2e-9):
        cases.append((np.eye(3), np.zeros(3), np.array([0.3, -0.2, z])))
    for R, t, p in cases:
        want_r, want_z = jres.point_residual(jnp.asarray(R), jnp.asarray(t), jnp.asarray(p),
                                             jnp.asarray(obs), jintr)
        got_r, got_z = res.point_residual(_t(R), _t(t), _t(p), _t(obs), intr)
        np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(got_z.numpy(), np.asarray(want_z), rtol=0, atol=1e-12)


def test_line_residual_vs_jax_with_norm_guard():
    jintr = default_intrinsics(jnp.float64)
    intr = _intr(jintr)
    rng = np.random.RandomState(3)
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.randn(3) * 0.1)))
    t = rng.randn(3) * 0.1
    obs8 = rng.rand(8) * 400
    q, d = rng.randn(3) + [0, 0, 6], rng.randn(3)
    d /= np.linalg.norm(d)
    lines = [np.concatenate([np.cross(q, d), d])]
    # a line whose camera-frame moment is along z: l0 = l1 = 0, the guarded
    # norm 1e-12 divides (identity pose, w = (0, 0, 1), d = (1, 0, 0))
    guard_pose = (np.eye(3), np.zeros(3))
    lines.append(np.array([0.0, 0.0, 1.0, 1.0, 0.0, 0.0]))
    for i, line in enumerate(lines):
        Ri, ti = (R, t) if i == 0 else guard_pose
        want = jres.line_residual(jnp.asarray(Ri), jnp.asarray(ti), jnp.asarray(line),
                                  jnp.asarray(obs8), jintr)
        got = res.line_residual(_t(Ri), _t(ti), _t(line), _t(obs8), intr)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-10)
    assert float(got.abs().max()) > 1e6  # the guard was the divisor


def test_imu_and_relative_pose_residuals_vs_jax():
    """The two residuals carried for the later slices (1e-10)."""
    rng = np.random.RandomState(8)
    rot = lambda s: np.asarray(jlie.so3_exp(jnp.asarray(rng.randn(3) * s)))
    args = [rot(0.3), rng.randn(3), rng.randn(3), rot(0.3), rng.randn(3), rng.randn(3),
            rng.randn(3) * 0.01, rng.randn(3) * 0.01, rot(0.1), rng.randn(3), rng.randn(3)]
    args += [rng.randn(3, 3) * 0.1 for _ in range(5)]
    args += [rng.randn(3) * 0.01, rng.randn(3) * 0.01]
    Rwg = rot(0.05)
    want = jres.imu_residual(*(jnp.asarray(a) for a in args), 0.05, jnp.asarray(Rwg), 9.81)
    got = res.imu_residual(*(_t(a) for a in args), 0.05, _t(Rwg), 9.81)
    assert tuple(got.shape) == (9,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-10)
    rel = [args[0], args[1], args[3], args[4], args[8], args[9]]
    np.testing.assert_allclose(
        res.relative_pose_residual(*(_t(a) for a in rel)).numpy(),
        np.asarray(jres.relative_pose_residual(*(jnp.asarray(a) for a in rel))),
        rtol=0, atol=1e-10)


def test_huber_weight_and_cost_vs_jax():
    chi2 = np.array([0.0, 1e-14, 10.0, 50.0, 50.0001, 400.0])
    d2 = np.full(6, 50.0)
    np.testing.assert_allclose(res.huber_weight(_t(chi2), _t(d2)).numpy(),
                               np.asarray(jres.huber_weight(jnp.asarray(chi2), jnp.asarray(d2))),
                               rtol=0, atol=1e-12)
    active = np.array([True, True, False, True, True, True])
    np.testing.assert_allclose(
        float(gn._huber_cost(_t(chi2), _t(d2), torch.as_tensor(active))),
        float(jgn._huber_cost(jnp.asarray(chi2), jnp.asarray(d2), jnp.asarray(active))),
        rtol=1e-12)


# ---------------------------------------------------------------------------
# solve_spd_small
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [3, 6, 9])
def test_solve_spd_small_vs_jax(n):
    """The unrolled Cholesky: the JAX one's arithmetic in its order (1e-12
    relative), and a true solve (1e-9 against numpy)."""
    rng = np.random.RandomState(n)
    A = rng.randn(n, n)
    H = A @ A.T + 0.5 * np.eye(n)
    b = rng.randn(n)
    got = gn.solve_spd_small(_t(H), _t(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(jgn.solve_spd_small(jnp.asarray(H), jnp.asarray(b))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, np.linalg.solve(H, b), rtol=1e-9, atol=1e-9)


def test_jac_with_value():
    def f(d):
        return torch.stack([d[0] * d[1] + 2.0 * d[2], torch.sin(d[0])]), d.sum()

    J, (value, aux) = gn._jac_with_value(f, 3, dtype=F64)
    np.testing.assert_allclose(J.numpy(), [[0.0, 0.0, 2.0], [1.0, 0.0, 0.0]], atol=1e-15)
    assert value.shape == (2,) and float(aux) == 0.0


# ---------------------------------------------------------------------------
# the pose Jacobians: autodiff port vs JAX (1e-8), analytic vs autodiff
# ---------------------------------------------------------------------------


def _with_guards(prob):
    """The problem with one point on the camera plane of the initial pose and
    one line whose image line has zero norm: both guards are hit and carry
    their derivative choice (0)."""
    pts = np.asarray(prob.points).copy()
    pts[0] = [0.4, -0.3, 0.0]
    lines = np.asarray(prob.lines).copy()
    lines[0] = [0.0, 0.0, 1.0, 1.0, 0.0, 0.0]
    return prob._replace(points=jnp.asarray(pts), lines=jnp.asarray(lines))


def test_pose6_residuals_jacobians_vs_jax():
    prob, jintr, ours, intr, _ = _both(5)
    prob = _with_guards(prob)
    ours = gn.problem_from_numpy(prob, dtype=F64)
    R0, t0 = prob.frames.Rwb[0], prob.frames.twb[0]
    want = jwindows._pose6_residuals(prob, jintr, R0, t0, True)
    got = windows._pose6_residuals(ours, intr, ours.frames.Rwb[0], ours.frames.twb[0], True)
    # with Jacobians the JAX function hands back (residual, depth) in the
    # depth's place; the depth itself is its second entry
    want = (want[0], want[1][1]) + tuple(want[2:])
    for g, w, name in zip(got, want, ("pr", "pz", "pJ", "lr", "lJ")):
        w = np.asarray(w)
        assert g.dtype == F64 and tuple(g.shape) == w.shape, name
        # relative to the entry's size: the guarded rows are ~1e12
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-8, atol=1e-8, err_msg=name)
    assert np.isfinite(got[2].numpy()).all() and np.isfinite(got[4].numpy()).all()
    no_jac = windows._pose6_residuals(ours, intr, ours.frames.Rwb[0], ours.frames.twb[0], False)
    np.testing.assert_array_equal(no_jac[0].numpy(), got[0].numpy())
    assert float(no_jac[2].abs().max()) == 0.0


@pytest.mark.parametrize("guards", [False, True])
def test_analytic_normal_equations_vs_autodiff(guards):
    """The plain version's analytic H and b against the same sums over the
    ``jacfwd`` Jacobians, at a pose off the identity, Huber weights on
    (1e-9 relative to the largest entry)."""
    prob, _, ours, intr, _ = _both(6)
    if guards:
        ours = gn.problem_from_numpy(_with_guards(prob), dtype=F64)
    cfg = gn.BAConfig()
    R = ours.frames.Rwb[0] if guards else lie.so3_exp(_t([0.01, -0.02, 0.015]))
    t = ours.frames.twb[0] if guards else _t([0.03, 0.01, -0.02])
    vis = pose_gn._Vision(ours, intr, cfg)
    p_m = ours.point_obs_mask[:, 0].to(F64)
    l_m = ours.line_obs_mask[:, 0].to(F64)
    H, b = vis.normal_equations(R, t, p_m, l_m)

    pr, _, pJ, lr, lJ = windows._pose6_residuals(ours, intr, R, t, True)
    prow, lrow = vis.rows(p_m, l_m)
    pw = res.huber_weight((pr * pr * prow).sum(-1), vis.pthr) * p_m
    lw = res.huber_weight((lr * lr * lrow).sum(-1) * vis.lsig, vis.lthr) * l_m * vis.lsig
    pJ, lJ = pJ * prow[..., None], lJ * lrow[..., None]
    H_ad = (torch.einsum("k,kri,krj->ij", pw, pJ, pJ) + torch.einsum("k,kri,krj->ij", lw, lJ, lJ))
    b_ad = -(torch.einsum("k,kri,kr->i", pw, pJ, pr * prow)
             + torch.einsum("k,kri,kr->i", lw, lJ, lr * lrow))
    assert torch.isfinite(H).all() and torch.isfinite(b).all()
    np.testing.assert_allclose(H.numpy(), H_ad.numpy(), rtol=0, atol=1e-9 * float(H_ad.abs().max()))
    np.testing.assert_allclose(b.numpy(), b_ad.numpy(), rtol=0, atol=1e-9 * float(b_ad.abs().max()))


# ---------------------------------------------------------------------------
# the solvers
# ---------------------------------------------------------------------------


def _assert_pose(out, ref, r_tol, t_tol):
    np.testing.assert_allclose(out.frames.Rwb[0].numpy(), np.asarray(ref.frames.Rwb[0]),
                               rtol=0, atol=r_tol)
    np.testing.assert_allclose(out.frames.twb[0].numpy(), np.asarray(ref.frames.twb[0]),
                               rtol=0, atol=t_tol)


def _assert_inliers(got, want):
    (pin, lin, n), (pin_r, lin_r, n_r) = got, want
    assert (pin.numpy() == np.asarray(pin_r)).all()
    assert (lin.numpy() == np.asarray(lin_r)).all()
    assert int(n) == int(n_r)


@pytest.fixture(scope="module")
def scan_f64():
    """The JAX scan solver's f64 result on the seed-5 problem."""
    prob, jintr, ours, intr, twb_true = _both(5)
    ref = jwindows._pose_only_fast(prob, jintr, jgn.BAConfig(), rounds=3, iters=10)
    return ref, ours, intr, twb_true


def test_pose_only_fast_port_vs_jax_f64(scan_f64):
    """The autodiff solver, port vs JAX, in f64: the same arithmetic up to
    summation order (R 1e-6, t 1e-6, equal inliers)."""
    (ref, pin_r, lin_r, n_r), ours, intr, twb_true = scan_f64
    out, pin, lin, n = windows._pose_only_fast(ours, intr, gn.BAConfig(), rounds=3, iters=10)
    _assert_pose(out, ref, 1e-6, 1e-6)
    _assert_inliers((pin, lin, n), (pin_r, lin_r, n_r))
    assert np.linalg.norm(out.frames.twb[0].numpy() - twb_true) < 5e-3


def test_plain_vs_jax_scan_f64(scan_f64):
    """The plain version of the kernel (analytic Jacobians) in f64 against
    the JAX scan solver (jacfwd): the gate of the Pallas kernel's own test
    (R 1e-4, t 1e-3, equal inliers)."""
    (ref, pin_r, lin_r, n_r), ours, intr, twb_true = scan_f64
    out, pin, lin, n = pose_gn.pose_only_fast_plain(ours, intr, gn.BAConfig(), rounds=3, iters=10)
    _assert_pose(out, ref, 1e-4, 1e-3)
    _assert_inliers((pin, lin, n), (pin_r, lin_r, n_r))
    assert np.linalg.norm(out.frames.twb[0].numpy() - twb_true) < 5e-3


def test_plain_f32_vs_pallas_interpret():
    """The plain version in f32 against the Pallas kernel in interpret mode
    on the same f32 problem (R 1e-4, t 1e-3, equal inliers): f32 sums in
    another order."""
    prob, jintr, ours, intr, twb_true = _both(5, dtype=jnp.float32)
    ref, pin_r, lin_r, n_r = pose_only_fast_pallas(prob, jintr, jgn.BAConfig(), rounds=3,
                                                   iters=10, interpret=True)
    out, pin, lin, n = pose_gn.pose_only_fast_plain(ours, intr, gn.BAConfig(), rounds=3, iters=10)
    assert out.frames.Rwb.dtype == torch.float32
    _assert_pose(out, ref, 1e-4, 1e-3)
    _assert_inliers((pin, lin, n), (pin_r, lin_r, n_r))
    assert np.linalg.norm(out.frames.twb[0].numpy() - twb_true) < 5e-3


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_plain_fixed_pose_is_unchanged(dtype):
    """``pose_free`` multiplies every Jacobian column: a fixed pose comes
    back bit-unchanged."""
    prob, _, _, intr, _ = _both(7, outliers=False)
    ours = gn.problem_from_numpy(prob._replace(pose_fixed=jnp.asarray([True])), dtype=dtype)
    out, _, _, n = pose_gn.pose_only_fast_plain(ours, intr, gn.BAConfig(), rounds=1, iters=3)
    assert torch.equal(out.frames.Rwb, ours.frames.Rwb)
    assert torch.equal(out.frames.twb, ours.frames.twb)
    assert int(n) > 0


def test_plain_lines_only_vs_jax():
    """No active point, lines only (t 1e-3, equal line inliers)."""
    prob, jintr, _, intr, _ = _both(11, K=1, M=24, outliers=False)
    prob = prob._replace(point_obs_mask=jnp.zeros_like(prob.point_obs_mask))
    ours = gn.problem_from_numpy(prob, dtype=F64)
    ref, _, lin_r, _ = jwindows._pose_only_fast(prob, jintr, jgn.BAConfig(), rounds=2, iters=8)
    out, pin, lin, n = pose_gn.pose_only_fast_plain(ours, intr, gn.BAConfig(), rounds=2, iters=8)
    _assert_pose(out, ref, 1e-4, 1e-3)
    assert (lin.numpy() == np.asarray(lin_r)).all()
    assert not pin.any() and int(n) == int(lin.sum()) > 0


# ---------------------------------------------------------------------------
# kernel P's schedule: one pass over the rows per evaluated pose
# ---------------------------------------------------------------------------


def _fused_schedule(problem, intr, cfg, rounds, iters):
    """Kernel P's order of work in plain tensor ops: at every pose the solve
    evaluates, the robust cost and the undamped H, b come from one pass; an
    accepted trial hands its H, b to the next iteration, a rejected one keeps
    the previous H, b (the same pose, so the same numbers). The damping, the
    solve, the retraction, the accept and the relabel are the plain
    version's."""
    dtype = problem.points.dtype
    vis = pose_gn._Vision(problem, intr, cfg)
    p_base = problem.point_obs_mask[:, 0].to(dtype)
    l_base = problem.line_obs_mask[:, 0].to(dtype)
    R0, t0 = problem.frames.Rwb[0], problem.frames.twb[0]
    eye6 = torch.eye(6, dtype=dtype)
    p_m, l_m = p_base, l_base
    R, t = R0, t0
    passes = 0
    for _ in range(rounds):
        R, t = R0, t0
        lam = torch.full((), windows.POSE_LM_LAM0, dtype=dtype)
        nu = torch.full((), windows.POSE_LM_NU0, dtype=dtype)
        cost, (H, b) = vis.cost_of(R, t, p_m, l_m), vis.normal_equations(R, t, p_m, l_m)
        passes += 1
        for _ in range(iters):
            Hd = H + lam * eye6
            Hd = Hd + torch.diag((torch.diagonal(Hd) < 1e-10).to(dtype))
            dx = gn.solve_spd_small(Hd, b)
            R2, t2 = R @ lie.so3_exp(dx[0:3]), t + R @ dx[3:6]
            cost2, (H2, b2) = vis.cost_of(R2, t2, p_m, l_m), vis.normal_equations(R2, t2, p_m, l_m)
            passes += 1
            if bool(cost2 < cost):
                R, t, cost, H, b = R2, t2, cost2, H2, b2
                lam, nu = lam / 3.0, torch.full_like(nu, 2.0)
            else:
                lam, nu = lam * nu, nu * 2.0
        pchi2, lchi2, pz = vis.chi2_of(R, t, p_base, l_base)
        p_m = ((pchi2 <= vis.pthr) & (pz > 0) & (p_base > 0.5)).to(dtype)
        l_m = ((lchi2 <= vis.lthr) & (l_base > 0.5)).to(dtype)
    p_in, l_in = p_m > 0.5, l_m > 0.5
    out = problem._replace(frames=problem.frames._replace(Rwb=R[None], twb=t[None]))
    # the kernel's chain: one reduction per pass and the final count
    return (out, p_in[:, None], l_in[:, None], p_in.sum() + l_in.sum()), passes + 1


def _jax_problem(problem):
    """The JAX package's BAProblem with the same (numpy) leaves."""
    frames = jgn.FrameStates(*(jnp.asarray(getattr(problem.frames, n).numpy())
                               for n in jgn.FrameStates._fields))
    leaves = {n: jnp.asarray(getattr(problem, n).numpy()) for n in jgn.BAProblem._fields
              if n not in ("frames", "imu", "g_value")}
    return jgn.BAProblem(frames=frames, imu=None, **leaves)


@pytest.mark.parametrize("case", ["full", "path", "lines_only"])
def test_fused_schedule_equals_plain_and_jax(case):
    """The schedule kernel P runs (rounds·(iters+1)+1 reductions) gives the
    plain version's poses, inlier flags and counts in f64 (the same
    arithmetic: ≤ 1e-12), and holds the JAX scan solver's gate (R 1e-4,
    t 1e-3, equal inliers) on chip_smoke.py's problems: the kernel's full
    size, the path's shape (200 points padded to 256, one masked line) and
    lines only."""
    rounds, iters = 3, 10
    if case == "full":
        problem, intr, _ = chip_smoke.tracking_problem(5, 512, 128, dtype=F64)
    elif case == "path":
        problem, intr, _ = chip_smoke.tracking_problem(6, 200, 1, n_masked_points=56,
                                                       mask_lines=True, dtype=F64)
    else:
        problem, intr, _ = chip_smoke.tracking_problem(11, 1, 24, outliers=False, dtype=F64)
        problem = problem._replace(point_obs_mask=torch.zeros_like(problem.point_obs_mask))
        rounds, iters = 2, 8
    cfg = gn.BAConfig()
    got, links = _fused_schedule(problem, intr, cfg, rounds, iters)
    assert links == rounds * (iters + 1) + 1
    want = pose_gn.pose_only_fast_plain(problem, intr, cfg, rounds=rounds, iters=iters)
    for g, w in ((got[0].frames.Rwb, want[0].frames.Rwb), (got[0].frames.twb, want[0].frames.twb)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-12)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert int(got[3]) == int(want[3]) > 0

    ref = jwindows._pose_only_fast(_jax_problem(problem), default_intrinsics(jnp.float64),
                                   jgn.BAConfig(), rounds=rounds, iters=iters)
    _assert_pose(got[0], ref[0], 1e-4, 1e-3)
    _assert_inliers(tuple(got[1:]), tuple(ref[1:]))


# ---------------------------------------------------------------------------
# dispatch and containers
# ---------------------------------------------------------------------------


def test_pose_only_optimization_dispatch():
    """A CPU problem with one frame runs the kernel's plain version, one with
    two frames the general dense solver, and the VI tracking layout the F=2
    VI solve."""
    _, _, ours, intr, _ = _both(5)
    launches = pose_gn.pose_only_fast.launches
    got = windows.pose_only_optimization(ours, intr, gn.BAConfig())
    want = pose_gn.pose_only_fast_plain(ours, intr, gn.BAConfig())
    assert torch.equal(got[0].frames.twb, want[0].frames.twb)
    assert torch.equal(got[1], want[1]) and int(got[3]) == int(want[3])
    assert pose_gn.pose_only_fast.launches == launches  # no kernel launch on the CPU

    two = ours._replace(frames=gn.FrameStates(*(torch.cat([a, a]) for a in ours.frames)))
    def pad(t):  # a second frame that observes nothing
        return torch.cat([t, torch.zeros_like(t)], dim=1)

    out2 = windows.pose_only_optimization(two._replace(
        pose_fixed=torch.tensor([False, True]), vel_fixed=torch.ones(2, dtype=torch.bool),
        point_obs=pad(ours.point_obs), point_obs_mask=pad(ours.point_obs_mask),
        line_obs=pad(ours.line_obs), line_obs_stereo=pad(ours.line_obs_stereo),
        line_obs_mask=pad(ours.line_obs_mask),
        line_obs_sigma=torch.cat([ours.line_obs_sigma] * 2, dim=1)), intr)
    assert out2[1].shape == (ours.points.shape[0], 2) and int(out2[3]) == int(want[3])
    assert float((out2[0].frames.twb[0] - want[0].frames.twb[0]).abs().max()) < 1e-6
    # the VI tracking layout (F=2, one IMU factor, frame 0 fixed) goes to the
    # 15×15 solve, a problem with no IMU factor is refused for that solve
    from tests.test_vio import _tiny_vi_problem

    vi = gn.problem_from_numpy(_tiny_vi_problem([True, False], [True, False])[0], F64)
    got_vi = windows.pose_only_optimization(vi, intr)
    want_vi = windows._pose_only_fast_vi(vi, intr, gn.BAConfig(), rounds=3, iters=10)
    assert torch.equal(got_vi[0].frames.twb, want_vi[0].frames.twb)
    assert torch.equal(got_vi[0].frames.vel, want_vi[0].frames.vel)
    assert int(got_vi[3]) == int(want_vi[3]) > 0
    assert pose_gn.pose_only_fast.launches == launches
    with pytest.raises(ValueError, match="exactly one IMU factor"):
        windows.pose_only_optimization(vi._replace(imu=None), intr, vi_tracking=True)
    with pytest.raises(ValueError, match="F=1"):
        pose_gn.pose_only_fast(two, intr)
    assert (windows.POSE_LM_LAM0, windows.POSE_LM_NU0) == (jwindows.POSE_LM_LAM0,
                                                           jwindows.POSE_LM_NU0)


def test_problem_from_numpy_carries_every_leaf():
    prob, _, ours, _, _ = _both(5)
    for name in gn.BAProblem._fields:
        if name in ("frames", "imu", "g_value"):
            continue
        want = np.asarray(getattr(prob, name))
        got = getattr(ours, name)
        assert got.dtype == (torch.bool if want.dtype == bool else F64), name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    for name in gn.FrameStates._fields:
        np.testing.assert_array_equal(getattr(ours.frames, name).numpy(),
                                      np.asarray(getattr(prob.frames, name)))
    assert ours.imu is None and ours.g_value == float(prob.g_value)
    assert gn.BAConfig() == tuple(jgn.BAConfig())
