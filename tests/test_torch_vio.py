"""The port's stereo-inertial path against the JAX package's on the CPU, in
float64 on both sides: the IMU factors of the window backend
(``backend/gn.py``), the F=2 VI tracking solve, the IMU initialization and
its closed-form seeds (``backend/windows.py``), and both ``MapBuilder``s
over a visual-inertial feature stream (tests/test_vio.py's trajectory and
world, cut to the shortest stream that initializes the IMU). The problems
are the numpy-seeded ones of tests/test_vio.py; each test states its
tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airslam_tpu.backend import gn as jgn
from airslam_tpu.backend import windows as jwindows
from airslam_tpu.core.imu import ImuData as JImuData
from airslam_tpu.pipelines.map_builder import KeyframeConfig as JKeyframeConfig
from airslam_tpu.pipelines.map_builder import MapBuilder as JMapBuilder
from airslam_tpu.slam.landmarks import Mapline as JMapline
from airslam_tpu_torch.backend import gn, windows
from airslam_tpu_torch.core.camera import Intrinsics
from airslam_tpu_torch.core.imu import ImuData
from airslam_tpu_torch.pipelines.map_builder import KeyframeConfig, MapBuilder
from airslam_tpu_torch.slam.landmarks import Mapline
from tests import test_vio as jvio
from tests import test_vo_pipeline as jvo
from tests.synthetic import default_intrinsics, make_imu_sequence
from tests.test_torch_map import POSE_TOL, Camera, Matcher

torch.set_num_threads(2)
F64 = torch.float64
G = 9.81


def _intr(jintr):
    return Intrinsics(*(float(getattr(jintr, k)) for k in ("fx", "fy", "cx", "cy", "bf")))


def _gap(a, b):
    return float(np.abs(np.asarray(a, np.float64) - b.double().numpy()).max())


def _rel_gap(a, b):
    """The gap relative to the reference's largest entry where that exceeds 1."""
    return _gap(a, b) / max(1.0, float(np.abs(np.asarray(a, np.float64)).max()))


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _window_problem(seed=0):
    """tests/test_vio.py::test_local_ba_with_imu_factors's window: 3 s of the
    analytic trajectory, keyframes every 0.75 s with noisy velocities, the
    poses fixed, plus a few observed points so the vision blocks are not
    empty; gravity free."""
    seq = make_imu_sequence(duration=3.0)
    kf_idx, preints = jvio._keyframe_preints(seq, 150)
    f = len(kf_idx)
    rng = np.random.RandomState(seed)
    rows = []
    for k, p in enumerate(preints):
        cov = np.asarray(p.state.cov)
        walk = np.zeros((6, 6))
        walk[:3, :3] = np.linalg.inv(cov[9:12, 9:12] + 1e-9 * np.eye(3))
        walk[3:, 3:] = np.linalg.inv(cov[12:15, 12:15] + 1e-9 * np.eye(3))
        rows.append((k, k + 1, p.state, np.linalg.inv(cov[:9, :9] + 1e-12 * np.eye(9)), walk))

    def stack(key):
        return jnp.stack([getattr(r[2], key) for r in rows])

    imu = jgn.IMUFactors(
        idx_i=jnp.asarray([r[0] for r in rows], jnp.int32),
        idx_j=jnp.asarray([r[1] for r in rows], jnp.int32),
        dR=stack("dR"), dV=stack("dV"), dP=stack("dP"), JRg=stack("JRg"), JVg=stack("JVg"),
        JVa=stack("JVa"), JPg=stack("JPg"), JPa=stack("JPa"),
        bg_lin=jnp.asarray(rng.randn(len(rows), 3) * 1e-3), ba_lin=jnp.zeros((len(rows), 3)),
        dT=stack("dT"), info=jnp.asarray(np.stack([r[3] for r in rows])),
        info_walk=jnp.asarray(np.stack([r[4] for r in rows])),
        mask=jnp.asarray([True] * (len(rows) - 1) + [False]))
    P = 16
    intr = default_intrinsics()
    pts = rng.randn(P, 3) + [0, 0, 6]
    obs = np.zeros((P, f, 3))
    obs[..., 2] = -1.0
    obs[..., 0] = 376.0 + rng.randn(P, f) * 50
    obs[..., 1] = 240.0 + rng.randn(P, f) * 50
    mask = rng.rand(P, f) < 0.5
    frames = jgn.FrameStates(
        Rwb=jnp.asarray(seq["Rwb"][kf_idx]), twb=jnp.asarray(seq["pos"][kf_idx]),
        vel=jnp.asarray(seq["vel"][kf_idx] + rng.randn(f, 3) * 0.3),
        bg=jnp.asarray(rng.randn(f, 3) * 1e-3), ba=jnp.zeros((f, 3)))
    pose_fixed = np.zeros(f, bool)
    pose_fixed[0] = True
    vel_fixed = np.zeros(f, bool)
    vel_fixed[-1] = True
    prob = jgn.BAProblem(
        frames=frames, pose_fixed=jnp.asarray(pose_fixed), vel_fixed=jnp.asarray(vel_fixed),
        points=jnp.asarray(pts), point_fixed=jnp.zeros(P, bool),
        point_obs=jnp.asarray(obs), point_obs_mask=jnp.asarray(mask),
        lines=jnp.asarray([[1.0, 0, 0, 0, 1.0, 0]]), line_fixed=jnp.ones(1, bool),
        line_obs=jnp.zeros((1, f, 8)), line_obs_stereo=jnp.zeros((1, f), bool),
        line_obs_mask=jnp.zeros((1, f), bool), line_obs_sigma=jnp.full((1, f), 1.0),
        Rwg=jnp.asarray(jwindows.gravity_to_rwg(jnp.asarray([0.05, -0.03, -1.0]))),
        gravity_free=jnp.asarray(1.0), imu=imu, Rcb=jnp.eye(3), tcb=jnp.zeros(3))
    return prob, intr, seq, kf_idx


def test_problem_from_numpy_carries_the_imu_factors():
    prob, _, _, _ = _window_problem()
    ours = gn.problem_from_numpy(prob, F64)
    for name in gn.IMUFactors._fields:
        want, got = np.asarray(getattr(prob.imu, name)), getattr(ours.imu, name)
        assert got.dtype == {"idx_i": torch.int64, "idx_j": torch.int64,
                             "mask": torch.bool}.get(name, F64), name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def test_imu_residuals_and_jacobians_vs_jax():
    """Residuals (K, 15) and Jacobians (K, 15, 32) to 1e-9: the same
    function under jacfwd on both sides; the factors are gathered before the
    map in the port."""
    prob, _, _, _ = _window_problem()
    ours = gn.problem_from_numpy(prob, F64)
    want_r, want_J = jax.jit(jgn.imu_residuals, static_argnums=(3,))(
        prob.frames, prob.imu, prob.Rwg, True, G)
    got_r, got_J = gn.imu_residuals(ours.frames, ours.imu, ours.Rwg, True, G)
    assert got_J.shape == np.asarray(want_J).shape == (4, 15, 32)
    assert _gap(want_r, got_r) <= 1e-9 and _gap(want_J, got_J) <= 1e-9
    r_only, none = gn._imu_residuals(ours, False)
    assert none is None and torch.equal(r_only, got_r)
    # g is per-problem state: the moon's gravity moves the residual
    moon, _ = gn.imu_residuals(ours.frames, ours.imu, ours.Rwg, False, 1.62)
    assert float((moon - got_r).abs().max()) > 1e-3


def _step_and_system(module, *args, **kw):
    """``module._assemble_and_solve(*args)`` and the damped system (H, b) it
    hands to its dense solve (``module.solve_spd``, wrapped for the call)."""
    seen, solve = {}, module.solve_spd

    def wrapped(H, b):
        seen["H"], seen["b"] = H, b
        return solve(H, b)

    module.solve_spd = wrapped
    try:
        return module._assemble_and_solve(*args, **kw), seen["H"], seen["b"]
    finally:
        module.solve_spd = solve


# the JAX reference compiled whole (one XLA program instead of one per
# operation): the same arithmetic, a fraction of the CPU time
_jax_step = jax.jit(lambda *args, robust: _step_and_system(jgn, *args, robust),
                    static_argnames=("robust",))


def _both_steps(prob, intr, lam, robust):
    want = _jax_step(prob, intr, jgn.BAConfig(), lam, robust=robust)
    got = _step_and_system(gn, gn.problem_from_numpy(prob, F64), _intr(intr), gn.BAConfig(),
                           torch.tensor(lam, dtype=F64), robust)
    return want, got


@pytest.mark.parametrize("robust", [True, False])
def test_vi_assemble_and_solve_step_vs_jax(robust):
    """One damped VI step (frame blocks of 15, gravity border, the Huber on
    the IMU term, a masked factor, fixed pose/velocity columns). The window's
    damped system (H, b) equals the JAX one to 1e-13 of its largest entry.
    Its bias random-walk information (about 7e7, from the noise floors) makes
    H's condition number about 2e11, so f64 solves of the same system by two
    Cholesky codes differ by up to 5e-7; the step itself is held to 1e-8 on
    the same window with that information scaled by 1e-4 (condition about
    3e8), relative to the largest entry where that exceeds 1, as are the
    candidate's states after ``apply_update``; the costs to 1e-8 relative."""
    prob, intr, _, _ = _window_problem()
    lam = 1e-3
    (_, jH, jb), (_, tH, tb) = _both_steps(prob, intr, lam, robust)
    jH, jb, tH, tb = np.asarray(jH), np.asarray(jb), tH.numpy(), tb.numpy()
    assert tH.shape == jH.shape == (5 * 15 + 2, 5 * 15 + 2)
    assert np.abs(tH - jH).max() <= 1e-13 * np.abs(jH).max()
    assert np.abs(tb - jb).max() <= 1e-13 * np.abs(jb).max()

    prob = prob._replace(imu=prob.imu._replace(info_walk=prob.imu.info_walk * 1e-4))
    (want, _, _), (got, _, _) = _both_steps(prob, intr, lam, robust)
    for w, g, name in zip(want, got, ("dx_frames", "dg", "dp", "dl")):
        assert g.shape == np.asarray(w).shape, name
        assert _rel_gap(w, g) <= 1e-8, name
    assert float(got[0][0, :6].abs().max()) == 0.0  # the fixed pose does not move
    assert float(got[0][-1, 6:].abs().max()) == 0.0  # nor the fixed velocity/bias
    assert float(got[1].abs().max()) > 0  # gravity is free here
    ours, cfg = gn.problem_from_numpy(prob, F64), gn.BAConfig()
    c_want = float(jgn.total_cost(prob, intr, jgn.BAConfig(), robust))
    c_got = float(gn.total_cost(ours, _intr(intr), cfg, robust))
    assert abs(c_want - c_got) <= 1e-8 * abs(c_want)
    cand, jcand = gn.apply_update(ours, *got), jgn.apply_update(prob, *want)
    for name in gn.FrameStates._fields:
        assert _rel_gap(getattr(jcand.frames, name), getattr(cand.frames, name)) <= 1e-8, name
    assert _gap(jcand.Rwg, cand.Rwg) <= 1e-8


def test_optimize_with_imu_factors_vs_jax():
    """tests/test_vio.py::test_local_ba_with_imu_factors through both LM
    loops (15 non-robust iterations, information scale 1): velocities to
    1e-6, and the IMU pulls them to the truth as it does for the JAX one."""
    prob, intr, seq, kf_idx = _window_problem()
    prob = prob._replace(pose_fixed=jnp.ones(len(kf_idx), bool),
                         vel_fixed=jnp.zeros(len(kf_idx), bool),
                         point_obs_mask=jnp.zeros_like(prob.point_obs_mask),
                         gravity_free=jnp.asarray(0.0), Rwg=jnp.eye(3))
    cfg = jgn.BAConfig(imu_info_scale=1.0)
    want = jgn.optimize(prob, intr, cfg, 15, robust=False)
    got = gn.optimize(gn.problem_from_numpy(prob, F64), _intr(intr),
                      gn.BAConfig(imu_info_scale=1.0), 15, robust=False)
    assert _gap(want.frames.vel, got.frames.vel) <= 1e-6
    assert _gap(want.frames.bg, got.frames.bg) <= 1e-9
    err = np.abs(got.frames.vel.numpy() - seq["vel"][kf_idx])[:-1].max()
    assert err < 0.05


def _vi_tracking_problem(seed=7):
    """tests/test_vio.py's tiny F=2 tracking problem, with biases on both
    frames (the test's are zero) so the random-walk rows carry weight."""
    prob, intr = jvio._tiny_vi_problem(pose_fixed=[True, False], vel_fixed=[True, False],
                                       seed=seed)
    rng = np.random.RandomState(seed + 100)
    frames = prob.frames._replace(bg=jnp.asarray(rng.randn(2, 3) * 1e-3),
                                  ba=jnp.asarray(rng.randn(2, 3) * 1e-2))
    return prob._replace(frames=frames), intr


@pytest.mark.parametrize("seed", [3, 7])
def test_pose_only_fast_vi_vs_jax_and_general(seed):
    """The F=2 VI solve (15 dof, frame 0 fixed) against the JAX one to 1e-8
    and against the port's general dense solver to 1e-8, with equal inlier
    flags and counts."""
    prob, jintr = _vi_tracking_problem(seed)
    ours, intr = gn.problem_from_numpy(prob, F64), _intr(jintr)
    want = jwindows.pose_only_optimization(prob, jintr)
    got = windows.pose_only_optimization(ours, intr)
    general = windows._pose_only_general(ours, intr)
    for name in gn.FrameStates._fields:
        assert _gap(getattr(want[0].frames, name), getattr(got[0].frames, name)) <= 1e-8, name
        g, w = getattr(got[0].frames, name)[1], getattr(general[0].frames, name)[1]
        assert float((g - w).abs().max()) <= 1e-8, name
    assert got[1].shape == (16, 2) and not bool(got[1][:, 0].any())
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[3]) == int(want[3]) == int(general[1][:, 1].sum())
    assert torch.equal(got[1][:, 1], general[1][:, 1])


def test_vi_dispatch_and_the_vi_tracking_flag():
    """``vi_tracking``: True selects the 15×15 solver without reading the fix
    pattern (the same result as inspecting it), False forces the general
    solver, True on a problem without the VI shape raises; a non-tracking
    fix pattern inspected goes to the general solver."""
    prob, jintr = _vi_tracking_problem(3)
    ours, intr = gn.problem_from_numpy(prob, F64), _intr(jintr)
    auto = windows.pose_only_optimization(ours, intr)
    flag = windows.pose_only_optimization(ours, intr, vi_tracking=True)
    assert torch.equal(auto[0].frames.twb, flag[0].frames.twb)
    forced = windows.pose_only_optimization(ours, intr, vi_tracking=False)
    general = windows._pose_only_general(ours, intr)
    assert torch.equal(forced[0].frames.twb, general[0].frames.twb)
    with pytest.raises(ValueError, match="F=2 with exactly one IMU factor"):
        windows.pose_only_optimization(ours._replace(imu=None), intr, vi_tracking=True)
    other, _ = jvio._tiny_vi_problem(pose_fixed=[False, True], vel_fixed=[False, True])
    other_t = gn.problem_from_numpy(other, F64)
    got = windows.pose_only_optimization(other_t, intr)
    want = windows._pose_only_general(other_t, intr)
    assert torch.equal(got[0].frames.twb, want[0].frames.twb)


# ---------------------------------------------------------------------------
# IMU initialization
# ---------------------------------------------------------------------------


def _init_inputs(bg_true=(0.01, -0.02, 0.015), ba_true=(0.05, -0.03, 0.08)):
    seq = make_imu_sequence(duration=6.0, bg=np.asarray(bg_true), ba=np.asarray(ba_true))
    kf_idx, preints = jvio._keyframe_preints(seq, 100)
    return seq, kf_idx, preints


def _stack(preints, key):
    return np.stack([np.asarray(getattr(p.state, key)) for p in preints])


def test_closed_form_seeds_vs_jax():
    """``compute_gyr_bias`` (1e-10), ``compute_velocity`` (velocities and
    gravity 1e-8: an SVD least squares on the JAX side, QR on the port's) and
    ``gravity_to_rwg`` (1e-12, and the identity for gravity along −z)."""
    seq, kf_idx, preints = _init_inputs()
    Rwb, twb = seq["Rwb"][kf_idx], seq["pos"][kf_idx]
    dR, JRg = _stack(preints, "dR"), _stack(preints, "JRg")
    want = jwindows.compute_gyr_bias(jnp.asarray(Rwb), jnp.asarray(dR), jnp.asarray(JRg))
    got = windows.compute_gyr_bias(_t(Rwb), _t(dR), _t(JRg))
    assert _gap(want, got) <= 1e-10 and np.allclose(got.numpy(), seq["bg"], atol=2e-3)
    dP, dV = _stack(preints, "dP"), _stack(preints, "dV")
    dT = np.asarray([p.dT for p in preints])
    jv, jg = jwindows.compute_velocity(*(jnp.asarray(a) for a in (Rwb, twb, dP, dV, dT)), G)
    tv, tg = windows.compute_velocity(*(_t(a) for a in (Rwb, twb, dP, dV, dT)), G)
    assert _gap(jv, tv) <= 1e-8 and _gap(jg, tg) <= 1e-8
    for g in (jg, jnp.asarray([0.3, -0.2, -9.7]), jnp.asarray([0.0, 0.0, -9.81])):
        assert _gap(jwindows.gravity_to_rwg(g), windows.gravity_to_rwg(_t(g))) <= 1e-12
    assert torch.equal(windows.gravity_to_rwg(_t([0.0, 0.0, -2.0])), torch.eye(3, dtype=F64))


def test_imu_initialization_vs_jax():
    """The 200-iteration GN over velocities, the shared bias pair and the
    gravity direction (tests/test_vio.py's weak-acc-prior case and the map's
    priors 1e2/1e5) to 1e-8, recovering the true biases as the JAX one."""
    seq, kf_idx, preints = _init_inputs()
    Rwb, twb = seq["Rwb"][kf_idx], seq["pos"][kf_idx]
    bg_seed = np.asarray(jwindows.compute_gyr_bias(
        jnp.asarray(Rwb), jnp.asarray(_stack(preints, "dR")), jnp.asarray(_stack(preints, "JRg"))))
    for p in preints:
        p.set_bias(bg_seed, np.zeros(3))
    dT = np.asarray([p.dT for p in preints])
    vels0, gravity = jwindows.compute_velocity(
        jnp.asarray(Rwb), jnp.asarray(twb), jnp.asarray(_stack(preints, "dP")),
        jnp.asarray(_stack(preints, "dV")), jnp.asarray(dT), G)
    Rwg0 = jwindows.gravity_to_rwg(gravity / jnp.linalg.norm(gravity))
    keys = ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa")
    infos = []
    for p in preints:
        inf = np.linalg.inv(np.asarray(p.state.cov)[:9, :9] + 1e-12 * np.eye(9))
        infos.append(0.5 * (inf + inf.T))
    jpre = {k: jnp.asarray(_stack(preints, k)) for k in keys}
    jpre.update(dT=jnp.asarray(dT), info=jnp.asarray(np.stack(infos)))
    tpre = {k: _t(v) for k, v in jpre.items()}
    runs = []
    for kw in ({"info_prior_acc": 1.0}, {}):
        want = jwindows.imu_initialization(
            jnp.asarray(Rwb), jnp.asarray(twb), vels0, jnp.asarray(bg_seed), jnp.zeros(3), Rwg0,
            jpre, G, jnp.asarray(bg_seed), jnp.zeros(3), **kw)
        runs.append(windows.imu_initialization(
            _t(Rwb), _t(twb), _t(vels0), _t(bg_seed), _t(np.zeros(3)), _t(Rwg0), tpre, G,
            _t(bg_seed), _t(np.zeros(3)), **kw))
        for w, g, name in zip(want, runs[-1], ("vels", "bg", "ba", "Rwg")):
            assert _gap(w, g) <= 1e-8, name
    # with the weak acc prior (the first case) the biases come out true
    got = runs[0]
    assert np.allclose(got[1].numpy(), seq["bg"], atol=2e-3)
    assert np.allclose(got[2].numpy(), seq["ba"], atol=0.02)
    assert np.allclose(got[0].numpy(), seq["vel"][kf_idx], atol=0.02)


# ---------------------------------------------------------------------------
# both builders over a visual-inertial feature stream
# ---------------------------------------------------------------------------

BG_TRUE = np.array([0.01, -0.015, 0.02])
STREAM_STRIDE = 60  # 200 Hz IMU rows per frame: one frame per 0.3 s
STREAM_FRAMES = 15  # ≥ 3 s and ≥ 10 keyframes initialize at frame 12; 2 VI frames follow
# a keyframe at every tracked frame (min_num_match above any match count)
STREAM_KF = dict(min_init_stereo_feature=40, min_num_match=1000, max_num_match=500,
                 tracking_point_rate=2.0)


def _imu_camera(cam):
    cam.use_imu = True
    cam.gyr_noise, cam.acc_noise = 1e-3, 1e-2
    cam.gyr_walk, cam.acc_walk = 1e-5, 1e-4
    return cam


def _vio_stream():
    """tests/test_vio.py::test_full_vio_pipeline's trajectory (8 s, the true
    gyro bias), world (600 points) and renders, one frame per 0.3 s."""
    seq = make_imu_sequence(duration=8.0, bg=BG_TRUE)
    rng = np.random.RandomState(5)
    pts = np.stack([rng.uniform(-4, 6, 600), rng.uniform(-3, 3, 600),
                    rng.uniform(3, 11, 600)], axis=-1)
    desc = rng.randn(600, 256).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    frames = []
    for n in range(STREAM_FRAMES):
        i = n * STREAM_STRIDE
        Twc = np.eye(4)
        Twc[:3, :3] = seq["Rwb"][i]
        Twc[:3, 3] = seq["pos"][i]
        frames.append((i, jvo.render_features(pts, desc, Twc, jvo.FakeCamera(), rng)))
    return seq, frames


def _run_stream(builder, seq, frames, imu_cls, mapline_cls=None):
    """The stream through ``track_features``. ``mapline_cls``: a mapline of
    this class is added after the first frame (the stream renders no lines),
    so the gravity alignment has a line to rotate. Returns the keyframe at
    which the IMU initialized."""
    times = seq["times"]
    rows = [imu_cls(times[i], seq["gyr"][i], seq["acc"][i]) for i in range(len(times))]
    init_at, last_i = None, 0
    for n, (i, (fl, fr, pairs)) in enumerate(frames):
        batch = rows[max(last_i - 1, 0): i + 2]
        builder.track_features(times[i], fl, fr, pairs, imu_batch=batch if n else None)
        if n == 0 and mapline_cls is not None:
            mpl = mapline_cls(10 ** 6)
            mpl.set_endpoints(np.array([1.0, -0.5, 6.0, 1.5, 0.8, 7.0]))
            mpl.add_observer(0, 0)
            builder.map.maplines[mpl.id] = mpl
        if builder.map.imu_initialized and init_at is None:
            init_at = builder.map.keyframe_ids[-1]
        last_i = i
    return init_at


def test_vi_builders_agree_over_a_feature_stream():
    """Both builders (descriptor-identity matcher, no networks) over the
    stream: the same keyframe ids, IMU initialization at the same keyframe
    (dropping the same keyframes before its init frame), every full-rate pose
    within POSE_TOL, and Rwg, every keyframe's velocity and biases and the
    landmark counts equal; the map after the gravity alignment too, a line
    added to both maps included. The port
    tracks its last frames with the F=2 VI solve (no kernel P launch needed
    on the CPU: the counts stay 0)."""
    from airslam_tpu_torch.backend import pose_gn

    seq, frames = _vio_stream()
    jb = JMapBuilder(_imu_camera(jvo.FakeCamera()), detector=None, matcher=jvo.FakeMatcher(),
                     kf_config=JKeyframeConfig(**STREAM_KF))
    tb = MapBuilder(_imu_camera(Camera()), detector=None, matcher=Matcher(),
                    kf_config=KeyframeConfig(**STREAM_KF), device="cpu", dtype=F64)
    j_init = _run_stream(jb, seq, frames, JImuData, JMapline)
    launches = pose_gn.pose_only_fast.launches
    t_init = _run_stream(tb, seq, frames, ImuData, Mapline)
    assert pose_gn.pose_only_fast.launches == launches
    jm, tm = jb.map, tb.map
    assert tm.imu_initialized and jm.imu_initialized
    assert t_init == j_init and tm.keyframe_ids == jm.keyframe_ids
    assert t_init < tm.keyframe_ids[-1] <= STREAM_FRAMES - 1  # VI frames followed
    np.testing.assert_array_equal(tm.Rwg, jm.Rwg)
    assert len(tb.trajectory) == len(jb.trajectory) == STREAM_FRAMES
    for (ts, T), (jts, jT) in zip(tb.trajectory, jb.trajectory):
        assert ts == jts and np.abs(T - jT).max() <= POSE_TOL
    for fid in tm.keyframe_ids:
        a, b = tm.keyframes[fid], jm.keyframes[fid]
        assert np.abs(a.Twc - b.Twc).max() <= POSE_TOL, fid
        for name in ("velocity", "bg", "ba"):
            assert np.abs(getattr(a, name) - getattr(b, name)).max() <= POSE_TOL, (fid, name)
        assert (a.preintegration is None) == (b.preintegration is None)
    for reg in ("mappoints", "maplines"):
        ours, theirs = getattr(tm, reg), getattr(jm, reg)
        assert sorted(ours) == sorted(theirs)
        assert [x.is_valid for x in ours.values()] == [theirs[k].is_valid for k in ours]
    for tid, mpt in tm.mappoints.items():
        if mpt.is_valid:
            assert np.abs(mpt.position - jm.mappoints[tid].position).max() <= 10 * POSE_TOL
    # the added line went through the gravity alignment with the map
    line, jline = tm.maplines[10 ** 6], jm.maplines[10 ** 6]
    assert np.abs(line.line3d - jline.line3d).max() <= POSE_TOL
    assert np.abs(line.endpoints - jline.endpoints).max() <= POSE_TOL
    assert np.abs(line.endpoints - [1.0, -0.5, 6.0, 1.5, 0.8, 7.0]).max() > 1e-2
    # test_full_vio_pipeline's own checks hold on the port's map
    last = tm.keyframes[tm.keyframe_ids[-1]]
    assert np.allclose(last.bg, BG_TRUE, atol=5e-3)
    assert all(np.linalg.norm(tm.keyframes[f].velocity) < 2.0 for f in tm.keyframe_ids)
    tm.check_map()


def test_pipelined_runner_passes_the_imu_batches():
    """``PipelinedRunner`` hands each frame's IMU batch to ``track_features``
    as the sequential loop does: over the stream's first 4 frames the same
    keyframes, the same preintegration rows on each and the same poses."""
    from airslam_tpu_torch.frontend.detector import FrameFeatures
    from airslam_tpu_torch.parallel.pipeline import PipelinedRunner

    seq, frames = _vio_stream()
    frames = frames[:4]
    times = seq["times"]
    rows = [ImuData(times[i], seq["gyr"][i], seq["acc"][i]) for i in range(len(times))]
    batches = [rows[max(a - 1, 0): b + 2] if n else None
               for n, (a, b) in enumerate(zip([0] + [i for i, _ in frames[:-1]],
                                              [i for i, _ in frames]))]

    class Stream:
        def __len__(self):
            return len(frames)

        def get(self, n):
            z = np.zeros((480, 752), np.float32)
            return times[frames[n][0]], z, z, batches[n]

    class StubDetector:
        """Hands out the rendered pairs in call order, as tensors."""

        def __init__(self):
            self.n = 0

        def detect(self, images):
            fl, fr, _ = frames[self.n][1]
            self.n += 1
            return FrameFeatures(*(torch.stack([torch.as_tensor(a), torch.as_tensor(b)])
                                   for a, b in zip(fl, fr)))

    def builder(detector=None):
        return MapBuilder(_imu_camera(Camera()), detector, Matcher(),
                          kf_config=KeyframeConfig(**STREAM_KF), device="cpu", dtype=F64)

    loop = builder()
    for n, (i, (fl, fr, pairs)) in enumerate(frames):
        loop.track_features(times[i], fl, fr, pairs, imu_batch=batches[n])
    pipe = builder(StubDetector())
    assert PipelinedRunner(pipe).run(Stream()) == 4
    assert pipe.map.keyframe_ids == loop.map.keyframe_ids and len(loop.map.keyframe_ids) >= 3
    for fid in loop.map.keyframe_ids[1:]:
        a, b = pipe.map.keyframes[fid].preintegration, loop.map.keyframes[fid].preintegration
        assert a.valid() and np.array_equal(np.asarray(a._rows_dt), np.asarray(b._rows_dt))
        assert np.array_equal(np.asarray(a._rows_acc), np.asarray(b._rows_acc))
    for (_, T0), (_, T1) in zip(loop.trajectory, pipe.trajectory):
        np.testing.assert_allclose(T1, T0, rtol=0, atol=1e-12)
