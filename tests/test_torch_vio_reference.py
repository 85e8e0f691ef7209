"""The port's stereo-inertial path against the plain float64 reference of the
VI cells (``slambench/reference/vi_ba.py``) on the CPU, on seeded problems
with EuRoC's IMU: its noise densities and walks at 200 Hz, non-zero biases,
the rotated body-to-camera transform of ``configs/camera/euroc.yaml`` and a
rotating flight (the VI cells' motion, ``slambench/traffic/stereo_imu_stream``).
Five pieces: the preintegration, the IMU residual and its Jacobians, the F=2
VI tracking solve, a VI local BA and the IMU initialization's optimization.

Each tolerance says why it is what it is; each test also runs the port in
float32 on the same problem and requires that run to miss at least one of
its tolerances, so that no tolerance is loose enough to pass the precision
below the float64 the VI cells state."""

import os

import numpy as np
import torch

from airslam_tpu_torch.backend import gn, windows
from airslam_tpu_torch.core.camera import Camera, Intrinsics
from airslam_tpu_torch.core.imu import ImuData, Preintegration
from airslam_tpu_torch.slam.map import preintegration_information
from slambench.reference import vi_ba, vio_check
from slambench.reference import window_ba as wba
from slambench.traffic.stereo_imu_stream import Motion

torch.set_num_threads(2)
F64, F32 = torch.float64, torch.float32
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EUROC = Camera(os.path.join(ROOT, "configs", "camera", "euroc.yaml"))
RATE = 200.0
# the VI cells' flight: 0.72 m/s along z with the weave, and the attitude
FLIGHT = {"trajectory": "forward", "time_scale": 0.3,
          "attitude": {"yaw": [6.0, 0.25], "pitch": [3.0, 0.40], "roll": [3.0, 0.35]}}
GRAVITY = np.array([0.0, EUROC.g_value, 0.0])  # the flight's world has y down
RWG = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])  # Rwg·(0, 0, −g) = GRAVITY
NOISE = (EUROC.gyr_noise, EUROC.acc_noise, EUROC.gyr_walk, EUROC.acc_walk)
INTR = Intrinsics(fx=450.0, fy=450.0, cx=376.0, cy=240.0, bf=45.0)
CAM = {"fx": 450.0, "fy": 450.0, "cx": 376.0, "cy": 240.0, "bf": 45.0}
CFG = gn.BAConfig()
THR = {k: getattr(CFG, k) for k in ("mono_point", "stereo_point", "mono_line", "stereo_line")}


def _imu(seconds: float, seed: int):
    """The flight's body states and EuRoC-noisy 200 Hz samples (t, gyro,
    acc) over ``seconds``, biases drawn at σ 0.01 rad/s and 0.05 m/s²."""
    rng = np.random.default_rng(seed)
    times = np.arange(int(round(seconds * RATE)) + 2) / RATE
    R, p, v, w, f = Motion(FLIGHT, EUROC.Tbc).kinematics(times, GRAVITY)
    gn_, an, gw, aw = NOISE
    m = len(times)
    bias = np.concatenate([rng.normal(0, 0.01, 3), rng.normal(0, 0.05, 3)]) + np.cumsum(
        np.concatenate([rng.normal(0, gw, (m, 3)), rng.normal(0, aw, (m, 3))], 1), 0)
    meas = np.concatenate([w, f], 1) + bias + np.concatenate(
        [rng.normal(0, gn_, (m, 3)), rng.normal(0, an, (m, 3))], 1)
    return dict(t=times, R=R, p=p, v=v, bias=bias,
                samples=np.concatenate([times[:, None], meas], 1))


def _factor(seq, i0, i1, bg, ba):
    """The reference's preintegration of samples i0..i1 at (bg, ba)."""
    s = seq["samples"]
    return vi_ba.preintegrate(*vi_ba.midpoint_rows(s[i0:i1 + 2], s[i0, 0], s[i1, 0]), bg, ba,
                              NOISE)


def _factors(seq, pairs, bg, ba, dtype, mask=None):
    """``gn.IMUFactors`` of (i, j, sample i, sample j) pairs, their
    information as the port's map computes it."""
    pres = [_factor(seq, a, b, bg, ba) for _, _, a, b in pairs]
    infos = [preintegration_information(p["cov"]) for p in pres]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(dtype)

    def stack(k):
        return t(np.stack([p[k] for p in pres]))

    k = len(pairs)
    return gn.IMUFactors(
        idx_i=torch.as_tensor([q[0] for q in pairs]), idx_j=torch.as_tensor([q[1] for q in pairs]),
        dR=stack("dR"), dV=stack("dV"), dP=stack("dP"), JRg=stack("JRg"), JVg=stack("JVg"),
        JVa=stack("JVa"), JPg=stack("JPg"), JPa=stack("JPa"), bg_lin=t(np.tile(bg, (k, 1))),
        ba_lin=t(np.tile(ba, (k, 1))), dT=t([p["dT"] for p in pres]),
        info=t(np.stack([i[0] for i in infos])), info_walk=t(np.stack([i[1] for i in infos])),
        mask=torch.ones(k, dtype=torch.bool) if mask is None else torch.as_tensor(mask))


def _cast(problem, dtype):
    def leaf(x):
        return x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x

    imu = None if problem.imu is None else gn.IMUFactors(*(leaf(x) for x in problem.imu))
    return problem._replace(**{k: leaf(getattr(problem, k)) for k in problem._fields
                               if k not in ("frames", "imu", "g_value")},
                            frames=gn.FrameStates(*(leaf(x) for x in problem.frames)), imu=imu)


def _gap(a, b):
    return float((torch.as_tensor(a).double() - torch.as_tensor(b).double()).abs().max())


def _camera_of(Rwb, twb):
    """(Rcw, tcw) of a body pose through the euroc body-to-camera transform."""
    Tcb = EUROC.Tcb
    Rcw = Tcb[:3, :3] @ Rwb.T
    return Rcw, Tcb[:3, 3] - Rcw @ twb


def _observe(rng, pts, Rwb, twb, px):
    """Stereo observations (u, v, u_right) of world points with ``px``
    noise; visible where in front and inside the image."""
    Rcw, tcw = _camera_of(Rwb, twb)
    pc = pts @ Rcw.T + tcw
    z = pc[:, 2]
    u = 450.0 * pc[:, 0] / z + 376.0
    v = 450.0 * pc[:, 1] / z + 240.0
    obs = np.stack([u, v, u - 45.0 / z], -1) + rng.normal(0, px, (len(pts), 3))
    ok = (z > 0.5) & (u > 0) & (u < 752) & (v > 0) & (v < 480)
    return obs, ok


def _points_ahead(rng, Rwb, twb, n):
    """``n`` world points 2–8 m in front of the camera of a body pose."""
    Rcw, tcw = _camera_of(Rwb, twb)
    z = rng.uniform(2.0, 8.0, n)
    pc = np.stack([rng.uniform(-0.6, 0.6, n) * z, rng.uniform(-0.4, 0.4, n) * z, z], -1)
    return (pc - tcw) @ Rcw


# -- 1. the preintegration ------------------------------------------------------


def test_preintegration_of_40_rows_equals_the_reference():
    """40 samples (0.2 s) of the rotating flight with EuRoC noise, integrated
    by ``Preintegration`` at non-zero biases from the rows the VO CLI hands
    over, against the reference's midpoint rows and propagation. Tolerance
    1e-12 (deltas, Jacobians; the covariance relative to its largest entry):
    both fold 40 float64 steps of the same recursion, whose rounding stays
    near 1e-15; float32 rounds each step at 6e-8."""
    seq = _imu(0.25, seed=2 ** 31 + 7)
    s = seq["samples"]
    bg, ba = np.array([0.012, -0.008, 0.004]), np.array([0.05, -0.03, 0.02])
    ref = _factor(seq, 0, 40, bg, ba)

    def port(dtype):
        pre = Preintegration(noise=NOISE, dtype=dtype, device="cpu")
        pre.set_bias(bg, ba)
        pre.add_batch([ImuData(r[0], r[1:4], r[4:7]) for r in s[:42]], s[0, 0], s[40, 0])
        return pre.state

    def gaps(st):
        g = {k: _gap(getattr(st, k), ref[k]) for k in ("dR", "dV", "dP", "dT", "JRg", "JVg",
                                                        "JVa", "JPg", "JPa")}
        g["cov"] = _gap(st.cov, ref["cov"]) / float(np.abs(ref["cov"]).max())
        return g

    got = gaps(port(F64))
    assert max(got.values()) <= 1e-12, got
    assert float(ref["dT"]) == 0.2 and np.linalg.norm(ref["dV"]) > 0.1
    assert max(gaps(port(F32)).values()) > 1e-12


# -- 2. the IMU residual and its Jacobians ------------------------------------------


def _state_pair(seq, rng, i0, i1):
    """Frames i0 and i1 of the flight as FrameStates, perturbed, and their
    factor at a bias off the truth."""
    Rwb = np.stack([seq["R"][i0], seq["R"][i1] @ vi_ba._np_exp(rng.normal(0, 0.01, 3))])
    twb = np.stack([seq["p"][i0], seq["p"][i1] + rng.normal(0, 0.02, 3)])
    vel = np.stack([seq["v"][i0], seq["v"][i1]]) + rng.normal(0, 0.05, (2, 3))
    bias = seq["bias"][[i0, i1]] + rng.normal(0, 0.003, (2, 6))
    return Rwb, twb, vel, bias


def test_imu_residual_and_jacobians_equal_the_reference():
    """``gn.imu_residuals`` (K, 15) and its Jacobians (K, 15, 32) over three
    factors of the flight (0.3 s each, biases off the linearization point)
    against the reference's residual under forward-mode derivatives of the
    same 32-d update (frame i 15, frame j 15, gravity 2). Tolerance 1e-11
    (entries up to about 10; the two read 2.2e-16 apart): one residual in
    float64 written twice; float32 rounds the 9.81 m/s² terms at 1e-6 and
    reads 4e-5 in the Jacobians."""
    seq = _imu(1.0, seed=2 ** 31 + 8)
    rng = np.random.default_rng(11)
    Rwb, twb, vel, bias = (np.concatenate(x) for x in zip(*[
        _state_pair(seq, rng, a, a + 60) for a in (0, 60, 120)]))
    pairs = [(2 * k, 2 * k + 1, 60 * k, 60 * k + 60) for k in range(3)]
    bg_lin, ba_lin = seq["bias"][0, :3] + 0.004, seq["bias"][0, 3:] - 0.02

    def port(dtype):
        t = lambda a: torch.as_tensor(np.asarray(a)).to(dtype)  # noqa: E731
        fr = gn.FrameStates(t(Rwb), t(twb), t(vel), t(bias[:, :3]), t(bias[:, 3:]))
        return gn.imu_residuals(fr, _factors(seq, pairs, bg_lin, ba_lin, dtype), t(RWG), True,
                                EUROC.g_value)

    fa = _factors(seq, pairs, bg_lin, ba_lin, F64)
    t64 = lambda a: torch.as_tensor(np.asarray(a, np.float64))  # noqa: E731
    ii, jj = fa.idx_i, fa.idx_j
    pre = (fa.dR, fa.dV, fa.dP, fa.JRg, fa.JVg, fa.JVa, fa.JPg, fa.JPa, fa.bg_lin, fa.ba_lin,
           fa.dT)
    S = [t64(a) for a in (Rwb, twb, vel, bias[:, :3], bias[:, 3:])]

    def ref_one(k):
        def f(d):
            Ri = S[0][ii[k]] @ wba._exp(d[0:3])
            ti = S[1][ii[k]] + S[0][ii[k]] @ d[3:6]
            Rj = S[0][jj[k]] @ wba._exp(d[15:18])
            tj = S[1][jj[k]] + S[0][jj[k]] @ d[18:21]
            vi, vj = S[2][ii[k]] + d[6:9], S[2][jj[k]] + d[21:24]
            bgi, bai = S[3][ii[k]] + d[9:12], S[4][ii[k]] + d[12:15]
            bgj, baj = S[3][jj[k]] + d[24:27], S[4][jj[k]] + d[27:30]
            Rwg = t64(RWG) @ wba._exp(torch.cat([d[30:32], d.new_zeros(1)]))
            r9 = vi_ba.imu_residual(Ri, ti, vi, Rj, tj, vj, bgj, baj, *(x[k] for x in pre), Rwg,
                                    EUROC.g_value)
            return torch.cat([r9, bgj - bgi, baj - bai])

        z = torch.zeros(32, dtype=F64)
        return f(z), torch.func.jacfwd(f)(z)

    want_r, want_J = (torch.stack(x) for x in zip(*[ref_one(k) for k in range(3)]))
    got_r, got_J = port(F64)
    assert got_J.shape == want_J.shape == (3, 15, 32)
    assert float(want_r[:, :9].abs().max()) > 1e-3  # the residual is not trivially zero
    assert _gap(got_r, want_r) <= 1e-11 and _gap(got_J, want_J) <= 1e-11
    r32, J32 = port(F32)
    assert max(_gap(r32, want_r), _gap(J32, want_J)) > 1e-11


# -- 3. the F=2 VI tracking solve ------------------------------------------------------


def _tracking_problem(seed):
    """The F=2 layout of ``MapBuilder._pose_only``: the last keyframe fixed
    (frame 0, 0.25 s back), the current frame seeded 3 cm and 0.02 rad off
    its truth with the keyframe's velocity and biases, 120 fixed points seen
    by it in stereo at 0.7 px, 12 of them 25 px off, one masked line."""
    seq = _imu(0.5, seed)
    rng = np.random.default_rng(seed)
    i0, i1 = 10, 60
    Rj0, tj0 = seq["R"][i1], seq["p"][i1]
    P = 128
    pts = _points_ahead(rng, Rj0, tj0, 120)
    obs, ok = _observe(rng, pts, Rj0, tj0, 0.7)
    obs[:12, :2] += rng.choice([-25.0, 25.0], (12, 2))
    points = np.zeros((P, 3))
    points[:120] = pts
    point_obs = np.zeros((P, 2, 3))
    point_obs[..., 2] = -1.0
    point_obs[:120, 1] = obs
    mask = np.zeros((P, 2), bool)
    mask[:120, 1] = ok
    kf_bias = seq["bias"][i0] + rng.normal(0, 0.002, 6)
    Rwb = np.stack([seq["R"][i0], Rj0 @ vi_ba._np_exp(rng.normal(0, 0.02 / np.sqrt(3), 3))])
    twb = np.stack([seq["p"][i0], tj0 + rng.normal(0, 0.03 / np.sqrt(3), 3)])
    vel = np.stack([seq["v"][i0] + rng.normal(0, 0.02, 3)] * 2)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64))  # noqa: E731
    problem = gn.BAProblem(
        frames=gn.FrameStates(t(Rwb), t(twb), t(vel), t(np.stack([kf_bias[:3]] * 2)),
                              t(np.stack([kf_bias[3:]] * 2))),
        pose_fixed=torch.tensor([True, False]), vel_fixed=torch.tensor([True, False]),
        points=t(points), point_fixed=torch.ones(P, dtype=torch.bool), point_obs=t(point_obs),
        point_obs_mask=torch.as_tensor(mask), lines=t([[1.0, 0, 0, 0, 1.0, 0]]),
        line_fixed=torch.ones(1, dtype=torch.bool), line_obs=torch.zeros((1, 2, 8), dtype=F64),
        line_obs_stereo=torch.zeros((1, 2), dtype=torch.bool),
        line_obs_mask=torch.zeros((1, 2), dtype=torch.bool),
        line_obs_sigma=torch.full((1, 2), 0.5, dtype=F64), Rwg=t(RWG),
        gravity_free=torch.zeros((), dtype=F64),
        imu=_factors(seq, [(0, 1, i0, i1)], np.zeros(3), np.zeros(3), F64),
        Rcb=t(EUROC.Tcb[:3, :3]), tcb=t(EUROC.Tcb[:3, 3]), g_value=EUROC.g_value)
    return problem, seq, i1


def test_vi_tracking_solve_equals_the_reference():
    """``windows.pose_only_optimization`` on the VI tracking layout
    (``_pose_only_fast_vi``: 3 rounds × 10 LM steps over the frame's 15 dof)
    against the reference's pose-only solve of the same problem. Tolerances
    (the largest over the frame's entries): 2e-9 m in position, 1e-9 in
    rotation and biases, 1e-8 m/s in velocity, the inlier flags equal. Both
    solvers take the same 30 damped steps in float64 and differ only in
    their sums' order, which the weakly weighted velocity carries furthest:
    they read 1.5e-10 m, 3e-11, 5e-12 and 9e-10 m/s apart; float32 reads
    1e-8 m, 8e-8 and 4e-7 m/s. The solve recovers the truth to the noise."""
    problem, seq, i1 = _tracking_problem(2 ** 31 + 12)
    ref = vi_ba.pose_only(vio_check.vi_window_of(problem), CAM, THR, CFG.imu_info_scale)

    def gaps(p_dtype):
        out, p_in, _, n_in = windows.pose_only_optimization(_cast(problem, p_dtype), INTR, CFG,
                                                            vi_tracking=True)
        fr, rs = out.frames, ref.state
        return {"t": _gap(fr.twb[1], rs.twb[1]), "R": _gap(fr.Rwb[1], rs.Rwb[1]),
                "v": _gap(fr.vel[1], rs.vel[1]),
                "b": max(_gap(fr.bg[1], rs.bg[1]), _gap(fr.ba[1], rs.ba[1]))}, p_in, n_in

    got, p_in, n_in = gaps(F64)
    lim = {"t": 2e-9, "R": 1e-9, "v": 1e-8, "b": 1e-9}
    assert all(got[k] <= lim[k] for k in lim), got
    assert torch.equal(p_in, ref.point_inlier) and int(n_in) == int(ref.point_inlier.sum())
    assert not bool(p_in[:12, 1].any()) and int(n_in) >= 90
    assert np.abs(ref.state.twb[1].numpy() - seq["p"][i1]).max() < 0.01
    f32 = gaps(F32)[0]
    assert any(f32[k] > lim[k] for k in lim), f32


# -- 4. a VI local BA --------------------------------------------------------------------


def _window_problem(seed):
    """Five keyframes 0.3 s apart on the flight, the oldest fixed (pose,
    velocity and biases), the others seeded 3 cm / 0.01 rad, 0.05 m/s off
    their truth with zero biases; 80 points seen in stereo at 0.7 px and
    seeded 5 cm off; 10 lines with stereo endpoints at 0.7 px, seeded by a
    small orthonormal update; IMU factors between consecutive keyframes,
    linearized at zero bias; gravity held."""
    seq = _imu(1.3, seed)
    rng = np.random.default_rng(seed)
    kf = [0, 60, 120, 180, 240]
    f = len(kf)
    Rt, pt = seq["R"][kf], seq["p"][kf]
    pts = np.concatenate([_points_ahead(rng, Rt[k], pt[k], 16) for k in range(f)])
    P, L = len(pts), 10
    point_obs = np.zeros((P, f, 3))
    point_obs[..., 2] = -1.0
    mask = np.zeros((P, f), bool)
    for k in range(f):
        point_obs[:, k], mask[:, k] = _observe(rng, pts, Rt[k], pt[k], 0.7)
    # lines: segments ahead of the middle keyframe, seen by every keyframe
    a = _points_ahead(rng, Rt[2], pt[2], L)
    b = a + rng.normal(0, 0.6, (L, 3))
    d = (b - a) / np.linalg.norm(b - a, axis=1, keepdims=True)
    lines = np.concatenate([np.cross(a, d), d], 1)
    line_obs = np.zeros((L, f, 8))
    for k in range(f):
        oa, _ = _observe(rng, a, Rt[k], pt[k], 0.7)
        ob, _ = _observe(rng, b, Rt[k], pt[k], 0.7)
        line_obs[:, k] = np.stack([oa[:, 0], oa[:, 1], ob[:, 0], ob[:, 1],
                                   oa[:, 2], oa[:, 1], ob[:, 2], ob[:, 1]], -1)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float64))  # noqa: E731
    seeded_lines = wba._line_oplus(t(lines), t(rng.normal(0, 0.005, (L, 4))))
    Rwb = np.stack([Rt[0]] + [Rt[k] @ vi_ba._np_exp(rng.normal(0, 0.006, 3)) for k in range(1, f)])
    twb = pt + np.concatenate([np.zeros((1, 3)), rng.normal(0, 0.017, (f - 1, 3))])
    vel = seq["v"][kf] + np.concatenate([np.zeros((1, 3)), rng.normal(0, 0.03, (f - 1, 3))])
    bias = np.zeros((f, 6))
    bias[0] = seq["bias"][0]
    fixed = torch.tensor([True] + [False] * (f - 1))
    problem = gn.BAProblem(
        frames=gn.FrameStates(t(Rwb), t(twb), t(vel), t(bias[:, :3]), t(bias[:, 3:])),
        pose_fixed=fixed, vel_fixed=fixed.clone(),
        points=t(pts + rng.normal(0, 0.03, (P, 3))), point_fixed=torch.zeros(P, dtype=torch.bool),
        point_obs=t(point_obs), point_obs_mask=torch.as_tensor(mask), lines=seeded_lines,
        line_fixed=torch.zeros(L, dtype=torch.bool), line_obs=t(line_obs),
        line_obs_stereo=torch.ones((L, f), dtype=torch.bool),
        line_obs_mask=torch.ones((L, f), dtype=torch.bool),
        line_obs_sigma=torch.full((L, f), 0.1, dtype=F64), Rwg=t(RWG),
        gravity_free=torch.zeros((), dtype=F64),
        imu=_factors(seq, [(k, k + 1, kf[k], kf[k + 1]) for k in range(f - 1)], np.zeros(3),
                     np.zeros(3), F64),
        Rcb=t(EUROC.Tcb[:3, :3]), tcb=t(EUROC.Tcb[:3, 3]), g_value=EUROC.g_value)
    return problem, seq, kf


def test_vi_local_ba_equals_the_reference():
    """``windows.local_ba`` on a five-keyframe VI window (5 robust LM steps,
    the χ² gate, 15 plain ones) against the reference's VI window BA of the
    same problem. Tolerances: 1e-9 m and 1e-9 in the free poses' position
    and rotation, 1e-8 m in every point, 1e-9 in the velocities and biases,
    1e-10 in the robust cost relative, the inlier flags equal. Both are
    float64 solvers of one system whose sums run in other orders; they read
    2.6e-12 m, 4.6e-13, 7.6e-11 m, 6.5e-12 and 1.5e-13 apart, and the limits
    sit two orders above for a window that is weaker along some direction;
    float32 reads 5e-7 m, 1.3e-7, 2.7e-5 m, 9.5e-7 m/s and 1.6e-8."""
    problem, seq, kf = _window_problem(2 ** 31 + 13)
    w = vio_check.vi_window_of(problem)
    ref = vi_ba.window_ba(w, CAM, THR, CFG.imu_info_scale, 5, 15)

    def gaps(dtype):
        out, p_in, l_in = windows.local_ba(_cast(problem, dtype), INTR, CFG)
        fr, rs = out.frames, ref.state
        got = {"t": _gap(fr.twb[1:], rs.twb[1:]), "R": _gap(fr.Rwb[1:], rs.Rwb[1:]),
               "p": _gap(out.points, rs.points), "v": _gap(fr.vel[1:], rs.vel[1:]),
               "b": max(_gap(fr.bg[1:], rs.bg[1:]), _gap(fr.ba[1:], rs.ba[1:]))}
        state = vi_ba.State(fr.Rwb, fr.twb, fr.vel, fr.bg, fr.ba, out.points, out.lines)
        c_prog = vi_ba.cost(w, CAM, THR, CFG.imu_info_scale, state)
        c_ref = vi_ba.cost(w, CAM, THR, CFG.imu_info_scale, rs)
        got["cost"] = abs(c_prog - c_ref) / c_ref
        return got, p_in, l_in

    got, p_in, l_in = gaps(F64)
    lim = {"t": 1e-9, "R": 1e-9, "p": 1e-8, "v": 1e-9, "b": 1e-9, "cost": 1e-10}
    assert all(got[k] <= lim[k] for k in lim), got
    assert torch.equal(p_in, ref.point_inlier) and torch.equal(l_in, ref.line_inlier)
    # the window moved towards the truth
    assert np.abs(ref.state.twb.numpy() - seq["p"][kf]).max() < 0.01
    f32 = gaps(F32)[0]
    assert any(f32[k] > lim[k] for k in lim), f32


def _line_through_right_camera(problem, line: int, frame: int, miss: float):
    """``problem`` with line ``line`` moved to pass ``miss`` metres from the
    right camera centre of keyframe ``frame``'s current estimate, its
    direction kept: it projects there to a 2D line of almost no normal."""
    Rcb, tcb = problem.Rcb, problem.tcb
    Rwb, twb = problem.frames.Rwb[frame], problem.frames.twb[frame]
    Rwc = Rwb @ Rcb.T
    twc = twb - Rwc @ tcb
    centre = twc + Rwc @ torch.tensor([INTR.bf / INTR.fx, 0.0, 0.0], dtype=F64)
    d = problem.lines[line, 3:] / problem.lines[line, 3:].norm()
    off = torch.linalg.cross(d, torch.tensor([0.0, 0.0, 1.0], dtype=F64))
    p = centre + miss * off / off.norm()
    lines = problem.lines.clone()
    lines[line] = torch.cat([torch.linalg.cross(p, d), d])
    return problem._replace(lines=lines)


def test_vi_local_ba_with_a_line_through_a_camera_centre_equals_the_reference():
    """The window of :func:`test_vi_local_ba_equals_the_reference` with one
    line through keyframe 2's right camera centre (1e-9 m off), as a line
    triangulated from other views can come to lie: its right-view rows in
    that keyframe reach 1e11. Eliminated through normal equations, its Schur
    term cancelled the pose block to rounding noise, the reduced system came
    out indefinite, every LM step gave NaN and the window was returned
    unoptimized. The window moves, and lands where the reference's
    least-squares solve (QR of the weighted rows) does: within 1e-8 m and
    1e-8 in the poses, 1e-7 m in the points, 1e-8 in velocities and biases,
    1e-8 in the cost relative (on the stream's windows of this kind the
    two read 1e-12 to 2e-9 m apart; the line's own rows leave rounding of
    1e-16 × 1e11 in both)."""
    problem, seq, kf = _window_problem(2 ** 31 + 13)
    problem = _line_through_right_camera(problem, 0, 2, 1e-9)
    _, _, _, LJl = gn._line_grid_residuals(problem, INTR, True)
    assert float(LJl[0, 2].abs().max()) > 1e10
    w = vio_check.vi_window_of(problem)
    ref = vi_ba.window_ba(w, CAM, THR, CFG.imu_info_scale, 5, 15)
    out, p_in, l_in = windows.local_ba(problem, INTR, CFG)
    fr, rs = out.frames, ref.state
    assert bool(torch.isfinite(fr.twb).all()) and _gap(fr.twb, problem.frames.twb) > 1e-3
    got = {"t": _gap(fr.twb[1:], rs.twb[1:]), "R": _gap(fr.Rwb[1:], rs.Rwb[1:]),
           "p": _gap(out.points, rs.points), "v": _gap(fr.vel[1:], rs.vel[1:]),
           "b": max(_gap(fr.bg[1:], rs.bg[1:]), _gap(fr.ba[1:], rs.ba[1:]))}
    state = vi_ba.State(fr.Rwb, fr.twb, fr.vel, fr.bg, fr.ba, out.points, out.lines)
    c_prog = vi_ba.cost(w, CAM, THR, CFG.imu_info_scale, state)
    c_ref = vi_ba.cost(w, CAM, THR, CFG.imu_info_scale, rs)
    got["cost"] = abs(c_prog - c_ref) / c_ref
    lim = {"t": 1e-8, "R": 1e-8, "p": 1e-7, "v": 1e-8, "b": 1e-8, "cost": 1e-8}
    assert all(got[k] <= lim[k] for k in lim), got
    assert torch.equal(p_in, ref.point_inlier) and torch.equal(l_in, ref.line_inlier)
    assert np.abs(rs.twb.numpy() - seq["p"][kf]).max() < 0.01


# -- 5. the IMU initialization ----------------------------------------------------------


def test_imu_initialization_equals_the_reference():
    """``windows.imu_initialization`` (200 LM steps over ten keyframes'
    velocities, the shared biases with the map's priors 1e2 / 1e5 and the
    gravity direction) on a ten-keyframe chain 0.4 s apart, its seeds off the
    truth (velocities by 0.05 m/s, gravity by 0.05 rad, the biases at zero),
    against the reference's. Tolerances 1e-9 in the velocities, the biases
    and Rwg: one 38-unknown system in float64 (the priors bound the biases),
    steps identical but for sum order, read 3.3e-13 apart; float32 reads
    8.7e-9 to 4e-7. The gyro bias comes out within 3e-3 rad/s of the
    truth."""
    seq = _imu(3.7, seed=2 ** 31 + 14)
    rng = np.random.default_rng(14)
    kf = [80 * k for k in range(10)]
    zero = np.zeros(3)
    pre = [_factor(seq, a, b, zero, zero) for a, b in zip(kf[:-1], kf[1:])]
    info = [preintegration_information(p["cov"])[0] for p in pre]
    Rwg0 = RWG @ vi_ba._np_exp(np.array([0.03, -0.04, 0.0]))
    vel0 = seq["v"][kf] + rng.normal(0, 0.05, (10, 3))

    def inputs(dtype):
        t = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(dtype)  # noqa: E731
        p = {k: t(np.stack([q[k] for q in pre])) for k in ("dR", "dV", "dP", "JRg", "JVg",
                                                          "JVa", "JPg", "JPa")}
        p["dT"] = t([q["dT"] for q in pre])
        p["info"] = t(np.stack(info))
        return (t(seq["R"][kf]), t(seq["p"][kf]), t(vel0), t(zero), t(zero), t(Rwg0), p,
                EUROC.g_value, t(zero), t(zero))

    want = vi_ba.imu_initialization(*inputs(F64))

    def gaps(dtype):
        got = windows.imu_initialization(*inputs(dtype))
        return [_gap(g, w_) for g, w_ in zip(got, want)]

    got = gaps(F64)
    assert max(got) <= 1e-9, got
    assert np.abs(want[1].numpy() - seq["bias"][kf].mean(0)[:3]).max() < 3e-3
    assert max(gaps(F32)) > 1e-9
