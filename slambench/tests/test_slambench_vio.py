"""The stereo-inertial cells: the generator's IMU against the rendered poses,
the two cells' frames bit for bit, the files found by name, and the VI
driver on the CPU at a small size, sound and with planted faults that make
``correct`` false (the IMU factor dropped from the F = 2 tracking solve;
gravity's sign flipped in the IMU residual; every VI local BA returning its
window unmoved), and on the card the float32 controls of both cells. Runs of
``drivers/vio.py`` reach the IMU's initialization on the CPU in several
minutes each."""

import contextlib
import copy
import io
import json
import time

import numpy as np
import pytest
import torch

import _helpers  # noqa: F401  (puts the checkout on sys.path)
from slambench.reference import vi_ba
from slambench.traffic import stereo_imu_stream

# CPU sizes: the stream up to the initialization and a window that holds a
# VI local BA (the check requires one)
VIO_SMALL = {"frames": 150, "check_frames": 2, "seconds": 15.0}


def _load(name):
    from slambench import run as R

    return R.load(name)


def test_load_finds_both_cells_and_the_configuration():
    bench, cell, wl, cfg = _load("vio_euroc.slow")
    assert cell["config"] == "vio_euroc" and wl["driver"] == "vio" and cfg["name"] == "vio_euroc"
    assert int(cfg["camera"]["use_imu"]) == 1 and cfg["reduced"] == []
    entry = next(c for c in bench["configs"] if c["name"] == "vio_euroc")
    assert entry["file"] == "slambench/configs/vio_euroc.json" and entry["reduced"] == []
    _, cell, wl2, cfg2 = _load("vo_euroc.slow")
    assert cell["config"] == "vo_euroc" and wl2["driver"] == "vo"
    assert {k: v for k, v in wl2["traffic"].items() if not k.startswith("warmup")} == \
        {k: v for k, v in wl["traffic"].items() if not k.startswith("warmup")}
    for key in ("vo", "networks_dtype", "tf32", "use_flash", "backend_dtype", "local_ba",
                "trajectory_gate_m", "trajectory_gate_frames"):
        assert cfg[key] == cfg2[key], key


def test_the_two_cells_frames_are_bit_identical_for_a_seed():
    (_, _, wl, cfg), (_, _, _, cfg_vo) = _load("vio_euroc.slow"), _load("vo_euroc.slow")
    tr = dict(wl["traffic"], frames=3)
    a = stereo_imu_stream.generate(tr, cfg["camera"], 2 ** 31 + 41, "cpu")
    b = stereo_imu_stream.generate(tr, cfg_vo["camera"], 2 ** 31 + 41, "cpu")
    assert np.array_equal(a.images, b.images) and np.array_equal(a.gt_Twc, b.gt_Twc)
    assert a.imu is not None and b.imu is None
    assert a.imu.shape == (2 * 10 + 2, 7) and np.array_equal(a.imu[::10, 0][:3], a.timestamps)


def test_the_noiseless_imu_integrated_by_the_reference_reproduces_the_rendered_poses():
    """1 s of the flight's noiseless IMU (200 Hz, body frame of the
    configuration's T_bc), integrated by the reference from the body's state
    at the first frame, lands on the body pose the rendered camera gives at
    the last: within 2e-4 rad and 2 mm. The midpoint rule ahead of a first
    order rotation update leaves about ω·dt/2 · g ≈ 4e-3 m/s² of
    acceleration error at the flight's rates, a millimetre over a second."""
    _, _, wl, cfg = _load("vio_euroc.slow")
    tr = dict(wl["traffic"], frames=21)
    Tbc = stereo_imu_stream._node_Tbc(cfg["camera"]["cam0"])
    gravity = np.array([0.0, float(cfg["camera"]["g_value"]), 0.0])
    times, step = stereo_imu_stream.imu_samples(tr, cfg["camera"], 21)
    motion = stereo_imu_stream.Motion(tr, Tbc)
    R, p, v, w, f = motion.kinematics(times, gravity)
    samples = np.concatenate([times[:, None], w, f], 1)
    pre = vi_ba.preintegrate(*vi_ba.midpoint_rows(samples, times[0], times[20 * step]),
                             np.zeros(3), np.zeros(3), (0.0,) * 4)
    T = pre["dT"]
    R1 = R[0] @ pre["dR"]
    p1 = p[0] + v[0] * T + 0.5 * gravity * T * T + R[0] @ pre["dP"]
    # the rendered camera's pose at frame 20, carried to the body
    stream = stereo_imu_stream.generate(dict(tr, frames=21, draw_distance_m=0.5),
                                        cfg["camera"], 7, "cpu")
    Twb = stream.gt_Twc[20] @ np.linalg.inv(Tbc)
    assert abs(T - 1.0) < 1e-12
    assert np.linalg.norm(R1.T @ Twb[:3, :3] - np.eye(3)) < 2e-4
    assert np.linalg.norm(p1 - Twb[:3, 3]) < 2e-3
    assert np.linalg.norm(Twb[:3, 3] - stream.gt_Twc[0, :3, 3]) > 0.5  # it did fly


def _small_vio(name="vio_euroc.slow"):
    bench, cell, wl, cfg = _load(name)
    wl = copy.deepcopy(wl)
    wl["traffic"]["frames"] = VIO_SMALL["frames"]
    wl["check"].update(frames=VIO_SMALL["check_frames"], pose_only_calls=2, local_ba_calls=1,
                       keyframes=2)
    wl["trace"] = {"frames": 1, "max_frames": 2}
    return bench, cell, wl, cfg


def drive_vio(seed, trace=False, seconds=None, **hooks):
    from slambench import run as R
    from slambench.drivers import vio

    torch.set_num_threads(4)
    bench, cell, wl, cfg = _small_vio()
    ctx = R.RunContext(bench, cell, wl, cfg, seed, seconds or VIO_SMALL["seconds"], trace,
                       torch.device("cpu"), time.perf_counter())
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = vio.run(ctx, **hooks)
    lines = [l for l in out.getvalue().splitlines() if l.startswith("{")]
    return rc, (json.loads(lines[-1]) if lines else None)


def test_a_sound_vio_run_is_correct_on_the_cpu():
    rc, line = drive_vio(2 ** 31 + 51, trace=True)
    assert rc == 0 and line is not None and line["correct"] is True, line and line["checks"]
    assert line["checks"]["vi_frames_missed"]["value"] == 0
    assert {"vi_pose_ms", "imu_preint_ms", "pose_ms"} <= set(line["metrics"])


@pytest.mark.parametrize("fault", ["imu_dropped", "gravity_flipped", "window_left"])
def test_a_planted_fault_makes_the_vio_run_incorrect(fault, monkeypatch):
    """``window_left``: every VI local BA returns its window as it found it,
    as when every LM step is rejected; ``vlba_stuck`` counts them."""
    from airslam_tpu_torch.backend import residuals, windows

    if fault == "window_left":
        real_lba = windows.local_ba

        def left(problem, *a, **k):
            if problem.imu is None:
                return real_lba(problem, *a, **k)
            return problem, problem.point_obs_mask, problem.line_obs_mask

        monkeypatch.setattr(windows, "local_ba", left)
    elif fault == "imu_dropped":
        real_vi = windows._pose_only_fast_vi

        def dropped(problem, intr, cfg, rounds=3, iters=10):
            off = problem.imu._replace(mask=torch.zeros_like(problem.imu.mask))
            return real_vi(problem._replace(imu=off), intr, cfg, rounds=rounds, iters=iters)

        monkeypatch.setattr(windows, "_pose_only_fast_vi", dropped)
    else:
        real = residuals.imu_residual

        def flipped(*a):  # g_value, the last argument, with its sign flipped
            return real(*a[:-1], -a[-1])

        monkeypatch.setattr(residuals, "imu_residual", flipped)
    rc, line = drive_vio(2 ** 31 + 52)
    assert rc == 0 and line is not None
    assert line["correct"] is False, line["checks"]
    if fault == "window_left":
        assert line["checks"]["vlba_stuck"]["value"] >= 1, line["checks"]


# -- the control, on the card at the cell's own size ------------------------------

CONTROL_SEEDS = (3_000_000_011, 3_000_000_012, 3_000_000_013)
VI_LIMITS = ("preint_gap", "vi_pose_gap_m", "vi_rot_gap", "vi_vel_gap", "vlba_pose_gap_m",
             "vlba_rot_gap", "vlba_point_gap_m", "vlba_vel_gap", "vlba_bias_gap",
             "vlba_cost_gap", "init_gravity_gap", "init_bg_gap")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's size on the card")
    return torch.device("cuda", 0)


def control_run(seed, device, seconds=50.0):
    """One run of ``vio_euroc.slow`` with the map, and with it the IMU
    preintegration and the VI solves, in float32 (the VO CLI's default)
    below the float64 the configuration states; returns the result line."""
    from slambench import run as R
    from slambench.drivers import vio

    bench, cell, wl, cfg = _load("vio_euroc.slow")
    cfg = dict(copy.deepcopy(cfg), backend_dtype="float32")
    ctx = R.RunContext(bench, cell, wl, cfg, seed, seconds, False, device, time.perf_counter())
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = vio.run(ctx)
    assert rc == 0
    return json.loads([l for l in out.getvalue().splitlines() if l.startswith("{")][-1])


@pytest.mark.cuda
@pytest.mark.parametrize("seed", CONTROL_SEEDS)
def test_vio_control_float32_is_not_correct(card, seed):
    line = control_run(seed, card)
    failed = [k for k in VI_LIMITS if line["checks"][k]["value"] > line["checks"][k]["limit"]]
    assert line["correct"] is False and failed, line["checks"]


LBA_LIMITS = ("lba_pose_gap_m", "lba_rot_gap", "lba_point_gap_m", "lba_cost_gap")


def vo_control_run(seed, device, seconds=50.0):
    """One run of ``vo_euroc.slow`` with the map in float32 below the
    float64 the configuration states: the window backend's control at this
    cell's keyframe rate (its ``lba_*`` limits are ``vo_euroc.fast``'s)."""
    from slambench import run as R
    from slambench.drivers import vo

    bench, cell, wl, cfg = _load("vo_euroc.slow")
    cfg = dict(copy.deepcopy(cfg), backend_dtype="float32")
    ctx = R.RunContext(bench, cell, wl, cfg, seed, seconds, False, device, time.perf_counter())
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = vo.run(ctx)
    assert rc == 0
    return json.loads([l for l in out.getvalue().splitlines() if l.startswith("{")][-1])


@pytest.mark.cuda
@pytest.mark.parametrize("seed", CONTROL_SEEDS)
def test_vo_slow_local_ba_control_float32_is_not_correct(card, seed):
    line = vo_control_run(seed, card)
    failed = [k for k in LBA_LIMITS if line["checks"][k]["value"] > line["checks"][k]["limit"]]
    assert line["correct"] is False and failed, line["checks"]
