"""The port's ``io`` package and its VO CLI against the JAX package's on the
CPU: the three config classes over every YAML under ``configs/``, TUM
trajectory files, map files read across the two packages both ways (schema
1: a pickle of plain dicts, numpy arrays and Python scalars), the ASL
dataset loader, and ``apps/visual_odometry_torch.py --device cpu`` on a tiny
rendered sequence."""

import dataclasses
import glob
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from airslam_tpu.io import config as jconfig
from airslam_tpu.io import serialization as jser
from airslam_tpu.io import trajectory as jtraj
from airslam_tpu.pipelines.map_builder import KeyframeConfig as JKeyframeConfig
from airslam_tpu.pipelines.map_builder import MapBuilder as JMapBuilder
from airslam_tpu_torch.io import config, dataset, serialization, trajectory
from airslam_tpu_torch.pipelines.map_builder import KeyframeConfig, MapBuilder
from tests import test_vo_lines as jlines
from tests import test_vo_pipeline as jvo
from tests.test_torch_map import Camera, Matcher

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fields(obj):
    """Dataclass or NamedTuple as a dict without the compute type."""
    d = obj._asdict() if hasattr(obj, "_asdict") else dataclasses.asdict(obj)
    d.pop("dtype", None)
    return d


def _yamls(kind):
    return sorted(glob.glob(os.path.join(REPO, "configs", kind, "*.yaml")))


def _assert_same_config(got, want):
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(g) or hasattr(g, "_asdict"):
            g, w = _fields(g), _fields(w)
            shared = set(g) & set(w)  # the port keeps no field of an unported option
            assert shared and {k: g[k] for k in shared} == {k: w[k] for k in shared}, f.name
            assert set(g) <= set(w) | {"use_flash"}, f.name
        else:
            assert g == w, f.name


@pytest.mark.parametrize("kind,name", [("visual_odometry", "VisualOdometryConfigs"),
                                       ("map_refinement", "MapRefinementConfigs"),
                                       ("relocalization", "RelocalizationConfigs")])
def test_config_classes_parse_every_yaml_like_jax(kind, name):
    paths = _yamls(kind)
    assert len(paths) >= 2
    for path in paths:
        got = getattr(config, name).load(path)
        want = getattr(jconfig, name).load(path)
        assert [f.name for f in dataclasses.fields(got)] == \
            [f.name for f in dataclasses.fields(want)]
        _assert_same_config(got, want)
    vo = config.VisualOdometryConfigs.load(
        os.path.join(REPO, "configs", "visual_odometry", "vo_euroc.yaml"), saving_dir="out")
    assert vo.saving_dir == "out" and vo.matcher.matcher == 0 and vo.early_exit == 0.0
    assert vo.detector.use_superpoint and vo.detector.max_keypoints == 400
    assert config.SG_SINKHORN_ITERS == 20


def test_superglue_config_parses_but_the_matcher_waits():
    """``matcher: 1`` parses with the shipped checkpoint's Sinkhorn depth, and
    the matcher no longer waits: it builds SuperGlue (stage 3) with the
    SuperGlue decode's threshold and keypoint scale."""
    cfg = config.parse_matcher_config({"point_matcher": {"matcher": 1}})
    assert cfg.sinkhorn_iterations == config.SG_SINKHORN_ITERS
    from airslam_tpu_torch.frontend.matcher import PointMatcher
    from airslam_tpu_torch.models.superglue import SuperGlue

    matcher = PointMatcher(cfg, device="cpu")
    assert isinstance(matcher.model, SuperGlue)
    assert matcher.model.sinkhorn_iterations == config.SG_SINKHORN_ITERS
    assert (matcher.threshold, matcher.norm_scale) == (0.2, 0.7)


def _random_trajectory(n=6, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        T = np.eye(4)
        T[:3, :3] = Rotation.random(random_state=rng).as_matrix()
        T[:3, 3] = rng.randn(3)
        out.append((1403636579.8 + i * 0.05, T))
    return out


def test_tum_files_equal_jax_and_read_both_ways(tmp_path):
    traj = _random_trajectory()
    ours, theirs = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    trajectory.save_tum(ours, traj)
    jtraj.save_tum(theirs, traj)
    a = np.loadtxt(ours)
    b = np.loadtxt(theirs)
    assert np.abs(a - b).max() <= 1e-8
    for path, loader in ((theirs, trajectory.load_tum), (ours, jtraj.load_tum)):
        for (t0, T0), (t1, T1) in zip(traj, loader(path)):
            assert abs(t0 - t1) < 1e-6 and np.allclose(T0, T1, atol=1e-7)


def test_ate_rmse_equals_jax():
    gt = [(i * 0.1, np.block([[np.eye(3), np.array([[i * 0.1], [np.sin(i * 0.3)], [0.0]])],
                              [np.zeros((1, 3)), np.ones((1, 1))]])) for i in range(20)]
    R = Rotation.from_euler("z", 0.7).as_matrix()
    est = []
    rng = np.random.RandomState(1)
    for t, T in gt:
        T2 = np.eye(4)
        T2[:3, 3] = 1.3 * R @ T[:3, 3] + np.array([5, -2, 1]) + rng.randn(3) * 0.01
        est.append((t, T2))
    for align in (True, False):
        assert abs(trajectory.ate_rmse(est, gt, align) - jtraj.ate_rmse(est, gt, align)) <= 1e-12
    assert trajectory.ate_rmse(est, gt) < 0.05 < trajectory.ate_rmse(est, gt, align=False)


@pytest.fixture(scope="module")
def line_maps():
    """The line stream of tests/test_vo_lines.py through both builders."""
    kf = dict(min_init_stereo_feature=50, max_num_match=500, tracking_point_rate=2.0)
    jb = JMapBuilder(jvo.FakeCamera(), None, jvo.FakeMatcher(), kf_config=JKeyframeConfig(**kf))
    tb = MapBuilder(Camera(), None, Matcher(), kf_config=KeyframeConfig(**kf), device="cpu",
                    dtype=torch.float64)
    segments, pts, desc, _ = jlines.make_line_world()
    for i in range(5):
        T = np.eye(4)
        T[:3, 3] = [0.05 * i, 0.01 * i, 0.1 * i]
        fl, fr, pairs = jlines.render(segments, pts, desc, T, jvo.FakeCamera())
        jb.track_features(i * 0.1, fl, fr, pairs)
        tb.track_features(i * 0.1, fl, fr, pairs)
    return jb.map, tb.map


def _assert_map_equal(a, b):
    assert a.keyframe_ids == b.keyframe_ids and sorted(a.mappoints) == sorted(b.mappoints)
    for fid in a.keyframe_ids:
        fa, fb = a.keyframes[fid], b.keyframes[fid]
        for name in ("Twc", "keypoints", "kp_desc", "kp_mask", "lines", "u_right", "depth",
                     "track_ids", "mappoint_ids", "lines_right", "lines_right_valid",
                     "line_track_ids", "mapline_ids", "points_on_lines", "junctions"):
            np.testing.assert_array_equal(getattr(fa, name), getattr(fb, name), err_msg=name)
        assert (fa.previous_frame.frame_id if fa.previous_frame else -1) == \
            (fb.previous_frame.frame_id if fb.previous_frame else -1)
    for tid, p in a.mappoints.items():
        q = b.mappoints[tid]
        assert p.type.value == q.type.value and p.observers == q.observers
        np.testing.assert_array_equal(p.position, q.position)
    for lid, l in a.maplines.items():
        m = b.maplines[lid]
        assert l.type.value == m.type.value and l.observers == m.observers
        assert l.endpoint_status == m.endpoint_status and l.endpoints_valid == m.endpoints_valid
        np.testing.assert_array_equal(l.line3d, m.line3d)
        np.testing.assert_array_equal(l.endpoints, m.endpoints)
    assert a.covisibility == b.covisibility and a.imu_initialized == b.imu_initialized
    np.testing.assert_array_equal(a.Rwg, b.Rwg)


def _no_foreign_objects(obj, path="state"):
    """Only dicts, lists, tuples, numpy arrays and scalars, Python scalars."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            _no_foreign_objects(k, path)
            _no_foreign_objects(v, f"{path}[{k!r}]")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _no_foreign_objects(v, f"{path}[{i}]")
    else:
        assert obj is None or isinstance(obj, (np.ndarray, np.generic, int, float, bool, str)), \
            (path, type(obj))


def test_map_file_written_by_the_port_loads_in_jax_and_back(line_maps, tmp_path):
    _, tm = line_maps
    path = str(tmp_path / "AirSLAM_mapv0.bin")
    serialization.save_map(tm, path)
    with open(path, "rb") as f:
        state = pickle.load(f)
    assert state["schema"] == serialization.SCHEMA_VERSION == jser.SCHEMA_VERSION == 1
    _no_foreign_objects(state)
    jm, dbs = jser.load_map(path)
    assert dbs == {}
    _assert_map_equal(tm, jm)
    jm.check_map()
    back, _ = serialization.load_map(path, device="cpu", dtype=torch.float64)
    _assert_map_equal(tm, back)
    assert back.dtype == torch.float64 and back.device.type == "cpu"
    assert back._intr.fx == tm._intr.fx and back.camera.Tcb.shape == (4, 4)


def test_map_file_written_by_jax_loads_in_the_port_and_goes_on(line_maps, tmp_path):
    jm, tm = line_maps
    path = str(tmp_path / "jax_mapv0.bin")
    jser.save_map(jm, path)
    got, _ = serialization.load_map(path, camera=Camera(), device="cpu", dtype=torch.float64)
    _assert_map_equal(jm, got)
    got.check_map()
    # the loaded map is a working map: its last window optimizes again
    last = got.keyframes[got.keyframe_ids[-1]]
    before = last.Twc.copy()
    got.local_map_optimization(last)
    assert np.abs(last.Twc - before).max() < 1e-4
    # and what the port writes from it, the JAX package reads
    again = str(tmp_path / "again.bin")
    serialization.save_map(got, again)
    _assert_map_equal(got, jser.load_map(again)[0])


def _preintegrations():
    """One preintegration of each package over the same two batches of rows,
    with a bias set and a bias update."""
    from airslam_tpu.core.imu import ImuData as JImuData, Preintegration as JPreintegration
    from airslam_tpu_torch.core.imu import ImuData, Preintegration

    rng = np.random.RandomState(8)
    stamps = np.arange(30) * 0.005
    gyr, acc = rng.randn(30, 3) * 0.1, rng.randn(30, 3) + [0, 0, 9.81]
    noise = (1e-3, 1e-2, 1e-5, 1e-4)
    ours = Preintegration(noise=noise, dtype=torch.float64, device="cpu")
    theirs = JPreintegration(noise=noise)
    for pre, cls in ((ours, ImuData), (theirs, JImuData)):
        for lo, hi in ((0, 16), (15, 30)):
            pre.add_batch([cls(*r) for r in zip(stamps[lo:hi], gyr[lo:hi], acc[lo:hi])],
                          stamps[lo], stamps[hi - 1])
        pre.set_bias([1e-3, 0.0, -2e-3], [0.01, 0.02, 0.0])
        pre.update_bias([2e-3, 0.0, -2e-3], [0.01, 0.02, 0.01])
    return ours, theirs


def _assert_preintegration_equal(a, b):
    for name in ("noise_diag", "walk_diag", "bg", "ba", "start_time", "end_time"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    for name in ("_rows_dt", "_rows_acc", "_rows_gyr"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)), err_msg=name)
    for x, y in zip(a.state, b.state):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=0, atol=1e-12)


def test_preintegration_state_waits(line_maps, tmp_path):
    """A keyframe's preintegration goes into the map file (it waited for the
    stereo-inertial slice until now) and comes back in both directions: the
    port's file read by the JAX package and the JAX package's by the port,
    with the rows, noise values, biases and times equal and the integrated
    state within 1e-12; the port restores it in the map's dtype on its
    device. The bias update (dbg, dba) is not part of the schema, in either
    package."""
    jm, tm = line_maps
    fid = tm.keyframe_ids[-1]
    ours, theirs = _preintegrations()
    tm.keyframes[fid].preintegration = ours
    jm.keyframes[fid].preintegration = theirs
    try:
        serialization.save_map(tm, str(tmp_path / "port.bin"))
        jser.save_map(jm, str(tmp_path / "jax.bin"))
        got_j = jser.load_map(str(tmp_path / "port.bin"))[0].keyframes[fid].preintegration
        got_t = serialization.load_map(str(tmp_path / "jax.bin"), camera=Camera(), device="cpu",
                                       dtype=torch.float64)[0].keyframes[fid].preintegration
    finally:
        tm.keyframes[fid].preintegration = jm.keyframes[fid].preintegration = None
    theirs.update_bias(theirs.bg, theirs.ba)
    _assert_preintegration_equal(got_j, theirs)
    _assert_preintegration_equal(got_t, ours)
    assert got_t.dtype == torch.float64 and got_t.device.type == "cpu"
    assert got_t.valid() and got_t.dT == pytest.approx(ours.dT, abs=1e-15)
    np.testing.assert_array_equal(got_t.dbg, np.zeros(3))


def _write_asl(root, n, shape=(48, 64), imu=False):
    import cv2

    rng = np.random.RandomState(0)
    t0 = 1403636579000000000
    for cam in ("cam0", "cam1"):
        (root / cam / "data").mkdir(parents=True)
    imgs = []
    for i in range(n):
        img = (rng.rand(*shape) * 255).astype(np.uint8)
        imgs.append(img)
        for cam in ("cam0", "cam1"):
            cv2.imwrite(str(root / cam / "data" / f"{t0 + i * 50_000_000}.png"), img)
    (root / "cam0" / "data" / "notes.txt").write_text("not a frame")
    os.remove(root / "cam1" / "data" / f"{t0 + (n - 1) * 50_000_000}.png")  # no right view
    if imu:
        (root / "imu0").mkdir()
        (root / "imu0" / "data.csv").write_text("#timestamp,wx,wy,wz,ax,ay,az\n")
    return imgs


def test_asl_dataset_loader_equals_jax(tmp_path):
    from airslam_tpu.io.dataset import Dataset as JDataset

    root = tmp_path / "mav0"
    imgs = _write_asl(root, 4)
    ours, theirs = dataset.Dataset(str(root)), JDataset(str(root))
    assert len(ours) == len(theirs) == 3
    assert ours.timestamps == theirs.timestamps and ours.left_paths == theirs.left_paths
    for i in range(3):
        a, b = ours.get(i), theirs.get(i)
        assert a[0] == b[0] and a[3] == b[3] == []
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], imgs[i].astype(np.float32) / 255.0)
    assert not dataset.Dataset(str(root), use_imu=True).use_imu  # no csv: vision only


def test_asl_dataset_with_an_imu_csv_waits(tmp_path):
    """An ASL tree with ``imu0/data.csv`` read with the IMU (it waited for the
    stereo-inertial slice until now): the frames outside the IMU's time range
    dropped and each frame's rows since the previous frame, with the first
    sample past it, equal to the JAX Dataset's; without ``use_imu`` the csv is
    not read."""
    from airslam_tpu.io.dataset import Dataset as JDataset

    root = tmp_path / "mav0"
    _write_asl(root, 6, imu=True)
    t0 = 1403636579000000000
    rng = np.random.RandomState(3)
    with open(root / "imu0" / "data.csv", "a") as f:
        # 200 Hz from just after frame 0 to just before frame 4
        for i in range(38):
            stamp = t0 + 10_000_000 + i * 5_000_000
            f.write(",".join([str(stamp)] + [repr(float(v)) for v in rng.randn(6)]) + "\n")
    ours, theirs = dataset.Dataset(str(root), use_imu=True), JDataset(str(root), use_imu=True)
    assert ours.use_imu and theirs.use_imu
    assert ours.timestamps == theirs.timestamps and ours.left_paths == theirs.left_paths
    assert len(ours) == 3  # frames 1, 2, 3: frame 0 before the rows, 4 after, 5 has no right view
    assert [len(b) for b in ours.imu_batches] == [len(b) for b in theirs.imu_batches]
    assert ours.imu_batches[0] == [] and len(ours.imu_batches[1]) > 5
    for ob, tb in zip(ours.imu_batches, theirs.imu_batches):
        for a, b in zip(ob, tb):
            assert a.timestamp == b.timestamp
            np.testing.assert_array_equal(a.gyr, b.gyr)
            np.testing.assert_array_equal(a.acc, b.acc)
    assert ours.imu_batches[1][-1].timestamp > ours.timestamps[1]  # the first sample past
    assert ours.get(2)[3] is ours.imu_batches[2]
    vision = dataset.Dataset(str(root))
    assert len(vision) == 5 and all(b == [] for b in vision.imu_batches)


def test_vo_cli_on_a_rendered_sequence(tmp_path):
    """``apps/make_synth_dataset.py`` renders 3 frames at 752×480; the port's
    CLI runs them on the CPU (float32 networks, the fused-attention path) and
    writes a trajectory and a map that both packages read."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    data = tmp_path / "ds"
    subprocess.run([sys.executable, os.path.join(REPO, "apps", "make_synth_dataset.py"),
                    "--out", str(data), "--frames", "3", "--texture", "0.1", "--seed", "3"],
                   check=True, env=env, cwd=REPO, capture_output=True)
    out = tmp_path / "out"
    run = subprocess.run(
        [sys.executable, os.path.join(REPO, "apps", "visual_odometry_torch.py"),
         "--config_path", os.path.join(REPO, "configs", "visual_odometry", "vo_euroc.yaml"),
         "--camera_config_path", os.path.join(REPO, "configs", "camera", "synth_stereo.yaml"),
         "--dataroot", str(data / "SYNTH_01" / "mav0"), "--saving_dir", str(out),
         "--max_frames", "3", "--device", "cpu", "--dtype", "f32", "--use_flash", "--pipelined"],
        env=env, cwd=REPO, capture_output=True, text=True)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "dataset: 3 frames on cpu" in run.stdout and "keyframe rate:" in run.stdout
    traj = trajectory.load_tum(str(out / "trajectory_v0.txt"))
    assert len(traj) == 3
    # 2.4 m/s forward at 20 Hz: 0.12 m per frame along the camera's z (world x)
    steps = np.diff(np.stack([T[:3, 3] for _, T in traj]), axis=0)
    assert np.abs(np.linalg.norm(steps, axis=1) - 0.12).max() < 0.02
    m, _ = serialization.load_map(str(out / "AirSLAM_mapv0.bin"), device="cpu")
    jm, _ = jser.load_map(str(out / "AirSLAM_mapv0.bin"))
    assert m.keyframe_ids == jm.keyframe_ids and len(m.keyframe_ids) >= 2
    assert sum(p.is_valid for p in m.mappoints.values()) > 100
    m.check_map()
    # without a card the default device fails instead of falling back
    if not torch.cuda.is_available():
        bad = subprocess.run(
            [sys.executable, os.path.join(REPO, "apps", "visual_odometry_torch.py"),
             "--config_path", "x", "--camera_config_path", "x", "--dataroot", "x",
             "--saving_dir", str(out)], env=env, cwd=REPO, capture_output=True, text=True)
        assert bad.returncode != 0 and "no CUDA device" in bad.stderr


def _vo_cli():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "visual_odometry_torch", os.path.join(REPO, "apps", "visual_odometry_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_vo_cli_builds_float32_networks_by_default(tmp_path):
    """The port's CLI builds its networks in float32 unless ``--dtype bf16``
    is given, as the JAX CLI builds them (FeatureDetector/PointMatcher at
    their f32 default); the geometry is float32 either way."""
    cli = _vo_cli()
    root = tmp_path / "mav0"
    _write_asl(root, 2)
    base = ["--config_path", os.path.join(REPO, "configs", "visual_odometry", "vo_euroc.yaml"),
            "--camera_config_path", os.path.join(REPO, "configs", "camera", "synth_stereo.yaml"),
            "--dataroot", str(root), "--saving_dir", str(tmp_path / "out"), "--device", "cpu"]
    assert cli.parse_args(base).dtype == "f32"
    for extra, want in (([], torch.float32), (["--dtype", "bf16"], torch.bfloat16)):
        builder, data, device = cli.build(cli.parse_args(base + extra))
        nets = (builder.detector.plnet, builder.detector.loi, builder.detector.superpoint,
                builder.matcher.model)
        assert builder.detector.config.dtype == builder.matcher.config.dtype == want
        assert all(net.dtype == want for net in nets if hasattr(net, "dtype"))
        assert builder.dtype == torch.float32 and device.type == "cpu" and len(data) == 1


def test_vo_cli_stereo_inertial_on_a_rendered_sequence(tmp_path):
    """``apps/make_synth_dataset.py`` renders 3 frames with their 200 Hz IMU
    rows; the port's CLI runs them on the CPU with
    ``configs/camera/synth_stereo_imu.yaml`` (``use_imu: 1``): the dataset
    hands the rows between frames to the builder, the keyframes after the
    first carry their preintegration into the map file, and both packages
    load it. 0.1 s of motion initializes no IMU (3 s and 10 keyframes)."""
    from airslam_tpu.io.dataset import Dataset as JDataset

    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    data = tmp_path / "ds"
    subprocess.run([sys.executable, os.path.join(REPO, "apps", "make_synth_dataset.py"),
                    "--out", str(data), "--frames", "3", "--texture", "0.1", "--seed", "3"],
                   check=True, env=env, cwd=REPO, capture_output=True)
    mav0 = data / "SYNTH_01" / "mav0"
    out = tmp_path / "out"
    run = subprocess.run(
        [sys.executable, os.path.join(REPO, "apps", "visual_odometry_torch.py"),
         "--config_path", os.path.join(REPO, "configs", "visual_odometry", "vo_euroc.yaml"),
         "--camera_config_path", os.path.join(REPO, "configs", "camera",
                                              "synth_stereo_imu.yaml"),
         "--dataroot", str(mav0), "--saving_dir", str(out), "--max_frames", "3",
         "--device", "cpu"],
        env=env, cwd=REPO, capture_output=True, text=True)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "dataset: 3 frames on cpu" in run.stdout and "imu initialized: False" in run.stdout
    ours = dataset.Dataset(str(mav0), use_imu=True)
    theirs = JDataset(str(mav0), use_imu=True)
    assert [len(b) for b in ours.imu_batches] == [len(b) for b in theirs.imu_batches]
    assert len(ours.imu_batches[1]) > 10  # 0.05 s at 200 Hz, both ends and one past
    assert len(trajectory.load_tum(str(out / "trajectory_v0.txt"))) == 3
    m, _ = serialization.load_map(str(out / "AirSLAM_mapv0.bin"), device="cpu")
    jm, _ = jser.load_map(str(out / "AirSLAM_mapv0.bin"))
    assert m.keyframe_ids == jm.keyframe_ids and len(m.keyframe_ids) >= 2
    assert m.camera.use_imu and not m.imu_initialized
    for fid in m.keyframe_ids[1:]:
        ours_pre, theirs_pre = m.keyframes[fid].preintegration, jm.keyframes[fid].preintegration
        assert ours_pre.valid() and theirs_pre.valid()
        assert ours_pre.dT == pytest.approx(theirs_pre.dT, abs=1e-6)
        np.testing.assert_array_equal(np.asarray(ours_pre._rows_dt),
                                      np.asarray(theirs_pre._rows_dt))
    assert m.keyframes[m.keyframe_ids[0]].preintegration is None
    m.check_map()
