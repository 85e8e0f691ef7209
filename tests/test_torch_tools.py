"""The last bring-up slice's tools against the JAX package on the CPU:
``backend/validate.py``'s printers (float64, 1e-9 relative),
``utils/debugviz.py``'s writers (equal pixels), ``utils/device.py``, and the
four CLIs ``apps/test_feature_torch.py`` (the JAX CLI's printed counts, the
card's f32 frontend gates), ``apps/run_launch_torch.py`` (the JAX parser's
nodes, the port's apps), ``apps/run_batch_torch.py`` (the JAX runner's
commands on the port's apps) and ``apps/bench_backend_torch.py`` (the JAX
``local_ba`` on its window: 1e-6 m in float64 at a small shape, 1e-4 m in
float32 at the app's own, ``PARITY_TPU.json``'s ``local_ba`` gate).
"""

import contextlib
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from airslam_tpu.backend import validate as jvalidate
from airslam_tpu.backend import windows as jwindows
from airslam_tpu.utils import debugviz as jviz
from airslam_tpu_torch.backend import validate, windows
from airslam_tpu_torch.utils import debugviz, device as device_util
from scripts import make_torch_oracle as mto

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "apps"))
import bench_backend_torch  # noqa: E402
import run_batch_torch  # noqa: E402
import run_launch_torch  # noqa: E402
import test_feature_torch  # noqa: E402

F64 = torch.float64


def _quiet(fn, *args, **kw):
    """(fn's result, its printed lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue().splitlines()


def _same_dict(got, want, rtol=1e-9):
    assert list(got) == list(want)
    for k in want:
        assert type(got[k]) is type(want[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=0, err_msg=k)


def _keys(lines):
    """Each printed line's label and its keys (the values aside)."""
    return [(ln.split("]")[0], [w.split("=")[0] for w in ln.split("] ")[1].split()
                                if "=" in w]) for ln in lines]


# ---------------------------------------------------------------------------
# backend/validate.py
# ---------------------------------------------------------------------------


def test_validate_reprojection_and_imu_equal_jax():
    """``validate_reprojection`` on ``apps/bench_backend.py``'s perturbed
    window (half a pixel of noise on its observations) and after its local
    BA, ``validate_imu`` with a synthetic IMU chain, float64: the JAX dicts
    within 1e-9 relative (exact zeros equal), the same printed labels and
    keys."""
    from __graft_entry__ import _synthetic_imu_chain
    from airslam_tpu_torch.entry import _intrinsics, window_problem

    jp, jintr, scene = mto.jax_bench_window(*mto.TOOLS["bench"], dtype=jnp.float64)
    tp, _ = bench_backend_torch.window(*mto.TOOLS["bench"], F64, torch.device("cpu"))
    intr = _intrinsics()
    np.testing.assert_array_equal(tp.points.numpy(), np.asarray(jp.points))
    # half a pixel of noise on the observations, so that the BA leaves
    # residuals well above float64's rounding
    noise = np.random.RandomState(4).randn(*tp.point_obs.shape) * 0.5
    jp = jp._replace(point_obs=jp.point_obs + noise)
    tp = tp._replace(point_obs=tp.point_obs + torch.from_numpy(noise))
    for label, j, t in (("before", jp, tp),
                        ("after", jwindows.local_ba(jp, jintr)[0], windows.local_ba(tp, intr)[0])):
        want, wl = _quiet(jvalidate.validate_reprojection, j, jintr, label)
        got, gl = _quiet(validate.validate_reprojection, t, intr, label)
        assert want["n_point_obs"] > 1000 and want["point_chi2_mean"] > 0
        _same_dict(got, want)
        assert _keys(gl) == _keys(wl)
    f = int(jp.frames.twb.shape[0])
    chain = _synthetic_imu_chain(np.arange(f - 1), np.arange(1, f), jnp.float64)
    jimu = jp._replace(imu=chain)
    # the JAX chain's values (some of them float32) as the port's factors
    timu = window_problem(scene, Rwb=tp.frames.Rwb.numpy(), twb=tp.frames.twb.numpy(),
                          points=tp.points.numpy(), dtype=F64, imu=windows.gn.IMUFactors(
                              **{k: np.asarray(v) for k, v in chain._asdict().items()}))
    want, wl = _quiet(jvalidate.validate_imu, jimu, "imu")
    got, gl = _quiet(validate.validate_imu, timu, "imu")
    assert want["n_factors"] == f - 1
    _same_dict(got, want)
    assert _keys(gl) == _keys(wl)
    none, lines = _quiet(validate.validate_imu, tp)
    assert none == {} and lines == ["[validate] no IMU factors"]


def _chain(pkg_imu, device_kw, seq, kf_idx, noise):
    """Keyframe stubs over ``seq`` at ``kf_idx`` with ``pkg_imu``'s
    preintegrations between them (tests/test_debugviz.py's chain)."""
    frames = []
    for i, kf in enumerate(kf_idx):
        fr = type("F", (), {})()
        fr.frame_id = i
        Twb = np.eye(4)
        Twb[:3, :3] = seq["Rwb"][kf]
        Twb[:3, 3] = seq["pos"][kf]
        fr.imu_pose = (lambda T: lambda Tcb: T)(Twb)
        fr.velocity = seq["vel"][kf].copy()
        fr.preintegration = None
        frames.append(fr)
    times = seq["times"]
    for i, (a, b) in enumerate(zip(kf_idx[:-1], kf_idx[1:])):
        rows = [pkg_imu.ImuData(times[k], seq["gyr"][k], seq["acc"][k]) for k in range(a, b + 1)]
        p = pkg_imu.Preintegration(noise=noise, **device_kw)
        p.add_batch(rows, times[a], times[b])
        frames[i + 1].preintegration = p
    return frames


def test_frame_chain_validators_equal_jax():
    """``validate_gyr_bias``, ``validate_velocity`` and
    ``validate_imu_initialization`` on tests/test_debugviz.py's VI chain,
    with a gyro bias the preintegrations do not know and a corrupted
    velocity (so that every residual is far from zero), both packages'
    preintegrations from the same rows in float64: the JAX dicts within 1e-9
    relative, the same printed labels and keys."""
    from airslam_tpu.core import imu as jimu
    from airslam_tpu_torch.core import imu as timu
    from tests.synthetic import make_imu_sequence

    seq = make_imu_sequence(duration=2.0, bg=np.array([0.02, -0.015, 0.01]))
    kf_idx = np.arange(0, len(seq["times"]), 100)
    noise = (1e-3, 1e-2, 1e-5, 1e-4)
    jf = _chain(jimu, {}, seq, kf_idx, noise)
    tf = _chain(timu, {"dtype": F64, "device": "cpu"}, seq, kf_idx, noise)
    for fr in (jf[1], tf[1]):
        fr.velocity = fr.velocity + 0.5
    g = np.array([0.0, 0.0, -9.81])
    for name, args in (("validate_gyr_bias", (np.eye(4),)),
                       ("validate_velocity", (np.eye(4), g)),
                       ("validate_imu_initialization", (np.eye(4), 9.81))):
        want, wl = _quiet(getattr(jvalidate, name), jf, *args, label="chain")
        got, gl = _quiet(getattr(validate, name), tf, *args, label="chain")
        assert want["n"] == len(kf_idx) - 1
        _same_dict(got, want)
        assert _keys(gl[-1:]) == _keys(wl[-1:]) and len(gl) == len(wl)
        assert [ln.split(" ")[:2] for ln in gl[:-1]] == [ln.split(" ")[:2] for ln in wl[:-1]]


# ---------------------------------------------------------------------------
# utils/debugviz.py
# ---------------------------------------------------------------------------


def test_debugviz_writers_write_the_jax_pixels(tmp_path):
    """Each of the nine writers on tests/test_debugviz.py's inputs writes the
    JAX writer's pixels, from numpy arrays and from tensors alike."""
    rng = np.random.RandomState(0)
    left, right = rng.rand(480, 752).astype(np.float32), rng.rand(480, 752).astype(np.float32)
    kpts = np.asarray([[100.0, 120.0], [300.0, 200.0], [500.0, 400.0], [50.0, 60.0]])
    pairs = np.asarray([[0, 1], [2, 3]])
    lines = np.asarray([[50.0, 50.0, 400.0, 90.0], [100.0, 300.0, 600.0, 310.0]])
    relation = np.zeros((2, 4), bool)
    relation[0, 0] = relation[1, 2] = True
    mm = np.zeros((4, 4), bool)
    mm[0, 1] = mm[2, 2] = True
    calls = {
        "save_detector_result": ((left, kpts), {"kp_mask": np.array([1, 0, 1, 1], bool)}),
        "save_line_detection_result": ((left, lines), {"line_mask": np.array([True, False]),
                                                        "keypoints": kpts, "relation": relation}),
        "save_matching_result": ((left, kpts, right, kpts, pairs), {}),
        "save_tracking_result": ((left, kpts, right, kpts + 3.0, pairs), {}),
        "save_stereo_match_result": ((left, right, kpts, kpts + [0.0, 5.0], pairs), {}),
        "save_point_line_relation": ((left, lines, kpts, relation), {}),
        "save_stereo_line_match": ((left, right, lines, lines + [5.0, 0, 5.0, 0], [1, -1]),
                                   {"points_on_line_left": relation, "kpts_left": kpts}),
        "save_dbow_matching_results": ((left, [right, left]),
                                       {"scores": [0.8, 0.5], "shared_words": [40, 22]}),
        "save_dbow_junction_matching": ((left, right, kpts, kpts, mm), {}),
    }

    def tensors(x):
        if isinstance(x, np.ndarray):
            return torch.from_numpy(x.copy())
        if isinstance(x, list) and x and isinstance(x[0], np.ndarray):
            return [torch.from_numpy(a) for a in x]
        return x

    for name, (args, kw) in calls.items():
        want_p, got_p, tens_p = (str(tmp_path / f"{name}_{s}.png") for s in ("jax", "np", "t"))
        getattr(jviz, name)(want_p, *args, **kw)
        getattr(debugviz, name)(got_p, *args, **kw)
        getattr(debugviz, name)(tens_p, *(tensors(a) for a in args),
                                **{k: tensors(v) for k, v in kw.items()})
        want = cv2.imread(want_p)
        assert want is not None and want.size > 0, name
        assert np.array_equal(cv2.imread(got_p), want), name
        assert np.array_equal(cv2.imread(tens_p), want), name


# ---------------------------------------------------------------------------
# utils/device.py
# ---------------------------------------------------------------------------


def test_device_select(monkeypatch):
    """``cpu`` selects the CPU; ``auto`` (the default) and ``cuda`` mean the
    card and raise without one: no fallback to the CPU."""
    import argparse

    ap = argparse.ArgumentParser()
    device_util.add_arg(ap)
    assert ap.parse_args([]).device == "auto"
    with pytest.raises(SystemExit):
        ap.parse_args(["--device", "tpu"])
    assert device_util.select("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("auto", "cuda", None):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            device_util.select(name)


# ---------------------------------------------------------------------------
# the four CLIs
# ---------------------------------------------------------------------------


def test_test_feature_cli_against_jax(tmp_path):
    """``apps/test_feature_torch.py --device cpu`` and ``apps/test_feature.py``
    on two left images of the frontend oracle, rectified with euroc.yaml's
    map: the same printed lines, the card's f32 frontend gates on every
    image, an annotated image per input."""
    frames = np.load(chip_smoke.ORACLE)["frames_u8"]
    img = tmp_path / "images"
    img.mkdir()
    for i in range(2):
        cv2.imwrite(str(img / f"{i:02d}.png"), frames[i, 0])
    cam = os.path.join(REPO, "configs", "camera", "euroc.yaml")
    with jax.enable_x64(False):  # the JAX CLI enables no x64
        want, wl = mto.jax_test_feature(str(img), str(tmp_path / "jax"),
                                        ["--camera_config_path", cam])
    got, gl = _quiet(test_feature_torch.main, ["--image_dir", str(img), "--save_dir",
                                               str(tmp_path / "port"), "--camera_config_path",
                                               cam, "--device", "cpu"])
    assert gl == wl and len(gl) == 2
    for (gn, g), (wn, w) in zip(got, want):
        assert gn == wn
        m = chip_smoke.detection_metrics({k: np.asarray(getattr(w, k))
                                          for k in chip_smoke.TOOLS_FIELDS},
                                         {k: getattr(g, k) for k in chip_smoke.TOOLS_FIELDS})
        assert all(m[k] >= v for k, v in chip_smoke.DETECT_GATES.items()), (gn, m)
        out = cv2.imread(str(tmp_path / "port" / gn))
        assert out is not None and out.shape == (480, 752, 3)


LAUNCH = """<launch>
  <arg name="dataroot" default="/data/seq/mav0"/>
  <arg name="saving_dir" default="$(find air_slam)/out"/>
  <arg name="visualization" default="false"/>
  <node name="vo" pkg="air_slam" type="visual_odometry" output="screen">
    <param name="config_path" value="$(find air_slam)/configs/visual_odometry/vo_euroc.yaml"/>
    <param name="camera_config_path" value="$(find air_slam)/configs/camera/euroc.yaml"/>
    <param name="dataroot" value="$(arg dataroot)"/>
    <param name="saving_dir" value="$(arg saving_dir)"/>
    <param name="model_dir" value="$(find air_slam)/output"/>
  </node>
  <group if="$(arg visualization)">
    <node name="rviz" pkg="rviz" type="rviz"/>
  </group>
  <node name="reloc" pkg="air_slam" type="relocalization">
    <param name="config_path" value="$(find air_slam)/configs/relocalization/reloc_euroc.yaml"/>
    <param name="map_root" value="$(arg saving_dir)"/>
    <param name="dataroot" value="$(arg dataroot)"/>
    <param name="voc_path" value="$(find air_slam)/voc/point_voc_L4.bin"/>
  </node>
</launch>
"""


def test_run_launch_parses_as_jax_and_runs_the_port_apps(tmp_path, monkeypatch):
    """``parse_launch`` equals the JAX parser's on a launch file with args,
    overrides, ``$(find)``, a skipped rviz group and two nodes; each node's
    command names the port's app with the JAX mapping of its params; ``main``
    runs one subprocess per node with the passed-through flags."""
    from apps import run_launch as jrl

    lf = tmp_path / "vo.launch"
    lf.write_text(LAUNCH)
    over = {"dataroot": str(tmp_path / "mav0")}
    got = run_launch_torch.parse_launch(str(lf), over, find_root=REPO)
    assert got == jrl.parse_launch(str(lf), over, find_root=REPO)
    assert [n for n, _ in got] == ["visual_odometry", "relocalization"]
    for node, params in got:
        cmd = run_launch_torch.node_command(node, params, ["--device", "cpu"])
        jcmd = jrl.node_command(node, params, ["--device", "cpu"])
        assert cmd[1] == jcmd[1].replace(".py", "_torch.py") and cmd[1].endswith("_torch.py")
        assert os.path.exists(cmd[1])
        assert cmd[2:] == jcmd[2:]
    calls = []

    class R:
        returncode = 0

    monkeypatch.setattr(run_launch_torch.subprocess, "run", lambda cmd: calls.append(cmd) or R())
    run_launch_torch.main([str(lf), f"saving_dir:={tmp_path / 'out'}", "--device", "cpu"])
    assert [os.path.basename(c[1]) for c in calls] == ["visual_odometry_torch.py",
                                                       "relocalization_torch.py"]
    assert all(c[-2:] == ["--device", "cpu"] for c in calls)
    assert f"--saving_dir {tmp_path / 'out'}" in " ".join(calls[0])


def test_run_batch_commands_equal_jax(tmp_path, monkeypatch):
    """Per stage, the commands ``run_batch_torch`` runs over two sequences
    (one with ground truth) are the JAX runner's with the port's apps and
    ``--device cpu``; ``_euroc_gt_to_tum`` writes the JAX file."""
    from apps import run_batch as jrb

    root = tmp_path / "data"
    for seq in ("A", "B"):
        (root / seq / "mav0" / "cam0" / "data").mkdir(parents=True)
    gt = root / "A" / "mav0" / "state_groundtruth_estimate0"
    gt.mkdir()
    (gt / "data.csv").write_text("#timestamp,p,q\n1000000000,1,2,3,1,0,0,0\n"
                                 "1050000000,1.5,2,3,0.9,0.1,0,0\n")
    cfg = os.path.join(REPO, "configs", "visual_odometry", "vo_euroc.yaml")
    cam = os.path.join(REPO, "configs", "camera", "euroc.yaml")

    def run(module, argv, out):
        calls = []

        def call(cmd):
            calls.append(cmd)
            if cmd[1].endswith(("visual_odometry.py", "visual_odometry_torch.py")):
                open(os.path.join(cmd[cmd.index("--saving_dir") + 1], "trajectory_v0.txt"),
                     "w").close()
            return 0

        monkeypatch.setattr(module.subprocess, "call", call)
        args = argv + ["--out_root", str(out)]
        if module is jrb:
            monkeypatch.setattr(sys, "argv", ["run_batch.py"] + args + ["--device", "cpu"])
            _quiet(module.main)
        else:
            _quiet(module.main, args + ["--device", "cpu"])
        return calls

    for stage, extra in (("vo", ["--camera_config_path", cam, "--max_frames", "3"]),
                         ("refine", []), ("reloc", [])):
        argv = ["--stage", stage, "--config_path", cfg, "--dataset_root", str(root)] + extra
        want = run(jrb, argv, tmp_path / "jax" / stage)
        got = run(run_batch_torch, argv, tmp_path / "port" / stage)
        assert len(got) == len(want) and len(got) >= 2, stage
        for g, w in zip(got, want):
            w = [a.replace(str(tmp_path / "jax"), str(tmp_path / "port")) for a in w]
            assert g[1] == w[1].replace(".py", "_torch.py") and os.path.exists(g[1])
            assert g[2:] == w[2:]
    a, b = tmp_path / "gt_port.txt", tmp_path / "gt_jax.txt"
    run_batch_torch._euroc_gt_to_tum(str(gt / "data.csv"), str(a))
    jrb._euroc_gt_to_tum(str(gt / "data.csv"), str(b))
    assert a.read_text() == b.read_text() and len(a.read_text().splitlines()) == 2


def test_bench_backend_against_jax_local_ba():
    """``apps/bench_backend_torch.py`` at a small shape (3 frames, 40
    points) in float64 against the JAX ``local_ba`` on the same window:
    poses within 1e-6 m; at the app's own shape in float32 (its default)
    against the stored JAX float32 run: within 1e-4 m (``PARITY_TPU.json``'s
    ``local_ba`` gate), the same inliers."""
    out, lines = _quiet(bench_backend_torch.main, ["--frames", "3", "--points", "40",
                                                   "--dtype", "f64", "--device", "cpu",
                                                   "--calls", "1", "--warmup", "0"])
    jp, jintr, scene = mto.jax_bench_window(3, 40, 0, dtype=jnp.float64)
    jout, jin, _ = jwindows.local_ba(jp, jintr)
    assert np.abs(out["twb"] - np.asarray(jout.frames.twb)).max() <= 1e-6
    assert out["inliers"] == int(np.asarray(jin).sum())
    assert len(lines) == 3 and "pose err vs GT" in lines[0] and "ms" in lines[1]
    z = np.load(chip_smoke.TOOLS_ORACLE)
    out32, _ = _quiet(bench_backend_torch.main, ["--device", "cpu", "--calls", "1",
                                                 "--warmup", "0"])
    assert np.abs(out32["twb"] - z["bench_twb"]).max() <= 1e-4
    assert out32["inliers"] == int(z["bench_inliers"])
    assert json.loads(str(z["validate"]))["before"]["n_point_obs"] == out32["n_obs"]
