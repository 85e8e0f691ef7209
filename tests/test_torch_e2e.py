"""The port's applications on the CPU against the JAX package's: the
rendered ASL tree (``apps/make_synth_dataset_torch.py``), the VO CLI chain on
it in both packages, the JAX map refiner on the port's map, the system
benchmark's JSON line and stage names, the timer and the evaluation.

``tests/data/torch_e2e_oracle.npz`` (``scripts/make_torch_oracle.py e2e``)
holds the JAX world and the JAX VO CLI's run over its rendered sequence; the
first frames are replayed here with the port's renderer, writer and CLI
(``chip_smoke.py`` phase ``e2e`` replays all 20 on the card). Tolerances:
PNGs within 1 grey level (the float renders agree within 1e-5, and the
writer truncates, so a value within 1e-5 of a grey level's edge may land on
either side), on at most 1e-3 of the pixels against the stored PNGs; CSVs
equal; the CPU replay's keyframes equal and its poses within 1e-3 m of the
JAX runs (both float32 on the CPU over the same PNGs up to such pixels).
"""

import contextlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = os.path.join(REPO, "tests", "data", "torch_e2e_oracle.npz")
N = 3  # frames replayed on the CPU
torch.set_num_threads(2)
ENV = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")


def _load(name, *parts):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, *parts))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MTO = _load("make_torch_oracle", "scripts", "make_torch_oracle.py")
BENCH = _load("benchmark_system_torch", "apps", "benchmark_system_torch.py")
MSD = _load("make_synth_dataset_torch", "apps", "make_synth_dataset_torch.py")
VO = _load("visual_odometry_torch", "apps", "visual_odometry_torch.py")
EVAL = _load("evaluate_torch", "apps", "evaluate_torch.py")


@pytest.fixture(autouse=True)
def _jax_f32():
    with jax.enable_x64(False):  # the JAX applications' precision; conftest turns x64 on
        yield


def _png(path_or_bytes):
    import cv2

    if isinstance(path_or_bytes, np.ndarray):
        return cv2.imdecode(path_or_bytes, cv2.IMREAD_UNCHANGED)
    return cv2.imread(str(path_or_bytes), cv2.IMREAD_UNCHANGED)


def _grey_gap(a, b):
    """(largest difference in grey levels, share of pixels that differ)."""
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), float((d > 0).mean())


def _read(path):
    with open(path) as f:
        return f.read()


def _keyframe_ids(saving_dir):
    from airslam_tpu_torch.io.serialization import load_map

    m, _ = load_map(os.path.join(saving_dir, "AirSLAM_mapv0.bin"), device="cpu")
    return m.keyframe_ids


def _positions(path):
    return np.loadtxt(path, ndmin=2)[:, 1:4]


@pytest.mark.parametrize("camera", [None, "synth_stereo_distorted.yaml"],
                         ids=["rectified", "distorted"])
def test_make_synth_dataset_with_jax_draws(tmp_path, camera):
    """``apps/make_synth_dataset_torch.py --device cpu --frames 3`` with the
    JAX app's world, texture and noise (rebuilt from its keys) writes the JAX
    app's tree: PNGs within 1 grey level, the IMU and ground-truth CSVs
    equal, and JAX's dataset reader reads both alike. The distorted case
    holds the port's inverse warp against the JAX app's ``cv2.remap``."""
    from airslam_tpu.io.dataset import Dataset as JDataset
    from airslam_tpu_torch.frontend import synthgen

    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    extra = ["--distort_camera", os.path.join(REPO, "configs", "camera", camera)] if camera else []
    subprocess.run([sys.executable, os.path.join(REPO, "apps", "make_synth_dataset.py"),
                    "--out", str(jax_root), "--frames", str(N), "--texture", "0.1", *extra],
                   check=True, env=ENV, cwd=REPO, capture_output=True)
    key = jax.random.PRNGKey(0)
    draws = {"world": synthgen.make_world3d(
                 {k: torch.as_tensor(np.array(v)) for k, v in MTO.jax_world3d_draws(key).items()}),
             "texture": torch.as_tensor(np.array(MTO.jax_texture_draws(
                 jax.random.PRNGKey(31))["theta"])),
             "noise": torch.as_tensor(MTO.jax_sequence_noise(0, N, 480, 752)["noise"])}
    with contextlib.redirect_stdout(io.StringIO()):
        mav0 = MSD.main(["--out", str(port_root), "--frames", str(N), "--texture", "0.1",
                         "--device", "cpu", *extra], draws=draws)
    jmav0 = jax_root / "SYNTH_01" / "mav0"
    for cam in ("cam0", "cam1"):
        names = sorted(os.listdir(jmav0 / cam / "data"))
        assert names == sorted(os.listdir(os.path.join(mav0, cam, "data"))) and len(names) == N
        for n in names:
            gap, _ = _grey_gap(_png(jmav0 / cam / "data" / n),
                               _png(os.path.join(mav0, cam, "data", n)))
            assert gap <= 1, (cam, n)
    for sub in ("imu0/data.csv", "state_groundtruth_estimate0/data.csv"):
        assert _read(jmav0 / sub) == _read(os.path.join(mav0, sub)), sub
    theirs, ours = JDataset(str(jmav0), use_imu=True), JDataset(mav0, use_imu=True)
    assert ours.timestamps == theirs.timestamps and len(ours) == N
    for i in range(N):
        a, b = theirs.get(i), ours.get(i)
        assert a[0] == b[0] and np.abs(a[1] - b[1]).max() <= 1 / 255 + 1e-6
        rows = [np.asarray([np.concatenate([[r.timestamp], r.gyr, r.acc]) for r in x[3] or []])
                for x in (a, b)]
        assert np.array_equal(*rows)


@pytest.fixture(scope="module")
def replay(tmp_path_factory):
    """The oracle's world, the first ``N`` frames of its rectified sequence
    (the trajectory of all ``E2E['frames']``) rendered by the port and
    written by its writer, then the port's VO CLI on them (float32)."""
    from airslam_tpu_torch.frontend import synthgen

    z = np.load(ORACLE)
    e2e = MTO.E2E
    root = tmp_path_factory.mktemp("e2e")
    draws = BENCH.load_world(ORACLE, N, 480, 752)  # the noise's first N frames
    ts = np.arange(e2e["frames"]) * 0.05 * e2e["stride"]
    total = float(e2e["frames"] * 0.05 * e2e["stride"])
    gt = []
    for t in ts[:N]:
        T = np.eye(4)
        T[:3, 3] = BENCH.traj_position(t, e2e["traj"], total)
        gt.append(T)
    tcw = np.stack([[-T[:3, 3], -T[:3, 3] - np.array([0.1, 0.0, 0.0])] for T in gt])
    img = synthgen.render_view3d(
        draws["world"], torch.eye(3).expand(2 * N, 3, 3),
        torch.as_tensor(tcw.reshape(2 * N, 3), dtype=torch.float32), *BENCH.SYNTH_INTRINSICS,
        480, 752, noise=draws["noise"].reshape(2 * N, 480, 752)).reshape(N, 2, 480, 752).numpy()
    mav0 = str(root / "SYNTH_01" / "mav0")
    MSD.write_asl(mav0, ts[:N], img[:, 0], img[:, 1], gt, e2e["traj"], total)
    out = str(root / "port")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            VO.main(["--config_path", os.path.join(REPO, "configs", "visual_odometry",
                                                   "vo_euroc.yaml"),
                     "--camera_config_path", os.path.join(REPO, "configs", "camera",
                                                          "synth_stereo.yaml"),
                     "--dataroot", mav0, "--saving_dir", out, "--device", "cpu"])
        # the CLI's float32 networks run without TF32 on a card, as the JAX CLI's
        tf32 = torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert not tf32
    return z, mav0, out


def test_e2e_replay_render_and_ground_truth(replay):
    """The port's render of the oracle's world against the stored JAX PNGs of
    frame 0, and its ground truth against the JAX tree's."""
    z, mav0, _ = replay
    for cam in ("cam0", "cam1"):
        first = sorted(os.listdir(os.path.join(mav0, cam, "data")))[0]
        gap, share = _grey_gap(_png(z[f"rect_{cam}_0_png"]),
                               _png(os.path.join(mav0, cam, "data", first)))
        assert gap <= 1 and share <= 1e-3, (cam, gap, share)
    gt = np.loadtxt(os.path.join(mav0, "state_groundtruth_estimate0", "data.csv"),
                    delimiter=",", ndmin=2)
    assert np.array_equal(gt, z["rect_gt"][:N])


def test_e2e_replay_keyframes_equal_jax_cli(replay):
    """The port's VO CLI over the first frames: the stored JAX CLI's
    keyframe decisions on them and its poses within 1e-3 m."""
    z, _, out = replay
    want = [int(k) for k in z["rect_keyframe_ids"] if k < N]
    assert _keyframe_ids(out) == want
    got = _positions(os.path.join(out, "trajectory_v0.txt"))
    assert got.shape == (N, 3)
    assert np.abs(got - z["rect_traj"][:N, 1:4]).max() <= 1e-3


def test_jax_vo_cli_on_the_port_tree(replay, tmp_path):
    """The JAX VO CLI reads the port's tree and decides as the port's CLI."""
    _, mav0, out = replay
    jout = tmp_path / "jax"
    run = subprocess.run(
        [sys.executable, os.path.join(REPO, "apps", "visual_odometry.py"),
         "--config_path", os.path.join(REPO, "configs", "visual_odometry", "vo_euroc.yaml"),
         "--camera_config_path", os.path.join(REPO, "configs", "camera", "synth_stereo.yaml"),
         "--dataroot", mav0, "--saving_dir", str(jout), "--device", "cpu"],
        env=ENV, cwd=REPO, capture_output=True, text=True)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
    assert _keyframe_ids(str(jout)) == _keyframe_ids(out)
    assert np.abs(_positions(jout / "trajectory_v0.txt")
                  - _positions(os.path.join(out, "trajectory_v0.txt"))).max() <= 1e-3


def test_port_mapv0_runs_in_the_jax_map_refiner(replay, tmp_path):
    """The port's mapv0 loads in the JAX ``MapRefiner``, which runs to its
    end and writes a mapv1."""
    from airslam_tpu.io.serialization import load_map, save_map
    from airslam_tpu.loopclosure.vocabulary import train_vocabulary
    from airslam_tpu.pipelines.map_refiner import MapRefiner
    from tests.test_vo_pipeline import FakeMatcher

    _, _, out = replay
    m, _ = load_map(os.path.join(out, "AirSLAM_mapv0.bin"))
    ids = list(m.keyframe_ids)
    desc = np.concatenate([m.keyframes[f].kp_desc[m.keyframes[f].kp_mask] for f in ids])
    refiner = MapRefiner(m, FakeMatcher(), train_vocabulary(desc[::3], k=6, depth=3, seed=1))
    refiner.run()
    assert m.keyframe_ids == ids and all(np.isfinite(m.keyframes[f].Twc).all() for f in ids)
    save_map(m, str(tmp_path / "AirSLAM_mapv1.bin"))
    back, _ = load_map(str(tmp_path / "AirSLAM_mapv1.bin"))
    assert back.keyframe_ids == ids


def test_evaluate_matches_jax(replay, tmp_path, capsys):
    """``apps/evaluate_torch.py`` prints what ``apps/evaluate.py`` prints on
    the same files: the replay's trajectory against its ground truth."""
    from airslam_tpu_torch.io.trajectory import save_tum
    from apps import evaluate as jeval

    _, mav0, out = replay
    rows = np.loadtxt(os.path.join(mav0, "state_groundtruth_estimate0", "data.csv"),
                      delimiter=",", ndmin=2)
    gt_tum = str(tmp_path / "gt.txt")
    save_tum(gt_tum, [(r[0] * 1e-9, np.block([[np.eye(3), r[1:4, None]], [np.zeros((1, 3)), 1]]))
                      for r in rows])
    argv = ["--est", os.path.join(out, "trajectory_v0.txt"), "--gt", gt_tum]
    assert EVAL.main(argv) == 0
    ours = capsys.readouterr().out
    saved = sys.argv
    sys.argv = ["evaluate.py"] + argv
    try:
        assert jeval.main() == 0
    finally:
        sys.argv = saved
    assert ours == capsys.readouterr().out and ours.startswith("ATE RMSE: ")
    assert EVAL.main(argv + ["--lost_gap", "-1"]) == 1


def test_benchmark_system_json_and_stage_names(capsys):
    """``apps/benchmark_system_torch.py --device cpu --frames 3 --json``: its
    JSON line, every frame tracked, and the stage timer's sections under the
    JAX ``MapBuilder.add_input``'s names."""
    record = BENCH.main(["--device", "cpu", "--frames", str(N), "--json"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    got = json.loads(line)
    assert got["metric"] == "full_system_hz" and got["value"] > 0 and got["device"] == "cpu"
    assert got["frames"] == N - 1 and got["tracked"] == N == len(record["trajectory"])
    with open(os.path.join(REPO, "airslam_tpu", "pipelines", "map_builder.py")) as f:
        jax_names = re.findall(r'with sect\("(\w+)"\)', f.read())
    assert sorted(jax_names) == sorted(got["stage_ms"]) == sorted(
        ["rectify", "detect", "stereo_match", "track"])
    assert all(v >= 0 for v in got["stage_ms"].values())


def test_timer_matches_jax():
    """The port's ``Timer`` keeps and prints its records as the JAX one."""
    from airslam_tpu.utils.timing import Timer as JTimer
    from airslam_tpu_torch.utils.timing import Timer, device_label

    ours, theirs = Timer(), JTimer()
    for name, vals in (("track", [0.0123, 0.5]), ("detect", [0.002]), ("rectify", [1e-5] * 3)):
        for t in (ours, theirs):
            t.records[name].extend(vals)
    with ours.section("match"), theirs.section("match"):
        pass
    for t in (ours, theirs):
        t.records["match"][0] = 0.25
    assert ours.summary() == theirs.summary()
    assert ours.mean("track") == theirs.mean("track") and ours.mean("none") == 0.0
    assert device_label("cpu") == "cpu"


def test_benchmark_system_pipelined_with_a_profile(tmp_path, capsys):
    """``--pipelined`` runs the loop through ``PipelinedRunner`` (no stage
    breakdown) and ``--profile`` writes a ``torch.profiler`` trace."""
    record = BENCH.main(["--device", "cpu", "--frames", "2", "--pipelined", "--profile",
                         str(tmp_path / "trace")])
    out = capsys.readouterr().out
    assert record["tracked"] == 2 and record["stage_ms"] == {}
    assert "PipelinedRunner" in out and os.path.getsize(tmp_path / "trace" / "trace.json") > 0


def test_applications_default_to_the_card(tmp_path):
    """Without ``--device`` the applications run on the card; without one
    they raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MSD.main(["--out", str(tmp_path), "--frames", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BENCH.main(["--frames", "2"])
