"""The port's frame-parallel frontend (``parallel/frontend.py``), its
mesh-pipelined runner (``parallel/pipeline.py``) and the VO CLI's
``--mesh_pipelined``, ``--jax_pnp`` and ``--model_dir`` (with the
relocalization and system-benchmark CLIs' ``--model_dir``), against the JAX
package's on the 8-device CPU mesh of tests/conftest.py where it has a
counterpart. Keypoints within 1e-2 px (the JAX dry run's gate); trajectories
within 1e-9 of the sequential loop in float64 and 1e-6 m in float32."""

import importlib.util
import os
import subprocess
import sys

import jax
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from airslam_tpu.frontend.detector import DetectorConfig as JDetectorConfig
from airslam_tpu.frontend.detector import FeatureDetector as JFeatureDetector
from airslam_tpu.models import weights as jw
from airslam_tpu.parallel import frontend as jfrontend
from airslam_tpu.parallel import mesh as jmesh
from airslam_tpu.parallel import pipeline as jpipeline
from airslam_tpu_torch import entry
from airslam_tpu_torch.frontend.detector import DetectorConfig, FeatureDetector
from airslam_tpu_torch.io import trajectory
from airslam_tpu_torch.models import weights as wio
from airslam_tpu_torch.models.lightglue import LightGlue
from airslam_tpu_torch.models.plnet import LoiHeadS1, PLNet
from airslam_tpu_torch.models.superpoint import SuperPoint
from airslam_tpu_torch.parallel import mesh as tmesh
from airslam_tpu_torch.parallel.frontend import pad_batch, sharded_detect
from airslam_tpu_torch.parallel.pipeline import MeshPipelinedRunner
from airslam_tpu_torch.parallel.train_plnet import flax_init_
from airslam_tpu_torch.pipelines.map_builder import KeyframeConfig, MapBuilder
from tests import test_torch_map as tmap
from tests import test_vo_pipeline as jvo

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = ["cpu"] * 8


_DET = dict(max_keypoints=64, max_lines=32, max_proposals=512)


@pytest.fixture(scope="module")
def detectors():
    """The JAX and the port's detector with the shipped weights (SuperPoint
    keypoints, the stage-1 head), float32."""
    with jax.enable_x64(False):
        params, _ = jw.load_default_frontend(use_superpoint=True)
        jdet = JFeatureDetector(JDetectorConfig(**_DET), params=params)
    return jdet, FeatureDetector(DetectorConfig(**_DET), device="cpu")


def test_sharded_detect_against_jax(detectors):
    """3 frames at 120×188 over 8 devices (padded to 8, one frame per
    device, the padding dropped) against the JAX ``sharded_detect`` on its
    mesh: keypoints within 1e-2 px, the same masks and counts; and the port's
    own single-device batch bit for bit."""
    jdet, tdet = detectors
    frames = np.random.RandomState(0).rand(3, 120, 188).astype(np.float32)
    padded, b = pad_batch(frames, tmesh.make_mesh(devices=CPU8))
    assert padded.shape == (8, 120, 188) and b == 3 and not padded[3:].any()
    with jax.enable_x64(False):
        want = jfrontend.sharded_detect(jdet, frames, jmesh.make_mesh(8), detect_junctions=True)
    got = sharded_detect(tdet, frames, tmesh.make_mesh(devices=CPU8), detect_junctions=True)
    assert got.keypoints.shape == (3, 64, 2)
    np.testing.assert_array_equal(got.kp_mask.numpy(), np.asarray(want.kp_mask))
    valid = got.kp_mask.numpy()
    assert valid.sum() > 100
    gap = np.abs(got.keypoints.numpy() - np.asarray(want.keypoints))[valid].max()
    assert gap <= 1e-2, gap
    single = tdet.detect(frames, detect_junctions=True)
    for a, b in zip(got, single):
        assert torch.equal(a, b)


class _RecordingBuilder(entry._RecordingBuilder):
    """The JAX dry run's recording builder, for either package: rectify
    returns the pair in the package's layout."""

    def __init__(self, detector, jax_layout):
        super().__init__(detector)
        self.jax_layout = jax_layout

    def rectify(self, left, right):
        return (left, right) if self.jax_layout else super().rectify(left, right)


def test_mesh_pipelined_runner_detections_against_jax(detectors):
    """``MeshPipelinedRunner`` with the JAX dry run's recording builder over
    3 stereo frames (chunk 4: a partial chunk, padded) on the 8-device mesh:
    the same consumption order as the JAX runner and keypoints within
    1e-2 px of its."""
    jdet, tdet = detectors
    frames6 = np.random.RandomState(1).rand(6, 120, 188).astype(np.float32)
    ds = entry._Frames(frames6)
    jrb, trb = _RecordingBuilder(jdet, True), _RecordingBuilder(tdet, False)
    with jax.enable_x64(False):
        jpipeline.MeshPipelinedRunner(jrb, jmesh.make_mesh(8)).run(ds)
    runner = MeshPipelinedRunner(trb, tmesh.make_mesh(devices=CPU8))
    assert runner.chunk == 4
    assert runner.run(ds) == 3
    assert [g[0] for g in trb.got] == [g[0] for g in jrb.got] == [0.0, 1.0, 2.0]
    for (_, k0, k1), (_, j0, j1) in zip(trb.got, jrb.got):
        for k, j in ((k0, j0), (k1, j1)):
            assert np.abs(k - np.asarray(j)).max() <= 1e-2


def test_mesh_pipelined_runner_matches_sequential():
    """tests/test_parallel.py:126 on the port: the map builder fed by
    ``MeshPipelinedRunner`` over the 8-device mesh (a stub detector serving
    rendered features, the last chunk padded) gives the sequential loop's
    trajectory, float64, within 1e-9 (tests/test_torch_map.py holds that
    loop to the JAX builder's)."""
    cam = jvo.FakeCamera()
    pts, desc = jvo.make_world(seed=21)
    traj = jvo.circle_trajectory(6)
    rng = np.random.RandomState(77)
    rendered = [jvo.render_features(pts, desc, T, cam, rng) for T in traj]

    views = [v for fl, fr, _ in rendered for v in (fl, fr)]

    class ChunkStubDetector:
        """Serves the rendered views in call order, one per image asked for
        (the JAX runner asks for a chunk at once, the port's each device's
        shard); padding rows repeat view 0 and are dropped."""

        def __init__(self, stack):
            self.i = 0
            self.stack = stack

        def detect(self, images, detect_junctions=False):
            outs = []
            for _ in range(int(images.shape[0])):
                outs.append(views[self.i] if self.i < len(views) else views[0])
                self.i += 1
            return jtu.tree_map(lambda *xs: self.stack([np.asarray(x) for x in xs]), *outs)

    class Frames:
        def __len__(self):
            return len(traj)

        def get(self, i):
            z = np.zeros((480, 752), np.float32)
            return i * 0.1, z, z, None

    kf = dict(min_init_stereo_feature=50, max_num_match=60, tracking_point_rate=0.5)
    seq = MapBuilder(tmap.Camera(), None, tmap.Matcher(), kf_config=KeyframeConfig(**kf),
                     device="cpu", dtype=torch.float64)
    for i, (fl, fr, pairs) in enumerate(rendered):
        seq.track_features(i * 0.1, fl, fr, pairs)
    ours = MapBuilder(tmap.Camera(), ChunkStubDetector(lambda xs: torch.as_tensor(np.stack(xs))),
                      tmap.Matcher(), kf_config=KeyframeConfig(**kf), device="cpu",
                      dtype=torch.float64)
    runner = MeshPipelinedRunner(ours, tmesh.make_mesh(devices=CPU8))
    assert runner.chunk == 4
    runner.run(Frames())
    assert len(ours.trajectory) == len(seq.trajectory) >= 4
    for (t0, T0), (t1, T1) in zip(seq.trajectory, ours.trajectory):
        assert t0 == t1
        np.testing.assert_allclose(T1, T0, atol=1e-9, rtol=0)




# ---------------------------------------------------------------------------
# the CLIs: --mesh_pipelined, --jax_pnp, --model_dir
# ---------------------------------------------------------------------------


def _app(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "apps", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _vo_args(mav0, out, *extra):
    return ["--config_path", os.path.join(REPO, "configs", "visual_odometry", "vo_euroc.yaml"),
            "--camera_config_path", os.path.join(REPO, "configs", "camera", "synth_stereo.yaml"),
            "--dataroot", str(mav0), "--saving_dir", str(out), "--max_frames", "3",
            "--device", "cpu", *extra]


def test_vo_cli_mesh_pipelined_matches_the_sequential_run(tmp_path, capsys):
    """The VO CLI with ``--mesh_pipelined`` over a 3-frame
    ``apps/make_synth_dataset.py`` tree on the CPU (the mesh is the one CPU
    device: a chunk of 1) writes the sequential run's trajectory within
    1e-6 m, float32."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    data = tmp_path / "ds"
    subprocess.run([sys.executable, os.path.join(REPO, "apps", "make_synth_dataset.py"),
                    "--out", str(data), "--frames", "3", "--texture", "0.1", "--seed", "3"],
                   check=True, env=env, cwd=REPO, capture_output=True)
    mav0 = data / "SYNTH_01" / "mav0"
    cli = _app("visual_odometry_torch")
    runs = {}
    for label, extra in (("seq", []), ("mesh", ["--mesh_pipelined"])):
        cli.main(_vo_args(mav0, tmp_path / label, *extra))
        runs[label] = trajectory.load_tum(str(tmp_path / label / "trajectory_v0.txt"))
    assert "mesh: Mesh({'dp': 1, 'tp': 1}, ['cpu'])" in capsys.readouterr().out
    assert len(runs["seq"]) == len(runs["mesh"]) == 3
    for (t0, T0), (t1, T1) in zip(runs["seq"], runs["mesh"]):
        assert t0 == t1
        np.testing.assert_allclose(T1[:3, 3], T0[:3, 3], atol=1e-6, rtol=0)
        np.testing.assert_allclose(T1[:3, :3], T0[:3, :3], atol=1e-6, rtol=0)


def _seeded_model_dir(path, with_matcher=True):
    """plnet.npz (PLNet, the stage-1 head and SuperPoint) and lightglue.npz
    of seeded fresh networks, written in the JAX layout. Returns the
    networks' state_dicts."""
    gen = torch.Generator().manual_seed(7)
    nets = {"plnet": PLNet(), "loi": LoiHeadS1(), "superpoint": SuperPoint(),
            "lightglue": LightGlue()}
    for net in nets.values():
        flax_init_(net, gen)
    sds = {k: v.state_dict() for k, v in nets.items()}
    wio.save_npz(os.path.join(path, "plnet.npz"),
                 {"plnet": wio.plnet_to_flax(sds["plnet"]), "loi": wio.loi_s1_to_flax(sds["loi"]),
                  "superpoint": wio.superpoint_to_flax(sds["superpoint"])})
    if with_matcher:
        wio.save_npz(os.path.join(path, "lightglue.npz"), wio.lightglue_to_flax(sds["lightglue"]))
    return sds


def _equal(sd, module):
    got = module.state_dict()
    assert sd.keys() == got.keys()
    return all(torch.equal(sd[k], got[k]) for k in sd)


def test_model_dir_loads_seeded_weights_bit_for_bit(tmp_path):
    """``--model_dir`` of the VO CLI: seeded weights written by ``*_to_flax``
    and ``save_npz`` come back in the CLI's detector and matcher bit for bit;
    a directory without ``lightglue.npz`` keeps the shipped matcher, as the
    JAX CLI falls back (apps/visual_odometry.py:60-72). The relocalization
    and system-benchmark CLIs take the flag; both read it through
    ``weights.load_model_dir``."""
    from airslam_tpu_torch.frontend.matcher import PointMatcher

    cli = _app("visual_odometry_torch")
    mav0 = tmp_path / "mav0"
    (mav0 / "cam0" / "data").mkdir(parents=True)
    (mav0 / "cam1" / "data").mkdir(parents=True)
    full, half = tmp_path / "full", tmp_path / "half"
    full.mkdir()
    half.mkdir()
    sds = _seeded_model_dir(str(full))
    _seeded_model_dir(str(half), with_matcher=False)
    builder, _, _ = cli.build(cli.parse_args(_vo_args(mav0, tmp_path / "o", "--model_dir",
                                                      str(full), "--jax_pnp")))
    det = builder.detector
    assert builder.use_jax_pnp
    assert _equal(sds["plnet"], det.plnet) and _equal(sds["loi"], det.loi)
    assert _equal(sds["superpoint"], det.superpoint)
    assert _equal(sds["lightglue"], builder.matcher.model)
    builder, _, _ = cli.build(cli.parse_args(_vo_args(mav0, tmp_path / "o", "--model_dir",
                                                      str(half))))
    assert _equal(sds["plnet"], builder.detector.plnet)
    shipped = PointMatcher(device="cpu").model.state_dict()
    assert _equal(shipped, builder.matcher.model)
    assert wio.load_model_dir(None) == (None, None)
    assert wio.load_model_dir(str(half), matcher=1)[1] is None
    reloc, bench = _app("relocalization_torch"), _app("benchmark_system_torch")
    assert reloc.parse_args(["--config_path", "c", "--map_root", "m", "--query_folder", "q",
                             "--model_dir", str(full)]).model_dir == str(full)
    assert bench.parse_args(["--model_dir", str(full)]).model_dir == str(full)
