"""Stage 2 of the port against the JAX refinement CLI on a rendered loop.

``tests/data/torch_e2e_oracle.npz`` holds the JAX VO CLI's mapv0 of all 40
frames of the rendered loop, the point vocabulary the JAX refinement CLI
trained on it (``--voc_path``, as scripts/verify_tpu_e2e.py's stage 2
shares it) and that CLI's run: its loop pairs with their relative poses,
its merges and its trajectory_v1. The port's refinement CLI runs on the same
mapv0 and vocabulary on the CPU (float32, as the JAX CLI) and is held to it
by ``chip_smoke.REFINE_GATES``: the same loop pairs (Rlq / tlq within 1e-3),
the same merges, the refined keyframes within 0.02 m / 5e-3, and ATE to the
truth within 0.05 m. The CLI also turns TF32 off, as the JAX CLI computes in
float32.
"""

import contextlib
import io
import os
import sys

import numpy as np
import pytest
import torch

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "apps"))
import map_refinement_torch as MR  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The port's refinement CLI on the stored JAX mapv0 and vocabulary, with
    both TF32 flags set before it. Returns (oracle, refiner, trajectory_v1,
    the flags after the run, map root)."""
    z = chip_smoke.e2e_oracle()
    map_root, voc = chip_smoke.write_stage2_tree(z, str(tmp_path_factory.mktemp("stage2")))
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            refiner = MR.main(["--config_path", os.path.join(REPO, "configs", "map_refinement",
                                                             "mr_euroc.yaml"),
                               "--map_root", map_root, "--voc_path", voc, "--device", "cpu"])
        flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    from airslam_tpu_torch.io.trajectory import load_tum

    traj = load_tum(os.path.join(map_root, "trajectory_v1.txt"))
    return z, refiner, traj, flags, map_root


@pytest.fixture(scope="module")
def gaps(port_run):
    z, refiner, traj, _, _ = port_run
    return chip_smoke.stage2_gaps(z, refiner, traj)


def test_refinement_cli_turns_tf32_off(port_run):
    """The CLI's float32 networks run without TF32 on a card, as the JAX
    CLI's: both flags are off after ``main``, whatever they were before."""
    assert port_run[3] == (False, False)


def test_loop_pairs_equal_jax(gaps):
    """The JAX CLI's loop pairs, each relative pose within 1e-3 (rotation
    entries) / 1e-3 m."""
    g = chip_smoke.REFINE_GATES
    assert gaps["loops"] == gaps["jax_loops"] and len(gaps["loops"]) > 0
    assert gaps["loop_R"] <= g["loop_R"] and gaps["loop_t"] <= g["loop_t"], gaps


def test_merges_equal_jax(gaps):
    assert gaps["merged"] == gaps["jax_merged"]


def test_refined_keyframes_within_gates(gaps):
    """trajectory_v1: the JAX CLI's keyframes, each within 0.02 m and 5e-3
    (rotation entries) of its pose."""
    g = chip_smoke.REFINE_GATES
    assert gaps["pose_t"] <= g["pose_t"] and gaps["pose_R"] <= g["pose_R"], gaps


def test_refined_ate_to_truth(gaps):
    """Sim(3)-aligned ATE of the refined keyframes to the rendered truth."""
    assert gaps["n_ate"] == gaps["keyframes"] >= 3
    assert gaps["ate"] <= chip_smoke.REFINE_GATES["ate"], gaps
    assert chip_smoke.stage2_failures(gaps) == []


def test_refined_map_loads_in_jax(port_run):
    """The port's mapv1 of the rendered loop reads back in the JAX package
    with the same keyframes and refined poses."""
    from airslam_tpu.io.serialization import load_map

    _, refiner, traj, _, map_root = port_run
    m, dbs = load_map(os.path.join(map_root, "AirSLAM_mapv1.bin"))
    assert "point" in dbs and m.keyframe_ids == refiner.map.keyframe_ids
    got = np.stack([m.keyframes[f].Twc[:3, 3] for f in m.keyframe_ids])
    want = np.stack([T[:3, 3] for _, T in traj])
    assert np.abs(got - want).max() < 1e-6


def test_queries_are_the_loops():
    """The relocalization oracle's ten hard queries (the chain's third stage
    on the card) belong to this loop: the e2e writer rendered them again
    from the same world, trajectory and JAX noise keys and found the same
    bytes; their ground truth is the stored one, each pose 0.18-0.30 m
    beside a frame of the loop, 0.5 ms after its stamp."""
    z, zr = chip_smoke.e2e_oracle(), chip_smoke.reloc_oracle()
    assert np.array_equal(z["s3_gt_tum"], zr["gt_tum"])
    rows = np.loadtxt(io.StringIO(z["s3_gt_tum"].tobytes().decode()), ndmin=2)
    gt = z["rect_gt"]
    assert len(rows) == len(z["s3_ok"]) == 10
    for row in rows:
        i = int(np.argmin(np.abs(gt[:, 0] * 1e-9 - row[0])))
        assert abs(gt[i, 0] * 1e-9 + 5e-4 - row[0]) < 1e-6
        assert 0.18 <= abs(row[1] - gt[i, 1]) <= 0.30
        assert np.linalg.norm(row[1:4] - gt[i, 1:4]) < 0.35
