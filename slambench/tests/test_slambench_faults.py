"""The comparison that decides ``correct`` fails a broken timed path: each
test drives the rest of a run on the CPU (the harness's look for a chip
skipped) with one fault planted underneath and sees ``correct`` come out
false. The faults are the ones each cell can have: a step that returns its
state unchanged, half of a batch left out, an answer altered where it is
produced; for VO also a local BA that returns its window unchanged. One
card, so no exchange between chips to leave out."""

import pytest
import torch

from _helpers import drive


# -- VO: planted through the driver's ``program`` hook ---------------------


def _builder():
    from slambench.drivers.vo import build_program

    return build_program


def frozen_after_warmup(cfg, dev):
    """add_input leaves the pipeline's state as it is once the warm-up's
    keyframes are in: the step returns its state unchanged."""
    builder = _builder()(cfg, dev)
    real = builder.add_input

    def add_input(ts, left, right, imu=None):
        if len(builder.map.keyframes) >= 3:
            return None
        return real(ts, left, right, imu)

    builder.add_input = add_input
    return builder


def shifted_keypoints(cfg, dev):
    """The detector's keypoints moved by one pixel where they are produced."""
    builder = _builder()(cfg, dev)
    real = builder.detector.detect

    def detect(images, detect_junctions=False):
        out = real(images, detect_junctions=detect_junctions)
        return out._replace(keypoints=out.keypoints + 1.0)

    builder.detector.detect = detect
    return builder


def temporal_pair_left_out(cfg, dev):
    """The matcher's batch of the stereo and the temporal pair runs the first
    half alone: the temporal matches come back empty."""
    import numpy as np

    builder = _builder()(cfg, dev)
    real = builder.matcher.matching_points_batched

    def batched(pairs, outlier_rejection=False, threshold=None):
        head = real(pairs[:1], outlier_rejection, threshold)
        return head + [(np.zeros((0, 2), np.int32), np.zeros(0, np.float32))] * (len(pairs) - 1)

    builder.matcher.matching_points_batched = batched
    return builder


def local_ba_unchanged(problem, intr, cfg=None, iters1=5, iters2=15, early_exit=0.0, mesh=None):
    """The window backend's local BA returns the window it was given: its
    poses and landmarks unmoved, every observation an inlier."""
    return problem, problem.point_obs_mask, problem.line_obs_mask


@pytest.mark.parametrize("fault", [frozen_after_warmup, shifted_keypoints,
                                   temporal_pair_left_out])
def test_vo_fault_makes_the_run_incorrect(fault):
    rc, line = drive("vo_euroc.fast", seed=2 ** 31 + 21, program=fault)
    assert rc == 0 and line is not None
    assert line["correct"] is False, line["checks"]


def test_vo_local_ba_left_unchanged_makes_the_run_incorrect(monkeypatch):
    from airslam_tpu_torch.backend import windows

    monkeypatch.setattr(windows, "local_ba", local_ba_unchanged)
    rc, line = drive("vo_euroc.fast", seed=2 ** 31 + 21, seconds=8.0)
    assert rc == 0 and line is not None and "lba_pose_gap_m" in line["checks"]
    assert line["correct"] is False, line["checks"]


# -- GlobalBA: planted through the driver's ``solver`` hook -----------------


def unchanged(prob, intr, cfg, iters1=50, iters2=40, chunk=2048):
    return prob, prob.pobs_mask, prob.lobs_mask


def point_moved(prob, intr, cfg, iters1=50, iters2=40, chunk=2048):
    from airslam_tpu_torch.backend import global_ba

    out, p_in, l_in = global_ba.global_ba(prob, intr, cfg, iters1=iters1, iters2=iters2,
                                          chunk=chunk)
    pts = out.points.clone()
    pts[0, 0] += 0.1
    return out._replace(points=pts), p_in, l_in


def half_the_observations(prob, intr, cfg, iters1=50, iters2=40, chunk=2048):
    from airslam_tpu_torch.backend import global_ba

    keep = prob.pobs_mask.clone()
    keep[1::2] = False
    out, p_in, l_in = global_ba.global_ba(prob._replace(pobs_mask=keep), intr, cfg,
                                          iters1=iters1, iters2=iters2, chunk=chunk)
    return out._replace(pobs_mask=prob.pobs_mask), p_in, l_in


@pytest.mark.parametrize("fault", [unchanged, point_moved, half_the_observations])
def test_global_ba_fault_makes_the_run_incorrect(fault):
    rc, line = drive("mr_euroc.map1000", seed=2 ** 31 + 23, solver=fault)
    assert rc == 0 and line is not None
    assert line["correct"] is False, line["checks"]


def test_sound_runs_are_correct_at_the_test_size():
    assert drive("mr_euroc.map1000", seed=2 ** 31 + 23)[1]["correct"] is True
    assert drive("vo_euroc.fast", seed=2 ** 31 + 21)[1]["correct"] is True


def test_ate_of_a_still_truth_reads_the_estimate_drift():
    """A Sim(3) fit to a still truth scales the estimate to a point; the
    trajectory error keeps the estimate's scale, so a drift shows."""
    import numpy as np

    from slambench.reference.vo_check import ate_rmse

    gt = np.zeros((40, 3))
    drift = np.stack([np.linspace(0.0, 0.1, 40), np.zeros(40), np.zeros(40)], -1)
    assert np.isclose(ate_rmse(drift, gt), np.sqrt(((drift - drift.mean(0)) ** 2).sum(1).mean()))
    assert ate_rmse(np.zeros((40, 3)), gt) == 0.0
    moving = np.stack([np.zeros(40), np.zeros(40), np.arange(40) * 0.12], -1)
    assert ate_rmse(2.0 * moving + 1.0, moving) < 1e-9
