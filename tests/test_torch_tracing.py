"""The port's spans (``airslam_tpu_torch/utils/timing.span``): free with no
profiler open, and, under one, one ``lm.step`` per LM iteration of the
window backend (``backend/windows.local_ba``) and of GlobalBA
(``backend/global_ba.global_ba``), each holding one ``lm.assemble``, one
``lm.solve`` and one ``lm.cost``, beside the χ² gates' ``ba.gate`` spans.
Every span name the package opens is in PERF.md's span table, and
``span`` is the package's only way to open a range."""

import os
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from airslam_tpu_torch.backend import gn, windows
from airslam_tpu_torch.backend import global_ba as gba
from airslam_tpu_torch.utils.timing import span
from tests.test_torch_window import _intr, _perturbed, _port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "airslam_tpu_torch")
LM_PHASES = ("lm.assemble", "lm.solve", "lm.cost")


def _traced(fn):
    """(``fn``'s result, its spans as [(name, start ns, end ns)]) under a
    host-only profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]
    return out, sorted(spans, key=lambda s: s[1])


def _inside(a, b):
    return b[1] <= a[1] and a[2] <= b[2]


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _assert_lm_steps(spans, outer, n_steps):
    """``n_steps`` ``lm.step`` spans inside ``outer``, each holding exactly
    one span of each LM phase, and every phase span inside a step."""
    steps = _named(spans, "lm.step")
    assert len(steps) == n_steps
    assert all(_inside(s, outer) for s in steps)
    for phase in LM_PHASES:
        assert len(_named(spans, phase)) == n_steps
        for step in steps:
            assert sum(_inside(p, step) for p in _named(spans, phase)) == 1


def _assert_gates(spans, outer):
    """The two χ² gates (the gate between the passes, the final flags)
    inside ``outer`` and outside every LM step."""
    gates = _named(spans, "ba.gate")
    assert len(gates) == 2 and all(_inside(g, outer) for g in gates)
    assert not any(_inside(g, s) for g in gates for s in _named(spans, "lm.step"))


def test_span_opens_no_record_function_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    with span("lm.step"), span("lm.assemble"):
        pass
    prob, scene = _perturbed(1, 4, 60)
    out, p_in, _ = windows.local_ba(_port(prob), _intr(scene["intr"]), iters1=2, iters2=2)
    assert bool(torch.isfinite(out.points).all()) and bool(p_in.any())
    # the patched function is the one a span opens once a profiler runs
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="lm.step"):
            span("lm.step")


@pytest.mark.parametrize("early_exit", [0.0, 1e-3], ids=["fixed-schedule", "early-exit"])
def test_local_ba_opens_one_lm_step_per_iteration(early_exit):
    prob, scene = _perturbed(1, 4, 60)
    ours, intr = _port(prob), _intr(scene["intr"])
    iters1, iters2 = 5, 15

    def run():
        with span("local_ba"):
            return windows.local_ba(ours, intr, iters1=iters1, iters2=iters2,
                                    early_exit=early_exit)

    _, spans = _traced(run)
    (outer,) = _named(spans, "local_ba")
    n_steps = len(_named(spans, "lm.step"))
    if early_exit:  # the loop ends early: fewer steps, each still whole
        assert 2 <= n_steps < iters1 + iters2
    else:
        assert n_steps == iters1 + iters2
    _assert_lm_steps(spans, outer, n_steps)
    _assert_gates(spans, outer)


def test_early_exit_steps_are_the_steps_run():
    """Under ``early_exit`` the ``lm.step`` spans count the LM iterations
    ``gn.optimize`` ran: one per ``_assemble_and_solve`` call."""
    prob, scene = _perturbed(1, 4, 60)
    ours, intr = _port(prob), _intr(scene["intr"])
    calls = []
    solve = gn._assemble_and_solve

    def counting(*a, **k):
        calls.append(1)
        return solve(*a, **k)

    gn._assemble_and_solve = counting
    try:
        _, spans = _traced(lambda: gn.optimize(ours, intr, gn.BAConfig(), 15, robust=True,
                                               early_exit=1e-3))
    finally:
        gn._assemble_and_solve = solve
    assert 1 <= len(calls) < 15
    assert len(_named(spans, "lm.step")) == len(calls)


def test_global_ba_opens_one_lm_step_per_iteration():
    prob, scene = _perturbed(0, 5, 80)
    sparse = gba.dense_to_sparse(_port(prob), max_obs=16)
    intr = _intr(scene["intr"])

    def run():
        with span("slambench.solve"):
            return gba.global_ba(sparse, intr, gn.BAConfig(), iters1=4, iters2=8, chunk=32)

    (out, p_in, _), spans = _traced(run)
    assert bool(torch.isfinite(out.points).all()) and bool(p_in.any())
    (outer,) = _named(spans, "slambench.solve")
    _assert_lm_steps(spans, outer, 4 + 8)
    _assert_gates(spans, outer)


def _package_sources():
    for root, _, names in os.walk(PACKAGE):
        for n in sorted(names):
            if n.endswith(".py"):
                path = os.path.join(root, n)
                with open(path) as f:
                    yield os.path.relpath(path, REPO), f.read()


def test_every_span_is_in_perf_md_and_span_is_the_only_range():
    opened = set()
    for rel, src in _package_sources():
        opened |= set(re.findall(r"\bspan\(\s*\"([^\"]+)\"", src))
        if rel != os.path.join("airslam_tpu_torch", "utils", "timing.py"):
            assert "record_function" not in src, rel
    # the spans the benchmark's readers and the breakdown read
    assert {"local_ba", "insert_keyframe", "triangulate", "local_map.build",
            "local_map.write_back", "lm.step", "ba.gate", "pnp", "pose_only",
            "stereo+temporal match", "resize+plnet", "superpoint", "decode+loi"} <= opened
    assert set(LM_PHASES) <= opened
    with open(os.path.join(REPO, "PERF.md")) as f:
        perf = f.read()
    table = {name for line in perf.splitlines() if line.startswith("| `")
             for name in re.findall(r"`([^`]+)`", line.split("|")[1])}
    assert opened <= table, sorted(opened - table)


# -- the stereo-inertial path's spans --------------------------------------------

VI_SPANS = ("imu.preintegrate", "pose_only.vi", "lm.imu")


def _framed_stream(builder, seq, frames):
    """tests/test_torch_vio.py's stream through ``track_features`` under a
    host-only profiler, each frame inside a test range ``frame<n>``. Returns
    (spans, the frames whose tracking began with the IMU initialized)."""
    from airslam_tpu_torch.core.imu import ImuData

    times = seq["times"]
    rows = [ImuData(times[i], seq["gyr"][i], seq["acc"][i]) for i in range(len(times))]
    vi_frames = []

    def run():
        last_i = 0
        for n, (i, (fl, fr, pairs)) in enumerate(frames):
            if builder.map.imu_initialized:
                vi_frames.append(n)
            with torch.profiler.record_function(f"frame{n}"):
                builder.track_features(times[i], fl, fr, pairs,
                                       imu_batch=rows[max(last_i - 1, 0): i + 2] if n else None)
            last_i = i

    _, spans = _traced(run)
    return spans, vi_frames


def test_vi_tracking_opens_one_pose_only_vi_per_frame_after_the_imu_initializes():
    """Over tests/test_torch_vio.py's stream (the IMU initializes at its
    twelfth frame): one ``pose_only.vi`` inside the ``pose_only`` span of
    each frame tracked after the initialization, none before it; an
    ``imu.preintegrate`` in every frame after the first keyframe; every
    ``lm.imu`` inside a ``local_ba``. A vision-only builder over the
    stream's head opens none of the three."""
    from airslam_tpu_torch.pipelines.map_builder import KeyframeConfig, MapBuilder
    from tests.test_torch_map import Camera, Matcher
    from tests.test_torch_vio import STREAM_KF, _imu_camera, _vio_stream

    seq, frames = _vio_stream()
    vi = MapBuilder(_imu_camera(Camera()), None, Matcher(), kf_config=KeyframeConfig(**STREAM_KF),
                    device="cpu", dtype=torch.float64)
    spans, vi_frames = _framed_stream(vi, seq, frames)
    assert vi.map.imu_initialized and len(vi_frames) >= 2
    for n in range(len(frames)):
        (frame,) = _named(spans, f"frame{n}")
        inner = [s for s in _named(spans, "pose_only.vi") if _inside(s, frame)]
        assert len(inner) == (1 if n in vi_frames else 0), n
        assert all(any(_inside(s, p) for p in _named(spans, "pose_only")) for s in inner)
        preint = [s for s in _named(spans, "imu.preintegrate") if _inside(s, frame)]
        assert (len(preint) >= 1) == (n > 0), n
    assert _named(spans, "lm.imu")
    assert all(any(_inside(s, b) for b in _named(spans, "local_ba"))
               for s in _named(spans, "lm.imu"))

    vision = MapBuilder(Camera(), None, Matcher(), kf_config=KeyframeConfig(**STREAM_KF),
                        device="cpu", dtype=torch.float64)
    spans, _ = _framed_stream(vision, seq, frames[:5])
    assert len(vision.map.keyframe_ids) >= 3 and _named(spans, "local_ba")
    assert not any(_named(spans, name) for name in VI_SPANS)


def test_vi_local_ba_opens_lm_imu_inside_every_assembly_and_cost():
    """A VI local BA (tests/test_torch_vio_reference.py's five-keyframe
    window): one ``lm.imu`` inside every ``lm.assemble`` and every
    ``lm.cost``, and one for the cost before the first step; the vision-only
    local BA opens none."""
    from tests.test_torch_vio_reference import CFG, INTR, _window_problem

    problem, _, _ = _window_problem(2 ** 31 + 13)

    def run():
        with span("local_ba"):
            return windows.local_ba(problem, INTR, CFG, iters1=2, iters2=3)

    _, spans = _traced(run)
    (outer,) = _named(spans, "local_ba")
    _assert_lm_steps(spans, outer, 5)
    imu = _named(spans, "lm.imu")
    for phase in ("lm.assemble", "lm.cost"):
        for s in _named(spans, phase):
            assert sum(_inside(i, s) for i in imu) == 1, phase
    assert len(imu) == 2 * 5 + 2  # and once before each pass's first step
    prob, scene = _perturbed(1, 4, 60)
    _, spans = _traced(lambda: windows.local_ba(_port(prob), _intr(scene["intr"]), iters1=2,
                                                iters2=2))
    assert _named(spans, "lm.assemble") and not _named(spans, "lm.imu")


def test_the_vi_spans_are_opened_and_in_perf_md():
    opened = set()
    for _, src in _package_sources():
        opened |= set(re.findall(r"\bspan\(\s*\"([^\"]+)\"", src))
    assert set(VI_SPANS) <= opened
    with open(os.path.join(REPO, "PERF.md")) as f:
        rows = [line for line in f.read().splitlines() if line.startswith("| `")]
    named = {n for line in rows for n in re.findall(r"`([^`]+)`", line.split("|")[1])}
    assert set(VI_SPANS) <= named
