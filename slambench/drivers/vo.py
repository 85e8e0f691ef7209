"""Driver of the VO cells: a closed loop of one client handing a rendered
stereo stream to ``MapBuilder.add_input``, frame after frame.

Set-up: the stream (rendered, distorted and stored 8-bit by the traffic
generator), the program as ``apps/visual_odometry_torch.py`` builds it from
the configuration, and warm-up frames from the head of the stream until the
map holds ``warmup_keyframes`` keyframes (the first local BAs have run, so
every kernel is built). The window then hands the following frames over, one
at a time, each converted from 8 bits as ``io/dataset.py`` delivers it,
until ``--seconds`` have passed and the frame under way has returned. A
stream that ends first fails the run (``window_short_s`` above 0): its
window would be shorter than the cell's. The warm-up takes at most
``warmup_max_frames`` frames, so a program that inserts no keyframes still
reaches the window and its comparison. A frame's latency runs from the
hand-over to the return and a synchronisation of the card.

While the window runs, every call of the window backend's ``local_ba`` is
kept: its arguments and its result. A traced run profiles
the window's first frames and times the rest untraced, for the metrics that
read host time.

Once the window has closed and the peak memory is read, the program is
freed and ``slambench/reference/vo_check.py`` judges what it produced: the
detector's and the stereo matcher's outputs on frames of the window drawn
from the seed (the slowest frame among them), local BAs of the window drawn
from the seed against the plain window BA solved from the same problems, and
the whole tracked
trajectory against the rendered truth.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import statistics
import sys
import time

import numpy as np

from slambench.harness import common, probes, trace

def build_program(config: dict, device):
    """The port's ``MapBuilder`` as the VO CLI builds it from
    ``configs/visual_odometry/vo_euroc.yaml`` and a camera file, from the
    configuration's ``vo`` and ``camera`` blocks, with its map's window
    backend in the configuration's ``backend_dtype``."""
    import torch

    from airslam_tpu_torch.core.camera import Camera
    from airslam_tpu_torch.frontend.detector import FeatureDetector
    from airslam_tpu_torch.frontend.matcher import PointMatcher
    from airslam_tpu_torch.io import config as cio
    from airslam_tpu_torch.pipelines.map_builder import MapBuilder

    node = config["vo"]
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[config["networks_dtype"]]
    detector = FeatureDetector(dataclasses.replace(cio.parse_detector_config(node), dtype=dtype),
                               device=device)
    matcher = PointMatcher(dataclasses.replace(cio.parse_matcher_config(node), dtype=dtype,
                                               use_flash=bool(config["use_flash"])),
                           device=device)
    builder = MapBuilder(Camera(node=config["camera"]), detector, matcher,
                         cio.parse_keyframe_config(node), cio.parse_ba_config(node, "backend"),
                         device=device)
    builder.map.ba_early_exit = cio.parse_early_exit(node, "backend")
    # the window backend's type, an option of the program's map
    builder.map.dtype = {"float32": torch.float32, "float64": torch.float64}[
        config["backend_dtype"]]
    return builder


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(ctx, program=None) -> int:
    """One run of a VO cell; returns the exit code. ``program``: a callable
    (config, device) → builder in place of :func:`build_program` (the fault
    tests plant a broken one)."""
    import torch

    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    # float32 networks compute in float32, as the VO CLI sets it: no TF32
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    traffic = wl["traffic"]
    gen = importlib.import_module("slambench.traffic." + traffic["generator"])
    stream = gen.generate(traffic, cfg["camera"], ctx.seed, dev)
    builder = (program or build_program)(cfg, dev)

    frames = {}  # window index -> the Frame add_input returned
    i = 0
    warm, cap = int(traffic["warmup_keyframes"]), int(traffic["warmup_max_frames"])
    while i < min(cap, len(stream.timestamps)) and len(builder.map.keyframes) < warm:
        left, right = gen.as_delivered(stream.images[i])
        builder.add_input(float(stream.timestamps[i]), left, right, None)
        i += 1
    _sync(dev)
    if len(builder.map.keyframes) < warm:
        print(f"warning: the warm-up reached {len(builder.map.keyframes)} of {warm} keyframes "
              f"in {cap} frames", file=sys.stderr)
    first = i
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - ctx.t0

    # a traced run profiles the first ``trace.frames`` frames of its window (a
    # keyframe's local BA launches tens of thousands of kernels: a whole
    # window would not reduce in time) and times the rest untraced
    n_trace = int(wl["trace"]["frames"]) if ctx.trace else 0
    prof = probe = keep_prof = None
    lat = []
    lba = probes.KeptCalls("airslam_tpu_torch.backend.windows", "local_ba")
    t_start = time.perf_counter()
    t_trace = t_after = None
    while i < len(stream.timestamps):
        if len(lat) == 0 and n_trace:
            probe = probes.Probes()
            prof = probes.start_profiler()
            t_trace = time.perf_counter()
            window_range = torch.profiler.record_function(trace.WINDOW_RANGE)
            window_range.__enter__()
        left, right = gen.as_delivered(stream.images[i])
        t1 = time.perf_counter()
        with torch.profiler.record_function(trace.FRAME_RANGE):
            frames[i] = builder.add_input(float(stream.timestamps[i]), left, right, None)
            _sync(dev)
        lat.append(time.perf_counter() - t1)
        i += 1
        if prof is not None and len(lat) == n_trace:
            window_range.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            probe.remove()
            t_after = time.perf_counter()
            t_trace = t_after - t_trace
            keep_prof, prof = prof, None
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    t_end = time.perf_counter()
    window_s = t_end - t_start
    lba.remove()
    n = len(lat)
    if window_s < ctx.seconds:
        print(f"warning: the stream's {len(stream.timestamps)} frames ended {window_s:.1f} s "
              f"into the {ctx.seconds:g} s window: the cell needs more frames", file=sys.stderr)
    device = common.device_record(dev, ctx.chips)

    metrics, breakdown = {}, None
    if ctx.trace:
        if prof is not None:  # the window ended inside the traced frames
            window_range.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            probe.remove()
            t_trace = time.perf_counter() - t_trace
            keep_prof = prof
        traced = first + min(n, n_trace)
        tr = trace.record(keep_prof)
        reading = probes.Reading(trace=tr, frames=[frames[k] for k in range(first, traced)],
                                 probes=probe, seconds=t_trace, config=cfg, device=dev,
                                 after_frames=[frames[k] for k in range(traced, i)],
                                 after_seconds=t_end - t_after if t_after else 0.0)
        metrics = common.per_layer(ctx.bench, ctx.cell["name"], reading)
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": tr.device_ops_top(), "idle_gaps": tr.idle_by_range()}
    else:
        units = {m["name"]: m["unit"] for m in ctx.bench["end_to_end"]}
        values = {"setup_s": setup_s, "vo_fps": n / window_s,
                  "frame_ms_p95": 1e3 * statistics.quantiles(lat, n=20)[-1] if n >= 2 else None}
        for m in ctx.bench["end_to_end"]:
            if m["name"] in values and ctx.cell["name"] in m.get("workloads", [ctx.cell["name"]]):
                metrics[m["name"]] = {"value": values[m["name"]], "unit": units[m["name"]]}

    # -- correctness, after the window and the peak ---------------------------
    from slambench.reference import vo_check

    trajectory = builder.trajectory
    rng = np.random.default_rng(ctx.seed)
    window = list(range(first, i))
    n_sample = min(int(wl["check"]["frames"]), len(window))
    picks = set(rng.choice(window, size=n_sample, replace=False).tolist()) if window else set()
    if window:
        picks.add(window[int(np.argmax(lat))])
    picked = {k: frames[k] for k in sorted(picks)}
    n_lba = min(int(wl["check"]["local_ba_calls"]), len(lba.calls))
    lba_calls = [lba.calls[k] for k in sorted(rng.choice(len(lba.calls), size=n_lba,
                                                          replace=False).tolist())]
    del builder, frames
    if ctx.trace:
        del reading, keep_prof
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = vo_check.judge(picked, stream, trajectory, i, cfg, wl["check"]["limits"], dev,
                            local_ba=lba_calls)
    checks.append(common.Check("window_short_s", max(0.0, ctx.seconds - window_s), 0.0))
    correct = bool(window) and all(c.ok for c in checks)
    return common.emit(correct, n, 0, metrics, device, checks, breakdown)
