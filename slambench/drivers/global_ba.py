"""Driver of the map-scale GlobalBA cells: ``backend/global_ba.global_ba``
solved back to back from one device-resident problem.

Set-up builds the map of the traffic generator on the card in the
configuration's dtype (the port's ``SparseBAProblem``: no lines but one
masked dummy, the observation table as wide as ``Map._sparse_global_ba``
makes it) and warms the solver up with one iteration of each pass, which
runs every shape a full solve runs. The window then solves the problem again
and again, each solve the configuration's schedule (a robust pass, the χ²
gate, a second pass), until ``--seconds`` have passed and the solve under
way has finished. ``global_ba_s`` is the window over the solves.

Once the window has closed and the peak memory is read,
``slambench/reference/ba_check.py`` holds every solve's poses, points and
inlier flags against the map's truth.
"""

from __future__ import annotations

import gc
import importlib
import time

import numpy as np

from slambench.harness import common, probes, trace


def build_problem(scene: dict, table: np.ndarray, dtype, device):
    """The port's ``SparseBAProblem`` of a map scene."""
    import torch

    from airslam_tpu_torch.backend import global_ba as gba

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device).to(dtype)

    def i(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    def b(a):
        return torch.as_tensor(np.asarray(a, bool), device=device)

    return gba.SparseBAProblem(
        Rwb=f(scene["Rwb"]), twb=f(scene["twb0"]), pose_fixed=b(scene["pose_fixed"]),
        points=f(scene["pts0"]), pobs_pidx=i(scene["pidx"]), pobs_fidx=i(scene["fidx"]),
        pobs=f(scene["pobs"]), pobs_mask=b(scene["ok"]), point_obs_table=i(table),
        lines=f([[1.0, 0, 0, 0, 1, 0]]), lobs_lidx=i([0]), lobs_fidx=i([0]),
        lobs=f(np.zeros((1, 8))), lobs_stereo=b([False]), lobs_mask=b([False]),
        lobs_sigma=f([0.001]), line_obs_table=i([[1]]), Rcb=f(np.eye(3)), tcb=f(np.zeros(3)))


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(ctx, solver=None) -> int:
    """One run of a GlobalBA cell; returns the exit code. ``solver``: a
    callable with ``global_ba``'s signature in place of the program's (the
    fault tests plant a broken one)."""
    import torch

    from airslam_tpu_torch.backend import global_ba as gba
    from airslam_tpu_torch.core.camera import Intrinsics
    from airslam_tpu_torch.io.config import parse_ba_config

    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    traffic = wl["traffic"]
    gen = importlib.import_module("slambench.traffic." + traffic["generator"])
    cam = cfg["camera"]
    scene = gen.generate(traffic, cam, ctx.seed)
    n_points = scene["pts"].shape[0]
    width = gen.table_width(scene["pidx"], scene["ok"], n_points)
    table = gen.obs_table(scene["pidx"], scene["ok"], n_points, width)
    dtype = {"float32": torch.float32, "float64": torch.float64}[cfg["dtype"]]
    prob = build_problem(scene, table, dtype, dev)
    intr = Intrinsics(cam["fx"], cam["fy"], cam["cx"], cam["cy"], cam["bf"], cam["width"],
                      cam["height"])
    bacfg = parse_ba_config({"optimization": cfg["optimization"]}, "backend")
    sched = cfg["global_ba"]
    solve = solver or gba.global_ba

    def one(iters1, iters2):
        return solve(prob, intr, bacfg, iters1=iters1, iters2=iters2, chunk=int(sched["chunk"]))

    one(1, 1)  # every shape of a solve, once
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - ctx.t0

    n_trace = int(wl["trace"]["solves"]) if ctx.trace else 0
    outs, times = [], []
    keep_prof = None
    t_start = time.perf_counter()
    while True:
        tracing = len(times) < n_trace
        if tracing and not times:
            probe = probes.Probes()
            prof = probes.start_profiler()
            t_trace = time.perf_counter()
            window_range = torch.profiler.record_function(trace.WINDOW_RANGE)
            window_range.__enter__()
        t1 = time.perf_counter()
        with torch.profiler.record_function(trace.SOLVE_RANGE):
            out, p_in, _ = one(int(sched["iters1"]), int(sched["iters2"]))
            _sync(dev)
        times.append(time.perf_counter() - t1)
        outs.append((out.Rwb, out.twb, out.points, p_in))
        if tracing and len(times) == n_trace:
            window_range.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            probe.remove()
            t_trace = time.perf_counter() - t_trace
            keep_prof = prof
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    window_s = time.perf_counter() - t_start
    n = len(times)
    device = common.device_record(dev, ctx.chips)

    metrics, breakdown = {}, None
    if ctx.trace:
        tr = trace.record(keep_prof)
        iters = n_trace * (int(sched["iters1"]) + int(sched["iters2"]))
        reading = probes.Reading(trace=tr, frames=[], probes=probe, seconds=t_trace, config=cfg,
                                 device=dev, iterations=iters)
        metrics = common.per_layer(ctx.bench, ctx.cell["name"], reading)
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": tr.device_ops_top(), "idle_gaps": tr.idle_by_range()}
        del reading, keep_prof
    else:
        values = {"setup_s": setup_s, "global_ba_s": window_s / n}
        for m in ctx.bench["end_to_end"]:
            if m["name"] in values and ctx.cell["name"] in m.get("workloads", [ctx.cell["name"]]):
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    # -- correctness, after the window and the peak ---------------------------
    from slambench.reference import ba_check

    del prob
    gc.collect()
    checks = ba_check.judge(outs, scene, cfg, wl["check"]["limits"], dev)
    bad = sum(1 for o in outs if not all(bool(torch.isfinite(t).all()) for t in o[:3]))
    return common.emit(all(c.ok for c in checks), n, bad, metrics, device, checks, breakdown)
