"""Shared set-up of the benchmark's tests: a cell's files at a size the CPU
holds, and a run of a driver in this process with its result line parsed."""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

# CPU sizes: a few frames of the VO stream, a small well-connected map
VO_SMALL = {"frames": 16, "check_frames": 2, "seconds": 3.0}
BA_SMALL = {"keyframes": 40, "points": 2000, "radius_m": 1.2, "iters1": 10, "iters2": 10,
            "seconds": 0.5}


def small_cell(name: str, tf32: bool = False):
    """(BENCHMARK.json, cell entry, workload, configuration) of ``name`` cut to
    the CPU sizes above."""
    from slambench import run as R

    bench, cell, wl, cfg = R.load(name)
    wl, cfg = copy.deepcopy(wl), copy.deepcopy(cfg)
    if wl["driver"] == "vo":
        wl["traffic"]["frames"] = VO_SMALL["frames"]
        wl["check"]["frames"] = VO_SMALL["check_frames"]
        wl["trace"] = {"frames": 2}
        cfg["tf32"] = tf32
    else:
        wl["traffic"].update(keyframes=BA_SMALL["keyframes"], points=BA_SMALL["points"],
                             radius_m=BA_SMALL["radius_m"])
        cfg["global_ba"].update(iters1=BA_SMALL["iters1"], iters2=BA_SMALL["iters2"])
    return bench, cell, wl, cfg


def drive(name: str, seed: int, trace: bool = False, device: str = "cpu", seconds=None,
          **hooks):
    """Run ``name``'s driver once in this process (the harness's look for a
    chip skipped); returns (exit code, the parsed result line or None)."""
    import torch

    from slambench import run as R

    torch.set_num_threads(4)
    bench, cell, wl, cfg = small_cell(name, tf32=hooks.pop("tf32", False))
    small = VO_SMALL if wl["driver"] == "vo" else BA_SMALL
    ctx = R.RunContext(bench, cell, wl, cfg, seed, seconds or small["seconds"], trace,
                       torch.device(device), time.perf_counter())
    driver = __import__("slambench.drivers." + wl["driver"], fromlist=["run"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = driver.run(ctx, **hooks)
    lines = [l for l in out.getvalue().splitlines() if l.startswith("{")]
    return rc, (json.loads(lines[-1]) if lines else None)
