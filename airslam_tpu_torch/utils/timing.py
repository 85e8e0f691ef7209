"""Timers and profiling.

Port of ``airslam_tpu/utils/timing.py``: an accumulating section timer with
the JAX package's summary format (the per-frame timing the reference prints,
demo/visual_odometry.cpp:49-58) and a ``torch.profiler`` trace context in
place of ``jax.profiler``'s. A section measures the host's clock; a caller
that wants the card's time synchronizes inside the section
(``MapBuilder.stage_timer`` does).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List


class Timer:
    """Accumulating named section timer."""

    def __init__(self):
        self.records: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records[name].append(time.perf_counter() - t0)

    def summary(self) -> str:
        lines = []
        for name, vals in sorted(self.records.items()):
            n = len(vals)
            total = sum(vals)
            lines.append(
                f"{name:30s} n={n:5d} total={total:8.3f}s mean={total / n * 1e3:8.2f}ms"
            )
        return "\n".join(lines)

    def mean(self, name: str) -> float:
        vals = self.records.get(name, [])
        return sum(vals) / len(vals) if vals else 0.0


@contextlib.contextmanager
def device_trace(logdir: str):
    """``torch.profiler`` over the block (the host, and the card when there
    is one); writes ``logdir/trace.json`` (Chrome trace format) on exit and
    yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_label(device) -> str:
    """What a time is measured on: for a card, its name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them (its name alone where ``nvidia-smi`` is missing); else the device."""
    import subprocess

    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return str(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(index)} (power limit not read)"
    return out.splitlines()[0]
