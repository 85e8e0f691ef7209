"""The parts of a run every driver shares: the device's record, the check
that no JAX module was loaded, the per-layer readers, and the result line.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from typing import Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "airslam_tpu")
HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)


class Check:
    """One number the correctness comparison holds against its limit: the run
    is correct when every number is at most its limit (a NaN never is)."""

    def __init__(self, name: str, value: float, limit: float):
        self.name, self.value, self.limit = name, float(value), float(limit)

    @property
    def ok(self) -> bool:
        return self.value <= self.limit

    def line(self) -> str:
        return (f"check {self.name} = {self.value!r} (limit {self.limit!r}): "
                + ("ok" if self.ok else "FAILED"))


def forbidden_modules(names=None) -> List[str]:
    """Top-level names of the loaded modules (or of ``names``) that are JAX's
    or the JAX package's, compared whole: ``airslam_tpu_torch`` is not
    ``airslam_tpu``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def power_limit(index: int = 0) -> str:
    try:
        out = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def device_record(device, chips: int) -> dict:
    """``device`` of the result line: the card's name, the cards used, the
    peak of allocated memory on the fullest of them, and the card's power
    limit (a card set below 700 W runs slower). A CPU run (the tests) names
    its platform and reads no peak."""
    import torch

    if device.type != "cuda":
        return {"platform": device.type, "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips)),
            "power_limit": power_limit()}


def load_reader(name: str):
    """The per-layer reader ``slambench/metrics/<name>.py`` (its ``read``)."""
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("slambench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer(bench: dict, cell: str, ctx) -> Dict[str, dict]:
    """Every per-layer metric of ``BENCHMARK.json`` that names this cell
    (or names no cells), read by its reader from the run's context; a reader
    that finds nothing returns None and the metric is left out."""
    out = {}
    for m in bench["per_layer"]:
        if "workloads" in m and cell not in m["workloads"]:
            continue
        value = load_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def emit(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
         checks: List[Check], breakdown: Optional[dict] = None) -> int:
    """Print the checks as the last lines of standard error and the result as
    the last line of standard output; returns the exit code. No result is
    printed where a JAX module was loaded."""
    found = forbidden_modules()
    if found:
        print(f"error: the run loaded {found}: the benchmark measures the PyTorch port "
              "alone", file=sys.stderr)
        return 5
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    sys.stdout.flush()
    for c in checks:
        print(c.line(), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
