#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of ``BENCHMARK.json``;
its file ``slambench/workloads/<cell>.json`` names the driver
(``slambench/drivers/<driver>.py``), the traffic generator and its
parameters, and the limits of the correctness comparison; its
configuration's file is the one ``BENCHMARK.json`` gives. The run sets up,
measures for ``--seconds``, compares what the timed path produced with the
plain reference under ``slambench/reference/``, and prints one JSON line:
with ``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics from a ``torch.profiler`` trace. It measures the
PyTorch/CUDA port (``airslam_tpu_torch``) alone and needs a CUDA card.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "slambench", "out")


class RunContext:
    """What a driver gets: the cell's entries and files, the run's arguments,
    the device, and the clock reading at the process's start."""

    def __init__(self, bench, cell, workload, config, seed, seconds, trace, device, t0):
        self.bench, self.cell, self.workload, self.config = bench, cell, workload, config
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t0 = device, t0
        self.chips = int(cell["chips"])


def load(workload: str, root: str = ROOT):
    """(BENCHMARK.json, the cell's entry, its workload file, its
    configuration file) of a cell, found by name."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    with open(os.path.join(root, "slambench", "workloads", workload + ".json")) as f:
        wl = json.load(f)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    return bench, cell, wl, config


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    # the shipped checkpoints, and every cache inside the checkout
    os.environ.pop("AIRSLAM_CHECKPOINT_DIR", None)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(OUT, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(OUT, "triton")
    bench, cell, wl, config = load(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"error: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    import airslam_tpu_torch  # noqa: F401  the program under test; a bare benchmark stops here

    driver = importlib.import_module("slambench.drivers." + wl["driver"])
    ctx = RunContext(bench, cell, wl, config, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), T0)
    return driver.run(ctx)


if __name__ == "__main__":
    sys.exit(main())
