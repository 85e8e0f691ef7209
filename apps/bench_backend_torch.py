#!/usr/bin/env python
"""Backend benchmark of the PyTorch/CUDA port: the full local-BA window
(robust 5 iterations → chi² gate → 15 iterations, ``windows.local_ba``) on
one synthetic window, its accuracy against the ground truth and its time per
call.

Counterpart of ``apps/bench_backend.py`` on the same window:
``make_point_scene(f=5, p=230)`` from ``RandomState(0)`` (the port's copy,
``entry.point_scene``), the poses of frames 1-4 perturbed by 0.02 rad and
0.05 m, the points by 0.05 m, in the given type (f32 by default). It prints
the pose error against the ground truth and the inliers, then the time per
call: the median of ``--calls`` calls after the accuracy call and
``--warmup`` more, each timed with CUDA events on the card (the host clock
on the CPU), beside the card's name and power limit; then the
``early_exit=1e-6`` variant's error and time, measured the same way.

Usage: python apps/bench_backend_torch.py [--device cpu] [--dtype f64] [--calls 20]
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    from airslam_tpu_torch.utils import device as device_util

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--points", type=int, default=230)
    ap.add_argument("--dtype", default="f32", choices=("f32", "f64"))
    ap.add_argument("--calls", type=int, default=20, help="timed calls (their median)")
    ap.add_argument("--warmup", type=int, default=3)
    device_util.add_arg(ap)
    return ap.parse_args(argv)


def window(frames: int, points: int, seed: int, dtype, device):
    """(the perturbed window problem, the scene's true poses and points) of
    ``apps/bench_backend.py``."""
    import numpy as np
    from scipy.spatial.transform import Rotation

    from airslam_tpu_torch.entry import point_scene, window_problem

    rng = np.random.RandomState(seed)
    scene = point_scene(frames, points, rng)
    Rwb0, twb0 = scene["Rwb"].copy(), scene["twb"].copy()
    for i in range(1, frames):
        Rwb0[i] = Rwb0[i] @ Rotation.from_rotvec(rng.randn(3) * 0.02).as_matrix()
        twb0[i] = twb0[i] + rng.randn(3) * 0.05
    pts0 = scene["points"] + rng.randn(*scene["points"].shape) * 0.05
    prob = window_problem(scene, Rwb=Rwb0, twb=twb0, points=pts0, dtype=dtype, device=device)
    return prob, scene


def card_name():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def time_ms(fn, device, calls: int, warmup: int) -> float:
    """Median ms per call of ``fn`` after ``warmup`` calls: CUDA events on
    the card, the host clock on the CPU."""
    import numpy as np
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(calls):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def main(argv=None):
    """Runs the benchmark. Returns a dict: ``twb`` (the full schedule's
    poses), ``err`` / ``err_early`` (m, against the ground truth),
    ``inliers`` / ``n_obs``, ``ms`` / ``ms_early`` (median per call),
    ``device``."""
    args = parse_args(argv)
    import numpy as np
    import torch

    from airslam_tpu_torch.backend import windows
    from airslam_tpu_torch.entry import _intrinsics
    from airslam_tpu_torch.utils import device as device_util

    device = device_util.select(args.device)
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    prob, scene = window(args.frames, args.points, 0, dtype, device)
    intr = _intrinsics()
    on = card_name() if device.type == "cuda" else "the CPU"

    out, p_in, _ = windows.local_ba(prob, intr)
    twb = out.frames.twb.cpu().numpy()
    err = float(np.abs(twb - scene["twb"]).max())
    inl, n_obs = int(p_in.sum()), int(prob.point_obs_mask.sum())
    print(f"{args.dtype} local BA on {device}: pose err vs GT = {err:.2e} m, "
          f"inliers {inl}/{n_obs}")
    ms = time_ms(lambda: windows.local_ba(prob, intr), device, args.calls, args.warmup)
    print(f"local BA window (F={args.frames}, P={args.points}, 5+15 LM iters): {ms:.3f} ms "
          f"(median of {args.calls} calls after {1 + args.warmup}) on {on}")

    # opt-in early-exit LM (optimization.early_exit): equal accuracy, fewer iters
    out_ee, _, _ = windows.local_ba(prob, intr, early_exit=1e-6)
    err_ee = float(np.abs(out_ee.frames.twb.cpu().numpy() - scene["twb"]).max())
    ms_ee = time_ms(lambda: windows.local_ba(prob, intr, early_exit=1e-6), device,
                    args.calls, args.warmup)
    print(f"local BA early_exit=1e-6: {ms_ee:.3f} ms ({ms / max(ms_ee, 1e-12):.2f}x), "
          f"pose err {err_ee:.2e} m (full schedule: {err:.2e}) on {on}")
    return {"twb": twb, "err": err, "err_early": err_ee, "inliers": inl, "n_obs": n_obs,
            "ms": ms, "ms_early": ms_ee, "device": on}


if __name__ == "__main__":
    main()
