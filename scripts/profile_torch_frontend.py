"""Where the time of the PyTorch port's frame goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_frontend.py [--dtype bf16|f32] [--tracked | --vo] [--use_flash]

Without ``--tracked`` it runs ``FrontendStep.rectify`` (kernel R) →
``FrontendStep`` on the first stored oracle pair with the EuRoC grids, as
``chip_smoke.py``'s path phase does. With ``--tracked`` it initialises the
port's ``MapBuilder`` (SuperPoint keypoints) on pair 0 and runs
``MapBuilder.track_frame`` on pair 1 against that keyframe: the per-frame
tracking path with kernels R, ``loi_features`` and P. With ``--vo`` it runs
``MapBuilder.add_input`` over the 8 stored frames of
``tests/data/torch_vo_oracle.npz`` (initialisation, tracking, four keyframe
insertions with the local BA; a first pass warms up) and also counts the
kernel launches issued inside the ``local_ba`` ranges. ``--use_flash`` sends
LightGlue's attention through kernel F. It reports from ``torch.profiler``
over 20 frames (``--vo``: the 8 frames of one pass):

- per stage, the spans the port itself opens (``utils/timing.span``)
  (``rectify``, ``resize+plnet``, ``superpoint``, ``decode+loi`` with the
  stage-1 head's ``loi`` inside it, ``stereo+temporal match`` with
  ``lightglue`` and ``match`` inside it,
  ``build_frame``, ``pnp``, ``pose_only``): the host time spent inside the
  range and the device (kernel) time of the kernels launched inside it, per
  frame;
- kernels launched per frame, summed device time per frame, the device's busy
  share of the profiled wall time and of the unprofiled frame time, and the
  kernels that take the most device time (the ctypes-launched kernels R,
  ``loi_features``, P and F count in the totals but are not attributed to a
  range);
- the per-frame wall time of the same frames without the profiler (CUDA
  events).

Writes the numbers to ``chiprun_out/profile_frontend_<dtype>.json``
(``profile_tracked_<dtype>.json`` with ``--tracked``,
``profile_vo_<dtype>.json`` with ``--vo``) as well.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

RANGES = ("rectify", "resize+plnet", "superpoint", "decode+loi", "loi", "stereo+temporal match",
          "lightglue", "match", "build_frame", "pnp", "pose_only", "local_ba")
# the window backend's spans inside a keyframe: on the device's timeline
# they are ranges, not kernels
BACKEND_SPANS = ("insert_keyframe", "triangulate", "local_map.build", "local_map.write_back",
                 "lm.step", "lm.assemble", "lm.solve", "lm.cost", "ba.gate")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--tracked", action="store_true",
                    help="profile one tracked frame of MapBuilder instead of the frontend step")
    ap.add_argument("--vo", action="store_true",
                    help="profile add_input over the stored VO sequence (keyframes, local BA)")
    ap.add_argument("--use_flash", action="store_true",
                    help="LightGlue's attention through the fused CUDA kernel")
    args = ap.parse_args()
    n_frames = 20

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from airslam_tpu_torch.entry import FrontendStep

    if not torch.cuda.is_available():
        sys.exit("profile_torch_frontend: needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    if args.dtype == "f32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    frames, _ = chip_smoke.oracle_pairs()
    if args.vo:
        cam, vo_frames, rec = chip_smoke.vo_oracle()
        first = chip_smoke.tracking_builder(cam, dtype, dev, identity_rectify=True,
                                            use_flash=args.use_flash)
        n_frames, per_call = 1, len(vo_frames)

        def frame():
            builder = chip_smoke.tracking_builder_like(first)
            for i in range(per_call):
                builder.add_input(float(rec["timestamps"][i]), vo_frames[i][0], vo_frames[i][1])
            return builder
    elif args.tracked:
        builder = chip_smoke.tracking_builder(chip_smoke.tracking_oracle()[0], dtype, dev,
                                              identity_rectify=True, use_flash=args.use_flash)
        builder.add_input(0.0, frames[0][0], frames[0][1])
        if not builder.init:
            sys.exit("profile_torch_frontend: pair 0 did not initialise the map")

        def frame():
            return builder.track_frame(0.05, frames[1][0], frames[1][1])
    else:
        step = FrontendStep(dtype=dtype, device=dev)
        raw = torch.as_tensor(frames[0], device=dev)
        grids = torch.as_tensor(chip_smoke.euroc_grids(), device=dev)

        def frame():
            left, right = step.rectify(raw[0], raw[1], grids)
            return step(torch.stack([left, right]))

    if not args.vo:
        per_call = 1
    for _ in range(1 if args.vo else 3):
        frame()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_frames):
        frame()
    end.record()
    torch.cuda.synchronize()
    n_frames *= per_call  # from here on: frames, not calls
    frame_ms = start.elapsed_time(end) / n_frames

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_frames // per_call):
            frame()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_frames
    events = prof.events()
    stages = {}
    for name in RANGES:
        hits = [e for e in events if e.name == name and e.device_type == DeviceType.CPU]
        stages[name] = {"host_ms": sum(e.cpu_time_total for e in hits) / 1e3 / n_frames,
                        "device_ms": sum(e.device_time_total for e in hits) / 1e3 / n_frames,
                        "calls_per_frame": len(hits) / n_frames}
    ba = [e for e in events if e.name == "local_ba" and e.device_type == DeviceType.CPU]
    if ba:
        spans = [(e.time_range.start, e.time_range.end) for e in ba]
        inside = sum(1 for e in events
                     if e.device_type == DeviceType.CPU and e.name == "cudaLaunchKernel"
                     and any(a <= e.time_range.start <= b for a, b in spans))
        stages["local_ba"].update(calls=len(ba), launches_per_call=inside / len(ba),
                                  host_ms_per_call=sum(e.cpu_time_total for e in ba) / 1e3 / len(ba),
                                  device_ms_per_call=sum(e.device_time_total for e in ba) / 1e3
                                  / len(ba))
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name not in RANGES + BACKEND_SPANS]
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n_frames
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]

    result = {
        "device": smi, "dtype": args.dtype, "frames": n_frames,
        "path": ("VO sequence" if args.vo else "tracked frame" if args.tracked else "frontend")
        + (" use_flash" if args.use_flash else ""),
        "frame_ms_events": frame_ms, "stages": stages,
        "profiled_wall_ms_per_frame": wall_ms,
        "kernel_launches_per_frame": len(kernels) / n_frames,
        "device_ms_per_frame": dev_ms,
        "device_busy_share": dev_ms / wall_ms,
        "device_busy_share_unprofiled": dev_ms / frame_ms,
        "top_kernels": [{"name": n[:90], "calls_per_frame": c / n_frames,
                         "ms_per_frame": t / n_frames} for n, (c, t) in top],
    }
    print(f"device: {smi}  dtype={args.dtype}  path={result['path']}")
    print(f"frame (no profiler, CUDA events, {n_frames} frames): {frame_ms:.3f} ms")
    print("stages per frame: " + " ".join(
        f"{k}: host_ms={v['host_ms']:.3f} device_ms={v['device_ms']:.3f}"
        for k, v in stages.items() if v["calls_per_frame"]))
    print(f"profiled: wall_ms/frame={wall_ms:.3f} device_ms/frame={dev_ms:.3f} "
          f"busy_share={result['device_busy_share']:.3f} "
          f"(of the unprofiled frame: {result['device_busy_share_unprofiled']:.3f}) "
          f"kernels/frame={result['kernel_launches_per_frame']:.0f}")
    if ba:
        v = stages["local_ba"]
        print(f"local_ba per call ({v['calls']} calls): host_ms={v['host_ms_per_call']:.1f} "
              f"device_ms={v['device_ms_per_call']:.2f} launches={v['launches_per_call']:.0f}")
    for k in result["top_kernels"]:
        print(f"  {k['ms_per_frame']:.4f} ms/frame  x{k['calls_per_frame']:.0f}  {k['name']}")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    stem = "profile_vo" if args.vo else "profile_tracked" if args.tracked else "profile_frontend"
    if args.use_flash:
        stem += "_flash"
    with open(os.path.join(REPO, "chiprun_out", f"{stem}_{args.dtype}.json"), "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
