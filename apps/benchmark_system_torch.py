#!/usr/bin/env python
"""Full-system throughput and accuracy of the PyTorch/CUDA port on a rendered
3D sequence: the detector, the matcher, tracking, keyframes, local BA and the
map, as ``apps/visual_odometry_torch.py`` runs them.

Counterpart of ``apps/benchmark_system.py``. A wireframe-and-dots world
(``airslam_tpu_torch.frontend.synthgen.render_view3d``) is rendered into a
stereo sequence on the card; ``MapBuilder.add_input`` then runs frame by
frame (or through ``PipelinedRunner``) with its ``stage_timer`` set. Prints
frames per second, ms per frame, the per-stage breakdown (rectify, detect,
stereo_match, track: the card's time, each section synchronized) and the
Sim(3)-aligned ATE against the ground truth, beside the card's name and
power limit. The warm-up frame stays outside the timed loop.

The world comes from seed 0 through PyTorch's generator, so it is another
world than the JAX benchmark's; ``--world`` renders a stored one instead
(see ``load_world``). ``--model_dir`` reads ``plnet.npz`` and
``lightglue.npz`` in the JAX layout (the JAX benchmark takes the flag and
ignores it); the shipped checkpoints stand in for a missing file.

Usage:
  python apps/benchmark_system_torch.py [--frames 200] [--pipelined] [--json]
      [--profile DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

# the synthetic rig's rectified pinhole intrinsics (fx, fy, cx, cy), whatever
# the rendered size, and its baseline
SYNTH_INTRINSICS = (450.0, 450.0, 376.0, 240.0)
BASELINE = 0.11


def traj_position(t, traj: str = "forward", total: float = None):
    """Analytic trajectory position at time t (seconds). ``forward``: smooth
    forward motion with a weave; ``loop``: out and back along z (returns to
    the start: exercises loop closure); ``wide``: the z loop twice while the
    lateral position sweeps ±1.5 m (one sine period), a wider coverage of the
    same world. Twin of ``make_synth_dataset_torch.traj_accel``."""
    x = 0.3 * np.sin(1.6 * t)
    y = 0.08 * np.sin(2.6 * t)
    if traj == "forward":
        z = 2.4 * t
    elif traj == "wide":
        w = 2.0 * np.pi / total
        x = x + 1.5 * np.sin(w * t)
        z = 2.0 * (1.0 - np.cos(2.0 * w * t))
    else:
        z = 2.0 * (1.0 - np.cos(2.0 * np.pi * t / total))
    return np.stack(np.broadcast_arrays(x, y, z), axis=-1)


def sequence_draws(seed: int, n_frames: int, height: int, width: int,
                   photometric: str = "none", device=None):
    """The random tensors of a sequence from one PyTorch generator seeded
    with ``seed``: the world, the plane texture's angles, each view's pixel
    noise (N, 2, H, W) and, for ``photometric='dark'``, each view's low-light
    noise."""
    import torch

    from airslam_tpu_torch.frontend import synthgen

    gen = torch.Generator(device=device).manual_seed(seed)
    d = {"world": synthgen.make_world3d(synthgen.world3d_draws(gen)),
         "texture": synthgen.texture_draws(gen)["theta"],
         "noise": synthgen.view_noise_draws(gen, 2 * n_frames, height, width)["noise"]
         .reshape(n_frames, 2, height, width)}
    if photometric == "dark":
        d["dark"] = synthgen.dark_draws(gen, 2 * n_frames, height, width)["noise"].reshape(
            n_frames, 2, height, width)
    return d


def load_world(path: str, n_frames: int, height: int, width: int,
               photometric: str = "none", device=None):
    """The draws of a sequence over a stored world: an ``.npz`` holding
    ``world_segments`` (S, 2, 3), ``world_seg_shade`` (S,), ``world_blobs``
    (B, 3), ``world_blob_shade`` (B,), ``texture_theta`` (2, 5, 3) and
    ``noise_seed`` (tests/data/torch_e2e_oracle.npz is one). The pixel noise
    is numpy's ``default_rng(noise_seed).standard_normal((N, 2, H, W),
    float32)`` (frame, then left and right), then the low-light noise of the
    same shape, so another renderer can rebuild it."""
    import torch

    from airslam_tpu_torch.frontend.synthgen import World3D

    with np.load(path) as z:
        world = World3D(*(torch.as_tensor(z[f"world_{k}"], dtype=torch.float32, device=device)
                          for k in ("segments", "seg_shade", "blobs", "blob_shade")))
        texture = torch.as_tensor(z["texture_theta"], dtype=torch.float32, device=device)
        rng = np.random.default_rng(int(z["noise_seed"]))
    shape = (n_frames, 2, height, width)
    d = {"world": world, "texture": texture,
         "noise": torch.as_tensor(rng.standard_normal(shape, dtype=np.float32), device=device)}
    if photometric == "dark":
        d["dark"] = torch.as_tensor(rng.standard_normal(shape, dtype=np.float32),
                                    device=device)
    return d


def make_sequence(n_frames: int, height: int, width: int, draws, baseline: float = BASELINE,
                  stride: int = 1, traj: str = "forward", texture: float = 0.0,
                  photometric: str = "none", intrinsics=None):
    """Render a stereo sequence along an analytic trajectory on the draws'
    device. Returns (timestamps, lefts (N, H, W), rights, gt_Twc list), the
    images float32 numpy in [0, 1]. ``stride`` subsamples the 20 Hz
    trajectory (2 = 10 Hz frames over twice the span); ``texture`` adds 1/f
    plane texture; ``photometric='dark'`` applies the low-light transform
    per view; ``intrinsics`` (fx, fy, cx, cy) overrides the synthetic ones
    (the distorted rig renders with its rectified intrinsics). Frames render
    8 at a time on the card, one at a time on the CPU."""
    import torch

    from airslam_tpu_torch.frontend import synthgen

    fx, fy, cx, cy = (float(v) for v in (intrinsics or SYNTH_INTRINSICS))
    world = draws["world"]
    dev = world.segments.device
    batch = 8 if dev.type == "cuda" else 1
    ts = np.arange(n_frames) * 0.05 * stride
    total = float(n_frames * 0.05 * stride)
    gt = []
    for k in range(n_frames):
        T = np.eye(4)
        T[:3, 3] = traj_position(ts[k], traj, total)
        gt.append(T)
    Rcw = np.stack([T[:3, :3].T for T in gt])
    tcw = np.stack([-T[:3, :3].T @ T[:3, 3] for T in gt])
    # the right camera's centre is the left's + baseline along camera +x
    tcw_r = tcw.copy()
    tcw_r[:, 0] -= baseline
    Rcw_t = torch.as_tensor(Rcw, dtype=torch.float32, device=dev)
    views = torch.as_tensor(np.stack([tcw, tcw_r], 1), dtype=torch.float32, device=dev)
    out = np.empty((n_frames, 2, height, width), np.float32)
    for i0 in range(0, n_frames, batch):
        sl = slice(i0, min(i0 + batch, n_frames))
        b = sl.stop - sl.start
        img = synthgen.render_view3d(
            world, Rcw_t[sl, None].expand(b, 2, 3, 3).reshape(2 * b, 3, 3),
            views[sl].reshape(2 * b, 3), fx, fy, cx, cy, height, width,
            noise=draws["noise"][sl].reshape(2 * b, height, width).to(dev),
            texture=texture, texture_theta=draws["texture"])
        if photometric == "dark":
            img = synthgen.dark_transform(
                img, {"noise": draws["dark"][sl].reshape(2 * b, height, width).to(dev)})
        out[sl] = img.reshape(b, 2, height, width).cpu().numpy()
    return ts, out[:, 0], out[:, 1], gt


class SynthCamera:
    """Camera facade with the synthetic intrinsics (rectified, no
    distortion), the attributes the port's ``MapBuilder`` reads."""

    def __init__(self, height, width, baseline=BASELINE):
        self.fx, self.fy, self.cx, self.cy = SYNTH_INTRINSICS
        self.bf = self.fx * baseline
        self.image_width, self.image_height = width, height
        self.depth_lower_thr, self.depth_upper_thr = 0.5, 25.0
        self.max_x_diff = self.bf / self.depth_lower_thr
        self.min_x_diff = self.bf / self.depth_upper_thr
        self.max_y_diff = 2.0
        self.Tbc = np.eye(4)
        self.Tcb = np.eye(4)
        self.use_imu = False
        self.g_value = 9.81

    def intrinsics(self):
        from airslam_tpu_torch.core.camera import Intrinsics

        return Intrinsics(fx=self.fx, fy=self.fy, cx=self.cx, cy=self.cy, bf=self.bf,
                          width=self.image_width, height=self.image_height)

    def rectify_maps(self, device=None):
        return None, None


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=752)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--world", default=None,
                    help=".npz of a stored world and noise seed to render instead of "
                         "seed 0's (load_world)")
    ap.add_argument("--profile", default=None,
                    help="directory for a torch.profiler trace of the timed loop")
    ap.add_argument("--model_dir", default=None,
                    help="directory with plnet.npz / lightglue.npz in the JAX layout "
                         "(the shipped checkpoints stand in for a missing file)")
    ap.add_argument("--pipelined", action="store_true",
                    help="queue the next frame's detection before the current one is tracked")
    ap.add_argument("--json", action="store_true", help="print one JSON line")
    return ap.parse_args(argv)


def main(argv=None):
    """Returns the run's record: the JSON line's fields, the trajectory
    [(timestamp, Twc)] and the ground truth."""
    args = parse_args(argv)
    import torch

    from airslam_tpu_torch import resolve_device
    from airslam_tpu_torch.frontend.detector import DetectorConfig, FeatureDetector
    from airslam_tpu_torch.frontend.matcher import MatcherConfig, PointMatcher
    from airslam_tpu_torch.io.trajectory import ate_rmse
    from airslam_tpu_torch.models.weights import load_model_dir
    from airslam_tpu_torch.parallel.pipeline import PipelinedRunner
    from airslam_tpu_torch.pipelines.map_builder import MapBuilder
    from airslam_tpu_torch.utils.timing import Timer, device_label, device_trace

    device = resolve_device(args.device)
    on = device_label(device)
    print(f"rendering {args.frames}-frame synthetic stereo sequence on {on}...", flush=True)
    if args.world:
        draws = load_world(args.world, args.frames, args.height, args.width, device=device)
    else:
        draws = sequence_draws(0, args.frames, args.height, args.width, device=device)
    t0 = time.perf_counter()
    ts, lefts, rights, gt = make_sequence(args.frames, args.height, args.width, draws)
    render_ms = (time.perf_counter() - t0) * 1e3 / args.frames

    det_params, mat_params = load_model_dir(args.model_dir, 0)
    det = FeatureDetector(DetectorConfig(max_keypoints=400, use_superpoint=False,
                                         dtype=torch.bfloat16), device=device, params=det_params)
    matcher = PointMatcher(MatcherConfig(matcher=0, max_keypoints=400, dtype=torch.bfloat16),
                           device=device, params=mat_params)
    builder = MapBuilder(SynthCamera(args.height, args.width), det, matcher, device=device)
    timer = Timer()
    builder.stage_timer = timer

    # the warm-up frame stays outside the timed loop
    builder.add_input(ts[0], lefts[0], rights[0], None)
    timer.records.clear()

    class _Seq:
        def __len__(self):
            return args.frames - 1

        def get(self, i):
            return ts[i + 1], lefts[i + 1], rights[i + 1], None

    def loop():
        if args.pipelined:
            PipelinedRunner(builder).run(_Seq())
        else:
            for i in range(1, args.frames):
                builder.add_input(ts[i], lefts[i], rights[i], None)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    if args.profile:
        with device_trace(args.profile):
            loop()
    else:
        loop()
    elapsed = time.perf_counter() - t0
    if args.profile:
        print(f"profiler trace written to {args.profile}")

    n = args.frames - 1
    hz = n / elapsed
    est = builder.trajectory
    gt_traj = [(ts[i], gt[i]) for i in range(args.frames)]
    try:
        ate = ate_rmse(est, gt_traj, align=True)
    except np.linalg.LinAlgError as e:  # degenerate tracking
        ate = float("nan")
        print(f"ATE failed: {e}")

    print(f"\nfull-system: {hz:.2f} Hz ({1e3 / hz:.1f} ms/frame) over {n} frames on {on}")
    print(f"keyframes: {len(builder.map.keyframes)}  mappoints: {len(builder.map.mappoints)}")
    print(f"ATE RMSE (aligned): {ate * 100:.2f} cm over {0.12 * args.frames:.1f} m")
    print(f"render: {render_ms:.3f} ms per stereo pair on {on}")
    if args.pipelined:
        print("no per-stage breakdown: PipelinedRunner overlaps the stages")
    else:
        print(f"\nper-stage breakdown (each stage synchronized, {on}):")
        print(timer.summary())
    record = {"metric": "full_system_hz", "value": round(hz, 2),
              "unit": f"Hz full VO system @{args.width}x{args.height} synthetic",
              "vs_baseline": round(hz / 73.0, 3), "ate_cm": round(ate * 100, 2),
              "ms_per_frame": 1e3 / hz, "frames": n, "tracked": len(est),
              "keyframes": len(builder.map.keyframes),
              "stage_ms": {k: 1e3 * timer.mean(k) for k in sorted(timer.records)},
              "render_ms_per_pair": render_ms, "device": on}
    if args.json:
        print(json.dumps(record))
    return dict(record, trajectory=est, gt=gt_traj)


if __name__ == "__main__":
    main()
