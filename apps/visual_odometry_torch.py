#!/usr/bin/env python
"""Visual odometry / mapping CLI of the PyTorch/CUDA port.

Counterpart of ``apps/visual_odometry.py`` on ``airslam_tpu_torch``: consumes
the reference's YAML configs unchanged, runs the VO pipeline over an
ASL/EuRoC dataset (stereo-inertial when the camera config sets ``use_imu: 1``
and the dataset has ``imu0/data.csv``), writes the TUM trajectory and the v0
map (which ``airslam_tpu.io.serialization.load_map`` reads too). The networks
run in float32, as the JAX CLI builds them; ``--dtype bf16`` opts into
bfloat16. Runs on the GPU unless ``--device cpu`` is given; without a card it
fails rather than fall back. ``--mesh_pipelined`` detects chunks of frames
frame-parallel over every visible card (``parallel/pipeline.py``; one card:
a chunk of 1; ``--device cpu``: the one CPU device) while the host tracks
the previous chunk; ``--model_dir`` reads ``plnet.npz`` and
``lightglue.npz`` / ``superglue.npz`` in the JAX layout from a directory,
the shipped checkpoints standing in for a missing file.

Usage:
  python apps/visual_odometry_torch.py --config_path configs/visual_odometry/vo_euroc.yaml \\
      --camera_config_path configs/camera/euroc.yaml \\
      --dataroot /data/euroc/MH_01/mav0 --saving_dir ./out [--use_flash] [--mesh_pipelined]
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config_path", required=True)
    ap.add_argument("--camera_config_path", required=True)
    ap.add_argument("--dataroot", required=True)
    ap.add_argument("--saving_dir", required=True)
    ap.add_argument("--model_dir", default=None, help="directory with *.npz weights")
    ap.add_argument("--traj_path", default=None)
    ap.add_argument("--max_frames", type=int, default=0)
    ap.add_argument("--pipelined", action="store_true",
                    help="queue the next frame's detection on the device before "
                         "the current frame is tracked on the host")
    ap.add_argument("--mesh_pipelined", action="store_true",
                    help="frame-parallel chunked detection over every device in the "
                         "mesh, overlapped with host tracking")
    ap.add_argument("--jax_pnp", action="store_true",
                    help="device-resident RANSAC PnP instead of cv2")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--dtype", default="f32", choices=("f32", "bf16"),
                    help="the networks' type (f32, as the JAX CLI; bf16 opt-in); "
                         "geometry is float32")
    ap.add_argument("--use_flash", action="store_true",
                    help="LightGlue's attention through the fused CUDA kernel")
    return ap.parse_args(argv)


def build(args):
    """The builder and the dataset the arguments name. Returns (builder,
    dataset, device)."""
    import torch

    from airslam_tpu_torch import resolve_device
    from airslam_tpu_torch.core.camera import Camera
    from airslam_tpu_torch.frontend.detector import FeatureDetector
    from airslam_tpu_torch.frontend.matcher import PointMatcher
    from airslam_tpu_torch.io.config import VisualOdometryConfigs
    from airslam_tpu_torch.io.dataset import Dataset
    from airslam_tpu_torch.models.weights import load_model_dir
    from airslam_tpu_torch.pipelines.map_builder import MapBuilder

    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    cfg = VisualOdometryConfigs.load(args.config_path)
    camera = Camera(args.camera_config_path)

    det_params, mat_params = load_model_dir(args.model_dir, cfg.matcher.matcher)
    detector = FeatureDetector(dataclasses.replace(cfg.detector, dtype=dtype), device=device,
                               params=det_params)
    matcher = PointMatcher(
        dataclasses.replace(cfg.matcher, dtype=dtype, use_flash=args.use_flash), device=device,
        params=mat_params)
    builder = MapBuilder(camera, detector, matcher, cfg.keyframe, cfg.backend_optimization,
                         device=device, use_jax_pnp=args.jax_pnp)
    builder.map.ba_early_exit = cfg.early_exit  # opt-in (0.0 = g2o schedule)

    dataset = Dataset(args.dataroot, use_imu=camera.use_imu)
    return builder, dataset, device


def main(argv=None):
    args = parse_args(argv)
    import torch

    from airslam_tpu_torch.io.serialization import save_map

    # float32 networks compute in float32, as the JAX CLI's: no TF32 in
    # cuDNN's convolutions (on by default) or cuBLAS's products
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    builder, dataset, device = build(args)
    n = len(dataset) if args.max_frames <= 0 else min(len(dataset), args.max_frames)
    print(f"dataset: {n} frames on {device}")

    t_start = time.perf_counter()
    if args.mesh_pipelined or args.pipelined:
        from airslam_tpu_torch.parallel.mesh import make_mesh
        from airslam_tpu_torch.parallel.pipeline import MeshPipelinedRunner, PipelinedRunner

        if args.mesh_pipelined:
            mesh = make_mesh() if device.type == "cuda" else make_mesh(devices=[device])
            print(f"mesh: {mesh}")
            runner = MeshPipelinedRunner(builder, mesh)
        else:
            runner = PipelinedRunner(builder)
        runner.run(dataset, max_frames=n,
                   progress=lambda i: print(f"frame {i}/{n}") if i % 50 == 0 else None)
    else:
        for i in range(n):
            ts, left, right, imu_batch = dataset.get(i)
            t0 = time.perf_counter()
            builder.add_input(ts, left, right, imu_batch)
            if i % 50 == 0:
                print(f"frame {i}/{n}  {1e3 * (time.perf_counter() - t0):.1f} ms/frame")
    elapsed = time.perf_counter() - t_start
    print(f"Average FPS: {n / elapsed:.2f}")

    os.makedirs(args.saving_dir, exist_ok=True)
    traj = args.traj_path or os.path.join(args.saving_dir, "trajectory_v0.txt")
    builder.save_trajectory(traj)
    builder.map.check_map()
    save_map(builder.map, os.path.join(args.saving_dir, "AirSLAM_mapv0.bin"))
    n_kf = len(builder.map.keyframes)
    print(f"saved {traj} and AirSLAM_mapv0.bin ({n_kf} keyframes)")
    print(f"keyframe rate: {n_kf}/{n} = {n_kf / max(n, 1):.3f}")
    if dataset.use_imu:
        print(f"imu initialized: {builder.map.imu_initialized}")


if __name__ == "__main__":
    main()
