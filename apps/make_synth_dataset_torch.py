#!/usr/bin/env python
"""Render a synthetic stereo(-inertial) sequence to disk in EuRoC/ASL layout
with the PyTorch/CUDA port.

Counterpart of ``apps/make_synth_dataset.py``: the same layout, flags and
files, so the CLI chain (``apps/visual_odometry_torch.py`` →
``apps/evaluate_torch.py``, and the JAX CLIs) runs on it as on EuRoC:

    <out>/<seq>/mav0/
        cam0/data/<ns>.png      left rectified grayscale (raw with --distort_camera)
        cam1/data/<ns>.png      right (baseline 0.1 m along +x)
        imu0/data.csv           ns, gyr xyz, acc xyz (200 Hz, analytic)
        state_groundtruth_estimate0/data.csv   ns, p_xyz, q_wxyz

The world and trajectory are the system benchmark's
(``apps/benchmark_system_torch.py``), rendered on the card and written on
the host; the matching camera YAML is configs/camera/synth_stereo.yaml
(vision-only) / synth_stereo_imu.yaml (VI). The world is drawn from --seed
by PyTorch's generator, so it is another world than the JAX app's for the
same seed (one from the same distributions); ``--world`` renders a stored
world and noise instead (``benchmark_system_torch.load_world``). The
trajectory, the IMU, the ground truth and the hard queries' poses are the
JAX app's.

Usage: python apps/make_synth_dataset_torch.py --out /tmp/synthds --frames 60
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

IMU_RATE = 200.0
FRAME_DT = 0.05  # 20 Hz frames
G_VALUE = 9.81
EPOCH = 1_400_000_000_000_000_000  # EuRoC-style fixed-width (19-digit) nanosecond stamps


def traj_accel(t: np.ndarray, traj: str = "forward", total: float = None) -> np.ndarray:
    """Analytic world acceleration: the exact second derivative of
    ``benchmark_system_torch.traj_position``."""
    ax = -0.3 * 1.6 ** 2 * np.sin(1.6 * t)
    if traj == "forward":
        az = np.zeros_like(t)
    elif traj == "wide":
        w = 2.0 * np.pi / total
        ax = ax - 1.5 * w * w * np.sin(w * t)
        az = 2.0 * (2.0 * w) ** 2 * np.cos(2.0 * w * t)
    else:
        w = 2.0 * np.pi / total
        az = 2.0 * w * w * np.cos(w * t)
    return np.stack([
        ax,
        -0.08 * 2.6 ** 2 * np.sin(2.6 * t),
        az,
    ], axis=-1)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True, help="dataset root directory")
    ap.add_argument("--seq", default="SYNTH_01")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--stride", type=int, default=1,
                    help="trajectory subsampling: 2 = 10 Hz frames over twice "
                         "the span (VI init needs >= 3 s of keyframes)")
    ap.add_argument("--traj", choices=["forward", "loop", "wide"], default="forward",
                    help="loop: out-and-back along z, ends at the start "
                         "(exercises loop closure in map_refinement); wide: "
                         "the z loop twice with a ±1.5 m lateral sweep over the "
                         "same world")
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=752)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--world", default=None,
                    help=".npz of a stored world and noise seed to render instead of "
                         "--seed's (benchmark_system_torch.load_world)")
    ap.add_argument("--hard_queries", type=int, default=0,
                    help="also render N novel-view relocalization queries "
                         "(lateral offset 0.18-0.30 m, yaw 4-9°, pitch ±3° "
                         "off the mapped trajectory) into mav0/hard0/data "
                         "with TUM ground truth in mav0/hard0/gt_tum.txt")
    ap.add_argument("--hard_offset", type=float, default=0.24,
                    help="hard-query mean lateral offset in m (sampled ±25%%)")
    ap.add_argument("--hard_yaw", type=float, default=6.5,
                    help="hard-query mean yaw in deg (sampled ±2.5)")
    ap.add_argument("--texture", type=float, default=0.0,
                    help="1/f plane-texture amplitude (e.g. 0.1): textured "
                         "floor/back-wall with exact multi-view consistency")
    ap.add_argument("--photometric", choices=["none", "dark"], default="none",
                    help="dark: gamma-crushed noisy low-light rendering "
                         "(pair with configs/visual_odometry/vo_euroc_dark.yaml)")
    ap.add_argument("--distort_camera", default=None,
                    help="camera YAML with distortion_type 1 (e.g. "
                         "configs/camera/synth_stereo_distorted.yaml): render "
                         "in that rig's RECTIFIED geometry, then inverse-warp "
                         "each view into the raw distorted domain, which the "
                         "pipeline must rectify on input")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu: where to render")
    return ap.parse_args(argv)


def inverse_maps(camera_yaml: str, height: int, width: int):
    """The distorted rig's rectified intrinsics, baseline and inverse warps:
    for every DISTORTED pixel of each view, where it lands in the rectified
    frame (``cv2.undistortPoints`` through R and P), so that sampling the
    rendered rectified view there gives the raw image whose rectification
    (``Camera.map_left`` / ``map_right``) recovers the render. Returns
    ((fx, fy, cx, cy), baseline, {"cam0": (H, W, 2), "cam1": ...})."""
    import cv2

    from airslam_tpu_torch.core.camera import Camera

    cam = Camera(camera_yaml)
    rect = cam.rect
    if rect is None or rect["type"] != 1:
        raise ValueError("--distort_camera needs a radtan camera (distortion_type 1)")
    # with identical cameras and a pure-x baseline, stereoRectify's rotations
    # are the identity: the rendered (rectified) camera frame is cam0's, so
    # the ground-truth poses need no reframing
    for k in ("R0", "R1"):
        if np.abs(rect[k] - np.eye(3)).max() >= 1e-6:
            raise ValueError(f"--distort_camera: {k} is not the identity:\n{rect[k]}")
    xs, ys = np.meshgrid(np.arange(width, dtype=np.float64), np.arange(height, dtype=np.float64))
    pix = np.stack([xs, ys], -1).reshape(-1, 1, 2)
    maps = {}
    for side, K, D, Rr, P in (("cam0", rect["K0"], rect["D0"], rect["R0"], rect["P0"]),
                              ("cam1", rect["K1"], rect["D1"], rect["R1"], rect["P1"])):
        m = cv2.undistortPoints(pix, K, D, R=Rr, P=P[:3, :3])
        maps[side] = m.reshape(height, width, 2).astype(np.float32)
    return (cam.fx, cam.fy, cam.cx, cam.cy), cam.bf / cam.fx, maps


def distort(images, inv_map, device=None):
    """Each rectified view (N, H, W) sampled at the inverse warp (H, W, 2):
    the raw distorted images, on ``device``. Bilinear with the border
    replicated, in exact float arithmetic, as OpenCV 5's ``remap`` computes
    it (OpenCV 4 rounds each sample position to 1/32 pixel: up to 3 grey
    levels apart at edges), so the tree does not depend on OpenCV's
    version."""
    import torch

    img = torch.as_tensor(np.asarray(images, np.float32), device=device)
    m = torch.as_tensor(inv_map, device=img.device)
    n, h, w = img.shape
    x, y = m[..., 0], m[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    flat = img.reshape(n, h * w)

    def tap(yy, xx):
        idx = yy.clamp(0, h - 1).long() * w + xx.clamp(0, w - 1).long()
        return flat[:, idx.reshape(-1)].reshape(n, h, w)

    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bottom = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    return (top * (1 - fy) + bottom * fy).cpu().numpy()


def write_png(path: str, img):
    """A float image in [0, 1] as an 8-bit PNG (the value × 255, truncated)."""
    import cv2

    cv2.imwrite(path, np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8))


def write_asl(mav0: str, ts, lefts, rights, gt, traj: str, total: float):
    """The ASL tree under ``mav0``: both views' PNGs, the 200 Hz IMU (zero body
    rates; measured acc = a + (0, 0, g), one extra sample on each side of the
    frames, since the dataset reader drops frames outside the IMU's range)
    and the ground truth."""
    for sub in ("cam0/data", "cam1/data", "imu0", "state_groundtruth_estimate0"):
        os.makedirs(os.path.join(mav0, sub), exist_ok=True)

    def stamp(t):
        return EPOCH + int(round(t * 1e9))

    for i in range(len(ts)):
        for cam, img in (("cam0", lefts[i]), ("cam1", rights[i])):
            write_png(os.path.join(mav0, cam, "data", f"{stamp(ts[i])}.png"), img)

    t_imu = np.arange(-1, int(ts[-1] * IMU_RATE) + 2) / IMU_RATE
    acc = traj_accel(np.maximum(t_imu, 0.0), traj, total)
    acc[:, 2] += G_VALUE
    with open(os.path.join(mav0, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for k, t in enumerate(t_imu):
            f.write(f"{stamp(t)},0.0,0.0,0.0,{acc[k, 0]:.9f},{acc[k, 1]:.9f},{acc[k, 2]:.9f}\n")

    with open(os.path.join(mav0, "state_groundtruth_estimate0", "data.csv"), "w") as f:
        f.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], "
                "q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z []\n")
        for i in range(len(ts)):
            p = gt[i][:3, 3]
            f.write(f"{stamp(ts[i])},{p[0]:.9f},{p[1]:.9f},{p[2]:.9f},1.0,0.0,0.0,0.0\n")


def hard_query_poses(seed, gt, n, offset: float = 0.24, yaw_deg: float = 6.5):
    """The poses of ``n`` novel-view relocalization queries off the mapped
    trajectory: the frame index each is near, its position and Rwc. Lateral
    offset in ±25 % of ``offset`` (alternating sides), yaw in ``yaw_deg`` ±
    2.5° (alternating sign), pitch ±3°, drawn as the JAX app draws them."""
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(seed + 7)
    idxs = np.linspace(2, len(gt) - 3, n).astype(int)
    out = []
    for k, i in enumerate(idxs):
        dx = rng.uniform(0.75, 1.25) * offset * (1.0 if k % 2 == 0 else -1.0)
        dy = rng.uniform(-0.08, 0.08)
        dz = rng.uniform(-0.10, 0.10)
        yaw = np.deg2rad(rng.uniform(yaw_deg - 2.5, yaw_deg + 2.5)) * (1.0 if k % 2 else -1.0)
        pitch = np.deg2rad(rng.uniform(-3.0, 3.0))
        Rwc = (Rotation.from_euler("y", yaw) * Rotation.from_euler("x", pitch)).as_matrix()
        out.append((int(i), gt[i][:3, 3] + np.array([dx, dy, dz]), Rwc))
    return out


def render_hard_queries(mav0, seed, ts, gt, n, height, width, draws, gen,
                        offset: float = 0.24, yaw_deg: float = 6.5, subdir: str = "hard0",
                        texture: float = 0.0, photometric: str = "none"):
    """Render :func:`hard_query_poses`' queries of ``draws``' world into
    ``mav0/<subdir>/data`` with TUM ground truth; their pixel (and
    low-light) noise comes from ``gen``. Returns the query directory."""
    import torch
    from scipy.spatial.transform import Rotation

    from airslam_tpu_torch.frontend import synthgen

    from apps.benchmark_system_torch import SYNTH_INTRINSICS

    fx, fy, cx, cy = SYNTH_INTRINSICS
    dev = draws["world"].segments.device
    qdir = os.path.join(mav0, subdir)
    os.makedirs(os.path.join(qdir, "data"), exist_ok=True)
    rows = []
    for i, pos, Rwc in hard_query_poses(seed, gt, n, offset, yaw_deg):
        Rcw = Rwc.T
        img = synthgen.render_view3d(
            draws["world"], torch.as_tensor(Rcw, dtype=torch.float32, device=dev)[None],
            torch.as_tensor(-Rcw @ pos, dtype=torch.float32, device=dev)[None],
            fx, fy, cx, cy, height, width,
            noise=synthgen.view_noise_draws(gen, 1, height, width)["noise"],
            texture=texture, texture_theta=draws["texture"])
        if photometric == "dark":
            img = synthgen.dark_transform(img, synthgen.dark_draws(gen, 1, height, width))
        ns = EPOCH + int(round(ts[i] * 1e9)) + 500_000  # off-grid stamp
        write_png(os.path.join(qdir, "data", f"{ns}.png"), img[0].cpu().numpy())
        rows.append((ns, pos, Rwc))
    with open(os.path.join(qdir, "gt_tum.txt"), "w") as f:
        for ns, pos, Rwc in rows:
            qx, qy, qz, qw = Rotation.from_matrix(Rwc).as_quat()
            f.write(f"{ns * 1e-9:.9f} {pos[0]:.6f} {pos[1]:.6f} {pos[2]:.6f} "
                    f"{qx:.9f} {qy:.9f} {qz:.9f} {qw:.9f}\n")
    return qdir


def main(argv=None, draws=None):
    """``draws``: the sequence's random tensors (``benchmark_system_torch.
    sequence_draws``' layout) to render instead of drawing them; returns
    the ``mav0`` directory."""
    args = parse_args(argv)
    import torch

    from airslam_tpu_torch import resolve_device

    from apps.benchmark_system_torch import load_world, make_sequence, sequence_draws

    device = resolve_device(args.device)
    intrinsics, baseline, inv_maps = None, 0.1, None
    if args.distort_camera:
        intrinsics, baseline, inv_maps = inverse_maps(args.distort_camera, args.height,
                                                      args.width)
    if draws is None and args.world:
        draws = load_world(args.world, args.frames, args.height, args.width,
                           args.photometric, device)
    elif draws is None:
        draws = sequence_draws(args.seed, args.frames, args.height, args.width,
                               args.photometric, device)
    ts, L, R, gt = make_sequence(args.frames, args.height, args.width, draws,
                                 baseline=baseline, stride=args.stride, traj=args.traj,
                                 texture=args.texture, photometric=args.photometric,
                                 intrinsics=intrinsics)
    if inv_maps is not None:
        L, R = distort(L, inv_maps["cam0"], device), distort(R, inv_maps["cam1"], device)
    total = float(args.frames * FRAME_DT * args.stride)
    mav0 = os.path.join(args.out, args.seq, "mav0")
    write_asl(mav0, ts, L, R, gt, args.traj, total)

    if args.hard_queries > 0:
        gen = torch.Generator(device=device).manual_seed(args.seed + 1000)
        qdir = render_hard_queries(mav0, args.seed, ts, gt, args.hard_queries, args.height,
                                   args.width, draws, gen, offset=args.hard_offset,
                                   yaw_deg=args.hard_yaw, texture=args.texture,
                                   photometric=args.photometric)
        print(f"wrote {args.hard_queries} hard relocalization queries to {qdir}")
    print(f"wrote {args.frames}-frame ASL sequence to {mav0}")
    return mav0


if __name__ == "__main__":
    main()
