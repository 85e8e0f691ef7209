"""The camera stream of a VO cell: a stereo flight through the rendered
world, as a 20 Hz EuRoC sequence delivers it.

One generator for every VO traffic mix; a mix is the parameters in its
workload file's ``traffic`` block:

- ``trajectory`` (``forward``, ``loop``, ``wide``) and ``time_scale``: the
  camera is at ``traj_position(time_scale · t)`` at frame time t, so 0.125
  flies the same path at an eighth of the speed;
- ``frames``: how many frames the stream holds (a run whose stream ends
  inside its window fails);
- ``distinct_frames`` (optional, a still camera only: ``time_scale`` 0):
  how many frames are rendered; the stream repeats them, each a draw of the
  sensor noise on the one view;
- ``rate_hz``: the camera's frame rate (timestamps);
- ``texture``: 1/f texture on the floor and the back wall (0 = flat shading);
- ``world_seed``: the world and its texture. The world is held fixed across
  runs so that every seed gives the same amount of work: the keyframe rate,
  and with it the frame rate, depends on the scene;
- ``world_z_m``, ``world_segments``, ``world_blobs`` (optional): the
  corridor's extent along z and its numbers of segments and dots (by default
  2 to 20 m, 48 and 320), so that a long flight stays inside the world;
- ``draw_distance_m`` (optional): each batch of views is rendered with the
  segments and dots in front of its cameras and at most this far ahead of
  them, so that a long corridor costs no more a view than a short one;
- the run's ``--seed`` draws the sensor noise of every view.

Each view is rendered rectified with the rig's rectified intrinsics, warped
into the raw distorted image of the configuration's camera
(:mod:`slambench.traffic.distort`) and stored 8-bit on the host, the
value × 255 truncated, as the PNGs of an ASL tree hold it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slambench.traffic import render3d
from slambench.traffic.distort import distort, inverse_maps
from slambench.traffic.trajectory import traj_position


class Repeat:
    """Frame k of a still camera's stream: rendered frame k mod n."""

    def __init__(self, images: np.ndarray, n: int):
        self.images, self.n = images, n

    def __len__(self):
        return self.n

    def __getitem__(self, k):
        return self.images[int(k) % len(self.images)]


class Stream(NamedTuple):
    timestamps: np.ndarray  # (N,) seconds
    images: np.ndarray  # (N, 2, H, W) uint8 (or a Repeat of them): raw left, raw right
    gt_Twc: np.ndarray  # (N, 4, 4) camera-in-world truth of the left camera
    rect: dict  # the rig's rectification (slambench.traffic.rig.rectification)


def generate(traffic: dict, camera: dict, seed: int, device, batch: int = 8) -> Stream:
    """Render the stream a cell's ``traffic`` block describes for the
    configuration's ``camera`` block; ``seed`` draws the sensor noise."""
    rect, inv = inverse_maps(camera)
    n_all = int(traffic["frames"])
    n = min(int(traffic.get("distinct_frames", n_all)), n_all)
    if n < n_all and float(traffic["time_scale"]) != 0.0:
        raise ValueError("distinct_frames repeats the frames of a still camera (time_scale 0)")
    h, w = rect["height"], rect["width"]
    fx, fy, cx, cy = rect["fx"], rect["fy"], rect["cx"], rect["cy"]
    baseline = rect["bf"] / fx
    dt = 1.0 / float(traffic["rate_hz"])
    ts = np.arange(n) * dt
    pos = traj_position(ts * float(traffic["time_scale"]), traffic["trajectory"],
                        n * dt * float(traffic["time_scale"]))
    gt = np.tile(np.eye(4), (n, 1, 1))
    gt[:, :3, 3] = pos

    world_gen = torch.Generator(device=device).manual_seed(int(traffic["world_seed"]))
    z0, z1 = traffic.get("world_z_m", render3d.WORLD_EXTENT[2])
    world = render3d.make_world3d(
        render3d.world3d_draws(world_gen, int(traffic.get("world_segments", 48)),
                               int(traffic.get("world_blobs", 320))),
        extent=render3d.WORLD_EXTENT[:2] + ((float(z0), float(z1)),))
    draw = traffic.get("draw_distance_m")
    theta = render3d.texture_draws(world_gen)["theta"]
    noise_gen = torch.Generator(device=device).manual_seed(int(seed))

    # identity rotations: the world-to-camera translation is −position; the
    # right camera's centre sits ``baseline`` along camera +x
    tcw = torch.as_tensor(-pos, dtype=torch.float32, device=device)
    tcw_r = tcw.clone()
    tcw_r[:, 0] -= baseline
    views = torch.stack([tcw, tcw_r], 1)
    maps = [torch.as_tensor(inv[k], device=device) for k in ("cam0", "cam1")]
    out = np.empty((n, 2, h, w), np.uint8)
    for i0 in range(0, n, batch):
        b = min(batch, n - i0)
        noise = render3d.view_noise_draws(noise_gen, 2 * b, h, w)["noise"]
        eye = torch.eye(3, device=device).expand(2 * b, 3, 3)
        seen = world if draw is None else _ahead(world, pos[i0:i0 + b, 2], float(draw))
        img = render3d.render_view3d(seen, eye, views[i0:i0 + b].reshape(2 * b, 3),
                                     fx, fy, cx, cy, h, w, noise=noise,
                                     texture=float(traffic.get("texture", 0.0)),
                                     texture_theta=theta).reshape(b, 2, h, w)
        raw = torch.stack([distort(img[:, 0], maps[0]), distort(img[:, 1], maps[1])], 1)
        out[i0:i0 + b] = (raw * 255.0).clamp(0, 255).to(torch.uint8).cpu().numpy()
    if n < n_all:
        ts = np.arange(n_all) * dt
        gt = np.tile(gt[:1], (n_all, 1, 1))
        return Stream(ts, Repeat(out, n_all), gt, rect)
    return Stream(ts, out, gt, rect)


def _ahead(world: render3d.World3D, cam_z: np.ndarray, draw: float) -> render3d.World3D:
    """The segments and dots of ``world`` that some camera at depths
    ``cam_z`` (identity rotations) sees in front of it, within ``draw``
    metres: the renderer weighs whatever lies behind every camera by zero."""
    lo, hi = float(cam_z.min()) + 0.25, float(cam_z.max()) + draw
    seg_z = world.segments[..., 2].min(dim=1).values
    s = (seg_z > lo) & (seg_z < hi)
    b = (world.blobs[:, 2] > lo) & (world.blobs[:, 2] < hi)
    return render3d.World3D(world.segments[s], world.seg_shade[s], world.blobs[b],
                            world.blob_shade[b])


def as_delivered(images: np.ndarray):
    """One frame's (2, H, W) uint8 pair as ``io/dataset.py`` hands it to the
    pipeline: float32 in [0, 1], each view its own array."""
    return images[0].astype(np.float32) / 255.0, images[1].astype(np.float32) / 255.0
