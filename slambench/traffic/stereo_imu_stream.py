"""The stereo-inertial stream of a VI cell: a rotating flight through the
rendered world, as a 20 Hz EuRoC sequence delivers its frames and its
200 Hz IMU.

The traffic block takes :mod:`slambench.traffic.stereo_stream`'s keys
(``trajectory`` — ``forward`` only —, ``time_scale``, ``frames``,
``rate_hz``, ``texture``, ``world_seed``, ``world_z_m``,
``world_segments``, ``world_blobs``, ``draw_distance_m``) and adds:

- ``attitude``: the camera's attitude oscillation on top of the path,
  ``{"yaw": [deg, Hz], "pitch": [deg, Hz], "roll": [deg, Hz]}``; the
  camera-to-world rotation is Ry(yaw) · Rx(pitch) · Rz(roll) in the
  renderer's world (x right, y down, z ahead), each angle
  ``deg · sin(2π · Hz · t)``;
- ``imu_bias_sigma``: ``[gyro rad/s, acc m/s²]``, the per-axis standard
  deviation of the biases' starting values, drawn from the seed.

The images are the camera's alone: they depend on the traffic block, the
configuration's rig and the seed, never on the IMU, so a vision-only
configuration with the same rig gets the same frames bit for bit.

Given a camera block with ``use_imu`` set, the stream also holds the IMU at
the configuration's ``rate_hz``: rows (t, gyro xyz, acc xyz) in the body
frame of cam0's ``T`` (``T_type`` 0: T_bc), from the motion's analytic
angular velocity and specific force with gravity ``g_value`` along the
world's +y, plus white noise at the configuration's densities × √rate and
biases that random-walk at the configured walks (σ · √dt a sample). The
frames sit on the IMU's grid: frame k at sample k · rate / camera rate. The
biases' truth is kept for the comparison.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from slambench.traffic import render3d
from slambench.traffic.distort import distort, inverse_maps
from slambench.traffic.stereo_stream import as_delivered  # noqa: F401  the delivery is shared
from slambench.traffic.trajectory import traj_position


class Stream(NamedTuple):
    timestamps: np.ndarray  # (N,) seconds
    images: np.ndarray  # (N, 2, H, W) uint8: raw left, raw right
    gt_Twc: np.ndarray  # (N, 4, 4) camera-in-world truth of the left camera
    rect: dict  # the rig's rectification (slambench.traffic.rig.rectification)
    imu: Optional[np.ndarray] = None  # (M, 7) t, gyro xyz, acc xyz in the body frame
    imu_bias: Optional[np.ndarray] = None  # (M, 6) the true gyro and acc biases
    gt_vel: Optional[np.ndarray] = None  # (N, 3) the body's velocity in the world
    Tbc: Optional[np.ndarray] = None  # (4, 4) cam0 in the body frame
    gravity: Optional[np.ndarray] = None  # (3,) in the renderer's world


def _node_Tbc(cam: dict) -> np.ndarray:
    T = np.array(cam["T"], np.float64).reshape(4, 4)
    return np.linalg.inv(T) if int(cam.get("T_type", 0)) else T


def _rot(axis: int, a):
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    rows = {0: ((o, z, z), (z, c, -s), (z, s, c)),
            1: ((c, z, s), (z, o, z), (-s, z, c)),
            2: ((c, -s, z), (s, c, z), (z, z, o))}[axis]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


class Motion:
    """The camera's pose at time t (float64 tensors): the path of
    :func:`traj_position` at ``time_scale`` and the attitude oscillation;
    with ``Tbc`` the body's pose too."""

    def __init__(self, traffic: dict, Tbc: Optional[np.ndarray] = None):
        if traffic["trajectory"] != "forward":
            raise ValueError("the stereo-inertial stream flies the 'forward' path")
        self.s = float(traffic["time_scale"])
        att = traffic.get("attitude", {})
        self.att = [(np.deg2rad(float(deg)), float(hz))
                    for deg, hz in (att.get(k, (0.0, 0.0)) for k in ("yaw", "pitch", "roll"))]
        Tcb = np.linalg.inv(Tbc if Tbc is not None else np.eye(4))
        self.Rcb = torch.as_tensor(Tcb[:3, :3])
        self.tcb = torch.as_tensor(Tcb[:3, 3])

    def camera(self, t):
        """(Rwc (3, 3), position (3,)) at the 0-d time ``t``."""
        u = self.s * t
        p = torch.stack([0.3 * torch.sin(1.6 * u), 0.08 * torch.sin(2.6 * u), 2.4 * u])
        (ay, fy), (ap, fp), (ar, fr) = self.att
        two_pi = 2.0 * np.pi
        R = (_rot(1, ay * torch.sin(two_pi * fy * t)) @ _rot(0, ap * torch.sin(two_pi * fp * t))
             @ _rot(2, ar * torch.sin(two_pi * fr * t)))
        return R, p

    def body(self, t):
        R, p = self.camera(t)
        return R @ self.Rcb, p + R @ self.tcb

    def kinematics(self, times: np.ndarray, gravity: np.ndarray):
        """Per time: the body's Rwb, position, velocity, angular velocity in
        the body frame and specific force in the body frame (float64
        numpy), by forward-mode derivatives of :meth:`body`."""
        t = torch.as_tensor(np.asarray(times, np.float64))
        g = torch.as_tensor(gravity)
        jac = torch.func.jacfwd

        def one(ti):
            R, p = self.body(ti)
            dR = jac(lambda x: self.body(x)[0])(ti)
            v = jac(lambda x: self.body(x)[1])(ti)
            a = jac(jac(lambda x: self.body(x)[1]))(ti)
            W = R.T @ dR
            w = torch.stack([W[2, 1] - W[1, 2], W[0, 2] - W[2, 0], W[1, 0] - W[0, 1]]) * 0.5
            return R, p, v, w, R.T @ (a - g)

        return tuple(x.numpy() for x in torch.func.vmap(one)(t))


def _in_view(world: render3d.World3D, Rcw, tcw, ahead_z: float) -> render3d.World3D:
    """The segments and dots of ``world`` that some camera of the batch sees
    in front of it (both ends of a segment at a depth above the renderer's
    0.25 m) and no farther along z than ``ahead_z``: the renderer weighs
    whatever else lies behind every camera by zero."""
    def depth(p):
        return torch.einsum("nk,sk->ns", Rcw[:, 2], p) + tcw[:, 2:3]

    za, zb = depth(world.segments[:, 0]), depth(world.segments[:, 1])
    seg_z = world.segments[..., 2].min(dim=1).values
    s = ((za > 0.25) & (zb > 0.25)).any(0) & (seg_z < ahead_z)
    b = (depth(world.blobs) > 0.25).any(0) & (world.blobs[:, 2] < ahead_z)
    return render3d.World3D(world.segments[s], world.seg_shade[s], world.blobs[b],
                            world.blob_shade[b])


def imu_samples(traffic: dict, camera: dict, n_frames: int):
    """(sample times, frame step) of the IMU grid covering ``n_frames``
    frames and one sample past the last."""
    rate, cam_rate = float(camera["rate_hz"]), float(traffic["rate_hz"])
    step = int(round(rate / cam_rate))
    if abs(step * cam_rate - rate) > 1e-9:
        raise ValueError("the IMU rate must be a whole multiple of the frame rate")
    return np.arange((n_frames - 1) * step + 2) / rate, step


def generate(traffic: dict, camera: dict, seed: int, device, batch: int = 8) -> Stream:
    """Render the stream a cell's ``traffic`` block describes for the
    configuration's ``camera`` block (and its IMU where the block sets
    ``use_imu``); ``seed`` draws the sensor noise, the biases and their walk."""
    rect, inv = inverse_maps(camera)
    n = int(traffic["frames"])
    h, w = rect["height"], rect["width"]
    fx, fy, cx, cy = rect["fx"], rect["fy"], rect["cx"], rect["cy"]
    baseline = rect["bf"] / fx
    # k / rate, correctly rounded: the same double as the IMU grid's sample
    # k · step / (rate · step)
    ts = np.arange(n) / float(traffic["rate_hz"])
    motion = Motion(traffic)
    Rwc, pos = (x.numpy() for x in torch.func.vmap(motion.camera)(torch.as_tensor(ts)))
    gt = np.tile(np.eye(4), (n, 1, 1))
    gt[:, :3, :3] = Rwc
    gt[:, :3, 3] = pos
    if np.abs(pos - traj_position(ts * motion.s, "forward")).max() > 1e-9:
        raise AssertionError("the stream's path left traj_position's")

    world_gen = torch.Generator(device=device).manual_seed(int(traffic["world_seed"]))
    z0, z1 = traffic.get("world_z_m", render3d.WORLD_EXTENT[2])
    world = render3d.make_world3d(
        render3d.world3d_draws(world_gen, int(traffic.get("world_segments", 48)),
                               int(traffic.get("world_blobs", 320))),
        extent=render3d.WORLD_EXTENT[:2] + ((float(z0), float(z1)),))
    draw = float(traffic.get("draw_distance_m", 1e9))
    theta = render3d.texture_draws(world_gen)["theta"]
    noise_gen = torch.Generator(device=device).manual_seed(int(seed))

    Rcw = np.swapaxes(Rwc, 1, 2)
    tcw = -np.einsum("nij,nj->ni", Rcw, pos)
    tcw_r = tcw.copy()
    tcw_r[:, 0] -= baseline  # the right camera's centre sits ``baseline`` along camera +x
    views_R = torch.as_tensor(np.repeat(Rcw, 2, axis=0), dtype=torch.float32, device=device)
    views_t = torch.as_tensor(np.stack([tcw, tcw_r], 1).reshape(2 * n, 3), dtype=torch.float32,
                              device=device)
    maps = [torch.as_tensor(inv[k], device=device) for k in ("cam0", "cam1")]
    out = np.empty((n, 2, h, w), np.uint8)
    for i0 in range(0, n, batch):
        b = min(batch, n - i0)
        noise = render3d.view_noise_draws(noise_gen, 2 * b, h, w)["noise"]
        R_b, t_b = views_R[2 * i0:2 * (i0 + b)], views_t[2 * i0:2 * (i0 + b)]
        seen = _in_view(world, R_b, t_b, float(pos[i0:i0 + b, 2].max()) + draw)
        img = render3d.render_view3d(seen, R_b, t_b, fx, fy, cx, cy, h, w, noise=noise,
                                     texture=float(traffic.get("texture", 0.0)),
                                     texture_theta=theta).reshape(b, 2, h, w)
        raw = torch.stack([distort(img[:, 0], maps[0]), distort(img[:, 1], maps[1])], 1)
        out[i0:i0 + b] = (raw * 255.0).clamp(0, 255).to(torch.uint8).cpu().numpy()
    if not int(camera.get("use_imu", 0)):
        return Stream(ts, out, gt, rect)
    return _with_imu(Stream(ts, out, gt, rect), traffic, camera, seed)


def _with_imu(stream: Stream, traffic: dict, camera: dict, seed: int) -> Stream:
    n = len(stream.timestamps)
    times, step = imu_samples(traffic, camera, n)
    if not np.array_equal(times[::step][:n], stream.timestamps):
        raise AssertionError("the frames are off the IMU's grid")
    Tbc = _node_Tbc(camera["cam0"])
    gravity = np.array([0.0, float(camera["g_value"]), 0.0])
    motion = Motion(traffic, Tbc)
    _, _, vel, gyr, acc = motion.kinematics(times, gravity)
    rate = float(camera["rate_hz"])
    sq = np.sqrt(rate)
    # numpy draws of their own: the images do not depend on them
    rng = np.random.default_rng([int(seed) % 2 ** 63, 0x1A0])
    sg, sa = (float(x) for x in traffic["imu_bias_sigma"])
    m = len(times)
    walk = np.concatenate([
        rng.standard_normal((m, 3)) * float(camera["gyroscope_random_walk"]) / sq,
        rng.standard_normal((m, 3)) * float(camera["accelerometer_random_walk"]) / sq], 1)
    walk[0] = np.concatenate([rng.standard_normal(3) * sg, rng.standard_normal(3) * sa])
    bias = np.cumsum(walk, axis=0)
    white = np.concatenate([
        rng.standard_normal((m, 3)) * float(camera["gyroscope_noise_density"]) * sq,
        rng.standard_normal((m, 3)) * float(camera["accelerometer_noise_density"]) * sq], 1)
    imu = np.concatenate([times[:, None], np.concatenate([gyr, acc], 1) + bias + white], 1)
    return stream._replace(imu=imu, imu_bias=bias, gt_vel=vel[::step][:n], Tbc=Tbc,
                           gravity=gravity)


def imu_batches(stream: Stream, make_row):
    """Each frame's IMU rows as ``io/dataset.py`` hands them to
    ``add_input``: none for the first frame; for frame k the samples from
    the one at frame k − 1 through the one at frame k, and the first sample
    past it. ``make_row(t, gyr, acc)`` builds one row (the program's
    ``ImuData``)."""
    if stream.imu is None:
        return [None] * len(stream.timestamps)
    n = len(stream.timestamps)
    step = (len(stream.imu) - 2) // max(n - 1, 1)
    rows = [make_row(float(r[0]), r[1:4].copy(), r[4:7].copy()) for r in stream.imu]
    return [[]] + [rows[step * (k - 1): step * k + 2] for k in range(1, n)]
