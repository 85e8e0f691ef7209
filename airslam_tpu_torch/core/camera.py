"""Stereo(-inertial) camera model: YAML parsing, rectification maps,
projection.

Port of ``airslam_tpu/core/camera.py``. The YAML schema is the reference's
(``configs/camera/*.yaml``). ``yaml`` and ``cv2`` are imported inside the
constructor, only when a file is parsed or a distorted rig rectified.
:func:`undistort_rectify_map` is the radtan formula of
``cv2.initUndistortRectifyMap`` in numpy, for callers without OpenCV.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Intrinsics:
    """Rectified pinhole intrinsics + stereo baseline (``fx * baseline``).
    The methods take tensors of any leading shape (camera.h:56-90)."""

    fx: float
    fy: float
    cx: float
    cy: float
    bf: float
    width: int = 752
    height: int = 480

    def project(self, p3d):
        z_inv = 1.0 / p3d[..., 2]
        u = p3d[..., 0] * z_inv * self.fx + self.cx
        v = p3d[..., 1] * z_inv * self.fy + self.cy
        return torch.stack([u, v], dim=-1)

    def stereo_project(self, p3d):
        """(…, 3) -> (…, 3) = (u_left, v, u_right)."""
        z_inv = 1.0 / p3d[..., 2]
        u = p3d[..., 0] * z_inv * self.fx + self.cx
        v = p3d[..., 1] * z_inv * self.fy + self.cy
        return torch.stack([u, v, u - self.bf * z_inv], dim=-1)

    def in_image(self, uv):
        return ((uv[..., 0] >= 0) & (uv[..., 0] < self.width)
                & (uv[..., 1] >= 0) & (uv[..., 1] < self.height))

    def back_project_mono(self, uv):
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        return torch.stack([x, y, torch.ones_like(x)], dim=-1)

    def back_project_stereo(self, uvr):
        ray = self.back_project_mono(uvr[..., :2])
        depth = self.bf / (uvr[..., 0] - uvr[..., 2])
        return ray * depth[..., None]

    def depth_from_disparity(self, disp):
        return self.bf / disp


def undistort_rectify_map(K, D, R, P, size):
    """(H, W, 2) float32 (x, y) source grid of a radtan camera: the formula of
    ``cv2.initUndistortRectifyMap`` (``D`` = [k1, k2, p1, p2, k3]), in f64.

    K: 3×3 camera matrix; R: 3×3 rectification rotation; P: 3×3 (or 3×4)
    new camera matrix; size: (width, height)."""
    w, h = int(size[0]), int(size[1])
    K = np.asarray(K, np.float64)
    k1, k2, p1, p2, k3 = (list(np.asarray(D, np.float64).ravel()) + [0.0] * 5)[:5]
    ir = np.linalg.inv(np.asarray(P, np.float64)[:3, :3] @ np.asarray(R, np.float64))
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    xh = ir[0, 0] * u + ir[0, 1] * v + ir[0, 2]
    yh = ir[1, 0] * u + ir[1, 1] * v + ir[1, 2]
    wh = ir[2, 0] * u + ir[2, 1] * v + ir[2, 2]
    x, y = xh / wh, yh / wh
    x2, y2, xy = x * x, y * y, x * y
    r2 = x2 + y2
    kr = 1.0 + ((k3 * r2 + k2) * r2 + k1) * r2
    xd = x * kr + 2.0 * p1 * xy + p2 * (r2 + 2.0 * x2)
    yd = y * kr + p1 * (r2 + 2.0 * y2) + 2.0 * p2 * xy
    mx = K[0, 0] * xd + K[0, 2]
    my = K[1, 1] * yd + K[1, 2]
    return np.stack([mx, my], axis=-1).astype(np.float32)


def _read_camera_node(cam_node):
    """camera.cc:140-166: intrinsics [fx, fy, cx, cy], 5 distortion coeffs, Tbc."""
    intr = [float(x) for x in cam_node["intrinsics"]]
    K = np.array([[intr[0], 0, intr[2]], [0, intr[1], intr[3]], [0, 0, 1]],
                 dtype=np.float64)
    D = np.array([float(x) for x in cam_node["distortion_coeffs"]], dtype=np.float64)
    T = np.array(cam_node["T"], dtype=np.float64).reshape(4, 4)
    if int(cam_node.get("T_type", 0)):
        T = np.linalg.inv(T)  # Kalibr gives Tcb
    return K, D, T


class Camera:
    """Host-side camera: YAML parsing, rectification-map precompute, IMU
    noise (camera.h:22-92, camera.cc:40-103)."""

    def __init__(self, camera_file: Optional[str] = None, node: Optional[dict] = None):
        if node is None:
            import yaml

            with open(camera_file, "r") as f:
                text = f.read()
            # OpenCV "%YAML:1.0" headers are not valid YAML 1.1
            lines = [l for l in text.splitlines() if not l.startswith("%YAML")]
            node = yaml.safe_load("\n".join(lines))

        self.image_height = int(node["image_height"])
        self.image_width = int(node["image_width"])
        self.depth_lower_thr = float(node["depth_lower_thr"])
        self.depth_upper_thr = float(node["depth_upper_thr"])
        self.max_y_diff = float(node["max_y_diff"])

        K0, D0, Tbc0 = _read_camera_node(node["cam0"])
        K1, D1, Tbc1 = _read_camera_node(node["cam1"])
        Tc1c0 = np.linalg.inv(Tbc1) @ Tbc0
        self.Tbc = Tbc0
        self.Tcb = np.linalg.inv(Tbc0)

        self.map_left = None  # (H, W, 2) float32 source-pixel grid or None
        self.map_right = None
        self.rect = None

        distortion_type = int(node["distortion_type"])
        if distortion_type == 0:
            fx, fy, cx, cy = K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2]
            bf = fx * abs(Tc1c0[0, 3])
        else:
            import cv2

            size = (self.image_width, self.image_height)
            R10 = np.ascontiguousarray(Tc1c0[:3, :3])
            t10 = np.ascontiguousarray(Tc1c0[:3, 3]).reshape(3, 1)
            if distortion_type == 1:
                R0, R1, P0, P1, _, _, _ = cv2.stereoRectify(
                    K0, D0, K1, D1, size, R10, t10, flags=cv2.CALIB_ZERO_DISPARITY, alpha=0)
                ml1, ml2 = cv2.initUndistortRectifyMap(K0, D0, R0, P0[:3, :3], size, cv2.CV_32FC1)
                mr1, mr2 = cv2.initUndistortRectifyMap(K1, D1, R1, P1[:3, :3], size, cv2.CV_32FC1)
            else:
                R0, R1, P0, P1, _ = cv2.fisheye.stereoRectify(
                    K0, D0[:4].reshape(4, 1), K1, D1[:4].reshape(4, 1), size, R10,
                    t10.reshape(3, 1), flags=cv2.CALIB_ZERO_DISPARITY, balance=0,
                    fov_scale=0.8)
                ml1, ml2 = cv2.fisheye.initUndistortRectifyMap(
                    K0, D0[:4].reshape(4, 1), R0, P0[:3, :3], size, cv2.CV_32FC1)
                mr1, mr2 = cv2.fisheye.initUndistortRectifyMap(
                    K1, D1[:4].reshape(4, 1), R1, P1[:3, :3], size, cv2.CV_32FC1)
            self.map_left = np.stack([ml1, ml2], axis=-1)
            self.map_right = np.stack([mr1, mr2], axis=-1)
            self.rect = dict(type=distortion_type, K0=K0, D0=D0, K1=K1, D1=D1,
                             R0=R0, R1=R1, P0=P0, P1=P1)
            bf = abs(P1[0, 3])
            fx, fy, cx, cy = P0[0, 0], P0[1, 1], P0[0, 2], P0[1, 2]

        self.fx, self.fy, self.cx, self.cy = float(fx), float(fy), float(cx), float(cy)
        self.bf = float(bf)
        self.max_x_diff = self.bf / self.depth_lower_thr
        self.min_x_diff = self.bf / self.depth_upper_thr

        # IMU noise scaled by sqrt(rate), camera.cc:89-103
        self.use_imu = bool(int(node.get("use_imu", 0)))
        self.g_value = 9.81
        self.imu_frequency = 0.0
        self.gyr_noise = self.acc_noise = self.gyr_walk = self.acc_walk = 0.0
        if self.use_imu:
            self.imu_frequency = float(node["rate_hz"])
            sq = float(np.sqrt(self.imu_frequency))
            self.gyr_noise = float(node["gyroscope_noise_density"]) * sq
            self.acc_noise = float(node["accelerometer_noise_density"]) * sq
            self.gyr_walk = float(node["gyroscope_random_walk"]) / sq
            self.acc_walk = float(node["accelerometer_random_walk"]) / sq
            self.g_value = float(node["g_value"])

    def intrinsics(self) -> Intrinsics:
        return Intrinsics(fx=self.fx, fy=self.fy, cx=self.cx, cy=self.cy, bf=self.bf,
                          width=self.image_width, height=self.image_height)

    def rectify_maps(self, device=None):
        """Remap grids as float32 tensors on ``device`` (``cuda`` unless
        named), or (None, None) when the input is already rectified."""
        if self.map_left is None:
            return None, None
        from airslam_tpu_torch import resolve_device

        dev = resolve_device(device)
        return (torch.as_tensor(self.map_left, device=dev),
                torch.as_tensor(self.map_right, device=dev))
