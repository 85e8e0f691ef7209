"""The stereo rig of a configuration: its rectification, computed from the
configuration's camera block alone.

Mirrors what a radtan camera's YAML gives the program (``cv2.stereoRectify``
with ``CALIB_ZERO_DISPARITY`` and ``alpha=0``, the reference's
camera.cc:161-182), so that the traffic generator and the plain reference
need nothing of the program to know the rectified intrinsics and the
baseline.
"""

from __future__ import annotations

import numpy as np


def _node(cam):
    intr = [float(x) for x in cam["intrinsics"]]
    K = np.array([[intr[0], 0, intr[2]], [0, intr[1], intr[3]], [0, 0, 1]], np.float64)
    D = np.array([float(x) for x in cam["distortion_coeffs"]], np.float64)
    T = np.array(cam["T"], np.float64).reshape(4, 4)
    if int(cam.get("T_type", 0)):
        T = np.linalg.inv(T)
    return K, D, T


def rectification(camera: dict) -> dict:
    """K0, D0, K1, D1, R0, R1, P0, P1 and the rectified fx, fy, cx, cy, bf,
    width, height of a radtan stereo camera block (``distortion_type`` 1)."""
    import cv2

    if int(camera["distortion_type"]) != 1:
        raise ValueError("the benchmark's rigs are radtan (distortion_type 1)")
    K0, D0, T0 = _node(camera["cam0"])
    K1, D1, T1 = _node(camera["cam1"])
    T10 = np.linalg.inv(T1) @ T0
    size = (int(camera["image_width"]), int(camera["image_height"]))
    R0, R1, P0, P1, _, _, _ = cv2.stereoRectify(
        K0, D0, K1, D1, size, np.ascontiguousarray(T10[:3, :3]),
        np.ascontiguousarray(T10[:3, 3]).reshape(3, 1), flags=cv2.CALIB_ZERO_DISPARITY, alpha=0)
    return dict(K0=K0, D0=D0, K1=K1, D1=D1, R0=R0, R1=R1, P0=P0, P1=P1,
                fx=float(P0[0, 0]), fy=float(P0[1, 1]), cx=float(P0[0, 2]), cy=float(P0[1, 2]),
                bf=float(abs(P1[0, 3])), width=size[0], height=size[1])

