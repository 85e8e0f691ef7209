"""ASL/EuRoC dataset loader, vision only.

Port of ``airslam_tpu/io/dataset.py`` (which replaces ``src/dataset.cc``):
scans ``cam0/data``/``cam1/data`` for image timestamps (filenames are
nanosecond stamps) and reads the stereo pairs. Reading ``imu0/data.csv`` and
chunking its rows between frames belongs to the stereo-inertial slice.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np


class Dataset:
    def __init__(self, dataroot: str, use_imu: bool = False):
        self.dataroot = dataroot
        self.use_imu = use_imu
        left_dir = os.path.join(dataroot, "cam0", "data")
        right_dir = os.path.join(dataroot, "cam1", "data")

        if use_imu:
            imu_csv = os.path.join(dataroot, "imu0", "data.csv")
            if os.path.exists(imu_csv):
                raise NotImplementedError(
                    f"reading {imu_csv}: the IMU rows between frames belong to the "
                    "stereo-inertial slice (ROADMAP queue 3)")
            print(f"warning: {imu_csv} missing — continuing vision-only")
            self.use_imu = False

        # sort by numeric timestamp, not lexicographically — EuRoC stamps are
        # fixed-width so string order coincides, but variable-width stamps
        # (e.g. synthetic sequences) must not shuffle the frame order
        def stamp(name):
            try:
                return float(os.path.splitext(name)[0])
            except ValueError:
                return float("inf")

        self.left_paths: List[str] = []
        self.right_paths: List[str] = []
        self.timestamps: List[float] = []
        self.imu_batches: List[list] = []
        for name in sorted(os.listdir(left_dir), key=stamp):
            try:
                t = float(os.path.splitext(name)[0]) * 1e-9
            except ValueError:
                continue
            rp = os.path.join(right_dir, name)
            if not os.path.exists(rp):
                continue
            self.imu_batches.append([])
            self.left_paths.append(os.path.join(left_dir, name))
            self.right_paths.append(rp)
            self.timestamps.append(t)

    def __len__(self):
        return len(self.timestamps)

    def get(self, idx: int):
        """Returns (timestamp, left (H, W) float32 in [0, 1], right, imu_batch)."""
        import cv2

        left = cv2.imread(self.left_paths[idx], cv2.IMREAD_GRAYSCALE)
        right = cv2.imread(self.right_paths[idx], cv2.IMREAD_GRAYSCALE)
        return (
            self.timestamps[idx],
            left.astype(np.float32) / 255.0,
            right.astype(np.float32) / 255.0,
            self.imu_batches[idx],
        )
