"""ASL/EuRoC dataset loader.

Port of ``airslam_tpu/io/dataset.py`` (which replaces ``src/dataset.cc``):
scans ``cam0/data``/``cam1/data`` for image timestamps (filenames are
nanosecond stamps), reads ``imu0/data.csv`` (timestamp, gyr xyz, acc xyz)
when asked for the IMU, drops frames outside the IMU time range, and
pre-chunks the IMU rows spanning [previous frame, frame], with the first
sample past the frame (dataset.cc:8-64).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from airslam_tpu_torch.core.imu import ImuData


class Dataset:
    def __init__(self, dataroot: str, use_imu: bool = False):
        self.dataroot = dataroot
        self.use_imu = use_imu
        left_dir = os.path.join(dataroot, "cam0", "data")
        right_dir = os.path.join(dataroot, "cam1", "data")

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
        self.imu_batches: List[List[ImuData]] = []

        imu_rows: List[ImuData] = []
        if use_imu:
            imu_csv = os.path.join(dataroot, "imu0", "data.csv")
            if not os.path.exists(imu_csv):
                print(f"warning: {imu_csv} missing — continuing vision-only")
                self.use_imu = use_imu = False
            else:
                with open(imu_csv) as f:
                    for line in f:
                        line = line.strip()
                        if not line or line.startswith("#"):
                            continue
                        v = [float(x) for x in line.split(",")]  # ns, gyr xyz, acc xyz
                        imu_rows.append(
                            ImuData(v[0] * 1e-9, np.asarray(v[1:4]), np.asarray(v[4:7])))

        imu_idx = 0
        last_t = None
        for name in sorted(os.listdir(left_dir), key=stamp):
            try:
                t = float(os.path.splitext(name)[0]) * 1e-9
            except ValueError:
                continue
            rp = os.path.join(right_dir, name)
            if not os.path.exists(rp):
                continue
            batch: List[ImuData] = []
            if use_imu and imu_rows:
                # drop frames outside the IMU range (dataset.cc:24-33)
                if t < imu_rows[0].timestamp or t > imu_rows[-1].timestamp:
                    continue
                if last_t is not None:
                    # rows spanning [last_t, t], inclusive of boundary samples
                    start = imu_idx
                    while start > 0 and imu_rows[start].timestamp > last_t:
                        start -= 1
                    j = start
                    while j < len(imu_rows) and imu_rows[j].timestamp <= t:
                        batch.append(imu_rows[j])
                        j += 1
                    if j < len(imu_rows):
                        batch.append(imu_rows[j])  # first sample past t
                    imu_idx = max(j - 1, 0)
            self.imu_batches.append(batch)
            self.left_paths.append(os.path.join(left_dir, name))
            self.right_paths.append(rp)
            self.timestamps.append(t)
            last_t = t

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
