"""Per-frame storage — the host-side data model (numpy).

Port of ``airslam_tpu/slam/frame.py`` (whole file), which replaces
``src/frame.cc`` / ``include/frame.h``. Differences from the reference driven
by the fixed-shape frontend:

- features arrive as fixed-shape masked arrays (FrameFeatures) instead of
  dynamic 259×N matrices; indices below the static budget K are stable ids;
- the stereo disparity/y-gate filter (frame.cc:139-199) and point-on-line
  assignment (frame.cc:125-135 via AssignPointsToLines) are vectorized ops
  whose results are stored here as numpy arrays;
- the 64×48 bucket grid for radius search (frame.h:24-25) is replaced by
  direct vectorized distance queries over ≤K keypoints (cheaper than grid
  bookkeeping at this scale).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class Frame:
    def __init__(self, frame_id: int, timestamp: float, features, camera=None):
        """features: FrameFeatures of numpy arrays or tensors (tensors are
        pulled to the host)."""

        def n(x):
            return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)

        self.frame_id = frame_id
        self.timestamp = timestamp
        self.camera = camera

        self.keypoints = n(features.keypoints)  # (K, 2)
        self.kp_scores = n(features.kp_scores)
        self.kp_desc = n(features.kp_desc)
        self.kp_mask = n(features.kp_mask)
        self.lines = n(features.lines)  # (L, 4)
        self.line_scores = n(features.line_scores)
        self.line_mask = n(features.line_mask)
        self.junctions = n(features.junctions)
        self.junc_scores = n(features.junc_scores)
        self.junc_desc = n(features.junc_desc)
        self.junc_mask = n(features.junc_mask)

        k = self.keypoints.shape[0]
        l = self.lines.shape[0]
        self.u_right = np.full(k, -1.0)
        self.depth = np.full(k, -1.0)
        self.track_ids = np.full(k, -1, np.int64)
        self.mappoint_ids = np.full(k, -1, np.int64)

        self.lines_right = np.zeros((l, 4))
        self.lines_right_valid = np.zeros(l, bool)
        self.line_track_ids = np.full(l, -1, np.int64)
        self.mapline_ids = np.full(l, -1, np.int64)
        self.points_on_lines = np.zeros((l, k), bool)  # relation matrix

        # pose: camera-in-world (the reference's Frame::GetPose convention)
        self.Twc = np.eye(4)
        self.velocity = np.zeros(3)
        self.bg = np.zeros(3)
        self.ba = np.zeros(3)
        self.preintegration: Optional["Preintegration"] = None  # core/imu.py
        self.previous_frame: Optional["Frame"] = None

        # BoW data filled by loopclosure
        self.bow_vector: Optional[Dict[int, float]] = None
        self.junction_bow_vector: Optional[Dict[int, float]] = None
        self.word_features: Optional[Dict[int, list]] = None

        # scratch markers used by window selection (reference:
        # local_map_optimization_frame_id etc.)
        self._lmo_frame_id = -1
        self._lmo_fix_frame_id = -1

    # -- pose ---------------------------------------------------------------

    def set_pose(self, Twc: np.ndarray):
        self.Twc = np.asarray(Twc).copy()

    def imu_pose(self, Tcb: np.ndarray) -> np.ndarray:
        """Twb = Twc · Tcb (frame.cc IMUPose equivalent)."""
        return self.Twc @ Tcb

    def set_imu_pose(self, Twb: np.ndarray, Tbc: np.ndarray):
        self.Twc = Twb @ Tbc

    # -- stereo -------------------------------------------------------------

    def add_right_features(self, feats_right, stereo_pairs, camera):
        """Apply the stereo gates and fill u_right/depth
        (frame.cc:139-199). ``stereo_pairs``: (M, 2) left/right keypoint
        index pairs from the matcher. Returns good stereo point count."""
        pairs = np.asarray(stereo_pairs, np.int64).reshape(-1, 2)
        if len(pairs) == 0:
            return 0
        kr = np.asarray(feats_right.keypoints)
        il = pairs[:, 0]
        ir = pairs[:, 1]
        dx = self.keypoints[il, 0] - kr[ir, 0]
        dy = np.abs(self.keypoints[il, 1] - kr[ir, 1])
        ok = (dx > camera.min_x_diff) & (dx < camera.max_x_diff) & (dy <= camera.max_y_diff)
        self.u_right[il[ok]] = kr[ir[ok], 0]
        self.depth[il[ok]] = camera.bf / dx[ok]
        return int(ok.sum())

    def keypoint_position(self, idx: int):
        """(u, v, u_right) with u_right = −1 for mono — the GetKeypointPosition
        contract used to build constraints."""
        u, v = self.keypoints[idx]
        return np.array([u, v, self.u_right[idx]])

    def back_project(self, idx: int, camera):
        """Camera-frame 3D point for a stereo keypoint (depth > 0)."""
        if self.depth[idx] <= 0:
            return None
        u, v = self.keypoints[idx]
        x = (u - camera.cx) / camera.fx
        y = (v - camera.cy) / camera.fy
        return np.array([x, y, 1.0]) * self.depth[idx]

    # -- queries ------------------------------------------------------------

    def valid_keypoint_count(self) -> int:
        return int(self.kp_mask.sum())

    def valid_line_count(self) -> int:
        return int(self.line_mask.sum())
