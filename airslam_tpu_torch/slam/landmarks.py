"""Mappoint / Mapline landmark types (host side, numpy).

Port of ``airslam_tpu/slam/landmarks.py`` (whole file), which replaces
``src/mappoint.cc``/``src/mapline.cc``. Same lifecycle: landmarks are
created UnTriangulated from track ids, become Good once triangulated, and Bad
when rejected; observers map keyframe id → feature index within that frame.
"""

from __future__ import annotations

import enum
from typing import Dict, Optional

import numpy as np


class LandmarkType(enum.Enum):
    UNTRIANGULATED = 0
    GOOD = 1
    BAD = 2


class Mappoint:
    def __init__(self, mpt_id: int, position: Optional[np.ndarray] = None,
                 descriptor: Optional[np.ndarray] = None):
        self.id = mpt_id
        self.type = LandmarkType.UNTRIANGULATED if position is None else LandmarkType.GOOD
        self.position = np.zeros(3) if position is None else np.asarray(position, float)
        self.descriptor = descriptor  # (256,) — not serialized (mappoint.h:56-64)
        self.observers: Dict[int, int] = {}  # frame_id -> kpt idx

    def add_observer(self, frame_id: int, idx: int):
        self.observers[frame_id] = idx

    def remove_observer(self, frame_id: int):
        self.observers.pop(frame_id, None)

    @property
    def is_valid(self) -> bool:
        return self.type == LandmarkType.GOOD

    def set_position(self, p: np.ndarray):
        self.position = np.asarray(p, float)
        if self.type == LandmarkType.UNTRIANGULATED:
            self.type = LandmarkType.GOOD

    def set_bad(self):
        self.type = LandmarkType.BAD


class Mapline:
    def __init__(self, mpl_id: int):
        self.id = mpl_id
        self.type = LandmarkType.UNTRIANGULATED
        self.line3d = np.array([1.0, 0, 0, 0, 1.0, 0])  # Plücker (w, d)
        self.endpoints = np.zeros(6)  # world endpoints
        self.endpoints_valid = False
        self.observers: Dict[int, int] = {}  # frame_id -> line idx
        # per-observer endpoint seed status (mapline.h:24-92): 1 = this
        # observation provided stereo endpoints, 0 = not
        self.endpoint_status: Dict[int, int] = {}
        self.to_update_endpoints = False

    def add_observer(self, frame_id: int, idx: int):
        self.observers[frame_id] = idx

    def remove_observer(self, frame_id: int):
        self.observers.pop(frame_id, None)
        self.endpoint_status.pop(frame_id, None)

    @property
    def is_valid(self) -> bool:
        return self.type == LandmarkType.GOOD

    def set_endpoints(self, endpoints: np.ndarray, update_line: bool = True):
        self.endpoints = np.asarray(endpoints, float)
        self.endpoints_valid = True
        if update_line:
            # lie.line_from_endpoints in numpy (ComputeLine3DFromEndpoints,
            # src/line_processor.cc:312-326): a 6-float result stays on the host
            p1, p2 = self.endpoints[:3], self.endpoints[3:]
            d = p2 - p1
            n = np.linalg.norm(d)
            if n >= 0.01:  # line_processor.cc:317
                d = d / n
                self.line3d = np.concatenate([np.cross(p1, d), d])
                self.type = LandmarkType.GOOD

    def set_line3d(self, line: np.ndarray):
        self.line3d = np.asarray(line, float)
        self.type = LandmarkType.GOOD
        self.to_update_endpoints = True

    def set_bad(self):
        self.type = LandmarkType.BAD
