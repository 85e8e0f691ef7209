"""Map: keyframe/landmark registries.

Port of what the FIRST keyframe needs of ``airslam_tpu/slam/map.py`` (which
replaces ``src/map.cc``): ``Map.__init__`` (:63-85), the intrinsics,
``triangulate_stereo_lines_frame`` (:48-60), ``insert_keyframe`` (:90-163)
and the covisibility update. From the second keyframe on, insertion runs the
sliding-window local BA; that, the multi-view point triangulation and the
mapline fit from mappoints belong to the window backend and raise
``NotImplementedError`` here. The registries are host-side (numpy), as in the
JAX package; only the stereo line triangulation runs on the map's device.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from airslam_tpu_torch import resolve_device
from airslam_tpu_torch.backend import gn
from airslam_tpu_torch.slam.frame import Frame
from airslam_tpu_torch.slam.landmarks import LandmarkType, Mapline, Mappoint

_NEXT_SLICE = "belongs to the window backend and map slice (ROADMAP queue 2)"


def triangulate_stereo_lines_frame(frame, intr, min_x_diff, max_x_diff,
                                   device="cpu", dtype=torch.float32):
    """Every stereo line triangulation of a frame in ONE fixed-shape call
    (line_processor.cc:196-245 runs per line). Returns (endpoints_w (L, 6),
    ok (L,)) as tensors on ``device``."""
    from airslam_tpu_torch.frontend.lines import triangulate_stereo_lines

    def t(a):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    return triangulate_stereo_lines(
        t(frame.lines), t(frame.lines_right),
        torch.as_tensor(frame.lines_right_valid, device=device),
        t(frame.Twc[:3, :3]), t(frame.Twc[:3, 3]), intr, min_x_diff, max_x_diff)


class Map:
    """``device``: where the map's tensor work runs (``cuda`` unless the
    caller passes another); ``dtype``: its float type."""

    def __init__(self, camera, ba_config: Optional[gn.BAConfig] = None, device=None,
                 dtype=torch.float32):
        self.camera = camera
        self.device = resolve_device(device)
        self.dtype = dtype
        self.keyframes: Dict[int, Frame] = {}
        self.keyframe_ids: List[int] = []
        self.mappoints: Dict[int, Mappoint] = {}
        self.maplines: Dict[int, Mapline] = {}
        self.covisibility: Dict[int, Dict[int, int]] = {}
        self.ba_config = ba_config or gn.BAConfig()
        self.imu_initialized = False
        self.Rwg = np.eye(3)
        self._imu_init_frame: Optional[Frame] = None

        self.g_value = float(getattr(camera, "g_value", 9.81))
        self._intr = camera.intrinsics() if hasattr(camera, "intrinsics") else camera

    # ------------------------------------------------------------------
    # keyframe insertion (map.cc:30-120)
    # ------------------------------------------------------------------

    def insert_keyframe(self, frame: Frame):
        if self.keyframes:
            # checked before anything is registered, so the map stays as it was
            raise NotImplementedError(
                "inserting a second keyframe runs Map.local_map_optimization, which "
                + _NEXT_SLICE)
        fid = frame.frame_id
        self.keyframes[fid] = frame
        self.keyframe_ids.append(fid)

        Rwc = frame.Twc[:3, :3]
        twc = frame.Twc[:3, 3]

        # points — back-projections vectorized (map.cc:45-72 runs per point)
        idxs = np.nonzero(frame.kp_mask & (frame.track_ids >= 0))[0]
        depths = frame.depth[idxs]
        xn = (frame.keypoints[idxs, 0] - self.camera.cx) / self.camera.fx
        yn = (frame.keypoints[idxs, 1] - self.camera.cy) / self.camera.fy
        pts_c = np.stack([xn, yn, np.ones_like(xn)], axis=-1) * depths[:, None]
        pts_w = pts_c @ Rwc.T + twc
        need_triangulation = []
        for j, i in enumerate(idxs):
            tid = int(frame.track_ids[i])
            mpt = self.mappoints.get(tid)
            if mpt is None:
                mpt = Mappoint(tid, descriptor=frame.kp_desc[i].copy())
                if depths[j] > 0:
                    mpt.set_position(pts_w[j])
                self.mappoints[tid] = mpt
            frame.mappoint_ids[i] = tid
            mpt.add_observer(fid, int(i))
            if mpt.type == LandmarkType.UNTRIANGULATED and len(mpt.observers) > 2:
                need_triangulation.append(mpt)
        if need_triangulation:
            self.triangulate_mappoints_batch(need_triangulation)

        # lines — stereo triangulation for the WHOLE frame in one call
        line_ids = np.nonzero(frame.line_mask)[0]
        stereo_ends, stereo_ok = None, None
        if len(line_ids) and frame.lines_right_valid.any():
            ends_all, ok_all = triangulate_stereo_lines_frame(
                frame, self._intr, self.camera.min_x_diff, self.camera.max_x_diff,
                self.device, self.dtype)
            stereo_ends = ends_all.double().cpu().numpy()
            stereo_ok = ok_all.cpu().numpy()
        need_line_triangulation = []
        for i in line_ids:
            ltid = int(frame.line_track_ids[i])
            if ltid < 0:
                continue
            mpl = self.maplines.get(ltid)
            if mpl is None:
                mpl = Mapline(ltid)
                if stereo_ok is not None and stereo_ok[i]:
                    mpl.set_endpoints(stereo_ends[i])
                    mpl.endpoint_status[fid] = 1
                self.maplines[ltid] = mpl
            frame.mapline_ids[i] = ltid
            mpl.add_observer(fid, int(i))
            mpl.endpoint_status.setdefault(fid, 0)
            if mpl.type == LandmarkType.UNTRIANGULATED and len(mpl.observers) >= 2:
                need_line_triangulation.append(mpl)
        if need_line_triangulation:
            self.triangulate_maplines_by_mappoints_batch(need_line_triangulation)

        self._update_covisibility(frame)
        self._imu_init_frame = frame

    # ------------------------------------------------------------------
    # the next slice's entry points
    # ------------------------------------------------------------------

    def triangulate_mappoints_batch(self, mpts, max_obs: int = 8) -> int:
        raise NotImplementedError("multi-view mappoint triangulation " + _NEXT_SLICE)

    def triangulate_maplines_by_mappoints_batch(self, mpls, max_pts: int = 64) -> int:
        raise NotImplementedError("the mapline fit from mappoints " + _NEXT_SLICE)

    def local_map_optimization(self, frame: Frame):
        raise NotImplementedError("Map.local_map_optimization " + _NEXT_SLICE)

    # ------------------------------------------------------------------

    def _update_covisibility(self, frame: Frame):
        counts: Dict[int, int] = {}
        for tid in frame.mappoint_ids[frame.mappoint_ids >= 0]:
            mpt = self.mappoints.get(int(tid))
            if mpt is None:
                continue
            for ofid in mpt.observers:
                if ofid != frame.frame_id:
                    counts[ofid] = counts.get(ofid, 0) + 1
        self.covisibility[frame.frame_id] = counts
        for ofid, c in counts.items():
            self.covisibility.setdefault(ofid, {})[frame.frame_id] = c

    def covisible_frames(self, frame_id: int, min_shared: int = 1):
        return [fid for fid, c in self.covisibility.get(frame_id, {}).items()
                if c >= min_shared]
