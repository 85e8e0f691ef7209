"""Map serialization — the checkpoint/resume subsystem.

Port of ``airslam_tpu/io/serialization.py``, same schema (version 1): the
reference checkpoints the full object graph via boost binary archives
(AirSLAM_mapv0.bin after VO, map_builder.cc:559-572); here the same logical
content is a pickle of plain dicts, numpy arrays and Python scalars with
explicit, versioned state dicts. No tensor and no class of either package
gets into the file, so a map written by this package loads in the JAX package
and the other way round. A keyframe's preintegration is saved as its raw
(dt, acc, gyr) rows, noise values, biases and times, and restored into the
loaded map's dtype and device.
"""

from __future__ import annotations

import pickle
from typing import Optional

import numpy as np

SCHEMA_VERSION = 1


def _frame_state(f) -> dict:
    d = dict(
        frame_id=f.frame_id, timestamp=f.timestamp, Twc=f.Twc,
        keypoints=f.keypoints, kp_scores=f.kp_scores, kp_desc=f.kp_desc,
        kp_mask=f.kp_mask, lines=f.lines, line_scores=f.line_scores,
        line_mask=f.line_mask, junctions=f.junctions, junc_scores=f.junc_scores,
        junc_desc=f.junc_desc, junc_mask=f.junc_mask,
        u_right=f.u_right, depth=f.depth, track_ids=f.track_ids,
        mappoint_ids=f.mappoint_ids, lines_right=f.lines_right,
        lines_right_valid=f.lines_right_valid, line_track_ids=f.line_track_ids,
        mapline_ids=f.mapline_ids, points_on_lines=f.points_on_lines,
        velocity=f.velocity, bg=f.bg, ba=f.ba,
        previous_frame_id=f.previous_frame.frame_id if f.previous_frame else -1,
        bow_vector=f.bow_vector, junction_bow_vector=f.junction_bow_vector,
    )
    if f.preintegration is not None:
        p = f.preintegration
        d["preintegration"] = dict(
            noise_diag=p.noise_diag, walk_diag=p.walk_diag, bg=p.bg, ba=p.ba,
            start_time=p.start_time, end_time=p.end_time,
            rows_dt=np.asarray(p._rows_dt),
            rows_acc=np.asarray(p._rows_acc).reshape(-1, 3),
            rows_gyr=np.asarray(p._rows_gyr).reshape(-1, 3),
        )
    return d


def _restore_frame(d: dict, camera, device, dtype):
    from airslam_tpu_torch.core.imu import Preintegration
    from airslam_tpu_torch.frontend.detector import FrameFeatures
    from airslam_tpu_torch.slam.frame import Frame

    feats = FrameFeatures(
        keypoints=d["keypoints"], kp_scores=d["kp_scores"], kp_desc=d["kp_desc"],
        kp_mask=d["kp_mask"], lines=d["lines"], line_scores=d["line_scores"],
        line_mask=d["line_mask"], junctions=d["junctions"],
        junc_scores=d["junc_scores"], junc_desc=d["junc_desc"], junc_mask=d["junc_mask"],
    )
    f = Frame(d["frame_id"], d["timestamp"], feats, camera)
    f.Twc = d["Twc"]
    f.u_right = d["u_right"]
    f.depth = d["depth"]
    f.track_ids = d["track_ids"]
    f.mappoint_ids = d["mappoint_ids"]
    f.lines_right = d["lines_right"]
    f.lines_right_valid = d["lines_right_valid"]
    f.line_track_ids = d["line_track_ids"]
    f.mapline_ids = d["mapline_ids"]
    f.points_on_lines = d["points_on_lines"]
    f.velocity = d["velocity"]
    f.bg = d["bg"]
    f.ba = d["ba"]
    f.bow_vector = d.get("bow_vector")
    f.junction_bow_vector = d.get("junction_bow_vector")
    if "preintegration" in d:
        p = d["preintegration"]
        pre = Preintegration(dtype=dtype, device=device)
        pre.noise_diag = p["noise_diag"]
        pre.walk_diag = p["walk_diag"]
        pre.bg = p["bg"]
        pre.ba = p["ba"]
        pre.start_time = p["start_time"]
        pre.end_time = p["end_time"]
        pre._rows_dt = list(p["rows_dt"])
        pre._rows_acc = list(p["rows_acc"])
        pre._rows_gyr = list(p["rows_gyr"])
        f.preintegration = pre
    return f, d["previous_frame_id"]


def save_map(m, path: str, databases: Optional[dict] = None):
    """m: slam.map.Map. ``databases``: optional {'point': Database,
    'junction': Database, 'point_voc_path': str, ...} saved into the archive
    (the v1 map embeds the point database — map_refiner.cc:1013-1028)."""
    state = dict(
        schema=SCHEMA_VERSION,
        camera=dict(
            fx=m.camera.fx, fy=m.camera.fy, cx=m.camera.cx, cy=m.camera.cy,
            bf=m.camera.bf, width=m.camera.image_width, height=m.camera.image_height,
            Tbc=getattr(m.camera, "Tbc", np.eye(4)),
            use_imu=getattr(m.camera, "use_imu", False),
            g_value=getattr(m.camera, "g_value", 9.81),
            depth_lower_thr=getattr(m.camera, "depth_lower_thr", 0.1),
            depth_upper_thr=getattr(m.camera, "depth_upper_thr", 10.0),
            max_y_diff=getattr(m.camera, "max_y_diff", 1.0),
        ),
        keyframe_ids=m.keyframe_ids,
        keyframes={fid: _frame_state(f) for fid, f in m.keyframes.items()},
        mappoints={
            mid: dict(id=p.id, type=p.type.value, position=p.position,
                      descriptor=p.descriptor, observers=p.observers)
            for mid, p in m.mappoints.items()
        },
        maplines={
            mid: dict(id=l.id, type=l.type.value, line3d=l.line3d,
                      endpoints=l.endpoints, endpoints_valid=l.endpoints_valid,
                      observers=l.observers, endpoint_status=l.endpoint_status)
            for mid, l in m.maplines.items()
        },
        covisibility=m.covisibility,
        imu_initialized=m.imu_initialized,
        Rwg=m.Rwg,
        databases={k: (v.state_dict() if hasattr(v, "state_dict") else v)
                   for k, v in (databases or {}).items()},
    )
    with open(path, "wb") as f:
        pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)


def load_map(path: str, camera=None, device=None, dtype=None):
    """Returns (Map, databases_state dict). If ``camera`` is None a minimal
    camera object is reconstructed from the archive. ``device``/``dtype``: the
    loaded map's (``Map``'s defaults when not given)."""
    from airslam_tpu_torch.slam.landmarks import LandmarkType, Mapline, Mappoint
    from airslam_tpu_torch.slam.map import Map

    with open(path, "rb") as f:
        state = pickle.load(f)
    assert state["schema"] <= SCHEMA_VERSION

    if camera is None:
        camera = _CameraStub(state["camera"])

    m = Map(camera, device=device, **({} if dtype is None else {"dtype": dtype}))
    m.keyframe_ids = state["keyframe_ids"]
    prev_ids = {}
    for fid, fs in state["keyframes"].items():
        fr, prev = _restore_frame(fs, camera, m.device, m.dtype)
        m.keyframes[fid] = fr
        prev_ids[fid] = prev
    for fid, prev in prev_ids.items():
        if prev >= 0 and prev in m.keyframes:
            m.keyframes[fid].previous_frame = m.keyframes[prev]

    for mid, p in state["mappoints"].items():
        mpt = Mappoint(p["id"], descriptor=p["descriptor"])
        mpt.position = p["position"]
        mpt.type = LandmarkType(p["type"])
        mpt.observers = p["observers"]
        m.mappoints[mid] = mpt
    for mid, l in state["maplines"].items():
        mpl = Mapline(l["id"])
        mpl.line3d = l["line3d"]
        mpl.endpoints = l["endpoints"]
        mpl.endpoints_valid = l["endpoints_valid"]
        mpl.type = LandmarkType(l["type"])
        mpl.observers = l["observers"]
        mpl.endpoint_status = l["endpoint_status"]
        m.maplines[mid] = mpl

    m.covisibility = state["covisibility"]
    m.imu_initialized = state["imu_initialized"]
    m.Rwg = state["Rwg"]
    return m, state.get("databases", {})


class _CameraStub:
    """Camera reconstructed from an archive (no distortion maps needed —
    features are already in rectified coordinates)."""

    def __init__(self, d: dict):
        self.fx, self.fy, self.cx, self.cy = d["fx"], d["fy"], d["cx"], d["cy"]
        self.bf = d["bf"]
        self.image_width, self.image_height = d["width"], d["height"]
        self.Tbc = d["Tbc"]
        self.Tcb = np.linalg.inv(d["Tbc"])
        self.use_imu = d["use_imu"]
        self.g_value = d["g_value"]
        self.depth_lower_thr = d["depth_lower_thr"]
        self.depth_upper_thr = d["depth_upper_thr"]
        self.max_y_diff = d["max_y_diff"]
        self.max_x_diff = self.bf / self.depth_lower_thr
        self.min_x_diff = self.bf / self.depth_upper_thr

    def intrinsics(self):
        from airslam_tpu_torch.core.camera import Intrinsics

        return Intrinsics(fx=float(self.fx), fy=float(self.fy), cx=float(self.cx),
                          cy=float(self.cy), bf=float(self.bf),
                          width=self.image_width, height=self.image_height)

    def rectify_maps(self, device=None):
        return None, None
