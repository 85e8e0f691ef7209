"""YAML configuration parsing — identical schema to the reference
(``include/read_configs.h``): the VO/map-refinement/relocalization YAMLs in
``configs/`` of the reference load unchanged.

Port of ``airslam_tpu/io/config.py`` (whole file; pure parsing into the port's
own config classes).

Top-level configs mirror ``VisualOdometryConfigs`` (read_configs.h:202-240),
``MapRefinementConfigs`` (:243-263), ``RelocalizationConfigs`` (:266-305).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import yaml

from airslam_tpu_torch.backend.gn import BAConfig
from airslam_tpu_torch.frontend.detector import DetectorConfig
from airslam_tpu_torch.frontend.matcher import MatcherConfig
from airslam_tpu_torch.pipelines.map_builder import KeyframeConfig

# Sinkhorn depth the shipped SuperGlue checkpoint was trained through
# (models/superglue.py of the JAX package)
SG_SINKHORN_ITERS = 20


@dataclasses.dataclass
class PublisherConfig:
    """ros_publisher block (read_configs.h:166-199) — topic toggles/names."""

    feature: bool = False
    feature_topic: str = ""
    frame_pose: bool = False
    frame_pose_topic: str = ""
    frame_odometry_topic: str = ""
    keyframe: bool = False
    keyframe_topic: str = ""
    path_topic: str = ""
    map: bool = False
    map_topic: str = ""
    mapline: bool = False
    mapline_topic: str = ""
    reloc: bool = False
    reloc_topic: str = ""


def _load_yaml(path: str) -> dict:
    with open(path) as f:
        text = f.read()
    lines = [l for l in text.splitlines() if not l.startswith("%YAML")]
    return yaml.safe_load("\n".join(lines))


def parse_detector_config(node: dict) -> DetectorConfig:
    p = node.get("plnet", {})
    return DetectorConfig(
        max_keypoints=int(p.get("max_keypoints", 400)),
        keypoint_threshold=float(p.get("keypoint_threshold", 0.004)),
        remove_borders=int(p.get("remove_borders", 4)),
        line_threshold=float(p.get("line_threshold", 0.75)),
        line_length_threshold=float(p.get("line_length_threshold", 50)),
        use_superpoint=bool(int(p.get("use_superpoint", 0))),
    )


def parse_matcher_config(node: dict) -> MatcherConfig:
    m = node.get("point_matcher", {})
    matcher = int(m.get("matcher", 0))
    # matcher: 1 defaults to the shipped checkpoint's Sinkhorn depth (the
    # reference ships OT disabled, but our trained superglue.npz is trained
    # through it); YAML key sinkhorn_iterations overrides.
    default_sk = 0 if matcher == 0 else SG_SINKHORN_ITERS
    return MatcherConfig(
        matcher=matcher,
        image_width=int(m.get("image_width", 752)),
        image_height=int(m.get("image_height", 480)),
        sinkhorn_iterations=int(m.get("sinkhorn_iterations", default_sk)),
    )


def parse_keyframe_config(node: dict) -> KeyframeConfig:
    k = node.get("keyframe", {})
    return KeyframeConfig(
        min_init_stereo_feature=int(k.get("min_init_stereo_feature", 90)),
        lost_num_match=int(k.get("lost_num_match", 10)),
        min_num_match=int(k.get("min_num_match", 30)),
        max_num_match=int(k.get("max_num_match", 80)),
        tracking_point_rate=float(k.get("tracking_point_rate", 0.65)),
        tracking_parallax_rate=float(k.get("tracking_parallax_rate", 0.1)),
    )


def parse_ba_config(node: dict, which: str = "backend") -> BAConfig:
    """Handles all three schemas: vo (nested optimization.tracking/backend),
    map_refinement (flat ``optimization``), relocalization (``pose_estimation``)."""
    o = node.get("optimization", node.get("pose_estimation", {}))
    if which in o:
        o = o[which]
    return BAConfig(
        mono_point=float(o.get("mono_point", 50)),
        stereo_point=float(o.get("stereo_point", 75)),
        mono_line=float(o.get("mono_line", 50)),
        stereo_line=float(o.get("stereo_line", 75)),
        line_sigma=float(o.get("rate", 0.5)),
    )


def parse_publisher_config(node: dict) -> PublisherConfig:
    r = node.get("ros_publisher", {})
    return PublisherConfig(
        feature=bool(int(r.get("feature", 0))),
        feature_topic=r.get("feature_topic", ""),
        frame_pose=bool(int(r.get("frame_pose", 0))),
        frame_pose_topic=r.get("frame_pose_topic", ""),
        frame_odometry_topic=r.get("frame_odometry_topic", ""),
        keyframe=bool(int(r.get("keyframe", 0))),
        keyframe_topic=r.get("keyframe_topic", ""),
        path_topic=r.get("path_topic", ""),
        map=bool(int(r.get("map", 0))),
        map_topic=r.get("map_topic", ""),
        mapline=bool(int(r.get("mapline", 0))),
        mapline_topic=r.get("mapline_topic", ""),
        reloc=bool(int(r.get("reloc", 0))),
        reloc_topic=r.get("reloc_topic", ""),
    )


def parse_early_exit(node: dict, which: str = "backend") -> float:
    """Optional opt-in early-exit LM tolerance (``optimization.early_exit``
    or ``optimization.<which>.early_exit``); 0.0 (absent in all reference
    YAMLs) keeps the exact g2o iteration schedule."""
    o = node.get("optimization", node.get("pose_estimation", {}))
    if which in o:
        o = o[which]
    return float(o.get("early_exit", 0.0))


@dataclasses.dataclass
class VisualOdometryConfigs:
    detector: DetectorConfig
    matcher: MatcherConfig
    keyframe: KeyframeConfig
    tracking_optimization: BAConfig
    backend_optimization: BAConfig
    publisher: PublisherConfig
    camera_file: Optional[str] = None
    dataroot: Optional[str] = None
    saving_dir: Optional[str] = None
    model_dir: Optional[str] = None
    early_exit: float = 0.0

    @classmethod
    def load(cls, path: str, **overrides):
        node = _load_yaml(path)
        return cls(
            detector=parse_detector_config(node),
            matcher=parse_matcher_config(node),
            keyframe=parse_keyframe_config(node),
            tracking_optimization=parse_ba_config(node, "tracking"),
            backend_optimization=parse_ba_config(node, "backend"),
            publisher=parse_publisher_config(node),
            early_exit=parse_early_exit(node, "backend"),
            **overrides,
        )


@dataclasses.dataclass
class MapRefinementConfigs:
    detector: DetectorConfig
    matcher: MatcherConfig
    backend_optimization: BAConfig
    publisher: PublisherConfig
    camera_file: Optional[str] = None
    map_root: Optional[str] = None
    model_dir: Optional[str] = None
    # The reference hardcodes the pose-graph branch gate at 80k mappoints
    # (map_refiner.cc:464) — implicitly sized to its EuRoC-scale maps. An
    # optional YAML key (`pose_graph_min_mappoints`) makes the gate explicit
    # so smaller rigs/datasets can exercise the branch; absent = reference
    # value.
    pose_graph_min_mappoints: int = 80000

    @classmethod
    def load(cls, path: str, **overrides):
        node = _load_yaml(path)
        return cls(
            detector=parse_detector_config(node),
            matcher=parse_matcher_config(node),
            backend_optimization=parse_ba_config(node, "backend"),
            publisher=parse_publisher_config(node),
            pose_graph_min_mappoints=int(
                node.get("pose_graph_min_mappoints", 80000)),
            **overrides,
        )


@dataclasses.dataclass
class RelocalizationConfigs:
    detector: DetectorConfig
    matcher: MatcherConfig
    tracking_optimization: BAConfig
    publisher: PublisherConfig
    pose_refinement: bool = False
    min_inlier_num: int = 45
    camera_file: Optional[str] = None
    map_root: Optional[str] = None
    model_dir: Optional[str] = None

    @classmethod
    def load(cls, path: str, **overrides):
        node = _load_yaml(path)
        return cls(
            detector=parse_detector_config(node),
            matcher=parse_matcher_config(node),
            tracking_optimization=parse_ba_config(node, "tracking"),
            publisher=parse_publisher_config(node),
            pose_refinement=bool(int(node.get("pose_refinement", 0))),
            min_inlier_num=int(node.get("min_inlier_num", 45)),
            **overrides,
        )
