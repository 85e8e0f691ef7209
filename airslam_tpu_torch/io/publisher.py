"""Headless publisher — the observability surface.

The port's own copy of ``airslam_tpu/io/publisher.py`` (numpy and the standard
library only). Replaces ``src/ros_publisher.cc`` + ``include/thread_publisher.h``: the same
six message families (feature image, frame pose, keyframe array + path, point
cloud, line markers, reloc markers), each drained by its own queue thread and
fanned out to registered callbacks. Sinks are plain callables (log to file,
forward to rerun/foxglove, collect in tests) instead of ROS topics; topic
names/toggles come from the same YAML block (``ros_publisher``,
read_configs.h:166-199).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class FeatureMessage:
    time: float
    image: Optional[np.ndarray]
    keypoints: np.ndarray
    lines: np.ndarray


@dataclasses.dataclass
class FramePoseMessage:
    time: float
    pose: np.ndarray  # Twc


@dataclasses.dataclass
class KeyframeMessage:
    time: float
    ids: List[int]
    poses: List[np.ndarray]


@dataclasses.dataclass
class MapMessage:
    time: float
    points: np.ndarray  # (N, 3)


@dataclasses.dataclass
class MaplineMessage:
    time: float
    endpoints: np.ndarray  # (N, 6)


@dataclasses.dataclass
class RelocMessage:
    time: float
    poses: List[np.ndarray]
    mappoints: np.ndarray


class TopicPublisher:
    """Single-topic queue + drain thread (``ThreadPublisher<T>``,
    thread_publisher.h:13-112)."""

    def __init__(self, name: str):
        self.name = name
        self._queue: "queue.Queue" = queue.Queue()
        self._callbacks: List[Callable[[Any], None]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def register(self, cb: Callable[[Any], None]):
        self._callbacks.append(cb)

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    def publish(self, msg):
        if self._callbacks:
            self._queue.put(msg)

    def _run(self):
        while not self._stop.is_set():
            try:
                msg = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            for cb in self._callbacks:
                cb(msg)

    def stop(self):
        # drain remaining messages, then stop (ThreadPublisher shutdown)
        while not self._queue.empty():
            try:
                msg = self._queue.get_nowait()
            except queue.Empty:
                break
            for cb in self._callbacks:
                cb(msg)
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None


class Publisher:
    """Message fan-out for the pipelines (``RosPublisher``,
    ros_publisher.h:24-117)."""

    TOPICS = ["feature", "frame_pose", "keyframe", "path", "map", "mapline", "reloc"]

    def __init__(self, config=None):
        self.config = config
        self.topics: Dict[str, TopicPublisher] = {
            name: TopicPublisher(name) for name in self.TOPICS
        }

    def register(self, topic: str, cb):
        self.topics[topic].register(cb)
        self.topics[topic].start()

    def _enabled(self, topic: str) -> bool:
        if self.config is None:
            return True
        return bool(getattr(self.config, topic, True))

    def publish_feature(self, msg: FeatureMessage):
        if self._enabled("feature"):
            self.topics["feature"].publish(msg)

    def publish_frame_pose(self, msg: FramePoseMessage):
        if self._enabled("frame_pose"):
            self.topics["frame_pose"].publish(msg)

    def publish_keyframes(self, msg: KeyframeMessage):
        if self._enabled("keyframe"):
            self.topics["keyframe"].publish(msg)

    def publish_map(self, msg: MapMessage):
        if self._enabled("map"):
            self.topics["map"].publish(msg)

    def publish_maplines(self, msg: MaplineMessage):
        if self._enabled("mapline"):
            self.topics["mapline"].publish(msg)

    def publish_reloc(self, msg: RelocMessage):
        if self._enabled("reloc"):
            self.topics["reloc"].publish(msg)

    def shutdown(self):
        for t in self.topics.values():
            t.stop()
