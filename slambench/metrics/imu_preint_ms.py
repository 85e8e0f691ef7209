"""Host ms per traced frame in the ``imu.preintegrate`` spans nested in the
harness's frame ranges (``pipelines/map_builder.py``: the frame's IMU rows
into the keyframe's preintegration, and the IMU prediction of its initial
pose)."""

import importlib.util
import os

from slambench.harness.trace import FRAME_RANGE


def _spans():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_spans.py")
    spec = importlib.util.spec_from_file_location("slambench_metrics_spans", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read(r):
    s = _spans()
    spans = s.nested(r.trace, "imu.preintegrate", FRAME_RANGE)
    return s.host_ms(spans) / len(r.frames) if spans and r.frames else None
