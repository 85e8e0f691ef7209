"""Launch calls the host makes inside the ``pose_only.vi`` spans nested in
``pose_only`` spans per traced frame: the kernels of the F = 2 VI tracking
solve."""

import importlib.util
import os


def _spans():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_spans.py")
    spec = importlib.util.spec_from_file_location("slambench_metrics_spans", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read(r):
    if r.device.type != "cuda":  # a count of the card's launches, from the card only
        return None
    s = _spans()
    spans = s.nested(r.trace, "pose_only.vi", "pose_only")
    return s.launches_in(r.trace, spans) / len(r.frames) if spans and r.frames else None
