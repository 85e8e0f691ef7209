"""Host ms per traced frame in the ``pose_only.vi`` spans nested in
``pose_only`` spans (``backend/windows.py``: the F = 2 VI tracking solve,
``_pose_only_fast_vi``)."""

import importlib.util
import os


def _spans():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_spans.py")
    spec = importlib.util.spec_from_file_location("slambench_metrics_spans", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read(r):
    s = _spans()
    spans = s.nested(r.trace, "pose_only.vi", "pose_only")
    return s.host_ms(spans) / len(r.frames) if spans and r.frames else None
