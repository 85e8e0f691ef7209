"""Device ms of the kernels launched inside ``lm.solve`` spans
(``backend/global_ba.py``: the damped, scaled reduced solve and the
landmarks' back-substitution of each LM step) per ``lm.step`` span."""

import importlib.util
import os


def _spans():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_spans.py")
    spec = importlib.util.spec_from_file_location("slambench_metrics_spans", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read(r):
    steps = r.trace.range_count("lm.step")
    by = _spans().device_ms_by_span(r.trace) if steps else None
    return by["lm.solve"] / steps if by and "lm.solve" in by else None
