"""Device ms of the kernels launched inside ``lm.assemble`` spans
(``backend/global_ba.py``: residuals, Jacobians, the scattered blocks and
the Schur complement of each LM step) per ``lm.step`` span."""

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
    return by["lm.assemble"] / steps if by and "lm.assemble" in by else None
