"""Launch calls the host makes inside the ``lm.assemble`` spans nested in
``local_ba`` spans, per ``local_ba`` span: the kernels of the window
backend's normal equations."""

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
    n = r.trace.range_count("local_ba")
    s = _spans()
    spans = s.nested(r.trace, "lm.assemble", "local_ba") if n else []
    return s.launches_in(r.trace, spans) / n if spans else None
