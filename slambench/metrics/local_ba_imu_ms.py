"""Host ms in the ``lm.imu`` spans nested in ``local_ba`` spans
(``backend/gn.py``: the IMU factors' blocks in each LM step's assembly and
their terms in its costs) per ``local_ba`` span."""

import importlib.util
import os


def _spans():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_spans.py")
    spec = importlib.util.spec_from_file_location("slambench_metrics_spans", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read(r):
    n = r.trace.range_count("local_ba")
    s = _spans()
    spans = s.nested(r.trace, "lm.imu", "local_ba") if n else []
    return s.host_ms(spans) / n if spans else None
