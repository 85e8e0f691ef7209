"""Kernel P's share of its roofline: the bound of each traced call from its
shapes (``_work.pose_work``, ``_work.bound_ms``) summed, over the summed
device time of the ``pose_gn`` kernels (``csrc/pose_gn.cu``), in %."""

import importlib.util
import os


def _work():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_work.py")
    spec = importlib.util.spec_from_file_location("slambench_metrics_work", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read(r):
    calls = r.probes.calls["pose_gn"] if r.probes is not None else []
    kernels = r.trace.kernels("pose_gn")
    device_ms = sum(e - s for _, s, e in kernels) * 1e-6
    if not calls or not kernels or len(calls) != len(kernels) or device_ms <= 0:
        return None
    w = _work()
    bound = sum(w.bound_ms(*w.pose_work(c["points"], c["lines"], c["rounds"], c["iters"]))[0]
                for c in calls)
    return 100.0 * bound / device_ms
