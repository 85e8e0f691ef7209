"""``loi_features``' share of its roofline (``csrc/bilerp.cu``): the bound
of each traced call from its operands (``_work.loi_work``, bytes-bound at
these shapes) summed, over the summed device time of the
``loi_features_kernel`` launches, in %."""

import importlib.util
import os


def _work():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_work.py")
    spec = importlib.util.spec_from_file_location("slambench_metrics_work", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read(r):
    calls = r.probes.calls["loi_features"] if r.probes is not None else []
    kernels = [k for k in r.trace.kernels("loi_features") if "backward" not in k[0]]
    device_ms = sum(e - s for _, s, e in kernels) * 1e-6
    if not calls or not kernels or len(calls) != len(kernels) or device_ms <= 0:
        return None
    w = _work()
    bound = sum(w.bound_ms(*w.loi_work(c))[0] for c in calls)
    return 100.0 * bound / device_ms
