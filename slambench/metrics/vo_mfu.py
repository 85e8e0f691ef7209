"""The VO step's share of the card's f32 peak (67 TFLOP/s, TF32 off): the
model FLOPs of the window's frames after the traced ones (PLNet and
SuperPoint on both views, LightGlue over the stereo pair and the temporal
pair, at each frame's real keypoint count on both sides) over the host
seconds those frames took, timed with the profiler off, in %."""

import importlib.util
import os


def _work():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_work.py")
    spec = importlib.util.spec_from_file_location("slambench_metrics_work", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read(r):
    if r.device.type != "cuda":  # a device metric, from the card only
        return None
    if not r.after_frames or not r.after_seconds:
        return None
    w = _work()
    sp = bool(int(r.config["vo"]["plnet"]["use_superpoint"]))
    det = w.detector_flops(sp)
    flops = 0
    for f in r.after_frames:
        if f is None:
            continue
        n = int(f.kp_mask.sum())
        flops += det + 2 * w.lightglue_flops(n, n)
    return 100.0 * flops / r.after_seconds / w.F32_FLOPS
