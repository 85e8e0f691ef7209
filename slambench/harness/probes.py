"""What a traced run records besides the profiler: the operands' shapes of
the hand-written kernels whose roofline the benchmark reads.

The kernels are launched through ``ctypes``, so the profiler sees their
names and times but not their operands. While a traced window is open,
:class:`Probes` wraps the two entry points the path calls,
``airslam_tpu_torch.backend.pose_gn.pose_only_fast`` (kernel P) and the
``loi_features`` that ``airslam_tpu_torch.models.plnet`` calls (the stage-1
head's sampling), and keeps each call's sizes and small operands. An entry
point that is no longer there is not wrapped, and the reader of its
roofline then finds nothing.
"""

from __future__ import annotations

import importlib
from typing import NamedTuple


class Probes:
    TARGETS = (("airslam_tpu_torch.backend.pose_gn", "pose_only_fast", "pose_gn"),
               ("airslam_tpu_torch.models.plnet", "loi_features", "loi_features"))

    def __init__(self):
        self.calls = {"pose_gn": [], "loi_features": []}
        self._saved = []
        for mod_name, attr, key in self.TARGETS:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr, None)
            if fn is None:
                continue
            wrapper = self._wrap(fn, key)
            # the program counts its launches on the function its module
            # names: the wrapper carries the count while it is in place
            wrapper.launches = start = getattr(fn, "launches", 0)
            self._saved.append((mod, attr, fn, wrapper, start))
            setattr(mod, attr, wrapper)

    def _wrap(self, fn, key):
        calls = self.calls[key]

        def pose_gn(problem, intr, cfg=None, rounds: int = 3, iters: int = 10, **kw):
            calls.append({"points": int(problem.points.shape[0]),
                          "lines": int(problem.lines.shape[0]), "rounds": rounds, "iters": iters})
            args = (problem, intr) if cfg is None else (problem, intr, cfg)
            return fn(*args, rounds=rounds, iters=iters, **kw)

        def loi_features(loi, loi_thin, loi_aux, junc_xy, pair_idx, lines, prop_lines, t_fwd,
                         t_rev, out_dtype=None):
            out = fn(loi, loi_thin, loi_aux, junc_xy, pair_idx, lines, prop_lines, t_fwd, t_rev,
                     out_dtype=out_dtype)
            calls.append({"map_shape": tuple(loi.shape), "map_size": loi.element_size(),
                          "small": [t.detach().clone() for t in (junc_xy, pair_idx, lines,
                                                                 prop_lines, t_fwd, t_rev)],
                          "out_bytes": out.numel() * out.element_size()})
            return out

        return pose_gn if key == "pose_gn" else loi_features

    def remove(self):
        for mod, attr, fn, wrapper, start in self._saved:
            setattr(mod, attr, fn)
            if hasattr(fn, "launches"):
                fn.launches += wrapper.launches - start
        self._saved = []


def _copy(x):
    """``x`` with every tensor in it copied (tuples and named tuples walked)."""
    if hasattr(x, "detach"):
        return x.detach().clone()
    if isinstance(x, tuple):
        items = [_copy(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


class KeptCalls:
    """Every call of ``module.attr`` made while the wrapper is in place:
    ``calls`` holds (positional arguments, keyword arguments, result) of
    each, every tensor copied. The wrapper calls through the module's
    attribute as it finds it, so a fault planted there is kept too."""

    def __init__(self, module: str, attr: str):
        self.calls = []
        self._mod = importlib.import_module(module)
        self._attr, self._fn = attr, getattr(self._mod, attr)
        fn = self._fn

        def wrapper(*args, **kw):
            out = fn(*args, **kw)
            self.calls.append((_copy(args), dict(kw), _copy(out)))
            return out

        setattr(self._mod, attr, wrapper)

    def remove(self):
        setattr(self._mod, self._attr, self._fn)


def start_profiler():
    """An entered ``torch.profiler.profile`` over the host and the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


class Reading(NamedTuple):
    """What the per-layer readers read: the trace, the traced frames or
    solves, the probes' records, the traced window's host seconds, the
    configuration and the device; for a VO run also the frames of the window
    after the traced ones, timed untraced, and their host seconds."""

    trace: object
    frames: list
    probes: Probes
    seconds: float
    config: dict
    device: object
    iterations: int = 0
    after_frames: list = []
    after_seconds: float = 0.0
