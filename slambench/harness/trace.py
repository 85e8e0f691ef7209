"""What a traced window leaves for the per-layer readers.

The driver opens ``torch.profiler`` (host and CUDA activity) around the
traced part of its window and hands the raw events to :class:`Trace`,
which keeps three lists: the device's operations (kernels, copies, fills)
with their times, the named ranges the program and the harness open on the
host (``record_function``), and the host's launch calls. The raw kineto
events are read directly; the profiler's Python event tree is not built, so
a window of a few hundred thousand launches reduces in seconds.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

# the harness's own ranges: one around each frame or solve it times, one
# around the whole traced window
FRAME_RANGE = "slambench.frame"
SOLVE_RANGE = "slambench.solve"
WINDOW_RANGE = "slambench.window"
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx",
                "cudaLaunchCooperativeKernel")


class Trace:
    def __init__(self, events):
        self.device_ops: List[Tuple[str, int, int]] = []  # (name, start ns, end ns)
        self.ranges: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        self.launches: List[int] = []
        for e in events:
            dev = str(e.device_type())
            start = int(e.start_ns())
            end = start + int(e.duration_ns())
            name = e.name()
            if dev.endswith("CUDA"):
                if not e.is_user_annotation():  # a host range mirrored on the device's timeline
                    self.device_ops.append((name, start, end))
            elif e.is_user_annotation():
                self.ranges[name].append((start, end))
            elif name in LAUNCH_CALLS:
                self.launches.append(start)
        self.device_ops.sort(key=lambda t: t[1])
        self.launches.sort()
        win = self.ranges.get(WINDOW_RANGE)
        if win:
            self.t0, self.t1 = win[0][0], win[-1][1]
        else:
            stamps = [s for _, s, _ in self.device_ops] + [e for _, _, e in self.device_ops]
            self.t0, self.t1 = (min(stamps), max(stamps)) if stamps else (0, 1)

    # -- the device ---------------------------------------------------------

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device's operations inside the window."""
        out: List[Tuple[int, int]] = []
        for _, s, e in self.device_ops:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def kernels(self, match=None) -> List[Tuple[str, int, int]]:
        """Device operations whose name contains ``match`` (all when None)."""
        return [k for k in self.device_ops if match is None or match in k[0]]

    def device_ops_top(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = defaultdict(float)
        for name, s, e in self.device_ops:
            by[name] += (e - s) * 1e-9
        return [[k[:200], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_range(self, n: int = 10) -> List[list]:
        """Idle device time inside the window, by the innermost named range
        open on the host when each gap began ("host: no range" outside
        every range), the ``n`` largest totals."""
        segments = self._innermost_segments()
        starts = [s for s, _, _ in segments]
        by: Dict[str, float] = defaultdict(float)
        prev = self.t0
        for s, e in self.busy_intervals() + [(self.t1, self.t1)]:
            if s > prev:
                i = bisect.bisect_right(starts, prev) - 1
                label = segments[i][2] if i >= 0 and segments[i][1] > prev else "host: no range"
                by[label] += (s - prev) * 1e-9
            prev = max(prev, e)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def _innermost_segments(self):
        """The host's timeline cut into (start, end, innermost range name)."""
        marks = []
        for name, spans in self.ranges.items():
            if name == WINDOW_RANGE:
                continue
            for s, e in spans:
                marks.append((s, e, name))
        marks.sort(key=lambda m: (m[0], -m[1]))
        out, stack = [], []

        def emit(upto):
            if stack and upto > emit.at:
                out.append((emit.at, upto, stack[-1][2]))
            emit.at = max(emit.at, upto)

        emit.at = self.t0
        for s, e, name in marks:
            while stack and stack[-1][1] <= s:
                emit(stack[-1][1])
                stack.pop()
            emit(s)
            stack.append((s, e, name))
        while stack:
            emit(stack[-1][1])
            stack.pop()
        return out

    # -- the host ------------------------------------------------------------

    def range_total_s(self, name: str) -> float:
        return sum(e - s for s, e in self.ranges.get(name, ())) * 1e-9

    def range_count(self, name: str) -> int:
        return len(self.ranges.get(name, ()))

    def launches_inside(self, name: str) -> int:
        """Launch calls the host made inside the spans of range ``name``."""
        return sum(bisect.bisect_left(self.launches, e) - bisect.bisect_left(self.launches, s)
                   for s, e in self.ranges.get(name, ()))


def record(prof) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile``."""
    return Trace(prof.profiler.kineto_results.events())
