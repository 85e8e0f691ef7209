"""Span arithmetic of the readers of the program's own spans
(``airslam_tpu_torch.utils.timing.span``): the spans of one name nested in
another's, their host time, the launch calls inside them, and the card's
time by the span that launched each kernel.

Only the public lists of the harness's ``Trace`` are read: ``ranges``,
``launches`` and ``device_ops``.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from slambench.harness.trace import WINDOW_RANGE

# the card's copies and fills: no launch call of the host's starts them
COPIES = ("Memcpy", "Memset")


def nested(trace, name: str, outer: str):
    """The spans of ``name`` that lie inside a span of ``outer``."""
    outs = sorted(trace.ranges.get(outer, ()))
    starts = [s for s, _ in outs]
    got = []
    for s, e in trace.ranges.get(name, ()):
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and e <= outs[i][1]:
            got.append((s, e))
    return got


def host_ms(spans) -> float:
    return sum(e - s for s, e in spans) * 1e-6


def launches_in(trace, spans) -> int:
    """Launch calls the host made inside ``spans``."""
    at = trace.launches
    return sum(bisect.bisect_left(at, e) - bisect.bisect_left(at, s) for s, e in spans)


def innermost(trace):
    """The host's timeline cut into (start, end, name) by the innermost span
    open in each piece (the harness's window range left out)."""
    marks = sorted(((s, e, name) for name, spans in trace.ranges.items()
                    if name != WINDOW_RANGE for s, e in spans),
                   key=lambda m: (m[0], -m[1]))
    out, stack = [], []
    at = None

    def close_to(t):
        nonlocal at
        if stack and t > at:
            out.append((at, t, stack[-1][2]))
        at = t if at is None else max(at, t)

    for s, e, name in marks:
        while stack and stack[-1][1] <= s:
            close_to(stack[-1][1])
            stack.pop()
        close_to(s)
        stack.append((s, e, name))
    while stack:
        close_to(stack[-1][1])
        stack.pop()
    return out


def device_ms_by_span(trace):
    """Device ms of the window's kernels by the innermost span open when the
    host launched each (None: launched outside every span). The n-th kernel
    is the n-th launch call's: one stream runs kernels in launch order. None
    where the kernels and the launch calls differ in number."""
    kernels = [k for k in trace.device_ops if not k[0].startswith(COPIES)]
    if not kernels or len(kernels) != len(trace.launches):
        return None
    segments = innermost(trace)
    starts = [s for s, _, _ in segments]
    by = defaultdict(float)
    for (_, s, e), t in zip(kernels, trace.launches):
        i = bisect.bisect_right(starts, t) - 1
        owner = segments[i][2] if i >= 0 and t < segments[i][1] else None
        by[owner] += (e - s) * 1e-6
    return dict(by)
