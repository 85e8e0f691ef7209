"""Host ms per traced frame inside the detector's ranges (``resize+plnet``,
``superpoint``, ``decode+loi``, opened by ``frontend/detector.py``)."""

RANGES = ("resize+plnet", "superpoint", "decode+loi")


def read(r):
    if not r.frames or not any(r.trace.range_count(n) for n in RANGES):
        return None
    return 1e3 * sum(r.trace.range_total_s(n) for n in RANGES) / len(r.frames)
