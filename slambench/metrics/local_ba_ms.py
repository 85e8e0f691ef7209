"""Host ms per ``local_ba`` range (``slam/map.py``: one local BA of the
window backend, problem build to write-back)."""


def read(r):
    n = r.trace.range_count("local_ba")
    return 1e3 * r.trace.range_total_s("local_ba") / n if n else None
