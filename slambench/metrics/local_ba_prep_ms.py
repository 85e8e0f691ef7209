"""Host ms in the ``local_map.build`` and ``local_map.write_back`` spans
(``slam/map.py``: the window's landmarks gathered and its problem built, the
result written back to the map) per ``local_ba`` span."""

PREP = ("local_map.build", "local_map.write_back")


def read(r):
    n = r.trace.range_count("local_ba")
    if not n or not any(r.trace.range_count(name) for name in PREP):
        return None
    return 1e3 * sum(r.trace.range_total_s(name) for name in PREP) / n
