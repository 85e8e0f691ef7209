"""Host ms per ``insert_keyframe`` span (``slam/map.py``: a keyframe's
landmarks, triangulation, covisibility and its local BA, problem build to
write-back); the spans' number is the window's keyframe count."""


def read(r):
    n = r.trace.range_count("insert_keyframe")
    return 1e3 * r.trace.range_total_s("insert_keyframe") / n if n else None
