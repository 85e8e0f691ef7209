"""Host ms per traced frame inside ``pnp`` and ``pose_only``
(``pipelines/map_builder.py``: the PnP initial pose and the pose-only solve)."""


def read(r):
    if not r.frames or not (r.trace.range_count("pnp") + r.trace.range_count("pose_only")):
        return None
    return 1e3 * (r.trace.range_total_s("pnp") + r.trace.range_total_s("pose_only")) / len(r.frames)
