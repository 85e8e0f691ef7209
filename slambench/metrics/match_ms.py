"""Host ms per traced frame inside ``stereo+temporal match``
(``pipelines/map_builder.py``: LightGlue over the stereo and temporal pairs
and the mutual match)."""


def read(r):
    if not r.frames or not r.trace.range_count("stereo+temporal match"):
        return None
    return 1e3 * r.trace.range_total_s("stereo+temporal match") / len(r.frames)
