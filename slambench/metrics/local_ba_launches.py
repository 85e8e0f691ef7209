"""Kernel launches the host makes inside each ``local_ba`` range, as
``scripts/profile_torch_frontend.py --vo`` counts them."""


def read(r):
    if r.device.type != "cuda":  # a device metric, from the card only
        return None
    n = r.trace.range_count("local_ba")
    return r.trace.launches_inside("local_ba") / n if n else None
