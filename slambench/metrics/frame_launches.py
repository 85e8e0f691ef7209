"""Kernels per traced frame (the card's copies and fills not counted)."""


def read(r):
    if not r.frames or not r.trace.device_ops:
        return None
    kernels = [k for k in r.trace.device_ops if not k[0].startswith(("Memcpy", "Memset"))]
    return len(kernels) / len(r.frames)
