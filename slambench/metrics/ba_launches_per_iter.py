"""Kernels of the traced solves (copies and fills not counted) over the LM
iterations they ran."""


def read(r):
    if not r.iterations or not r.trace.device_ops:
        return None
    kernels = [k for k in r.trace.device_ops if not k[0].startswith(("Memcpy", "Memset"))]
    return len(kernels) / r.iterations
