"""Summed device time of the traced solves over the LM iterations they ran
(``backend/global_ba.py``: both passes and the χ² gates), ms."""


def read(r):
    if not r.iterations or not r.trace.device_ops:
        return None
    return sum(e - s for _, s, e in r.trace.device_ops) * 1e-6 / r.iterations
