"""Frozen copy of the analytic camera trajectory of the port's system
benchmark.

Copied from ``apps/benchmark_system_torch.py``'s ``traj_position``; the
benchmark never calls the program's version.
"""

from __future__ import annotations

import numpy as np


def traj_position(t, traj: str = "forward", total: float = None):
    """Position at time t (seconds). ``forward``: 2.4 m/s along z with a
    weave in x and y; ``loop``: out and back along z over ``total``
    seconds; ``wide``: the z loop twice while x sweeps ±1.5 m."""
    x = 0.3 * np.sin(1.6 * t)
    y = 0.08 * np.sin(2.6 * t)
    if traj == "forward":
        z = 2.4 * t
    elif traj == "wide":
        w = 2.0 * np.pi / total
        x = x + 1.5 * np.sin(w * t)
        z = 2.0 * (1.0 - np.cos(2.0 * w * t))
    else:
        z = 2.0 * (1.0 - np.cos(2.0 * np.pi * t / total))
    return np.stack(np.broadcast_arrays(x, y, z), axis=-1)
