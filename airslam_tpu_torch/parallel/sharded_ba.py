"""Multi-device bundle adjustment: the landmark axis sharded over the mesh.

Port of ``airslam_tpu/parallel/sharded_ba.py``. Every sum of the BA
assembly runs over landmarks: the per-frame Hessian blocks, the Schur
complement and its right side are sums of per-landmark terms. The JAX
package shards the landmark-major arrays over ``dp`` and lets XLA turn each
sum into per-device partials and a ``psum``. The port writes that out
(``backend/gn.py`` :func:`landmark_shards`, ``backend/global_ba.py``
:func:`observation_shards`): each dp device computes its landmarks' blocks,
cost terms, Schur terms and back-substitution; the partial sums meet on the
primary device in shard order, where the small reduced camera system is
solved once and the IMU factors, frame-only, are added once.

The four functions below are the JAX module's API under its names; the
port's own callers pass ``mesh=`` to ``windows.local_ba`` and
``global_ba.global_ba`` directly.
"""

from __future__ import annotations

from airslam_tpu_torch.backend import gn
from airslam_tpu_torch.backend import global_ba as gba
from airslam_tpu_torch.backend import windows


def shard_problem(problem: gn.BAProblem, mesh):
    """The window problem laid out for ``mesh``: (point shards, line
    shards), landmark slices on the dp devices with the frames and camera
    replicated; a landmark count that dp does not divide stays whole on the
    problem's device, as the JAX package replicates it."""
    return gn.landmark_shards(problem, mesh)


def sharded_global_ba(problem: gn.BAProblem, intr, cfg: gn.BAConfig, mesh,
                      iters1: int = 50, iters2: int = 40):
    """The two-stage window BA (``windows.local_ba``) with the landmarks
    sharded over ``mesh``. Returns (problem, point_inlier, line_inlier) on
    the problem's device."""
    return windows.local_ba(problem, intr, cfg, iters1=iters1, iters2=iters2, mesh=mesh)


def shard_sparse_problem(prob: gba.SparseBAProblem, mesh):
    """The map-scale problem laid out for ``mesh``: observations and
    landmarks over dp, each landmark with its observations on one device."""
    return gba.observation_shards(prob, mesh)


def sharded_sparse_global_ba(prob: gba.SparseBAProblem, intr, cfg: gn.BAConfig, mesh,
                             iters1: int = 50, iters2: int = 40, chunk: int = 2048):
    """``global_ba.global_ba`` with observations and landmarks sharded over
    ``mesh``."""
    return gba.global_ba(prob, intr, cfg, iters1=iters1, iters2=iters2, chunk=chunk, mesh=mesh)
