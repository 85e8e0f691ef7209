"""Pipelined map building: detection of the next frames ∥ host tracking.

Port of ``airslam_tpu/parallel/pipeline.py`` and of the JAX map builder's
``PipelinedRunner``. The reference overlaps its feature thread with its
tracking thread on one GPU (map_builder.cc:33-49). Over a mesh the overlap
widens: the mesh detects a chunk of upcoming frames frame-parallel
(:func:`airslam_tpu_torch.parallel.frontend.sharded_detect`, one image per
device) while the host consumes the previous chunk in order: tracking, the
keyframe policy and map maintenance are serial. On one device the chunk is
one frame: the double-buffered single-device pipeline
(:class:`PipelinedRunner`).

Kernel launches are asynchronous, so no threads are needed: chunk t+1's
rectification and detection are queued before chunk t's features are pulled
to the host. Where the detector reads a value back inside (its decode's host
loops) the overlap shrinks; the results do not change: detection is
stateless per frame and the consumption order is the sequential loop's.
"""

from __future__ import annotations

import torch

from airslam_tpu_torch.parallel.frontend import sharded_detect
from airslam_tpu_torch.parallel.mesh import make_mesh
from airslam_tpu_torch.pipelines.map_builder import _as_np_features


class MeshPipelinedRunner:
    """Double-buffered chunked runner over a :class:`parallel.mesh.Mesh`.

    ``frames_per_chunk`` defaults to ``mesh.size // 2`` (a frame is a
    stereo pair, so a chunk gives every device one image); on a one-device
    mesh it is 1. Each frame is matched and tracked through the builder's
    ``_match_detected`` and ``track_features``, as the sequential loop's."""

    def __init__(self, builder, mesh, frames_per_chunk: int | None = None):
        self.builder = builder
        self.mesh = mesh
        self.chunk = max(1, int(frames_per_chunk or mesh.size // 2))

    def run(self, dataset, max_frames: int = 0, progress=None):
        b = self.builder
        n = len(dataset) if max_frames <= 0 else min(len(dataset), max_frames)
        pending = None
        done = 0
        for lo in range(0, n, self.chunk):
            metas, pairs = [], []
            for i in range(lo, min(lo + self.chunk, n)):
                ts, left_raw, right_raw, imu = dataset.get(i)
                pairs.append(b.rectify(left_raw, right_raw))  # (2, H, W)
                metas.append((ts, imu))
            # queued before the previous chunk is consumed
            feats_dev = sharded_detect(b.detector, torch.cat(pairs), self.mesh)
            if pending is not None:
                done += self._consume(pending, progress, done)
            pending = (metas, feats_dev)
        if pending is not None:
            done += self._consume(pending, progress, done)
        return n

    def _consume(self, item, progress, done):
        metas, feats_dev = item
        b = self.builder
        feats = _as_np_features(feats_dev)  # one host pull per chunk
        for j, (ts, imu) in enumerate(metas):
            f0, f1, pairs, temporal = b._match_detected(feats, j)
            b.track_features(ts, f0, f1, pairs, imu, temporal_matches=temporal)
            if progress is not None:
                progress(done + j)
        return len(metas)


class PipelinedRunner(MeshPipelinedRunner):
    """The one-device case: frame t+1's rectification and detection are
    queued on the builder's device before frame t's features are pulled, so
    the device detects while the host tracks. One frame of latency, the
    sequential loop's results."""

    def __init__(self, builder):
        super().__init__(builder, make_mesh(devices=[builder.device]))
