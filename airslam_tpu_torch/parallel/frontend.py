"""Frame-parallel frontend: a batch of frames split over every mesh device.

Port of ``airslam_tpu/parallel/frontend.py``. Offline mapping and the
refinement's re-detection are embarrassingly parallel over frames: the JAX
package shards the batch axis over every mesh device (dp × tp) and lets XLA
partition the detector. Here the padded batch is cut into one contiguous
shard per mesh device, each shard detected on its device by a replica of the
detector, and the shards gathered on the primary device, padding rows
dropped.

Usage::

    mesh = parallel.mesh.make_mesh()
    feats = sharded_detect(detector, frames, mesh)   # (B, H, W) -> features

``detect_junctions`` defaults to False, as in the JAX ``sharded_detect``:
the junction fields are zeros unless the caller asks for them.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from airslam_tpu_torch.parallel.mesh import same_device


def pad_batch(images, mesh):
    """Pad (B, H, W) with zero frames to a multiple of the mesh size; returns
    (padded, B). Keeps a tensor a tensor (on its device) and numpy numpy."""
    n = mesh.size
    b = images.shape[0]
    pad = (-b) % n
    if pad:
        if torch.is_tensor(images):
            zeros = images.new_zeros((pad,) + tuple(images.shape[1:]))
            images = torch.cat([images, zeros])
        else:
            images = np.concatenate(
                [images, np.zeros((pad,) + images.shape[1:], images.dtype)], axis=0)
    return images, b


def detector_replica(detector, mesh, device):
    """``detector`` where it already runs on ``device`` (every shard of a
    virtual mesh shares it: n copies of the networks on one card would cost
    memory for nothing); else a copy of its networks on ``device``, made once
    and cached on the mesh."""
    if same_device(getattr(detector, "device", device), device):
        return detector

    def make(dev):
        rep = copy.copy(detector)
        rep.device = dev
        for name in ("plnet", "loi", "superpoint"):
            net = getattr(detector, name, None)
            if net is not None:
                setattr(rep, name, copy.deepcopy(net).to(dev))
        return rep

    return mesh.replica(("detector", id(detector)), device, make)


def sharded_detect(detector, images, mesh, detect_junctions: bool = False):
    """``detector.detect`` with the frame batch split over every mesh device
    (dp × tp, dp-major as ``batch_all_devices``). Returns the batched
    ``FrameFeatures`` of the single-device path on the primary device, the
    padding frames removed. Each device's detection is queued before the
    next one's: nothing is read back until a caller reads the result (the
    detector's own host loops aside)."""
    arr, b = pad_batch(images, mesh)
    devs = mesh.all_devices()
    per = arr.shape[0] // len(devs)
    parts = []
    for i, dev in enumerate(devs):
        shard = torch.as_tensor(arr[i * per:(i + 1) * per], dtype=torch.float32).to(dev)
        parts.append(detector_replica(detector, mesh, dev).detect(
            shard, detect_junctions=detect_junctions))
    primary = mesh.primary
    return type(parts[0])(*(torch.cat([torch.as_tensor(p[k]).to(primary) for p in parts])[:b]
                            for k in range(len(parts[0]))))
