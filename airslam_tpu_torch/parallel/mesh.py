"""Device mesh of the port: a (dp, tp) grid of torch devices driven by one
process.

Port of ``airslam_tpu/parallel/mesh.py``. The JAX package is single-process
SPMD: arrays are placed on a ``jax.sharding.Mesh`` and XLA partitions the
work and inserts the ``psum``s. The port keeps that contract in one process,
with the partitioning written out:

- a :class:`Mesh` holds a (dp, tp) array of ``torch.device``;
- each sharded function splits its batch or landmark axis into per-device
  shards and runs each shard's work on that shard's device;
- partial sums are reduced on the primary device (``devices[0, 0]``) in a
  fixed shard order (:func:`reduce_sum`), so two runs give the same bits; no
  shard adds into another's memory.

A device may repeat. A mesh of 8 × ``cpu`` is the counterpart of the 8
virtual CPU devices that the JAX tests force; n × ``cuda:0`` exercises the
sharding on one card. Such a virtual mesh is made only by passing the device
list (``make_mesh(devices=[dev] * n)``); :func:`make_mesh` over real devices
raises when fewer exist than asked for.
"""

from __future__ import annotations

import copy
from typing import List, Sequence

import numpy as np
import torch


class Mesh:
    """A (dp, tp) array of devices. ``shape`` is ``{"dp": .., "tp": ..}``
    as the JAX mesh's; ``size`` the number of entries."""

    def __init__(self, devices):
        arr = np.empty(np.shape(devices)[:2], dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(devices[idx[0]][idx[1]])
        self.devices = arr
        self._replicas = {}

    @property
    def shape(self) -> dict:
        return {"dp": self.devices.shape[0], "tp": self.devices.shape[1]}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def primary(self) -> torch.device:
        return self.devices[0, 0]

    def dp_devices(self) -> List[torch.device]:
        """One device per dp row (its tp = 0 entry): where landmark and batch
        shards run."""
        return list(self.devices[:, 0])

    def all_devices(self) -> List[torch.device]:
        """Every entry, dp-major: the order of JAX's ``P(("dp", "tp"))``."""
        return list(self.devices.reshape(-1))

    def replica(self, key, device: torch.device, make):
        """``make(device)``, made once per (``key``, device) and cached on the
        mesh: the per-device copies of a model."""
        slot = (key, str(device))
        if slot not in self._replicas:
            self._replicas[slot] = make(device)
        return self._replicas[slot]

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.all_devices()]})"


def make_mesh(n_devices: int | None = None, tp: int | None = None,
              devices: Sequence | None = None) -> Mesh:
    """(dp, tp) mesh. Without ``devices``: the first ``n_devices`` CUDA cards
    (all of them by default); raises when fewer exist. With ``devices``: that
    list as given (it may repeat a device: a virtual mesh). ``tp`` defaults to
    2 when the device count is even and > 1, else 1."""
    if devices is None:
        avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = avail if n_devices is None else int(n_devices)
        if n < 1 or n > avail:
            raise RuntimeError(f"a mesh of {n_devices if n_devices is not None else 'every'} "
                               f"CUDA device(s) was asked for and {avail} exist; pass "
                               "devices=[...] for a virtual mesh")
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        devs = [torch.device(d) for d in devices]
        if n_devices is not None and int(n_devices) != len(devs):
            raise ValueError(f"n_devices={n_devices} but {len(devs)} devices were given")
    n = len(devs)
    if tp is None:
        tp = 2 if (n % 2 == 0 and n > 1) else 1
    if n % tp:
        raise ValueError(f"tp={tp} does not divide {n} devices")
    return Mesh([devs[i * tp:(i + 1) * tp] for i in range(n // tp)])


def split_sizes(n: int, k: int) -> List[int]:
    """Sizes of ``k`` contiguous shards of ``n`` rows, as even as possible
    (the first ``n % k`` one larger)."""
    return [n // k + (1 if i < n % k else 0) for i in range(k)]


def even_bounds(n: int, k: int):
    """(lo, hi) row ranges of ``k`` equal shards when ``k`` divides ``n``
    (and ``n >= k``), else one range holding every row: the JAX package
    replicates an axis that the mesh does not divide
    (``parallel/sharded_ba.py:36-38``), which here means the whole family is
    computed once, on the primary device."""
    if n >= k and n % k == 0:
        s = n // k
        return [(i * s, (i + 1) * s) for i in range(k)]
    return [(0, n)]


def batch_sharding(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
    """Axis 0 of ``x`` split over dp, shard i on dp row i's device."""
    devs = mesh.dp_devices()
    parts = torch.split(x, split_sizes(x.shape[0], len(devs)))
    return [p.to(d) for p, d in zip(parts, devs)]


def same_device(a, b) -> bool:
    """Whether two device names are one mesh entry's device: ``cuda`` is the
    current card, ``cpu`` is ``cpu:0``. ``cpu:1`` is another entry although
    its tensors live in the same memory, so a mesh over ``cpu`` and
    ``cpu:1`` runs the copies that cards would get (the CPU tests use it)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    default = torch.cuda.current_device() if a.type == "cuda" else 0
    return (default if a.index is None else a.index) == (default if b.index is None else b.index)


def reduce_sum(parts, device: torch.device):
    """Σ of ``parts`` on ``device`` in list order. One part comes back as it
    is (no copy when it is already there), so a one-shard reduction adds
    nothing to the arithmetic."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def shard_lightglue_params(model, mesh: Mesh):
    """Tensor-parallel layout for LightGlue (JAX ``shard_lightglue_params``):
    each self- and cross-block's q/k/v projections are split by heads over
    the ``tp`` axis, column-wise as the JAX spec ``P(None, "tp")`` splits the
    kernels' output features, and the output projection's partial sums of
    each head group are added on the primary device. The parameters stay
    where they are: every tp device reads its rows through a differentiable
        copy, so one optimizer step updates them. A block computes on the tp row
    whose first device holds its input (a dp shard's row). Returns
    ``model``."""
    tp = mesh.shape["tp"]
    rows = [list(row) for row in mesh.devices] if tp > 1 else None
    for blk in list(model.self_blocks) + list(model.cross_blocks):
        if blk.heads % tp:
            raise ValueError(f"tp={tp} does not divide {blk.heads} heads")
        blk.tp_rows = rows
    return model


# ---------------------------------------------------------------------------
# data parallelism over dp: per-shard gradients through per-device replicas
# ---------------------------------------------------------------------------


def shard_batch(mesh: Mesh, tree, batch: int) -> list:
    """A tree of dicts, tuples and tensors (each tensor's axis 0 is the
    batch) split over dp, leaf by leaf (:func:`batch_sharding`): one tree
    per dp device."""
    k = len(mesh.dp_devices())
    if tree is None:
        return [None] * k
    if isinstance(tree, dict):
        parts = {key: shard_batch(mesh, v, batch) for key, v in tree.items()}
        return [{key: p[i] for key, p in parts.items()} for i in range(k)]
    if isinstance(tree, tuple):
        parts = [shard_batch(mesh, v, batch) for v in tree]
        make = (lambda xs: type(tree)(*xs)) if hasattr(tree, "_fields") else tuple
        return [make([p[i] for p in parts]) for i in range(k)]
    if tree.shape[0] != batch:
        raise ValueError(f"a leaf of shape {tuple(tree.shape)} has no batch axis of {batch}")
    return batch_sharding(mesh, tree)


def trainable(modules) -> list:
    """The parameters that take gradients, module by module."""
    return [p for m in modules for p in m.parameters() if p.requires_grad]


def module_replicas(mesh: Mesh, modules, device):
    """The modules on ``device``: themselves where they already are (a
    virtual mesh's shards share them), else copies made once and cached on
    the mesh."""
    home = next(modules[0].parameters()).device
    if same_device(device, home):
        return modules
    return tuple(mesh.replica(("module", id(m)), device, lambda d, m=m: copy.deepcopy(m).to(d))
                 for m in modules)


def dp_gradients(mesh: Mesh, modules, params, inputs, batch: int, loss_fn):
    """The gradient of a global batch mean, data-parallel over dp: ``inputs``
    (a tree whose tensors lead with the batch) split into one contiguous
    shard per dp device; ``loss_fn(replicas, shard) -> (loss (n,), terms
    {name: (n,)})`` per example on the shard's device through its replica of
    ``modules``; each shard's loss taken as its examples' sum over the global
    batch (numerators and denominators summed apart, as XLA's SPMD computes
    a global mean), its gradients by autograd on its device and summed on
    the primary in shard order. ``params``: the modules' trainable
    parameters (the optimizer's, in that order). Returns (loss, terms,
    grads), grads None where no gradient flowed."""
    primary = params[0].device
    devs = mesh.dp_devices()
    grads = [None] * len(params)
    loss, terms = None, {}

    def acc(a, b):
        return b if a is None else a + b

    shards = shard_batch(mesh, inputs, batch)
    for dev, n, part in zip(devs, split_sizes(batch, len(devs)), shards):
        if n == 0:
            continue
        reps = module_replicas(mesh, modules, dev)
        rep_params = trainable(reps)
        if len(rep_params) != len(params):
            raise ValueError("the modules' trainable parameters are not the optimizer's")
        total, t = loss_fn(reps, part)
        shard = total.sum() / batch
        for i, g in enumerate(torch.autograd.grad(shard, rep_params, allow_unused=True)):
            if g is not None:
                grads[i] = acc(grads[i], g.to(primary))
        loss = acc(loss, shard.detach().to(primary))
        for k, v in t.items():
            terms[k] = acc(terms.get(k), (v.detach().sum() / batch).to(primary))
    return loss, terms, grads


@torch.no_grad()
def refresh_replicas(mesh: Mesh, modules, params):
    """Copy the updated ``params`` into every other device's replica."""
    for dev in mesh.dp_devices():
        reps = module_replicas(mesh, modules, dev)
        if reps is not modules:
            for rp, p in zip(trainable(reps), params):
                rp.copy_(p)
