"""How far the data-parallel ``plnet`` step's gate separates a sound
reduction from a faulty one, on one NVIDIA GPU.

    python3 scripts/dp_step_faults.py

Runs ``chip_smoke.dp_plnet_step_gaps`` (two steps of the shipped
checkpoint, single-device against data-parallel over a virtual mesh of
phase mesh's ``MESH_RUN["dp"]``, at its batch or ``--batch``; float32, TF32
off, cuDNN's deterministic algorithms) as the port computes it, once with
a one-device "mesh" in place of the dp one (two single-device runs: the
card's run-to-run floor), and once with each planted fault in the dp
reduction:

- ``per-shard means``: each shard's loss is its own mean and the shards'
  means are averaged (a fault only where dp does not divide the batch:
  at 7 over 2 the 3-image shard weighs 4/3 of the other);
- ``last shard left out``: the last shard adds nothing.

Prints each run's gaps at each step (loss and terms relative, gradients
relative L2 worst leaf and over every leaf) beside
``chip_smoke.MESH_GATES``, then the card's name and power limit. A fault
is planted by wrapping the per-shard loss function that
``parallel/mesh.dp_gradients`` is handed; nothing in the package changes.
"""

from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _per_shard_means(batch, dp):
    def wrap(loss_fn):
        def shard_loss(reps, part):
            total, terms = loss_fn(reps, part)
            return total * (batch / (total.shape[0] * dp)), terms
        return shard_loss
    return wrap


def _last_shard_left_out(batch, dp):
    def wrap(loss_fn):
        calls = []

        def shard_loss(reps, part):
            calls.append(1)
            total, terms = loss_fn(reps, part)
            return (total * 0.0 if len(calls) % dp == 0 else total), terms
        return shard_loss
    return wrap


def main():
    import argparse

    import torch

    from airslam_tpu_torch.parallel import mesh as mesh_mod
    from airslam_tpu_torch.parallel import train_plnet

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=chip_smoke.MESH_RUN["batch"])
    batch = ap.parse_args().batch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    dp = chip_smoke.MESH_RUN["dp"]
    sound, make_mesh = train_plnet.dp_gradients, mesh_mod.make_mesh

    def one_device(tp=None, devices=None):
        return make_mesh(tp=tp, devices=devices[:1])

    out = {}
    for label, fault in (("sound", None), ("run to run", None),
                         ("per-shard means", _per_shard_means),
                         ("last shard left out", _last_shard_left_out)):
        if fault is not None:
            wrap = fault(batch, dp)

            def planted(mesh, modules, params, inputs, n, loss_fn, wrap=wrap):
                return sound(mesh, modules, params, inputs, n, wrap(loss_fn))

            train_plnet.dp_gradients = planted
        if label == "run to run":
            mesh_mod.make_mesh = one_device
        try:
            gaps = chip_smoke.dp_plnet_step_gaps(dev, dp, batch)
        finally:
            train_plnet.dp_gradients, mesh_mod.make_mesh = sound, make_mesh
        out[label] = [{k: step[k] for k in ("loss", "terms", "grad_leaf", "grad_all")}
                      for step in gaps["per_step"]]
        for i, step in enumerate(out[label]):
            print(f"{label}, step {i + 1}: " + ", ".join(f"{k} {v:.3e}" for k, v in step.items()),
                  flush=True)
    print(json.dumps({"batch": batch, "dp": dp, "gates": chip_smoke.MESH_GATES, "runs": out}))
    print(chip_smoke.card())


if __name__ == "__main__":
    main()
