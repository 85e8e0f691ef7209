"""Train PLNet stage 0 (with the stage-1 LOI head) or SuperPoint on synthetic
shapes with the PyTorch port, on the card (or the CPU), and write checkpoints
in the JAX package's layout, which both packages' ``FeatureDetector`` load
(through ``AIRSLAM_CHECKPOINT_DIR``).

The port of ``apps/train_plnet.py``: the same flags, except ``--device``
(default ``cuda``; ``cpu`` runs the plain versions of the kernels) in place
of ``--cpu``; the same log line; ``optax.chain(clip_by_global_norm(5),
adam(lr))`` as :class:`ClippedAdam`. Fresh networks get flax's initialisers;
the LOI head starts from the shipped ``plnet_s1.npz``; ``--distill`` reads
the shipped ``plnet_s0.npz`` (read only). The default ``--out`` is
``checkpoints_torch/`` beside the packages (git ignores it), never the JAX
package's checkpoint folder. The networks train in float32 as the JAX
trainer's do: no TF32 in cuDNN's convolutions or cuBLAS's products. With
more than one visible card (and ``--device cuda``) every step is
data-parallel over all of them, as the JAX CLI's ``dp`` mesh: the batch split
over the cards, the gradients summed on the first (``parallel/train_plnet.py``
``_train_step``).

Usage:
  python apps/train_plnet_torch.py --steps 2000 --batch 8
  python apps/train_plnet_torch.py --model superpoint --distill --steps 2000
  python apps/train_plnet_torch.py --device cpu --steps 2 --batch 1
"""

from __future__ import annotations

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

DEFAULT_OUT = os.path.join(REPO, "checkpoints_torch")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=["plnet", "superpoint"], default="plnet")
    ap.add_argument("--distill", action="store_true",
                    help="superpoint only: distill descriptors onto the shipped PLNet "
                         "stage-0 space (shared space across use_superpoint: 0/1 configs)")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--resume", action="store_true",
                    help="start from the checkpoint in --out if present")
    ap.add_argument("--log_every", type=int, default=25)
    ap.add_argument("--augment", type=float, default=1.0,
                    help="photometric augmentation strength (0 disables)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train; returns ``losses`` (per step), ``terms`` (per step), the
    checkpoint path, ``first_step_s`` and ``steady_ms`` (ms per step after
    the first, the device synchronised)."""
    args = parse_args(argv)
    from airslam_tpu_torch import resolve_device
    from airslam_tpu_torch.models import weights as wio
    from airslam_tpu_torch.models.plnet import LoiHeadS1, PLNet
    from airslam_tpu_torch.models.superpoint import SuperPoint
    from airslam_tpu_torch.parallel import train_plnet as tp
    from airslam_tpu_torch.parallel.mesh import make_mesh

    # float32 throughout, as the JAX trainer computes: no TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    init_gen = torch.Generator().manual_seed(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    mesh = None
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        mesh = make_mesh(tp=1)
        print(f"data-parallel over {mesh}")

    if args.model == "plnet":
        plnet, loi = PLNet(), LoiHeadS1()
        ckpt = os.path.join(args.out, "plnet_s0.npz")
        if args.resume and os.path.exists(ckpt):
            tree = wio.load_npz(ckpt)
            plnet.load_state_dict(wio.plnet_from_flax(tree["plnet"]))
            loi.load_state_dict(wio.loi_s1_from_flax(tree["loi"]))
        else:
            tp.flax_init_(plnet, init_gen)
            loi.load_state_dict(wio.loi_s1_from_flax(
                wio.load_npz(wio.checkpoint_path("plnet_s1.npz"))))
        plnet.to(dev).train()
        loi.to(dev).train()
        opt = tp.ClippedAdam(list(plnet.parameters()) + list(loi.parameters()), args.lr)
        step_fn = tp.make_plnet_train_step(plnet, loi, opt, augment=args.augment, mesh=mesh)

        def save():
            wio.save_npz(ckpt, {"plnet": wio.plnet_to_flax(plnet.state_dict()),
                                "loi": wio.loi_s1_to_flax(loi.state_dict())})
    else:
        sp = SuperPoint()
        ckpt = os.path.join(args.out, "superpoint.npz")
        if args.resume and os.path.exists(ckpt):
            sp.load_state_dict(wio.superpoint_from_flax(wio.load_npz(ckpt)))
        else:
            tp.flax_init_(sp, init_gen)
        sp.to(dev).train()
        opt = tp.ClippedAdam(sp.parameters(), args.lr)
        if args.distill:
            s0 = wio.checkpoint_path("plnet_s0.npz")
            if not os.path.exists(s0):
                sys.exit("distillation needs the trained plnet_s0.npz")
            plnet = PLNet()
            plnet.load_state_dict(wio.plnet_from_flax(wio.load_npz(s0)["plnet"]))
            plnet.to(dev).eval().requires_grad_(False)
            step_fn = tp.make_superpoint_distill_step(sp, opt, plnet, augment=args.augment,
                                                      mesh=mesh)
        else:
            step_fn = tp.make_superpoint_train_step(sp, opt, augment=args.augment, mesh=mesh)

        def save():
            wio.save_npz(ckpt, wio.superpoint_to_flax(sp.state_dict()))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    losses, terms_log = [], []
    t0 = time.time()
    t_first = None
    for step in range(args.steps):
        loss, terms = step_fn(gen, args.batch)
        losses.append(loss)
        terms_log.append(terms)
        if step == 0:
            sync()
            t_first = time.time()
        if step % args.log_every == 0 or step == args.steps - 1:
            vals = {k: float(v) for k, v in terms.items()}
            print(f"step {step:5d} loss {float(loss):8.4f} "
                  + " ".join(f"{k}={v:.4f}" for k, v in sorted(vals.items()))
                  + f"  ({(time.time() - t0):.0f}s)", flush=True)
        if step and step % 500 == 0:
            save()
    sync()
    t_end = time.time()
    save()
    print(f"saved {ckpt}")
    return {"losses": [float(v) for v in losses],
            "terms": [{k: float(v) for k, v in t.items()} for t in terms_log], "ckpt": ckpt,
            "first_step_s": (t_first - t0) if t_first else None,
            "steady_ms": (t_end - t_first) * 1e3 / (args.steps - 1) if args.steps > 1 else None}


if __name__ == "__main__":
    main()
