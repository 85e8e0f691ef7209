"""Train LightGlue or SuperGlue on rendered affine scene pairs described by
the frozen PLNet, with the PyTorch port, on the card (or the CPU), and write
the checkpoint in the JAX package's layout, which both packages'
``PointMatcher`` load (through ``AIRSLAM_CHECKPOINT_DIR``).

The port of ``apps/train_matcher.py``: the same flags, except ``--device``
(default ``cuda``) in place of ``--cpu`` and ``--out`` (default
``checkpoints_torch/`` beside the packages, which git ignores) in place of
writing into the JAX package's checkpoint folder; the same log line;
``optax.adam(lr)`` without clipping. It reads the shipped ``plnet_s0.npz``
(read only) and stops when it is absent. Fresh matchers get flax's
initialisers; ``--resume`` starts from the checkpoint in ``--out`` if present,
else from ``AIRSLAM_CHECKPOINT_DIR``'s or the shipped one. The networks run
in float32 as the JAX trainer's do: no TF32 in cuDNN's convolutions or
cuBLAS's products. One device (the JAX CLI has no mesh either).

Usage:
  python apps/train_matcher_torch.py --steps 1500 --batch 4 [--arch superglue]
  python apps/train_matcher_torch.py --tokens detected --view 2 --resume
  python apps/train_matcher_torch.py --device cpu --steps 2 --batch 1
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
    ap.add_argument("--arch", choices=["lightglue", "superglue"], default="lightglue")
    ap.add_argument("--tokens", choices=["corners", "detected"], default="corners",
                    help="corners: GT-corner tokens; detected: the frozen "
                         "detector's top-k keypoints (inference distribution)")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--resume", action="store_true",
                    help="start from the checkpoint in --out if present, else from "
                         "AIRSLAM_CHECKPOINT_DIR's or the shipped one")
    ap.add_argument("--log_every", type=int, default=50)
    ap.add_argument("--augment", type=float, default=1.0,
                    help="photometric augmentation strength (0 disables)")
    ap.add_argument("--view", type=float, default=1.0,
                    help="viewpoint-gap curriculum: affine strength sampled "
                         "per pair in [1, view] (detected tokens only)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train; returns ``losses`` (per step), the checkpoint path,
    ``first_step_s`` and ``steady_ms`` (ms per step after the first, the
    device synchronised)."""
    args = parse_args(argv)
    from airslam_tpu_torch import resolve_device
    from airslam_tpu_torch.models import weights as wio
    from airslam_tpu_torch.models.lightglue import LightGlue
    from airslam_tpu_torch.models.plnet import PLNet
    from airslam_tpu_torch.models.superglue import SuperGlue
    from airslam_tpu_torch.parallel import training

    # float32 throughout, as the JAX trainer computes: no TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = resolve_device(args.device)

    s0_ckpt = wio.checkpoint_path("plnet_s0.npz")
    if not os.path.exists(s0_ckpt):
        sys.exit("train the detector first (apps/train_plnet_torch.py)")
    plnet = PLNet()
    plnet.load_state_dict(wio.plnet_from_flax(wio.load_npz(s0_ckpt)["plnet"]))
    plnet.to(dev).eval().requires_grad_(False)

    if args.arch == "lightglue":
        model, name = LightGlue(), "lightglue.npz"
        from_flax, to_flax = wio.lightglue_from_flax, wio.lightglue_to_flax
        state = training.init_train_state(model, lr=args.lr, seed=args.seed)
        make_step = training.make_rendered_train_step
    else:
        model = SuperGlue(sinkhorn_iterations=training.SG_SINKHORN_ITERS, return_full=True)
        name = "superglue.npz"
        from_flax, to_flax = wio.superglue_from_flax, wio.superglue_to_flax
        state = training.init_train_state_sg(model, lr=args.lr, seed=args.seed)
        make_step = training.make_rendered_train_step_sg
    os.makedirs(args.out, exist_ok=True)
    ckpt = os.path.join(args.out, name)
    if args.resume:
        start = ckpt if os.path.exists(ckpt) else wio.checkpoint_path(name)
        if os.path.exists(start):
            model.load_state_dict(from_flax(wio.load_npz(start)))
    model.to(dev).train()  # in place: the optimizer keeps the same parameters
    if args.tokens == "detected":
        step_fn = training.make_detected_train_step(state, plnet, augment=args.augment,
                                                    view=args.view)
    else:
        step_fn = make_step(state, plnet, augment=args.augment)

    def save():
        wio.save_npz(ckpt, to_flax(model.state_dict()))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    losses = []
    t0 = time.time()
    t_first = None
    for step in range(args.steps):
        loss = step_fn(gen, args.batch)
        losses.append(loss)
        if step == 0:
            sync()
            t_first = time.time()
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(loss):8.4f} ({time.time() - t0:.0f}s)",
                  flush=True)
        if step and step % 500 == 0:
            save()
    sync()
    t_end = time.time()
    save()
    print(f"saved {ckpt}")
    return {"losses": [float(v) for v in losses], "ckpt": ckpt,
            "first_step_s": (t_first - t0) if t_first else None,
            "steady_ms": (t_end - t_first) * 1e3 / (args.steps - 1) if args.steps > 1 else None}


if __name__ == "__main__":
    main()
