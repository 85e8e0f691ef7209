"""Where the port's stored train steps part from the JAX step on one NVIDIA
GPU: cuDNN, the card against the host, float32 against float64 sums.

    python3 scripts/train_step_gaps.py

1. ``chip_smoke.train_oracle_steps`` (one step of each detector-training
   mode from the shipped checkpoints against
   ``tests/data/torch_train_oracle.npz``; float32, TF32 off, cuDNN's
   deterministic algorithms) on the card with cuDNN on, as the training CLI
   runs, then with cuDNN off (PyTorch's own im2col and cuBLAS convolutions),
   then on the host's CPU. Each prints every leaf's worst gaps to the JAX
   step and the gradients where JAX's is exactly zero; a failed gate is
   printed and the script goes on.
2. The stored ``superpoint`` pair through SuperPoint's backbone on the card
   and on the CPU: per convolution, the pixels whose pre-activation has
   another sign on the two devices (ReLU passes the gradient on one and not
   on the other).
3. SuperPoint's ``conv1a``/``conv1b`` weight and bias gradients of the
   stored ``superpoint`` step on the card, summed in float32 (cuDNN, as the
   port trains) and in float64 from the same layer inputs and output
   gradients, as relative L2 gaps.

Then the card's name and power limit.
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _steps(label, dev, **flags):
    import torch

    print(f"--- {label}")
    with torch.backends.cudnn.flags(benchmark=False, deterministic=True, allow_tf32=False,
                                    **flags):
        try:
            chip_smoke.train_oracle_steps(dev)
        except RuntimeError as err:
            print(f"gate failed: {err}")


def _superpoint(dev):
    from airslam_tpu_torch.models import weights as wio
    from airslam_tpu_torch.models.superpoint import SuperPoint

    sp = SuperPoint()
    sp.load_state_dict(wio.superpoint_from_flax(wio.load_npz(
        wio.checkpoint_path("superpoint.npz"))))
    return sp.to(dev)


def relu_flips(dev):
    import torch
    import torch.nn.functional as F

    from airslam_tpu_torch.models.superpoint import VGG_CONVS

    z = np.load(chip_smoke.TRAIN_ORACLE)
    scenes = [chip_smoke.train_scene(z, "superpoint", v) for v in (0, 1)]
    img = torch.cat([s.image for s in scenes])[:, None]
    nets = {d: _superpoint(d).backbone for d in (dev, "cpu")}
    xs = {d: img.to(d) for d in nets}
    with torch.no_grad(), chip_smoke._no_tf32("f32"):
        for i, (name, _, _) in enumerate(VGG_CONVS):
            pre = {d: getattr(nets[d], name)(xs[d]).cpu() for d in nets}
            flips = int(((pre[dev] > 0) != (pre["cpu"] > 0)).sum())
            gap = float((pre[dev] - pre["cpu"]).abs().max())
            print(f"{name}: {flips} of {pre['cpu'].numel()} pre-activations change sign between "
                  f"the card and the CPU; max |gap| {gap:.3e}")
            for d in nets:
                xs[d] = F.relu(pre[d].to(d))
                if i % 2 == 1 and i < 6:
                    xs[d] = F.max_pool2d(xs[d], 2)


def f32_sums(dev):
    import torch

    from airslam_tpu_torch.parallel import train_plnet as tp

    z = np.load(chip_smoke.TRAIN_ORACLE)
    s0, s1 = (chip_smoke._to_dev(chip_smoke.train_scene(z, "superpoint", v), dev)
              for v in (0, 1))
    sp = _superpoint(dev)
    inputs, grads = {}, {}

    def hook(name):
        def keep(module, args, out):
            inputs[name] = args[0].detach()
            out.register_hook(lambda g: grads.__setitem__(name, g.detach()))
        return keep

    convs = {n: getattr(sp.backbone, n) for n in ("conv1a", "conv1b")}
    handles = [conv.register_forward_hook(hook(n)) for n, conv in convs.items()]
    try:
        with chip_smoke._no_tf32("f32"), chip_smoke._pinned_cudnn():
            loss, _ = tp.superpoint_loss(sp, s0, s1)
            loss.backward()
    finally:
        for h in handles:
            h.remove()
    for name, conv in convs.items():
        x, g = inputs[name].double(), grads[name].double()
        w64 = torch.nn.grad.conv2d_weight(x, conv.weight.shape, g, padding=1)
        w, b = (chip_smoke._rel_l2(lo.grad.double().cpu().numpy(), hi.cpu().numpy())
                for lo, hi in ((conv.weight, w64), (conv.bias, g.sum((0, 2, 3)))))
        print(f"{name}: float32 sums against float64: weight {w:.3e}, bias {b:.3e}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("train_step_gaps: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    _steps("card, cuDNN on", dev, enabled=True)
    _steps("card, cuDNN off", dev, enabled=False)
    _steps("host CPU", torch.device("cpu"))
    print("--- ReLU signs, card against CPU (the stored superpoint pair)")
    relu_flips(dev)
    print("--- SuperPoint's first weight gradients on the card")
    f32_sums(dev)
    print(f"device: {chip_smoke.card()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
