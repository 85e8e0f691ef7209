"""PyTorch/CUDA port of ``airslam_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package imports nothing of it.
Plain tensor code is PyTorch; every Pallas kernel of the JAX package on a
ported path is a hand-written CUDA kernel under ``csrc/`` with a plain
PyTorch twin beside its wrapper (see ``ops/remap.py`` and ``ops/bilerp.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU they raise rather than fall back.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when CUDA is asked for and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev
