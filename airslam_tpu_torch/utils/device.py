"""Device selection for the port's CLI apps.

``--device auto`` (the default) and ``--device cuda`` mean the card;
``--device cpu`` runs the plain PyTorch path. Without a card, ``auto`` and
``cuda`` raise (through :func:`airslam_tpu_torch.resolve_device`): nothing
falls back to the CPU silently."""

import torch

from airslam_tpu_torch import resolve_device


def select(device) -> torch.device:
    """The ``torch.device`` that a ``--device`` value names."""
    return resolve_device(None if device in (None, "auto") else device)


def add_arg(parser):
    parser.add_argument("--device", default="auto", choices=["auto", "cpu", "cuda"],
                        help="where to run: auto and cuda mean the card (the default), "
                             "cpu the plain PyTorch path")
