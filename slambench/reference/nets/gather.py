"""Clipped row and value gathers.

Port of ``airslam_tpu/ops/gather.py``. On the TPU these were one-hot MXU
contractions to avoid serial dynamic slices; on the card they are plain
indexing with the same clip semantics (out-of-range indices clamp to the
nearest row), which is all the callers rely on.
"""

from __future__ import annotations

import torch


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[clip(idx)]`` for ``table`` (R, C) and ``idx`` (N,) int."""
    return table[idx.clamp(0, table.shape[0] - 1)]


def take_values(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``values[clip(idx)]`` for a 1-D ``values``."""
    return values[idx.clamp(0, values.shape[0] - 1)]
