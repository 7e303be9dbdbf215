"""Small tensor helpers (counterpart of ``tropical/core/ext.py``)."""

from __future__ import annotations

import torch


def nonzero_last(t: torch.Tensor) -> torch.Tensor:
    """Per row with any nonzero: (row, last nonzero column) as int64 [K, 2]."""
    t = t != 0
    if t.ndim != 2:
        raise ValueError(f"expected a 2-D tensor, got shape {tuple(t.shape)}")
    if t.shape[1] == 0:
        return torch.empty((0, 2), dtype=torch.int64, device=t.device)
    any_ = t.any(dim=1)
    # argmax over the reversed columns finds the first True from the right
    cols = t.shape[1] - 1 - torch.argmax(t.flip(1).to(torch.uint8), dim=1)
    rows = torch.nonzero(any_).squeeze(1)
    return torch.stack([rows, cols[any_]], dim=1)
