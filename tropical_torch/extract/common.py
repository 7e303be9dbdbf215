"""Shared helpers for the extraction engine."""

from __future__ import annotations

import torch


def host_region(net, x: torch.Tensor, outputs: torch.Tensor, eps: float):
    """Region sign vector + grid offset from *cached* outputs (no forward).

    Named after its JAX counterpart, where this ran on the host; here it
    runs wherever ``x`` lives."""
    m, offset, _ = net.region(x, output=outputs, eps=eps)
    return m, offset
