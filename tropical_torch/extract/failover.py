"""Numerical failure recovery of the subdivision loop, flat path only.

Counterpart of the ``force=True`` part of ``tropical/extract/failover.py``:
the sign-vector override.  The curved path's gradient-descent rescue and
strict filter belong to the curved slice.
"""

from __future__ import annotations

import torch

# event totals of the most recent extraction (reset by ``subpoly``): curved
# rows with no in-range trilinear root, rows the gradient-descent rescue
# optimized, and curved rows the strict filter dropped.  All stay 0 on the
# flat path.
COUNTERS = {"sentinels": 0, "gd_rows": 0, "strict_drops": 0}


def reset_counters() -> None:
    for k in COUNTERS:
        COUNTERS[k] = 0


def sign_override(edges_m: torch.Tensor, _regions: torch.Tensor,
                  _offset: torch.Tensor, idx: int, outputs_new: torch.Tensor,
                  eps: float) -> bool:
    """Force new vertices exactly onto the planes their parent edge lies on.

    If a new vertex's output on a plane shared by both parent endpoints (and,
    for grid planes, the same cell) exceeds eps, all such plane outputs are
    overridden to exactly 0 so later eps-sign-vector region tests do not
    fracture.  Mutates ``outputs_new`` in place; returns True if an override
    happened.
    """
    m_rgn = _regions[edges_m]          # [N, 2, 3+R]
    offset = _offset[edges_m]          # [N, 2, 3]
    m_chk = (m_rgn[:, 0] == 0) & (m_rgn[:, 1] == 0)
    m_chk[:, :3] &= offset[:, 0] == offset[:, 1]
    b = m_chk[:, 3:].clone()           # neuron-plane membership of the edge
    b[:, idx:] = False
    b[:, idx] = True                   # always pin the current surface
    if bool((outputs_new[b].abs() > eps).any()):
        outputs_new[b] = 0.0
        return True
    return False
