"""Launch counts and largest shapes of every hand-written kernel.

Each kernel's wrapper calls ``record`` where it launches its kernel, and
nowhere else, so a run can show that its path went through the kernels:
``reset`` before it, read ``LAUNCHES`` after it.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

# kernel launches since the last reset
LAUNCHES: Dict[str, int] = {"min_dist": 0, "trilinear_roots": 0,
                             "hashgrid_encode_fwd": 0,
                             "hashgrid_encode_bwd": 0,
                             "hashgrid_encode_bwd_bwd": 0}
# the largest problem shape each kernel was launched on since the last reset:
# (n, m) of a min_dist search, (B,) of a trilinear_roots solve, (B, L) of a
# hash-grid encode kernel
LARGEST: Dict[str, Optional[Tuple[int, ...]]] = {k: None for k in LAUNCHES}


def reset() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LARGEST[k] = None


def record(name: str, shape: Tuple[int, ...]) -> None:
    """Count one launch of kernel ``name`` on a problem of ``shape``."""
    LAUNCHES[name] += 1
    if math.prod(shape) > math.prod(LARGEST[name] or (0,)):
        LARGEST[name] = tuple(shape)
