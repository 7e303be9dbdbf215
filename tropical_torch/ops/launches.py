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
                             "hashgrid_encode_bwd_bwd": 0,
                             "bvh_hierarchy": 0, "bvh_refit": 0,
                             "bvh_ray": 0, "bvh_closest": 0,
                             "lattice_encode": 0, "skeleton_mark": 0,
                             "split_step": 0, "connect_step": 0,
                             "curved_select": 0, "curved_roots": 0,
                             "curved_resolve": 0, "curved_filter": 0}
# the largest problem shape each kernel was launched on since the last reset:
# (n, m) of a min_dist search, (B,) of a trilinear_roots solve, (B, L) of a
# hash-grid encode kernel, (T,) triangles of a BVH build kernel, (N, T) rays
# or points by triangles of a BVH query; (N, L) lattice points by the levels
# of a lattice encode launch, (n,) items of a device-engine kernel (lattice
# points, edges, candidates)
LARGEST: Dict[str, Optional[Tuple[int, ...]]] = {k: None for k in LAUNCHES}
# the product of each LARGEST shape (0 for none)
_LARGEST_SIZE: Dict[str, int] = {k: 0 for k in LAUNCHES}
# the launches of each hash-grid backward that scattered a table gradient
# (a backward asked for the gradient in x alone scatters none)
SCATTERS: Dict[str, int] = {"hashgrid_encode_bwd": 0,
                            "hashgrid_encode_bwd_bwd": 0}


def reset() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LARGEST[k] = None
        _LARGEST_SIZE[k] = 0
    for k in SCATTERS:
        SCATTERS[k] = 0


def record(name: str, shape: Tuple[int, ...], scatter: bool = False,
           count: int = 1) -> None:
    """Count ``count`` launches of kernel ``name`` on a problem of
    ``shape``, and whether they scattered a table gradient."""
    if count <= 0:
        return
    LAUNCHES[name] += count
    if scatter:
        SCATTERS[name] += count
    size = math.prod(shape)
    if size > _LARGEST_SIZE[name]:
        _LARGEST_SIZE[name] = size
        LARGEST[name] = tuple(shape)
