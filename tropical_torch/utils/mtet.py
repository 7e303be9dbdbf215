"""Marching tetrahedra with the reference call signature.

Counterpart of ``tropical/utils/mtet.py``: a wrapper over
:func:`tropical_torch.utils.isosurface.marching_tetrahedra`.
"""

from __future__ import annotations

import torch

from tropical_torch.utils.isosurface import marching_tetrahedra


def marching_tetrahedras(vertices: torch.Tensor, tets: torch.Tensor,
                         sdf: torch.Tensor, level: float = 0.0):
    """(vertices [P,3], tets [T,4], sdf [P]) -> (verts, faces) of the
    ``level`` set, on the inputs' device."""
    return marching_tetrahedra(vertices, tets, sdf - level)
