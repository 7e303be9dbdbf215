"""Marching tetrahedra on a 6-tet cube lattice: the evaluation's grid
baseline for ``-t mtet``.

Counterpart of ``tropical/utils/isosurface.py`` on torch tensors on the
net's device: the same 16-case sign tables, derived from the corner-sign
patterns (triangle normals point from the positive inside toward the
negative region), the same tetrahedral lattice, and the same float64
arithmetic as the JAX package's numpy, in the same order, so that a field
gives bitwise the JAX package's vertices and triangles.  Three points keep
it so:

- every sum of a fixed few terms is written out left to right, as numpy
  reduces them, and the cross product is separate products and
  differences (no reduction kernel or fused multiply-add reorders them);
- a row flip is ``flip(-1)`` (numpy's ``[:, ::-1]``);
- ``torch.unique(sorted=True)`` orders the crossing edges and the merged
  vertices as ``np.unique`` does, on the card as on the CPU.

The grid field comes from ``utils/marching_cubes``' slabs, through
``net.sdf`` and so the encode forward kernel: one net evaluation a slab.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tropical_torch.utils.marching_cubes import (grid_points, merge_slabs,
                                                 slab_fields)
from tropical_torch.utils.ply import Mesh

# 6 tetrahedra per cube over corners v0..v7 (the reference evaluation's
# decomposition)
CUBE_TETS = np.asarray([
    [0, 1, 2, 6],
    [1, 2, 4, 6],
    [0, 1, 3, 6],
    [1, 3, 5, 6],
    [4, 5, 6, 7],
    [1, 4, 5, 6],
], np.int64)

# corner offsets: v0=(0,0,0) v1=(1,0,0) v2=(0,1,0) v3=(0,0,1) v4=(1,1,0)
# v5=(1,0,1) v6=(0,1,1) v7=(1,1,1)
CUBE_CORNERS = np.asarray([
    [0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1],
    [1, 1, 0], [1, 0, 1], [0, 1, 1], [1, 1, 1],
], np.int64)


def _case_tables():
    """For each of 16 corner-sign codes: up to 2 triangles, each vertex being
    a (corner_a, corner_b) crossing edge; -1 padding."""
    tris_table = np.full((16, 2, 3, 2), -1, np.int64)
    ntris = np.zeros(16, np.int64)
    for code in range(16):
        pos = [i for i in range(4) if (code >> i) & 1]
        neg = [i for i in range(4) if not (code >> i) & 1]
        if len(pos) == 1:
            p = pos[0]
            a, b, c = neg
            tris_table[code, 0] = [(p, a), (p, b), (p, c)]
            ntris[code] = 1
        elif len(pos) == 3:
            n = neg[0]
            a, b, c = pos
            tris_table[code, 0] = [(n, a), (n, b), (n, c)]
            ntris[code] = 1
        elif len(pos) == 2:
            p0, p1 = pos
            n0, n1 = neg
            e00, e01, e10, e11 = (p0, n0), (p0, n1), (p1, n1), (p1, n0)
            tris_table[code, 0] = [e00, e01, e10]
            tris_table[code, 1] = [e00, e10, e11]
            ntris[code] = 2
    return tris_table, ntris


_TRIS_TABLE, _NTRIS = _case_tables()


def _sum_corners(t: torch.Tensor) -> torch.Tensor:
    """[F, 4, 3] -> [F, 3], summed over the corners left to right."""
    return ((t[:, 0] + t[:, 1]) + t[:, 2]) + t[:, 3]


def marching_tetrahedra(points: torch.Tensor, tets: torch.Tensor,
                        sdf: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Triangulate the zero level set of ``sdf`` over the tetrahedral mesh,
    on the inputs' device.

    Args:
        points: [P, 3] vertex positions.
        tets: [T, 4] int64 tetrahedron corner indices.
        sdf: [P] field values (inside positive).

    Returns:
        (vertices [V, 3] float64, triangles [F, 3] int64) with one vertex
        per crossing edge, edges in ascending (low, high) corner order.
    """
    dev = points.device
    points = points.to(torch.float64)
    sdf = sdf.to(torch.float64)
    occ = sdf > 0
    ntris = torch.from_numpy(_NTRIS).to(dev)
    code = (occ[tets].to(torch.int64)
            << torch.arange(4, device=dev)).sum(-1)
    active = ntris[code] > 0
    tets = tets[active]
    code = code[active]
    if tets.shape[0] == 0:
        return (torch.empty((0, 3), dtype=torch.float64, device=dev),
                torch.empty((0, 3), dtype=torch.int64, device=dev))

    # per-tet triangle corner-pair lists, valid triangles in (tet, slot)
    # order
    tt = torch.from_numpy(_TRIS_TABLE).to(dev)[code]   # [T, 2, 3, 2]
    nt = ntris[code]                                    # [T]
    tri_mask = torch.arange(2, device=dev)[None, :] < nt[:, None]
    tri_pairs = tt[tri_mask]                            # [F, 3, 2]
    tri_tets = tets[torch.repeat_interleave(
        torch.arange(tets.shape[0], device=dev), nt)]   # [F, 4]

    # global vertex ids of each edge's endpoints; one vertex per edge
    ga = torch.gather(tri_tets, 1, tri_pairs[..., 0])
    gb = torch.gather(tri_tets, 1, tri_pairs[..., 1])
    n_points = points.shape[0]
    key = torch.minimum(ga, gb) * n_points + torch.maximum(ga, gb)
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    ua = uniq // n_points
    ub = uniq % n_points
    sa = sdf[ua]
    sb = sdf[ub]
    w = sa / (sa - sb)
    verts = points[ua] * (1 - w[:, None]) + points[ub] * w[:, None]
    tris = inv.reshape(-1, 3)

    # orientation: the normal points from inside (positive) to outside
    # (negative), i.e. along mean(negative corners) - mean(positive corners)
    v = verts[tris]
    a = v[:, 1] - v[:, 0]
    b = v[:, 2] - v[:, 0]
    normal = torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                          a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                          a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=-1)
    tet_pts = points[tri_tets]                          # [F, 4, 3]
    tet_occ = occ[tri_tets]                             # [F, 4]
    n_pos = tet_occ.sum(-1, keepdim=True).clamp(min=1).to(torch.float64)
    n_neg = (~tet_occ).sum(-1, keepdim=True).clamp(min=1).to(torch.float64)
    w_pos = tet_occ.to(torch.float64) / n_pos
    w_neg = (~tet_occ).to(torch.float64) / n_neg
    out_dir = (_sum_corners(tet_pts * w_neg[..., None])
               - _sum_corners(tet_pts * w_pos[..., None]))
    prod = normal * out_dir
    flip = (prod[:, 0] + prod[:, 1]) + prod[:, 2] < 0
    tris = torch.where(flip[:, None], tris.flip(-1), tris)
    return verts, tris


def grid_tetrahedra(nx: int, n: int, device) -> torch.Tensor:
    """[6 (nx-1)(n-1)^2, 4] tet corner indices of an nx x n x n grid with
    idx = x*n^2 + y*n + z, cubes in row-major order."""
    ar = [torch.arange(k - 1, device=device) for k in (nx, n, n)]
    base = ((ar[0][:, None, None] * n + ar[1][None, :, None]) * n
            + ar[2][None, None, :]).reshape(-1)                 # [C]
    offsets = torch.from_numpy(
        CUBE_CORNERS @ np.asarray([n * n, n, 1])).to(device)   # [8]
    corner_ids = base[:, None] + offsets[None, :]               # [C, 8]
    return corner_ids[:, torch.from_numpy(CUBE_TETS).to(device)].reshape(-1, 4)


def sdf_grid(net, res: int, canvas: float) -> torch.Tensor:
    """net.sdf on the res^3 grid over [-canvas, canvas]^3, [res, res, res]
    float32 on the net's device: the x-planes of
    ``utils/marching_cubes.slab_fields``, each once, so each value is the
    one the grid meshes see."""
    return torch.cat([vals[1 if x0 else 0:]
                      for x0, _, vals in slab_fields(net, res, canvas)])


def mt_slabs(net, res: int, canvas: float):
    """Yield ``(vals, verts, tris)`` of marching tetrahedra on each x-slab
    (``utils/marching_cubes.slab_fields``)."""
    for x0, s, vals in slab_fields(net, res, canvas):
        nx = vals.shape[0]
        pts = grid_points(s, x0 * res * res, nx * res * res)
        verts, tris = marching_tetrahedra(
            pts.to(torch.float64), grid_tetrahedra(nx, res, net.device),
            vals.reshape(-1))
        yield vals, verts, tris


def run_marching_tetrahedra(net, res: int, canvas: float,
                            R: float = 1.0) -> Mesh:
    """Grid MT baseline mesh of the net's zero level set on a res^3 grid
    over [-canvas, canvas]^3, vertices divided by the dataset scale R.

    Processed in x-slabs so a 512^3 grid never materializes the full
    800M-tet array; duplicate vertices on slab boundaries (bitwise-identical
    positions) are merged at the end."""
    return merge_slabs(mt_slabs(net, res, canvas), R)
