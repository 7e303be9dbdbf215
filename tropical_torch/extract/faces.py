"""Skeleton filtering and face assembly from sign-vector regions.

Counterpart of ``tropical/extract/faces.py``: surviving vertices are grouped
by region (excluding the final SDF plane column), each region polygon is
sorted by angle around the SDF normal at its mean point, and
fan-triangulated.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tropical_torch.core import regions as rg
from tropical_torch.extract.common import host_region


def extract_skeleton(vertices: torch.Tensor, edges: torch.Tensor,
                     outputs: torch.Tensor, net, eps: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Keep vertices with |sdf-plane output| < eps inside the unit range, and
    edges with both endpoints surviving; compact indices."""
    m = outputs[:, -1].abs() < eps
    v = net.preprocess(vertices)
    m &= ~(v > 1).any(dim=-1)
    m &= ~(v < 0).any(dim=-1)

    dev = vertices.device
    if int(m.sum()) < 3:
        return (torch.empty((0, 3), dtype=vertices.dtype, device=dev),
                torch.empty((0, 2), dtype=torch.int64, device=dev),
                torch.empty(0, dtype=torch.int64, device=dev))

    edges = edges[m[edges].sum(dim=-1) == 2]
    v_idx, r_idx = torch.unique(edges.reshape(-1), return_inverse=True)
    return vertices[v_idx], r_idx.reshape(-1, 2), v_idx


def sort_polygon_rows(points: torch.Tensor, normals: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """Angular ordering of polygon vertices around their normal.

    The cosine to the first vertex plus the cross-product direction against
    the normal gives a full 360-degree score ``s = cos * sign(d) + 2*(d<0)``,
    sorted descending (stable).

    Args:
        points: [R, M, 3], invalid entries zero-filled.
        normals: [R, 3].
        valid: [R, M] bool.

    Returns:
        order [R, M] argsort indices.
    """
    # float64 from here on, as the JAX package's numpy code promotes it
    k = valid.sum(-1, keepdim=True).clamp(min=1)[..., None]
    u = points.double() - points.sum(-2, keepdim=True).double() / k
    d = torch.linalg.cross(u[:, :1].expand_as(u), u, dim=-1)
    nrm = torch.linalg.vector_norm(u, dim=-1)
    denom = (nrm[:, :1] * nrm).clamp(min=1e-8)
    c = (u[:, :1] * u).sum(-1) / denom
    dn = (d @ normals.double()[..., None]).squeeze(-1)
    s = c * ((dn >= 0) * 2.0 - 1.0) + (dn < 0) * 2.0
    return torch.argsort(-s, dim=-1, stable=True)


def fan_triangles(rows: torch.Tensor) -> torch.Tensor:
    """Fan-triangulate each row's (angle-sorted) vertex-index list.

    Rows are left-aligned and padded with -1.  Duplicated indices within a
    row are removed first, then each row with count >= 3 emits the fan
    (v0, v_{j}, v_{j+1}).
    """
    rows = rows.to(torch.int64).clone()
    R, M = rows.shape
    for i in range(1, M):
        dup = (rows[:, :i] == rows[:, i:i + 1]).any(dim=1)
        rows[dup, i] = -1

    mask = rows != -1
    counts = mask.sum(-1)
    flat = rows[mask]
    starts = torch.cumsum(counts, 0) - counts
    ntri = (counts - 2).clamp(min=0)
    n_total = int(ntri.sum())
    if n_total == 0:
        return torch.empty((0, 3), dtype=torch.int64, device=rows.device)
    row_ids = torch.repeat_interleave(torch.arange(R, device=rows.device), ntri)
    tri_starts = torch.cumsum(ntri, 0) - ntri
    rank = (torch.arange(n_total, device=rows.device)
            - torch.repeat_interleave(tri_starts, ntri))
    base = starts[row_ids]
    return torch.stack([flat[base], flat[base + rank + 1],
                        flat[base + rank + 2]], dim=1)


def mean_points_with_valid(vertices: torch.Tensor, v_indices: torch.Tensor):
    """Mean point per region row (-1 padded); drop rows with < 3 valid
    vertices."""
    invalid = v_indices == -1
    points = vertices[v_indices.clamp(min=0)]
    points[invalid] = 0
    Z = (~invalid).sum(-1, keepdim=True)
    # divided in float64 and rounded once more, as in the JAX package
    mean_points = (points.sum(1).double() / Z.clamp(min=1)).to(points.dtype)
    keep = Z.squeeze(-1) >= 3
    return mean_points[keep], points[keep], v_indices[keep]


def extract_faces(vertices: torch.Tensor, edges: torch.Tensor, net,
                  outputs: torch.Tensor, eps: float):
    """Region-group surviving vertices, sort each polygon, fan-triangulate.

    Returns (face_positions [T,3,3], triangle_indices [T,3])."""
    dev = vertices.device
    empty = (torch.empty((0, 3, 3), dtype=torch.float32, device=dev),
             torch.empty((0, 3), dtype=torch.int64, device=dev))
    if vertices.shape[0] == 0:
        return empty

    m_rgn, offset = host_region(net, vertices, outputs, eps)

    # exclude the final SDF plane column
    r_idx, aug = rg.regions_to_vertices(m_rgn[:, :-1], offset)
    v_indices = rg.region_table(r_idx, aug)
    v_indices = torch.unique(v_indices, dim=0)

    mean_points, points, v_indices = mean_points_with_valid(vertices, v_indices)
    if mean_points.shape[0] == 0:
        return empty

    normals = net.normal(mean_points)

    order = sort_polygon_rows(points, normals, v_indices != -1)
    sorted_idx = torch.gather(v_indices, 1, order)

    # the angular sort is CCW around +grad(sdf) (inward for inside-positive
    # SDFs); reverse the winding so exported normals point outward
    tris = fan_triangles(sorted_idx).flip(1)
    return vertices[tris], tris
