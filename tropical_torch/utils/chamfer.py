"""Chamfer / angular distance metrics and ray-based surface sampling.

Counterpart of ``tropical/utils/chamfer.py``:

- ``chamfer_distance`` = symmetric mean nearest-neighbour L2 distance, on
  the nearest-neighbour kernel of :mod:`tropical_torch.ops.chamfer`,
- ``sample_surface_from_rays`` casts the evaluation rays with the device ray
  tracer and returns hit positions + per-face cross-product normals + hit
  mask,
- ``get_rays`` / ``angular_distance`` as in the reference's evaluation.
"""

from __future__ import annotations

import numpy as np
import torch

from tropical_torch.ops.chamfer import min_nn_distance
from tropical_torch.ops.mesh_queries import MeshQuery


def chamfer_distance(x: torch.Tensor, y: torch.Tensor) -> float:
    """Symmetric mean NN distance between point sets x [N,3] and y [M,3]."""
    d2_yx, _ = min_nn_distance(y, x)
    d2_xy, _ = min_nn_distance(x, y)
    return float((d2_yx.sqrt().mean() + d2_xy.sqrt().mean()) / 2.0)


def get_rays(n: int = 100000, rng: np.random.Generator | None = None, *,
             device: torch.device | str):
    """Random unit directions from the origin, on ``device`` (no default:
    a caller that forgets it must not trace on the host).  The directions
    come from numpy's ``default_rng(0)``, so they are the JAX package's own
    rays."""
    rng = rng or np.random.default_rng(0)
    theta = rng.random(n) * 2 * np.pi
    phi = rng.random(n) * 2 * np.pi
    x = np.cos(theta) * np.sin(phi)
    y = np.sin(theta) * np.sin(phi)
    z = np.cos(phi)
    rays_d = torch.from_numpy(np.stack([x, y, z], axis=1).astype(np.float32))
    rays_d = rays_d.to(device)
    return torch.zeros_like(rays_d), rays_d


def sample_surface_from_rays(rays_o: torch.Tensor, rays_d: torch.Tensor, mesh,
                             return_normal: bool = False):
    """First-hit surface samples of ``mesh`` (a :class:`Mesh` of numpy
    arrays), traced on the rays' device.

    Returns hit positions [H,3] f32 and, with ``return_normal``, per-ray unit
    face normals [N,3] f64 and the hit mask [N]."""
    dev = rays_o.device
    n = rays_o.shape[0]
    faces = np.asarray(mesh.faces)
    if faces.shape[0] == 0:
        # degenerate mesh (an empty row of the eval ladder): no hits
        empty = torch.zeros((0, 3), dtype=torch.float32, device=dev)
        mask = torch.zeros(n, dtype=torch.bool, device=dev)
        if return_normal:
            return empty, torch.zeros((n, 3), dtype=torch.float64,
                                      device=dev), mask
        return empty

    positions, face_id, _ = MeshQuery(mesh.vertices, faces, dev).ray_trace(
        rays_o, rays_d)
    mask = face_id >= 0
    hit_positions = positions[mask]
    if not return_normal:
        return hit_positions

    fid = torch.where(mask, face_id, 0)
    verts = torch.as_tensor(np.asarray(mesh.vertices, np.float64), device=dev)
    tris = verts[torch.as_tensor(faces, device=dev)[fid]]
    normals = torch.linalg.cross(tris[:, 1] - tris[:, 0],
                                 tris[:, 2] - tris[:, 0], dim=-1)
    normals = normals / (torch.linalg.vector_norm(normals, dim=-1,
                                                  keepdim=True) + 1e-12)
    return hit_positions, normals, mask


def angular_distance(x: torch.Tensor, y: torch.Tensor):
    """Mean/std of the angle in degrees between unit normals."""
    deg = torch.rad2deg(torch.arccos(torch.clamp((x * y).sum(-1), -1, 1)))
    return float(deg.mean()), float(deg.std(correction=0))
