"""Triangle-mesh ray casting on the device, by brute force.

Counterpart of the ray-trace part of ``tropical/ops/mesh_queries.py``
(``_ray_tri_t`` and ``MeshQuery.ray_trace``): every ray is tested against
every triangle with Möller-Trumbore, in [rays x triangles] tiles with a
running first-hit minimum carried over the triangle chunks.
"""

from __future__ import annotations

import numpy as np
import torch

# a tile of RAY_BLOCK x TRI_CHUNK pairs keeps each f32 temporary at 32 MiB
RAY_BLOCK = 8192
TRI_CHUNK = 1024


def _ray_tri_t(o, d, a, b, c, eps: float = 1e-9):
    """Möller-Trumbore hit parameter t (inf on a miss).

    o, d: [P, 1, 3]; a, b, c: [1, T, 3] -> [P, T]."""
    e1 = b - a
    e2 = c - a
    h = torch.linalg.cross(d, e2, dim=-1)
    det = (e1 * h).sum(-1)
    inv = 1.0 / torch.where(det.abs() < eps, eps, det)
    s = o - a
    u = (s * h).sum(-1) * inv
    q = torch.linalg.cross(s, e1, dim=-1)
    v = (d * q).sum(-1) * inv
    t = (e2 * q).sum(-1) * inv
    hit = (det.abs() > eps) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-6)
    return torch.where(hit, t, torch.inf)


class MeshQuery:
    """A triangle mesh on a device, answering first-hit ray queries."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray,
                 device: torch.device | str):
        vertices = torch.as_tensor(np.asarray(vertices, np.float32),
                                   device=device)
        faces = torch.as_tensor(np.asarray(faces, np.int64), device=device)
        self.tris = vertices[faces]  # [T, 3, 3]
        self.device = self.tris.device

    def ray_trace(self, rays_o: torch.Tensor, rays_d: torch.Tensor):
        """First-hit positions [N,3] f32, face ids [N] (-1 = miss) and
        depths [N] (0 on a miss).  Ties go to the lowest face id."""
        o_all = rays_o.to(self.device, torch.float32)
        d_all = rays_d.to(self.device, torch.float32)
        n = o_all.shape[0]
        best_t = torch.full((n,), torch.inf, device=self.device)
        best_id = torch.full((n,), -1, dtype=torch.int64, device=self.device)
        for r0 in range(0, n, RAY_BLOCK):
            o = o_all[r0:r0 + RAY_BLOCK, None, :]
            d = d_all[r0:r0 + RAY_BLOCK, None, :]
            bt = best_t[r0:r0 + RAY_BLOCK]
            bi = best_id[r0:r0 + RAY_BLOCK]
            for t0 in range(0, self.tris.shape[0], TRI_CHUNK):
                tc = self.tris[t0:t0 + TRI_CHUNK]
                t = _ray_tri_t(o, d, tc[None, :, 0], tc[None, :, 1],
                               tc[None, :, 2])
                tmin, amin = t.min(dim=-1)
                better = tmin < bt
                bt.copy_(torch.where(better, tmin, bt))
                bi.copy_(torch.where(better, amin + t0, bi))
        miss = ~torch.isfinite(best_t)
        fid = torch.where(miss, -1, best_id)
        t = torch.where(miss, 0.0, best_t)
        positions = o_all + t[:, None] * d_all
        return positions, fid, t
