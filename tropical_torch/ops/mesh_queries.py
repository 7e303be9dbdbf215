"""Triangle-mesh queries on the device, by brute force: ray casting and
signed distance.

Counterpart of ``tropical/ops/mesh_queries.py``.  Every ray or point is
tested against every triangle in [points x triangles] tiles, with a running
minimum (first hit, or squared distance) carried over the triangle chunks:

- ``ray_trace``: Möller-Trumbore first hits (evaluation surface samples);
- ``unsigned_distance``: Ericson's closest point on a triangle;
- ``signed_distance``: positive inside, by the parity of the crossings of a
  fixed ray from each point (the training labels).

Plain torch; K10 in ROADMAP.md, whose kernel is later work.
"""

from __future__ import annotations

import numpy as np
import torch

# a tile of RAY_BLOCK x TRI_CHUNK pairs keeps each f32 temporary at 32 MiB
RAY_BLOCK = 8192
TRI_CHUNK = 1024
# the distance tile holds some ten [P, T, 3] temporaries: 48 MiB each
POINT_BLOCK = 4096
# the parity ray's direction, built in float32 as the JAX package builds it
_PARITY_DIR = np.asarray([0.5320963, 0.6418563, 0.55234 / 0.9], np.float32)
_PARITY_DIR = _PARITY_DIR / np.linalg.norm(_PARITY_DIR)


def _closest_dist2(p, a, b, c):
    """Squared distance point -> triangle (Ericson, Real-Time Collision
    Detection 5.1.5) over [P, T] pair tiles, its cases applied in the JAX
    package's order: interior, edges BC, AC, AB, then vertices c, b, a.

    p: [P, 1, 3]; a, b, c: [1, T, 3] -> [P, T]."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = (ab * ap).sum(-1)
    d2 = (ac * ap).sum(-1)

    bp = p - b
    d3 = (ab * bp).sum(-1)
    d4 = (ac * bp).sum(-1)

    cp = p - c
    d5 = (ab * cp).sum(-1)
    d6 = (ac * cp).sum(-1)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    def safe_div(x, y):
        return x / torch.where(y.abs() < 1e-30, 1e-30, y)

    # interior point
    denom = safe_div(torch.ones_like(va), va + vb + vc)
    v_in = vb * denom
    w_in = vc * denom
    closest = a + ab * v_in[..., None] + ac * w_in[..., None]

    # edge BC
    w_bc = safe_div(d4 - d3, (d4 - d3) + (d5 - d6))
    on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    closest = torch.where(on_bc[..., None], b + (c - b) * w_bc[..., None],
                          closest)

    # edge AC
    w_ac = safe_div(d2, d2 - d6)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    closest = torch.where(on_ac[..., None], a + ac * w_ac[..., None], closest)

    # edge AB
    w_ab = safe_div(d1, d1 - d3)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    closest = torch.where(on_ab[..., None], a + ab * w_ab[..., None], closest)

    # vertices
    closest = torch.where(((d6 >= 0) & (d5 <= d6))[..., None], c, closest)
    closest = torch.where(((d3 >= 0) & (d4 <= d3))[..., None], b, closest)
    closest = torch.where(((d1 <= 0) & (d2 <= 0))[..., None], a, closest)

    diff = p - closest
    return (diff * diff).sum(-1)


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
    """A triangle mesh on a device, answering first-hit ray and (signed)
    distance queries."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray,
                 device: torch.device | str):
        vertices = torch.as_tensor(np.asarray(vertices, np.float32),
                                   device=device)
        faces = torch.as_tensor(np.asarray(faces, np.int64), device=device)
        self.tris = vertices[faces]  # [T, 3, 3]
        self.device = self.tris.device

    def _tiles(self, n: int, block: int):
        """(row slice, first triangle of the chunk, the chunk's a, b, c as
        [1, T, 3]) for every tile of ``block`` of ``n`` rows by TRI_CHUNK
        triangles."""
        for p0 in range(0, n, block):
            for t0 in range(0, self.tris.shape[0], TRI_CHUNK):
                tc = self.tris[t0:t0 + TRI_CHUNK]
                yield (slice(p0, p0 + block), t0, tc[None, :, 0],
                       tc[None, :, 1], tc[None, :, 2])

    def unsigned_distance(self, points: torch.Tensor) -> torch.Tensor:
        """Distance [N] f32 from each point to the nearest triangle."""
        p = points.to(self.device, torch.float32)
        best = torch.full((p.shape[0],), torch.inf, device=self.device)
        for rows, _, a, b, c in self._tiles(p.shape[0], POINT_BLOCK):
            d2 = _closest_dist2(p[rows, None, :], a, b, c)
            torch.minimum(best[rows], d2.amin(dim=-1), out=best[rows])
        return best.sqrt()

    def signed_distance(self, points: torch.Tensor) -> torch.Tensor:
        """Signed distance [N] f32, positive inside: the unsigned distance,
        with the sign of the parity of the crossings of a fixed ray."""
        p = points.to(self.device, torch.float32)
        dist = self.unsigned_distance(p)
        d = torch.from_numpy(_PARITY_DIR).to(self.device)[None, None, :]
        hits = torch.zeros(p.shape[0], dtype=torch.int64, device=self.device)
        for rows, _, a, b, c in self._tiles(p.shape[0], POINT_BLOCK):
            t = _ray_tri_t(p[rows, None, :], d, a, b, c)
            hits[rows] += torch.isfinite(t).sum(-1)
        return torch.where(hits % 2 == 1, dist, -dist)

    def ray_trace(self, rays_o: torch.Tensor, rays_d: torch.Tensor):
        """First-hit positions [N,3] f32, face ids [N] (-1 = miss) and
        depths [N] (0 on a miss).  Ties go to the lowest face id."""
        o_all = rays_o.to(self.device, torch.float32)
        d_all = rays_d.to(self.device, torch.float32)
        n = o_all.shape[0]
        best_t = torch.full((n,), torch.inf, device=self.device)
        best_id = torch.full((n,), -1, dtype=torch.int64, device=self.device)
        for rows, t0, a, b, c in self._tiles(n, RAY_BLOCK):
            bt, bi = best_t[rows], best_id[rows]
            t = _ray_tri_t(o_all[rows, None, :], d_all[rows, None, :], a, b, c)
            tmin, amin = t.min(dim=-1)
            better = tmin < bt
            bt.copy_(torch.where(better, tmin, bt))
            bi.copy_(torch.where(better, amin + t0, bi))
        miss = ~torch.isfinite(best_t)
        fid = torch.where(miss, -1, best_id)
        t = torch.where(miss, 0.0, best_t)
        positions = o_all + t[:, None] * d_all
        return positions, fid, t
