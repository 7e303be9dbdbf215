"""Triangle-mesh queries: ray casting and signed distance.

Counterpart of ``tropical/ops/mesh_queries.py`` and of the JAX package's
host BVH (``tropical/utils/bvh_host.py``, ``tropical/csrc/bvh.cpp``):

- ``ray_trace``: Möller-Trumbore first hits (evaluation surface samples);
- ``unsigned_distance``: Ericson's closest point on a triangle;
- ``signed_distance``: positive inside, by the parity of the crossings of a
  fixed ray from each point (the training labels).

A mesh on a CUDA device is traced through a BVH built on the card in
``MeshQuery.__init__`` (the kernels of :mod:`tropical_torch.ops.bvh`).  A
mesh on the CPU is traced by brute force: every ray or point against every
triangle in [points x triangles] tiles, a running minimum (first hit, or
squared distance) or sum (crossings) carried over the triangle chunks.
These tiles (``first_hits_plain``, ``crossings_plain``, ``min_dist2_plain``)
are the plain versions the kernels are bitwise equal to on every mesh
``chip_smoke.py`` traces (their culling is conservative but for a sliver
seen edge-on, ``csrc/bvh.cu``): both round every operation alone, in one
order, the dot and cross products written out element by element (torch's
own may reduce or contract in another order on the card), on tiles of one
component each.
"""

from __future__ import annotations

import numpy as np
import torch

from tropical_torch.ops import bvh

# a tile of RAY_BLOCK x TRI_CHUNK pairs keeps each f32 temporary at 32 MiB
RAY_BLOCK = 8192
TRI_CHUNK = 1024
# the distance tile holds some ten [P, T, 3] temporaries: 48 MiB each
POINT_BLOCK = 4096
# the parity ray's direction, built in float32 as the JAX package builds it
_PARITY_DIR = np.asarray([0.5320963, 0.6418563, 0.55234 / 0.9], np.float32)
_PARITY_DIR = _PARITY_DIR / np.linalg.norm(_PARITY_DIR)


# A vector below is a tuple of its three components, each a tensor of one
# shape ([P, 1] for points, [1, T] for triangles), so that every operation
# is on contiguous [P, T] tiles and the arithmetic's order is written out.

def _sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def _axpy(a, b, s):
    """a + b * s, s a [P, T] tile."""
    return tuple(x + y * s for x, y in zip(a, b))


def _where(cond, a, b):
    return tuple(torch.where(cond, x, y) for x, y in zip(a, b))


def _dot(a, b):
    """(a.x b.x + a.y b.y) + a.z b.z."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    """a x b, each product rounded alone."""
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _closest_dist2(p, a, b, c):
    """Squared distance point -> triangle (Ericson, Real-Time Collision
    Detection 5.1.5) over [P, T] pair tiles, its cases applied in the JAX
    package's order: interior, edges BC, AC, AB, then vertices c, b, a.

    p: vector of [P, 1]; a, b, c: vectors of [1, T] -> [P, T]."""
    ab = _sub(b, a)
    ac = _sub(c, a)
    ap = _sub(p, a)
    d1 = _dot(ab, ap)
    d2 = _dot(ac, ap)

    bp = _sub(p, b)
    d3 = _dot(ab, bp)
    d4 = _dot(ac, bp)

    cp = _sub(p, c)
    d5 = _dot(ab, cp)
    d6 = _dot(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    def safe_div(x, y):
        return x / torch.where(y.abs() < 1e-30, 1e-30, y)

    # interior point
    denom = safe_div(torch.ones_like(va), va + vb + vc)
    v_in = vb * denom
    w_in = vc * denom
    closest = _axpy(_axpy(a, ab, v_in), ac, w_in)

    # edge BC
    w_bc = safe_div(d4 - d3, (d4 - d3) + (d5 - d6))
    on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    closest = _where(on_bc, _axpy(b, _sub(c, b), w_bc), closest)

    # edge AC
    w_ac = safe_div(d2, d2 - d6)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    closest = _where(on_ac, _axpy(a, ac, w_ac), closest)

    # edge AB
    w_ab = safe_div(d1, d1 - d3)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    closest = _where(on_ab, _axpy(a, ab, w_ab), closest)

    # vertices
    closest = _where((d6 >= 0) & (d5 <= d6), c, closest)
    closest = _where((d3 >= 0) & (d4 <= d3), b, closest)
    closest = _where((d1 <= 0) & (d2 <= 0), a, closest)

    diff = _sub(p, closest)
    return _dot(diff, diff)


def _ray_tri_t(o, d, a, b, c, eps: float = 1e-9):
    """Möller-Trumbore hit parameter t (inf on a miss).

    o, d: vectors of [P, 1]; a, b, c: vectors of [1, T] -> [P, T]."""
    e1 = _sub(b, a)
    e2 = _sub(c, a)
    h = _cross(d, e2)
    det = _dot(e1, h)
    inv = 1.0 / torch.where(det.abs() < eps, eps, det)
    s = _sub(o, a)
    u = _dot(s, h) * inv
    q = _cross(s, e1)
    v = _dot(d, q) * inv
    t = _dot(e2, q) * inv
    hit = (det.abs() > eps) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-6)
    return torch.where(hit, t, torch.inf)


def _rows(x: torch.Tensor, rows: slice):
    """The vector of rows ``rows`` of ``x`` [N, 3], components [P, 1]."""
    return tuple(x[rows, k, None] for k in range(3))


def _tiles(tris: torch.Tensor, n: int, block: int):
    """(row slice, first triangle of the chunk, the chunk's a, b, c as
    vectors of [1, T]) for every tile of ``block`` of ``n`` rows by
    TRI_CHUNK triangles."""
    comp = tris.permute(1, 2, 0).contiguous()  # [vertex, axis, T]
    for p0 in range(0, n, block):
        for t0 in range(0, tris.shape[0], TRI_CHUNK):
            a, b, c = (tuple(comp[k, x, None, t0:t0 + TRI_CHUNK]
                             for x in range(3)) for k in range(3))
            yield slice(p0, p0 + block), t0, a, b, c


def min_dist2_plain(tris: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """The least squared distance [N] f32 from each point [N, 3] to a
    triangle of ``tris`` [T, 3, 3] (+inf for none)."""
    best = torch.full((points.shape[0],), torch.inf, device=points.device)
    for rows, _, a, b, c in _tiles(tris, points.shape[0], POINT_BLOCK):
        d2 = _closest_dist2(_rows(points, rows), a, b, c)
        torch.minimum(best[rows], d2.amin(dim=-1), out=best[rows])
    return best


def crossings_plain(tris: torch.Tensor, points: torch.Tensor,
                    direction: torch.Tensor) -> torch.Tensor:
    """How many triangles [N] int64 the ray from each point along the one
    ``direction`` [3] crosses."""
    d = tuple(direction.reshape(1, 3)[:, k, None] for k in range(3))
    hits = torch.zeros(points.shape[0], dtype=torch.int64,
                       device=points.device)
    for rows, _, a, b, c in _tiles(tris, points.shape[0], POINT_BLOCK):
        t = _ray_tri_t(_rows(points, rows), d, a, b, c)
        hits[rows] += torch.isfinite(t).sum(-1)
    return hits


def first_hits_plain(tris: torch.Tensor, rays_o: torch.Tensor,
                     rays_d: torch.Tensor):
    """(t [N] f32, face id [N] int64) of each ray's first hit, +inf and -1
    on a miss; an equal t goes to the lowest face id."""
    n = rays_o.shape[0]
    best_t = torch.full((n,), torch.inf, device=rays_o.device)
    best_id = torch.full((n,), -1, dtype=torch.int64, device=rays_o.device)
    for rows, t0, a, b, c in _tiles(tris, n, RAY_BLOCK):
        bt, bi = best_t[rows], best_id[rows]
        t = _ray_tri_t(_rows(rays_o, rows), _rows(rays_d, rows), a, b, c)
        tmin, amin = t.min(dim=-1)
        better = tmin < bt
        bt.copy_(torch.where(better, tmin, bt))
        bi.copy_(torch.where(better, amin + t0, bi))
    return best_t, best_id


class MeshQuery:
    """A triangle mesh on a device, answering first-hit ray and (signed)
    distance queries: through a BVH built here on a CUDA device, by the
    plain tiles on the CPU."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray,
                 device: torch.device | str):
        vertices = torch.as_tensor(np.asarray(vertices, np.float32),
                                   device=device)
        faces = torch.as_tensor(np.asarray(faces, np.int64), device=device)
        self.tris = vertices[faces]  # [T, 3, 3]
        self.device = self.tris.device
        # anything but the CPU goes to the kernels, which raise off the card
        self.bvh = None if self.device.type == "cpu" else bvh.build(self.tris)

    def _points(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device, torch.float32).contiguous()

    def _min_dist2(self, p: torch.Tensor) -> torch.Tensor:
        if self.bvh is None:
            return min_dist2_plain(self.tris, p)
        return bvh.min_dist2(self.bvh, p)

    def unsigned_distance(self, points: torch.Tensor) -> torch.Tensor:
        """Distance [N] f32 from each point to the nearest triangle."""
        return self._min_dist2(self._points(points)).sqrt()

    def signed_distance(self, points: torch.Tensor) -> torch.Tensor:
        """Signed distance [N] f32, positive inside: the unsigned distance,
        with the sign of the parity of the crossings of a fixed ray."""
        p = self._points(points)
        dist = self._min_dist2(p).sqrt()
        d = torch.from_numpy(_PARITY_DIR).to(self.device)
        hits = (crossings_plain(self.tris, p, d) if self.bvh is None
                else bvh.crossings(self.bvh, p, d))
        return torch.where(hits % 2 == 1, dist, -dist)

    def ray_trace(self, rays_o: torch.Tensor, rays_d: torch.Tensor):
        """First-hit positions [N,3] f32, face ids [N] (-1 = miss) and
        depths [N] (0 on a miss).  Ties go to the lowest face id."""
        o_all, d_all = self._points(rays_o), self._points(rays_d)
        best_t, best_id = (
            first_hits_plain(self.tris, o_all, d_all) if self.bvh is None
            else bvh.first_hits(self.bvh, o_all, d_all))
        miss = ~torch.isfinite(best_t)
        fid = torch.where(miss, -1, best_id)
        t = torch.where(miss, 0.0, best_t)
        positions = o_all + t[:, None] * d_all
        return positions, fid, t
