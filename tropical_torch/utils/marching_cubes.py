"""Marching cubes with programmatically derived 256-case tables.

Counterpart of ``tropical/utils/marching_cubes.py``: the same table builder
(face-loop walk, a fixed convention on the 4-cut ambiguous face so
neighbouring cubes always agree; triangle normals point from the positive
inside toward the negative region) and the same topology pass, on torch
tensors on the net's device.  Vertices sit on grid edges at the linearly
interpolated zero crossing.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tropical_torch.utils.ply import Mesh

# corner c -> offset (bit0 = x, bit1 = y, bit2 = z)
_CORNER_OFF = np.stack([(np.arange(8) >> a) & 1 for a in range(3)],
                       axis=-1).astype(np.int64)  # [8, 3]

# 12 edges, axis-major: for each axis, the 4 corners with that bit clear
_EDGES = []  # (corner_lo, axis)
for _a in range(3):
    for _c in range(8):
        if not (_c >> _a) & 1:
            _EDGES.append((_c, _a))
_EDGE_LO = np.asarray([c for c, _ in _EDGES], np.int64)      # [12]
_EDGE_AXIS = np.asarray([a for _, a in _EDGES], np.int64)    # [12]
_EDGE_HI = _EDGE_LO | (1 << _EDGE_AXIS)
_EDGE_ID = {(int(c), int(a)): i for i, (c, a) in enumerate(_EDGES)}


def _face_cycles():
    """For each of the 6 faces: (4 corners in cyclic order, outward normal)."""
    faces = []
    for axis in range(3):
        u, v = [a for a in range(3) if a != axis]
        for side in range(2):
            cyc = []
            for du, dv in ((0, 0), (1, 0), (1, 1), (0, 1)):
                c = (side << axis) | (du << u) | (dv << v)
                cyc.append(c)
            fn = np.zeros(3)
            fn[axis] = 1.0 if side else -1.0
            faces.append((cyc, fn))
    return faces


_FACES = _face_cycles()


def _edge_of(ca: int, cb: int) -> int:
    lo, hi = min(ca, cb), max(ca, cb)
    axis = (lo ^ hi).bit_length() - 1
    return _EDGE_ID[(lo, axis)]


def _edge_mid(e: int) -> np.ndarray:
    return 0.5 * (_CORNER_OFF[_EDGE_LO[e]] + _CORNER_OFF[_EDGE_HI[e]])


def _case_loops(code: int):
    """Directed closed loops of cut-edge ids for one corner-sign code
    (bit c set = corner c inside).

    The isosurface's intersection with the cube surface is the oriented
    boundary of the inside region on that surface.  Per face, the segment
    bounding each maximal cyclic run of inside corners is DIRECTED so the
    inside lies to the left of the travel direction when viewed down the
    outward face normal (t = fn x s with s pointing from the segment toward
    the inside corners).  A neighbouring cube sees the same face with the
    opposite outward normal, so it directs the shared segment oppositely —
    orientation is globally consistent (each directed mesh edge appears
    exactly once) with no geometric normal estimation at all.
    """
    inside = [(code >> c) & 1 for c in range(8)]
    nxt: dict = {}
    for cyc, fn in _FACES:
        s = [inside[c] for c in cyc]
        cuts = [i for i in range(4) if s[i] != s[(i + 1) % 4]]
        if not cuts:
            continue
        for i in cuts:
            if s[(i + 1) % 4] != 1:
                continue  # the run after this cut is outside; handled once
            j = (i + 1) % 4
            run = [cyc[j]]
            while s[(j + 1) % 4] == 1:
                j = (j + 1) % 4
                run.append(cyc[j])
            ea = _edge_of(cyc[i], cyc[(i + 1) % 4])
            eb = _edge_of(cyc[j], cyc[(j + 1) % 4])
            ma, mb = _edge_mid(ea), _edge_mid(eb)
            m_in = _CORNER_OFF[run].mean(0)
            t = np.cross(fn, m_in - 0.5 * (ma + mb))
            if float((mb - ma) @ t) > 0:
                nxt[ea] = eb
            else:
                nxt[eb] = ea

    # each cut edge has exactly one outgoing and one incoming segment ->
    # the next-pointers decompose into disjoint directed cycles
    loops = []
    seen = set()
    for start in sorted(nxt):
        if start in seen:
            continue
        loop = [start]
        seen.add(start)
        cur = nxt[start]
        while cur != start:
            loop.append(cur)
            seen.add(cur)
            cur = nxt[cur]
        loops.append(loop)
    return loops


def _build_tables() -> Tuple[np.ndarray, np.ndarray]:
    """(tri_table [256, MAXT, 3] edge ids with -1 pad, ntris [256])."""
    all_tris = []
    for code in range(256):
        loops = _case_loops(code)
        tris = []
        for loop in loops:
            for k in range(1, len(loop) - 1):
                tris.append((loop[0], loop[k], loop[k + 1]))
        all_tris.append(tris)
    maxt = max(len(t) for t in all_tris)
    table = np.full((256, maxt, 3), -1, np.int64)
    ntris = np.zeros(256, np.int64)
    for code, tris in enumerate(all_tris):
        ntris[code] = len(tris)
        for i, t in enumerate(tris):
            table[code, i] = t
    return table, ntris


_TRI_TABLE, _NTRIS = _build_tables()


def marching_cubes(vals: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                   zs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero level set of ``vals`` [nx, ny, nz] over the rectilinear grid
    (xs, ys, zs); inside = vals > 0.  Returns (vertices [V,3] float64,
    triangles [F,3] int64) with per-edge-deduplicated vertices.
    """
    vals = vals.to(torch.float64)

    def fetch(pi, pj, pk, qi, qj, qk):
        return vals[pi, pj, pk], vals[qi, qj, qk]

    return _marching_cubes_core(vals > 0, xs, ys, zs, fetch)


def _marching_cubes_core(occ: torch.Tensor, xs, ys, zs, fetch
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = occ.device
    nx, ny, nz = occ.shape
    tri_table = torch.from_numpy(_TRI_TABLE).to(dev)
    ntris = torch.from_numpy(_NTRIS).to(dev)

    code = torch.zeros((nx - 1, ny - 1, nz - 1), dtype=torch.int64, device=dev)
    for c in range(8):
        dx, dy, dz = (int(v) for v in _CORNER_OFF[c])
        code |= (occ[dx:dx + nx - 1, dy:dy + ny - 1, dz:dz + nz - 1]
                 .to(torch.int64) << c)

    active = torch.nonzero(ntris[code.reshape(-1)] > 0).squeeze(1)
    if active.numel() == 0:
        return (torch.empty((0, 3), dtype=torch.float64, device=dev),
                torch.empty((0, 3), dtype=torch.int64, device=dev))
    acode = code.reshape(-1)[active]

    # cube base point (i, j, k) of each active cube
    ci = active // ((ny - 1) * (nz - 1))
    cj = (active // (nz - 1)) % (ny - 1)
    ck = active % (nz - 1)

    # triangles as (active-cube row, local edge id)
    tt = tri_table[acode]                      # [A, MAXT, 3]
    nt = ntris[acode]
    tri_mask = torch.arange(tt.shape[1], device=dev)[None, :] < nt[:, None]
    tri_edges = tt[tri_mask]                   # [F, 3] local edge ids
    cube_of_tri = torch.repeat_interleave(
        torch.arange(active.numel(), device=dev), nt)

    # global edge key = axis * npts + linear index of the edge's low point
    npts = nx * ny * nz
    lo_off = torch.from_numpy(_CORNER_OFF[_EDGE_LO]).to(dev)   # [12, 3]
    gi = ci[:, None] + lo_off[None, :, 0]
    gj = cj[:, None] + lo_off[None, :, 1]
    gk = ck[:, None] + lo_off[None, :, 2]
    gkey = (torch.from_numpy(_EDGE_AXIS).to(dev)[None, :] * npts
            + (gi * ny + gj) * nz + gk)        # [A, 12]

    tri_keys = torch.gather(gkey[cube_of_tri], 1, tri_edges)
    uniq, inv = torch.unique(tri_keys, return_inverse=True)

    # interpolate each unique crossing
    axis = uniq // npts
    lin = uniq % npts
    pi = lin // (ny * nz)
    pj = (lin // nz) % ny
    pk = lin % nz
    qi, qj, qk = (pi + (axis == 0).to(torch.int64),
                  pj + (axis == 1).to(torch.int64),
                  pk + (axis == 2).to(torch.int64))
    va, vb = fetch(pi, pj, pk, qi, qj, qk)
    t = va / (va - vb)
    pa = torch.stack([xs[pi], ys[pj], zs[pk]], -1).to(torch.float64)
    pb = torch.stack([xs[qi], ys[qj], zs[qk]], -1).to(torch.float64)
    verts = pa * (1 - t[:, None]) + pb * t[:, None]
    return verts, inv.reshape(-1, 3)


def _sdf_grid_vals(net, s: torch.Tensor, lin0: int, count: int) -> torch.Tensor:
    """SDF values at row-major linear indices [lin0, lin0+count) of the
    res^3 grid whose axis coordinates are ``s``."""
    res = s.shape[0]
    idx = lin0 + torch.arange(count, device=s.device)
    pts = torch.stack([s[idx // (res * res)], s[(idx // res) % res],
                       s[idx % res]], dim=-1)
    return net.sdf(pts)[:, 0]


# x-slab width in cubes: one slab's SDF sweep at res 512 is 17*512^2 points
SLAB = 16


def run_marching_cubes(net, res: int, canvas: float, R: float = 1.0) -> Mesh:
    """MC mesh of the net's zero level set on a res^3 grid over
    [-canvas, canvas]^3, vertices divided by the dataset scale R.

    The grid axis is ``np.linspace`` in float32, as on the JAX package's CPU
    path.  x-slabs of ``SLAB`` cubes bound the memory of one SDF sweep;
    slab-boundary duplicates (bitwise-identical positions) are merged at the
    end.
    """
    dev = net.device
    s = torch.from_numpy(np.linspace(-canvas, canvas, res,
                                     dtype=np.float32)).to(dev)
    all_verts, all_tris = [], []
    base = 0
    for x0 in range(0, res - 1, SLAB):
        x1 = min(res - 1, x0 + SLAB)
        nxs = x1 - x0 + 1
        vals = _sdf_grid_vals(net, s, x0 * res * res,
                              nxs * res * res).reshape(nxs, res, res)
        verts, tris = marching_cubes(vals, s[x0:x1 + 1], s, s)
        if verts.shape[0]:
            all_verts.append(verts)
            all_tris.append(tris + base)
            base += verts.shape[0]

    if not all_verts:
        return Mesh(np.empty((0, 3)), np.empty((0, 3), np.int64))
    verts = torch.cat(all_verts)
    tris = torch.cat(all_tris)
    uniq, inverse = torch.unique(verts, dim=0, return_inverse=True)
    return Mesh((uniq / R).cpu().numpy(), inverse[tris].cpu().numpy())
