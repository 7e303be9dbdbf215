"""The edge-subdivision extraction engine.

Counterpart of the exact host-orchestrated engine ``tropical/extract/
subdivide.py``.  Starting from the hash-grid skeleton, every neuron's folding
hypersurface is inserted in turn (the (L-1)*H hidden neurons, then the final
SDF plane); each insertion splits sign-crossing edges, adds connecting edges
among coplanar same-region vertices, and prunes edges whose endpoints share
identical future sign vectors.

The flat path (``force=True``) splits every edge at the linear
interpolation of its endpoint outputs.  The curved path (``force=False``,
the exact bi-/tri-linear correction) places the new vertex of each curved
edge (one spanning more than one axis, inside an earlier plane) at the
intersection of that plane's trilinear surface, the current one's and the
cube's x = z diagonal plane (``core/trilinear.py``; on the card the
``trilinear_roots`` kernel, one launch a step), rescues off-surface roots by
gradient descent and drops what still misses the surface
(``extract/failover.py``).

The Python loop orchestrates; every tensor (vertices, edges, cached outputs,
region bookkeeping) stays on the net's device.  Each order-defining step
(boolean-mask compaction, sorted unique, stable sort) keeps the JAX
package's order, so the output vertices come out in the same order.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch

from tropical_torch.core import regions as rg
from tropical_torch.core import trilinear as tl
from tropical_torch.core.ext import nonzero_last
from tropical_torch.extract import failover as fo
from tropical_torch.extract import stats
from tropical_torch.extract.common import host_region
from tropical_torch.extract.faces import extract_faces, extract_skeleton
from tropical_torch.extract.skeleton import get_hypercube, grid_skeleton
from tropical_torch.utils.profiling import Phases

PHASES = Phases()


def _curved_intersections(net, e_c: torch.Tensor, r_edges: torch.Tensor,
                          idx: int, eps: float, l: int, h: int):
    """New-vertex local coordinates [Nc, 3] of the curved edges ``e_c``
    [Nc, 2, 3] and their residuals d_new [Nc, 2] on the earlier plane and
    plane ``idx``; out-of-range rows keep coordinates outside [0, 1]."""
    # corner-cube outputs, each cube evaluated in one shared linear region
    d_corner = net.outputs(tl.corner_points(e_c).reshape(-1, 3), group=8)
    d_corner = d_corner.reshape(e_c.shape[0], 8, -1)       # [Nc, 8, R]

    # the last earlier plane each curved edge lies on
    inds = nonzero_last(r_edges[:, :idx])
    if inds.shape[0] != r_edges.shape[0]:
        bad = int((~r_edges[:, :idx].any(dim=1)).sum())
        raise RuntimeError(f"curved edges not on any earlier plane at "
                           f"{l}/{h}: {bad}/{r_edges.shape[0]}")
    plane = inds[:, 1]
    p = d_corner.gather(2, plane[:, None, None].expand(-1, 8, 1))[..., 0]
    q = d_corner[:, :, idx].contiguous()

    # intersection of the two surfaces on the x = z diagonal plane
    ints = tl.intersection_of_two_planes(p, q)

    cand = e_c[:, 0] * (1 - ints) + e_c[:, 1] * ints
    outs = net.outputs(cand)
    d_new = torch.stack([outs.gather(1, plane[:, None])[:, 0], outs[:, idx]],
                        dim=-1)

    # exclude no-intersection rows; rescue the rest by gradient descent
    gg = ((ints < 0) | (ints > 1)).any(-1)
    with PHASES("gd_rescue"):  # inside "curved"
        ints, d_new = fo.gradient_descent_failover(
            net, e_c, ints, d_new, gg, plane, idx, eps)
    if os.environ.get("TROPICAL_DEBUG"):
        # diagnostic only: report rows still off-surface after the rescue;
        # strict_check drops them from the complex either way
        fo.check_new_vertices_on_surface(ints, d_new, gg, eps, l, h, e_c=e_c)
    return ints, d_new


def subpoly_(vertices: torch.Tensor, edges: torch.Tensor, net, l: int, h: int,
             eps: float, outputs_: torch.Tensor | None = None,
             force: bool = False):
    """One hyperplane insertion: plane ``idx = l * H + h``.  ``force`` takes
    the flat path; the curved one drops its vertices off the surface."""
    if outputs_ is None:
        outputs_ = net.outputs(vertices)
    elif outputs_.shape[0] != vertices.shape[0]:
        raise ValueError("outputs_ and vertices disagree in length")

    idx = l * net.num_hidden + h
    outputs = outputs_[:, idx]

    # 1. subdivide edges: strict sign change, both endpoints off-plane
    d = outputs[edges]
    m = (d[:, 0] * d[:, 1]) < 0
    m &= (d[:, 0].abs() > eps) & (d[:, 1].abs() > eps)
    if not bool(m.any()):
        return vertices, edges, outputs_

    dm = d[m]
    edges_m = edges[m]
    e = vertices[edges_m]  # [N, 2, 3]

    # 1-1. linear interpolation weights
    w = dm[:, :1].abs() / (dm[:, 1:] - dm[:, :1]).abs()
    _regions, _offset = host_region(net, vertices, outputs_, eps)

    # 1-2. curved edges span more than one axis
    has_curved = False
    c = None
    if not force:
        c = ((e[:, 1] - e[:, 0]).abs() > eps).sum(-1) > 1
        has_curved = bool(c.any())
    if has_curved:
        fo.COUNTERS["curved_steps"] += 1
        regions_pair = _regions[edges_m[c]][:, :, 3:]      # [Nc, 2, R]
        r_edges = (regions_pair[:, 0] == 0) & (regions_pair[:, 1] == 0)
        with PHASES("curved"):
            ints, d_new = _curved_intersections(net, e[c], r_edges, idx, eps,
                                                l, h)
    else:
        ints = torch.zeros((0, 3), dtype=e.dtype, device=e.device)
        d_new = torch.zeros((1, 2), dtype=e.dtype, device=e.device)

    # 1-3. new vertices
    v_new = e[:, 0] * (1 - w) + e[:, 1] * w
    if has_curved:
        v_new[c] = e[c, 0] + ints * (e[c, 1] - e[c, 0])

    with PHASES("forward_new"):
        outputs_new = net.outputs(v_new)
    m_rgn, offset = host_region(net, v_new, outputs_new, eps)
    m_idx = offset.shape[1] + idx

    if fo.sign_override(edges_m, _regions, _offset, idx, outputs_new, eps):
        # re-region with the overridden outputs so new vertices sit exactly on
        # the planes of their parent edge and the current surface
        m_rgn, offset = host_region(net, v_new, outputs_new, eps)

    m_rgn, m_rgn_ = m_rgn[:, :m_idx], m_rgn[:, m_idx:]

    if not force:
        m, v_new, m_rgn, m_rgn_, offset, outputs_new = fo.strict_check(
            c, d_new, eps, idx, ints, m, m_rgn, m_rgn_, offset, outputs_new,
            has_curved, v_new, l, h)
        edges_m = edges[m]

    # 2. rewrite left edges in place; append right edges
    new_ids = vertices.shape[0] + torch.arange(
        v_new.shape[0], dtype=torch.int64, device=vertices.device)
    e_new = torch.stack([edges_m[:, 1], new_ids], dim=-1)
    edges = edges.clone()
    edges[m, 1] = new_ids

    # 3. connecting edges among coplanar same-region vertices, including old
    #    vertices the plane hits within eps
    h_idx = outputs_[:, idx].abs() < eps
    v_rgn = torch.cat([m_rgn, _regions[h_idx][:, :m_idx]], dim=0)
    v_off = torch.cat([offset, _offset[h_idx]], dim=0)
    v_ids = torch.cat([new_ids, torch.nonzero(h_idx).squeeze(1)], dim=0)

    with PHASES("edge_vertices"):
        pairs = rg.edge_vertices(v_rgn, v_off)
    c_new = v_ids[pairs]
    if c_new.numel():
        c_new = torch.unique(torch.sort(c_new, dim=1).values, dim=0)

    vertices = torch.cat([vertices, v_new], dim=0)
    edges = torch.cat([edges, e_new, c_new], dim=0)
    outputs_ = torch.cat([outputs_, outputs_new], dim=0)

    # 4. prune edges whose endpoints share identical future sign vectors
    if h < net.num_hidden:
        m_prn = torch.cat([_regions[:, m_idx:], m_rgn_], dim=0)
        with PHASES("prune_unique"):
            inv = rg.row_unique_inverse(m_prn)
        e_prn = inv[edges]
        edges = edges[e_prn[:, 0] != e_prn[:, 1]]

        v_idx, r_idx = torch.unique(edges.reshape(-1), return_inverse=True)
        vertices = vertices[v_idx]
        edges = r_idx.reshape(-1, 2)
        outputs_ = outputs_[v_idx]

    return vertices, edges, outputs_


def subpoly(net, d: int, size: float, eps: float = 1e-4, force: bool = False,
            verbose: bool = True, engine: str = "auto"
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full subdivision-polygons extraction on the net's device.

    Returns (face_positions [T,3,3], vertices [V,3], triangles [T,3]).
    ``force=True`` takes the flat path, ``force=False`` the curved one.

    ``engine``: "auto" takes the device engine (``extract/device.py``),
    on either path, for a net it supports, and this host-orchestrated loop
    otherwise; "host" / "device" force a choice.
    """
    from tropical_torch.extract import device as dv

    if engine not in ("auto", "host", "device"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "device" or (engine == "auto"
                              and dv.device_engine_supports(net)):
        return dv.subpoly_device(net, d, size, eps, verbose=verbose,
                                 force=force)
    fo.reset_counters()
    with PHASES("skeleton"):
        vertices, edges = grid_skeleton(net)
    if edges.shape[0] == 0:
        vertices, edges, _ = get_hypercube(d, size, net.device)

    outputs = None
    for l in range(net.num_layers - 1):
        for h in range(net.num_hidden):
            vertices, edges, outputs = subpoly_(
                vertices, edges, net, l, h, eps, outputs, force=force)

    vertices, edges, outputs = subpoly_(
        vertices, edges, net, net.num_layers - 2, net.num_hidden, eps, outputs,
        force=force)

    pre_v, pre_e = vertices.shape[0], edges.shape[0]
    if verbose:
        print()
        print(f"# of vertices and edges = {pre_v}/{pre_e} => ", end="")

    vertices, edges, v_idx = extract_skeleton(vertices, edges, outputs, net, eps)
    if vertices.shape[0] == 0:
        if verbose:
            print("0/0, 0 faces", end=", ")
        stats.record(pre_v, pre_e, 0, 0, 0)
        dev = vertices.device
        return (torch.empty((0, 3, 3), dtype=torch.float32, device=dev),
                vertices, torch.empty((0, 3), dtype=torch.int64, device=dev))
    outputs = outputs[v_idx]

    if verbose:
        print(f"{vertices.shape[0]}/{edges.shape[0]}", end=", ")

    with PHASES("extract_faces"):
        faces, tris = extract_faces(vertices, edges, net, outputs, eps)

    if verbose:
        print(f"{len(faces)} faces", end=", ")
    PHASES.report()
    stats.record(pre_v, pre_e, vertices.shape[0], edges.shape[0], len(faces))

    return faces, vertices, tris
