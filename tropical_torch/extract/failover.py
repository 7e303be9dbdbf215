"""Numerical failure recovery of the subdivision loop.

Counterpart of ``tropical/extract/failover.py``: the sign-vector override
(both paths), and for the curved path (``force=False``) the
gradient-descent rescue of missed trilinear intersections, the strict
on-surface filter, their event counters and the diagnostics.  These are
on-path mechanisms that change the output, not debug prints.
"""

from __future__ import annotations

import torch

# event totals of the most recent extraction (reset by ``subpoly``): curved
# rows with no in-range trilinear root (sentinels), rows the gradient-descent
# rescue optimized, and curved rows the strict filter dropped, counted as the
# JAX host engine counts them; and the insertion steps that had curved rows
# (each solves its intersections with one ``trilinear_roots`` launch on the
# card), and the rescue's descent steps (each one forward and one backward
# of the net).  All stay 0 on the flat path.
COUNTERS = {"sentinels": 0, "gd_rows": 0, "strict_drops": 0,
            "curved_steps": 0, "gd_steps": 0}


def reset_counters() -> None:
    for k in COUNTERS:
        COUNTERS[k] = 0


def _abs_max(t: torch.Tensor) -> float:
    """max |t|, 0 for an empty tensor (numpy's ``max(initial=0)``; torch's
    ``amax`` raises on an empty tensor)."""
    return float(t.abs().max()) if t.numel() else 0.0


def check_new_vertices_on_two_planes(edges_m, _regions, _offset, l, h, c, idx,
                                     verbose: bool = True) -> int:
    """Both endpoints of every curved edge must share >= 2 planes.  Returns
    the violation count."""
    m_rgn = _regions[edges_m][c][:, :, :3 + idx]
    offset = _offset[edges_m][c]
    chk = (m_rgn[:, 0] == 0) & (m_rgn[:, 1] == 0)
    chk[:, :3] &= offset[:, 0] == offset[:, 1]
    counts = chk.sum(-1)
    bad = int((counts < 2).sum())
    if bad and verbose:
        print("warning: two vertices of an edge must be on at least two "
              f"planes! {bad} / {counts.numel()} {l}/{h}")
    return bad


def check_planary_among_vertices(vertices, v_indices, null_value: int = -1,
                                 eps: float = 1e-4) -> int:
    """Region polygons must be planar.  Returns the number of non-planar
    region rows."""
    safe = torch.where(v_indices == null_value, 0, v_indices)
    points = vertices[safe]
    points[v_indices == null_value] = 0
    counts = (v_indices != null_value).sum(-1).tolist()
    bad = 0
    for r, k in enumerate(counts):
        if k < 4:
            continue
        p = points[r, :k]
        n = torch.linalg.cross(p[1] - p[0], p[2] - p[0])
        nn = torch.linalg.norm(n)
        if nn < 1e-12:
            continue
        n = n / nn
        for i in range(3, k):
            v = torch.linalg.cross(p[1] - p[0], p[i] - p[0])
            nv = torch.linalg.norm(v)
            if nv < 1e-12:
                continue
            if abs(float(torch.dot(n, v / nv))) < 1 - eps:
                bad += 1
                break
    return bad


def sign_override(edges_m: torch.Tensor, _regions: torch.Tensor,
                  _offset: torch.Tensor, idx: int, outputs_new: torch.Tensor,
                  eps: float) -> bool:
    """Force new vertices exactly onto the planes their parent edge lies on.

    If a new vertex's output on a plane shared by both parent endpoints (and,
    for grid planes, the same cell) exceeds eps, all such plane outputs are
    overridden to exactly 0 so later eps-sign-vector region tests do not
    fracture.  Mutates ``outputs_new`` in place; returns True if an override
    happened.
    """
    m_rgn = _regions[edges_m]          # [N, 2, 3+R]
    offset = _offset[edges_m]          # [N, 2, 3]
    m_chk = (m_rgn[:, 0] == 0) & (m_rgn[:, 1] == 0)
    m_chk[:, :3] &= offset[:, 0] == offset[:, 1]
    b = m_chk[:, 3:].clone()           # neuron-plane membership of the edge
    b[:, idx:] = False
    b[:, idx] = True                   # always pin the current surface
    if bool((outputs_new[b].abs() > eps).any()):
        outputs_new[b] = 0.0
        return True
    return False


def gradient_descent_failover(net, e_c: torch.Tensor, ints: torch.Tensor,
                              d_new: torch.Tensor, gg: torch.Tensor,
                              plane_cols: torch.Tensor, idx: int, eps: float,
                              max_iters: int = 500, lr: float = 1e-2):
    """Pull off-surface trilinear intersections back onto both surfaces.

    At most ``max_iters`` steps of normalized gradient descent on
    d0^2 + d1^2 over the local edge coordinates, clamped to [0, 1]^3, for
    the rows that are in range (not ``gg``) but off either surface; d0 is
    the output of the row's earlier plane ``plane_cols``, d1 that of plane
    ``idx``.  The loop stops once every such row is within eps of both.
    The residuals reported are those at the pre-update x of the last step,
    as in the JAX package.  Returns updated (ints, d_new).

    The stop test reads the residuals back to the host once a step; rows
    needing the rescue are rare on trained nets.
    """
    gd = ~gg & (d_new.abs() > eps).any(-1)
    n = int(gd.sum())
    COUNTERS["sentinels"] += int(gg.sum())
    COUNTERS["gd_rows"] += n
    if n == 0:
        return ints, d_new

    e0 = e_c[gd, 0]
    x, d0, d1 = descend(net, e0, e_c[gd, 1] - e0, plane_cols[gd], ints[gd],
                        idx, eps, max_iters, lr)
    ints = ints.clone()
    d_new = d_new.clone()
    ints[gd] = x
    d_new[gd] = torch.stack([d0, d1], dim=-1)
    return ints, d_new


def descend(net, e0: torch.Tensor, de: torch.Tensor, cols: torch.Tensor,
            x: torch.Tensor, idx: int, eps: float, max_iters: int = 500,
            lr: float = 1e-2, on_test=None):
    """``gradient_descent_failover``'s loop on its rows (start ``e0``,
    direction ``de``, earlier plane ``cols``, root ``x``): returns (x, d0,
    d1), the residuals at the pre-update x of the last step.  The stop
    test reads the residuals back to the host once a step but the first
    (all ones); ``on_test`` is called at each such read."""
    cols = cols.long()[:, None]
    d0 = d1 = torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    for i in range(max_iters):
        if i == 0:
            go = x.shape[0] > 0 and eps < 1.0
        else:
            if on_test is not None:
                on_test()
            go = bool(((d0.abs() > eps) | (d1.abs() > eps)).any())
        if not go:
            break
        COUNTERS["gd_steps"] += 1
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            outs = net(e0 + xx * de, gather=True, table_grad=False)[1]
            d0 = outs.gather(1, cols)[:, 0]
            d1 = outs[:, idx]
            (g,) = torch.autograd.grad((d0 * d0 + d1 * d1).sum(), xx)
        d0, d1 = d0.detach(), d1.detach()
        gn = g / torch.linalg.norm(g, dim=-1, keepdim=True).clamp_min(1e-12)
        x = (x - lr * gn).clamp(0.0, 1.0)
    return x, d0, d1


def check_new_vertices_on_surface(ints: torch.Tensor, d_new: torch.Tensor,
                                  gg: torch.Tensor, eps: float, l: int, h: int,
                                  e_c: torch.Tensor | None = None,
                                  verbose: bool = True) -> int:
    """Diagnostic: report curved intersections whose residuals exceed eps
    after the gradient-descent rescue (the strict filter downstream drops
    them either way).  Returns the number of off-surface rows among the
    in-range (not ``gg``) ones."""
    res = d_new[~gg].abs()
    bad = int((res > eps).any(-1).sum()) if res.numel() else 0
    if bad and verbose:
        worst = int(res.amax(-1).argmax())
        print(f"check if the below ints. d to be near-zeros "
              f"({float(res.max())} > {eps}) at {l}/{h}: {bad} rows")
        debug_report_idx(worst, ints[~gg], d_new[~gg],
                         e_c[~gg] if e_c is not None else None)
    return bad


def debug_report_idx(test_idx: int, ints: torch.Tensor, d_new: torch.Tensor,
                     e_c: torch.Tensor | None = None) -> None:
    """Print one offending curved row's state."""
    print("-------------------------------------------")
    print(f"test_idx: {test_idx}")
    print("local intersection coords:", ints[test_idx].tolist())
    print("residuals (d0, d1):", d_new[test_idx].tolist())
    if e_c is not None:
        print("edge endpoints:", e_c[test_idx].tolist())
    print("-------------------------------------------")


def strict_check(c: torch.Tensor, d_new: torch.Tensor, eps: float, idx: int,
                 ints: torch.Tensor, m: torch.Tensor, m_rgn: torch.Tensor,
                 m_rgn_: torch.Tensor, offset: torch.Tensor,
                 outputs_new: torch.Tensor, has_curved: bool,
                 v_new: torch.Tensor, l: int = -1, h: int = -1,
                 verbose: bool = False):
    """Drop new vertices that failed to land on the current surface.

    Off-surface vertices and curved rows whose trilinear root fell outside
    [0,1] (no intersection) are filtered out of every per-vertex array, and
    the edge mask ``m`` is updated to match.  Returns (m, v_new, m_rgn,
    m_rgn_, offset, outputs_new).
    """
    chk = outputs_new[:, idx]
    if (_abs_max(chk) >= eps) or (_abs_max(d_new[:, 0]) >= eps) \
            or has_curved:
        g = chk.abs() < eps

        gg = torch.zeros(0, dtype=torch.bool, device=g.device)
        if has_curved:
            gg = ((ints < 0) | (ints > 1)).any(-1)
            g[c] |= gg                      # permit for now (counted separately)
            d_new = d_new.clone()
            d_new[gg, 0] = 0

        if verbose and bool((~g).any()):
            print(f"\n{int((~g).sum())}/{g.numel()} new vertices are filtered "
                  f"at {l}/{h} ({_abs_max(chk[~g])}).")

        g1 = None
        if eps < _abs_max(d_new[:, 0]):
            g1 = d_new[:, 0].abs() < eps
            if verbose:
                print(f"\n{int((~g1).sum())}/{g1.numel()} old vertices are "
                      f"filtered at {l}/{h}.")

        if has_curved:
            gc = (chk[c].abs() < eps) & ~gg
            if g1 is not None:
                gc &= g1
            g[c] = gc
            COUNTERS["strict_drops"] += int((~gc).sum())

        m_out = m.clone()
        m_out[m] = g
        m = m_out
        v_new = v_new[g]
        m_rgn = m_rgn[g]
        m_rgn_ = m_rgn_[g]
        offset = offset[g]
        outputs_new = outputs_new[g]

    return m, v_new, m_rgn, m_rgn_, offset, outputs_new
