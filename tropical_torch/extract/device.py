"""The device extraction engine: the flat path's subdivision loop on the card.

Counterpart of ``tropical/extract/device.py`` for ``force=True``: the
skeleton built on the card from the lattice forward (``"dist"``: the
Lipschitz-distance-pruned lattice with a local gradient bound, or
``"sign"``), then the 32 hidden-plane insertions and the final one, each
insertion a handful of kernels over packed sign words, with the counts on
the device.  The port's ``extract_skeleton`` and ``extract_faces`` finish.
The result equals the host engine's (``extract/subdivide.py``) wherever
both start from the same skeleton: the same vertices and edges, bit for
bit, in the same order.

What fixes the order, as in the JAX engine: every compaction is a prefix
sum (order-preserving), the future-sign prune is the scalar test
``LD >= idx`` on each edge's last differing column, and the connecting
edges are appended in (lo, hi) order after a stable sort.

Counts stay on the device.  A busy insertion makes one device-to-host
read, of one small count vector (``META``): the connecting edges it found,
the edges and vertices its prune keeps, and, per plane, the live edges
that plane splits and the live vertices it hits.  The next busy plane and
the next insertion's sizes come from those histograms, so idle planes are
skipped with no read, and no buffer has a capacity to overflow.  The
pools are compacted at every busy insertion, so every vertex is live: the
hit scan reads the vertices' strict words, and the JAX engine's per-edge
copies of them (EZ0/EZ1) have no counterpart.

The JAX engine groups the connecting-edge candidates by expanding each
into its 2^zeros region replicas; that count has no bound known before
the forward of the new vertices, and a buffer sized by it would need a
second read a step.  Here two candidates pair when their sign vectors are
compatible (every active column equal or zero in one of them; grid columns
by cell intervals), which is exactly when some replica of each coincides
(tests/test_torch_device_engine.py holds it against ``_expand_keys``), and
compatible candidates lie in neighbouring cells: the candidates are sorted
by cell, and each scans the 3 x 3 x 3 cells around its own.  Each pair is
found once, so no dedup is needed.

Each kernel (``csrc/device_engine.cu``) has its plain version here; a CPU
tensor takes the plain version, a CUDA tensor the kernel.

- K3 ``skeleton_mark``: ``skeleton_pool`` (the NaN-propagating max-pool
  of |grad sdf|, one launch an axis), ``skeleton_points`` (sign, zero and
  strict words of each lattice point and its keep flag),
  ``skeleton_edges`` (the lattice edges, axis-major, whose words differ,
  both ends kept), ``skeleton_squeeze`` (the order-preserving compaction);
- K4 ``split_step``: ``pack_words``, ``edge_words`` (``_edge_bits``),
  ``split_mark`` (the split bit test at plane idx), ``split_lerp``,
  ``split_override`` and ``split_append`` (the sign override, the new
  vertices' words, the left-edge rewrite and the right-edge append);
- K5 ``connect_step``: ``hit_mark``, ``candidates`` (region words through
  ``_grid_region_lut``, cell keys), ``connect_table`` (each cell column's
  range of sorted positions, and the rows in sorted order),
  ``connect_count`` / ``connect_fill`` (the pairs: compatible, sharing a
  zero plane (``__popc``), past the future-sign pre-filter),
  ``census_edges`` / ``census_vertices`` (the prune's survivors and the
  per-plane histograms) and ``compact_rows`` / ``compact_edges`` (the
  prune's compaction).

K2 (the lattice encode) is ``core/hashgrid.lattice_encode``.
"""

from __future__ import annotations

import ctypes
import time
from typing import NamedTuple

import numpy as np
import torch

from tropical_torch.core.hashgrid import compute_marks, lattice_tables
from tropical_torch.core.mlp import mlp_forward
from tropical_torch.core.net import lattice_features
from tropical_torch.ops import cuda_build, launches

R_COLS = 33  # (num_layers - 1) * num_hidden + 1 of the 3 x 16 architecture
D = 3
NW = 2       # 32-bit words covering the R_COLS columns
LUTN = 1024  # uniform cells of the grid-region lookup table
# the count vector a busy insertion reads: connecting edges, live old and
# appended edges, live vertices, then per plane the live edges it splits
# and the live vertices it hits
N_CONN, N_LIVE, N_USED, SPLIT, HIT = 0, 1, 2, 3, 3 + R_COLS
META = 3 + 2 * R_COLS
# the cell neighbourhood's (dx, dy) columns, in scan order
NEIGHBOURS = tuple((dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1))


# --- the JAX package's units, in torch ---------------------------------------

def _eps_sign(out: torch.Tensor, eps: float) -> torch.Tensor:
    s = torch.where(out > 0, 1, -1).to(torch.int32)
    return torch.where(out.abs() <= eps, 0, s)


def _to_i32(w: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> their int32 bit pattern."""
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def _pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """[N, R] bool -> [N, NW] int32: bit j of word w is column 32 w + j."""
    words = []
    for w in range(NW):
        blk = mask[:, 32 * w:32 * w + 32].to(torch.int64)
        sh = torch.arange(blk.shape[1], device=mask.device)
        words.append(_to_i32((blk << sh).sum(1)))
    return torch.stack(words, 1)


def _pack_out_words(out: torch.Tensor, eps: float):
    """[N, R] f32 -> (sign, zero, strict words), each [N, NW] int32: bit
    j of word w is ``out > 0``, ``|out| <= eps``, ``|out| < eps`` of column
    32 w + j.  (The JAX package's are [NW, N] uint32.)"""
    a = out.abs()
    return _pack_bits(out > 0), _pack_bits(a <= eps), _pack_bits(a < eps)


def _bit(words: torch.Tensor, col: int) -> torch.Tensor:
    """Bit ``col`` of [N, NW] int32 words -> [N] bool."""
    return ((words[:, col // 32] >> (col % 32)) & 1) > 0


def _high_bit(v: torch.Tensor) -> torch.Tensor:
    """Index of the highest set bit of each 32-bit word (int32 bits), -1
    for 0: frexp's exponent of the word's unsigned value, exact."""
    u = v.to(torch.int64) & 0xFFFFFFFF
    _, e = torch.frexp(u.double())
    return torch.where(u > 0, e.to(torch.int32) - 1, -1)


def _edge_bits(sbp, zbp, sbq, zbq):
    """Per-edge predicates from endpoint words ([K, NW] int32 each):
    (split words [K, NW], last differing column [K] int32).  Bit j of the
    split words: plane j splits the edge (both ends off the eps band, of
    opposite signs); the last differing column: the highest column whose
    eps-sign differs between the ends, -1 if none, so the future-sign
    prune at plane idx is ``ld >= idx``."""
    nz = ~zbp & ~zbq
    sdif = (sbp ^ sbq) & nz
    dif = (zbp ^ zbq) | sdif
    base = 32 * torch.arange(NW, device=dif.device, dtype=torch.int32)
    cand = torch.where(dif != 0, base + _high_bit(dif), -1)
    return sdif, cand.max(1).values


def _grid_region_lut(marks, base, xu, eps: float, K: int):
    """({0,1} on-no-plane mask, cell offset) per axis of unit-cube points
    ``xu`` [N, D]: offset = #marks < xu + eps, less one, through a uniform
    table ``base[j] = #marks < j / LUTN`` and ``K`` refinement reads (K the
    most marks in one table cell)."""
    q = xu + eps
    j = (q * LUTN).to(torch.int32).clamp(0, LUTN - 1)
    cnt = base[j.long()]
    Mm = marks.shape[0]
    start = cnt
    for t in range(K):
        pos = start + t
        mk = marks[torch.clamp(pos, max=Mm - 1).long()]
        cnt = cnt + ((pos < Mm) & (mk < q)).to(torch.int32)
    off = cnt - 1
    wrapped = torch.where(off < 0, off + Mm, off)
    mark_at = marks[wrapped.clamp(0, Mm - 1).long()]
    mask = ((mark_at - xu).abs() > eps).to(torch.int32)
    return mask, off


def _lut(marks: torch.Tensor) -> torch.Tensor:
    """``_grid_region_lut``'s table: #marks < j / LUTN, int32 [LUTN]."""
    grid = torch.arange(LUTN, dtype=marks.dtype, device=marks.device) / LUTN
    return torch.searchsorted(marks, grid).to(torch.int32)


def _lut_k(marks: np.ndarray) -> int:
    """The most marks in one of ``_grid_region_lut``'s table cells."""
    cell = np.clip((marks * LUTN).astype(np.int64), 0, LUTN - 1)
    return max(1, int(np.bincount(cell, minlength=LUTN).max()))


def _edges_from_sgn(sgn: torch.Tensor, M: int, keepv=None):
    """Axis-major lattice edges of the per-point rows ``sgn`` [M, M, M, C]:
    (mask, serial of the upper end, serial of the lower end), each
    [3 (M-1) M^2]; an edge is kept where its ends' rows differ (and, with
    ``keepv`` [M, M, M] bool, both ends are kept)."""
    ax = torch.arange(M, dtype=torch.int32, device=sgn.device)
    gx, gy, gz = torch.meshgrid(ax, ax, ax, indexing="ij")
    serial = gx * M * M + gy * M + gz
    masks, e_a, e_b = [], [], []
    for axis in range(3):
        sl_a = tuple(slice(1, None) if d == axis else slice(None)
                     for d in range(3))
        sl_b = tuple(slice(None, -1) if d == axis else slice(None)
                     for d in range(3))
        m = (sgn[sl_a] != sgn[sl_b]).any(-1)
        if keepv is not None:
            m = m & keepv[sl_a] & keepv[sl_b]
        masks.append(m.reshape(-1))
        e_a.append(serial[sl_a].reshape(-1))
        e_b.append(serial[sl_b].reshape(-1))
    return torch.cat(masks), torch.cat(e_a), torch.cat(e_b)


def _pool_axis(g: torch.Tensor, M: int, k: int, axis: int) -> torch.Tensor:
    """Max over the window [i - k, i + k] along ``axis`` of the [M^3]
    lattice values ``g``, clipped at the lattice's ends; NaN wins."""
    v = g.reshape(M, M, M)
    out = v.clone()
    for d in range(1, k + 1):
        for sign in (1, -1):
            sl_src = [slice(None)] * 3
            sl_dst = [slice(None)] * 3
            sl_src[axis] = slice(d, None) if sign > 0 else slice(None, -d)
            sl_dst[axis] = slice(None, -d) if sign > 0 else slice(d, None)
            out[tuple(sl_dst)] = torch.maximum(out[tuple(sl_dst)],
                                               v[tuple(sl_src)])
    return out.reshape(-1)


def _bound_cell(marks: np.ndarray) -> np.float32:
    """sqrt(3) * 2 * the widest cell, in the JAX package's f32 rounding."""
    return np.float32(np.float32(np.sqrt(3.0) * 2.0)
                      * np.float32(np.diff(marks).max()))


def _lipschitz_keepv(dist, gnorm, marks, k: int):
    """Keep mask of the lattice points [M, M, M] within the distance bound
    sqrt(3) * 2 * max_cell * max_grad of the surface, max_grad |grad sdf|
    max-pooled over the (2k+1)^3 neighbourhood (k <= 0: the global max)."""
    M = dist.shape[0]
    if k <= 0:
        gmax = gnorm.reshape(-1).max().expand(M ** 3)
    else:
        gmax = gnorm.reshape(-1)
        for axis in range(3):
            gmax = _pool_axis(gmax, M, k, axis)
    bc = float(_bound_cell(np.asarray(marks.cpu(), np.float32)))
    return dist <= (bc * gmax).reshape(M, M, M)


def _dist_pool_k(marks) -> int:
    """Index-space pooling radius covering the bound's world reach
    sqrt(3) * 2 * max_cell from any lattice plane; 0 (the global max) if a
    window would span more than 16 planes."""
    mk = np.asarray(marks, np.float64)
    if mk.size < 2:
        return 0
    reach = np.sqrt(3.0) * 2.0 * np.diff(mk).max()
    lo = np.searchsorted(mk, mk - reach, side="left")
    hi = np.searchsorted(mk, mk + reach, side="right") - 1
    i = np.arange(mk.size)
    k = int(max((i - lo).max(), (hi - i).max()))
    return k if k <= 16 else 0


# --- the skeleton's lattice forward -------------------------------------

def _mlp_tangents(net, feats: torch.Tensor, dfeats: torch.Tensor):
    """The gathered columns [N, R] and, for each tangent of the features
    (``dfeats`` [3, N, F]), the last column's derivative [N]: the MLP's
    forward with its linearisation, ReLU's derivative 0 where the
    pre-activation is <= 0."""
    weights = [l.weight for l in net.fc]
    biases = [l.bias for l in net.fc]
    x, ts, pre = feats, list(dfeats), []
    for i, (w, b) in enumerate(zip(weights, biases)):
        x = x @ w.T + b
        ts = [t @ w.T for t in ts]
        if i != len(weights) - 1:
            pre.append(x)
            on = x > 0
            ts = [torch.where(on, t, 0.0) for t in ts]
            x = torch.relu(x)
        else:
            pre.append(x[:, 1:] - x[:, :1])
            ts = [t[:, 1] - t[:, 0] for t in ts]
    return torch.cat(pre, dim=-1), ts


@torch.no_grad()
def _sdf_dist_grad_lattice(net, xw, yw, zw, tables=None, plain=False):
    """(gathered columns [N, R], |sdf| [N], |grad sdf| [N]) over the
    separable world lattice: the sdf is tanh of the last column, so its
    gradient is (1 - sdf^2) times the column's, from the encode's axis
    derivatives (``lattice_encode``) through the MLP's tangents."""
    feats, dfeats = lattice_features(net, xw, yw, zw, tables, need_grad=True,
                                     plain=plain)
    out, ts = _mlp_tangents(net, feats, dfeats)
    sd = torch.tanh(out[:, -1])
    gn = torch.linalg.vector_norm(torch.stack(ts, -1), dim=-1) * (
        1.0 - sd * sd)
    return out, sd.abs(), gn


# --- the kernels, and their plain versions -------------------------------

class Kernels:
    """``csrc/device_engine.cu``'s launch functions on one device.  Every
    launch function takes device pointers, ``long long`` integers and
    ``float`` scalars in its declared order, then the stream, and returns
    the count of kernels it launched (K3, K4 or K5), which the call
    records, or minus a CUDA error, which it raises.  ``device`` may be the
    CPU for a library built against the tests' CUDA emulation."""

    def __init__(self, lib: ctypes.CDLL, device: torch.device):
        self.lib = lib
        self.device = device

    def __call__(self, kernel: str, name: str, n: int, *args) -> None:
        if n <= 0:
            return
        fn = getattr(self.lib, f"{name}_launch")
        conv = []
        for a in args:
            if a is None or torch.is_tensor(a):
                if a is not None and (a.device != self.device
                                      or not a.is_contiguous()):
                    raise ValueError(f"{name}: a tensor on {a.device} (or "
                                     f"not contiguous); the kernels run on "
                                     f"{self.device}")
                conv.append(ctypes.c_void_p(None if a is None
                                            else a.data_ptr()))
            elif isinstance(a, float):
                conv.append(ctypes.c_float(a))
            else:
                conv.append(ctypes.c_longlong(int(a)))
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                stream = torch.cuda.current_stream(self.device).cuda_stream
                rc = fn(*conv, ctypes.c_void_p(stream))
        else:
            rc = fn(*conv, ctypes.c_void_p(None))
        if rc < 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                               f"{-rc}")
        launches.record(kernel, (int(n),), count=rc)


# ``kern=PLAIN``: the plain versions on any device (the card's comparisons)
PLAIN = "plain"
_KERNELS: dict = {}


def kernels(device: torch.device) -> Kernels:
    """The committed build's ``Kernels`` on a CUDA device."""
    if device.type != "cuda":
        raise ValueError(f"the device engine's kernels run on CUDA, not "
                         f"{device}")
    k = _KERNELS.get(device)
    if k is None:
        k = _KERNELS[device] = Kernels(cuda_build.load("device_engine"),
                                       device)
    return k


def _run(kern, device: torch.device) -> Kernels | None:
    """The kernels a stage launches: ``kern`` if given, else the committed
    build's on a CUDA device; None (the plain version) on the CPU or for
    ``PLAIN``."""
    if kern is PLAIN:
        return None
    if kern is not None:
        return kern
    return None if device.type == "cpu" else kernels(device)


def _i32(*shape, device) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device=device)


def _zeros32(*shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.int32, device=device)


# K3 skeleton_mark

def skeleton_pool(g: torch.Tensor, M: int, k: int, axis: int,
                  kern: Kernels | None = None) -> torch.Tensor:
    """``_pool_axis`` of the lattice values ``g`` [M^3]."""
    run = _run(kern, g.device)
    if run is None:
        return _pool_axis(g, M, k, axis)
    out = torch.empty_like(g)
    run("skeleton_mark", "skeleton_pool", g.numel(), g, out, M, k, axis)
    return out


def skeleton_points_plain(out, dq, gmax, bc: float, eps: float):
    sb, zb, sz = _pack_out_words(out, eps)
    if dq is None:
        keep = torch.ones(out.shape[0], dtype=torch.int32, device=out.device)
    else:
        keep = (dq <= bc * gmax).to(torch.int32)
    return sb, zb, sz, keep


def skeleton_points(out, dq, gmax, bc: float, eps: float,
                    kern: Kernels | None = None):
    """Each lattice point's (sign, zero, strict words [N, NW], keep flag
    [N] int32): keep = |sdf| <= bc * gmax (bc = ``_bound_cell``), or 1
    without ``dq`` (sign mode)."""
    run = _run(kern, out.device)
    if run is None:
        return skeleton_points_plain(out, dq, gmax, bc, eps)
    n = out.shape[0]
    sb, zb, sz = (_i32(n, NW, device=out.device) for _ in range(3))
    keep = _i32(n, device=out.device)
    run("skeleton_mark", "skeleton_points", n, out, dq, gmax, n, bc, eps,
        sb, zb, sz, keep)
    return sb, zb, sz, keep


def _canonical(sb, zb):
    """Words equal exactly where the eps-signs are: the zero words and
    the sign bits off the eps band."""
    return torch.cat([sb & ~zb, zb], 1)


def skeleton_edges_plain(sb, zb, keep, M: int):
    rows = _canonical(sb, zb).reshape(M, M, M, -1)
    mask, ea, eb = _edges_from_sgn(rows, M, keep.reshape(M, M, M) > 0)
    used = _zeros32(M ** 3, device=sb.device)
    used[ea[mask].long()] = 1
    used[eb[mask].long()] = 1
    return mask.to(torch.int32), used


def skeleton_edges(sb, zb, keep, M: int, kern: Kernels | None = None):
    """The lattice edges in ``_edges_from_sgn``'s axis-major order: (flag
    [3 (M-1) M^2] int32, 1 where the ends' eps-signs differ and both ends
    are kept; used [M^3] int32, 1 at the ends of a flagged edge)."""
    run = _run(kern, sb.device)
    if run is None:
        return skeleton_edges_plain(sb, zb, keep, M)
    ne = 3 * (M - 1) * M * M
    flags = _i32(ne, device=sb.device)
    used = _zeros32(M ** 3, device=sb.device)
    run("skeleton_mark", "skeleton_edges", ne, sb, zb, keep, M, flags, used)
    return flags, used


def _serials(M: int, device):
    """(upper, lower) end serials of every lattice edge, axis-major."""
    rows = torch.zeros((M, M, M, 1), dtype=torch.int32, device=device)
    _, ea, eb = _edges_from_sgn(rows, M)
    return ea, eb


def skeleton_squeeze_plain(ecum, ucum, marks, out, sb, zb, sz, M: int,
                           scale: float, n_edges: int, n_used: int):
    dev = out.device
    flags = torch.diff(ecum, prepend=ecum.new_zeros(1)) > 0
    used = torch.diff(ucum, prepend=ucum.new_zeros(1)) > 0
    ea, eb = _serials(M, dev)
    new_index = ucum - 1
    E = torch.stack([new_index[ea[flags].long()],
                     new_index[eb[flags].long()]], 1)
    v = torch.nonzero(used)[:, 0]
    xu = torch.stack([marks[v // (M * M)], marks[(v // M) % M], marks[v % M]],
                     -1)
    V = xu * (scale * 2) - scale
    return V, out[v], sb[v], zb[v], sz[v], E.to(torch.int32)


def skeleton_squeeze(ecum, ucum, marks, out, sb, zb, sz, M: int, scale: float,
                     n_edges: int, n_used: int, kern: Kernels | None = None):
    """The order-preserving compaction (``_squeeze_edges``): the flagged
    edges renumbered onto the used lattice points, and those points'
    world coordinates, outputs and words.  ``ecum`` / ``ucum``: inclusive
    prefix sums of the edge flags and used flags."""
    run = _run(kern, out.device)
    if run is None:
        return skeleton_squeeze_plain(ecum, ucum, marks, out, sb, zb, sz, M,
                                      scale, n_edges, n_used)
    dev = out.device
    V = torch.empty((n_used, 3), dtype=torch.float32, device=dev)
    OUT = torch.empty((n_used, R_COLS), dtype=torch.float32, device=dev)
    SB, ZB, SZ = (_i32(n_used, NW, device=dev) for _ in range(3))
    E = _i32(n_edges, 2, device=dev)
    run("skeleton_mark", "skeleton_squeeze", max(ecum.numel(), ucum.numel()),
        ecum, ucum, marks, out, sb, zb, sz, M, scale, V, OUT, SB, ZB, SZ, E)
    return V, OUT, SB, ZB, SZ, E


# K4 split_step

def pack_words(out: torch.Tensor, eps: float, kern: Kernels | None = None):
    """``_pack_out_words``: (sign, zero, strict words), each [N, NW]."""
    run = _run(kern, out.device)
    if run is None:
        return _pack_out_words(out, eps)
    n = out.shape[0]
    sb, zb, sz = (_i32(n, NW, device=out.device) for _ in range(3))
    run("split_step", "pack_words", n, out, n, eps, sb, zb, sz)
    return sb, zb, sz


def edge_words(E: torch.Tensor, SB, ZB, kern: Kernels | None = None):
    """``_edge_bits`` of each edge's ends: (split words [n, NW], last
    differing column [n])."""
    run = _run(kern, E.device)
    if run is None:
        p, q = E[:, 0].long(), E[:, 1].long()
        return _edge_bits(SB[p], ZB[p], SB[q], ZB[q])
    n = E.shape[0]
    eb, ld = _i32(n, NW, device=E.device), _i32(n, device=E.device)
    run("split_step", "edge_words", n, E, n, SB, ZB, eb, ld)
    return eb, ld


def split_mark(EB: torch.Tensor, idx: int, kern: Kernels | None = None):
    """1 where plane ``idx`` splits the edge (its split bit), int32 [n]."""
    run = _run(kern, EB.device)
    if run is None:
        return _bit(EB, idx).to(torch.int32)
    n = EB.shape[0]
    flags = _i32(n, device=EB.device)
    run("split_step", "split_mark", n, EB, n, idx, flags)
    return flags


def split_lerp_plain(E, cum, V, OUT, ZB, idx: int, n_split: int):
    lanes = torch.nonzero(torch.diff(cum, prepend=cum.new_zeros(1)) > 0)[:, 0]
    ce = E[lanes]
    a, b = ce[:, 0].long(), ce[:, 1].long()
    d0, d1 = OUT[a, idx][:, None], OUT[b, idx][:, None]
    # the host engine's lerp, op for op
    w = d0.abs() / (d1 - d0).abs()
    Vn = V[a] * (1 - w) + V[b] * w
    return lanes.to(torch.int32), ce, Vn, ZB[a] & ZB[b]


def split_lerp(E, cum, V, OUT, ZB, idx: int, n_split: int,
               kern: Kernels | None = None):
    """The split edges, in edge order (``cum``: inclusive prefix sum of
    ``split_mark``): (their lanes [S] int32, ends [S, 2], new vertices
    [S, 3] at the linear interpolation of plane ``idx``'s outputs, the
    ends' shared zero words [S, NW])."""
    run = _run(kern, E.device)
    if run is None:
        return split_lerp_plain(E, cum, V, OUT, ZB, idx, n_split)
    dev = E.device
    lanes, ce = _i32(n_split, device=dev), _i32(n_split, 2, device=dev)
    Vn = torch.empty((n_split, 3), dtype=torch.float32, device=dev)
    bz = _i32(n_split, NW, device=dev)
    run("split_step", "split_lerp", E.shape[0], E, cum, E.shape[0], V, OUT,
        ZB, idx, lanes, ce, Vn, bz)
    return lanes, ce, Vn, bz


def _override_mask(bz: torch.Tensor, idx: int) -> torch.Tensor:
    """[S, R] bool: the planes both ends lie on (columns < idx) and plane
    idx, which the new vertex must lie on."""
    cols = torch.arange(R_COLS, device=bz.device)
    both = torch.stack([_bit(bz, c) for c in range(R_COLS)], 1)
    return (both & (cols < idx)) | (cols == idx)


def split_override(OUTn: torch.Tensor, bz: torch.Tensor, idx: int, eps: float,
                   kern: Kernels | None = None) -> torch.Tensor:
    """1 (int32 [1]) if some new vertex's output on a plane of
    ``_override_mask`` is off the eps band (the sign override fires for
    the whole step), else 0."""
    run = _run(kern, OUTn.device)
    if run is None:
        b = _override_mask(bz, idx)
        return (b & (OUTn.abs() > eps)).any().to(torch.int32).reshape(1)
    viol = _zeros32(1, device=OUTn.device)
    run("split_step", "split_override", OUTn.shape[0], OUTn, bz,
        OUTn.shape[0], idx, eps, viol)
    return viol


def split_append_plain(OUTn, bz, viol, lanes, ce, E, EB, LD, SB, ZB, nV: int,
                       idx: int, eps: float, final: bool):
    S = OUTn.shape[0]
    fire = (viol[0] > 0) & _override_mask(bz, idx)
    OUTn.copy_(torch.where(fire, 0.0, OUTn))
    sbn, zbn, szn = _pack_out_words(OUTn, eps)
    new_ids = nV + torch.arange(S, dtype=torch.int32, device=OUTn.device)
    lanes_l = lanes.long()
    E[lanes_l, 1] = new_ids
    Er = torch.stack([ce[:, 1], new_ids], 1)
    if final:
        return sbn, zbn, szn, Er, None, None
    a, b = ce[:, 0].long(), ce[:, 1].long()
    EB[lanes_l], LD[lanes_l] = _edge_bits(SB[a], ZB[a], sbn, zbn)
    EBr, LDr = _edge_bits(SB[b], ZB[b], sbn, zbn)
    return sbn, zbn, szn, Er, EBr, LDr


def split_append(OUTn, bz, viol, lanes, ce, E, EB, LD, SB, ZB, nV: int,
                 idx: int, eps: float, final: bool,
                 kern: Kernels | None = None):
    """The sign override (``OUTn`` zeroed in place on the override's
    planes if ``viol``), the new vertices' words, the left edges rewritten
    in place to end at the new vertices (``E``, and but for the ``final``
    insertion ``EB`` / ``LD``), and the right edges (old second end, new
    vertex) with their split words and last differing columns."""
    run = _run(kern, OUTn.device)
    if run is None:
        return split_append_plain(OUTn, bz, viol, lanes, ce, E, EB, LD, SB,
                                  ZB, nV, idx, eps, final)
    dev, S = OUTn.device, OUTn.shape[0]
    sbn, zbn, szn = (_i32(S, NW, device=dev) for _ in range(3))
    Er = _i32(S, 2, device=dev)
    EBr = None if final else _i32(S, NW, device=dev)
    LDr = None if final else _i32(S, device=dev)
    run("split_step", "split_append", S, OUTn, bz, viol, lanes, ce, E,
        None if final else EB, None if final else LD, SB, ZB, S, nV, idx,
        eps, sbn, zbn, szn, Er, EBr, LDr)
    return sbn, zbn, szn, Er, EBr, LDr


# K5 connect_step

def hit_mark(SZ: torch.Tensor, idx: int, kern: Kernels | None = None):
    """1 where a vertex lies strictly inside plane ``idx``'s eps band."""
    run = _run(kern, SZ.device)
    if run is None:
        return _bit(SZ, idx).to(torch.int32)
    n = SZ.shape[0]
    flags = _i32(n, device=SZ.device)
    run("connect_step", "hit_mark", n, SZ, n, idx, flags)
    return flags


def _active(idx: int) -> int:
    """Bits of the active neuron columns (< idx) in word 0, as int32."""
    m = (1 << min(idx, 32)) - 1
    return m - 2 ** 32 if m >= 2 ** 31 else m


def _cell_key(go: torch.Tensor, M: int) -> torch.Tensor:
    """The cell key of packed region words: offsets + 1 in base M + 1."""
    o = [((go >> (9 * d)) & 511) for d in range(D)]
    return (o[0] * (M + 1) + o[1]) * (M + 1) + o[2]


def candidates_plain(Vx, SBx, ZBx, hcum, nV: int, n_split: int, n_hit: int,
                     idx: int, marks, lut, lut_k: int, eps: float,
                     scale: float):
    dev = Vx.device
    hits = torch.nonzero(torch.diff(hcum, prepend=hcum.new_zeros(1)) > 0)[:, 0]
    vid = torch.cat([nV + torch.arange(n_split, device=dev), hits])
    v = vid.long()
    xu = (Vx[v] + scale) / (scale * 2)
    g, o = _grid_region_lut(marks, lut, xu, eps, lut_k)
    act = _active(idx)
    zs = ZBx[v, 0] & act
    sbm = SBx[v, 0] & ~ZBx[v, 0] & act
    go = (o[:, 0] + 1) | ((o[:, 1] + 1) << 9) | ((o[:, 2] + 1) << 18)
    for d in range(D):
        go = go | ((g[:, d] == 0).to(torch.int32) << (27 + d))
    C = torch.stack([vid.to(torch.int32), zs, sbm, go.to(torch.int32)], 1)
    return C, _cell_key(C[:, 3], marks.shape[0])


def candidates(Vx, SBx, ZBx, hcum, nV: int, n_split: int, n_hit: int,
               idx: int, marks, lut, lut_k: int, eps: float, scale: float,
               kern: Kernels | None = None):
    """The connecting-edge candidates, the new vertices then the hit
    vertices in id order (``hcum``: inclusive prefix sum of ``hit_mark``):
    rows [S + H, 4] int32 (vertex id; zero bits and nonzero sign bits of
    the active neuron columns; 3 x 9-bit grid cell offset + 1 and the
    3-bit on-grid-plane mask at bit 27, ``_grid_region_lut``), and each
    row's cell key."""
    run = _run(kern, Vx.device)
    if run is None:
        return candidates_plain(Vx, SBx, ZBx, hcum, nV, n_split, n_hit, idx,
                                marks, lut, lut_k, eps, scale)
    dev = Vx.device
    n = n_split + n_hit
    C, key = _i32(n, 4, device=dev), _i32(n, device=dev)
    run("connect_step", "candidates", n_split + nV, Vx, SBx, ZBx, hcum, nV,
        n_split, idx, marks, marks.shape[0], lut, lut_k, eps, scale, C, key)
    return C, key


def _compatible(a, b, idx: int):
    """[P] bool: rows a, b ([P, 4] candidate rows) lie in a common region:
    no active neuron column of opposite signs, and each axis's cell sets
    ({off}, or {off - 1, off} on a grid plane) meet."""
    ok = ((a[:, 2] ^ b[:, 2]) & ~a[:, 1] & ~b[:, 1]) == 0
    for d in range(D):
        oa = (a[:, 3] >> (9 * d)) & 511
        ob = (b[:, 3] >> (9 * d)) & 511
        lo_a = oa - ((a[:, 3] >> (27 + d)) & 1)
        lo_b = ob - ((b[:, 3] >> (27 + d)) & 1)
        ok &= (lo_a <= ob) & (lo_b <= oa)
    return ok


def _popc(v: torch.Tensor) -> torch.Tensor:
    """Population count of 32-bit words (int32 bits)."""
    u = v.to(torch.int64) & 0xFFFFFFFF
    u = u - ((u >> 1) & 0x55555555)
    u = (u & 0x33333333) + ((u >> 2) & 0x33333333)
    u = (u + (u >> 4)) & 0x0F0F0F0F
    return ((u * 0x01010101) & 0xFFFFFFFF) >> 24


def _shares_plane(a, b):
    """[P] bool: the rows share a zero plane (a neuron column zero in
    both, or a grid plane both lie on at the same offset)."""
    shared = _popc(a[:, 1] & b[:, 1])
    both = (a[:, 3] >> 27) & (b[:, 3] >> 27)
    for d in range(D):
        same = (((a[:, 3] ^ b[:, 3]) >> (9 * d)) & 511) == 0
        shared = shared + ((((both >> d) & 1) > 0) & same)
    return shared >= 1


def _pairs_plain(C, skey, perm, SBx, ZBx, idx: int, M: int, final: bool):
    """Every tested pair in the kernels' scan order, and whether it is
    kept: (sorted position p of the first row, its neighbour column (0..8,
    ``NEIGHBOURS``' order), vertex ids a, b, kept)."""
    dev = C.device
    n = C.shape[0]
    rows = C[perm.long()]
    p = torch.arange(n, device=dev)
    o = [((rows[:, 3] >> (9 * d)) & 511).long() for d in range(D)]
    W = M + 1
    ps, qs = [], []
    for dx, dy in NEIGHBOURS:
        nx, ny = o[0] + dx, o[1] + dy
        ok = (nx >= 0) & (nx < W) & (ny >= 0) & (ny < W)
        lo_key = (nx * W + ny) * W + (o[2] - 1).clamp(min=0)
        hi_key = (nx * W + ny) * W + (o[2] + 1).clamp(max=W - 1)
        lo = torch.searchsorted(skey, lo_key.to(skey.dtype))
        hi = torch.searchsorted(skey, hi_key.to(skey.dtype), right=True)
        lo = torch.maximum(lo, p + 1)
        cnt = torch.where(ok, (hi - lo).clamp(min=0), 0)
        rp = torch.repeat_interleave(p, cnt)
        start = torch.repeat_interleave(lo, cnt)
        rank = torch.arange(rp.numel(), device=dev) - torch.repeat_interleave(
            torch.cumsum(cnt, 0) - cnt, cnt)
        ps.append(rp)
        qs.append(start + rank)
    # scan order: by row, then neighbour column, then position
    k = torch.cat([torch.full_like(x, i) for i, x in enumerate(ps)])
    ps, qs = torch.cat(ps), torch.cat(qs)
    order = torch.argsort(ps * (len(NEIGHBOURS) * (n + 1)) + k * (n + 1) + qs,
                          stable=True)
    ps, qs, k = ps[order], qs[order], k[order]
    a, b = rows[ps], rows[qs]
    keep = _compatible(a, b, idx) & _shares_plane(a, b)
    va, vb = a[:, 0].long(), b[:, 0].long()
    if not final:
        _, ld = _edge_bits(SBx[va], ZBx[va], SBx[vb], ZBx[vb])
        keep &= ld >= idx
    return ps, k, va, vb, keep


def connect_table_plain(C, skey, perm, M: int):
    W = M + 1
    base = torch.arange(W * W, device=C.device, dtype=skey.dtype) * W
    start = torch.searchsorted(skey, base).to(torch.int32)
    end = torch.searchsorted(skey, base + W).to(torch.int32)
    cols = torch.stack([start, end], 1)
    return torch.where((start == end)[:, None], 0, cols), C[perm.long()]


def connect_table(C, skey, perm, M: int, kern: Kernels | None = None):
    """The pair scan's column table: for each (x, y) column of the
    (M + 1)^2 cell grid, the [start, end) of its candidates' sorted
    positions ([(M + 1)^2, 2] int32, (0, 0) for an empty column), and the
    candidate rows in sorted order ``C[perm]`` [n, 4]."""
    run = _run(kern, C.device)
    if run is None:
        return connect_table_plain(C, skey, perm, M)
    n, W = C.shape[0], M + 1
    cols = _zeros32(W * W, 2, device=C.device)
    Cs = _i32(n, 4, device=C.device)
    run("connect_step", "connect_table", n, C, skey, perm, n, M, cols, Cs)
    return cols, Cs


def connect_count_plain(C, skey, perm, SBx, ZBx, idx, M, final, used, meta):
    ps, k, va, vb, keep = _pairs_plain(C, skey, perm, SBx, ZBx, idx, M,
                                       final)
    nc = len(NEIGHBOURS)
    cnt = torch.bincount((ps * nc + k)[keep], minlength=C.shape[0] * nc).to(
        torch.int32).reshape(-1, nc)
    if not final:
        used[va[keep]] = 1
        used[vb[keep]] = 1
        eb, _ = _edge_bits(SBx[va[keep]], ZBx[va[keep]], SBx[vb[keep]],
                           ZBx[vb[keep]])
        meta[SPLIT:SPLIT + R_COLS] += torch.stack(
            [_bit(eb, c).sum() for c in range(R_COLS)]).to(torch.int32)
    return cnt


def connect_count(C, skey, perm, cols, Cs, SBx, ZBx, idx: int, M: int,
                  final: bool, used, meta, kern: Kernels | None = None):
    """The connecting edges each candidate row finds in each of its 9
    neighbour columns, int32 [n, 9] by sorted position (row-major: scan
    order): the rows after it in the cells around its own that are
    compatible, share a zero plane and (but for the final insertion) pass
    the future-sign pre-filter.  But for the final insertion, also marks
    their ends in ``used`` and adds their split bits to ``meta``'s
    per-plane histogram.  The kernel reads ``connect_table``'s ``cols`` and
    ``Cs``; the plain version searches ``skey``."""
    run = _run(kern, C.device)
    if run is None:
        return connect_count_plain(C, skey, perm, SBx, ZBx, idx, M, final,
                                   used, meta)
    n = C.shape[0]
    cnt = _i32(n, len(NEIGHBOURS), device=C.device)
    run("connect_step", "connect_pairs", n, C, skey, perm, cols, Cs, n, SBx,
        ZBx, idx, M, int(final), cnt, None, None if final else used,
        None if final else meta, None)
    return cnt


def connect_fill(C, skey, perm, cols, Cs, SBx, ZBx, idx: int, M: int,
                 final: bool, ccum, n_conn: int,
                 kern: Kernels | None = None):
    """The connecting edges (lo, hi) [n_conn, 2] int32, in scan order at
    the slots of ``ccum`` (the inclusive prefix sum of ``connect_count``'s
    [n, 9] counts, flattened)."""
    run = _run(kern, C.device)
    if run is None:
        _, _, va, vb, keep = _pairs_plain(C, skey, perm, SBx, ZBx, idx, M,
                                          final)
        lo, hi = torch.minimum(va, vb)[keep], torch.maximum(va, vb)[keep]
        return torch.stack([lo, hi], 1).to(torch.int32)
    n = C.shape[0]
    pairs = _i32(n_conn, 2, device=C.device)
    run("connect_step", "connect_pairs", n, C, skey, perm, cols, Cs, n, SBx,
        ZBx, idx, M, int(final), None, ccum, None, None, pairs)
    return pairs


def census_edges_plain(E, EB, LD, Er, EBr, LDr, idx, used, meta):
    for e, ld, eb in ((E, LD, EB), (Er, LDr, EBr)):
        live = ld >= idx
        used[e[live].reshape(-1).long()] = 1
        meta[N_LIVE] += live.sum().to(torch.int32)
        meta[SPLIT:SPLIT + R_COLS] += torch.stack(
            [(_bit(eb, c) & live).sum() for c in range(R_COLS)]).to(
                torch.int32)


def census_edges(E, EB, LD, Er, EBr, LDr, idx: int, used, meta,
                 kern: Kernels | None = None) -> None:
    """The prune's census of the old (rewritten) and right edges: the
    live ones (``LD >= idx``) counted in ``meta``, their ends marked in
    ``used``, their split bits added to the per-plane histogram."""
    run = _run(kern, E.device)
    if run is None:
        return census_edges_plain(E, EB, LD, Er, EBr, LDr, idx, used, meta)
    n0, n1 = E.shape[0], Er.shape[0]
    run("connect_step", "census_edges", n0 + n1, E, EB, LD, n0, Er, EBr, LDr,
        n1, idx, used, meta)


def census_vertices(used, SZx, meta, kern: Kernels | None = None) -> None:
    """The live vertices counted in ``meta``, and the strict-zero bits of
    each added to the per-plane hit histogram."""
    run = _run(kern, used.device)
    if run is None:
        live = used > 0
        meta[N_USED] += live.sum().to(torch.int32)
        meta[HIT:HIT + R_COLS] += torch.stack(
            [(_bit(SZx, c) & live).sum() for c in range(R_COLS)]).to(
                torch.int32)
        return
    n = used.shape[0]
    run("connect_step", "census_vertices", n, used, SZx, n, meta)


def compact_rows(src: torch.Tensor, cum: torch.Tensor, n_out: int,
                 kern: Kernels | None = None) -> torch.Tensor:
    """The rows of ``src`` [n, ...] (any 4-byte type) whose flag is set,
    in order; ``cum`` the flags' inclusive prefix sum.  The kernel takes
    the outputs' pool (rows of 33 words) below 2^31 words."""
    run = _run(kern, src.device)
    if run is None:
        return src[torch.diff(cum, prepend=cum.new_zeros(1)) > 0]
    out = torch.empty((n_out,) + src.shape[1:], dtype=src.dtype,
                      device=src.device)
    n = src.shape[0]
    width = src[0].numel() if n else 1
    run("connect_step", "compact_rows", n, src.view(torch.int32) if
        src.dtype != torch.int32 else src, cum, n, width,
        out.view(torch.int32) if out.dtype != torch.int32 else out)
    return out


def compact_edges(E: torch.Tensor, cum: torch.Tensor, vcum: torch.Tensor,
                  n_out: int, kern: Kernels | None = None) -> torch.Tensor:
    """``compact_rows`` of the edges, their ends renumbered onto the kept
    vertices (``vcum``: the vertices' used flags' inclusive prefix sum)."""
    run = _run(kern, E.device)
    if run is None:
        keep = torch.diff(cum, prepend=cum.new_zeros(1)) > 0
        return (vcum[E[keep].long()] - 1).to(torch.int32)
    out = _i32(n_out, 2, device=E.device)
    run("connect_step", "compact_edges", E.shape[0], E, cum, vcum, E.shape[0],
        out)
    return out


# --- the engine -------------------------------------------------------------

class Pools(NamedTuple):
    """The live complex between insertions: every vertex is an end of an
    edge.  Words are int32 bit patterns, [n, NW]."""

    V: torch.Tensor    # [nV, 3] f32 world coordinates
    OUT: torch.Tensor  # [nV, R] f32 gathered columns
    SB: torch.Tensor   # sign words (out > 0)
    ZB: torch.Tensor   # zero words (|out| <= eps)
    SZ: torch.Tensor   # strict words (|out| < eps), the hit test
    E: torch.Tensor    # [nE, 2] int32
    EB: torch.Tensor   # [nE, NW] split words (_edge_bits)
    LD: torch.Tensor   # [nE] int32 last differing column


class Stats:
    """The loop's host reads and its busy insertions, for tooling."""

    def __init__(self):
        self.reads = 0
        self.busy = []       # (plane, splits, hits, connecting edges)
        self.t_skeleton = self.t_loop = self.t_faces = 0.0


LAST = Stats()


class Engine:
    """The flat path's subdivision loop for one net, on the net's device
    (``kern``: the kernels to launch; default the committed build on a
    CUDA device, the plain versions on the CPU)."""

    def __init__(self, net, eps: float = 1e-4, kern: Kernels | None = None,
                 stats: Stats | None = None):
        self.net = net
        self.eps = eps
        self.dev = net.device
        self.kern = PLAIN if kern is PLAIN else _run(kern, self.dev)
        self.stats = stats if stats is not None else Stats()
        mk = compute_marks(net.spec.grid)
        self.M = int(mk.shape[0])
        self.marks = net.marks
        self.lut = _lut(self.marks)
        self.lut_k = _lut_k(mk)
        self.dist_k = _dist_pool_k(mk)
        self.bc = float(_bound_cell(mk))
        self.n_hidden = (net.num_layers - 1) * net.num_hidden
        # pinned host memory for the one read an insertion makes
        self._host = torch.empty(META, dtype=torch.int32,
                                 pin_memory=self.dev.type == "cuda")

    def read(self, meta: torch.Tensor) -> np.ndarray:
        """The count vector, read to the host: the loop's only sync."""
        self.stats.reads += 1
        if self.dev.type != "cuda":
            return meta.numpy().copy()
        host = self._host[:meta.numel()]
        host.copy_(meta, non_blocking=True)
        torch.cuda.current_stream(self.dev).synchronize()
        return host.numpy().copy()

    # skeleton ---------------------------------------------------------------

    @torch.no_grad()
    def skeleton(self, mode: str = "dist"):
        """The initial skeleton on the device: the lattice forward (K2),
        then K3.  Returns (V, OUT, SB, ZB, SZ, E) compacted, or None
        without edges."""
        net, M, k = self.net, self.M, self.kern
        spec = net.spec
        aw = self.marks * (spec.scale * 2) - spec.scale
        tables = lattice_tables(spec.grid, net.enc.table.detach(), M ** 3)
        if mode == "dist":
            out, dq, gn = _sdf_dist_grad_lattice(net, aw, aw, aw, tables,
                                                 plain=k is PLAIN)
            if self.dist_k <= 0:
                gmax = gn.max().expand(M ** 3).contiguous()
            else:
                gmax = gn
                for axis in range(3):
                    gmax = skeleton_pool(gmax, M, self.dist_k, axis, kern=k)
        elif mode == "sign":
            feats = lattice_features(net, aw, aw, aw, tables,
                                     plain=k is PLAIN)
            out = mlp_forward([l.weight for l in net.fc],
                              [l.bias for l in net.fc], feats, gather=True,
                              eps=spec.eps)[1]
            dq = gmax = None
        else:
            raise ValueError(f"unknown skeleton mode {mode!r}")
        sb, zb, sz, keep = skeleton_points(out, dq, gmax, self.bc, self.eps,
                                           kern=k)
        flags, used = skeleton_edges(sb, zb, keep, M, kern=k)
        ecum = torch.cumsum(flags, 0, dtype=torch.int32)
        ucum = torch.cumsum(used, 0, dtype=torch.int32)
        n_edges, n_used = (int(x) for x in self.read(
            torch.stack([ecum[-1], ucum[-1]])))
        if n_edges == 0:
            return None
        return skeleton_squeeze(ecum, ucum, self.marks, out, sb, zb, sz, M,
                                spec.scale, n_edges, n_used, kern=k)

    # the loop ---------------------------------------------------------------

    def pools(self, V, OUT, E, words=None):
        """Pools of a starting complex (every vertex an edge's end), and
        its count vector (``META``, read)."""
        k = self.kern
        SB, ZB, SZ = words if words is not None else pack_words(
            OUT, self.eps, kern=k)
        E = E.to(torch.int32).contiguous()
        EB, LD = edge_words(E, SB, ZB, kern=k)
        meta = _zeros32(META, device=self.dev)
        used = _zeros32(V.shape[0], device=self.dev)
        census_edges(E, EB, LD, E[:0], EB[:0], LD[:0], -1, used, meta,
                     kern=k)
        census_vertices(used, SZ, meta, kern=k)
        return Pools(V, OUT, SB, ZB, SZ, E, EB, LD), self.read(meta)

    def _next(self, counts: np.ndarray, after: int) -> int:
        """The next busy hidden plane after ``after``, else the final one."""
        split = counts[SPLIT:SPLIT + R_COLS]
        for j in range(after + 1, self.n_hidden):
            if split[j] > 0:
                return j
        return self.n_hidden

    @torch.no_grad()
    def step(self, P: Pools, idx: int, n_split: int, n_hit: int,
             final: bool):
        """One busy insertion at plane ``idx`` (``n_split`` edges split,
        ``n_hit`` vertices hit, from the last count vector).  Returns the
        pruned pools and their count vector; the final insertion returns
        the unpruned (V, OUT, E) instead."""
        k, eps, dev = self.kern, self.eps, self.dev
        nV, nE = P.V.shape[0], P.E.shape[0]
        E, EB, LD = P.E.clone(), P.EB.clone(), P.LD.clone()
        # K4: split, lerp, forward, override, words, rewrite and append
        scum = torch.cumsum(split_mark(EB, idx, kern=k), 0, dtype=torch.int32)
        lanes, ce, Vn, bz = split_lerp(E, scum, P.V, P.OUT, P.ZB, idx,
                                       n_split, kern=k)
        OUTn = self.net.outputs(Vn)
        viol = split_override(OUTn, bz, idx, eps, kern=k)
        sbn, zbn, szn, Er, EBr, LDr = split_append(
            OUTn, bz, viol, lanes, ce, E, EB, LD, P.SB, P.ZB, nV, idx, eps,
            final, kern=k)
        Vx = torch.cat([P.V, Vn])
        SBx, ZBx = torch.cat([P.SB, sbn]), torch.cat([P.ZB, zbn])
        # K5: hits, candidates by cell, the pairs, the prune's census
        hcum = torch.cumsum(hit_mark(P.SZ, idx, kern=k), 0, dtype=torch.int32)
        C, key = candidates(Vx, SBx, ZBx, hcum, nV, n_split, n_hit, idx,
                            self.marks, self.lut, self.lut_k, eps,
                            self.net.spec.scale, kern=k)
        skey, perm = torch.sort(key, stable=True)
        perm = perm.to(torch.int32)
        cols, Cs = connect_table(C, skey, perm, self.M, kern=k)
        meta = _zeros32(META, device=dev)
        used = None if final else _zeros32(nV + n_split, device=dev)
        cnt = connect_count(C, skey, perm, cols, Cs, SBx, ZBx, idx, self.M,
                            final, used, meta, kern=k)
        ccum = torch.cumsum(cnt.reshape(-1), 0, dtype=torch.int32)
        if not final:
            census_edges(E, EB, LD, Er, EBr, LDr, idx, used, meta, kern=k)
            SZx = torch.cat([P.SZ, szn])
            census_vertices(used, SZx, meta, kern=k)
        if ccum.numel():
            meta[N_CONN] = ccum[-1]
        counts = self.read(meta)
        n_conn = int(counts[N_CONN])
        pairs = connect_fill(C, skey, perm, cols, Cs, SBx, ZBx, idx, self.M,
                             final, ccum, n_conn, kern=k)
        order = torch.sort(pairs[:, 0].long() << 32 | pairs[:, 1].long(),
                           stable=True).indices
        Ec = pairs[order]
        self.stats.busy.append((idx, n_split, n_hit, n_conn))
        OUTx = torch.cat([P.OUT, OUTn])
        if final:
            return Vx, OUTx, torch.cat([E, Er, Ec])
        EBc, LDc = edge_words(Ec, SBx, ZBx, kern=k)
        Ex = torch.cat([E, Er, Ec])
        EBx, LDx = torch.cat([EB, EBr, EBc]), torch.cat([LD, LDr, LDc])
        ecum = torch.cumsum((LDx >= idx).to(torch.int32), 0,
                            dtype=torch.int32)
        vcum = torch.cumsum(used, 0, dtype=torch.int32)
        n_keep = int(counts[N_LIVE]) + n_conn
        n_used = int(counts[N_USED])
        pools = Pools(compact_rows(Vx, vcum, n_used, kern=k),
                      compact_rows(OUTx, vcum, n_used, kern=k),
                      compact_rows(SBx, vcum, n_used, kern=k),
                      compact_rows(ZBx, vcum, n_used, kern=k),
                      compact_rows(SZx, vcum, n_used, kern=k),
                      compact_edges(Ex, ecum, vcum, n_keep, kern=k),
                      compact_rows(EBx, ecum, n_keep, kern=k),
                      compact_rows(LDx, ecum, n_keep, kern=k))
        return pools, counts

    def loop(self, P: Pools, counts: np.ndarray):
        """Every busy insertion from the pools on, skipping idle planes by
        the count vector's split histogram; returns the complex after the
        final insertion (V, OUT, E), unpruned."""
        idx = self._next(counts, -1)
        while idx < self.n_hidden:
            P, counts = self.step(P, idx, int(counts[SPLIT + idx]),
                                  int(counts[HIT + idx]), final=False)
            idx = self._next(counts, idx)
        fin = self.n_hidden
        if counts[SPLIT + fin] == 0:
            return P.V, P.OUT, P.E
        return self.step(P, fin, int(counts[SPLIT + fin]),
                         int(counts[HIT + fin]), final=True)


class _Clock:
    """Stage boundaries on the device's timeline (CUDA events, so marking
    one adds no sync) or the host clock on the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.marks = []
        self.mark()

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def spans(self) -> list:
        """Seconds between consecutive marks."""
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b) / 1e3
                    for a, b in zip(self.marks, self.marks[1:])]
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


def device_engine_supports(net) -> bool:
    """The engine packs R_COLS = 33 sign columns and 9-bit grid-cell
    offsets (at most 511 marks); any other net takes the host engine."""
    r = (net.num_layers - 1) * net.num_hidden + 1
    return r == R_COLS and int(net.marks.shape[0]) <= 511


def subpoly_device(net, d: int = 3, size: float = 1.2, eps: float = 1e-4,
                   verbose: bool = True, force: bool = True,
                   skeleton_mode: str = "auto"):
    """The flat path's extraction on the net's device: the skeleton
    (``skeleton_mode`` "dist", the default, or "sign"), the busy
    insertions, then the port's ``extract_skeleton`` and ``extract_faces``.

    Returns (face positions [T, 3, 3], vertices [V, 3], triangles [T, 3]),
    as ``subdivide.subpoly``; ``LAST`` keeps the run's reads, busy
    insertions and stage times."""
    from tropical_torch.extract import stats
    from tropical_torch.extract.faces import extract_faces, extract_skeleton
    from tropical_torch.extract.skeleton import get_hypercube

    if not force:
        raise NotImplementedError(
            "the device engine has the flat path only (force=True); the "
            "curved path waits for ROADMAP.md Queue 1 item 1 (stage 3b)")
    if not device_engine_supports(net):
        raise ValueError(
            f"the device engine takes {R_COLS}-column nets with at most 511 "
            f"marks (got {(net.num_layers - 1) * net.num_hidden + 1} columns, "
            f"{int(net.marks.shape[0])} marks); use engine='host'")
    mode = "dist" if skeleton_mode == "auto" else skeleton_mode
    global LAST
    LAST = Stats()
    eng = Engine(net, eps, stats=LAST)
    clock = _Clock(net.device)
    sk = eng.skeleton(mode)
    if sk is None:  # no lattice edge: the hypercube (subpoly.py:51-52)
        V, E, _ = get_hypercube(d, size, net.device)
        sk = (V, net.outputs(V), None, None, None, E)
    V, OUT, SB, ZB, SZ, E = sk
    P, counts = eng.pools(V, OUT, E, None if SB is None else (SB, ZB, SZ))
    clock.mark()
    V, OUT, E = eng.loop(P, counts)
    E = E.to(torch.int64)
    clock.mark()

    pre_v, pre_e = V.shape[0], E.shape[0]
    if verbose:
        print()
        print(f"# of vertices and edges = {pre_v}/{pre_e} => ", end="")
    V, E, v_idx = extract_skeleton(V, E, OUT, net, eps)
    dev = V.device
    if V.shape[0] == 0:
        if verbose:
            print("0/0, 0 faces", end=", ")
        stats.record(pre_v, pre_e, 0, 0, 0)
        return (torch.empty((0, 3, 3), dtype=torch.float32, device=dev), V,
                torch.empty((0, 3), dtype=torch.int64, device=dev))
    OUT = OUT[v_idx]
    if verbose:
        print(f"{V.shape[0]}/{E.shape[0]}", end=", ")
    faces, tris = extract_faces(V, E, net, OUT, eps)
    clock.mark()
    if verbose:
        print(f"{len(faces)} faces", end=", ")
    LAST.t_skeleton, LAST.t_loop, LAST.t_faces = clock.spans()
    stats.record(pre_v, pre_e, V.shape[0], E.shape[0], len(faces))
    return faces, V, tris
