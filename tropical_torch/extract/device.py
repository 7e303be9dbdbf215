"""The device extraction engine: the subdivision loop on the card.

Counterpart of ``tropical/extract/device.py``, on the flat path
(``force=True``) and the curved one: the skeleton built on the card from
the lattice forward (``"dist"``: the Lipschitz-distance-pruned lattice with
a local gradient bound, or ``"sign"``), then the 32 hidden-plane insertions
and the final one, each insertion a handful of kernels over packed sign
words, with the counts on the device, then the final filter and the faces
(K6, ``Engine.faces``).  The result equals the host engine's
(``extract/subdivide.py``) wherever both start from the same skeleton: the
same vertices and edges, bit for bit, in the same order, and on the curved
path the same ``failover.COUNTERS``; the same faces but for the diagonals
of fans whose angular sort ties otherwise (the host faces sort in float64,
K6 in float32 around a fixed-point mean, as the JAX engine's device faces
do) and the order of the triangles.

The faces (the JAX engine's fused stage, ``make_extract_fn._run``
:1444-1772): the used vertices' 2^zeros region replicas as int64 keys (3 x
10 bits of grid cell + 2, 32 hidden neurons' sign bits), sorted (the
members of a region in (zero count, id) order), a region a run of equal
keys with its mean in 2^-22 fixed point, the duplicate regions (equal
member lists) found among the regions of equal signature (first member,
count), the normals at the kept regions' means (the encode's kernels),
then each polygon sorted by angle and fanned.  Two reads of the count
vector: after the filter and the replica count, after the fans' count.

The curved path (the JAX engine's stage 3b and strict filter) runs between
an insertion's split and its finish (``Engine._curved``): the curved rows
(a split edge whose ends differ in two or more coordinates) take the
trilinear intersection of their earlier plane's and the current plane's
surfaces on the cube's x = z plane (the corner forward, the root solve of
``trilinear_roots`` inside ``curved_roots``, the on-surface forward),
off-surface roots the gradient-descent rescue, and the strict filter keeps
the new vertices on the surface; the survivors take the ids nV + rank.
The forwards run on the host engine's rows in its order and batches, so
cuBLAS rounds them alike.  A curved busy insertion reads its count words
twice more than a flat one (the curved rows; the sentinels, rescued rows
and survivors), and with rescued rows once a rescue step but the first
and once more after it.

What fixes the order, as in the JAX engine: every compaction is a prefix
sum (order-preserving), the future-sign prune is the scalar test
``LD >= idx`` on each edge's last differing column, and the connecting
edges are appended in (lo, hi) order after a stable sort.

Counts stay on the device.  A busy insertion of the flat path makes one
device-to-host read, of one small count vector (``META``): the
connecting edges it found, the edges and vertices its prune keeps, and,
per plane, the live edges that plane splits and the live vertices it
hits.  The next busy plane and the next insertion's sizes come from
those histograms, so idle planes are skipped with no read, and no buffer
has a capacity to overflow.  The pools are compacted at every busy
insertion, so every vertex is live: the hit scan reads the vertices'
strict words, and the JAX engine's per-edge copies of them (EZ0/EZ1)
have no counterpart.

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
  of |grad sdf|, one launch an axis), ``skeleton_words`` (each lattice
  point's canonical words and keep flag), ``skeleton_flags`` (the lattice
  edges, axis-major, whose words differ, both ends kept, and the used
  points, as bit masks with block counts), ``skeleton_scan`` (the block
  counts' prefix sums) and ``skeleton_compact`` (the order-preserving
  compaction); its first design's stages ``skeleton_points``, ``_edges``,
  ``_cumsum`` and ``_squeeze`` run in a build of it alone;
- K4 ``split_step``: ``pack_words``, ``edge_words`` (``_edge_bits``),
  ``split_select`` (the edges plane idx splits, compacted in edge order by
  a decoupled look-back, and their lerp) and ``split_finish`` (two
  launches: the sign override's test, then the override, the new
  vertices' words, the left-edge rewrite and the right-edge append); its
  first design's stages ``split_mark`` (the split bit test),
  ``split_cumsum``, ``split_lerp``, ``split_override`` and
  ``split_append`` run in a build of it alone;
- K4c, the curved insertion: the curved rows (``split_select``'s curved
  instance: compacted in slot order with their planes, ends and corner
  points),
  ``curved_roots`` (K7's root solve on p and q gathered from the corner
  forward, and the roots' points), ``curved_resolve`` (``curved_gd``: the
  residuals, the sentinels and the rescue's rows, and the curved vertices
  and their states as if none were rescued; ``curved_mix``, after a
  rescue: the rescue taken back) and ``curved_filter`` (the override's
  test, then the strict filter and the survivors, compacted);
- K5 ``connect_step``: ``hit_mark``, ``candidates`` (region words through
  ``_grid_region_lut``, cell keys), ``connect_table`` (each cell column's
  range of sorted positions, and the rows in sorted order),
  ``connect_count`` / ``connect_fill`` (the pairs: compatible, sharing a
  zero plane (``__popc``), past the future-sign pre-filter),
  ``census_edges`` / ``census_vertices`` (the prune's survivors and the
  per-plane histograms) and ``compact_rows`` / ``compact_edges`` (the
  prune's compaction);
- K6 (``csrc/faces.cu``): ``final_keep`` (the keep flags and the ends of
  the edges and kept edges, one launch), ``face_keys``
  (``face_keys_count``: each used vertex's all-minus key, its zero columns
  and zero count; ``face_keys_fill``: its replicas), ``face_regions`` (the
  replicas grouped by key in a hash table, the regions ranked in
  signature order by their first member's vertex: their members, counts,
  means and kept flags), ``face_fans`` (``_count``: the triangles of each
  kept region; ``_fill``: the angular sort and the fan).

K2 (the lattice encode) is ``core/hashgrid.lattice_encode``.
"""

from __future__ import annotations

import ctypes
import time
from typing import NamedTuple

import numpy as np
import torch

from tropical_torch.core import trilinear as tl
from tropical_torch.core.hashgrid import compute_marks, lattice_tables
from tropical_torch.core.mlp import mlp_forward
from tropical_torch.core.net import lattice_features
from tropical_torch.extract import failover as fo
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


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., n] bool -> [..., ceil(n / 32)] int32: bit b of word w is item
    32 w + b ([N, R] columns -> [N, NW] words)."""
    pad = (-bits.shape[-1]) % 32
    b = torch.nn.functional.pad(bits.to(torch.int64), (0, pad))
    b = b.reshape(*bits.shape[:-1], -1, 32)
    return _to_i32((b << torch.arange(32, device=bits.device)).sum(-1))


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
    """``csrc/device_engine.cu``'s launch functions (with ``faces.cu``'s,
    which it includes) on one device.  Every launch function takes device
    pointers, ``long long`` integers and ``float`` scalars in its declared
    order, then the stream, and returns the count of kernels it launched
    (K3, K4, K4c, K5 or K6), which the call records, or minus a CUDA error,
    which it raises.  ``device`` may be the
    CPU for a library built against the tests' CUDA emulation."""

    def __init__(self, lib: ctypes.CDLL, device: torch.device):
        self.lib = lib
        self.device = device
        # a build of K3's, K4's or K6's first design takes its own stages
        self.first_skeleton = bool(lib.skeleton_first_design())
        self.first_split = bool(lib.split_first_design())
        self.first_faces = bool(lib.faces_first_design())
        self._table = None

    def region_table(self, n: int):
        """``face_regions``' hash table for ``n`` replicas: ([S, 8] int64,
        a 64-byte slot a row: its key, ``EMPTY_KEY`` where empty; as int32
        its first replica (INT_MAX where empty), its count (0), its
        overflow list's head (-1) and its first 11 replicas), log2 S), S
        the least power of two of at least 2 n and 1,024.  Empty when
        handed out: every launch clears the slots it filled.  Kept across
        calls, grown as needed."""
        bits = max(10, (2 * n - 1).bit_length())
        size = 1 << bits
        if self._table is None or self._table.shape[0] < size:
            empty = torch.tensor([EMPTY_KEY, 2 ** 31 - 1, 2 ** 32 - 1] +
                                 [0] * 5, dtype=torch.int64)
            self._table = empty.to(self.device).repeat(size, 1)
        return self._table[:size], bits

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

# skeleton_words' byte of a lattice point: column 32's canonical bits (0:
# sign off the eps band, 1: zero) and the keep flag
KEEP_BIT = 4
# skeleton_flags' block: 1,024 lattice points, 32 words of each mask
FLAG_BLOCK = 1024


def skeleton_pool(g: torch.Tensor, M: int, k: int, axis: int,
                  kern: Kernels | None = None) -> torch.Tensor:
    """``_pool_axis`` of the lattice values ``g`` [M^3]."""
    run = _run(kern, g.device)
    if run is None:
        return _pool_axis(g, M, k, axis)
    out = torch.empty_like(g)
    run("skeleton_mark", "skeleton_pool", g.numel(), g, out, M, k, axis)
    return out


def skeleton_words_plain(out, dq, g, M: int, k: int, bc: float, eps: float):
    sb, zb, _ = _pack_out_words(out, eps)
    cs = sb & ~zb
    W = torch.stack([cs[:, 0], zb[:, 0]], 1)
    X = (cs[:, 1] & 1) | (zb[:, 1] & 1) << 1
    if dq is None:
        X |= KEEP_BIT
    else:
        keep = dq <= bc * _pool_axis(g, M, k, 2)
        X |= torch.where(keep, KEEP_BIT, 0).to(X.dtype)
    return W, X.to(torch.uint8)


def skeleton_words(out, dq, g, M: int, k: int, bc: float, eps: float,
                   kern: Kernels | None = None):
    """Each lattice point's canonical columns, equal exactly where the
    eps-signs are: (W [N, 2] int32, columns 0-31's sign bits off the eps
    band and zero bits; X [N] uint8, column 32's two bits and the keep
    flag ``KEEP_BIT``: |sdf| <= bc * gmax (bc = ``_bound_cell``), gmax the
    last axis's max-pool (``_pool_axis`` along axis 2, radius ``k`` <= 16)
    of ``g``, or set without ``dq`` (sign mode)).  The kernel takes
    ``out`` 16-byte aligned."""
    run = _run(kern, out.device)
    if run is None:
        return skeleton_words_plain(out, dq, g, M, k, bc, eps)
    n = out.shape[0]
    W = _i32(n, 2, device=out.device)
    X = torch.empty(n, dtype=torch.uint8, device=out.device)
    run("skeleton_mark", "skeleton_words", n, out, dq, g, M, k, bc, eps, W, X)
    return W, X


def skeleton_flags_plain(W, X, M: int):
    n = M ** 3
    rows = torch.cat([W, (X & 3).to(torch.int32)[:, None]], 1)
    mask, ea, eb = _edges_from_sgn(rows.reshape(M, M, M, 3), M,
                                   ((X & KEEP_BIT) > 0).reshape(M, M, M))
    per = (M - 1) * M * M
    flags = torch.zeros((4, n), dtype=torch.bool, device=W.device)
    for axis in range(3):
        m = mask[axis * per:(axis + 1) * per]
        flags[axis, eb[axis * per:(axis + 1) * per][m].long()] = True
    flags[3, ea[mask].long()] = True
    flags[3, eb[mask].long()] = True
    masks = _pack_bits(flags)
    nw = masks.shape[1]
    nb = -(-nw // 32)
    counts = torch.nn.functional.pad(_popc(masks), (0, 32 * nb - nw))
    incl = torch.cumsum(counts.reshape(4, nb, 32), -1)
    pre = (incl.reshape(4, -1) - counts)[:, :nw]
    return masks, pre.to(torch.int32), incl[:, :, -1].to(torch.int32)


def skeleton_flags(W: torch.Tensor, X: torch.Tensor, M: int,
                   kern: Kernels | None = None):
    """The lattice edges whose canonical words differ, both ends kept, as
    bit masks by lattice point: (masks [4, ceil(M^3 / 32)] int32: bit p of
    row 0, 1, 2 flags the edge along axis 0, 1, 2 whose lower end is point
    p (``_edges_from_sgn``'s order, axis-major, an absent edge 0), row 3
    the used points, the ends of a flagged edge; pre, as masks: each
    word's popcount prefix within its block of ``FLAG_BLOCK`` points; cnt
    [4, blocks]: each block's popcounts)."""
    run = _run(kern, W.device)
    if run is None:
        return skeleton_flags_plain(W, X, M)
    n = M ** 3
    nw, nb = -(-n // 32), -(-n // FLAG_BLOCK)
    masks, pre = _i32(4, nw, device=W.device), _i32(4, nw, device=W.device)
    cnt = _i32(4, nb, device=W.device)
    run("skeleton_mark", "skeleton_flags", n, W, X, M, masks, pre, cnt)
    return masks, pre, cnt


def skeleton_scan_plain(cnt):
    edges, used = cnt[:3].reshape(-1), cnt[3]
    off = torch.cat([torch.cumsum(edges, 0) - edges,
                     torch.cumsum(used, 0) - used])
    tot = torch.stack([edges.sum(), used.sum()])
    return off.reshape(4, -1).to(torch.int32), tot.to(torch.int32)


def skeleton_scan(cnt: torch.Tensor, kern: Kernels | None = None):
    """(off [4, blocks]: the exclusive prefix sums of ``skeleton_flags``'
    block counts, the three edge rows as one sequence, axis-major, the
    used points' row as another; tot [2]: the edges and used points)."""
    run = _run(kern, cnt.device)
    if run is None:
        return skeleton_scan_plain(cnt)
    off, tot = _i32(*cnt.shape, device=cnt.device), _i32(2, device=cnt.device)
    run("skeleton_mark", "skeleton_scan", cnt.shape[1], cnt, cnt.shape[1], off,
        tot)
    return off, tot


def skeleton_compact_plain(masks, marks, out, M: int, scale: float,
                           eps: float):
    n = M ** 3
    bits = (masks[..., None] >> torch.arange(32, device=masks.device)) & 1
    bits = bits.reshape(4, -1)[:, :n] > 0
    rank = torch.cumsum(bits[3], 0) - 1
    E = []
    for axis, stride in enumerate((M * M, M, 1)):
        lo = torch.nonzero(bits[axis])[:, 0]
        E.append(torch.stack([rank[lo + stride], rank[lo]], 1))
    v = torch.nonzero(bits[3])[:, 0]
    xu = torch.stack([marks[v // (M * M)], marks[(v // M) % M], marks[v % M]],
                     -1)
    OUT = out[v]
    return (xu * (scale * 2) - scale, OUT, *_pack_out_words(OUT, eps),
            torch.cat(E).to(torch.int32))


def skeleton_compact(masks, pre, off, marks, out, M: int, scale: float,
                     eps: float, n_edges: int, n_used: int,
                     kern: Kernels | None = None):
    """The order-preserving compaction (``_squeeze_edges``): the flagged
    edges, axis-major, renumbered onto the used lattice points, and those
    points' world coordinates, outputs and words.  The kernel ranks an
    item by its block's offset (``off``), its word's prefix (``pre``) and
    the lower bits of its word; the plain version by prefix sums of the
    masks."""
    run = _run(kern, out.device)
    if run is None:
        return skeleton_compact_plain(masks, marks, out, M, scale, eps)
    dev = out.device
    V = torch.empty((n_used, 3), dtype=torch.float32, device=dev)
    OUT = torch.empty((n_used, R_COLS), dtype=torch.float32, device=dev)
    SB, ZB, SZ = (_i32(n_used, NW, device=dev) for _ in range(3))
    E = _i32(n_edges, 2, device=dev)
    run("skeleton_mark", "skeleton_compact", M ** 3, masks, pre, off, M, marks,
        out, scale, eps, V, OUT, SB, ZB, SZ, E)
    return V, OUT, SB, ZB, SZ, E


# K3's first design (a build with SKELETON_CUMSUM): its stages launch the
# kernels only, and its whole skeleton is held to the plain versions above

def skeleton_points(out, dq, gmax, bc: float, eps: float, kern: Kernels):
    """Each lattice point's (sign, zero, strict words [N, NW], keep flag
    [N] int32)."""
    n = out.shape[0]
    sb, zb, sz = (_i32(n, NW, device=out.device) for _ in range(3))
    keep = _i32(n, device=out.device)
    kern("skeleton_mark", "skeleton_points", n, out, dq, gmax, n, bc, eps,
         sb, zb, sz, keep)
    return sb, zb, sz, keep


def skeleton_edges(sb, zb, keep, M: int, kern: Kernels):
    """(flag [3 (M-1) M^2] int32, axis-major; used [M^3] int32)."""
    ne = 3 * (M - 1) * M * M
    flags = _i32(ne, device=sb.device)
    used = _zeros32(M ** 3, device=sb.device)
    kern("skeleton_mark", "skeleton_edges", ne, sb, zb, keep, M, flags, used)
    return flags, used


def skeleton_cumsum(flags, used):
    """The inclusive prefix sums of the edge and used flags, and their
    totals (torch.cumsum)."""
    ecum = torch.cumsum(flags, 0, dtype=torch.int32)
    ucum = torch.cumsum(used, 0, dtype=torch.int32)
    return ecum, ucum, torch.stack([ecum[-1], ucum[-1]])


def skeleton_squeeze(ecum, ucum, marks, out, sb, zb, sz, M: int, scale: float,
                     n_edges: int, n_used: int, kern: Kernels):
    """``skeleton_compact`` from the prefix sums."""
    dev = out.device
    V = torch.empty((n_used, 3), dtype=torch.float32, device=dev)
    OUT = torch.empty((n_used, R_COLS), dtype=torch.float32, device=dev)
    SB, ZB, SZ = (_i32(n_used, NW, device=dev) for _ in range(3))
    E = _i32(n_edges, 2, device=dev)
    kern("skeleton_mark", "skeleton_squeeze", max(ecum.numel(), ucum.numel()),
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


def split_select_plain(E, EB, V, OUT, ZB, idx: int, n_split: int):
    cum = torch.cumsum(_bit(EB, idx).to(torch.int32), 0, dtype=torch.int32)
    return split_lerp_plain(E, cum, V, OUT, ZB, idx, n_split)


def split_select(E, EB, V, OUT, ZB, idx: int, n_split: int,
                 eps: float | None = None, cw=None,
                 kern: Kernels | None = None):
    """The ``n_split`` edges plane ``idx`` splits (their split bit in
    ``EB``), in edge order: (their lanes [S] int32, ends [S, 2], new
    vertices [S, 3] at the linear interpolation of plane ``idx``'s outputs,
    the ends' shared zero words [S, NW]), as ``split_lerp`` of
    ``split_mark``'s prefix sum.  The kernel ranks the edges in one pass
    (ballots within a tile of 512, a decoupled look-back across tiles).
    Given the curved path's count words ``cw`` (and ``eps``), also the
    curved rows of the selection, as ``curved_select_plain`` of it:
    (slots, planes, ends, corners) after the four, counted into ``cw``;
    the kernel's curved instance selects them in the same pass (a second
    ballot and look-back), its outputs of the split rows' length.  (A
    build of K4c's first design launches the flat instance, then a
    selection pass of its own.)"""
    run = _run(kern, E.device)
    if run is None:
        sel = split_select_plain(E, EB, V, OUT, ZB, idx, n_split)
        if cw is None:
            return sel
        return sel + curved_select_plain(sel[1], sel[3], V, idx, eps, cw)
    dev, n = E.device, E.shape[0]
    lanes, ce = _i32(n_split, device=dev), _i32(n_split, 2, device=dev)
    Vn = torch.empty((n_split, 3), dtype=torch.float32, device=dev)
    bz = _i32(n_split, NW, device=dev)
    if cw is None:
        run("split_step", "split_select", n, E, EB, n, V, OUT, ZB, idx, lanes,
            ce, Vn, bz)
        return lanes, ce, Vn, bz
    qs, plane = _i32(n_split, device=dev), _i32(n_split, device=dev)
    e01 = torch.empty((n_split, 2, 3), dtype=torch.float32, device=dev)
    corners = torch.empty((n_split, 8, 3), dtype=torch.float32, device=dev)
    run("split_step", "split_select_curved", n, E, EB, n, n_split, V, OUT,
        ZB, idx, eps, lanes, ce, Vn, bz, qs, plane, e01, corners, cw)
    return lanes, ce, Vn, bz, qs, plane, e01, corners


def split_finish_plain(OUTn, bz, lanes, ce, E, EB, LD, SB, ZB, nV: int,
                       idx: int, eps: float, final: bool):
    viol = split_override_plain(OUTn, bz, idx, eps)
    return split_append_plain(OUTn, bz, viol, lanes, ce, E, EB, LD, SB, ZB,
                              nV, idx, eps, final)


def split_finish(OUTn, bz, lanes, ce, E, EB, LD, SB, ZB, nV: int, idx: int,
                 eps: float, final: bool, kern: Kernels | None = None,
                 survivors: bool = False):
    """``split_append`` after ``split_override``: the sign override
    (``OUTn`` zeroed in place on ``_override_mask``'s planes if any new
    vertex's output there is off the eps band), the new vertices' words,
    the left edges rewritten in place (``E``, and but for the ``final``
    insertion ``EB`` / ``LD``), and the right edges with their split words
    and last differing columns.  Two launches: the override's test (a
    whole-step any), then the rest from OUTn's rows staged by 16-byte
    loads (``OUTn`` 16-byte aligned).  ``survivors``: the rows are
    ``curved_filter``'s, which carry the override already, so the test
    cannot fire and the kernel's finish runs alone (one launch; a build
    of K4c's first design tests them all the same)."""
    run = _run(kern, OUTn.device)
    if run is None:
        return split_finish_plain(OUTn, bz, lanes, ce, E, EB, LD, SB, ZB, nV,
                                  idx, eps, final)
    dev, S = OUTn.device, OUTn.shape[0]
    sbn, zbn, szn = (_i32(S, NW, device=dev) for _ in range(3))
    Er = _i32(S, 2, device=dev)
    EBr = None if final else _i32(S, NW, device=dev)
    LDr = None if final else _i32(S, device=dev)
    run("split_step", "split_finish", S, OUTn, bz, lanes, ce, E,
        None if final else EB, None if final else LD, SB, ZB, S, nV, idx, eps,
        sbn, zbn, szn, Er, EBr, LDr, int(not survivors))
    return sbn, zbn, szn, Er, EBr, LDr


# K4's first design (a build with SPLIT_FOUR_PASS): four launches and a
# torch.cumsum; its stages' plain versions compose the design's

def split_mark(EB: torch.Tensor, idx: int, kern: Kernels | None = None):
    """1 where plane ``idx`` splits the edge (its split bit), int32 [n]."""
    run = _run(kern, EB.device)
    if run is None:
        return _bit(EB, idx).to(torch.int32)
    n = EB.shape[0]
    flags = _i32(n, device=EB.device)
    run("split_step", "split_mark", n, EB, n, idx, flags)
    return flags


def split_cumsum(flags: torch.Tensor) -> torch.Tensor:
    """The inclusive prefix sum of ``split_mark``'s flags (torch.cumsum)."""
    return torch.cumsum(flags, 0, dtype=torch.int32)


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
    """``split_select`` from ``cum``, the inclusive prefix sum of
    ``split_mark``."""
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


def split_override_plain(OUTn, bz, idx: int, eps: float) -> torch.Tensor:
    b = _override_mask(bz, idx)
    return (b & (OUTn.abs() > eps)).any().to(torch.int32).reshape(1)


def split_override(OUTn: torch.Tensor, bz: torch.Tensor, idx: int, eps: float,
                   kern: Kernels | None = None) -> torch.Tensor:
    """1 (int32 [1]) if some new vertex's output on a plane of
    ``_override_mask`` is off the eps band (the sign override fires for
    the whole step), else 0."""
    run = _run(kern, OUTn.device)
    if run is None:
        return split_override_plain(OUTn, bz, idx, eps)
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
    """``split_finish`` given ``split_override``'s ``viol``."""
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


# K4c curved_step: the curved insertion (force=False)

# the count words of a curved insertion (int32 [CW], zeroed): its curved
# rows and those on no earlier plane (read after the selection), its
# sentinel rows and the rows the gradient-descent rescue takes, whether a
# curved residual at the plane is off the eps band, its survivors and the
# curved rows the strict filter drops (read after ``curved_filter``)
CW_CURVED, CW_NOPLANE, CW_SENT, CW_GD, CW_ANYD0, CW_KEPT, CW_DROPS = range(7)
CW = 7
# a split row's state for the strict filter (``curved_gd``'s mix, and
# ``curved_mix``'s after a rescue): curved, its
# root out of [0, 1], its residual at the plane not inside the eps band
CV_CURVED, CV_GG, CV_OFF = 1, 2, 4


def _planes_below(bz: torch.Tensor, idx: int) -> torch.Tensor:
    """[S, R] bool: the columns below ``idx`` zero at both ends."""
    cols = torch.arange(R_COLS, device=bz.device)
    both = torch.stack([_bit(bz, c) for c in range(R_COLS)], 1)
    return both & (cols < idx)


def _out_of_range(t: torch.Tensor) -> torch.Tensor:
    return ((t < 0) | (t > 1)).any(-1)


def curved_select_plain(ce, bz, V, idx: int, eps: float, cw):
    """The curved rows of the ``split_select`` rows (ends ``ce``, shared
    zero words ``bz``): a row whose ends differ by more than ``eps`` in
    two or more coordinates, in slot order: (their slots, earlier planes
    (the highest column below ``idx`` zero at both ends), ends [n, 2, 3],
    corner points [n, 8, 3] (``core/trilinear.corner_points``)).  Counts
    the curved rows into ``cw[CW_CURVED]`` and those on no earlier plane
    into ``cw[CW_NOPLANE]``.  ``split_select``'s curved instance computes
    it in the selection's pass."""
    e = torch.stack([V[ce[:, 0].long()], V[ce[:, 1].long()]], 1)
    curved = ((e[:, 1] - e[:, 0]).abs() > eps).sum(-1) > 1
    below = _planes_below(bz, idx)
    # the last earlier plane (nonzero_last's), -1 for none
    plane = R_COLS - 1 - torch.argmax(below.flip(1).to(torch.uint8), 1)
    plane = torch.where(below.any(1), plane, -1)
    qs = torch.nonzero(curved)[:, 0]
    cw[CW_CURVED] += qs.numel()
    cw[CW_NOPLANE] += (curved & ~below.any(1)).sum().to(torch.int32)
    ec = e[qs]
    return (qs.to(torch.int32), plane[qs].to(torch.int32), ec,
            tl.corner_points(ec))


def curved_roots_plain(d_corner, plane, e01, idx: int):
    """The roots ``ints`` [n, 3] of K7 on p, the corner forward's columns at
    each row's plane, and q, at ``idx`` ([n, 8] each), and their points on
    the rows' edges, e0 (1 - t) + e1 t."""
    cols = torch.stack([plane.long(), torch.full_like(plane.long(), idx)], 1)
    pq = d_corner.gather(2, cols[:, None, :].expand(-1, 8, 2))
    ints = tl.intersection_of_two_planes_plain(pq[..., 0].contiguous(),
                                               pq[..., 1].contiguous())
    return ints, e01[:, 0] * (1 - ints) + e01[:, 1] * ints


def curved_roots(d_corner, plane, e01, idx: int, kern: Kernels | None = None):
    """The curved rows' roots and their points (``curved_roots_plain``)
    from the corner forward ``d_corner`` [n, 8, R]: (ints, cand), [n, 3]
    each.  One launch: K7's kernel (``csrc/trilinear_roots.cuh``) reading
    its rows from ``d_corner`` and writing each root's point beside it
    (K4c's first design: ``curved_pick`` into the scratch rows ``pq``, K7
    and ``curved_points``)."""
    run = _run(kern, d_corner.device)
    if run is None:
        return curved_roots_plain(d_corner, plane, e01, idx)
    dev, n = d_corner.device, d_corner.shape[0]
    ints, cand = (torch.empty((n, 3), dtype=torch.float32, device=dev)
                  for _ in range(2))
    pq = torch.empty((2, n, 8), dtype=torch.float32, device=dev)
    run("curved_roots", "curved_roots", n, d_corner, plane, e01, n, idx, ints,
        cand, pq[0], pq[1])
    return ints, cand


def curved_gd_plain(outs, plane, ints, e01, idx: int, eps: float, cw):
    d0 = outs.gather(1, plane.long()[:, None])[:, 0]
    d1 = outs[:, idx]
    gg = _out_of_range(ints)
    gd = ~gg & ((d0.abs() > eps) | (d1.abs() > eps))
    g = torch.nonzero(gd)[:, 0]
    grank = torch.full_like(plane, -1)
    grank[g] = torch.arange(g.numel(), dtype=grank.dtype, device=g.device)
    cw[CW_SENT] += gg.sum().to(torch.int32)
    cw[CW_GD] += g.numel()
    ge0 = e01[g, 0]
    return (torch.stack([d0, d1], 1), grank, ge0, e01[g, 1] - ge0,
            plane[g], ints[g])


def curved_gd(outs, plane, ints, e01, qs, idx: int, eps: float, Vn, cstate,
              cw, kern: Kernels | None = None):
    """After the on-surface forward ``outs`` [n, R] of the roots' points:
    (the residuals at the plane and at ``idx`` [n, 2]; each row's rank
    among the rows the rescue takes, else -1; those rows' start e0,
    direction e1 - e0, plane and root), the rescue's rows in row order:
    in range (no coordinate of the root outside [0, 1]) and off either
    surface.  Counts the sentinel rows (out of range) into ``cw[CW_SENT]``
    and the rescue's into ``cw[CW_GD]``; the kernel's rescue rows have the
    curved rows' length, the first ``cw[CW_GD]`` set.  Also mixes every
    row as ``curved_mix`` would if none were rescued (its vertex into
    ``Vn`` at its slot ``qs``, its state into ``cstate``,
    ``cw[CW_ANYD0]``), so that without a rescue no mix follows.  One
    launch."""
    run = _run(kern, outs.device)
    if run is None:
        res = curved_gd_plain(outs, plane, ints, e01, idx, eps, cw)
        curved_mix_plain(qs, e01, ints, res[0], res[1], None, None, eps, Vn,
                         cstate, cw)
        return res
    dev, n = outs.device, outs.shape[0]
    dnew = torch.empty((n, 2), dtype=torch.float32, device=dev)
    grank, gcols = _i32(n, device=dev), _i32(n, device=dev)
    ge0, gde, gx = (torch.empty((n, 3), dtype=torch.float32, device=dev)
                    for _ in range(3))
    run("curved_resolve", "curved_gd", n, outs, plane, ints, e01, qs, n, idx,
        eps, dnew, grank, ge0, gde, gcols, gx, Vn, cstate, cw)
    return dnew, grank, ge0, gde, gcols, gx


def curved_mix_plain(qs, e01, ints, dnew, grank, gx, gd0, eps: float, Vn,
                     cstate, cw):
    t, d0 = ints.clone(), dnew[:, 0].clone()
    sel = grank >= 0
    if gx is not None:
        t[sel] = gx[grank[sel].long()]
        d0[sel] = gd0[grank[sel].long()]
    gg = _out_of_range(t)
    d0 = torch.where(gg, 0.0, d0)
    s = qs.long()
    Vn[s] = e01[:, 0] + t * (e01[:, 1] - e01[:, 0])
    cstate[s] = (CV_CURVED + torch.where(gg, CV_GG, 0)
                 + torch.where(d0.abs() < eps, 0, CV_OFF)).to(torch.int32)
    cw[CW_ANYD0] |= (d0.abs() > eps).any().to(torch.int32)


def curved_mix(qs, e01, ints, dnew, grank, gx, gd0, eps: float, Vn, cstate,
               cw, kern: Kernels | None = None) -> None:
    """After the rescue (``gx``, ``gd0``: its rows' final roots and their
    residuals at the plane; None: no row rescued, as ``curved_gd`` mixes
    the rows): each curved row's root and residual taken back, its vertex
    e0 + t (e1 - e0) written into ``Vn`` at its slot ``qs`` over the lerp,
    and its state (``CV_*``; a row out of range takes residual 0) into
    ``cstate``; ``cw[CW_ANYD0]`` set if a curved residual at the plane is
    off the eps band."""
    run = _run(kern, Vn.device)
    if run is None:
        return curved_mix_plain(qs, e01, ints, dnew, grank, gx, gd0, eps, Vn,
                                cstate, cw)
    n = qs.shape[0]
    run("curved_resolve", "curved_mix", n, qs, e01, ints, dnew, grank, gx,
        gd0, n, eps, Vn, cstate, cw)


def curved_filter_plain(OUTn, bz, lanes, ce, Vn, cstate, idx: int,
                        eps: float, cw):
    viol = split_override_plain(OUTn, bz, idx, eps)
    OUTo = torch.where((viol[0] > 0) & _override_mask(bz, idx), 0.0, OUTn)
    on = OUTo[:, idx].abs() < eps
    curved = (cstate & CV_CURVED) > 0
    ok = (((cstate & CV_GG) == 0)
          & (((cstate & CV_OFF) == 0) | (cw[CW_ANYD0] == 0)))
    keep = torch.where(curved, on & ok, on)
    cw[CW_KEPT] += keep.sum().to(torch.int32)
    cw[CW_DROPS] += (curved & ~keep).sum().to(torch.int32)
    k = torch.nonzero(keep)[:, 0]
    return Vn[k], OUTo[k], bz[k], lanes[k], ce[k]


def curved_filter(OUTn, bz, lanes, ce, Vn, cstate, idx: int, eps: float, cw,
                  kern: Kernels | None = None):
    """The strict filter of the split rows after the forward ``OUTn`` of
    their vertices ``Vn``: the sign override's test (``split_override``),
    then the survivors in slot order, (vertices, outputs with the override
    applied where it fired, shared zero words, lanes, ends), for
    ``split_finish``.  A flat row survives on the surface at ``idx``
    (|out| < eps); a curved one on it, in range, and with its residual at
    the plane inside the eps band if any curved residual is off it.
    Counts the survivors into ``cw[CW_KEPT]`` and the curved rows dropped
    into ``cw[CW_DROPS]``; the kernel's outputs have the split rows'
    length, the first ``cw[CW_KEPT]`` set.  Two launches: the test
    (``split_check``), then the filter on a tile's rows staged by 16-byte
    loads (``OUTn`` 16-byte aligned), its survivors' rows written as one
    block."""
    run = _run(kern, OUTn.device)
    if run is None:
        return curved_filter_plain(OUTn, bz, lanes, ce, Vn, cstate, idx, eps,
                                   cw)
    dev, S = OUTn.device, OUTn.shape[0]
    Vs = torch.empty((S, 3), dtype=torch.float32, device=dev)
    OUTs = torch.empty((S, R_COLS), dtype=torch.float32, device=dev)
    bzs, ces = _i32(S, NW, device=dev), _i32(S, 2, device=dev)
    lanes_s = _i32(S, device=dev)
    run("curved_filter", "curved_filter", S, OUTn, bz, lanes, ce, Vn, cstate,
        S, idx, eps, cw, Vs, OUTs, bzs, lanes_s, ces)
    return Vs, OUTs, bzs, lanes_s, ces


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


# K6 the final filter and the faces (csrc/faces.cu)

# the faces stage's count vector (int64 [FC], zeroed): vertices the keep
# test passes, vertices and edges of the complex (the funnel's "A/B"), kept
# edges and the vertices they use ("C/D"), region replicas (read after
# face_keys_count); kept regions and triangles (read after face_fans_count);
# then the used vertices by zero count
FC_KEEPV, FC_PRE, FC_LIVE, FC_EKEEP, FC_USED, FC_REP, FC_KEPT, FC_TRI = range(8)
FC_HIST = 8
KZ_MAX = D + R_COLS - 1  # the grid columns and the hidden neurons'
FC = FC_HIST + KZ_MAX + 1
KZ_NONE = 64             # an unused vertex's zero count: it sorts last
KEYS_TILE = 1024         # face_keys' tile of vertices (faces.cu kTile)
SIG_NONE = 2 ** 63 - 1   # the signature of a replica that starts no region
PFIX = 2.0 ** 22         # the means' fixed point (the JAX engine's, :1614)
# a region key's grid fields (cell offset + 2, 10 bits each, axis 0 highest)
# above the 32 hidden neurons' sign bits
KEY_SHIFT = (52, 42, 32)


# face_regions' hash table: an empty slot's key (no region key is)
EMPTY_KEY = -2 ** 63


def final_keep_plain(V, OUT, E, eps: float, scale: float, fc):
    keep = OUT[:, -1].abs() < eps
    xu = (V + scale) / (scale * 2)
    keep &= ~(xu > 1).any(-1) & ~(xu < 0).any(-1)
    a, b = E[:, 0].long(), E[:, 1].long()
    ends = _zeros32(2, V.shape[0], device=V.device)
    ends[0, a] = 1
    ends[0, b] = 1
    ek = keep[a] & keep[b]
    ends[1, a[ek]] = 1
    ends[1, b[ek]] = 1
    fc[FC_KEEPV] += keep.sum()
    fc[FC_LIVE] += E.shape[0]
    fc[FC_EKEEP] += ek.sum()
    return keep.to(torch.int32), ends


def final_keep(V, OUT, E, eps: float, scale: float, fc,
               kern: Kernels | None = None):
    """The final filter (``faces.extract_skeleton``'s test): (keep [nV]
    int32, a vertex with |OUT[:, -1]| < eps inside the unit cube; ends
    [2, nV] int32, row 0 the ends of an edge, row 1 the ends of a kept
    edge, both ends kept).  Counts the kept vertices, the edges and the
    kept edges into ``fc``.  One launch, a thread a vertex or an edge, an
    edge's thread testing its two ends itself (the first design,
    ``-DFACES_FIRST``: a vertex pass, then an edge pass reading its
    flags)."""
    run = _run(kern, V.device)
    if run is None:
        return final_keep_plain(V, OUT, E, eps, scale, fc)
    nV, nE = V.shape[0], E.shape[0]
    keep = _i32(nV, device=V.device)
    ends = _zeros32(2, nV, device=V.device)
    run("final_keep", "final_keep", nV + nE, V, OUT, nV, E, nE, eps, scale,
        keep, ends, fc)
    return keep, ends


def _replica_rows(V, SB, ZB, marks, lut, lut_k: int, eps: float,
                  scale: float):
    """Each vertex's all-minus region key and zero columns: [n, 4] int32
    (the key's low and high words, the zero hidden neurons' bits, the
    on-grid-plane axes' bits), and its zero count [n]."""
    xu = (V + scale) / (scale * 2)
    g, off = _grid_region_lut(marks, lut, xu, eps, lut_k)
    zg = (g == 0).to(torch.int64)
    field = off.to(torch.int64) + 2 - zg
    zw = ZB[:, 0]
    key = (SB[:, 0] & ~zw).to(torch.int64) & 0xFFFFFFFF
    gz = torch.zeros_like(key)
    for d in range(D):
        key |= field[:, d] << KEY_SHIFT[d]
        gz |= zg[:, d] << d
    kz = _popc(zw) + _popc(gz)
    rows = torch.stack([_to_i32(key & 0xFFFFFFFF), (key >> 32).to(torch.int32),
                        zw, gz.to(torch.int32)], 1)
    return rows, kz.to(torch.int32)


def _class_order(kz, used):
    """The used vertices in (zero count, vertex) order: the stable sort of
    the zero counts, the unused last."""
    return torch.sort(torch.where(used, kz, KZ_NONE),
                      stable=True).indices[:int(used.sum())]


def face_keys_count_plain(V, SB, ZB, ends, marks, lut, lut_k: int, eps: float,
                          scale: float, fc):
    rows, kz = _replica_rows(V, SB, ZB, marks, lut, lut_k, eps, scale)
    used = ends[1] > 0
    fc[FC_PRE] += (ends[0] > 0).sum()
    fc[FC_USED] += used.sum()
    ku = kz[used].long()
    fc[FC_REP] += (1 << ku).sum()
    fc[FC_HIST:] += torch.bincount(ku, minlength=KZ_MAX + 1)
    # ranks in the tile: among the used, and among the used of a zero count
    n = V.shape[0]
    tile = torch.arange(n, device=V.device) // KEYS_TILE
    cls = torch.where(used, kz.long(), KZ_MAX + 1)
    o = torch.sort(tile * (KZ_MAX + 2) + cls, stable=True).indices
    group = (tile * (KZ_MAX + 2) + cls)[o]
    start = torch.ones(n, dtype=torch.bool, device=V.device)
    start[1:] = group[1:] != group[:-1]
    pos = torch.arange(n, device=V.device)
    rank = torch.empty(n, dtype=torch.int64, device=V.device)
    rank[o] = pos - torch.cummax(torch.where(start, pos, 0), 0).values
    ut = torch.zeros(n, dtype=torch.int64, device=V.device)
    ut.index_add_(0, tile, used.long())
    local = torch.cumsum(used.long(), 0) - 1
    local -= (torch.cumsum(ut, 0) - ut)[tile]
    rk = torch.stack([torch.where(used, local, -1),
                      torch.where(used, rank, -1)], 1).to(torch.int32)
    agg = torch.zeros((-(-n // KEYS_TILE), KZ_MAX + 1), dtype=torch.int64,
                      device=V.device)
    agg.index_put_((tile[used], ku), torch.ones_like(ku), accumulate=True)
    return (torch.where(used[:, None], rows, 0), rk, agg.to(torch.int32))


def face_keys_count(V, SB, ZB, ends, marks, lut, lut_k: int, eps: float,
                    scale: float, fc, kern: Kernels | None = None):
    """Tiles of ``KEYS_TILE`` vertices, a thread a vertex: for each used
    vertex (``ends[1]``), its region (``_grid_region_lut`` on the unit-cube
    point, the hidden neurons' eps-signs from the words, the final sdf
    column excluded) as the all-minus key with its zero columns ([nV, 4]
    int32, 0 for an unused vertex); its rank in its tile among the used
    and among the used of its zero count kz ([nV, 2] int32, -1 for an
    unused one), by ballots; each tile's used vertices by kz ([tiles,
    KZ_MAX + 1] int32).  Counts the vertices of an edge, the used vertices,
    their 2^kz replicas and the used vertices by kz into ``fc``."""
    run = _run(kern, V.device)
    if run is None:
        return face_keys_count_plain(V, SB, ZB, ends, marks, lut, lut_k, eps,
                                     scale, fc)
    n, dev = V.shape[0], V.device
    rows, rk = _i32(n, 4, device=dev), _i32(n, 2, device=dev)
    agg = _i32(-(-n // KEYS_TILE), KZ_MAX + 1, device=dev)
    run("face_keys", "face_keys_count", n, V, SB, ZB, ends, n, marks,
        marks.shape[0], lut, lut_k, eps, scale, rows, rk, agg, fc)
    return rows, rk, agg


def _zero_deltas(rows):
    """[n, KZ_MAX] int64: the key's increment for each zero column, by the
    column's rank (grid axes first, then the hidden neurons), 0 past kz."""
    n = rows.shape[0]
    cols = [(((rows[:, 3] >> d) & 1) > 0, 1 << KEY_SHIFT[d]) for d in range(D)]
    cols += [(_bit(rows[:, 2:3], c), 1 << c) for c in range(R_COLS - 1)]
    z = torch.stack([c for c, _ in cols], 1)
    rank = torch.cumsum(z.to(torch.int64), 1) - 1
    inc = torch.tensor([v for _, v in cols], dtype=torch.int64,
                       device=rows.device)
    out = torch.zeros((n, KZ_MAX + 1), dtype=torch.int64, device=rows.device)
    out.scatter_(1, torch.where(z, rank, KZ_MAX), torch.where(z, inc, 0))
    return out[:, :KZ_MAX]


def _replica_keys(V, rows, o, k, vid, n_rep: int):
    """The replicas of the used vertices ``o`` in (kz, vertex) order (``k``
    their zero counts, ``vid`` their ids): (keys, ids, the used rows of V
    by id)."""
    n_used = o.numel()
    Vf = torch.empty((n_used, 3), dtype=V.dtype, device=V.device)
    Vf[vid] = V[o]
    cnt = 1 << k
    first = torch.cumsum(cnt, 0) - cnt
    rv = torch.repeat_interleave(torch.arange(n_used, device=V.device), cnt,
                                 output_size=n_rep)
    p = torch.arange(n_rep, device=V.device) - first[rv]
    r = rows[o]
    base = (r[:, 0].to(torch.int64) & 0xFFFFFFFF) | (
        r[:, 1].to(torch.int64) << 32)
    bits = (p[:, None] >> torch.arange(KZ_MAX, device=V.device)) & 1
    keys = base[rv] + (bits * _zero_deltas(r)[rv]).sum(1)
    return keys, vid[rv].to(torch.int32), Vf


def face_keys_fill_plain(V, rows, rk, agg, n_used: int, n_rep: int):
    used = rk[:, 0] >= 0
    kz = _popc(rows[:, 2]) + _popc(rows[:, 3])
    o = _class_order(kz, used)
    vid = torch.cumsum(used, 0) - 1
    return _replica_keys(V, rows, o, kz[o].long(), vid[o], n_rep)


def face_keys_fill(V, rows, rk, agg, fc, n_used: int, n_rep: int,
                   kern: Kernels | None = None):
    """``face_keys_count``'s tiles, a thread a vertex: the tiles before's
    used vertices by zero count (``agg``'s earlier rows summed) make a used
    vertex's tile ranks (``rk``) its id among all the used and its rank
    among the used of its zero count kz; its 2^kz region replicas (keys
    [n_rep] int64: a zero column's bit r of the replica's rank takes the
    column's + side, the replica of a grid column's - side the cell
    below), each with the vertex's id [n_rep] int32, at its kz's slots
    (the histogram in ``fc``) and its rank there: the replicas in (kz,
    vertex) order, a warp's of one kz written a slot a lane; and the used
    vertices' rows of ``V`` [n_used, 3]."""
    run = _run(kern, V.device)
    if run is None:
        return face_keys_fill_plain(V, rows, rk, agg, n_used, n_rep)
    dev, n = V.device, V.shape[0]
    keys = torch.empty(n_rep, dtype=torch.int64, device=dev)
    rvid = _i32(n_rep, device=dev)
    Vf = torch.empty((n_used, 3), dtype=V.dtype, device=dev)
    run("face_keys", "face_keys_fill", n, V, rows, rk, agg, fc, n, keys, rvid,
        Vf)
    return keys, rvid, Vf


def face_keys_count_first_plain(V, SB, ZB, ends, marks, lut, lut_k: int,
                                eps: float, scale: float, fc):
    rows, rk, _ = face_keys_count_plain(V, SB, ZB, ends, marks, lut, lut_k,
                                        eps, scale, fc)
    used = rk[:, 0] >= 0
    kz = _popc(rows[:, 2]) + _popc(rows[:, 3])
    return torch.where(used, kz, KZ_NONE).to(torch.int32), rows


def face_keys_count_first(V, SB, ZB, ends, marks, lut, lut_k: int,
                          eps: float, scale: float, fc,
                          kern: Kernels | None = None):
    """The first design's count (``-DFACES_FIRST``), a thread a vertex:
    the key rows as ``face_keys_count``'s and the zero counts kz (int32
    [nV], ``KZ_NONE`` for an unused vertex), which the caller sorts."""
    run = _run(kern, V.device)
    if run is None:
        return face_keys_count_first_plain(V, SB, ZB, ends, marks, lut,
                                           lut_k, eps, scale, fc)
    n = V.shape[0]
    kz, rows = _i32(n, device=V.device), _i32(n, 4, device=V.device)
    run("face_keys", "face_keys_count_first", n, V, SB, ZB, ends, n, marks,
        marks.shape[0], lut, lut_k, eps, scale, kz, rows, fc)
    return kz, rows


def face_keys_fill_first_plain(V, rows, kzs, order, vcum, n_used: int,
                               n_rep: int):
    o = order[:n_used].long()
    return _replica_keys(V, rows, o, kzs[:n_used].long(),
                         (vcum[o] - 1).long(), n_rep)


def face_keys_fill_first(V, rows, kzs, order, vcum, fc, n_used: int,
                         n_rep: int, kern: Kernels | None = None):
    """The first design's fill, a thread a used vertex in (kz, vertex)
    order (``kzs``, ``order``: the stable sort of the zero counts; ``vcum``
    the used flags' inclusive prefix sum), its replicas written one after
    another: ``face_keys_fill``'s outputs."""
    run = _run(kern, V.device)
    if run is None:
        return face_keys_fill_first_plain(V, rows, kzs, order, vcum, n_used,
                                          n_rep)
    dev = V.device
    keys = torch.empty(n_rep, dtype=torch.int64, device=dev)
    rvid = _i32(n_rep, device=dev)
    Vf = torch.empty((n_used, 3), dtype=V.dtype, device=dev)
    run("face_keys", "face_keys_fill_first", n_used, V, rows, kzs, order,
        vcum, fc, n_used, keys, rvid, Vf)
    return keys, rvid, Vf


def face_regions_runs_first_plain(skey, perm, rvid, Vf):
    n = skey.shape[0]
    dev = skey.device
    svid = rvid[perm]
    start = torch.ones(n, dtype=torch.bool, device=dev)
    start[1:] = skey[1:] != skey[:-1]
    s = torch.nonzero(start)[:, 0]
    cnt = torch.diff(s, append=s.new_full((1,), n))
    fix = torch.round(Vf[svid.long()] * PFIX).to(torch.int64)
    cs = torch.cat([fix.new_zeros(1, 3), torch.cumsum(fix, 0)])
    sums = cs[s + cnt] - cs[s]
    sig = torch.full((n,), SIG_NONE, dtype=torch.int64, device=dev)
    sig[s] = (svid[s].to(torch.int64) << 32) | cnt
    rcnt = _zeros32(n, device=dev)
    rcnt[s] = cnt.to(torch.int32)
    mean = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    mean[s] = sums.to(torch.float32) / (cnt.to(torch.float32) * PFIX)[:, None]
    return sig, rcnt, mean, svid


def face_regions_runs_first(skey, perm, rvid, Vf,
                            kern: Kernels | None = None):
    """The first design's runs (``-DFACES_FIRST``), a thread a replica of
    the key-sorted replicas (``skey``; ``perm`` the sort's permutation of
    ``face_keys_fill``'s order): the one that
    starts a run of equal keys, a region, writes at its position the
    region's signature (its first member's id << 32 | its member count;
    ``SIG_NONE`` elsewhere) [n] int64, its count [n] int32 (0 elsewhere)
    and the mean of its members' points in 2^-22 fixed point (integer
    sums, one f32 division) [n, 3] (0 elsewhere); every replica its member
    id in sorted order, ``svid`` [n] int32."""
    run = _run(kern, skey.device)
    if run is None:
        return face_regions_runs_first_plain(skey, perm, rvid, Vf)
    n, dev = skey.shape[0], skey.device
    sig = torch.empty(n, dtype=torch.int64, device=dev)
    rcnt, svid = _i32(n, device=dev), _i32(n, device=dev)
    mean = torch.empty((n, 3), dtype=torch.float32, device=dev)
    run("face_regions", "face_regions_runs_first", n, skey, perm, rvid, Vf,
        n, sig, rcnt, mean, svid)
    return sig, rcnt, mean, svid


def face_regions_dups_first_plain(ssig, rord, rcnt, svid):
    n = ssig.shape[0]
    dev = ssig.device
    real = ssig != SIG_NONE
    s = rord.long()
    c = rcnt[s].long()
    i = torch.arange(n, device=dev)
    new = torch.ones(n, dtype=torch.bool, device=dev)
    new[1:] = ssig[1:] != ssig[:-1]
    first = torch.cummax(torch.where(new, i, 0), 0).values
    L = torch.where(real, i - first, 0)
    # every pair (j, earlier j') inside a run of equal signatures
    jj = torch.repeat_interleave(i, L)
    jp = first[jj] + torch.arange(jj.numel(), device=dev) - (
        torch.cumsum(L, 0) - L)[jj]
    cp = c[jj]
    pair = torch.repeat_interleave(torch.arange(jj.numel(), device=dev), cp)
    k = torch.arange(pair.numel(), device=dev) - (torch.cumsum(cp, 0)
                                                  - cp)[pair]
    mism = svid[s[jj][pair] + k] != svid[s[jp][pair] + k]
    bad = torch.zeros(jj.numel(), dtype=torch.int64, device=dev)
    bad.index_add_(0, pair, mism.to(torch.int64))
    dup = torch.zeros(n, dtype=torch.bool, device=dev)
    dup[jj[bad == 0]] = True
    return (real & (c >= 3) & ~dup).to(torch.int32)


def face_regions_dups_first(ssig, rord, rcnt, svid,
                            kern: Kernels | None = None):
    """The first design's duplicates (``-DFACES_FIRST``), a thread a region
    slot of the signature-sorted order (``ssig``,
    ``rord`` the sort's permutation of the replica positions): the region
    is kept (1, int32 [n]) if it has 3 members or more and is no duplicate:
    no earlier region of its run of equal signatures has its member list,
    compared member by member with every one of them."""
    run = _run(kern, ssig.device)
    if run is None:
        return face_regions_dups_first_plain(ssig, rord, rcnt, svid)
    n = ssig.shape[0]
    keep = _i32(n, device=ssig.device)
    run("face_regions", "face_regions_dups_first", n, ssig, rord, rcnt, svid,
        n, keep)
    return keep


def face_regions_plain(keys, rvid, Vf):
    skey, perm = torch.sort(keys, stable=True)
    sig, rcnt0, mean0, svid0 = face_regions_runs_first_plain(skey, perm,
                                                             rvid, Vf)
    ssig, o = torch.sort(sig, stable=True)
    n, dev = keys.shape[0], keys.device
    m = int((ssig != SIG_NONE).sum())
    # the regions in signature order, their members end to end
    old = o[:m]
    c = rcnt0[old].long()
    start = torch.cumsum(c, 0) - c
    r, pos, _ = _members(start, c)
    svid = torch.empty_like(svid0)
    svid[pos] = svid0[old[r] + pos - start[r]]
    rcnt = _zeros32(n, device=dev)
    rcnt[start] = c.to(torch.int32)
    mean = torch.zeros_like(mean0)
    mean[start] = mean0[old]
    rord = torch.full((n,), -1, dtype=torch.int64, device=dev)
    rord[:m] = start
    keep = face_regions_dups_first_plain(ssig, rord.clamp(min=0), rcnt, svid)
    return rord, rcnt, mean, svid, keep


def face_regions(keys, rvid, Vf, kern: Kernels | None = None):
    """The regions of ``face_keys_fill``'s replicas (``keys``, the member
    ids ``rvid``, every used vertex's replicas one run; ``Vf`` the used
    points), in the order of a stable sort of the keys and then of the
    regions' signatures (first member, then count; ties in key order),
    without a sort: the replicas grouped in a hash table (``Kernels.
    region_table``), a thread a used vertex ranking the regions whose first
    member it is (by count, then key) across tiles of 64 vertices by a
    decoupled look-back, then a thread a region writing its members.
    Returns, over the n replica slots, (rord [n]
    int64: region j's members' start in ``svid``, -1 past the regions;
    rcnt [n] int32: a region's member count at its start, 0 elsewhere;
    mean [n, 3]: its members' mean in 2^-22 fixed point (integer sums, one
    f32 division) at its start, 0 elsewhere; svid [n] int32: the regions'
    members in signature order, each region's in replica order; keep [n]
    int32: region j has 3 members or more and no earlier region of its run
    of equal signatures has its members, 0 past the regions).  Three
    launches."""
    run = _run(kern, keys.device)
    if run is None:
        return face_regions_plain(keys, rvid, Vf)
    n, n_used, dev = keys.shape[0], Vf.shape[0], keys.device
    table, bits = run.region_table(n)
    rord = torch.empty(n, dtype=torch.int64, device=dev)
    rcnt, svid, keep = (_i32(n, device=dev) for _ in range(3))
    mean = torch.empty((n, 3), dtype=torch.float32, device=dev)
    rslot, nxt, mem, tmp = (_i32(n, device=dev) for _ in range(4))
    vstart = _i32(n_used, device=dev)
    big = torch.empty((n, 2), dtype=torch.int64, device=dev)  # [n] Region
    rsig = torch.empty(n, dtype=torch.int64, device=dev)
    run("face_regions", "face_regions", n, keys, rvid, Vf, n, n_used, bits,
        table, rslot, nxt, vstart, big, rsig, mem, tmp, rord, rcnt, mean,
        svid, keep)
    return rord, rcnt, mean, svid, keep


def _region_members(rord, rcnt, keep):
    """The kept regions' members: (each member's region rank [m], position
    in the sorted replicas [m], the regions' counts [r])."""
    j = torch.nonzero(keep)[:, 0]
    s = rord[j].long()
    c = rcnt[s].long()
    return _members(s, c)


def _members(s, c):
    """Each member's region and position of the regions starting at ``s``
    in the sorted replicas with ``c`` members: (region [m], position [m],
    c)."""
    r = torch.repeat_interleave(torch.arange(s.numel(), device=s.device), c)
    k = torch.arange(r.numel(), device=s.device) - (torch.cumsum(c, 0)
                                                    - c)[r]
    return r, s[r] + k, c


def kept_members(kl, n_kept: int):
    """The kept regions of ``face_fans_count``'s list ``kl``: (each
    member's region rank [m], position in the sorted replicas [m], the
    regions' counts [n_kept])."""
    g = kl[:n_kept].long()
    return _members(g[:, 0], g[:, 1])


def _first_in_region(r, v, n: int):
    """[m] bool: the first of each (region r, vertex v) in the given
    order."""
    key = r.to(torch.int64) * (n + 1) + v.to(torch.int64)
    o = torch.sort(key, stable=True).indices
    ks = key[o]
    dup = torch.zeros_like(ks, dtype=torch.bool)
    dup[1:] = ks[1:] == ks[:-1]
    first = torch.ones_like(dup)
    first[o] = ~dup
    return first


def _fan_counts(rord, rcnt, svid, keep):
    """The kept regions' slots, starts, counts and triangles (their
    distinct members less 2)."""
    r, pos, c = _region_members(rord, rcnt, keep)
    d = torch.bincount(r[_first_in_region(r, svid[pos], keep.shape[0])],
                       minlength=c.numel())
    j = torch.nonzero(keep)[:, 0]
    return j, rord[j], c, (d - 2).clamp(min=0)


def face_fans_count_plain(rord, rcnt, svid, mean, keep, fc, kl, mk):
    _, s, c, nt = _fan_counts(rord, rcnt, svid, keep)
    m = s.numel()
    kl[:m] = torch.stack([s, c, torch.cumsum(nt, 0) - nt, nt],
                         1).to(torch.int32)
    mk[:m] = mean[s]
    fc[FC_KEPT] += m
    fc[FC_TRI] += nt.sum()
    return kl, mk


def face_fans_count(rord, rcnt, svid, mean, keep, fc, kl, mk,
                    kern: Kernels | None = None):
    """Tiles of 1,024 region slots of the signature-sorted order: each
    kept slot's region (``rord[j]``, its start in the sorted replicas;
    ``rcnt`` its count) ranked among the kept, its triangles (its distinct
    member ids less 2) and their offset among all the triangles, by a
    block scan and a decoupled look-back of both counts; written in rank
    order into ``kl`` ([n, 4] int32: start, count, triangle offset,
    triangles) and ``mk`` ([n, 3]: its mean, for the normals), their rows
    past the kept ones left as they are.  Counts the kept regions and the
    triangles into ``fc``.  Returns (kl, mk)."""
    run = _run(kern, keep.device)
    if run is None:
        return face_fans_count_plain(rord, rcnt, svid, mean, keep, fc, kl, mk)
    n = keep.shape[0]
    run("face_fans", "face_fans_count", n, rord, rcnt, svid, mean, keep, n,
        fc, kl, mk)
    return kl, mk


def _fan_scores(P, Mn, Nn, first):
    """The angular score of each member point ``P`` [m, 3] around its
    region's mean ``Mn`` and normal ``Nn`` (rows a member), against the
    region's first member (``first``: its row): s = cos * sign(dn) +
    2 (dn < 0), f32, every sum written out left to right."""
    u = P - Mn
    ux, uy, uz = u.unbind(1)
    ax, ay, az = u[first].unbind(1)
    nx, ny, nz = Nn.unbind(1)
    dx, dy, dz = ay * uz - az * uy, az * ux - ax * uz, ax * uy - ay * ux
    nrm = torch.sqrt(ux * ux + uy * uy + uz * uz)
    denom = torch.clamp(nrm[first] * nrm, min=1e-8)
    cos = (ax * ux + ay * uy + az * uz) / denom
    dn = dx * nx + dy * ny + dz * nz
    return cos * torch.where(dn >= 0, 1.0, -1.0) + torch.where(dn < 0, 2.0,
                                                              0.0)


def _fans(r, pos, c, means, nrm, svid, Vf, n_tri: int):
    """The kept regions' fans (members ``r``, ``pos``; counts ``c``; each
    region's mean and normal): [n_tri, 3] int64."""
    v = svid[pos]
    dev, n = v.device, svid.shape[0]
    first = (torch.cumsum(c, 0) - c)[r]
    score = _fan_scores(Vf[v.long()], means[r], nrm[r], first)
    # by region, then by descending score, ties in member order
    o = torch.sort(-score, stable=True).indices
    o = o[torch.sort(r[o], stable=True).indices]
    r, v = r[o], v[o]
    keepm = _first_in_region(r, v, n)
    r, v = r[keepm], v[keepm].to(torch.int64)
    d = torch.bincount(r, minlength=c.numel())
    nt = (d - 2).clamp(min=0)
    t = torch.repeat_interleave(torch.arange(c.numel(), device=dev), nt,
                                output_size=n_tri)
    b = (torch.cumsum(d, 0) - d)[t]
    rank = torch.arange(n_tri, device=dev) - (torch.cumsum(nt, 0) - nt)[t]
    # the fan (v0, v_t+1, v_t+2) with its winding reversed (faces.py)
    return torch.stack([v[b + rank + 2], v[b + rank + 1], v[b]], 1)


def face_fans_fill_plain(kl, svid, mk, nrm, Vf, n_kept: int, n_tri: int):
    r, pos, c = kept_members(kl, n_kept)
    return _fans(r, pos, c, mk[:n_kept], nrm, svid, Vf, n_tri)


def face_fans_fill(kl, svid, mk, nrm, Vf, n_kept: int, n_tri: int,
                   kern: Kernels | None = None):
    """A thread a kept region (``face_fans_count``'s ``kl`` and ``mk``;
    ``nrm`` [n_kept, 3] its normal): its members' angular scores around
    its normal, a stable sort by descending score (ties keep the (kz, id)
    member order) and the repeated ids dropped (the first in angle order
    kept), in shared memory up to 8 members, else in the region's own
    segment of scratch memory; the block's fans written as one run of
    rows: [n_tri, 3] int64, each (v_t+2, v_t+1, v0), the winding reversed
    so the normals point out."""
    run = _run(kern, svid.device)
    if run is None:
        return face_fans_fill_plain(kl, svid, mk, nrm, Vf, n_kept, n_tri)
    n, dev = svid.shape[0], svid.device
    tris = torch.empty((n_tri, 3), dtype=torch.int64, device=dev)
    score = torch.empty(n, dtype=torch.float32, device=dev)
    ids = _i32(n, device=dev)
    run("face_fans", "face_fans_fill", n_kept, kl, svid, mk, nrm, Vf, n_kept,
        score, ids, tris)
    return tris


def face_fans_count_first_plain(rord, rcnt, svid, mean, keep, kcum, fc):
    n = keep.shape[0]
    j, s, _, nt = _fan_counts(rord, rcnt, svid, keep)
    ntri = torch.zeros(n, dtype=torch.int64, device=keep.device)
    ntri[j] = nt
    mk = torch.zeros((n, 3), dtype=torch.float32, device=keep.device)
    mk[kcum[j] - 1] = mean[s]
    fc[FC_KEPT] += j.numel()
    fc[FC_TRI] += ntri.sum()
    return ntri, mk


def face_fans_count_first(rord, rcnt, svid, mean, keep, kcum, fc,
                          kern: Kernels | None = None):
    """The first design's count (``-DFACES_FIRST``), a thread a region slot
    (``kcum``: the keep flags' inclusive prefix sum): its triangles (int64
    [n], 0 for a slot not kept) and its mean at its rank among the kept
    (``mk`` [n, 3], zeros past them).  Counts the kept regions and the
    triangles into ``fc``."""
    run = _run(kern, keep.device)
    if run is None:
        return face_fans_count_first_plain(rord, rcnt, svid, mean, keep, kcum,
                                           fc)
    n, dev = keep.shape[0], keep.device
    ntri = torch.empty(n, dtype=torch.int64, device=dev)
    mk = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    run("face_fans", "face_fans_count_first", n, rord, rcnt, svid, mean, keep,
        kcum, n, fc, ntri, mk)
    return ntri, mk


def face_fans_fill_first_plain(rord, rcnt, svid, mean, keep, nrm, Vf,
                               n_tri: int):
    r, pos, c = _region_members(rord, rcnt, keep)
    j = torch.nonzero(keep)[:, 0]
    return _fans(r, pos, c, mean[rord[j]], nrm, svid, Vf, n_tri)


def face_fans_fill_first(rord, rcnt, svid, mean, keep, kcum, ntri, tcum, nrm,
                         Vf, n_tri: int, kern: Kernels | None = None):
    """The first design's fill, a thread a region slot: a kept region's fan
    sorted in its segment of scratch memory, written at its slot of
    ``tcum`` (``ntri``'s inclusive prefix sum): ``face_fans_fill``'s
    triangles."""
    run = _run(kern, keep.device)
    if run is None:
        return face_fans_fill_first_plain(rord, rcnt, svid, mean, keep, nrm,
                                          Vf, n_tri)
    n, dev = keep.shape[0], keep.device
    tris = torch.empty((n_tri, 3), dtype=torch.int64, device=dev)
    score = torch.empty(n, dtype=torch.float32, device=dev)
    order = _i32(n, device=dev)
    run("face_fans", "face_fans_fill_first", n, rord, rcnt, svid, mean, keep,
        kcum, ntri, tcum, nrm, Vf, n, score, order, tris)
    return tris


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
        # the curved path's busy insertions: (plane, splits, curved rows,
        # rescued rows, rescue steps, survivors, host reads)
        self.curved = []
        self.t_skeleton = self.t_loop = self.t_faces = 0.0


LAST = Stats()


class Engine:
    """The subdivision loop for one net, on the net's device: the flat path
    (``force``) or the curved one, then the faces.  ``kern``: the kernels
    to launch; default the committed build on a CUDA device, the plain
    versions on the CPU (and for ``PLAIN``)."""

    def __init__(self, net, eps: float = 1e-4, kern: Kernels | None = None,
                 stats: Stats | None = None, force: bool = True):
        self.net = net
        self.eps = eps
        self.force = force
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
        # pinned host memory for the one read an insertion makes, by type
        self._host = {}

    def read(self, meta: torch.Tensor) -> np.ndarray:
        """The count vector, read to the host: the loop's only sync."""
        self.stats.reads += 1
        if self.dev.type != "cuda":
            return meta.numpy().copy()
        buf = self._host.get(meta.dtype)
        if buf is None:
            buf = self._host[meta.dtype] = torch.empty(
                max(META, FC), dtype=meta.dtype, pin_memory=True)
        host = buf[:meta.numel()]
        host.copy_(meta, non_blocking=True)
        torch.cuda.current_stream(self.dev).synchronize()
        return host.numpy().copy()

    # skeleton ---------------------------------------------------------------

    @torch.no_grad()
    def skeleton(self, mode: str = "dist"):
        """The initial skeleton on the device: the lattice forward (K2),
        then K3 (``mark``).  Returns (V, OUT, SB, ZB, SZ, E) compacted, or
        None without edges."""
        net, M, k = self.net, self.M, self.kern
        spec = net.spec
        aw = self.marks * (spec.scale * 2) - spec.scale
        tables = lattice_tables(spec.grid, net.enc.table.detach(), M ** 3)
        if mode == "dist":
            return self.mark(*_sdf_dist_grad_lattice(
                net, aw, aw, aw, tables, plain=k is PLAIN))
        if mode == "sign":
            feats = lattice_features(net, aw, aw, aw, tables,
                                     plain=k is PLAIN)
            return self.mark(mlp_forward(
                [l.weight for l in net.fc], [l.bias for l in net.fc], feats,
                gather=True, eps=spec.eps)[1])
        raise ValueError(f"unknown skeleton mode {mode!r}")

    @torch.no_grad()
    def mark(self, out, dq=None, gn=None):
        """K3 on the M^3 lattice's gathered columns ``out`` [M^3, R]: with
        |sdf| ``dq`` and |grad sdf| ``gn`` [M^3] (dist mode) the points
        within the distance bound, else (sign mode) all of them; the edges
        whose eps-signs differ, both ends kept, compacted.  Returns (V, OUT,
        SB, ZB, SZ, E), or None without edges."""
        M, k = self.M, self.kern
        g, pool_k = None, 0
        if dq is not None:
            # pooled along axes 0 and 1 here, along axis 2 by the words
            if self.dist_k <= 0:
                g = gn.max().expand(M ** 3).contiguous()
            else:
                g, pool_k = gn, self.dist_k
                for axis in range(2):
                    g = skeleton_pool(g, M, pool_k, axis, kern=k)
        if isinstance(k, Kernels) and k.first_skeleton:
            return self._skeleton_first(out, dq, g, pool_k)
        W, X = skeleton_words(out, dq, g, M, pool_k, self.bc, self.eps,
                              kern=k)
        masks, pre, cnt = skeleton_flags(W, X, M, kern=k)
        off, tot = skeleton_scan(cnt, kern=k)
        n_edges, n_used = (int(x) for x in self.read(tot))
        if n_edges == 0:
            return None
        return skeleton_compact(masks, pre, off, self.marks, out, M,
                                self.net.spec.scale, self.eps, n_edges,
                                n_used, kern=k)

    def _skeleton_first(self, out, dq, g, pool_k):
        """``mark`` in the first design's stages (its third pool launch,
        along axis 2, before the points)."""
        k, M = self.kern, self.M
        gmax = g if pool_k <= 0 else skeleton_pool(g, M, pool_k, 2, kern=k)
        sb, zb, sz, keep = skeleton_points(out, dq, gmax, self.bc, self.eps,
                                           kern=k)
        flags, used = skeleton_edges(sb, zb, keep, M, kern=k)
        ecum, ucum, tot = skeleton_cumsum(flags, used)
        n_edges, n_used = (int(x) for x in self.read(tot))
        if n_edges == 0:
            return None
        return skeleton_squeeze(ecum, ucum, self.marks, out, sb, zb, sz, M,
                                self.net.spec.scale, n_edges, n_used, kern=k)

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
        the unpruned (V, OUT, E) and the vertices' sign and zero words
        instead."""
        k, eps, dev = self.kern, self.eps, self.dev
        nV, nE = P.V.shape[0], P.E.shape[0]
        E, EB, LD = P.E.clone(), P.EB.clone(), P.LD.clone()
        # K4: split and lerp, forward, override, words, rewrite and append;
        # on the curved path (K4c) the curved rows' vertices and the strict
        # filter between the split and the finish
        if isinstance(k, Kernels) and k.first_split:
            if not self.force:
                raise ValueError("K4's first design takes the flat path only")
            Vn, OUTn, (sbn, zbn, szn, Er, EBr, LDr) = self._split_first(
                P, E, EB, LD, idx, n_split, final)
        elif self.force:
            lanes, ce, Vn, bz = split_select(E, EB, P.V, P.OUT, P.ZB, idx,
                                             n_split, kern=k)
            OUTn = self.net.outputs(Vn)
            sbn, zbn, szn, Er, EBr, LDr = split_finish(
                OUTn, bz, lanes, ce, E, EB, LD, P.SB, P.ZB, nV, idx, eps,
                final, kern=k)
        else:
            cw = _zeros32(CW, device=dev)
            sel = split_select(E, EB, P.V, P.OUT, P.ZB, idx, n_split, eps,
                               cw, kern=k)
            Vn, OUTn, bz, lanes, ce = self._curved(P, *sel, idx, cw)
            # the survivors carry the override: K4's finish alone
            sbn, zbn, szn, Er, EBr, LDr = split_finish(
                OUTn, bz, lanes, ce, E, EB, LD, P.SB, P.ZB, nV, idx, eps,
                final, kern=k, survivors=True)
        n_new = Vn.shape[0]  # the survivors on the curved path
        Vx = torch.cat([P.V, Vn])
        SBx, ZBx = torch.cat([P.SB, sbn]), torch.cat([P.ZB, zbn])
        # K5: hits, candidates by cell, the pairs, the prune's census
        hcum = torch.cumsum(hit_mark(P.SZ, idx, kern=k), 0, dtype=torch.int32)
        C, key = candidates(Vx, SBx, ZBx, hcum, nV, n_new, n_hit, idx,
                            self.marks, self.lut, self.lut_k, eps,
                            self.net.spec.scale, kern=k)
        skey, perm = torch.sort(key, stable=True)
        perm = perm.to(torch.int32)
        cols, Cs = connect_table(C, skey, perm, self.M, kern=k)
        meta = _zeros32(META, device=dev)
        used = None if final else _zeros32(nV + n_new, device=dev)
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
            return Vx, OUTx, torch.cat([E, Er, Ec]), SBx, ZBx
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

    def _count_read(self) -> None:
        self.stats.reads += 1

    def _curved(self, P: Pools, lanes, ce, Vn, bz, qs, plane, e01, corners,
                idx: int, cw):
        """K4c between the selection (the split rows and their curved rows,
        counted in ``cw``) and ``split_finish``: the curved rows' vertices
        (the corner forward, K7's roots and their points, the on-surface
        forward, the residuals and the vertices as if no row were rescued),
        the forward of every new vertex, then the strict filter.  Returns
        the survivors' (Vn, OUTn, bz, lanes, ce).  Reads the count words
        twice: the curved rows, then the sentinels, rescued rows and
        survivors.  Where rows were rescued, the rescue (a read a step but
        the first) and the mix take them back, and the forward and the
        filter run again, with a third read.  Counts the events into
        ``failover.COUNTERS`` as the host engine does."""
        k, eps, net = self.kern, self.eps, self.net
        reads = self.stats.reads
        cstate = _zeros32(Vn.shape[0], device=self.dev)
        n_cv, bad = (int(x) for x in self.read(cw[:CW_SENT]))
        if bad:
            raise RuntimeError(f"curved edges not on any earlier plane at "
                               f"plane {idx}: {bad}/{n_cv}")
        if n_cv:
            fo.COUNTERS["curved_steps"] += 1
            qs, plane, e01 = qs[:n_cv], plane[:n_cv], e01[:n_cv]
            d_corner = net.outputs(corners[:n_cv].reshape(-1, 3), group=8)
            ints, cand = curved_roots(d_corner.reshape(n_cv, 8, R_COLS), plane,
                                      e01, idx, kern=k)
            dnew, grank, ge0, gde, gcols, gx = curved_gd(
                net.outputs(cand), plane, ints, e01, qs, idx, eps, Vn, cstate,
                cw, kern=k)

        def strict():
            OUTn = net.outputs(Vn)
            return curved_filter(OUTn, bz, lanes, ce, Vn, cstate, idx, eps, cw,
                                 kern=k)

        kept = strict()
        n_sent, n_gd, _, n_keep, drops = (int(x)
                                          for x in self.read(cw[CW_SENT:]))
        steps = 0
        if n_gd:
            before = fo.COUNTERS["gd_steps"]
            gx_end, gd0, _ = fo.descend(net, ge0[:n_gd], gde[:n_gd],
                                        gcols[:n_gd], gx[:n_gd], idx, eps,
                                        on_test=self._count_read)
            steps = fo.COUNTERS["gd_steps"] - before
            cw[CW_ANYD0:].zero_()  # the mix's flag, the filter's counts
            curved_mix(qs, e01, ints, dnew, grank, gx_end, gd0, eps, Vn,
                       cstate, cw, kern=k)
            kept = strict()
            n_keep, drops = (int(x) for x in self.read(cw[CW_KEPT:]))
        fo.COUNTERS["sentinels"] += n_sent
        fo.COUNTERS["gd_rows"] += n_gd
        fo.COUNTERS["strict_drops"] += drops
        self.stats.curved.append((idx, Vn.shape[0], n_cv, n_gd, steps, n_keep,
                                  self.stats.reads - reads))
        return tuple(x[:n_keep] for x in kept)

    def _split_first(self, P: Pools, E, EB, LD, idx: int, n_split: int,
                     final: bool):
        """K4 in the first design's stages: (Vn, OUTn, ``split_append``'s
        outputs)."""
        k, eps = self.kern, self.eps
        scum = split_cumsum(split_mark(EB, idx, kern=k))
        lanes, ce, Vn, bz = split_lerp(E, scum, P.V, P.OUT, P.ZB, idx,
                                       n_split, kern=k)
        OUTn = self.net.outputs(Vn)
        viol = split_override(OUTn, bz, idx, eps, kern=k)
        return Vn, OUTn, split_append(OUTn, bz, viol, lanes, ce, E, EB, LD,
                                      P.SB, P.ZB, P.V.shape[0], idx, eps,
                                      final, kern=k)

    def loop(self, P: Pools, counts: np.ndarray):
        """Every busy insertion from the pools on, skipping idle planes by
        the count vector's split histogram; returns the complex after the
        final insertion (V, OUT, E), unpruned, and its vertices' sign and
        zero words (SB, ZB)."""
        idx = self._next(counts, -1)
        while idx < self.n_hidden:
            P, counts = self.step(P, idx, int(counts[SPLIT + idx]),
                                  int(counts[HIT + idx]), final=False)
            idx = self._next(counts, idx)
        fin = self.n_hidden
        if counts[SPLIT + fin] == 0:
            return P.V, P.OUT, P.E, P.SB, P.ZB
        return self.step(P, fin, int(counts[SPLIT + fin]),
                         int(counts[HIT + fin]), final=True)

    # the faces ------------------------------------------------------------

    @torch.no_grad()
    def faces(self, V, OUT, E, SB, ZB):
        """K6 on the complex after the final insertion (V, OUT, E and its
        vertices' words SB, ZB): the final filter, then the faces.  Returns
        the funnel (vertices and edges before the filter, after it), the
        used vertices [n, 3] in vertex order and the triangles [T, 3]
        int64.  Reads the count vector twice: after the filter and the
        replica count, and after the fans' count."""
        k, eps, scale = self.kern, self.eps, self.net.spec.scale
        dev = V.device
        E = E.to(torch.int32).contiguous()
        fc = torch.zeros(FC, dtype=torch.int64, device=dev)
        _, ends = final_keep(V, OUT, E, eps, scale, fc, kern=k)
        # K6's first design (-DFACES_FIRST) takes torch.cumsum and
        # torch.sort between its kernels; the design none
        first = isinstance(k, Kernels) and k.first_faces
        if first:
            kz, rows = face_keys_count_first(V, SB, ZB, ends, self.marks,
                                             self.lut, self.lut_k, eps, scale,
                                             fc, kern=k)
        else:
            rows, rk, agg = face_keys_count(V, SB, ZB, ends, self.marks,
                                            self.lut, self.lut_k, eps, scale,
                                            fc, kern=k)
        n_keepv, pre_v, pre_e, n_ekeep, n_used, n_rep = (
            int(x) for x in self.read(fc[:FC_KEPT]))
        no_tris = torch.empty((0, 3), dtype=torch.int64, device=dev)
        if n_keepv < 3 or n_used == 0:  # extract_skeleton's empty result
            return (pre_v, pre_e, 0, 0), V[:0], no_tris
        funnel = (pre_v, pre_e, n_used, n_ekeep)
        if first:
            vcum = torch.cumsum(ends[1], 0, dtype=torch.int32)
            kzs, order = torch.sort(kz, stable=True)
            keys, rvid, Vf = face_keys_fill_first(V, rows, kzs, order, vcum,
                                                  fc, n_used, n_rep, kern=k)
            skey, perm = torch.sort(keys, stable=True)
            sig, rcnt, mean, svid = face_regions_runs_first(skey, perm, rvid,
                                                            Vf, kern=k)
            ssig, rord = torch.sort(sig, stable=True)
            keep = face_regions_dups_first(ssig, rord, rcnt, svid, kern=k)
        else:
            keys, rvid, Vf = face_keys_fill(V, rows, rk, agg, fc, n_used,
                                            n_rep, kern=k)
            rord, rcnt, mean, svid, keep = face_regions(keys, rvid, Vf,
                                                        kern=k)
        n = keep.shape[0]
        if first:
            kcum = torch.cumsum(keep, 0, dtype=torch.int64)
            ntri, mk = face_fans_count_first(rord, rcnt, svid, mean, keep,
                                             kcum, fc, kern=k)
        else:
            kl, mk = face_fans_count(
                rord, rcnt, svid, mean, keep, fc, _i32(n, 4, device=dev),
                torch.empty((n, 3), dtype=torch.float32, device=dev), kern=k)
        n_kept, n_tri = (int(x) for x in self.read(fc[FC_KEPT:FC_HIST]))
        if n_kept == 0:
            return funnel, Vf, no_tris
        nrm = self.net.normal(mk[:n_kept])
        if first:
            tris = face_fans_fill_first(rord, rcnt, svid, mean, keep, kcum,
                                        ntri, torch.cumsum(ntri, 0), nrm, Vf,
                                        n_tri, kern=k)
        else:
            tris = face_fans_fill(kl, svid, mk, nrm, Vf, n_kept, n_tri,
                                  kern=k)
        return funnel, Vf, tris


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
    """The extraction on the net's device, the flat path (``force``) or
    the curved one: the skeleton (``skeleton_mode`` "dist", the default,
    or "sign"), the busy insertions, then the final filter and the faces
    (``Engine.faces``).

    Returns (face positions [T, 3, 3], vertices [V, 3], triangles [T, 3]),
    as ``subdivide.subpoly``; ``LAST`` keeps the run's reads, busy
    insertions and stage times, ``failover.COUNTERS`` the curved path's
    events."""
    from tropical_torch.extract import stats
    from tropical_torch.extract.skeleton import get_hypercube

    if not device_engine_supports(net):
        raise ValueError(
            f"the device engine takes {R_COLS}-column nets with at most 511 "
            f"marks (got {(net.num_layers - 1) * net.num_hidden + 1} columns, "
            f"{int(net.marks.shape[0])} marks); use engine='host'")
    mode = "dist" if skeleton_mode == "auto" else skeleton_mode
    global LAST
    LAST = Stats()
    fo.reset_counters()
    eng = Engine(net, eps, stats=LAST, force=force)
    clock = _Clock(net.device)
    sk = eng.skeleton(mode)
    if sk is None:  # no lattice edge: the hypercube (subpoly.py:51-52)
        V, E, _ = get_hypercube(d, size, net.device)
        sk = (V, net.outputs(V), None, None, None, E)
    V, OUT, SB, ZB, SZ, E = sk
    P, counts = eng.pools(V, OUT, E, None if SB is None else (SB, ZB, SZ))
    clock.mark()
    V, OUT, E, SB, ZB = eng.loop(P, counts)
    clock.mark()
    (pre_v, pre_e, post_v, post_e), V, tris = eng.faces(V, OUT, E, SB, ZB)
    faces = V[tris]
    clock.mark()
    if verbose:
        print()
        print(f"# of vertices and edges = {pre_v}/{pre_e} => "
              f"{post_v}/{post_e}, {len(faces)} faces", end=", ")
    LAST.t_skeleton, LAST.t_loop, LAST.t_faces = clock.spans()
    stats.record(pre_v, pre_e, post_v, post_e, len(faces))
    return faces, V, tris
