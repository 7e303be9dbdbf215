"""Multiresolution hash-grid encoding (Müller et al. 2022) in PyTorch.

Counterpart of ``tropical/core/hashgrid.py`` with the same tiny-cuda-nn grid
semantics, so checkpoints carry over unchanged:

- per-level scale   ``s_l = N_min * b**l - 1``  with geometric growth
  ``b = exp2(log2(N_max*scale/N_min) / (L-1))``,
- resolution        ``r_l = ceil(s_l) + 1``,
- sample position   ``pos = x * s_l + 0.5``,
- dense linear index while ``r_l**D`` fits the table, otherwise the spatial
  hash ``xor_d(grid[d] * primes[d]) mod 2^T`` with primes
  (1, 2654435761, 805459861),
- per-level table size ``min(next_multiple(r_l**D, 8), 2^T)``,
- trilinear interpolation over the 2^D cell corners, float32 params.

The tcnn hash multiplies in uint32 with wraparound.  Torch has no complete
uint32 arithmetic on CUDA, so it runs in int64 and is masked to 32 bits,
which gives the same low bits.

``encode`` is one autograd function, ``HashGridEncode``, differentiable
twice (the eikonal term differentiates the x-gradient).  On CUDA tensors
its forward, backward and double backward are the kernels of
``csrc/hashgrid_encode.cu``; on CPU tensors they are the plain versions
``encode_plain``, ``encode_backward_plain`` and
``encode_double_backward_plain``, whose order of operations the kernels
follow bit for bit (but for the scattered table gradients).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from functools import cached_property
from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.autograd.function import once_differentiable

from tropical_torch.ops import cuda_build, launches

PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


def _next_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class HashGridSpec:
    """Static configuration of a multiresolution hash grid."""

    scale: float = 1.0
    dim: int = 3
    levels: int = 16
    features: int = 2
    log2_table: int = 19
    n_min: int = 16
    n_max: int = 2048
    eps: float = 1e-4

    @cached_property
    def growth(self) -> float:
        if self.levels == 1:
            return 1.0
        return float(
            np.exp2(np.log2(self.n_max * self.scale / self.n_min) / (self.levels - 1))
        )

    def level_scale(self, l: int) -> float:
        return float(np.exp2(l * np.log2(self.growth)) * self.n_min - 1.0)

    def level_resolution(self, l: int) -> int:
        return int(np.ceil(self.level_scale(l))) + 1

    def level_entries(self, l: int) -> int:
        dense = self.level_resolution(l) ** self.dim
        return min(_next_multiple(dense, 8), 1 << self.log2_table)

    def level_uses_hash(self, l: int) -> bool:
        return self.level_resolution(l) ** self.dim > (1 << self.log2_table)

    @cached_property
    def level_offsets(self) -> Sequence[int]:
        offs = []
        o = 0
        for l in range(self.levels):
            offs.append(o)
            o += self.level_entries(l)
        return tuple(offs)

    @cached_property
    def n_entries(self) -> int:
        return self.level_offsets[-1] + self.level_entries(self.levels - 1)


def _level_indices(spec: HashGridSpec, l: int,
                   grid: Sequence[torch.Tensor]) -> torch.Tensor:
    """Table index (int64) for integer corner coordinates, one int64 tensor
    per axis in ``grid``."""
    res = spec.level_resolution(l)
    if spec.level_uses_hash(l):
        h = (grid[0] * PRIMES[0]) & _U32
        for d in range(1, spec.dim):
            h = h ^ ((grid[d] * PRIMES[d]) & _U32)
        return h & ((1 << spec.log2_table) - 1)
    idx = grid[0]
    stride = 1
    for d in range(1, spec.dim):
        stride *= res
        idx = idx + grid[d] * stride
    # tcnn applies `index % hashmap_size` unconditionally with this level's
    # padded entry count, so a boundary corner at coordinate `res` wraps
    # within the level instead of reading the next level's entries
    return torch.remainder(idx, spec.level_entries(l))


def _level_grid(spec: HashGridSpec, x: torch.Tensor, l: int):
    """Level ``l``'s cell of each point: (integer corner 0 [B, D] int64,
    fraction in the cell [B, D]).  ``x * s_l`` multiplies by the level scale
    rounded to the tensor's type, then adds 0.5: two roundings."""
    pos = x * spec.level_scale(l) + 0.5
    pos_grid = torch.floor(pos)
    return pos_grid.to(torch.int64), pos - pos_grid


def _corners(spec: HashGridSpec, l: int, pos_grid: torch.Tensor,
             frac: torch.Tensor, n_rows: int):
    """The 2^D cell corners in order: (bits, table row [B] clamped to the
    table, per-axis trilinear weights: ``frac`` where the bit is set, else
    ``1 - frac``)."""
    D = spec.dim
    off = spec.level_offsets[l]
    for corner in range(1 << D):
        bits = [(corner >> d) & 1 for d in range(D)]
        cp = [pos_grid[..., d] + bits[d] for d in range(D)]
        idx = (off + _level_indices(spec, l, cp)).clamp(0, n_rows - 1)
        wd = [frac[..., d] if bits[d] else 1.0 - frac[..., d]
              for d in range(D)]
        yield bits, idx, wd


def _product(terms):
    """Left-to-right product; 1.0 for no terms."""
    out = 1.0
    for i, t in enumerate(terms):
        out = t if i == 0 else out * t
    return out


def _accumulate(acc, term):
    return term if acc is None else acc + term


def _row_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_k a[:, k] * b[:, k], left to right: [B, F] x [B, F] -> [B]."""
    out = None
    for k in range(a.shape[-1]):
        out = _accumulate(out, a[:, k] * b[:, k])
    return out


def _encode_level(spec: HashGridSpec, table: torch.Tensor, x: torch.Tensor,
                  l: int) -> torch.Tensor:
    """One level's pointwise 8-corner gather encode: [B, D] -> [B, F]."""
    pos_grid, frac = _level_grid(spec, x, l)
    feat = None
    for _, idx, wd in _corners(spec, l, pos_grid, frac, table.shape[0]):
        feat = _accumulate(feat, _product(wd)[..., None] * table[idx])
    return feat


def encode_plain(spec: HashGridSpec, table: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """Plain version of the encode: points ``x`` [B, D] in [0,1]^D ->
    features [B, L*F] (level-major); ``w = (w_x*w_y)*w_z`` and the corners
    summed in order 0..2^D-1."""
    return torch.cat([_encode_level(spec, table, x, l)
                      for l in range(spec.levels)], dim=-1)


def encode_backward_plain(spec: HashGridSpec, table: torch.Tensor,
                          x: torch.Tensor, dfeat: torch.Tensor,
                          need_x: bool = True, need_table: bool = True):
    """Plain version of the encode's backward: (dx [B, D] or None, dtable
    [N, F] or None) for the feature gradient ``dfeat`` [B, L*F].

    With g_c = sum_k dfeat_k T[idx_c, k] and P_cd the product of corner c's
    weights other than axis d (in axis order), each level gives
    dfrac_d = sum_c (+-)(g_c * P_cd) (minus where c's bit d is 0, corners in
    order) and dx = sum_l dfrac * s_l (levels in order): floor has no
    gradient, so d frac / dx = s_l.  dtable[idx_c] += w_c * dfeat, in the
    order of ``index_add_``."""
    F = spec.features
    dx = None
    dtable = torch.zeros_like(table) if need_table else None
    for l in range(spec.levels):
        pos_grid, frac = _level_grid(spec, x, l)
        dl = dfeat[:, l * F:(l + 1) * F]
        dfrac = [None] * spec.dim
        for bits, idx, wd in _corners(spec, l, pos_grid, frac, table.shape[0]):
            if need_table:
                dtable.index_add_(0, idx, _product(wd)[:, None] * dl)
            if need_x:
                g = _row_dot(dl, table[idx])
                for d in range(spec.dim):
                    t = g * _product(wd[:d] + wd[d + 1:])
                    dfrac[d] = _accumulate(dfrac[d], t if bits[d] else -t)
        if need_x:
            dx = _accumulate(dx, torch.stack(dfrac, dim=-1)
                             * spec.level_scale(l))
    return dx, dtable


def encode_double_backward_plain(spec: HashGridSpec, table: torch.Tensor,
                                 x: torch.Tensor, dfeat: torch.Tensor,
                                 ddx: torch.Tensor, need_dfeat: bool = True,
                                 need_table: bool = True,
                                 need_x: bool = True):
    """Plain version of the backward of the encode's backward: for the
    gradient ``ddx`` [B, D] of ``dx``, (d_dfeat [B, L*F], dtable2 [N, F],
    dx2 [B, D]), each None where not needed.

    With u = ddx * s_l and a_c = grad(w_c) . u = sum_d (+-)(P_cd * u_d):
    d_dfeat = sum_c a_c T[idx_c]; dtable2[idx_c] += a_c * dfeat; and from
    the mixed second derivatives of the weights,
    dx2_e = s_l * sum_c g_c * sum_{d != e} (+-)(W_c,de * u_d), with W_c,de
    the product of c's weights on the axes other than d and e and the sign
    minus where c's bits d and e differ."""
    F, D = spec.features, spec.dim
    d_dfeat = []
    dtable2 = torch.zeros_like(table) if need_table else None
    dx2 = None
    for l in range(spec.levels):
        pos_grid, frac = _level_grid(spec, x, l)
        dl = dfeat[:, l * F:(l + 1) * F]
        u = ddx * spec.level_scale(l)
        dd = None
        dfrac2 = [None] * D
        for bits, idx, wd in _corners(spec, l, pos_grid, frac, table.shape[0]):
            a = None
            for d in range(D):
                q = _product(wd[:d] + wd[d + 1:]) * u[:, d]
                a = _accumulate(a, q if bits[d] else -q)
            t_c = table[idx] if (need_dfeat or need_x) else None
            if need_dfeat:
                dd = _accumulate(dd, a[:, None] * t_c)
            if need_table:
                dtable2.index_add_(0, idx, a[:, None] * dl)
            if need_x:
                g = _row_dot(dl, t_c)
                for e in range(D):
                    h = None
                    for d in range(D):
                        if d == e:
                            continue
                        q = _product([wd[k] for k in range(D)
                                      if k not in (d, e)]) * u[:, d]
                        h = _accumulate(h, q if bits[d] == bits[e] else -q)
                    dfrac2[e] = _accumulate(dfrac2[e], g * h)
        if need_dfeat:
            d_dfeat.append(dd)
        if need_x:
            dx2 = _accumulate(dx2, torch.stack(dfrac2, dim=-1)
                              * spec.level_scale(l))
    return (torch.cat(d_dfeat, dim=-1) if need_dfeat else None), dtable2, dx2


# --- the CUDA kernels (csrc/hashgrid_encode.cu) ------------------------------

_THREADS_LIMIT = 2 ** 31
# the kernels' most levels (csrc/hashgrid_encode.cu:kMaxLevels)
_MAX_LEVELS = 32
# the backwards' shared memory for a block's private table-gradient rows
# (csrc/hashgrid_encode.cu:kPrivateBytes): at the full budget, with the
# warps' scratch, two blocks of 256 threads still fit an SM's 227 KB
PRIVATE_BYTES = 80 * 1024


def private_levels(spec: HashGridSpec) -> int:
    """How many levels, from level 0 on, whose table-gradient rows the
    backwards sum in a block-private copy in shared memory: the longest
    prefix of levels whose rows (8 bytes each) fit ``PRIVATE_BYTES``.

    A block flushes only the private rows it made non-zero, one atomic a
    row, so a privatised level never takes more device-memory atomics than
    its corners would, and a coarse level, whose few rows every point hits,
    takes one a block instead of one a point; its cost is the block's
    zero-fill and scan of the rows, and the shared memory."""
    k = 0
    while (k < spec.levels and 8 * (spec.level_offsets[k]
                                    + spec.level_entries(k)) <= PRIVATE_BYTES):
        k += 1
    return k


def private_rows(spec: HashGridSpec) -> int:
    """The table rows of the ``private_levels``: rows [0, private_rows)."""
    k = private_levels(spec)
    return spec.n_entries if k == spec.levels else spec.level_offsets[k]


def _group(spec: HashGridSpec) -> int:
    """Threads a point in the forward: the power of two at or above the
    level count."""
    return 1 << (spec.levels - 1).bit_length()


def _level_rows(spec: HashGridSpec) -> np.ndarray:
    """Per-level constants, one row a level as the kernel's ``LevelRow``:
    f32 scale (as its bits), offset, entries, resolution, whether the level
    hashes (int32 [L, 5])."""
    return np.array([[np.float32(spec.level_scale(l)).view(np.int32),
                      spec.level_offsets[l], spec.level_entries(l),
                      spec.level_resolution(l), int(spec.level_uses_hash(l))]
                     for l in range(spec.levels)], np.int32)


class _Plan(ctypes.Structure):
    """The kernels' ``Plan``: a spec's launch constants on one device."""

    _fields_ = [("rows", ctypes.c_void_p), ("levels", ctypes.c_int),
                ("group", ctypes.c_int), ("n_rows", ctypes.c_int),
                ("hash_mask", ctypes.c_uint), ("private_rows", ctypes.c_int),
                ("blocks_bwd", ctypes.c_int), ("blocks_bwd_bwd", ctypes.c_int),
                ("fwd_wave", ctypes.c_int),
                ("level_rows", ctypes.c_int32 * (_MAX_LEVELS * 5))]


class _Launcher:
    """A library's launch functions bound to one spec on one device: the
    plan (the level rows on the host and, for the backwards, on the device),
    filled once."""

    def __init__(self, lib: ctypes.CDLL, spec: HashGridSpec, index: int):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        self.fwd, self.bwd, self.bwd_bwd = fns = (
            lib.hashgrid_encode_fwd_launch, lib.hashgrid_encode_bwd_launch,
            lib.hashgrid_encode_bwd_bwd_launch)
        # (plan, x, table, n, the gradients and outputs..., stream)
        for fn, tail in zip(fns, (2, 4, 6)):
            fn.argtypes = [ptr, ptr, ptr, i32] + [ptr] * tail
            fn.restype = ctypes.c_int
        self.lanes_of = lib.hashgrid_encode_fwd_lanes
        self.lanes_of.argtypes, self.lanes_of.restype = [ptr, i32], i32
        self.device, self.levels = index, spec.levels
        # with one card its device is always the current one
        self.only_device = torch.cuda.device_count() == 1
        rows = _level_rows(spec)
        self.rows = torch.from_numpy(rows).to(torch.device("cuda", index))
        self.plan = _Plan(self.rows.data_ptr(), spec.levels, _group(spec),
                          spec.n_entries, (1 << spec.log2_table) - 1,
                          private_rows(spec), 0, 0, 0)
        self.plan.level_rows[:rows.size] = rows.ravel().tolist()
        self.ref = ctypes.addressof(self.plan)
        lib.hashgrid_encode_configure.argtypes = [ptr]
        lib.hashgrid_encode_configure.restype = ctypes.c_int
        with torch.cuda.device(index):
            rc = lib.hashgrid_encode_configure(self.ref)
        if rc != 0:
            raise RuntimeError(f"hashgrid_encode_configure failed: CUDA "
                               f"error {rc}")

    def lanes(self, n: int) -> int:
        """The lanes a (point, level) of a forward over n points."""
        return self.lanes_of(self.ref, n)

    def __call__(self, fn, name: str, n: int, *pointers,
                 scatter: bool = False) -> None:
        """Launch ``fn`` on the current stream of the plan's device and
        count it (and whether it scattered a table gradient)."""
        index = self.device
        if self.only_device or torch.cuda.current_device() == index:
            rc = fn(self.ref, *pointers,
                    torch._C._cuda_getCurrentRawStream(index))
        else:
            with torch.cuda.device(index):
                rc = fn(self.ref, *pointers,
                        torch._C._cuda_getCurrentRawStream(index))
        if rc != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
        launches.record(name, (n, self.levels), scatter=scatter)


# (id of the spec, device index, library) -> (the spec, its launcher)
_LAUNCHERS: dict = {}


def _launcher(spec: HashGridSpec, index: int,
              lib: ctypes.CDLL | None) -> _Launcher:
    """The launcher of ``lib`` (default: the committed build) for ``spec`` on
    device ``index``, made on first use.  Found by the spec object's
    identity: hashing the frozen dataclass's fields costs more than the
    rest of the lookup."""
    found = _LAUNCHERS.get((id(spec), index, lib))
    if found is None or found[0] is not spec:
        found = _LAUNCHERS[(id(spec), index, lib)] = (spec, _Launcher(
            lib or cuda_build.load("hashgrid_encode"), spec, index))
    return found[1]


def _check(t: torch.Tensor, name: str, shape, align: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def _explain(spec: HashGridSpec, table: torch.Tensor, x: torch.Tensor,
             grads) -> None:
    """Raise what is wrong with the kernels' inputs."""
    if spec.dim != 3 or spec.features != 2:
        raise ValueError(f"the kernels take D = 3 and F = 2, not D = "
                         f"{spec.dim} and F = {spec.features}")
    if _group(spec) > 32:
        raise ValueError(f"the kernels take at most 32 levels, not "
                         f"{spec.levels}")
    n = x.shape[0] if x.ndim == 2 else -1
    # table and dfeat rows are read as float2
    _check(x, "x", (n, 3), 4)
    _check(table, "table", (spec.n_entries, 2), 8)
    shapes = {"dfeat": ((n, spec.levels * 2), 8), "ddx": ((n, 3), 4)}
    for name, t in grads.items():
        _check(t, name, *shapes[name])
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if table.device != x.device:
        raise ValueError(f"table is on {table.device}, x on {x.device}")
    if n * _group(spec) >= _THREADS_LIMIT:
        raise ValueError(f"{n} points at {_group(spec)} threads a point "
                         "overflow the kernels' int32 thread count")
    raise AssertionError("unreachable: the inputs passed every check")


def _fits(t: torch.Tensor, shape, index: int, align: int) -> bool:
    return (t.dtype is torch.float32 and t.shape == shape
            and t.get_device() == index and t.is_contiguous()
            and not t.data_ptr() % align)


def _check_inputs(spec: HashGridSpec, table: torch.Tensor, x: torch.Tensor,
                  **grads: torch.Tensor) -> tuple[int, int]:
    """Check the kernels' inputs; returns (B, the index of their CUDA
    device).  One pass of cheap tests, and on a failure the detailed checks
    that say what failed."""
    index = x.get_device() if x.is_cuda else -1
    n = x.shape[0] if x.ndim == 2 else -1
    ok = (index >= 0 and spec.dim == 3 and spec.features == 2
          and spec.levels <= 32 and n * _group(spec) < _THREADS_LIMIT
          and _fits(x, (n, 3), index, 4)
          and _fits(table, (spec.n_entries, 2), index, 8))
    for name, t in grads.items():
        ok = ok and _fits(t, (n, 3) if name == "ddx" else (n, spec.levels * 2),
                          index, 4 if name == "ddx" else 8)
    if not ok:
        _explain(spec, table, x, grads)
    return n, index


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def hashgrid_encode_fwd(spec: HashGridSpec, table: torch.Tensor,
                        x: torch.Tensor,
                        lib: ctypes.CDLL | None = None) -> torch.Tensor:
    """``encode_plain`` by the CUDA kernel, bitwise: features [B, L*2].
    ``lib``: a variant build of the kernels
    (scripts/hashgrid_encode_variants.py), else the committed one."""
    n, index = _check_inputs(spec, table, x)
    feat = x.new_empty((n, spec.levels * 2))
    if n:
        run = _launcher(spec, index, lib)
        run(run.fwd, "hashgrid_encode_fwd", n, x.data_ptr(), table.data_ptr(),
            n, feat.data_ptr())
    return feat


def hashgrid_encode_bwd(spec: HashGridSpec, table: torch.Tensor,
                        x: torch.Tensor, dfeat: torch.Tensor,
                        need_x: bool = True, need_table: bool = True,
                        lib: ctypes.CDLL | None = None):
    """``encode_backward_plain`` by the CUDA kernel: dx bitwise, dtable an
    atomic scatter (its order of adds is free), zero-filled by the launch.
    Without ``need_table`` nothing is scattered.  ``lib`` as for
    ``hashgrid_encode_fwd``."""
    n, index = _check_inputs(spec, table, x, dfeat=dfeat)
    dx = x.new_empty((n, 3)) if need_x else None
    if not n:
        return dx, torch.zeros_like(table) if need_table else None
    dtable = torch.empty_like(table) if need_table else None
    if need_x or need_table:
        run = _launcher(spec, index, lib)
        run(run.bwd, "hashgrid_encode_bwd", n, x.data_ptr(), table.data_ptr(),
            n, dfeat.data_ptr(), _ptr(dx), _ptr(dtable), scatter=need_table)
    return dx, dtable


def hashgrid_encode_bwd_bwd(spec: HashGridSpec, table: torch.Tensor,
                            x: torch.Tensor, dfeat: torch.Tensor,
                            ddx: torch.Tensor, need_dfeat: bool = True,
                            need_table: bool = True, need_x: bool = True,
                            lib: ctypes.CDLL | None = None):
    """``encode_double_backward_plain`` by the CUDA kernel: d_dfeat and dx2
    bitwise, dtable2 an atomic scatter, zero-filled by the launch."""
    n, index = _check_inputs(spec, table, x, dfeat=dfeat, ddx=ddx)
    d_dfeat = x.new_empty((n, spec.levels * 2)) if need_dfeat else None
    dx2 = x.new_empty((n, 3)) if need_x else None
    if not n:
        return d_dfeat, torch.zeros_like(table) if need_table else None, dx2
    dtable2 = torch.empty_like(table) if need_table else None
    if need_dfeat or need_table or need_x:
        run = _launcher(spec, index, lib)
        run(run.bwd_bwd, "hashgrid_encode_bwd_bwd", n, x.data_ptr(),
            table.data_ptr(), n, dfeat.data_ptr(), ddx.data_ptr(),
            _ptr(d_dfeat), _ptr(dtable2), _ptr(dx2), scatter=need_table)
    return d_dfeat, dtable2, dx2


# --- autograd ------------------------------------------------------------------

def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


class HashGridEncode(torch.autograd.Function):
    """The encode, differentiable twice.  CPU tensors take the plain
    versions; anything else goes to the kernels, which raise on what they do
    not take."""

    @staticmethod
    def forward(ctx, x, table, spec):
        ctx.spec = spec
        ctx.save_for_backward(x, table)
        if _on_cpu(x, table):
            return encode_plain(spec, table, x)
        return hashgrid_encode_fwd(spec, table, x.contiguous())

    @staticmethod
    def backward(ctx, dfeat):
        x, table = ctx.saved_tensors
        need_x, need_table, _ = ctx.needs_input_grad
        dx, dtable = _EncodeBackward.apply(x, table, dfeat, ctx.spec, need_x,
                                           need_table)
        return dx, dtable, None


class _EncodeBackward(torch.autograd.Function):
    """The encode's backward as a function of (x, table, dfeat), so that a
    gradient of dx (the eikonal term's) can flow back through it."""

    @staticmethod
    def forward(ctx, x, table, dfeat, spec, need_x, need_table):
        ctx.spec = spec
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, table, dfeat)
        if _on_cpu(x, table, dfeat):
            return encode_backward_plain(spec, table, x, dfeat, need_x,
                                         need_table)
        return hashgrid_encode_bwd(spec, table, x.contiguous(),
                                   dfeat.contiguous(), need_x, need_table)

    @staticmethod
    @once_differentiable
    def backward(ctx, ddx, ddtable):
        if ddtable is not None:
            raise NotImplementedError(
                "the gradient of the encode's table gradient is not "
                "implemented")
        if ddx is None:
            return (None,) * 6
        x, table, dfeat = ctx.saved_tensors
        need_x, need_table, need_dfeat = ctx.needs_input_grad[:3]
        if _on_cpu(x, table, dfeat, ddx):
            d_dfeat, dtable2, dx2 = encode_double_backward_plain(
                ctx.spec, table, x, dfeat, ddx, need_dfeat, need_table,
                need_x)
        else:
            d_dfeat, dtable2, dx2 = hashgrid_encode_bwd_bwd(
                ctx.spec, table, x.contiguous(), dfeat.contiguous(),
                ddx.contiguous(), need_dfeat, need_table, need_x)
        return dx2, dtable2, d_dfeat, None, None, None


def encode(spec: HashGridSpec, table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Encode points ``x`` [B, D] in [0,1]^D -> features [B, L*F] (level-major).

    Gradients w.r.t. ``x`` flow through the trilinear weights (floor has
    zero gradient): the piecewise-trilinear structure the extraction uses.
    One ``HashGridEncode``: the kernels on CUDA tensors, the plain versions
    on CPU tensors."""
    return HashGridEncode.apply(x, table, spec)


# --- the separable lattice encode (K2: csrc/lattice_encode.cu) -----------------

def corner_bins(spec: HashGridSpec, l: int) -> int:
    """Corner coordinates a level's unit-cube queries touch, per axis:
    pos = x s + 0.5 with x <= 1 floors to at most s + 0.5 <= res, so the
    corners 0..res + 1 cover every query."""
    return spec.level_resolution(l) + 2


def corner_table(spec: HashGridSpec, table: torch.Tensor,
                 l: int) -> torch.Tensor:
    """Level ``l``'s corner-value grid, [K^3, F] in (x, y, z) order with z
    fastest: every table row the separable interpolation can read, gathered
    once through ``_level_indices`` (dense or hashed alike)."""
    K = corner_bins(spec, l)
    ax = torch.arange(K, device=table.device)
    grid = torch.meshgrid(ax, ax, ax, indexing="ij")
    idx = _level_indices(spec, l, [g.reshape(-1) for g in grid])
    return table[spec.level_offsets[l] + idx]


def _factored(spec: HashGridSpec, l: int, n_points: int) -> bool:
    """Whether the lattice encode of ``n_points`` points factors level
    ``l``: not when its corner grid has more than 8 entries a point (the
    pointwise encode's gathers) or passes 512 MB."""
    K3 = corner_bins(spec, l) ** 3
    return not (K3 > 8 * n_points or K3 * spec.features * 4 > 2 ** 29)


def lattice_tables(spec: HashGridSpec, table: torch.Tensor,
                   n_points: int) -> list:
    """Each level's ``corner_table`` for a lattice of ``n_points`` points,
    None where the level takes the pointwise encode."""
    return [corner_table(spec, table, l) if _factored(spec, l, n_points)
            else None for l in range(spec.levels)]


def _tangent(spec: HashGridSpec, l: int, world_scale: float) -> np.float32:
    """d pos / d x_world of level ``l``: 1 / (2 scale) times s_l, in f32 (an
    exact product for scale 1)."""
    return np.float32(np.float32(1.0 / (2.0 * world_scale))
                      * np.float32(spec.level_scale(l)))


def _axis(a: torch.Tensor, s: float):
    """One axis of a level: (corner 0 index [N] int64, weights 1 - frac and
    frac [N]), with ``_level_grid``'s two roundings."""
    pos = a * s + 0.5
    g = torch.floor(pos)
    frac = pos - g
    return g.to(torch.int64), 1.0 - frac, frac


def _contract(A: torch.Tensor, dim: int, g: torch.Tensor, w0, w1):
    """sum over ``dim`` of A against a weight matrix with two nonzeros a
    row: A[g] * w0 + A[g + 1] * w1, the products rounded, then the sum."""
    shape = [1] * A.ndim
    shape[dim] = -1
    w0 = w0.reshape(shape) if torch.is_tensor(w0) else w0
    w1 = w1.reshape(shape) if torch.is_tensor(w1) else w1
    return (A.index_select(dim, g) * w0) + (A.index_select(dim, g + 1) * w1)


def lattice_level_plain(spec: HashGridSpec, G: torch.Tensor, l: int,
                        xs: torch.Tensor, ys: torch.Tensor, zs: torch.Tensor,
                        need_grad: bool = False, world_scale: float = 1.0):
    """Plain version of the lattice encode of one level: features [N, F]
    of the lattice {xs} x {ys} x {zs} (unit-cube axis coordinates, x-major
    point order), and with ``need_grad`` their derivatives along the three
    world axes [3, N, F].

    ``G`` [K^3, F] is the level's ``corner_table``.  The interpolation
    contracts z, then y, then x, each as ``_contract``; a derivative swaps
    its axis's weights (1 - frac, frac) for (-t, t), t = ``_tangent``."""
    K, F = corner_bins(spec, l), spec.features
    s = spec.level_scale(l)
    G = G.reshape(K, K, K, F)
    (gx, x0, x1), (gy, y0, y1), (gz, z0, z1) = (_axis(a, s)
                                                 for a in (xs, ys, zs))
    t1 = _contract(G, 2, gz, z0, z1)
    t2 = _contract(t1, 1, gy, y0, y1)
    feat = _contract(t2, 0, gx, x0, x1).reshape(-1, F)
    if not need_grad:
        return feat, None
    t = float(_tangent(spec, l, world_scale))
    dx = _contract(t2, 0, gx, -t, t)
    dy = _contract(_contract(t1, 1, gy, -t, t), 0, gx, x0, x1)
    dz = _contract(_contract(_contract(G, 2, gz, -t, t), 1, gy, y0, y1),
                   0, gx, x0, x1)
    return feat, torch.stack([d.reshape(-1, F) for d in (dx, dy, dz)])


def _lattice_fn(lib: ctypes.CDLL):
    fn = lib.lattice_encode_launch
    if fn.argtypes is None:
        p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, i32, i32, i32, p, i32, f32, f32, p, p, i32,
                       ctypes.c_longlong, p]
        fn.restype = ctypes.c_int
    return fn


def lattice_encode(spec: HashGridSpec, G: torch.Tensor, l: int,
                   xs: torch.Tensor, ys: torch.Tensor, zs: torch.Tensor,
                   feat: torch.Tensor, grad: torch.Tensor | None = None,
                   world_scale: float = 1.0,
                   lib: ctypes.CDLL | None = None) -> None:
    """``lattice_level_plain`` by the CUDA kernel, bitwise: writes level
    ``l``'s columns of ``feat`` [N, L*F] (and of ``grad`` [3, N, L*F])."""
    F, LF = spec.features, spec.levels * spec.features
    K = corner_bins(spec, l)
    n = xs.shape[0] * ys.shape[0] * zs.shape[0]
    dev = feat.device
    for name, t, shape in (("G", G, (K ** 3, F)), ("xs", xs, xs.shape),
                           ("ys", ys, ys.shape), ("zs", zs, zs.shape),
                           ("feat", feat, (n, LF))):
        if (t.device != dev or t.device.type != "cuda"
                or t.dtype != torch.float32 or tuple(t.shape) != tuple(shape)
                or not t.is_contiguous() or t.ndim != len(shape)):
            raise ValueError(f"lattice_encode: {name} must be a contiguous "
                             f"float32 CUDA tensor of shape {tuple(shape)} "
                             f"on {dev}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
    if F != 2:
        raise ValueError(f"the kernel takes F = 2, not {F}")
    if grad is not None and (grad.shape != (3, n, LF) or grad.device != dev
                             or not grad.is_contiguous()):
        raise ValueError(f"lattice_encode: grad must be [3, {n}, {LF}] on "
                         f"{dev}")
    if n >= 2 ** 31:
        raise ValueError(f"{n} lattice points overflow the kernel's int32")
    if not n:
        return
    fn = _lattice_fn(lib or cuda_build.load("lattice_encode"))
    with torch.cuda.device(dev):
        rc = fn(xs.data_ptr(), ys.data_ptr(), zs.data_ptr(), xs.shape[0],
                ys.shape[0], zs.shape[0], G.data_ptr(), K,
                np.float32(spec.level_scale(l)).item(),
                float(_tangent(spec, l, world_scale)),
                feat.data_ptr() + 4 * F * l,
                None if grad is None else grad.data_ptr() + 4 * F * l, LF,
                n * LF, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lattice_encode kernel launch failed: CUDA error "
                           f"{rc}")
    launches.record("lattice_encode", (n, 1))


def encode_lattice(spec: HashGridSpec, table: torch.Tensor, xs: torch.Tensor,
                   ys: torch.Tensor, zs: torch.Tensor, tables=None,
                   need_grad: bool = False, world_scale: float = 1.0,
                   plain: bool = False):
    """Encode the separable lattice {xs} x {ys} x {zs} (unit-cube axis
    coordinates) -> features [Nx*Ny*Nz, L*F], x-major point order; with
    ``need_grad`` also their derivatives along the world axes
    [3, N, L*F].

    A factored level (``_factored``) interpolates against its corner grid
    (``tables[l]``, or gathered here): on the CPU by
    ``lattice_level_plain``, on the card by the ``lattice_encode`` kernel
    (``plain``: the plain version there too).
    Another level takes the pointwise ``encode`` of the lattice's points;
    the skeleton's lattices (M >= the finest resolution) never do, and
    that path has no derivatives."""
    n = xs.shape[0] * ys.shape[0] * zs.shape[0]
    F, LF = spec.features, spec.levels * spec.features
    feat = xs.new_empty((n, LF))
    grad = xs.new_empty((3, n, LF)) if need_grad else None
    pointwise = None
    for l in range(spec.levels):
        cols = slice(F * l, F * (l + 1))
        G = tables[l] if tables is not None else None
        if G is None and _factored(spec, l, n):
            G = corner_table(spec, table, l)
        if G is None:
            if need_grad:
                raise NotImplementedError(
                    f"level {l} of a {n}-point lattice takes the pointwise "
                    "encode, which has no lattice derivatives")
            if pointwise is None:
                pts = torch.stack(torch.meshgrid(xs, ys, zs, indexing="ij"),
                                  dim=-1).reshape(-1, 3)
                pointwise = encode(spec, table, pts)
            feat[:, cols] = pointwise[:, cols]
        elif plain or xs.device.type == "cpu":
            f, g = lattice_level_plain(spec, G, l, xs, ys, zs, need_grad,
                                       world_scale)
            feat[:, cols] = f
            if need_grad:
                grad[:, :, cols] = g
        else:
            lattice_encode(spec, G, l, xs, ys, zs, feat, grad, world_scale)
    return (feat, grad) if need_grad else feat


def compute_marks(spec: HashGridSpec) -> np.ndarray:
    """Sorted, eps-deduplicated union of all levels' grid-plane coordinates.

    Per level the breakpoints of ``pos = x*s_l + 0.5`` are
    ``k/s_l - 0.5/s_l`` for ``k*unit < 1.5``; the boundary {0, scale} is
    appended; neighbours closer than eps are merged to their midpoint; the
    result is clipped to [0, scale].  Host float64, stored float32.
    """
    vertices = []
    for l in range(spec.levels):
        unit = 1.0 / spec.level_scale(l)
        ks = np.arange(0, math.ceil(1.5 / unit) + 1)
        v = ks * unit
        v = v[v < 1.5] - 0.5 * unit
        vertices.append(v)
    vertices.append(np.array([0.0, spec.scale]))
    marks = np.unique(np.concatenate(vertices))

    keep = np.ones(len(marks), bool)
    marks = marks.copy()
    for i in range(len(marks) - 1):
        if abs(marks[i] - marks[i + 1]) < spec.eps:
            marks[i + 1] = (marks[i] + marks[i + 1]) / 2
            keep[i] = False
    marks = marks[keep]
    marks = marks[(marks >= 0) & (marks <= spec.scale)]
    return marks.astype(np.float32)


class TropicalHashGrid(nn.Module):
    """Hash-grid encoding module that knows its grid marks.

    ``table`` [n_entries, F] is the parameter; ``marks`` [L] (float32, unit
    cube coordinates) is a non-persistent buffer derived from the spec.
    """

    def __init__(self, spec: HashGridSpec,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.spec = spec
        # tiny-cuda-nn's grid init: uniform in [-1e-4, 1e-4]
        table = torch.rand(spec.n_entries, spec.features, generator=generator,
                           dtype=torch.float32) * 2e-4 - 1e-4
        self.table = nn.Parameter(table)
        self.register_buffer("marks", torch.from_numpy(compute_marks(spec)),
                             persistent=False)

    def forward(self, x: torch.Tensor, table_grad: bool = True) -> torch.Tensor:
        """The encode of ``x``; with ``table_grad`` False the table is
        detached, so a gradient through it is in x alone and the backward
        scatters no table gradient."""
        return encode(self.spec, self.table if table_grad
                      else self.table.detach(), x)
