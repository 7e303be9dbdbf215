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
import functools
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


def _group(spec: HashGridSpec) -> int:
    """Threads a point: the power of two at or above the level count."""
    return 1 << (spec.levels - 1).bit_length()


@functools.lru_cache(maxsize=None)
def _level_rows(spec: HashGridSpec, device: torch.device) -> torch.Tensor:
    """Per-level constants on ``device``, one row a level as the kernel's
    ``LevelRow``: f32 scale (as its bits), offset, entries, resolution,
    whether the level hashes (int32 [L, 5])."""
    rows = np.array([[np.float32(spec.level_scale(l)).view(np.int32),
                      spec.level_offsets[l], spec.level_entries(l),
                      spec.level_resolution(l), int(spec.level_uses_hash(l))]
                     for l in range(spec.levels)], np.int32)
    return torch.from_numpy(rows).to(device)


@functools.lru_cache(maxsize=None)
def _launchers(lib: ctypes.CDLL):
    """The library's three launch functions, their C signatures declared
    once per library."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    head = [ptr, ptr, ptr, i32, i32, i32, ctypes.c_uint, i32]
    fns = (lib.hashgrid_encode_fwd_launch, lib.hashgrid_encode_bwd_launch,
           lib.hashgrid_encode_bwd_bwd_launch)
    for fn, tail in zip(fns, ([ptr, ptr], [ptr, ptr, ptr, ptr],
                              [ptr, ptr, ptr, ptr, ptr, ptr])):
        fn.argtypes = head + tail
        fn.restype = ctypes.c_int
    return fns


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


def _check_inputs(spec: HashGridSpec, table: torch.Tensor, x: torch.Tensor,
                  **grads: torch.Tensor) -> int:
    """Check the kernels' inputs; returns B."""
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
    return n


def _launch(fn, name: str, spec: HashGridSpec, table: torch.Tensor,
            x: torch.Tensor, n: int, *pointers) -> None:
    """Launch ``fn`` on the current stream of x's device and count it."""
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), table.data_ptr(),
                _level_rows(spec, x.device).data_ptr(), spec.levels,
                _group(spec), spec.n_entries, (1 << spec.log2_table) - 1,
                n, *pointers, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launches.record(name, (n, spec.levels))


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def hashgrid_encode_fwd(spec: HashGridSpec, table: torch.Tensor,
                        x: torch.Tensor) -> torch.Tensor:
    """``encode_plain`` by the CUDA kernel, bitwise: features [B, L*2]."""
    n = _check_inputs(spec, table, x)
    feat = torch.empty((n, spec.levels * 2), dtype=torch.float32,
                       device=x.device)
    if n:
        fwd, _, _ = _launchers(cuda_build.load("hashgrid_encode"))
        _launch(fwd, "hashgrid_encode_fwd", spec, table, x, n, feat.data_ptr())
    return feat


def hashgrid_encode_bwd(spec: HashGridSpec, table: torch.Tensor,
                        x: torch.Tensor, dfeat: torch.Tensor,
                        need_x: bool = True, need_table: bool = True):
    """``encode_backward_plain`` by the CUDA kernel: dx bitwise, dtable an
    ``atomicAdd`` scatter (its order of adds is free)."""
    n = _check_inputs(spec, table, x, dfeat=dfeat)
    dx = (torch.empty((n, 3), dtype=torch.float32, device=x.device)
          if need_x else None)
    dtable = torch.zeros_like(table) if need_table else None
    if n and (need_x or need_table):
        _, bwd, _ = _launchers(cuda_build.load("hashgrid_encode"))
        _launch(bwd, "hashgrid_encode_bwd", spec, table, x, n,
                dfeat.data_ptr(), _ptr(dx), _ptr(dtable))
    return dx, dtable


def hashgrid_encode_bwd_bwd(spec: HashGridSpec, table: torch.Tensor,
                            x: torch.Tensor, dfeat: torch.Tensor,
                            ddx: torch.Tensor, need_dfeat: bool = True,
                            need_table: bool = True, need_x: bool = True):
    """``encode_double_backward_plain`` by the CUDA kernel: d_dfeat and dx2
    bitwise, dtable2 an ``atomicAdd`` scatter."""
    n = _check_inputs(spec, table, x, dfeat=dfeat, ddx=ddx)
    dev = x.device
    d_dfeat = (torch.empty((n, spec.levels * 2), dtype=torch.float32,
                           device=dev) if need_dfeat else None)
    dtable2 = torch.zeros_like(table) if need_table else None
    dx2 = (torch.empty((n, 3), dtype=torch.float32, device=dev)
           if need_x else None)
    if n and (need_dfeat or need_table or need_x):
        _, _, bwd_bwd = _launchers(cuda_build.load("hashgrid_encode"))
        _launch(bwd_bwd, "hashgrid_encode_bwd_bwd", spec, table, x, n,
                dfeat.data_ptr(), ddx.data_ptr(), _ptr(d_dfeat),
                _ptr(dtable2), _ptr(dx2))
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return encode(self.spec, self.table, x)
