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
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import cached_property
from typing import Sequence

import numpy as np
import torch
from torch import nn

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


def _encode_level(spec: HashGridSpec, table: torch.Tensor, x: torch.Tensor,
                  l: int) -> torch.Tensor:
    """One level's pointwise 8-corner gather encode: [B, D] -> [B, F]."""
    D = spec.dim
    pos = x * spec.level_scale(l) + 0.5
    pos_grid = torch.floor(pos)
    frac = pos - pos_grid
    pos_grid = pos_grid.to(torch.int64)
    off = spec.level_offsets[l]

    feat = None
    for corner in range(1 << D):
        bits = [(corner >> d) & 1 for d in range(D)]
        cp = [pos_grid[..., d] + bits[d] for d in range(D)]
        idx = (off + _level_indices(spec, l, cp)).clamp(0, table.shape[0] - 1)
        w = None
        for d in range(D):
            wd = frac[..., d] if bits[d] else 1.0 - frac[..., d]
            w = wd if w is None else w * wd
        term = w[..., None] * table[idx]
        feat = term if feat is None else feat + term
    return feat


def encode(spec: HashGridSpec, table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Encode points ``x`` [B, D] in [0,1]^D -> features [B, L*F] (level-major).

    Gradients w.r.t. ``x`` flow through the trilinear weights (floor has
    zero gradient): the piecewise-trilinear structure the extraction uses."""
    return torch.cat([_encode_level(spec, table, x, l)
                      for l in range(spec.levels)], dim=-1)


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
