"""Region (sign-vector) bookkeeping: Def. 3.4 adjacency via zero expansion.

Counterpart of ``tropical/core/regions.py``, on torch tensors on the net's
device.  A vertex's ternary sign vector m in {-1,0,+1}^(D+R) (the first D
columns are the {0,1} grid mask paired with integer cell ``offset``s) is
expanded into all 2^(#zeros) adjacent-region replicas; grid columns map their
+-1 pattern to the cell index ``offset`` or ``offset-1``.  Regions are
identified by row-unique ids; the region->vertex table then yields candidate
connecting edges, filtered to pairs sharing at least one common zero plane
(grid planes must also share the cell offset).
"""

from __future__ import annotations

from typing import Tuple

import torch


def _sign_patterns(k: int, device: torch.device) -> torch.Tensor:
    """All 2^k vectors over {-1, +1} [2^k, k], first column slowest (the
    order of ``torch.cartesian_prod``)."""
    if k == 0:
        return torch.zeros((1, 0), dtype=torch.int64, device=device)
    bits = torch.arange(k - 1, -1, -1, device=device)
    codes = torch.arange(1 << k, device=device)[:, None]
    return ((codes >> bits) & 1) * 2 - 1


def regions_to_vertices(m: torch.Tensor, offset: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand sign vectors into adjacent-region replicas.

    Args:
        m: [N, C] ternary sign matrix (first D columns: {0,1} grid mask).
        offset: [N, D] integer cell offsets.

    Returns:
        (r_idx [M], idx_org [M]): region id per replica and the original row.
        Replicas of a row are contiguous; rows are grouped by ascending
        zero-count, and this order fixes the vertex order of each region's
        row in :func:`region_table`.
    """
    dev = m.device
    if m.numel() == 0:
        z = torch.empty(0, dtype=torch.int64, device=dev)
        return z, z
    m = m.to(torch.int64)
    offset = offset.to(torch.int64)
    D = offset.shape[1]
    C = m.shape[1]

    k = (m == 0).sum(1)
    aug_list, idx_list = [], []
    for ki in torch.unique(k).tolist():
        rows = torch.nonzero(k == ki).squeeze(1)
        dim = 1 << ki
        rep = m[rows].repeat_interleave(dim, dim=0)
        # each replica row has exactly ki zeros: fill them, in column order,
        # with that replica's sign pattern
        rep[rep == 0] = _sign_patterns(ki, dev).repeat(rows.shape[0], 1).reshape(-1)
        # grid columns: -1 pattern -> cell offset-1, +1 -> offset; mask 1 -> offset
        rep[:, :D] = (torch.div(rep[:, :D] - 1, 2, rounding_mode="floor")
                      + offset[rows].repeat_interleave(dim, dim=0))
        aug_list.append(rep)
        idx_list.append(rows.repeat_interleave(dim))

    m_aug = torch.cat(aug_list, dim=0)
    idx_org = torch.cat(idx_list, dim=0)
    # Region ids by packed-key grouping: after expansion the neuron columns
    # are one sign bit each and the grid columns small cell indices, so each
    # row packs into a few int64 keys.  Bits are packed with shifts and a
    # sum (CUDA has no int64 matrix product).
    kg = torch.zeros(m_aug.shape[0], dtype=torch.int64, device=dev)
    for dax in range(D):
        # +2: grid values reach offset-1 >= -2 under the -1 wrap semantics
        kg = (kg << 21) | (m_aug[:, dax] + 2)
    nb = (m_aug[:, D:] > 0).to(torch.int64)
    keys = [kg]
    for c0 in range(0, C - D, 62):
        w = nb[:, c0:c0 + 62]
        keys.append((w << torch.arange(w.shape[1], device=dev)).sum(1))
    _, r_idx = torch.unique(torch.stack(keys, dim=1), dim=0, return_inverse=True)
    return r_idx, idx_org


def region_table(r_idx: torch.Tensor, idx_org: torch.Tensor) -> torch.Tensor:
    """Left-aligned (Region x maxlen) vertex-index table, padded with -1.

    May contain duplicated vertex indices (replicas of the same vertex landing
    in the same region)."""
    dev = r_idx.device
    if r_idx.numel() == 0:
        return torch.empty((0, 0), dtype=torch.int64, device=dev)
    order = torch.argsort(r_idx, stable=True)
    rs = r_idx[order]
    vs = idx_org[order]
    _, counts = torch.unique_consecutive(rs, return_counts=True)
    maxlen = int(counts.max())
    out = torch.full((counts.shape[0], maxlen), -1, dtype=torch.int64,
                     device=dev)
    mask = torch.arange(maxlen, device=dev)[None, :] < counts[:, None]
    out[mask] = vs
    return out


def edge_vertices(m: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """Connecting edges among same-region vertices sharing a zero plane.

    Returns [P, 2] pairs of *local* row indices into m/offset, each pair
    sorted, the list deduplicated in lexicographic order.
    """
    dev = m.device
    m = m.to(torch.int64)
    offset = offset.to(torch.int64)
    r_idx, aug = regions_to_vertices(m, offset)
    table = region_table(r_idx, aug)
    empty = torch.empty((0, 2), dtype=torch.int64, device=dev)
    if table.numel() == 0:
        return empty

    pairs = []
    for i in range(1, table.shape[1]):
        a = table[:, i]
        valid = a != -1  # left-aligned: column i valid implies 0..i-1 valid
        av = a[valid]
        for j in range(i):
            pairs.append(torch.stack([av, table[valid, j]], dim=1))
    if not pairs:
        return empty
    out = torch.cat(pairs, dim=0)
    out = torch.sort(out, dim=1).values
    # lexicographic dedup through one int64 key per pair
    n = m.shape[0]
    key = torch.unique(out[:, 0] * n + out[:, 1])
    out = torch.stack([key // n, key % n], dim=1)
    out = out[out[:, 0] != out[:, 1]]
    if out.numel() == 0:
        return out

    # pairs must share >= 1 common zero plane; grid-plane matches must also
    # share the cell offset
    D = offset.shape[1]
    chk1 = (m == 0)[out]  # [P, 2, C]
    both = chk1[:, 0] & chk1[:, 1]
    zero_counts = both.sum(-1)
    chk2 = offset[out]
    zero_counts -= (both[:, :D] & (chk2[:, 0] != chk2[:, 1])).sum(-1)
    return out[zero_counts >= 1]


def row_unique_inverse(m: torch.Tensor) -> torch.Tensor:
    """Inverse indices of the row-wise unique of ``m`` (int64 [N])."""
    if m.shape[0] == 0:
        return torch.empty(0, dtype=torch.int64, device=m.device)
    return torch.unique(m, dim=0, return_inverse=True)[1]
