"""Initial edge skeleton on the hash-grid mark lattice.

Counterpart of ``tropical/extract/skeleton.py``: sweep the marks^3 lattice
in chunks and keep, in ``"sign"`` mode, the lattice edges whose endpoint
sign vectors differ (an edge whose endpoints share every neuron sign is
never split and is pruned by the subdivision loop, so it can never reach
the final skeleton); in ``"distance"`` mode, the edges whose endpoints both
lie within the Lipschitz bound sqrt(3) * 2 * max_cell * max_grad of the
surface, max_grad the largest |grad sdf| of the chunk.  The device engine
(``extract/device.py``) builds its skeleton on the card in one block.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# lattice points per chunk side
UNIT = 128

AXIS_SLICES = (((slice(1, None), slice(None), slice(None)),
                (slice(None, -1), slice(None), slice(None))),
               ((slice(None), slice(1, None), slice(None)),
                (slice(None), slice(None, -1), slice(None))),
               ((slice(None), slice(None), slice(1, None)),
                (slice(None), slice(None), slice(None, -1))))


def get_hypercube(d: int, size: float, device: torch.device | str):
    """Fallback start: hypercube vertices/edges/faces, on ``device``."""
    x = np.array([-size, size], np.float32)
    grids = np.stack(np.meshgrid(x, x, x, indexing="ij"), axis=-1)
    vertices = grids.reshape(-1, 3)
    edges = []
    for i in range(vertices.shape[0]):
        for j in range(i + 1, vertices.shape[0]):
            if ((vertices[i] * vertices[j]) < 0).sum() == 1:
                edges.append([i, j])
    faces = [[0, 3, 5, 1], [0, 2, 8, 4], [3, 4, 10, 7],
             [1, 2, 9, 6], [8, 9, 11, 10], [7, 11, 6, 5]]
    return (torch.from_numpy(vertices).to(device),
            torch.tensor(edges, dtype=torch.int64, device=device), faces)


def grid_skeleton(net, mode: str = "sign"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pruned initial skeleton, ``mode`` "sign" or "distance".

    Returns (vertices [V,3] world coords float32, edges [E,2] int64 with
    compacted vertex ids), on the net's device.  Chunks overlap by one
    lattice plane, so edges inside a shared plane appear once per chunk,
    exactly as in the JAX package.
    """
    dev = net.device
    marks = net.marks
    L = marks.shape[0]
    eps = net.eps
    if mode not in ("sign", "distance"):
        raise ValueError(f"unknown pruning mode {mode!r}")
    max_len = float((marks[1:] - marks[:-1]).max())

    edge_chunks = []
    for i0 in range(0, L, UNIT - 1):
        for j0 in range(0, L, UNIT - 1):
            for k0 in range(0, L, UNIT - 1):
                start = (i0, j0, k0)
                axes = [torch.arange(s, min(L, s + UNIT), device=dev)
                        for s in start]
                indices = torch.stack(torch.meshgrid(*axes, indexing="ij"),
                                      dim=-1)  # [U,U,U,3]
                x = net.preprocess_inverse(marks[indices].reshape(-1, 3))
                serial = (indices[..., 0] * L * L + indices[..., 1] * L
                          + indices[..., 2])

                if mode == "distance":
                    sdf, grad = net.sdf_and_grad(x)
                    max_grad = float(torch.linalg.vector_norm(
                        grad, dim=-1).max())
                    # the bound in float64, as the JAX package's numpy
                    bound = np.sqrt(3.0) * 2 * max_len * max_grad
                    near = (sdf.abs()[:, 0].double() <= bound).reshape(
                        indices.shape[:-1])
                    for sl_a, sl_b in AXIS_SLICES:
                        m = near[sl_a] & near[sl_b]
                        edge_chunks.append(torch.stack(
                            [serial[sl_a][m], serial[sl_b][m]], dim=-1))
                    continue
                out = net.outputs(x)
                sgn = torch.where(out > 0, 1, -1).to(torch.int8)
                sgn[out.abs() <= eps] = 0
                future = sgn.reshape(*indices.shape[:-1], -1)
                for sl_a, sl_b in AXIS_SLICES:
                    m = (future[sl_a] != future[sl_b]).any(-1)
                    edge_chunks.append(torch.stack(
                        [serial[sl_a][m], serial[sl_b][m]], dim=-1))

    edges = torch.cat(edge_chunks, dim=0)
    if edges.shape[0] == 0:
        return (torch.empty((0, 3), dtype=torch.float32, device=dev),
                torch.empty((0, 2), dtype=torch.int64, device=dev))

    v_idx, inverse = torch.unique(edges.reshape(-1), return_inverse=True)
    edges = inverse.reshape(-1, 2)

    # serialized id -> per-axis mark indices -> world coords
    p = torch.stack([v_idx // (L * L), (v_idx // L) % L, v_idx % L], dim=-1)
    vertices = net.preprocess_inverse(marks[p])
    return vertices, edges
