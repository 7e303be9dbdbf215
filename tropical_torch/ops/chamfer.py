"""Nearest-neighbour search for the chamfer metric.

Counterpart of ``tropical/ops/chamfer_tpu.py``.  For each point of ``x`` it
finds the nearest point of ``y`` and the exact squared distance to it:

- ``min_dist_cuda``: the hand-written kernel ``csrc/min_dist.cu`` (replaces
  the Pallas kernel ``min_dist_pallas``), bound with ctypes;
- ``min_dist_plain``: the same function in plain PyTorch, a chunked direct
  difference with a running min/argmin, the reference the tests and the
  GPU smoke run hold the kernel against;
- ``min_nn_distance``: the wrapper the metric calls.  CPU tensors take the
  plain version; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from tropical_torch.ops import cuda_build

# kernel launches since the last reset, counted where the kernel launches
LAUNCHES = {"min_dist": 0}

PLAIN_BLOCK = 4096


def min_dist_plain(x: torch.Tensor, y: torch.Tensor, block: int = PLAIN_BLOCK
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d2 [N] f32, idx [N] int32): for each row of ``x`` [N,3] the squared
    distance to its nearest row of ``y`` [M,3] and that row's index (the first
    one on a tie).  d2 = (dx*dx + dy*dy) + dz*dz, each step rounded, exactly
    as the kernel computes it."""
    n = x.shape[0]
    best = torch.full((n,), torch.inf, dtype=torch.float32, device=x.device)
    best_j = torch.zeros(n, dtype=torch.int64, device=x.device)
    for r0 in range(0, n, block):
        xb = x[r0:r0 + block, None, :]
        bd = best[r0:r0 + block]
        bj = best_j[r0:r0 + block]
        for c0 in range(0, y.shape[0], block):
            d = xb - y[None, c0:c0 + block, :]
            d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
            d2 = d2 + d[..., 2] * d[..., 2]
            dmin, jmin = d2.min(dim=1)
            better = dmin < bd
            bd.copy_(torch.where(better, dmin, bd))
            bj.copy_(torch.where(better, jmin + c0, bj))
    return best, best_j.to(torch.int32)


def _check(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.ndim != 2 or t.shape[1] != 3:
        raise ValueError(f"{name} must have shape [N, 3], got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.shape[0] >= 2 ** 31:
        raise ValueError(f"{name} has too many rows for int32 indices")


def min_dist_cuda(x: torch.Tensor, y: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``min_dist_plain`` as one launch of the CUDA kernel, on the current
    stream of ``x``'s device."""
    _check(x, "x")
    _check(y, "y")
    if x.device != y.device:
        raise ValueError(f"x on {x.device} but y on {y.device}")
    if y.shape[0] == 0:
        raise ValueError("y is empty: no nearest neighbour")
    lib = cuda_build.load("min_dist")
    fn = lib.min_dist_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n = x.shape[0]
    d2 = torch.empty(n, dtype=torch.float32, device=x.device)
    idx = torch.empty(n, dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), y.data_ptr(), n, y.shape[0], d2.data_ptr(),
                idx.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"min_dist kernel launch failed: CUDA error {rc}")
    LAUNCHES["min_dist"] += 1
    return d2, idx


def min_nn_distance(x: torch.Tensor, y: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d2, idx) of each ``x`` row's nearest ``y`` row (see
    ``min_dist_plain``).  The plain version runs only when both tensors lie
    on the CPU; anything else goes to the kernel, which raises on what it
    does not take."""
    if x.device.type == "cpu" and y.device.type == "cpu":
        return min_dist_plain(x, y)
    return min_dist_cuda(x, y)
