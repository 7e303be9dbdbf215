"""Nearest-neighbour search for the chamfer metric.

Counterpart of ``tropical/ops/chamfer_tpu.py``.  For each point of ``x`` it
finds the nearest point of ``y`` and the exact squared distance to it:

- ``min_dist_cuda``: the hand-written kernel ``csrc/min_dist.cu`` (replaces
  the Pallas kernel ``min_dist_pallas``), bound with ctypes.  It scans with
  the FMA expansion |y|^2 - 2 x.y and recomputes the exact distance only for
  pairs within ``expansion_margin`` of the running best, so its result is
  still the plain version's, bit for bit;
- ``min_dist_plain``: the same function in plain PyTorch, a chunked direct
  difference with a running min/argmin, the reference the tests and the
  GPU smoke run hold the kernel against;
- ``min_nn_distance``: the wrapper the metric calls.  CPU tensors take the
  plain version; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from tropical_torch.ops import cuda_build, launches

# the y range is cut into at most this many splits, each at least
# MIN_SPLIT_PANELS panels long (each split starts its rows' thresholds
# afresh, so many short splits spend more on the exact path than they gain)
MAX_SPLITS = 64
MIN_SPLIT_PANELS = 8

PLAIN_BLOCK = 4096

# (library, CUDA device index) -> its kernel_config
_CONFIGS: Dict[Tuple[ctypes.CDLL, int], Dict[str, int]] = {}


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


def expansion_margin(xx: torch.Tensor, ymax_sq: torch.Tensor,
                     best: torch.Tensor) -> torch.Tensor:
    """How far the kernel's filter value d' = fl(|y|^2 - 2 x.y) (three FMAs)
    may lie from d2 - |x|^2, for a pair whose f32 distance d2 is at most
    ``best``: 2^-20 ((|x| + |y|max)^2 + best) + 2^-126, with ``xx`` = f32
    |x|^2 and ``ymax_sq`` = the largest f32 |y|^2.  The derivation is in
    ``csrc/min_dist.cu``, which computes the same formula on the card."""
    s = torch.sqrt(xx) + torch.sqrt(ymax_sq)
    return (s * s + best) * 2.0 ** -20 + 2.0 ** -126


def split_plan(n: int, m: int, sms: int, resident: int, rows_per_block: int,
               panel: int) -> Tuple[int, int]:
    """(splits, panels per split) of the y range for an n x m search on a
    card with ``sms`` SMs that each hold ``resident`` scan blocks at once.
    The grid stays within one wave (a block that waits for a second wave
    runs alone on its SM at the end); within it, the split count that gives
    the busiest SM the least work wins, and on a tie the larger one, whose
    extra warps hide more latency."""
    x_blocks = max(1, -(-n // rows_per_block))
    panels = -(-m // panel)
    most = max(1, min(MAX_SPLITS, panels // MIN_SPLIT_PANELS,
                      sms * resident // x_blocks))

    def busiest(s):  # blocks on the busiest SM, per unit of work
        return -(-x_blocks * s // sms) / s

    splits = min(range(1, most + 1), key=lambda s: (busiest(s), -s))
    per_split = -(-panels // splits)
    return -(-panels // per_split), per_split


def kernel_config(lib: ctypes.CDLL, index: int) -> Dict[str, int]:
    """The kernel's compiled shape (threads, rows per block, panel, group),
    how many scan blocks one SM of CUDA device ``index`` holds at once, and
    that device's SM count.  Queried once per library and device; the first
    query also declares the library's C signatures."""
    cfg = _CONFIGS.get((lib, index))
    if cfg is None:
        ptr = ctypes.c_void_p
        lib.min_dist_config.argtypes = [ptr]
        lib.min_dist_config.restype = ctypes.c_int
        lib.min_dist_scratch_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.min_dist_scratch_bytes.restype = ctypes.c_size_t
        lib.min_dist_launch.argtypes = ([ptr, ptr] + [ctypes.c_int] * 4
                                        + [ptr] * 4)
        lib.min_dist_launch.restype = ctypes.c_int
        out = (ctypes.c_int * 5)()
        with torch.cuda.device(index):
            rc = lib.min_dist_config(out)
        if rc != 0:
            raise RuntimeError(
                f"min_dist occupancy query failed: CUDA error {rc}")
        cfg = dict(zip(("threads", "rows_per_block", "panel", "group",
                        "resident"), out))
        props = torch.cuda.get_device_properties(index)
        cfg["sms"] = props.multi_processor_count
        _CONFIGS[(lib, index)] = cfg
    return cfg


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


def run_kernel(lib: ctypes.CDLL, x: torch.Tensor, y: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One search by the kernel in ``lib`` on checked inputs with at least
    one x row: the split plan, the scratch and the launch, which raises on a
    non-zero CUDA error.  Counts nothing (``min_dist_cuda`` does)."""
    n, m = x.shape[0], y.shape[0]
    dev = x.device
    cfg = kernel_config(lib, dev.index)
    splits, per_split = split_plan(n, m, cfg["sms"], cfg["resident"],
                                   cfg["rows_per_block"], cfg["panel"])
    with torch.cuda.device(dev):
        scratch = torch.empty(lib.min_dist_scratch_bytes(n, m),
                              dtype=torch.uint8, device=dev)
        d2 = torch.empty(n, dtype=torch.float32, device=dev)
        idx = torch.empty(n, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.min_dist_launch(x.data_ptr(), y.data_ptr(), n, m, splits,
                                 per_split, scratch.data_ptr(), d2.data_ptr(),
                                 idx.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"min_dist kernel launch failed: CUDA error {rc}")
    return d2, idx


def min_dist_cuda(x: torch.Tensor, y: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``min_dist_plain`` by the CUDA kernel, on the current stream of
    ``x``'s device."""
    _check(x, "x")
    _check(y, "y")
    if x.device != y.device:
        raise ValueError(f"x on {x.device} but y on {y.device}")
    if y.shape[0] == 0:
        raise ValueError("y is empty: no nearest neighbour")
    if x.shape[0] + y.shape[0] >= 2 ** 31:
        raise ValueError("x and y have too many rows together for int32 "
                         "indices")
    n, m = x.shape[0], y.shape[0]
    if n == 0:  # nothing to search, nothing launched
        return (torch.empty(0, dtype=torch.float32, device=x.device),
                torch.empty(0, dtype=torch.int32, device=x.device))
    d2, idx = run_kernel(cuda_build.load("min_dist"), x, y)
    launches.record("min_dist", (n, m))
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
