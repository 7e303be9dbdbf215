"""PyTorch/CUDA port of the ``tropical`` package for one NVIDIA Hopper GPU.

Same layout and module names as ``tropical/``; every module here keeps its
own copy of what it needs and imports nothing of the JAX package.  Entry
points take an explicit ``device`` and run on ``cuda`` unless the caller asks
for ``cpu``; without a card they raise instead of carrying on on the CPU.

TF32 stays off: the extraction's sign tests run at eps = 1e-4 and the
chamfer distances need full f32.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device to run on; raises if CUDA is asked for but absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: pass device='cpu' (CLI: --device cpu) "
            "to run on the CPU")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued device work (host timers around CUDA work need it)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
