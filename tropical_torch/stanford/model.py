"""SDF network presets for the Stanford workload.

Counterpart of ``tropical/stanford/model.py``: hash encoding (L=4, F=2) into
an [8, 16, 16, 2] ReLU MLP.
"""

from __future__ import annotations

import torch

from tropical_torch.core.net import NetSpec, TorchNet

# model-size -> (r_min, r_max)
SIZE_PRESETS = {
    "small": (2, 32),
    "medium": (4, 64),
    "large": (8, 128),
}


def Net(num_layers: int = 3, num_hidden: int = 16, levels: int = 4,
        r_min: int = 2, r_max: int = 32, T: int = 19, eps: float = 1e-4,
        device: str | torch.device = "cuda",
        generator: torch.Generator | None = None) -> TorchNet:
    spec = NetSpec(num_layers=num_layers, num_hidden=num_hidden, levels=levels,
                   r_min=r_min, r_max=r_max, T=T, eps=eps)
    return TorchNet(spec, device=device, generator=generator)


def net_for_size(model_size: str, dataset: str = "", seed: int = 0,
                 device: str | torch.device = "cuda") -> TorchNet:
    """The blessed config for a model size, initialised from ``seed``.

    T=21 only for large bunny, else 19."""
    r_min, r_max = SIZE_PRESETS[model_size]
    T = 21 if (model_size == "large" and "bunny" in dataset.lower()) else 19
    return Net(num_layers=3, num_hidden=16, levels=4, r_min=r_min, r_max=r_max,
               T=T, device=device,
               generator=torch.Generator().manual_seed(seed))
