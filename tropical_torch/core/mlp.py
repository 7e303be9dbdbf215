"""Small SDF MLP forward with pre-activation gathering and grouped activations.

Counterpart of ``tropical/core/mlp.py:mlp_forward``:

- a stack of Linear layers with ReLU between them,
- ``gather=True`` collects every hidden layer's *pre-activation* plus the final
  layer's ``x[:,1] - x[:,0]`` into R = (num_layers-1)*num_hidden + 1 "neuron
  distance" columns,
- ``group=k`` replaces ReLU with a pseudo-ReLU whose on/off pattern is shared
  by each consecutive group of k rows, decided by rows 0 and k-1 of the group
  (the 8 corner points of an edge's cube evaluated in one linear region).

Weights are in ``torch.nn.Linear`` layout [out, in].  Each layer is a matmul
followed by a separate bias add, the order the JAX package rounds in.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def mlp_forward(
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    feats: torch.Tensor,
    gather: bool = False,
    group: int = 1,
    eps: float = 1e-4,
) -> Tuple[torch.Tensor, torch.Tensor | None]:
    """Forward through the Linear/ReLU stack.

    Returns (out [B, 2], gathered [B, R] or None).
    """
    n = len(weights)
    x = feats
    pre = []
    for i in range(n):
        x = x @ weights[i].T + biases[i]
        if i != n - 1:
            if gather:
                pre.append(x)
            if group == 1:
                x = torch.relu(x)
            else:
                m = (x[::group] > eps) | (x[group - 1::group] > eps)
                x = x * m.repeat_interleave(group, dim=0).to(x.dtype)
        elif gather:
            pre.append(x[:, 1:] - x[:, :1])
    if gather:
        return x, torch.cat(pre, dim=-1)
    return x, None
