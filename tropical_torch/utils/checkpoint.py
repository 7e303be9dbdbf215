"""Checkpoint IO: the JAX package's ``.npz`` params plus reference ``.pth``.

The reference caches ``state_dict`` at models/{d}/{d}_sdf_{size}_{seed}.pth;
the JAX package saves its params as a sibling ``.npz``.  Both load here.
"""

from __future__ import annotations

import os

import numpy as np


def load_params(path: str):
    """The ``.npz`` params pytree as numpy arrays:
    {"table", "mlp": {"w": [...], "b": [...]}} with w in [in, out] layout."""
    with np.load(path) as data:
        n_layers = sum(1 for k in data.files if k.startswith("w"))
        return {
            "table": data["table"],
            "mlp": {"w": [data[f"w{i}"] for i in range(n_layers)],
                    "b": [data[f"b{i}"] for i in range(n_layers)]},
        }


def find_checkpoint(path_pth: str) -> str | None:
    """Prefer the exact reference .pth path, else the .npz sibling."""
    if os.path.isfile(path_pth):
        return path_pth
    npz = path_pth + ".npz"
    if os.path.isfile(npz):
        return npz
    return None


def load_into(net, path: str):
    if path.endswith(".npz"):
        return net.params_from_numpy(load_params(path))
    return net.load_reference_checkpoint(path)
