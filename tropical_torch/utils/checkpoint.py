"""Checkpoint IO: the JAX package's ``.npz`` params plus reference ``.pth``.

The reference caches ``state_dict`` at models/{d}/{d}_sdf_{size}_{seed}.pth;
the JAX package saves its params as a sibling ``.npz``.  Both load here, and
``save_params`` writes the JAX package's ``.npz`` layout (``table``, ``w{i}``
as [in, out], ``b{i}``), which its ``load_params`` reads.
"""

from __future__ import annotations

import os

import numpy as np


def save_params(path: str, params) -> str:
    """Save a params pytree of numpy arrays (``TorchNet.params_to_numpy``)
    to ``path`` with a forced ``.npz`` suffix; returns the path written."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {"table": np.asarray(params["table"], np.float32)}
    for i, (w, b) in enumerate(zip(params["mlp"]["w"], params["mlp"]["b"])):
        flat[f"w{i}"] = np.asarray(w, np.float32)
        flat[f"b{i}"] = np.asarray(b, np.float32)
    np.savez(path, **flat)
    return path


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
