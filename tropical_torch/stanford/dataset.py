"""Training data: points around a mesh, labelled by signed distance.

Counterpart of ``tropical/stanford/dataset.py``.  The points are drawn on
the host from the caller's ``numpy.random.Generator``, with its calls in the
JAX package's order, so the points and the batch order equal the JAX
package's bit for bit; the labels are computed on the device
(``ops/mesh_queries.MeshQuery.signed_distance``) and ``batches`` yields
device tensors.

``sphere`` and ``torus`` are procedural; the Stanford scans load from the
same PLY paths under ``tropical/stanford/`` when they are there, and
``bunny_npy`` rebuilds its mesh from the density grid
``tropical/stanford/models/bunny.npy`` by marching tetrahedra, as the JAX
package does (none of them is in the repository).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tropical_torch import resolve_device
from tropical_torch.ops.mesh_queries import MeshQuery
from tropical_torch.utils.isosurface import (grid_tetrahedra,
                                             marching_tetrahedra)
from tropical_torch.utils.ply import Mesh, read_ply
from tropical_torch.utils.procedural import icosphere, torus

SCANS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                         "..", "tropical", "stanford")

# name -> PLY path under SCANS_DIR
_PLY_PATHS = {
    "bunny": "bunny/reconstruction/bun_zipper.ply",
    "armadillo": "armadillo/Armadillo.ply",
    "drill": "drill/reconstruction/drill_shaft_vrip.ply",
    "lucy": "lucy/lucy_res10.ply",
    "dragon": "dragon_recon/dragon_vrip_res3.ply",
    "happy": "happy_recon/happy_vrip_res3.ply",
}

_PROCEDURAL = {
    "sphere": lambda: icosphere(4),
    "torus": lambda: torus(),
}


class StanfordDataset:
    """``n_samples`` resampled (point, signed distance) pairs around the
    target mesh, on ``device``."""

    def __init__(self, name: str = "dragon",
                 rng: np.random.Generator | None = None,
                 n_samples: int = 50000,
                 device: str | torch.device = "cuda"):
        self.R = 0.8  # world scale divisor applied at export
        self.name = name
        self.rng = rng or np.random.default_rng(0)
        self.n_samples = n_samples
        self.device = resolve_device(device)
        self.init()
        self.resample()

    def __len__(self) -> int:
        return self.n_samples

    def init(self):
        name = self.name.lower()
        if name in _PROCEDURAL:
            print(f"Building procedural {name} mesh ...")
            self.mesh = _PROCEDURAL[name]()
        elif name == "bunny_npy":
            # the density-grid variant: the mesh rebuilt from models/bunny.npy
            # (read by path, as the committed checkpoints are) by marching
            # tetrahedra over the grid, already in [-R, R]
            print("Loading bunny.npy ...")
            density = np.load(os.path.join(SCANS_DIR, "models", "bunny.npy"))
            n = density.shape[0]
            g = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), -1)
            points = (g.reshape(-1, 3) / 32.0 - 1.0) * self.R
            verts, tris = marching_tetrahedra(
                torch.from_numpy(points).to(self.device),
                grid_tetrahedra(n, n, self.device),
                torch.from_numpy(density.reshape(-1)).to(self.device))
            self.mesh = Mesh(verts.cpu().numpy(), tris.cpu().numpy())
        else:
            rel = _PLY_PATHS.get(name)
            if rel is None:
                raise ValueError(f"unknown dataset {self.name}")
            path = os.path.normpath(os.path.join(SCANS_DIR, rel))
            print(f"Loading {os.path.basename(rel)} ...")
            if not os.path.isfile(path):
                raise FileNotFoundError(
                    f"{path} not found: download the Stanford scans into "
                    f"tropical/stanford/ (the reference's layout), or use "
                    f"the procedural 'sphere'/'torus' datasets")
            self.mesh = read_ply(path)
        print("Done.", flush=True)

        # the longest side of the bounding box to 2, centred (bunny_npy is
        # in [-R, R] already)
        if name != "bunny_npy":
            vertices = np.asarray(self.mesh.vertices, np.float64)
            scale = (vertices.max(0) - vertices.min(0)).max()
            vertices = vertices / scale * 2
            vertices -= (vertices.max(0) + vertices.min(0)) / 2
            self.mesh = Mesh(vertices, self.mesh.faces)

        self.query = MeshQuery(self.mesh.vertices, self.mesh.faces,
                               self.device)
        print("Mesh query initialized.", flush=True)

    def resample(self):
        """Draw new jittered points near the surface and label them (inside
        is positive)."""
        vertices = np.asarray(self.mesh.vertices, np.float32)
        d = 0.4
        if self.name.lower() != "lucy":  # lucy has too many vertices
            vertices = np.tile(vertices, (10, 1))
        if vertices.shape[0] < len(self):  # drill has few vertices
            vertices = np.tile(np.asarray(self.mesh.vertices, np.float32),
                               (30, 1))
            d = 0.2
        perm = self.rng.permutation(vertices.shape[0])[:len(self)]
        points = vertices[perm] + (
            self.rng.random((len(self), 3), np.float32) * d - d / 2)

        if self.name.lower() in _PROCEDURAL:
            # the procedural shapes mix in 20 % uniform samples over the
            # extraction canvas: without far-field supervision the tanh head
            # grazes zero away from the surface (a phantom shell)
            n_vol = len(self) // 5
            vol = (self.rng.random((n_vol, 3), np.float32) * 2.4 - 1.2)
            points[:n_vol] = vol

        self.X = torch.from_numpy(points.astype(np.float32)).to(self.device)
        self.Y = self.query.signed_distance(self.X)

    def batches(self, batch_size: int, shuffle: bool = True):
        """Mini-batches (x [B, 3], y [B]) on the device, in the order of one
        permutation drawn from the generator."""
        order = (self.rng.permutation(len(self)) if shuffle
                 else np.arange(len(self)))
        order = torch.from_numpy(order).to(self.device)
        for i in range(0, len(self), batch_size):
            sel = order[i:i + batch_size]
            yield self.X[sel], self.Y[sel]
