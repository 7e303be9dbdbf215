"""Procedural meshes (sphere, torus) for training without scan files.

Counterpart of ``tropical/utils/procedural.py`` (numpy on the host, the same
arithmetic, so the meshes are equal bit for bit): the Stanford scans are not
in the repository, and these shapes make train -> extract -> evaluate
self-contained.
"""

from __future__ import annotations

import numpy as np

from tropical_torch.utils.ply import Mesh


def icosphere(subdivisions: int = 4, radius: float = 1.0) -> Mesh:
    """Unit icosahedron subdivided ``subdivisions`` times and projected."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)

    for _ in range(subdivisions):
        edge_mid = {}
        new_faces = []
        verts = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = (np.asarray(verts[a]) + np.asarray(verts[b])) / 2
                m /= np.linalg.norm(m)
                edge_mid[key] = len(verts)
                verts.append(m)
            return edge_mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts)
        faces = np.asarray(new_faces, np.int64)

    return Mesh(np.asarray(verts) * radius, faces)


def torus(R: float = 0.7, r: float = 0.3, nu: int = 96, nv: int = 48) -> Mesh:
    """Torus with major radius R, minor radius r."""
    u = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    v = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    x = (R + r * np.cos(vv)) * np.cos(uu)
    y = (R + r * np.cos(vv)) * np.sin(uu)
    z = r * np.sin(vv)
    verts = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=-1)

    faces = []
    for i in range(nu):
        for j in range(nv):
            a = i * nv + j
            b = ((i + 1) % nu) * nv + j
            c = ((i + 1) % nu) * nv + (j + 1) % nv
            d = i * nv + (j + 1) % nv
            faces += [[a, b, c], [a, c, d]]
    return Mesh(verts, np.asarray(faces, np.int64))
