"""Rays and points hard for the BVH's culling and tie rule, shared by the
CPU tests, the GPU tests and ``chip_smoke.py``.  Imports neither jax nor the
JAX package."""

import numpy as np
import torch


def adversarial_rays(tris, n_random, seed):
    """(o, d) [N, 3] f32 for a mesh ``tris`` [T, 3, 3], on its device: from
    the origin in ``n_random`` random directions first; then along the axes
    and in the axis planes (zero components); through vertices and edge
    midpoints (shared by neighbours: ties); from origins on the faces of
    leaf boxes (a vertex's coordinates), along zero-component directions;
    and from points near the mesh in random directions."""
    rng = np.random.default_rng(seed)
    v = tris.reshape(-1, 3).cpu().numpy()
    d = rng.normal(size=(n_random, 3))
    axes = np.concatenate([np.eye(3), -np.eye(3)])
    plane = rng.normal(size=(60, 3))
    plane[np.arange(60), np.arange(60) % 3] = 0.0
    through = np.concatenate([v[rng.integers(0, len(v), 80)],
                              (v[0::3][:80] + v[1::3][:80]) / 2])
    dirs = np.concatenate([d, axes, plane, through])
    o = np.zeros_like(dirs)
    on_face = v[rng.integers(0, len(v), 60)]
    face_dirs = np.concatenate([axes, plane])[rng.integers(0, 66, 60)]
    near = v[rng.integers(0, len(v), 100)] + rng.normal(scale=0.05,
                                                       size=(100, 3))
    o = np.concatenate([o, on_face, near])
    dirs = np.concatenate([dirs, face_dirs, rng.normal(size=(100, 3))])
    dirs = dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
    return (torch.from_numpy(o.astype(np.float32)).to(tris.device),
            torch.from_numpy(dirs.astype(np.float32)).to(tris.device))


def near_points(tris, n, seed):
    """n points [n, 3] f32 on the device of ``tris``: within about 0.05 of
    the mesh's vertices, a tenth of them on a vertex (distance 0)."""
    rng = np.random.default_rng(seed)
    v = tris.reshape(-1, 3).cpu().numpy()
    p = v[rng.integers(0, len(v), n)] + rng.normal(scale=0.05, size=(n, 3))
    p[: n // 10] = v[rng.integers(0, len(v), n // 10)]
    return torch.from_numpy(p.astype(np.float32)).to(tris.device)


def centre_points(tris, n, seed, radius=0.05):
    """n points [n, 3] f32 on the device of ``tris``, uniform in the ball of
    ``radius`` about the centre of the mesh's box: deep inside a closed
    mesh, where every box lies about as near as the nearest triangle."""
    rng = np.random.default_rng(seed)
    v = tris.reshape(-1, 3).cpu().numpy().astype(np.float64)
    centre = (v.min(axis=0) + v.max(axis=0)) / 2
    d = rng.normal(size=(n, 3))
    d *= radius * rng.uniform(size=(n, 1)) ** (1 / 3) / np.linalg.norm(
        d, axis=1, keepdims=True)
    return torch.from_numpy((centre + d).astype(np.float32)).to(tris.device)


def closest_sets(tris, n, seed):
    """Named point sets [*, 3] f32 on the device of ``tris`` for the
    closest-point query: ``centre`` (``centre_points``), ``vertices`` (n of
    the mesh's vertices: distance 0), ``edges`` (n edge midpoints, each on
    two triangles), ``duplicates`` (n copies of 4 points near the mesh, so
    that whole warps ask the same query) and ``nan`` (n points near the
    mesh, one of them NaN)."""
    rng = np.random.default_rng(seed)
    t = tris.cpu().numpy()
    v = t.reshape(-1, 3)
    faces = rng.integers(0, len(t), n)
    corner = rng.integers(0, 3, n)
    edges = (t[faces, corner] + t[faces, (corner + 1) % 3]) / 2
    four = near_points(tris, 4, seed).cpu().numpy()
    nan = near_points(tris, n, seed + 1).cpu().numpy()
    nan[n // 2] = np.nan
    sets = {"centre": centre_points(tris, n, seed)}
    for name, p in (("vertices", v[rng.integers(0, len(v), n)]),
                    ("edges", edges), ("duplicates", four[np.arange(n) % 4]),
                    ("nan", nan)):
        sets[name] = torch.from_numpy(p.astype(np.float32)).to(tris.device)
    return sets


def caterpillar(copies=8, span=600.0):
    """[34 + copies, 3, 3] f32 triangles on the CPU whose Morton codes are
    0 (``copies`` equal triangles at the origin) and, but for the three
    that set each axis's extent, one bit each: a tree 33 deep.  Each lies
    in a plane x = const and spans ``span`` in y and z, so that a ray along
    x enters every box: counting its crossings stacks 33 far children."""
    qs = [(0.0, 0.0, 0.0)] * copies
    for axis in range(3):
        for v in [(2 ** i + 0.25) / 3 for i in range(10)] + [1024 / 3]:
            q = [0.0, 0.0, 0.0]
            q[axis] = v
            qs.append(tuple(q))
    q = np.asarray(qs)[:, None, :]
    corners = np.array([[0, 2, -1], [0, -1, 2], [0, -1, -1]]) * span
    return torch.from_numpy((q + corners).astype(np.float32))


def caterpillar_rays(n, seed):
    """(o, d) [2n, 3] f32 on the CPU for ``caterpillar``: n rays along +x
    from x = -10 and n along -x from x = 400, at y, z in [0, 1), a third of
    them tilted a little."""
    rng = np.random.default_rng(seed)
    yz = rng.random((2 * n, 2))
    o = np.concatenate([np.full((2 * n, 1), -10.0), yz], axis=1)
    o[n:, 0] = 400.0
    d = np.zeros((2 * n, 3))
    d[:n, 0], d[n:, 0] = 1.0, -1.0
    d[::3, 1:] = rng.normal(scale=1e-3, size=(len(d[::3]), 2))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.from_numpy(o.astype(np.float32)),
            torch.from_numpy(d.astype(np.float32)))
