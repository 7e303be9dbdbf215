"""Parity of the port's flat-path extraction with the JAX host engine.

- torus-small: the JAX host engine (``engine="host"``, the oracle its own
  tests use) against the port on the CPU.  Funnel counts exact; vertices in
  the same order within 5e-6.  The MLP's matrix products round in another
  order (outputs differ by <= 2e-7), and the lerp weight |d0|/|d1-d0|
  magnifies that on short edges: measured up to 1.6e-6 on 5 of 7983
  vertices.  Triangles follow the fan-diagonal contract of
  tests/test_device_faces.py: only rows of polygons whose angular order
  flips on rounding may differ, with the same vertex set and area.
- sphere-small through the port alone against the golden funnel.
- The bookkeeping units against their JAX counterparts on seeded inputs.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from tropical.core import ext as jext
from tropical.core import regions as jrg
from tropical.extract import faces as jfaces
from tropical_torch.core import ext as text
from tropical_torch.core import regions as trg
from tropical_torch.extract import faces as tfaces

ROOT = os.path.join(os.path.dirname(__file__), "..")
GOLDEN = json.load(open(os.path.join(ROOT, "tests/golden/self_golden.json")))


def _torch_net(entry):
    from tropical_torch.stanford.model import Net
    from tropical_torch.utils import checkpoint as ckpt

    net = Net(r_min=entry.get("r_min", 2), r_max=entry.get("r_max", 32),
              device="cpu")
    found = ckpt.find_checkpoint(os.path.join(ROOT, entry["checkpoint"]))
    assert found, entry["checkpoint"]
    return ckpt.load_into(net, found)


def _assert_golden(stats, tris, g):
    assert (stats["pre_v"], stats["pre_e"]) == (g["pre_v"], g["pre_e"]), stats
    assert (stats["post_v"], stats["post_e"]) == (g["post_v"], g["post_e"]), stats
    assert tris.shape[0] == g["n_tris"]


def test_torus_small_matches_jax_host_engine():
    from tropical.extract import stats as jstats
    from tropical.extract.subdivide import subpoly as jsubpoly
    from tropical.stanford.model import Net
    from tropical.utils import checkpoint as jckpt
    from tropical_torch.extract import stats as tstats
    from tropical_torch.extract.subdivide import subpoly

    g = GOLDEN["torus"]
    jnet = Net(r_min=2, r_max=32, key=jax.random.PRNGKey(1))
    jckpt.load_into(jnet, jckpt.find_checkpoint(
        os.path.join(ROOT, g["checkpoint"])))
    f1, v1, t1 = jsubpoly(jnet, 3, 1.2, force=True, verbose=False,
                          engine="host")
    f2, v2, t2 = subpoly(_torch_net(g), 3, 1.2, force=True, verbose=False)
    assert tstats.LAST == jstats.LAST
    _assert_golden(tstats.LAST, t2, g)

    v2, t2 = v2.numpy(), t2.numpy()
    assert v2.shape == v1.shape
    np.testing.assert_allclose(v2, v1, rtol=0, atol=5e-6)
    np.testing.assert_array_equal(f2.numpy(), v2[t2])

    # fan-diagonal contract, row by row (both engines emit polygons in the
    # same order with the same triangle count each)
    assert t2.shape == t1.shape
    rows = (t1 != t2).any(1)
    assert rows.mean() <= 0.005, rows.sum()
    assert set(t1[rows].ravel()) == set(t2[rows].ravel())

    def area(t):
        p = v1[t]
        cr = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        return float(0.5 * np.linalg.norm(cr, axis=1).sum())

    assert abs(area(t1[rows]) - area(t2[rows])) <= 1e-6 * area(t1) + 1e-12


def test_sphere_small_golden_funnel():
    from tropical_torch.extract import stats
    from tropical_torch.extract.subdivide import subpoly

    g = GOLDEN["sphere"]
    faces, vertices, tris = subpoly(_torch_net(g), 3, 1.2, force=True,
                                    verbose=False)
    _assert_golden(stats.LAST, tris, g)
    assert tris.min() >= 0 and tris.max() < vertices.shape[0]


def test_curved_path_is_not_ported_yet():
    from tropical_torch.extract.subdivide import subpoly

    with pytest.raises(NotImplementedError, match="curved path"):
        subpoly(_torch_net(GOLDEN["sphere"]), 3, 1.2, force=False)


def _random_signs(seed, n=300, cols=12, D=3):
    rng = np.random.default_rng(seed)
    m = rng.choice([-1, 0, 1], size=(n, cols), p=[0.45, 0.1, 0.45])
    m[:, :D] = rng.choice([0, 1], size=(n, D), p=[0.15, 0.85])
    offset = rng.integers(-1, 6, size=(n, D))
    return m.astype(np.int32), offset.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_region_bookkeeping_matches_jax(seed):
    m, offset = _random_signs(seed)
    mt, ot = torch.from_numpy(m), torch.from_numpy(offset)

    r_j, aug_j = jrg.regions_to_vertices(m, offset)
    r_t, aug_t = trg.regions_to_vertices(mt, ot)
    np.testing.assert_array_equal(aug_t.numpy(), aug_j)
    # region numbering is free; the grouping is not
    _, inv = np.unique(np.stack([r_j, r_t.numpy()], 1), axis=0,
                       return_inverse=True)
    assert len(np.unique(inv)) == len(np.unique(r_j)) == len(np.unique(r_t))

    # the left-aligned table, rows in content order as extract_faces uses it
    tab_j = np.unique(jrg.region_table(r_j, aug_j), axis=0)
    tab_t = torch.unique(trg.region_table(r_t, aug_t), dim=0)
    np.testing.assert_array_equal(tab_t.numpy(), tab_j)

    np.testing.assert_array_equal(trg.edge_vertices(mt, ot).numpy(),
                                  jrg.edge_vertices(m, offset))
    inv_j = jrg.row_unique_inverse(m)
    inv_t = trg.row_unique_inverse(mt).numpy()
    np.testing.assert_array_equal(inv_j[:, None] == inv_j[None, :],
                                  inv_t[:, None] == inv_t[None, :])

    z = (m[:, 3:] == 0)
    np.testing.assert_array_equal(
        text.nonzero_last(torch.from_numpy(z)).numpy(), jext.nonzero_last(z))


def test_polygon_sort_and_fan_match_jax():
    rng = np.random.default_rng(5)
    R, M = 200, 7
    counts = rng.integers(2, M + 1, R)
    valid = np.arange(M)[None, :] < counts[:, None]
    # convex-ish polygons around the z axis, shuffled, with a random normal
    ang = rng.uniform(0, 2 * np.pi, (R, M))
    pts = np.stack([np.cos(ang), np.sin(ang), 0.01 * rng.normal(size=(R, M))],
                   -1).astype(np.float32)
    pts[~valid] = 0
    normals = np.tile(np.float32([0, 0, 1]), (R, 1))
    normals[::3] *= -1
    o_j = jfaces.sort_polygon_rows(pts, normals, valid)
    o_t = tfaces.sort_polygon_rows(torch.from_numpy(pts),
                                   torch.from_numpy(normals),
                                   torch.from_numpy(valid))
    np.testing.assert_array_equal(o_t.numpy(), o_j)

    idx = np.where(valid, rng.integers(0, 50, (R, M)), -1)
    np.testing.assert_array_equal(
        tfaces.fan_triangles(torch.from_numpy(idx)).numpy(),
        jfaces.fan_triangles(idx))
