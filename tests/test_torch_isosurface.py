"""Parity of the port's marching tetrahedra with the JAX package on the CPU.

- The case tables and the tetrahedral lattice are equal to JAX's.
- ``marching_tetrahedra`` is bitwise JAX's (vertices, triangles, their
  order) on the same field: the float64 arithmetic runs in numpy's order.
- ``run_marching_tetrahedra`` on the committed sphere-small: given JAX's
  own field, bitwise JAX's mesh (slabs, boundary merge and row order); on
  the port's net, whose field differs from JAX's by f32 rounding of the MLP
  (<= 2e-7), the same topology with every vertex within 1e-5 of its twin.
  The lerp weight sa / (sa - sb) magnifies the field's rounding on edges
  where both ends lie near zero: measured 5.0e-6 at 48 (17 of 24,506
  vertices beyond 1e-6), 4.3e-6 at 32.
- The committed ``meshes/sphere/mtet0{16,32,48,64}_mesh_small_1.ply`` were
  written on a TPU: neither JAX on the CPU nor the port reproduces them
  within 1e-6.  The topology is the same, with vertices within 4e-5
  (measured: JAX on the CPU 3.5e-5 at 48, the port 3.3e-5).
- The self-golden's ``cd_vs_mt48`` and ``on_grid_frac`` for the port's own
  flat extraction of sphere-small and torus-small, to their printed digits.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_eval import ROOT, _match, _nets
from tropical.utils import isosurface as jiso
from tropical.utils import mtet as jmtet
from tropical_torch.utils import isosurface as tiso
from tropical_torch.utils import mtet as tmtet

GOLDEN = json.load(open(os.path.join(ROOT, "tests/golden/self_golden.json")))


def test_tables_equal_jax():
    np.testing.assert_array_equal(tiso.CUBE_TETS, jiso.CUBE_TETS)
    np.testing.assert_array_equal(tiso.CUBE_CORNERS, jiso.CUBE_CORNERS)
    np.testing.assert_array_equal(tiso._TRIS_TABLE, jiso._TRIS_TABLE)
    np.testing.assert_array_equal(tiso._NTRIS, jiso._NTRIS)


@pytest.mark.parametrize("nx,n", [(2, 2), (2, 5), (3, 4), (17, 9), (9, 17)])
def test_grid_tetrahedra_equal_jax(nx, n):
    got = tiso.grid_tetrahedra(nx, n, "cpu")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), jiso.grid_tetrahedra(nx, n))


def _field(kind, n=14, seed=0):
    """(points [n^3, 3] f32, sdf [n^3] f32) of a seeded field on an n^3
    grid over [-1, 1]^3."""
    rng = np.random.default_rng(seed)
    s = np.linspace(-1, 1, n, dtype=np.float32)
    pts = np.stack(np.meshgrid(s, s, s, indexing="ij"), -1).reshape(-1, 3)
    if kind == "random_sign":
        sdf = rng.normal(size=n ** 3)
    elif kind == "sphere":
        sdf = 0.6 - np.linalg.norm(pts, axis=-1)
    elif kind == "exact_zeros":  # grid values exactly 0, some edges 0-0
        sdf = rng.normal(size=n ** 3)
        sdf[rng.random(n ** 3) < 0.25] = 0.0
    elif kind == "one_sign":
        sdf = rng.uniform(0.1, 1.0, n ** 3)
    elif kind == "all_negative":
        sdf = -rng.uniform(0.1, 1.0, n ** 3)
    else:
        raise ValueError(kind)
    return pts, sdf.astype(np.float32)


def _both(pts, tets, sdf):
    v_j, t_j = jiso.marching_tetrahedra(pts.astype(np.float64), tets, sdf)
    v_t, t_t = tiso.marching_tetrahedra(torch.from_numpy(pts).double(),
                                        torch.from_numpy(tets),
                                        torch.from_numpy(sdf))
    return (v_j, t_j), (v_t.numpy(), t_t.numpy())


@pytest.mark.parametrize("kind", ["random_sign", "sphere", "exact_zeros",
                                  "one_sign", "all_negative"])
@pytest.mark.parametrize("seed", [0, 1])
def test_marching_tetrahedra_bitwise(kind, seed):
    pts, sdf = _field(kind, seed=seed)
    tets = jiso.grid_tetrahedra(14, 14)
    (v_j, t_j), (v_t, t_t) = _both(pts, tets, sdf)
    assert v_t.dtype == np.float64 and t_t.dtype == np.int64
    assert v_t.shape == v_j.shape and t_t.shape == t_j.shape
    if kind in ("one_sign", "all_negative"):
        assert v_t.shape == (0, 3) and t_t.shape == (0, 3)
    else:
        assert t_t.shape[0] > 100
    np.testing.assert_array_equal(v_t, v_j)
    np.testing.assert_array_equal(t_t, t_j)


def test_marching_tetrahedra_empty_grid():
    """No tetrahedra at all, and tetrahedra over random (non-grid) points."""
    pts, sdf = _field("random_sign", n=3)
    none = np.empty((0, 4), np.int64)
    (v_j, t_j), (v_t, t_t) = _both(pts, none, sdf)
    assert v_t.shape == v_j.shape == (0, 3)
    assert t_t.shape == t_j.shape == (0, 3)
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    sdf = rng.normal(size=500).astype(np.float32)
    tets = rng.integers(0, 500, (3000, 4))
    (v_j, t_j), (v_t, t_t) = _both(pts, tets, sdf)
    np.testing.assert_array_equal(v_t, v_j)
    np.testing.assert_array_equal(t_t, t_j)


@pytest.mark.parametrize("level", [0.0, 0.25, -0.3])
def test_marching_tetrahedras_level(level):
    pts, _ = _field("sphere")
    sdf = (0.6 - np.linalg.norm(pts, axis=-1)).astype(np.float32)
    tets = jiso.grid_tetrahedra(14, 14)
    v_j, t_j = jmtet.marching_tetrahedras(pts, tets, sdf, level)
    v_t, t_t = tmtet.marching_tetrahedras(torch.from_numpy(pts),
                                          torch.from_numpy(tets),
                                          torch.from_numpy(sdf), level)
    assert t_t.shape[0] > 100
    np.testing.assert_array_equal(v_t.numpy(), v_j)
    np.testing.assert_array_equal(t_t.numpy(), t_j)
    r = np.linalg.norm(v_t.numpy(), axis=-1)
    np.testing.assert_allclose(r, 0.6 - level, atol=0.02)


class _JaxField:
    """A stand-in for the port's net whose ``sdf`` is the JAX net's."""

    def __init__(self, jnet):
        self.jnet = jnet
        self.device = torch.device("cpu")

    def sdf(self, x):
        return torch.from_numpy(np.array(
            self.jnet.sdf(jnp.asarray(x.numpy()))))


def test_run_marching_tetrahedra_bitwise_on_jax_field():
    """The slabs (16 cubes, 3 of them at 48), the boundary merge and the
    row order are JAX's when the field is."""
    jnet, _ = _nets()
    m_j = jiso.run_marching_tetrahedra(jnet, 48, 1.2, R=0.8)
    m_t = tiso.run_marching_tetrahedra(_JaxField(jnet), 48, 1.2, R=0.8)
    np.testing.assert_array_equal(m_t.vertices, m_j.vertices)
    np.testing.assert_array_equal(m_t.faces, m_j.faces)


def test_run_marching_tetrahedra_matches_jax_cpu_path():
    jnet, tnet = _nets()
    m_j = jiso.run_marching_tetrahedra(jnet, 48, 1.2, R=0.8)
    m_t = tiso.run_marching_tetrahedra(tnet, 48, 1.2, R=0.8)
    assert m_t.faces.shape == m_j.faces.shape == (42352, 3)
    assert m_t.vertices.shape == m_j.vertices.shape == (24506, 3)
    idx = _match(m_t.vertices, m_j.vertices, atol=1e-5)
    np.testing.assert_array_equal(idx[m_t.faces], m_j.faces)

    # the committed TPU-written mesh: same topology, vertices within 4e-5
    from tropical.utils.ply import read_ply

    ref = read_ply(os.path.join(ROOT, "meshes/sphere/mtet048_mesh_small_1.ply"))
    assert ref.faces.shape == m_t.faces.shape
    idx = _match(m_t.vertices, ref.vertices, atol=4e-5)
    np.testing.assert_array_equal(idx[m_t.faces], ref.faces)


@pytest.mark.parametrize("method", ["mt", "mc"])
def test_slab_boundaries_merge_every_crossing(method):
    """At 48 (3 slabs) every crossing on the two shared x-planes is a vertex
    of both slabs, bitwise equal, and merges."""
    from tropical_torch.utils import marching_cubes as tmc

    _, tnet = _nets()
    slabs = tiso.mt_slabs if method == "mt" else tmc.mc_slabs
    merged, crossings = tmc.slab_merge_counts(slabs(tnet, 48, 1.2))
    assert merged == crossings > 100


def test_sdf_grid_is_the_slabs_field():
    """``sdf_grid`` holds each slab's field bitwise, the shared planes
    once: the values the grid meshes see."""
    from tropical_torch.utils import marching_cubes as tmc

    _, tnet = _nets()
    res = 2 * tmc.SLAB + 8
    grid = tiso.sdf_grid(tnet, res, 1.2)
    assert grid.shape == (res, res, res)
    n = 0
    for x0, _, vals in tmc.slab_fields(tnet, res, 1.2):
        assert torch.equal(grid[x0:x0 + vals.shape[0]], vals)
        n += 1
    assert n == 3


def test_sdf_grid_matches_jax():
    jnet, tnet = _nets()
    got = tiso.sdf_grid(tnet, 12, 1.2)
    assert got.shape == (12, 12, 12) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jiso.sdf_grid(jnet, 12, 1.2),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["sphere", "torus"])
def test_self_golden_mt48_and_on_grid(name):
    """The port's own flat extraction against its MT-48 mesh (R = 1, as
    tests/test_golden.py scores JAX's), to the golden's printed digits."""
    from test_torch_extract import _torch_net
    from tropical_torch.extract.subdivide import subpoly
    from tropical_torch.utils.chamfer import chamfer_distance

    g = GOLDEN[name]
    net = _torch_net(g)
    _, vertices, _ = subpoly(net, 3, 1.2, force=True, verbose=False)
    gt = tiso.run_marching_tetrahedra(net, 48, 1.2)
    cd = chamfer_distance(vertices, torch.from_numpy(
        np.asarray(gt.vertices, np.float32)))
    assert abs(cd - g["cd_vs_mt48"]) <= 1e-6, cd

    d = (net.preprocess(vertices)[:, :, None]
         - net.marks[None, None, :]).abs().amin(-1)
    on_grid = float((d < 1e-4).any(-1).double().mean())
    assert abs(on_grid - g["on_grid_frac"]) <= 5e-5, on_grid


def test_pseudo_gt_256_holds_a_zero_of_the_port_field_only():
    """Why the port's marching-cubes pseudo-GT at 256 has 208,792 vertices
    and JAX's 208,794 (the evaluate golden): at grid point (95, 107, 226)
    the port's sdf is exactly 0 (outside: ``vals > 0`` is false) and JAX's
    is 4.47e-8 (inside), f32 rounding of the MLP in another order.  The
    card gives the port's 0 as well (``chip_smoke.py`` counts the zeros)."""
    from tropical_torch.utils.marching_cubes import grid_axis

    jnet, tnet = _nets()
    s = grid_axis(256, 1.2, "cpu")
    p = torch.stack([s[95], s[107], s[226]])[None]
    assert float(tnet.sdf(p)[0, 0]) == 0.0
    assert float(np.asarray(jnet.sdf(jnp.asarray(p.numpy())))[0, 0]) > 0
