"""The port's lattice forward and the device engine's units against the JAX
package, on the CPU.

- ``encode_lattice`` (K2's plain version, ``lattice_level_plain``): a dense
  spec and one whose finest level hashes, against JAX's ``encode_lattice``
  to f32 rounding: JAX contracts the same two-term sums as ``einsum``s, and
  XLA may fuse a product into the add (an FMA), a difference of one
  rounding of the larger term; the features are held within 4 ulps of
  their magnitude.  The pointwise fallback of a lattice smaller than its
  corner grid is the same pointwise encode: bitwise.
- ``net_outputs_lattice`` / ``net_sdf_lattice`` and the tangent norm of
  ``_sdf_dist_grad_lattice`` on the committed sphere-small checkpoint: the
  MLP's matrix products sum in another order than XLA's, as everywhere in
  the port (outputs within 2e-6), and the norm rounds differently
  (|grad sdf| within 1e-5 relative).
- The integer units, bitwise: ``_pack_out_words``, ``_edge_bits``,
  ``_grid_region_lut``, ``_dist_pool_k``, ``_lipschitz_keepv`` and
  ``_edges_from_sgn``.
- The host skeleton's ``"distance"`` mode against ``grid_skeleton(mode=
  "distance")``: the same vertices and edges, in order.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tropical.core import hashgrid as jhg
from tropical.extract import device as jdv
from tropical_torch.core import hashgrid as thg
from tropical_torch.extract import device as tdv

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT = "tropical/stanford/models/sphere/sphere_sdf_small_1.pth"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the plain versions run many small operations, which
    a thread pool only slows when the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jspec(spec):
    return jhg.HashGridSpec(scale=spec.scale, dim=spec.dim, levels=spec.levels,
                            features=spec.features, log2_table=spec.log2_table,
                            n_min=spec.n_min, n_max=spec.n_max, eps=spec.eps)


def _axes(rng, sizes, marks=None):
    """Unit-cube axis coordinates: lattice marks where given, else uniform
    draws with the cube's ends."""
    out = []
    for n in sizes:
        if marks is not None:
            a = np.sort(rng.choice(marks, n, replace=False))
        else:
            a = np.sort(np.concatenate([[0.0, 1.0], rng.uniform(0, 1, n - 2)]))
        out.append(a.astype(np.float32))
    return out


@pytest.mark.parametrize("r_max, T", [(32, 19), (128, 19)])
def test_encode_lattice_matches_jax(r_max, T):
    """Dense levels (r_max 32), and sphere-large's grid whose finest level
    hashes (r_max 128), every level factored (the corner grids passed in)."""
    spec = thg.HashGridSpec(levels=4, n_min=2, n_max=r_max, log2_table=T)
    assert spec.level_uses_hash(3) == (r_max == 128)
    rng = np.random.default_rng(r_max)
    table = rng.normal(size=(spec.n_entries, 2)).astype(np.float32)
    xs, ys, zs = _axes(rng, (9, 7, 8))
    big = 10 ** 8  # factors every level
    jt = jhg.lattice_tables(_jspec(spec), jnp.asarray(table), big)
    want = np.asarray(jhg.encode_lattice(_jspec(spec), jnp.asarray(table),
                                         *map(jnp.asarray, (xs, ys, zs)),
                                         tables=jt))
    tt = torch.from_numpy(table)
    tabs = thg.lattice_tables(spec, tt, big)
    for l in range(spec.levels):
        np.testing.assert_array_equal(
            tabs[l].numpy(), np.asarray(jt[l]).reshape(-1, 2))
    got = thg.encode_lattice(spec, tt, *map(torch.from_numpy, (xs, ys, zs)),
                             tables=tabs).numpy()
    assert got.shape == want.shape == (9 * 7 * 8, 8)
    tol = 4 * np.finfo(np.float32).eps * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_encode_lattice_pointwise_fallback_is_the_encode():
    """A 3 x 2 x 2 lattice is smaller than its finer levels' corner grids:
    those levels take the pointwise encode, bitwise JAX's columns."""
    spec = thg.HashGridSpec(levels=4, n_min=2, n_max=32, log2_table=19)
    assert not thg._factored(spec, 3, 12) and thg._factored(spec, 0, 12)
    rng = np.random.default_rng(3)
    table = rng.normal(size=(spec.n_entries, 2)).astype(np.float32)
    xs, ys, zs = _axes(rng, (3, 2, 2))
    want = np.asarray(jhg.encode_lattice(_jspec(spec), jnp.asarray(table),
                                         *map(jnp.asarray, (xs, ys, zs))))
    got = thg.encode_lattice(spec, torch.from_numpy(table),
                             *map(torch.from_numpy, (xs, ys, zs))).numpy()
    for l in range(spec.levels):
        cols = slice(2 * l, 2 * l + 2)
        if thg._factored(spec, l, 12):
            np.testing.assert_allclose(got[:, cols], want[:, cols], rtol=0,
                                       atol=1e-6)
        else:
            np.testing.assert_array_equal(got[:, cols], want[:, cols])


@pytest.fixture(scope="module")
def nets():
    from tropical.stanford.model import Net as JNet
    from tropical.utils import checkpoint as jckpt
    from tropical_torch.stanford.model import Net
    from tropical_torch.utils import checkpoint as ckpt

    path = os.path.join(ROOT, CKPT)
    jnet = JNet(r_min=2, r_max=32, key=jax.random.PRNGKey(1))
    jckpt.load_into(jnet, jckpt.find_checkpoint(path))
    tnet = ckpt.load_into(Net(r_min=2, r_max=32, device="cpu"),
                          ckpt.find_checkpoint(path))
    return jnet, tnet


def test_lattice_forward_and_tangents_match_jax(nets):
    """A 12 x 10 x 11 sub-lattice of sphere-small's marks through the
    surface, every level factored (the corner grids passed in): the
    columns, the sdf and |grad sdf| (the three axis tangents through the
    MLP's linearisation)."""
    from tropical.core.net import net_outputs_lattice as j_out
    from tropical.core.net import net_sdf_lattice as j_sdf
    from tropical_torch.core.net import net_outputs_lattice, net_sdf_lattice

    jnet, tnet = nets
    marks = np.asarray(jnet.marks)
    rng = np.random.default_rng(0)
    axes = [a * 2.0 - 1.0 for a in _axes(rng, (12, 10, 11), marks)]
    ja = [jnp.asarray(a) for a in axes]
    ta = [torch.from_numpy(a.astype(np.float32)) for a in axes]
    jt = jhg.lattice_tables(jnet.spec.grid, jnet.params["table"], 10 ** 8)
    tt = thg.lattice_tables(tnet.spec.grid, tnet.enc.table.detach(), 10 ** 8)
    want = np.asarray(j_out(jnet.spec, jnet.params, *ja, tables=jt))
    got = net_outputs_lattice(tnet, *ta, tables=tt).numpy()
    assert got.shape == want.shape == (1320, 33)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    np.testing.assert_allclose(
        net_sdf_lattice(tnet, *ta, tables=tt).numpy(),
        np.asarray(j_sdf(jnet.spec, jnet.params, *ja, tables=jt)), rtol=0,
        atol=2e-6)
    wo, wd, wg = (np.asarray(x) for x in jdv._sdf_dist_grad_lattice(
        jnet.spec, jnet.params, *ja, tables=jt))
    go, gd, gg = (x.numpy() for x in tdv._sdf_dist_grad_lattice(
        tnet, *ta, tables=tt))
    np.testing.assert_allclose(go, wo, rtol=0, atol=2e-6)
    np.testing.assert_allclose(gd, wd, rtol=0, atol=2e-6)
    np.testing.assert_allclose(gg, wg, rtol=1e-5, atol=1e-6)
    assert (gg > 0).mean() > 0.5


def _outputs(rng, n=4000):
    """[n, 33] outputs on and around the eps band, with exact +-eps and 0."""
    eps = np.float32(1e-4)
    out = rng.normal(scale=3e-4, size=(n, 33)).astype(np.float32)
    pick = rng.random((n, 33))
    out[pick < 0.1] = eps
    out[(pick >= 0.1) & (pick < 0.2)] = -eps
    out[(pick >= 0.2) & (pick < 0.25)] = 0.0
    return out


def test_word_units_match_jax():
    """Sign, zero and strict words; the split words and last differing
    column of random end pairs (also identical and zero rows)."""
    rng = np.random.default_rng(1)
    out = _outputs(rng)
    jw = [np.asarray(w).T.view(np.int32)
          for w in jdv._pack_out_words(jnp.asarray(out), 1e-4)]
    tw = [w.numpy() for w in tdv._pack_out_words(torch.from_numpy(out), 1e-4)]
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(a, b)
    p = rng.integers(0, out.shape[0], 3000)
    q = rng.integers(0, out.shape[0], 3000)
    q[:100] = p[:100]
    sb, zb = tw[0], tw[1]
    jeb, jld = jdv._edge_bits(*(jnp.asarray(w[i].T.view(np.uint32))
                                for w, i in ((sb, p), (zb, p), (sb, q),
                                             (zb, q))))
    teb, tld = tdv._edge_bits(*(torch.from_numpy(w[i]) for w, i in
                                ((sb, p), (zb, p), (sb, q), (zb, q))))
    np.testing.assert_array_equal(teb.numpy(), np.asarray(jeb).T.view(np.int32))
    np.testing.assert_array_equal(tld.numpy(), np.asarray(jld))
    assert (tld.numpy()[:100] == -1).all() and (tld.numpy() == 32).any()


def test_grid_region_lut_matches_jax(nets):
    """Points on every mark, within eps of one, and at random, against
    JAX's table lookup (and the host engine's ``searchsorted``)."""
    jnet, tnet = nets
    marks = np.asarray(jnet.marks)
    rng = np.random.default_rng(2)
    x = np.concatenate([
        rng.choice(marks, (400, 3)),
        rng.choice(marks, (400, 3)) + rng.choice([-1e-4, 1e-4, 5e-5, -5e-5],
                                                 (400, 3)),
        rng.uniform(0, 1, (400, 3))]).astype(np.float32).clip(0, 1)
    # unit-cube points as the engine derives them from world coordinates
    world = torch.from_numpy(x) * 2 - 1
    xu = tnet.preprocess(world)
    k = tdv._lut_k(marks)
    lut_j = jnp.searchsorted(jnp.asarray(marks),
                             jnp.arange(1024, dtype=jnp.float32) / 1024)
    jm, jo = jdv._grid_region_lut(jnp.asarray(marks), lut_j.astype(jnp.int32),
                                  jnp.asarray(xu.numpy()), 1e-4, k)
    tm_ = torch.from_numpy(marks.copy())
    lut = tdv._lut(tm_)
    np.testing.assert_array_equal(lut.numpy(), np.asarray(lut_j))
    m, o = tdv._grid_region_lut(tm_, lut, xu, 1e-4, k)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    # the host engine's region offsets and masks, by binary search
    rgn, off, _ = tnet.region(world, output=torch.zeros(x.shape[0], 33))
    np.testing.assert_array_equal(o.numpy(), off.numpy())
    np.testing.assert_array_equal(m.numpy(), rgn[:, :3].numpy())


def test_pooling_and_lattice_edges_match_jax(nets):
    """``_dist_pool_k`` on the presets' marks and a uniform lattice;
    ``_lipschitz_keepv`` at k = 2, with a NaN in the gradient, and at the
    global-max k = 0; ``_edges_from_sgn`` with and without a keep mask."""
    from tropical_torch.core.hashgrid import compute_marks
    from tropical_torch.stanford.model import net_for_size

    for size in ("small", "medium", "large"):
        mk = compute_marks(net_for_size(size, device="cpu").spec.grid)
        assert tdv._dist_pool_k(mk) == jdv._dist_pool_k(mk)
    assert tdv._dist_pool_k(np.linspace(0, 1, 33)) == 3
    rng = np.random.default_rng(4)
    M = 9
    marks = np.sort(rng.uniform(0, 1, M)).astype(np.float32)
    dist = rng.uniform(0, 3, (M, M, M)).astype(np.float32)
    g = rng.uniform(0, 2, (M, M, M)).astype(np.float32)
    gnan = g.copy()
    gnan[2, 3, 4] = np.nan  # spreads over its window
    for k, g in ((2, gnan), (0, g)):
        want = np.asarray(jdv._lipschitz_keepv(jnp.asarray(dist),
                                               jnp.asarray(g),
                                               jnp.asarray(marks), k))
        got = tdv._lipschitz_keepv(torch.from_numpy(dist), torch.from_numpy(g),
                                   torch.from_numpy(marks), k).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < got.mean() < 1
    sgn = rng.choice([-1, 0, 1], (M, M, M, 5), p=[0.45, 0.1, 0.45]).astype(
        np.int8)
    keep = rng.random((M, M, M)) < 0.8
    for kv in (None, keep):
        want = jdv._edges_from_sgn(jnp.asarray(sgn), M,
                                   None if kv is None else jnp.asarray(kv))
        got = tdv._edges_from_sgn(torch.from_numpy(sgn), M,
                                  None if kv is None else torch.from_numpy(kv))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_host_distance_skeleton_matches_jax(nets):
    """The host ``grid_skeleton``'s distance mode on sphere-small: the same
    vertices and edges, in order."""
    from tropical.extract.skeleton import grid_skeleton as jgrid
    from tropical_torch.extract.skeleton import grid_skeleton

    jnet, tnet = nets
    jv, je = jgrid(jnet, mode="distance")
    tv, te = grid_skeleton(tnet, mode="distance")
    np.testing.assert_array_equal(te.numpy(), je)
    np.testing.assert_array_equal(tv.numpy(), jv)
    # the chunk-wide max gradient prunes less than the sign test does here
    assert je.shape[0] > grid_skeleton(tnet)[1].shape[0]
    with pytest.raises(ValueError, match="unknown pruning mode"):
        grid_skeleton(tnet, mode="none")
