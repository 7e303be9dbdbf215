"""The port's device extraction engine (``extract/device.py``) against the
JAX package and against the port's host engine, on the CPU (the kernels'
plain versions).

- The skeleton, both modes, against JAX's ``make_skeleton_fn`` on the
  ``trained_net`` fixture: counts and edges in order exactly; vertices to
  f32 rounding (XLA may fuse the world map ``x * 2 - 1`` into an FMA);
  outputs within 2e-6 (the MLP's products sum in another order).
- The loop, fed the host skeleton, against the port's host engine
  (``subpoly_`` step by step): vertices, edges, their order and the
  funnel, bit for bit (``tests/test_device_engine.py`` holds JAX's two
  engines to each other the same way); on the curved path
  (``force=False``) also the ``failover.COUNTERS`` deltas and the reads
  (``curved_loop_is_the_host_engine``, which
  ``tests/test_torch_device_curved.py`` runs on its kinked nets).
- Dist and sign skeletons give the same final vertex set.
- End to end against JAX's ``subpoly_device``: the funnel exactly, the
  vertices within 5e-6 (the port's bound against JAX since PR 1, the MLP's
  summation order through the lerp), the triangles under the fan contract
  of ``tests/test_device_faces.py``; on the curved path
  ``tests/test_device_curved.py``'s contract against JAX's
  ``subpoly_device(force=False)``.
- The pair test (compatible sign vectors sharing a zero plane) is exactly
  "some 2^zeros replica of each coincides" of JAX's ``_expand_keys``.
- Routing (both paths take the device engine under ``engine="auto"``, the
  host engine under ``engine="host"``), and one host read a busy
  insertion.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tropical.extract import device as jdv
from tropical_torch.extract import device as tdv


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the plain versions run many small operations, which
    a thread pool only slows when the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tnet(trained_net):
    from tropical_torch.stanford.model import Net

    s = trained_net.spec
    net = Net(num_layers=s.num_layers, num_hidden=s.num_hidden,
              levels=s.levels, r_min=s.r_min, r_max=s.r_max, T=s.T,
              device="cpu")
    return net.params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                        trained_net.params))


@pytest.mark.parametrize("mode", ["sign", "dist"])
def test_skeleton_matches_jax(trained_net, tnet, mode):
    net = trained_net
    M = int(net.marks.shape[0])
    dk = jdv._dist_pool_k(np.asarray(net.marks))
    V0, O0, E0, nv, ne, ovf = jdv.make_skeleton_fn(
        net.spec, jdv.default_skel_caps(M, mode), M, 1e-4, mode=mode,
        dist_k=dk)(net.params, net.marks)
    nv, ne = int(nv), int(ne)
    assert int(ovf) == 0 and ne > 1000
    V, OUT, SB, ZB, SZ, E = tdv.Engine(tnet).skeleton(mode)
    assert (V.shape[0], E.shape[0]) == (nv, ne)
    np.testing.assert_array_equal(E.numpy(), np.asarray(E0)[:ne])
    np.testing.assert_allclose(V.numpy(), np.asarray(V0)[:nv], rtol=0,
                               atol=2.5e-7)
    np.testing.assert_allclose(OUT.numpy(), np.asarray(O0)[:nv], rtol=0,
                               atol=2e-6)
    words = tdv._pack_out_words(OUT, 1e-4)
    for got, want in zip((SB, ZB, SZ), words):
        assert torch.equal(got, want)


def _host_loop(net, V, E, force=True):
    """The port's host engine from (V, E) through the final insertion."""
    from tropical_torch.extract import subdivide as sp

    outputs = None
    for l in range(net.num_layers - 1):
        for h in range(net.num_hidden):
            V, E, outputs = sp.subpoly_(V, E, net, l, h, 1e-4, outputs,
                                        force=force)
    return sp.subpoly_(V, E, net, net.num_layers - 2, net.num_hidden, 1e-4,
                       outputs, force=force)


def curved_loop_is_the_host_engine(net, max_iters=500):
    """The device engine's curved loop (``force=False``, the plain versions)
    from the host skeleton against the port's host engine's: ``V``, ``OUT``,
    ``E`` and the ``failover.COUNTERS`` deltas bit for bit, and the reads:
    one a busy insertion and the starting pools', and of the curved path's
    2 an insertion, one more with rescued rows and one a rescue step but
    the first (a rescue stopped at ``max_iters`` steps, the rescue's cap:
    one less).  Returns the host engine's counters."""
    from tropical_torch.extract import failover as fo
    from tropical_torch.extract.skeleton import grid_skeleton

    V0, E0 = grid_skeleton(net)
    fo.reset_counters()
    Vh, Eh, Oh = _host_loop(net, V0, E0, force=False)
    host = dict(fo.COUNTERS)
    fo.reset_counters()
    eng = tdv.Engine(net, force=False)
    P, counts = eng.pools(V0, net.outputs(V0), E0)
    Vd, Od, Ed, *_ = eng.loop(P, counts)
    stats = eng.stats
    assert dict(fo.COUNTERS) == host
    assert torch.equal(Vd, Vh) and torch.equal(Od, Oh)
    assert torch.equal(Ed.long(), Eh)
    assert host["curved_steps"] > 0 and len(stats.curved) == len(stats.busy)
    assert stats.reads == len(stats.busy) + 1 + sum(
        r for *_, r in stats.curved)
    assert [r for *_, r in stats.curved] == [
        2 + (g > 0) + min(s, max_iters - 1)
        for _, _, _, g, s, _, _ in stats.curved]
    return host


def test_loop_from_the_host_skeleton_is_the_host_engine(tnet):
    from tropical_torch.extract.skeleton import grid_skeleton

    V0, E0 = grid_skeleton(tnet)
    Vh, Eh, Oh = _host_loop(tnet, V0, E0)
    eng = tdv.Engine(tnet)
    P, counts = eng.pools(V0, tnet.outputs(V0), E0)
    Vd, Od, Ed, *_ = eng.loop(P, counts)
    assert len(eng.stats.busy) > 5
    assert torch.equal(Vd, Vh) and torch.equal(Od, Oh)
    assert torch.equal(Ed.long(), Eh)
    # one host read a busy insertion, one for the starting pools
    assert eng.stats.reads == len(eng.stats.busy) + 1


def test_curved_loop_from_the_host_skeleton_is_the_host_engine(tnet):
    curved_loop_is_the_host_engine(tnet)


def test_dist_and_sign_give_the_same_vertex_set(tnet):
    got = {}
    for mode in ("dist", "sign"):
        _, v, t = tdv.subpoly_device(tnet, verbose=False, skeleton_mode=mode)
        got[mode] = (v.numpy(), t.shape)
    vd, vs = got["dist"][0], got["sign"][0]
    assert vd.shape == vs.shape and got["dist"][1] == got["sign"][1]
    np.testing.assert_array_equal(vd[np.lexsort(vd.T)], vs[np.lexsort(vs.T)])


def _fan_contract(v, t1, t2):
    s1, s2 = set(map(tuple, np.sort(t1, 1))), set(map(tuple, np.sort(t2, 1)))
    d1, d2 = s1 - s2, s2 - s1
    assert len(d1) == len(d2) and len(d1) <= 0.005 * len(s1)
    assert {i for t in d1 for i in t} == {i for t in d2 for i in t}

    def area(tris):
        if not tris:
            return 0.0
        p = v[np.asarray(sorted(tris))].astype(np.float64)
        cr = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        return float(0.5 * np.linalg.norm(cr, axis=1).sum())

    assert abs(area(d1) - area(d2)) <= 1e-6 * area(s1) + 1e-12


def test_end_to_end_matches_jax_subpoly_device(trained_net, tnet):
    from tropical.extract import stats as jstats
    from tropical_torch.extract import stats as tstats

    f1, v1, t1 = jdv.subpoly_device(trained_net, verbose=False)
    f2, v2, t2 = tdv.subpoly_device(tnet, verbose=False)
    assert tstats.LAST == jstats.LAST
    v2, t2 = v2.numpy(), t2.numpy()
    assert v2.shape == v1.shape and t2.shape == t1.shape
    np.testing.assert_allclose(v2, v1, rtol=0, atol=5e-6)
    np.testing.assert_array_equal(f2.numpy(), v2[t2])
    _fan_contract(v1, t1, t2)
    # the engine's stage times and the busy insertions of the run; its
    # reads: one a busy insertion, the skeleton's, the starting pools' and
    # the faces' two
    assert min(tdv.LAST.t_skeleton, tdv.LAST.t_loop, tdv.LAST.t_faces) > 0
    assert tdv.LAST.reads == len(tdv.LAST.busy) + 4


def test_curved_end_to_end_matches_jax_subpoly_device(trained_net, tnet):
    """``tests/test_device_curved.py``'s contract: vertex counts within
    0.5 %, each set within 1e-5 of the other for all but 0.5 %, |sdf| <
    2e-4 through the JAX net, and the fan contract.  Measured: the funnel
    equal (4471/8410 => 2065/4138, 4127) and the vertices in the same
    order within 2.2e-7 (the MLP's summation order; 981 sentinel rows
    against JAX's 982); held to that funnel and to 5e-6, the port's bound
    against JAX on the flat path."""
    from scipy.spatial import cKDTree

    from tropical.extract import stats as jstats
    from tropical_torch.extract import failover as fo
    from tropical_torch.extract import stats as tstats

    f1, v1, t1 = jdv.subpoly_device(trained_net, force=False, verbose=False)
    jfunnel = dict(jstats.LAST)
    f2, v2, t2 = tdv.subpoly_device(tnet, verbose=False, force=False)
    v2, t2 = v2.numpy(), t2.numpy()
    n = v1.shape[0]
    assert abs(v2.shape[0] - n) <= max(5, int(0.005 * n))
    assert (cKDTree(v2).query(v1)[0] > 1e-5).sum() <= max(5, int(0.005 * n))
    assert (cKDTree(v1).query(v2)[0] > 1e-5).sum() <= max(
        5, int(0.005 * v2.shape[0]))
    sd = np.asarray(trained_net.sdf(jnp.asarray(v2)))[:, 0]
    assert np.abs(sd).max() < 2e-4
    np.testing.assert_array_equal(f2.numpy(), v2[t2])
    assert tstats.LAST == jfunnel
    np.testing.assert_allclose(v2, v1, rtol=0, atol=5e-6)
    _fan_contract(v1, t1, t2)
    assert fo.COUNTERS["curved_steps"] > 0
    assert tdv.LAST.reads == len(tdv.LAST.busy) + 4 + sum(
        r for *_, r in tdv.LAST.curved)


def _rows(rng, n):
    """Candidate rows as ``candidates`` packs them at plane idx = 4, with
    the ternary rows they stand for: [n, 3 + idx] (grid masks first),
    offsets [n, 3]."""
    idx = 4
    m = rng.choice([-1, 0, 1], size=(n, 3 + idx), p=[0.4, 0.2, 0.4])
    m[:, :3] = rng.choice([0, 1], size=(n, 3), p=[0.3, 0.7])
    off = rng.integers(0, 2, size=(n, 3))
    zs = ((m[:, 3:] == 0) << np.arange(idx)).sum(1)
    sbm = ((m[:, 3:] > 0) << np.arange(idx)).sum(1)
    go = ((off[:, 0] + 1) | ((off[:, 1] + 1) << 9) | ((off[:, 2] + 1) << 18)
          | ((m[:, :3] == 0) << np.array([27, 28, 29])).sum(1))
    C = np.stack([np.arange(n), zs, sbm, go], 1).astype(np.int32)
    return torch.from_numpy(C), m, off, idx


def test_pair_test_is_replica_intersection():
    """Two candidates are compatible iff some 2^zeros replica of each has
    the same key (``_expand_keys``, all 2^zeros replicas of a row), and
    share a plane as JAX's popcount filter counts it."""
    rng = np.random.default_rng(7)
    n = 300
    C, m, off, idx = _rows(rng, n)
    # every row's replica keys, through JAX (at most 3 + idx zeros)
    cols = np.concatenate([m, np.ones((n, 33 - idx), np.int64)], 1)
    is_zero = cols == 0
    kz = is_zero.sum(1)
    zrank = np.cumsum(is_zero, 1) - 1
    k1, k2, k3, rows = (np.asarray(a) for a in jdv._expand_keys(
        jnp.asarray(cols), jnp.asarray(zrank), jnp.asarray(off),
        jnp.ones(n, bool), jnp.asarray(kz), 128, 7, jnp.arange(n)))
    keys = {}
    for a, b, c, r in zip(k1, k2, k3, rows):
        if a < jdv.BIGKEY:
            keys.setdefault(int(r), set()).add((int(a), int(b), int(c)))
    i, j = np.triu_indices(n, 1)
    got = tdv._compatible(C[i], C[j], idx).numpy()
    want = np.array([bool(keys[a] & keys[b]) for a, b in zip(i, j)])
    np.testing.assert_array_equal(got, want)
    assert 0.01 < got.mean() < 0.99
    share = tdv._shares_plane(C[i], C[j]).numpy()
    both = is_zero[i] & is_zero[j]
    both[:, :3] &= off[i] == off[j]
    np.testing.assert_array_equal(share, both.sum(1) >= 1)


def test_routing(tnet):
    from tropical_torch.extract import failover as fo
    from tropical_torch.extract.subdivide import subpoly

    tdv.LAST = None
    subpoly(tnet, 3, 1.2, force=True, verbose=False)
    assert tdv.LAST is not None and tdv.LAST.busy and not tdv.LAST.curved
    # the curved path takes the device engine too
    tdv.LAST = None
    fo.COUNTERS["curved_steps"] = -1
    subpoly(tnet, 3, 1.2, force=False, verbose=False)
    assert tdv.LAST is not None and tdv.LAST.curved
    assert fo.COUNTERS["curved_steps"] >= 0
    tdv.LAST = None
    subpoly(tnet, 3, 1.2, force=False, verbose=False, engine="device")
    assert tdv.LAST is not None and tdv.LAST.curved
    # engine="host" keeps the host engine on either path
    tdv.LAST = None
    for force in (True, False):
        fo.COUNTERS["curved_steps"] = -1
        subpoly(tnet, 3, 1.2, force=force, verbose=False, engine="host")
        assert tdv.LAST is None and fo.COUNTERS["curved_steps"] >= 0
    with pytest.raises(ValueError, match="unknown engine"):
        subpoly(tnet, 3, 1.2, force=True, verbose=False, engine="fused")
