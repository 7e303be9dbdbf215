"""K6, the device engine's final filter and faces (``Engine.faces``, the
plain versions of ``csrc/faces.cu``'s kernels on the CPU), against the JAX
package and against the port's host faces.

- End to end, flat and curved, on the ``trained_net`` fixture: the port's
  device engine against JAX's device faces (``make_extract_fn(
  with_faces=True)``, reached as ``tests/test_device_faces.py`` reaches
  it: the second ``subpoly_device`` call, after the caps are memoised):
  the funnel and the triangle count exactly, the vertices within 5e-6
  (the MLP's summation order through the lerp), the triangles under the
  fan contract of ``tests/test_device_faces.py`` (at most 0.5 % of them
  differ, on the same vertices, with the same area: a fan's diagonal
  taken the other way); the stage's two reads.
- The port's host faces (``extract_skeleton`` + ``extract_faces``) on
  the same loop output: the vertices bit for bit, the counts exactly, the
  fan contract.  Each fan that differs is the same polygon started at another vertex:
  its members that crossed the angular sort's cut lie within two
  fixed-point steps (2^-22) of it (``faces_cases.fan_ties``).
- Each stage's plain version on seeded inputs (``tests/faces_cases.py``):
  ``final_keep`` against the JAX engine's ``keep_v`` / ``e_keep`` / used
  vertices and its counts (``make_extract_fn._run`` :1451-1498, written
  out in jnp), exactly; ``face_keys`` against ``_grid_region_lut`` with
  ``_expand_keys`` and ``_expand4_keys``: the same multiset of (region,
  vertex), up to 6 zero neurons and 3 grid planes, and the same regions as
  the host engine's ``regions_to_vertices``.
- Planted cases: duplicate regions (an A, B, A signature interleaving), a
  repeated vertex id, regions of 1, 2 and 100 members, exact score ties,
  cell offsets -1, 0 and M - 1; the calls the emulated and the card's
  builds are held to, in both designs.
- ``faces_cases.golden_ties``, which holds sphere-large's faces on the card
  to JAX's device faces, on ``trained_net``'s, and the golden file's
  counts (``tests/golden/sphere_large_device_faces.npz``).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import faces_cases as cases
from tropical.extract import device as jdv
from tropical.extract import stats as jstats
from tropical_torch.core import regions as rg
from tropical_torch.extract import device as tdv
from tropical_torch.extract import stats as tstats
from tropical_torch.extract.faces import extract_faces, extract_skeleton

EPS = 1e-4
ROOT = Path(__file__).resolve().parents[1]


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
    import jax

    from tropical_torch.stanford.model import Net

    s = trained_net.spec
    net = Net(num_layers=s.num_layers, num_hidden=s.num_hidden,
              levels=s.levels, r_min=s.r_min, r_max=s.r_max, T=s.T,
              device="cpu")
    return net.params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                        trained_net.params))


def _jax_device_faces(net, force):
    """JAX's ``subpoly_device`` through its fused program, whose faces are
    assembled on the device: a first call (the ramp, host faces) memoises
    the caps, the second takes the fused program.  Returns its (faces,
    vertices, triangles) and funnel."""
    for memo in (jdv._GOOD_CAPS, jdv._SKEL_CAPS, jdv._PERSISTED["good"],
                 jdv._PERSISTED["skel"]):
        memo.clear()
    jdv.subpoly_device(net, verbose=False, force=force)
    out = jdv.subpoly_device(net, verbose=False, force=force)
    assert any(k[-1] == "fused" and k[3] == force for k in jdv._EXTRACT_CACHE)
    return out, dict(jstats.LAST)


@pytest.fixture(scope="module", params=[True, False], ids=["flat", "curved"])
def runs(request, trained_net, tnet):
    """Both engines end to end, and the loop output ``Engine.faces`` took
    (recorded by wrapping it): (force, JAX's result and funnel, the port's
    result, funnel and reads, the faces' inputs)."""
    force = request.param
    jax_out = _jax_device_faces(trained_net, force)
    seen = {}
    faces = tdv.Engine.faces

    def keep(self, *args):
        seen["args"] = args
        return faces(self, *args)

    tdv.Engine.faces = keep
    try:
        out = tdv.subpoly_device(tnet, verbose=False, force=force)
    finally:
        tdv.Engine.faces = faces
    return force, jax_out, (out, dict(tstats.LAST), tdv.LAST), seen["args"]


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


def test_device_faces_match_jax_device_faces(runs):
    force, ((_, v1, t1), jfunnel), ((f2, v2, t2), funnel, last), _ = runs
    assert funnel == jfunnel
    v2, t2 = v2.numpy(), t2.numpy()
    assert v2.shape == v1.shape and t2.shape == t1.shape
    assert funnel["n_faces"] == t2.shape[0] > 1000
    np.testing.assert_allclose(v2, v1, rtol=0, atol=5e-6)
    np.testing.assert_array_equal(f2.numpy(), v2[t2])
    _fan_contract(v1, t1, t2)
    # the loop's reads (one a busy insertion, the skeleton's, the starting
    # pools', the curved path's), then the faces' two
    assert last.reads == len(last.busy) + 4 + sum(r for *_, r in last.curved)
    assert bool(last.curved) != force


def test_device_faces_match_host_faces(runs, tnet):
    _, _, ((_, Vf, tris), funnel, _), (V, OUT, E, SB, ZB) = runs
    Vh, Eh, vidx = extract_skeleton(V, E.long(), OUT, tnet, EPS)
    _, th = extract_faces(Vh, Eh, tnet, OUT[vidx], EPS)
    assert torch.equal(Vf, Vh)
    assert (funnel["pre_v"], funnel["pre_e"], funnel["post_v"],
            funnel["post_e"], funnel["n_faces"]) == (
        V.shape[0], E.shape[0], Vh.shape[0], Eh.shape[0], th.shape[0])
    assert tris.shape == th.shape and int(tris.min()) >= 0
    assert int(tris.max()) < Vf.shape[0]
    _fan_contract(Vh.numpy(), th.numpy(), tris.numpy())


def test_device_fans_differ_from_host_fans_only_at_the_cut(runs, tnet):
    force, _, _, (V, OUT, E, SB, ZB) = runs
    eng = tdv.Engine(tnet, force=force)
    (_, _, tris), calls = cases.record(
        tdv, lambda: eng.faces(V, OUT, E, SB, ZB))
    Vh, Eh, vidx = extract_skeleton(V, E.long(), OUT, tnet, EPS)
    _, th = extract_faces(Vh, Eh, tnet, OUT[vidx], EPS)
    ties = cases.fan_ties(tdv, tnet, calls[-1], tris, th)
    assert ties["host_rows"] and ties["k6_rows"], ties
    assert ties["differ"] == ties["rotations"] == ties["near"], ties
    assert ties["mean_steps"] <= 1.0, ties


def test_device_fans_differ_from_jax_device_fans_only_at_the_cut(runs, tnet):
    """``faces_cases.golden_ties``, the check phase 11d makes against the
    JAX device faces of sphere-large, on the same loop output: each fan
    with a row that JAX's device faces lack is its polygon started at
    another vertex, and K6's score on JAX's vertices gives JAX's fan."""
    force, ((_, v1, t1), _), _, (V, OUT, E, SB, ZB) = runs
    eng = tdv.Engine(tnet, force=force)
    (_, _, tris), calls = cases.record(
        tdv, lambda: eng.faces(V, OUT, E, SB, ZB))
    ties = cases.golden_ties(tdv, tnet, calls[-1], tris, np.asarray(t1),
                             np.asarray(v1))
    assert ties["k6_rows"], ties
    assert ties["differ"] == ties["rotations"] == ties["explained"], ties
    print(ties)


def test_final_keep_matches_jax(trained_net):
    spec = trained_net.spec
    V, OUT, E = cases.final_keep_case("cpu", spec.scale, EPS)
    fc = torch.zeros(tdv.FC, dtype=torch.int64)
    keep, ends = tdv.final_keep(V, OUT, E, EPS, spec.scale, fc)
    # the JAX engine's final filter (make_extract_fn._run :1451-1498)
    Vj, Oj, Ej = (jnp.asarray(t.numpy()) for t in (V, OUT, E))
    n = V.shape[0]
    used_pre = jnp.zeros(n, bool).at[Ej[:, 0]].set(True).at[Ej[:, 1]].set(
        True)
    xu = jdv.preprocess(spec, Vj)
    keep_v = (jnp.abs(Oj[:, -1]) < EPS) & (xu <= 1).all(-1) & (
        xu >= 0).all(-1)
    e_keep = keep_v[Ej[:, 0]] & keep_v[Ej[:, 1]]
    used = jnp.zeros(n, bool).at[jnp.where(e_keep, Ej[:, 0], n)].set(
        True, mode="drop").at[jnp.where(e_keep, Ej[:, 1], n)].set(
        True, mode="drop")
    np.testing.assert_array_equal(keep.numpy() > 0, np.asarray(keep_v))
    np.testing.assert_array_equal(ends[0].numpy() > 0, np.asarray(used_pre))
    np.testing.assert_array_equal(ends[1].numpy() > 0, np.asarray(used))
    assert int(fc[tdv.FC_EKEEP]) == int(e_keep.sum()) > 10
    assert int(fc[tdv.FC_LIVE]) == E.shape[0]
    assert int(fc[tdv.FC_KEEPV]) == int(keep_v.sum())
    # the planted extremes: the cube's faces kept, just past them dropped,
    # |sdf column| = eps dropped, a vertex of no edge unused
    assert bool(keep[:40].any()) and not bool(keep[40:55].any())
    assert not bool(keep[60:81].any()) and int(ends[0, -1]) == 0
    lut = tdv._lut(torch.from_numpy(np.asarray(trained_net.marks)))
    marks = np.asarray(trained_net.marks)
    tdv.face_keys_count(V, *tdv._pack_out_words(OUT, EPS)[:2], ends,
                        torch.from_numpy(marks), lut, tdv._lut_k(marks), EPS,
                        spec.scale, fc)
    assert int(fc[tdv.FC_PRE]) == int(used_pre.sum())
    assert int(fc[tdv.FC_USED]) == int(used.sum())


def _keys_run(marks):
    """The planted face_keys case through both stages: (V, SB, ZB, ends,
    keys, vertex of each replica (its row in V), fc)."""
    V, SB, ZB, ends = cases.face_keys_case(tdv, marks, "cpu", 1.2, EPS)
    lut, lut_k = tdv._lut(marks), tdv._lut_k(marks.numpy())
    fc = torch.zeros(tdv.FC, dtype=torch.int64)
    rows, rk, agg = tdv.face_keys_count(V, SB, ZB, ends, marks, lut, lut_k,
                                        EPS, 1.2, fc)
    n_used, n_rep = int(fc[tdv.FC_USED]), int(fc[tdv.FC_REP])
    keys, rvid, Vf = tdv.face_keys_fill(V, rows, rk, agg, fc, n_used, n_rep)
    used = torch.nonzero(ends[1])[:, 0]
    assert torch.equal(Vf, V[used])
    assert int(fc[tdv.FC_HIST:].sum()) == n_used
    return V, SB, ZB, ends, keys, used[rvid.long()], fc, lut, lut_k


def _decode(keys):
    """(grid cell values [n, 3], the hidden neurons' sign bits [n]) of
    region keys."""
    g = torch.stack([((keys >> s) & 1023) - 2 for s in tdv.KEY_SHIFT], 1)
    return g, keys & 0xFFFFFFFF


def test_face_keys_match_jax_expansion():
    marks = torch.from_numpy(np.linspace(0, 1, 21).astype(np.float32))
    V, SB, ZB, ends, keys, rows, fc, lut, lut_k = _keys_run(marks)
    n = V.shape[0]
    xu = (V.numpy() + np.float32(1.2)) / np.float32(2.4)
    g_mask, g_off = (np.asarray(a) for a in jdv._grid_region_lut(
        jnp.asarray(marks.numpy()), jnp.asarray(lut.numpy()), jnp.asarray(xu),
        EPS, lut_k))
    col = np.arange(33)
    s = ((SB.numpy()[:, :1] >> col[None, :32]) & 1) > 0
    z = ((ZB.numpy()[:, :1] >> col[None, :32]) & 1) > 0
    sgn = np.concatenate([np.where(z, 0, np.where(s, 1, -1)),
                          np.ones((n, 1), np.int64)], 1)
    allc = np.concatenate([g_mask, sgn], 1).astype(np.int32)
    is_zero = allc == 0
    kz = is_zero.sum(1)
    assert kz.max() >= 7 and (kz[ends[1].numpy() > 0] <= 2).any()
    assert {-1, 0, 20} <= set(g_off.ravel().tolist())
    valid = ends[1].numpy() > 0
    kmax = int(kz.max())
    k1, k2, k3, r = (np.asarray(a) for a in jdv._expand_keys(
        jnp.asarray(allc), jnp.asarray(np.cumsum(is_zero, 1) - 1),
        jnp.asarray(g_off), jnp.asarray(valid), jnp.asarray(kz), 1 << kmax,
        kmax, jnp.arange(n)))

    def jax_set(k1, k2, k3, r):
        ok = k1 < jdv.BIGKEY
        g = np.stack([((k1 >> (10 * d)) & 1023) - 1 for d in range(3)], 1)
        nb = k2.astype(np.int64) | ((k3.astype(np.int64) & 0xFFFF) << 16)
        return sorted(zip(*(a[ok].tolist() for a in (g[:, 0], g[:, 1], g[:, 2],
                                                     nb, r))))

    g, nb = _decode(keys)
    ours = sorted(zip(g[:, 0].tolist(), g[:, 1].tolist(), g[:, 2].tolist(),
                      nb.tolist(), rows.tolist()))
    assert ours == jax_set(k1, k2, k3, r)
    assert len(ours) == int(fc[tdv.FC_REP]) == int((1 << kz[valid]).sum())
    assert (g == -1).any() and (g == 19).any() and (g == 20).any()
    # the tier-A expansion of the rows with at most 2 zero columns
    a = valid & (kz <= 2)
    jk = jdv._expand4_keys(jnp.asarray(allc), jnp.asarray(g_off),
                           jnp.asarray(a), jnp.asarray(kz), jnp.arange(n))
    mine = [t for t in ours if a[t[4]]]
    assert mine == jax_set(*(np.asarray(x) for x in jk))


def test_face_keys_are_the_host_regions():
    """The keys group the replicas as the host engine's
    ``regions_to_vertices`` does on the same signs and cells."""
    marks = torch.from_numpy(np.linspace(0, 1, 21).astype(np.float32))
    V, SB, ZB, ends, keys, rows, _, lut, lut_k = _keys_run(marks)
    used = torch.nonzero(ends[1])[:, 0]
    g_mask, off = tdv._grid_region_lut(marks, lut, (V + 1.2) / 2.4, EPS,
                                       lut_k)
    s, z = (torch.stack([tdv._bit(w, c) for c in range(32)], 1)
            for w in (SB, ZB))
    m = torch.cat([g_mask, torch.where(z, 0, torch.where(s, 1, -1))], 1)
    r_idx, org = rg.regions_to_vertices(m[used], off[used])

    def groups(region, member):
        out = {}
        for a, b in zip(region.tolist(), member.tolist()):
            out.setdefault(a, []).append(b)
        return sorted(tuple(sorted(v)) for v in out.values())

    assert groups(keys, rows) == groups(r_idx, used[org])


def _chain(device="cpu", normal=(0.0, 0.0, 1.0)):
    """The planted regions through the region and fan stages' plain
    versions: (keep flags by slot, the slots' regions, the triangles)."""
    skey, perm, rvid, Vf = cases.regions_case(device)
    sig, rcnt, mean, svid = tdv.face_regions_runs(skey, perm, rvid, Vf)
    ssig, rord = torch.sort(sig, stable=True)
    keep = tdv.face_regions_dups(ssig, rord, rcnt, svid)
    fc = torch.zeros(tdv.FC, dtype=torch.int64)
    n = keep.shape[0]
    kl, mk = tdv.face_fans_count(rord, rcnt, svid, mean, keep, fc,
                                 torch.zeros((n, 4), dtype=torch.int32),
                                 torch.zeros((n, 3)))
    n_kept, n_tri = int(fc[tdv.FC_KEPT]), int(fc[tdv.FC_TRI])
    nrm = torch.tensor([normal] * n_kept)
    tris = tdv.face_fans_fill(kl, svid, mk, nrm, Vf, n_kept, n_tri)
    ntri = torch.zeros(n, dtype=torch.int64)
    ntri[torch.nonzero(keep)[:, 0]] = kl[:n_kept, 3].long()
    real = ssig != tdv.SIG_NONE
    regions = [svid[int(s):int(s) + int(rcnt[s])].tolist()
               for s in rord[real]]
    return keep[real].tolist(), regions, tris, ntri[real].tolist(), Vf


def test_planted_regions_and_fans():
    keep, regions, tris, ntri, Vf = _chain()
    R = cases.REGIONS
    # slots by signature (first member, count), then key: A, B, A' first
    assert regions[:3] == [R[0], R[1], R[2]]
    assert keep == [1, 1, 0, 1, 0, 0, 1, 1, 1]
    assert ntri == [1, 1, 0, 1, 0, 0, 98, 4, 2]
    t = tris.tolist()
    assert len(t) == sum(ntri)
    # the 100-gon around +z: one fan over consecutive points of the circle
    fan = t[3:101]
    apex = fan[0][2]
    assert all(f[2] == apex for f in fan)
    ring = [fan[0][1]] + [f[0] for f in fan]
    assert sorted(ring + [apex]) == list(range(10, 110))
    steps = {(b - a) % 100 for a, b in zip([apex] + ring, ring)}
    assert len(steps) == 1 and steps <= {1, 99}
    # exact ties keep the member order: 110, its twin point 115 and 114 on
    # its ray score 1 alike, after 113 (2.2) and before 111, 112
    sq = t[101:105]
    order = [sq[0][2], sq[0][1]] + [f[0] for f in sq]
    assert order == [113, 110, 114, 115, 111, 112]
    # the repeated ids: 5 once, 116 once (its first place in angle order)
    assert sorted({i for f in t[2:3] for i in f}) == [4, 5, 6]
    assert sorted({i for f in t[105:] for i in f}) == [116, 117, 118, 119]
    # the means are the fixed-point ones: integer sums, one division
    pts = Vf[torch.tensor(R[7])]
    fix = torch.round(pts * 2.0 ** 22).to(torch.int64).sum(0)
    _, rcnt, mean, _ = tdv.face_regions_runs(*cases.regions_case("cpu"))
    s = int(torch.nonzero(rcnt == 6)[0, 0])
    assert torch.equal(mean[s], fix.to(torch.float32) / (6 * 2.0 ** 22))


def test_planted_calls_run_end_to_end():
    """Every stage of ``faces_cases.planted_calls`` (the calls the emulated
    and the card's builds are held to) has work, in both designs: kept
    vertices and edges, replicas of 7 zero columns and more, every region
    case, triangles; five tiles of vertices with every zero count 0 to 35
    used; three tiles through the fill; five tiles of region slots with
    regions past the shared-memory path (8 members) kept; one kept region;
    none."""
    for first, stages in ((False, cases.K6_STAGES),
                          (True, cases.K6_FIRST_STAGES)):
        calls = cases.planted_calls(tdv, "cpu", first=first)
        assert [c[0] for c in calls[:7]] == list(stages)
        fc = torch.zeros(tdv.FC, dtype=torch.int64)
        rows = tdv.face_keys_count(*calls[1][1][:-1], fc)[0]
        kz = tdv._popc(rows[:, 2]) + tdv._popc(rows[:, 3])
        used = calls[1][1][3][1] > 0
        assert int(kz[used].max()) >= 7 and int(fc[tdv.FC_REP]) > 1000
        assert calls[6][1][-1] == 1 + 1 + 1 + 98 + 4 + 2
        name, args, _ = calls[7]
        assert name == stages[1] and args[0].shape[0] > 4 * 1024
        hist = torch.zeros(tdv.FC, dtype=torch.int64)
        tdv.face_keys_count(*args[:-1], hist)
        assert bool((hist[tdv.FC_HIST:] > 0).all())
        assert [c[0] for c in calls[8:10]] == [stages[1], stages[2]]
        assert calls[8][1][0].shape[0] > 2 * 1024
        assert [c[0] for c in calls[10:]] == [stages[5], stages[6],
                                              stages[5], stages[6], stages[5]]
        keep = calls[10][1][4]
        assert keep.shape[0] > 4 * 1024
        counts = calls[10][1][1][calls[10][1][0][keep > 0]]
        assert int(counts.max()) > 8 and int((counts <= 8).sum()) > 100
        assert int(calls[12][1][4].sum()) == 1
        assert int(calls[14][1][4].sum()) == 0


def test_sphere_large_golden_counts():
    """``tests/golden/sphere_large_device_faces.npz`` (the JAX package's
    device faces of sphere-large, ``scripts/device_faces_golden.py``):
    its funnel and triangle count are the JAX CLI's
    (``sphere_flat_presets.json``), every index names one of its vertices,
    and its host-against-device rows give its share."""
    import json

    g = np.load(ROOT / "tests/golden/sphere_large_device_faces.npz")
    want = json.load(open(ROOT / "tests/golden/sphere_flat_presets.json"))[
        "sphere_large_flat"]
    funnel = [want[k] for k in ("pre_v", "pre_e", "post_v", "post_e")]
    assert g["funnel"].tolist() == funnel + [want["n_tris"]]
    assert g["triangles"].dtype == np.int32
    assert g["vertices"].dtype == np.float32
    assert g["triangles"].shape == (want["n_tris"], 3)
    assert g["vertices"].shape == (want["post_v"], 3)
    t = g["triangles"]
    assert 0 <= int(t.min()) and int(t.max()) < want["post_v"]
    assert bool((np.diff(t, axis=1) >= 0).all())
    rows = np.unique(t, axis=0).shape[0]
    assert g["host_only"].shape == g["device_only"].shape
    assert float(g["jax_share"]) == g["device_only"].shape[0] / rows
    assert 0.005 < float(g["jax_share"]) < 0.006
