"""The device engine's curved path (``force=False``; ``extract/device.py``,
K4c: the selection in ``split_select``'s curved instance, ``curved_roots``,
``curved_resolve``, ``curved_filter``, then K4's finish alone) on the CPU.

- The loop, fed the host skeleton (``grid_skeleton``), with the plain
  versions, against the port's host engine's curved loop (``subpoly_``
  step by step, ``force=False``): ``V``, ``OUT``, ``E`` and the
  ``failover.COUNTERS`` deltas bit for bit, on the x3000 kinked net and
  the x30000 GD fixture of ``tests/test_device_curved.py`` (its rescue
  cut from 500 steps to 100 in both engines, for the file's time), where
  sentinels, strict drops and rescued rows are each > 0
  (``test_torch_device_engine.curved_loop_is_the_host_engine``).  The
  ``trained_net`` fixture's loop and the end to end run against the JAX
  package's ``subpoly_device(force=False)`` are in
  ``tests/test_torch_device_engine.py``, which builds that fixture
  already.
- sphere-small curved through ``subpoly`` (the CLI's route): the funnel of
  ``tests/golden/sphere_curved_presets.json`` (the JAX CLI's route,
  ``scripts/curved_presets_golden.py``) exactly, with no sentinel, rescued
  or dropped row, as JAX counts them.
- A curved edge on no earlier plane raises ``RuntimeError``.
- ``Engine._curved`` on synthetic curved rows of the x30000 net, with
  rescued rows and with none (every box flat along a coordinate: K7's
  sentinel), against the parent design's order of the same plain stages
  (``curved_pick``, K7, ``curved_points``, ``curved_gd``, a count read,
  the rescue, ``curved_mix``, the forward, the filter): the same
  survivors and counters, one read fewer without a rescue and as many
  with one.
- The K4c kernels built with g++ against ``tests/cuda_emulation.h`` and
  held bitwise to their plain versions: ``split_select``'s curved instance
  against ``split_select_plain`` then ``curved_select_plain`` (and its flat
  instance) on synthetic pools (no curved row, all curved, ragged; every
  edge's plane the last column below idx; curved rows on no plane);
  ``curved_roots`` on K7's hard rows (``tests/trilinear_cases.py``)
  gathered from a corner forward, its plain version also against the
  parent design's chain (``curved_pick``, K7's plain version,
  ``curved_points``); ``curved_gd`` with its mix against
  ``curved_gd_plain`` then ``curved_mix_plain`` without a rescue, and
  ``curved_mix`` after a rescue (no rescued row and some);
  ``curved_filter`` (survivors none, all and ragged, the override firing),
  and K4's finish alone on its survivors against the plain composition; at
  a hidden insertion and the final one; and every call of the kinked net's
  run, recorded, in the design and in K4c's first design
  (``cuda_build.CURVED_FIRST``, through the same calls: ``curved_select``
  after the flat selection, ``curved_pick``, K7 and ``curved_points``,
  ``curved_gd`` then ``curved_mix``, the filter by ``split_check`` and a
  thread a row, the finish with its check).
"""

import json
import os

import numpy as np
import pytest
import torch

import trilinear_cases
from test_device_curved import _kinked_net
from test_torch_curved import _torch_twin
from test_torch_device_engine import curved_loop_is_the_host_engine
from test_torch_device_kernels import _bits, _build
from tropical_torch.core import trilinear as tl
from tropical_torch.extract import device as dv
from tropical_torch.extract import failover as fo
from tropical_torch.ops import cuda_build, launches

ROOT = os.path.join(os.path.dirname(__file__), "..")
EPS = 1e-4
# a hidden insertion's plane and the final one
PLANES = (20, 32)
# the nets of the loop test: the kinked fixtures' arguments
KINKED = {"kinked": {}, "gd": dict(r_max=6, levels=3, scale=30000.0)}
# the GD fixture's rescue cap in the loop test, in both engines, for its
# time: none of its rescued rows converges, so each rescue runs to the cap
# (500 in the program)
GD_STEPS = 100


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """The design's and K4c's first design's ``Kernels``."""
    libs = _build(tmp_path_factory, "device_engine",
                  {"design": (), "first": cuda_build.CURVED_FIRST[1]})
    return {k: dv.Kernels(lib, torch.device("cpu")) for k, lib in libs.items()}


@pytest.fixture(scope="module")
def kern(builds):
    return builds["design"]


@pytest.fixture(scope="module")
def kinked_nets():
    return {k: _torch_twin(_kinked_net(**kw)) for k, kw in KINKED.items()}


def _device_loop(net, V0, E0):
    eng = dv.Engine(net, force=False)
    P, counts = eng.pools(V0, net.outputs(V0), E0)
    return eng.loop(P, counts), eng.stats


@pytest.mark.parametrize("name", ["kinked", "gd"])
def test_loop_from_the_host_skeleton_is_the_host_engine(name, kinked_nets,
                                                        monkeypatch):
    steps = GD_STEPS if name == "gd" else 500
    monkeypatch.setattr(fo.descend, "__defaults__", (steps, 1e-2, None))
    monkeypatch.setattr(fo.gradient_descent_failover, "__defaults__",
                        (steps, 1e-2))
    host = curved_loop_is_the_host_engine(kinked_nets[name], steps)
    assert min(host["sentinels"], host["strict_drops"],
               host["gd_rows"]) > 0, host


def test_sphere_small_is_the_golden_funnel():
    from tropical_torch.extract import stats
    from tropical_torch.extract.subdivide import subpoly
    from tropical_torch.stanford.model import net_for_size
    from tropical_torch.utils import checkpoint as ckpt

    g = json.load(open(os.path.join(ROOT, "tests/golden/"
                                    "sphere_curved_presets.json")))
    g = g["sphere_small_curved"]
    net = ckpt.load_into(net_for_size("small", seed=1, device="cpu"),
                         ckpt.find_checkpoint(os.path.join(
                             ROOT, g["checkpoint"])))
    dv.LAST = None
    _, V, tris = subpoly(net, 3, 1.2, force=False, verbose=False)
    assert dv.LAST is not None and dv.LAST.curved
    assert stats.LAST == {k: g[k] for k in ("pre_v", "pre_e", "post_v",
                                            "post_e")} | {
        "n_faces": g["n_tris"]}
    for k in ("sentinels", "gd_rows", "strict_drops"):
        assert fo.COUNTERS[k] == g[k]
    assert float(net.sdf(V).abs().max()) < 2e-4


def test_no_earlier_plane_raises(kinked_nets):
    """Curved split rows whose ends share no zero column below idx."""
    net = kinked_nets["kinked"]
    eng = dv.Engine(net, force=False)
    V = torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.0, 0.5, 0.5]])
    ce = torch.tensor([[0, 1], [0, 2]], dtype=torch.int32)
    bz = torch.zeros((2, dv.NW), dtype=torch.int32)
    bz[0, 0] = 1 << 3  # plane 3 below idx 5: the other row has none
    P = dv.Pools(V, *[None] * 7)
    lanes = torch.arange(2, dtype=torch.int32)

    def curved():
        cw = dv._zeros32(dv.CW, device="cpu")
        sel = dv.curved_select_plain(ce, bz, V, 5, EPS, cw)
        return eng._curved(P, lanes, ce, V[:2].clone(), bz, *sel, 5, cw)

    with pytest.raises(RuntimeError, match="not on any earlier plane"):
        curved()
    bz[1, 0] = 1 << 4
    curved()


def _parent_roots(d_corner, plane, e01, idx):
    """The parent design's chain: ``curved_pick``'s plain version (p at
    each row's plane, q at idx), K7's plain version, ``curved_points``'
    plain version."""
    p = d_corner.gather(2, plane.long()[:, None, None].expand(-1, 8, 1))
    p, q = p[..., 0], d_corner[:, :, idx].contiguous()
    ints = tl.intersection_of_two_planes_plain(p, q)
    return ints, e01[:, 0] * (1 - ints) + e01[:, 1] * ints


def _parent_curved(eng, lanes, ce, Vn, bz, qs, plane, e01, corners, idx, cw):
    """``Engine._curved`` in the parent design's order, on the plain
    stages: the curved rows read, the corner forward, K7 and the points,
    the on-surface forward, ``curved_gd``, a read of the sentinels and
    rescued rows, the rescue, ``curved_mix``, the forward of every new
    vertex, the filter and a read of the survivors."""
    net, eps = eng.net, eng.eps
    cstate = dv._zeros32(Vn.shape[0], device="cpu")
    n_cv, _ = (int(x) for x in eng.read(cw[:dv.CW_SENT]))
    if n_cv:
        fo.COUNTERS["curved_steps"] += 1
        qs, plane, e01 = qs[:n_cv], plane[:n_cv], e01[:n_cv]
        d_corner = net.outputs(corners[:n_cv].reshape(-1, 3), group=8)
        ints, cand = _parent_roots(d_corner.reshape(n_cv, 8, dv.R_COLS),
                                   plane, e01, idx)
        dnew, grank, ge0, gde, gcols, gx = dv.curved_gd_plain(
            net.outputs(cand), plane, ints, e01, idx, eps, cw)
        n_sent, n_gd = (int(x) for x in eng.read(cw[dv.CW_SENT:dv.CW_ANYD0]))
        fo.COUNTERS["sentinels"] += n_sent
        fo.COUNTERS["gd_rows"] += n_gd
        gx_end = gd0 = None
        if n_gd:
            gx_end, gd0, _ = fo.descend(net, ge0[:n_gd], gde[:n_gd],
                                        gcols[:n_gd], gx[:n_gd], idx, eps,
                                        on_test=eng._count_read)
        dv.curved_mix_plain(qs, e01, ints, dnew, grank, gx_end, gd0, eps, Vn,
                            cstate, cw)
    kept = dv.curved_filter_plain(net.outputs(Vn), bz, lanes, ce, Vn, cstate,
                                  idx, eps, cw)
    n_keep, drops = (int(x) for x in eng.read(cw[dv.CW_KEPT:]))
    fo.COUNTERS["strict_drops"] += drops
    return [x[:n_keep] for x in kept]


@pytest.mark.parametrize("case", ["rescue", "no_rescue"])
def test_curved_reads_and_order(kinked_nets, monkeypatch, case):
    """``Engine._curved`` against ``_parent_curved`` on 300 synthetic split
    rows of the x30000 net at plane 20 (ends in [-1, 1]^3 at a plane below
    idx): the survivors and the ``failover.COUNTERS`` deltas bit for bit;
    with rescued rows as many reads, without (each curved row's ends equal
    in one coordinate, a box flat along it: K7's sentinel for every row)
    one read fewer."""
    monkeypatch.setattr(fo.descend, "__defaults__", (GD_STEPS, 1e-2, None))
    net, idx, n = kinked_nets["gd"], 20, 300
    rng = np.random.default_rng(7)
    a = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    if case == "no_rescue":
        axis = rng.integers(0, 3, n)
        b[np.arange(n), axis] = a[np.arange(n), axis]
    V = torch.from_numpy(np.concatenate([a, b]))
    ce = torch.from_numpy(np.stack([np.arange(n), n + np.arange(n)], 1)
                          .astype(np.int32))
    words = rng.integers(0, 2 ** 32, (n, dv.NW), dtype=np.int64)
    words[:, 0] |= 1 << rng.integers(0, idx, n)
    bz = dv._to_i32(torch.from_numpy(words)).contiguous()
    Vn = 0.5 * (V[:n] + V[n:])
    lanes = torch.arange(n, dtype=torch.int32)
    runs = []
    for curved in ("engine", "parent"):
        eng = dv.Engine(net, force=False)
        cw = dv._zeros32(dv.CW, device="cpu")
        sel = dv.curved_select_plain(ce, bz, V, idx, EPS, cw)
        fo.reset_counters()
        args = (lanes, ce, Vn.clone(), bz, *sel, idx, cw)
        kept = (eng._curved(dv.Pools(V, *[None] * 7), *args)
                if curved == "engine" else _parent_curved(eng, *args))
        runs.append((kept, dict(fo.COUNTERS), eng.stats.reads))
    (kept, counters, reads), (pkept, pcounters, preads) = runs
    _same(pkept, kept)
    assert counters == pcounters
    assert counters["curved_steps"] == 1 and counters["sentinels"] > 0
    assert (counters["gd_rows"] > 0) == (case == "rescue")
    assert reads == preads - (case == "no_rescue")


# --- the kernels under emulation ---------------------------------------------

def _same(want, got):
    """Plain outputs against the kernel's (its row outputs of the split or
    curved rows' length: the plain rows first)."""
    for i, (x, y) in enumerate(zip(want, got)):
        if x is None:
            continue
        y = y[:x.shape[0]]
        assert x.shape == y.shape and torch.equal(_bits(x), _bits(y)), i


def _clone(args):
    return [a.clone() if torch.is_tensor(a) else a for a in args]


def _band(rng, shape, share=0.3):
    out = rng.normal(size=shape).astype(np.float32)
    band = rng.random(shape) < share
    out[band] = rng.choice([0.0, EPS / 2, -EPS / 2, EPS, -EPS],
                           band.sum()).astype(np.float32)
    return out


def _select_inputs(case, idx, n=700, n_edges=1100):
    """(E, EB, V, OUT, ZB) of a pool of ``n_edges`` edges (two tiles of 512
    and a ragged one), ``n`` of them split at ``idx``, whose ends differ in
    as many coordinates as ``case`` says."""
    rng = np.random.default_rng(idx + len(case))
    a = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    k = {"none": rng.integers(0, 2, n), "all": rng.integers(2, 4, n)}.get(
        case, rng.integers(0, 4, n))
    step = rng.uniform(0.01, 0.5, (n, 3)).astype(np.float32)
    if case == "ragged":
        # a coordinate that moves by eps, or less, does not count
        step[rng.random((n, 3)) < 0.1] = np.float32(EPS)
    b = a.copy()
    for i in range(n):
        axes = rng.choice(3, k[i], replace=False)
        b[i, axes] += step[i, axes]
    V = np.concatenate([a, b])
    # the split rows' shared zero words, each end's a superset of them
    words = rng.integers(0, 2 ** 32, (n, dv.NW), dtype=np.int64)
    words[:, 1] &= 1
    below = (1 << min(idx, 32)) - 1
    if case == "last_bit":
        words[:, 0] = (words[:, 0] & ~below) | (1 << (idx - 1))
    elif case == "noplane":
        words[rng.random(n) < 0.2, 0] &= ~below
    else:
        words[(words[:, 0] & below) == 0, 0] |= 1 << int(rng.integers(idx))
    extra = rng.integers(0, 2 ** 32, (n, dv.NW), dtype=np.int64)
    ZB = np.concatenate([words | extra, words | (rng.integers(
        0, 2 ** 32, (n, dv.NW), dtype=np.int64) & ~extra)])
    # the outputs at idx of opposite signs at the two ends
    OUT = rng.normal(size=(2 * n, dv.R_COLS)).astype(np.float32)
    OUT[:n, idx] = np.abs(OUT[:n, idx]) + 0.1
    OUT[n:, idx] = -np.abs(OUT[n:, idx]) - 0.1
    # the split edges in row order, among unsplit ones anywhere in the pool
    split = np.zeros(n_edges, bool)
    split[np.sort(rng.choice(n_edges, n, replace=False))] = True
    E = rng.integers(0, 2 * n, (n_edges, 2))
    E[split] = np.stack([np.arange(n), n + np.arange(n)], 1)
    EB = rng.integers(0, 2 ** 32, (n_edges, dv.NW), dtype=np.int64)
    bit = 1 << (idx % 32)
    EB[:, idx // 32] = np.where(split, EB[:, idx // 32] | bit,
                                EB[:, idx // 32] & ~bit)
    return (torch.from_numpy(E.astype(np.int32)),
            dv._to_i32(torch.from_numpy(EB)).contiguous(),
            torch.from_numpy(V), torch.from_numpy(OUT),
            dv._to_i32(torch.from_numpy(ZB)).contiguous())


@pytest.mark.parametrize("idx", PLANES)
@pytest.mark.parametrize("case", ["none", "all", "ragged", "last_bit",
                                  "noplane"])
def test_emulated_curved_select(kern, case, idx):
    """``split_select``'s curved instance against ``split_select_plain``
    then ``curved_select_plain``; its flat instance against the first."""
    pool = _select_inputs(case, idx)
    n = 700
    cws = [dv._zeros32(dv.CW, device="cpu") for _ in range(2)]
    launches.reset()
    want = dv.split_select(*pool, idx, n, EPS, cws[0])
    got = dv.split_select(*pool, idx, n, EPS, cws[1], kern=kern)
    assert torch.equal(cws[0], cws[1])
    _same(want, got)
    _same(want[:4], dv.split_select(*pool, idx, n, kern=kern))
    assert launches.LAUNCHES["split_step"] == 2
    assert launches.LAUNCHES["curved_select"] == 0
    assert want[0].shape[0] == n
    n_cv, bad = int(cws[0][dv.CW_CURVED]), int(cws[0][dv.CW_NOPLANE])
    assert n_cv == {"none": 0, "all": n}.get(case, n_cv)
    assert 0 < n_cv or case == "none"
    assert (bad > 0) == (case == "noplane")
    if case == "last_bit":
        assert (want[5] == idx - 1).all()
    # the state is back at zero: a second launch gives the same bits
    again = dv.split_select(*pool, idx, n, EPS, cws[1].zero_(), kern=kern)
    _same(want, again)


def _resolve_inputs(case, idx, n=600, seed=0):
    rng = np.random.default_rng(seed + idx + len(case))
    e01 = torch.from_numpy(rng.uniform(-1, 1, (n, 2, 3)).astype(np.float32))
    ints = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    ints[rng.random(n) < 0.2] = -1.0
    ints[rng.random(n) < 0.05, 1] = np.float32(1.0000001)
    ints[rng.random(n) < 0.05, 0] = 0.0
    plane = torch.from_numpy(rng.integers(0, idx, n).astype(np.int32))
    outs = _band(rng, (n, dv.R_COLS), 0.9 if case == "no_gd" else 0.5)
    if case == "no_gd":
        outs = np.clip(outs, -EPS, EPS)
    return e01, torch.from_numpy(ints), plane, torch.from_numpy(outs)


def _corner_forward(case, idx, plane):
    """A corner forward [n, 8, R] whose rows at each row's plane and at idx
    are K7's hard rows (``trilinear_cases.kernel_pq``: quartics of known
    roots, cubes constant along an axis, random rows) ("some_gd"), or
    normal draws ("no_gd")."""
    n = plane.shape[0]
    rng = np.random.default_rng(idx + len(case))
    d = rng.normal(size=(n, 8, dv.R_COLS)).astype(np.float32)
    if case == "some_gd":
        p, q, _ = trilinear_cases.kernel_pq()
        rows = np.resize(rng.permutation(p.shape[0]), n)
        r = np.arange(n)
        d[r, :, idx] = q[rows]
        d[r, :, plane.numpy()] = p[rows]
    return torch.from_numpy(d)


@pytest.mark.parametrize("idx", PLANES)
@pytest.mark.parametrize("case", ["no_gd", "some_gd"])
def test_emulated_curved_roots(kern, case, idx):
    """``curved_roots`` (one launch) on 600 curved rows, bitwise its plain
    version, which is bitwise the parent design's chain
    (``_parent_roots``)."""
    e01, _, plane, _ = _resolve_inputs(case, idx)
    d_corner = _corner_forward(case, idx, plane)
    launches.reset()
    want = dv.curved_roots(d_corner, plane, e01, idx)
    _same(_parent_roots(d_corner, plane, e01, idx), want)
    _same(want, dv.curved_roots(d_corner, plane, e01, idx, kern=kern))
    assert launches.LAUNCHES["curved_roots"] == 1
    ints = want[0]
    assert (ints == -1).any() and ((ints >= 0) & (ints <= 1)).all(1).any()


@pytest.mark.parametrize("idx", PLANES)
@pytest.mark.parametrize("case", ["no_gd", "some_gd", "tiles"])
def test_emulated_curved_resolve(kern, case, idx):
    """``curved_resolve`` on 600 curved rows of 800 split rows (one block
    ranks them) and on 1,500 ("tiles": ranked by tiles of 256 and their
    look-back): ``curved_gd`` with its mix (one launch), bitwise its plain
    version, which is bitwise ``curved_gd_plain`` then ``curved_mix_plain``
    without a rescue; and with rescued rows ``curved_mix`` after the
    rescue (its results made up)."""
    e01, ints, plane, outs = _resolve_inputs(case, idx,
                                             1500 if case == "tiles" else 600)
    n, S = e01.shape[0], e01.shape[0] + 200
    rng = np.random.default_rng(idx)
    qs = torch.from_numpy(np.sort(rng.choice(S, n, replace=False))
                          .astype(np.int32))
    Vn = torch.from_numpy(rng.normal(size=(S, 3)).astype(np.float32))
    launches.reset()
    runs = []
    for k in (None, kern):
        V_, cs, cw = Vn.clone(), dv._zeros32(S, device="cpu"), dv._zeros32(
            dv.CW, device="cpu")
        res = dv.curved_gd(outs, plane, ints, e01, qs, idx, EPS, V_, cs, cw,
                           kern=k)
        runs.append([*res, V_, cs, cw])
    _same(*runs)
    V_, cs, cw = Vn.clone(), dv._zeros32(S, device="cpu"), dv._zeros32(
        dv.CW, device="cpu")
    res = dv.curved_gd_plain(outs, plane, ints, e01, idx, EPS, cw)
    dv.curved_mix_plain(qs, e01, ints, res[0], res[1], None, None, EPS, V_,
                        cs, cw)
    _same([*res, V_, cs, cw], runs[0])
    want, cw0 = runs[0][:6], runs[0][-1]
    n_gd = int(cw0[dv.CW_GD])
    assert (n_gd == 0) == (case == "no_gd") and cw0[dv.CW_SENT] > 0
    assert ((cs & dv.CV_CURVED) > 0).sum() == n and (cs & dv.CV_GG).any()
    assert launches.LAUNCHES["curved_resolve"] == 1
    if not n_gd:
        return
    # the rescue's results: roots in [0, 1] (two at its ends), residuals
    # on both sides of the band
    gx = torch.from_numpy(rng.uniform(0, 1, (n_gd, 3)).astype(np.float32))
    gx[:1] = 0.0
    gx[1:2] = 1.0
    gd0 = torch.from_numpy(_band(rng, (n_gd,), 0.5))
    mixed = []
    for k in (None, kern):
        V_, cs, cw = runs[0][6].clone(), runs[0][7].clone(), cw0.clone()
        cw[dv.CW_ANYD0] = 0
        dv.curved_mix(qs, e01, ints, want[0], want[1], gx, gd0, EPS, V_, cs,
                      cw, kern=k)
        mixed.append((V_, cs, cw))
    _same(*mixed)
    assert not torch.equal(mixed[0][0], runs[0][6])
    assert launches.LAUNCHES["curved_resolve"] == 2


def _filter_inputs(case, idx, S=700):
    """(OUTn, bz, lanes, ce, Vn, cstate) of ``S`` split rows (``OUTn``
    16-byte aligned, as the forward gives it).  An output at idx off the
    band fires the override, which zeroes them all, so a row that fails the
    test at idx has |out| = eps; "fire" plants a violation on a shared
    plane below idx."""
    rng = np.random.default_rng(idx + 3 * len(case))
    OUTn = _band(rng, (S, dv.R_COLS))
    chk = {"none": rng.choice([-EPS, EPS], S),
           "all": rng.choice([0.0, EPS / 2, -EPS / 2], S)}.get(
        case, rng.choice([0.0, EPS / 2, EPS, -EPS / 4], S))
    OUTn[:, idx] = chk.astype(np.float32)
    words = rng.integers(0, 2 ** 32, (S, dv.NW), dtype=np.int64)
    below = (1 << min(idx, 32)) - 1
    if case != "fire":
        # no override: the planes both ends share are inside the band
        for c in range(idx):
            on = ((words[:, 0] >> c) & 1) > 0
            OUTn[on, c] = np.float32(EPS / 4)
    else:
        words[5, 0] |= 1 << (idx - 1)
        OUTn[5, idx - 1] = np.float32(0.5)
    words[:, 0] &= below | ~0xFFFFFFFF
    cstate = {"none": rng.choice([0, 3], S), "all": np.zeros(S)}.get(
        case, rng.choice([0, 1, 3, 5, 7], S))
    V = rng.normal(size=(S, 3)).astype(np.float32)
    lanes = np.sort(rng.choice(4 * S, S, replace=False))
    ce = rng.integers(0, 1000, (S, 2))
    return [torch.from_numpy(np.ascontiguousarray(a)).clone() for a in (
        OUTn, dv._to_i32(torch.from_numpy(words)).numpy(),
        lanes.astype(np.int32), ce.astype(np.int32), V,
        cstate.astype(np.int32))]


@pytest.mark.parametrize("anyd0", [0, 1])
@pytest.mark.parametrize("idx", PLANES)
@pytest.mark.parametrize("case", ["none", "all", "ragged", "fire"])
def test_emulated_curved_filter(kern, case, idx, anyd0):
    OUTn, bz, lanes, ce, Vn, cstate = _filter_inputs(case, idx)
    res = []
    launches.reset()
    for k in (None, kern):
        cw = dv._zeros32(dv.CW, device="cpu")
        cw[dv.CW_ANYD0] = anyd0
        res.append((dv.curved_filter(OUTn, bz, lanes, ce, Vn, cstate, idx,
                                     EPS, cw, kern=k), cw))
    (want, cw0), (got, cw1) = res
    assert torch.equal(cw0, cw1)
    _same(want, got)
    kept = int(cw0[dv.CW_KEPT])
    assert kept == {"none": 0, "all": 700}.get(case, kept)
    assert 0 < kept < 700 or case in ("none", "all")
    # the override fired (every survivor's output at idx zeroed) in "fire"
    assert kept == 0 or bool((want[1][:, idx] == 0).all()) == (
        case == "fire")
    assert launches.LAUNCHES["curved_filter"] == 2


@pytest.mark.parametrize("idx", PLANES)
@pytest.mark.parametrize("case", ["ragged", "fire"])
def test_emulated_finish_after_the_filter(kern, case, idx):
    """``curved_filter``, then K4's finish alone on its survivors
    (``survivors=True``: one launch, no second override test), against the
    plain composition (``curved_filter_plain``, ``split_finish_plain``,
    whose test finds no violation there): every output and the pools it
    rewrites in place, at a hidden insertion and at the final one."""
    OUTn, bz, lanes, ce, Vn, cstate = _filter_inputs(case, idx)
    rng = np.random.default_rng(idx)
    S, nV = OUTn.shape[0], 1000
    E = torch.from_numpy(rng.integers(0, nV, (4 * S, 2)).astype(np.int32))
    EB, SB, ZB = (dv._to_i32(torch.from_numpy(rng.integers(
        0, 2 ** 32, (m, dv.NW), dtype=np.int64))).contiguous()
        for m in (4 * S, nV, nV))
    LD = torch.from_numpy(rng.integers(-1, 33, 4 * S).astype(np.int32))
    final = idx == PLANES[1]
    runs = []
    launches.reset()
    for k in (None, kern):
        cw = dv._zeros32(dv.CW, device="cpu")
        kept = dv.curved_filter(OUTn, bz, lanes, ce, Vn, cstate, idx, EPS, cw,
                                kern=k)
        n = int(cw[dv.CW_KEPT])
        Vs, OUTs, bzs, lanes_s, ces = (x[:n].clone() for x in kept)
        pools = [x.clone() for x in (E, EB, LD)]
        res = dv.split_finish(OUTs, bzs, lanes_s, ces, *pools, SB, ZB, nV,
                              idx, EPS, final, kern=k, survivors=True)
        runs.append([Vs, OUTs, *res, *pools, cw])
    _same(*runs)
    kept = runs[0][1]
    assert 0 < kept.shape[0] < S
    assert bool((kept[:, idx] == 0).all()) == (case == "fire")
    assert launches.LAUNCHES["curved_filter"] == 2
    assert launches.LAUNCHES["split_step"] == 1


# the stage functions of the curved route: K4's selection (its curved
# instance) and finish (alone), and K4c's
K4C = ("split_select", "curved_roots", "curved_gd", "curved_mix",
       "curved_filter", "split_finish")


@pytest.fixture(scope="module")
def recorded(kinked_nets):
    """Every call of the curved route's stages in the kinked net's run
    (plain versions, from the host skeleton), its tensor arguments cloned
    as given, and its keywords."""
    from tropical_torch.extract.skeleton import grid_skeleton

    net = kinked_nets["kinked"]
    calls, real = [], {name: getattr(dv, name) for name in K4C}

    def recorder(name):
        def call(*args, **kw):
            calls.append((name, _clone(args), kw))
            return real[name](*args, **kw)
        return call

    try:
        for name in K4C:
            setattr(dv, name, recorder(name))
        _device_loop(net, *grid_skeleton(net))
    finally:
        for name in K4C:
            setattr(dv, name, real[name])
    return calls


def test_emulated_recorded_calls(builds, recorded):
    """Each recorded call by the kernels (the design, and K4c's first
    design through the same calls) and by the plain version, on clones of its arguments:
    every output and every argument changed in place (the count words, the
    mix's vertices and states, the pools the finish rewrites) bitwise."""
    names = [name for name, *_ in recorded]
    assert names.count("split_select") == names.count("split_finish") == 11
    # 7 insertions with curved rows; the mix, and the filter a second
    # time, after the one rescue
    assert names.count("curved_roots") == names.count("curved_gd") == 7
    assert names.count("curved_mix") == 1
    assert names.count("curved_filter") == 11 + 1
    assert all(len(args) == 9 for name, args, _ in recorded
               if name == "split_select")
    assert all(kw["survivors"] for name, _, kw in recorded
               if name == "split_finish")
    launches.reset()
    for name, args, kw in recorded:
        fn = getattr(dv, name)
        a = _clone(args)
        want = fn(*a, **{**kw, "kern": None})
        for build, kern in builds.items():
            b = _clone(args)
            got = fn(*b, **{**kw, "kern": kern})
            _same(want if isinstance(want, tuple) else [want],
                  got if isinstance(got, tuple) else [got])
            _same([x for x in a if torch.is_tensor(x)],
                  [y for y in b if torch.is_tensor(y)])
    # the design's selection and finish one launch each; the first design's
    # two each (the flat selection and its curved_select, the finish with
    # its override test)
    assert launches.LAUNCHES["split_step"] == 11 * (1 + 1) + 11 * (2 + 2)
    assert launches.LAUNCHES["curved_select"] == 0
    # curved_roots one launch, the first design's three (curved_pick, K7,
    # curved_points); curved_gd one, the first design's two (with
    # curved_mix); the rescue's curved_mix one in each
    assert launches.LAUNCHES["curved_roots"] == 7 * (1 + 3)
    assert launches.LAUNCHES["curved_resolve"] == 7 * (1 + 2) + 1 * 2
