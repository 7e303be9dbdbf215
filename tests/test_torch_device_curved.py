"""The device engine's curved path (``force=False``; ``extract/device.py``,
K4c: the selection in ``split_select``'s curved instance, ``curved_pick``,
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
- The K4c kernels built with g++ against ``tests/cuda_emulation.h`` and
  held bitwise to their plain versions: ``split_select``'s curved instance
  against ``split_select_plain`` then ``curved_select_plain`` (and its flat
  instance) on synthetic pools (no curved row, all curved, ragged; every
  edge's plane the last column below idx; curved rows on no plane);
  ``curved_pick`` and ``curved_resolve`` (no rescued row and some);
  ``curved_filter`` (survivors none, all and ragged, the override firing),
  and K4's finish alone on its survivors against the plain composition; at
  a hidden insertion and the final one; and every call of the kinked net's
  run, recorded, in the design and in K4c's first design
  (``cuda_build.CURVED_FIRST``, through the same calls: ``curved_select``
  after the flat selection, the filter by ``split_check`` and a thread a
  row, the finish with its check).
"""

import json
import os

import numpy as np
import pytest
import torch

from test_device_curved import _kinked_net
from test_torch_curved import _torch_twin
from test_torch_device_engine import curved_loop_is_the_host_engine
from test_torch_device_kernels import _bits, _build
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


@pytest.mark.parametrize("idx", PLANES)
@pytest.mark.parametrize("case", ["no_gd", "some_gd"])
def test_emulated_curved_pick_and_resolve(kern, case, idx):
    """``curved_pick``, then ``curved_resolve``'s three stages (the points,
    the residuals and the rescue's rows, the mix) on 600 curved rows of 800
    split rows, with the rescue's results made up."""
    e01, ints, plane, outs = _resolve_inputs(case, idx)
    n = e01.shape[0]
    rng = np.random.default_rng(idx)
    d_corner = torch.from_numpy(rng.normal(size=(n, 8, dv.R_COLS)).astype(
        np.float32))
    launches.reset()
    _same(dv.curved_pick(d_corner, plane, idx),
          dv.curved_pick(d_corner, plane, idx, kern=kern))
    _same([dv.curved_points(e01, ints)],
          [dv.curved_points(e01, ints, kern=kern)])
    cws = [dv._zeros32(dv.CW, device="cpu") for _ in range(2)]
    want = dv.curved_gd(outs, plane, ints, e01, idx, EPS, cws[0])
    got = dv.curved_gd(outs, plane, ints, e01, idx, EPS, cws[1], kern=kern)
    assert torch.equal(cws[0], cws[1])
    _same(want, got)
    n_gd = int(cws[0][dv.CW_GD])
    assert (n_gd == 0) == (case == "no_gd") and cws[0][dv.CW_SENT] > 0
    # the rescue's results: roots in [0, 1] (two at its ends), residuals
    # on both sides of the band
    gx = torch.from_numpy(rng.uniform(0, 1, (n_gd, 3)).astype(np.float32))
    gx[:1] = 0.0
    gx[1:2] = 1.0
    gd0 = torch.from_numpy(_band(rng, (n_gd,), 0.5))
    qs = torch.from_numpy(np.sort(rng.choice(n + 200, n, replace=False))
                          .astype(np.int32))
    S = n + 200
    Vn = torch.from_numpy(rng.normal(size=(S, 3)).astype(np.float32))
    outs_mix = []
    for k in (None, kern):
        V_, cs, cw = Vn.clone(), dv._zeros32(S, device="cpu"), cws[0].clone()
        dv.curved_mix(qs, e01, ints, want[0], want[1],
                      gx if n_gd else None, gd0 if n_gd else None, EPS, V_,
                      cs, cw, kern=k)
        outs_mix.append((V_, cs, cw))
    _same(*outs_mix)
    cs = outs_mix[0][1]
    assert ((cs & dv.CV_CURVED) > 0).sum() == n and (cs & dv.CV_GG).any()
    assert launches.LAUNCHES["curved_pick"] == 1
    assert launches.LAUNCHES["curved_resolve"] == 3


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
K4C = ("split_select", "curved_pick", "curved_points", "curved_gd",
       "curved_mix", "curved_filter", "split_finish")


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
    assert names.count("curved_mix") == 7
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
