"""The device engine's CUDA sources, run on the CPU: ``csrc/lattice_encode.cu``
(K2) and ``csrc/device_engine.cu`` (K3, K4, K5, and K6 from the
``csrc/faces.cu`` it includes) built with g++ against
``tests/cuda_emulation.h`` (one thread a lane, a barrier in each
``__syncthreads``) and held bitwise to their plain versions.

- K2's one launch for every level, at the three presets' grids (large's
  finest level hashes), with and without the derivatives, on a lattice
  whose point count is not a multiple of the block; also its first design
  (a level a launch), and a launch that leaves a level alone on a grid of
  an odd count of levels; the kernels each build's launch reports.
- K3-K5 through the whole engine, in the designs and the first designs: a
  seeded 11-mark net (its table scaled so that its zero set crosses the
  cube, the final bias shifted onto it) from the dist skeleton to the final
  insertion, and its sign skeleton; every output of the emulated kernels
  equals the plain versions' and every kernel launched, as many as each
  build records.
- K3 alone (``Engine.mark``) in both designs on synthetic 11^3 lattices
  (1,331 points and 3,630 edges: no multiple of a 32-bit word or of a
  block): random outputs with a band of near-zero ones, a pool radius of 2
  and a NaN in |grad sdf|; the global max (radius 0); the sign skeleton;
  no edge (``mark`` returns None); edges whose lower end is the last bit
  of a mask word and of a block.
- K5's column table and pair scan (the design and the first design) on
  synthetic candidates: empty columns, columns at x and y = 0 and W - 1, a
  cell of more candidates than a warp, one candidate, none; the launches
  each build records; ``compact_rows`` at widths 1, 2 and 33 with no rows
  kept, some and all, and its refusal of an outputs' pool of 2^31 words.
- Stage edge cases: the max-pool with a NaN, empty compactions.
- K6 on the 11-mark net's complex after the final insertion, in the
  design and in its first design (-DFACES_FIRST, built into the first
  designs' library): every stage call of the build's ``Engine.faces``
  held bitwise to its plain version, the whole stage's result the plain
  engine's, two launches of each of the four kernels; and every stage on
  the planted cases of ``tests/faces_cases.py`` (duplicate regions in an
  A, B, A signature run, repeated ids, 1, 2, 8, 9, 12 and 100 members,
  exact score ties, cell offsets -1, 0 and M - 1, five tiles of vertices
  with every zero count 0 to 35, five tiles of region slots, one kept
  region and none).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import faces_cases
from test_torch_encode_forward import emulated_source
from tropical_torch.core import hashgrid as thg
from tropical_torch.extract import device as dv
from tropical_torch.ops import cuda_build, launches

ROOT = Path(__file__).resolve().parents[1]
# the builds held here: the designs and the first designs
LATTICE_BUILDS = {"design": (), "first": cuda_build.LATTICE_FIRST[1]}
# (K6's first design, -DFACES_FIRST, rides in the first designs' build)
ENGINE_BUILDS = {"design": (), "first": cuda_build.DEVICE_ENGINE_FIRST[1]
                 + cuda_build.FACES_FIRST[1]}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the plain versions run many small operations, which
    a thread pool only slows when the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _build(tmp_path_factory, name, builds):
    """{build: library} of ``csrc/<name>.cu`` with each build's macros,
    one g++ a build, all started together."""
    compiler = shutil.which("g++")
    if compiler is None:
        pytest.skip("needs g++ to emulate the CUDA source")
    out = tmp_path_factory.mktemp(name)
    cpp = out / f"{name}.cpp"
    cpp.write_text(emulated_source(
        (ROOT / "tropical_torch" / "csrc" / f"{name}.cu").read_text()))
    procs = {}
    for build, defines in builds.items():
        so = out / f"lib{name}_{build}.so"
        procs[build] = (so, subprocess.Popen(
            [compiler, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
             "-shared", "-pthread", f"-I{ROOT / 'tests'}", "-include",
             "cuda_emulation.h", *(f"-D{d}" for d in defines), "-o", str(so),
             str(cpp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for build, (so, proc) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"g++ failed for {name} {build}:\n{log}"
        libs[build] = ctypes.CDLL(str(so))
    return libs


@pytest.fixture(scope="module")
def lattice_libs(tmp_path_factory):
    return _build(tmp_path_factory, "lattice_encode", LATTICE_BUILDS)


@pytest.fixture(scope="module")
def engine_libs(tmp_path_factory):
    return {k: dv.Kernels(lib, torch.device("cpu")) for k, lib in
            _build(tmp_path_factory, "device_engine", ENGINE_BUILDS).items()}


@pytest.fixture(scope="module")
def engine_kernels(engine_libs):
    return engine_libs["design"]


def _emulated_encode(lib, spec, tables, xs, ys, zs, need_grad):
    """The K2 launch of an emulated build on CPU tensors (the columns of a
    level without a table stay NaN): (feat, grad), and the kernels the
    launch reports."""
    n = xs.shape[0] * ys.shape[0] * zs.shape[0]
    LF = spec.levels * 2
    feat = torch.full((n, LF), float("nan"))
    grad = torch.full((3, n, LF), float("nan")) if need_grad else None
    lv = thg.lattice_levels(spec, tables)
    rc = thg._lattice_fn(lib)(xs.data_ptr(), ys.data_ptr(), zs.data_ptr(),
                              xs.shape[0], ys.shape[0], zs.shape[0],
                              ctypes.byref(lv), feat.data_ptr(),
                              None if grad is None else grad.data_ptr(), None)
    return feat, grad, rc


def _held_to_plain(lib, spec, tables, xs, ys, zs, launched):
    for need_grad in (False, True):
        f, g, rc = _emulated_encode(lib, spec, tables, xs, ys, zs, need_grad)
        assert rc == launched
        for l, G in enumerate(tables):
            cols = slice(2 * l, 2 * l + 2)
            if G is None:
                assert f[:, cols].isnan().all()
                continue
            pf, pg = thg.lattice_level_plain(spec, G, l, xs, ys, zs,
                                             need_grad)
            assert torch.equal(f[:, cols].contiguous().view(torch.int32),
                               pf.view(torch.int32))
            if need_grad:
                assert torch.equal(g[:, :, cols].contiguous().view(
                    torch.int32), pg.view(torch.int32))


@pytest.mark.parametrize("build", LATTICE_BUILDS)
@pytest.mark.parametrize("r_max", [32, 64, 128])
def test_emulated_lattice_encode_is_bitwise_plain(lattice_libs, r_max, build):
    """Every level in one launch, on a 7 x 5 x 9 lattice (315 points: a
    block and a partial one)."""
    spec = thg.HashGridSpec(levels=4, n_min=r_max // 16, n_max=r_max,
                            log2_table=19)
    rng = np.random.default_rng(r_max)
    table = torch.from_numpy(
        rng.normal(size=(spec.n_entries, 2)).astype(np.float32))
    marks = thg.compute_marks(spec)
    axes = [np.sort(rng.choice(marks, n, replace=False)) for n in (7, 5, 9)]
    axes[1] = np.sort(rng.uniform(0, 1, 5)).astype(np.float32)
    xs, ys, zs = (torch.from_numpy(a.astype(np.float32)) for a in axes)
    tables = [thg.corner_table(spec, table, l) for l in range(spec.levels)]
    _held_to_plain(lattice_libs[build], spec, tables, xs, ys, zs,
                   1 if build == "design" else spec.levels)
    assert spec.level_uses_hash(3) == (r_max == 128)


@pytest.mark.parametrize("build", ["design", "first"])
def test_emulated_lattice_encode_leaves_a_level_alone(lattice_libs, build):
    """Five levels (rows of 10 floats: no staging, no float4 stores) with
    level 1 left alone (as a level that takes the pointwise encode)."""
    spec = thg.HashGridSpec(levels=5, n_min=2, n_max=32, log2_table=19)
    rng = np.random.default_rng(5)
    table = torch.from_numpy(
        rng.normal(size=(spec.n_entries, 2)).astype(np.float32))
    xs, ys, zs = (torch.from_numpy(np.sort(rng.uniform(0, 1, n)).astype(
        np.float32)) for n in (3, 11, 8))
    tables = [None if l == 1 else thg.corner_table(spec, table, l)
              for l in range(spec.levels)]
    _held_to_plain(lattice_libs[build], spec, tables, xs, ys, zs,
                   1 if build == "design" else spec.levels - 1)


@pytest.fixture(scope="module")
def net11():
    """A seeded net of 11 marks whose zero set crosses the cube."""
    from tropical_torch.core.net import NetSpec, TorchNet

    net = TorchNet(NetSpec(levels=4, r_min=2, r_max=5, T=12), device="cpu",
                   generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        net.enc.table.mul_(3000.0)
        x = torch.from_numpy(np.random.default_rng(0).uniform(
            -1, 1, (512, 3)).astype(np.float32))
        out = net(x)
        net.fc[2].bias[1] -= float((out[:, 1] - out[:, 0]).mean())
    assert net.marks.shape[0] == 11
    return net


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _engine_run(net, kern, mode):
    """The skeleton and, in dist mode, the complex after the final
    insertion; the busy insertions; the launches."""
    launches.reset()
    eng = dv.Engine(net, kern=kern)
    sk = eng.skeleton(mode)
    out = []
    if mode == "dist":
        out = list(eng.loop(*eng.pools(sk[0], sk[1], sk[5], sk[2:5])))
    return list(sk) + out, eng.stats.busy, dict(launches.LAUNCHES)


@pytest.mark.parametrize("mode", ["dist", "sign"])
def test_emulated_engine_is_bitwise_plain(engine_libs, net11, mode):
    """The dist run through the loop; the sign run's skeleton (its loop is
    the same run here: the distance bound prunes nothing at 11 marks); in
    the design and in the first design."""
    a, busy_a, _ = _engine_run(net11, None, mode)
    for build, kern in engine_libs.items():
        b, busy_b, count = _engine_run(net11, kern, mode)
        assert busy_a == busy_b
        for x, y in zip(a, b):
            assert x.shape == y.shape and torch.equal(_bits(x), _bits(y))
        if mode == "sign":
            # the words, flags, scan and compaction; the first design's
            # points, edges and squeeze
            assert count["skeleton_mark"] == (4 if build == "design" else 3)
            continue
        assert len(busy_a) >= 6 and any(c for *_, c in busy_a[:-1])
        assert any(h for _, _, h, _ in busy_a)
        # every stage launched: the skeleton's 6 (2 pools and 4, or the
        # first design's 3 pools and 3), then per busy insertion 3 of K4
        # (split_select, split_check, split_finish; the first design's 4),
        # the starting
        # pools' edge_words and one for each hidden insertion's connecting
        # edges, and at least 6 of K5
        assert count["skeleton_mark"] == 6
        hidden = [b for b in busy_a if b[0] < 32]
        assert count["split_step"] == (3 if build == "design" else 4) * len(
            busy_a) + 1 + sum(c > 0 for *_, c in hidden)
        assert count["connect_step"] >= 6 * len(busy_a)


# K3's synthetic lattices: (pool radius, dist mode); the outputs by case in
# _mark_inputs
MARK_CASES = {"ragged": (2, True), "global_max": (0, True),
              "sign": (0, False), "no_edges": (2, True),
              "last_bits": (2, True)}


def _mark_inputs(case, M, eps=1e-4):
    """(out [M^3, 33], dq, gn) of a ``MARK_CASES`` lattice."""
    rng = np.random.default_rng(len(case))
    n = M ** 3
    if case in ("no_edges", "last_bits"):
        out = np.full((n, 33), 0.5, np.float32)
        # column 0's sign flipped at the last bit of word 0 and of block 0
        out[[31, 1023] if case == "last_bits" else [], 0] = -0.5
    else:
        out = rng.normal(size=(n, 33)).astype(np.float32)
        band = rng.random((n, 33)) < 0.2
        out[band] = rng.choice([0.0, eps / 2, -eps / 2, eps, -eps],
                               band.sum()).astype(np.float32)
    dq = rng.uniform(0, 0.25, n).astype(np.float32)
    gn = rng.uniform(0, 0.4, n).astype(np.float32)
    if case == "ragged":  # NaN wins the pool (the global max would be NaN)
        gn[rng.integers(0, n)] = np.nan
    return (torch.from_numpy(out), torch.from_numpy(dq),
            torch.from_numpy(gn))


@pytest.mark.parametrize("build", ENGINE_BUILDS)
@pytest.mark.parametrize("case", MARK_CASES)
def test_emulated_skeleton_mark_cases(engine_libs, net11, case, build):
    """K3 (``Engine.mark``) on a synthetic lattice of the 11-mark net, by
    the build's kernels and by the plain versions: every result bitwise,
    or both None."""
    k, dist = MARK_CASES[case]
    out, dq, gn = _mark_inputs(case, int(net11.marks.shape[0]))
    got = []
    for kern in (None, engine_libs[build]):
        eng = dv.Engine(net11, kern=kern)
        eng.dist_k = k
        got.append(eng.mark(out, dq, gn) if dist else eng.mark(out))
    want, sk = got
    if case == "no_edges":
        assert want is None and sk is None
        return
    assert len(sk) == len(want) == 6
    for x, y in zip(want, sk):
        assert x.shape == y.shape and torch.equal(_bits(x), _bits(y))
    E = want[5]
    if case == "last_bits":
        # the edges at points 31 ((0, 2, 9): none below along axis 0) and
        # 1023 ((8, 5, 0): none below along axis 2), 5 each, 3 of them with
        # the point as lower end: bit 31 of word 0, of word 31 (block 0's
        # last)
        assert E.shape[0] == 10
    elif case == "ragged":
        assert 1000 < E.shape[0] < 3630 and want[0].shape[0] < 1331


def test_emulated_stage_edge_cases(engine_kernels):
    k = engine_kernels
    M = 5
    g = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, M ** 3).astype(np.float32))
    g[62] = float("nan")  # the centre (2, 2, 2)
    for axis in range(3):
        got = dv.skeleton_pool(g, M, 2, axis, kern=k)
        want = dv._pool_axis(g, M, 2, axis)
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(got[~got.isnan()], want[~want.isnan()])
        assert int(got.isnan().sum()) == 5
    src = torch.arange(12, dtype=torch.int32).reshape(6, 2)
    none = torch.zeros(6, dtype=torch.int32)
    assert dv.compact_rows(src, none, 0, kern=k).shape == (0, 2)
    cum = torch.cumsum(torch.tensor([0, 1, 1, 0, 0, 1], dtype=torch.int32), 0,
                       dtype=torch.int32)
    assert torch.equal(dv.compact_rows(src, cum, 3, kern=k),
                       dv.compact_rows(src, cum, 3))
    # a connect stage with no candidates launches nothing
    before = launches.LAUNCHES["connect_step"]
    C = torch.zeros((0, 4), dtype=torch.int32)
    e = torch.zeros(0, dtype=torch.int32)
    cols, Cs = dv.connect_table(C, e, e, M, kern=k)
    cnt = dv.connect_count(C, e, e, cols, Cs, e, e, 3, M, True, None, None,
                           kern=k)
    assert cnt.shape == (0, 9) and launches.LAUNCHES["connect_step"] == before


# synthetic insertions for K5's pair scan: (M, cells), each cell (x, y, z
# offsets + 1 in [0, M], candidates in it); "crowded" adds 200 candidates
# in random cells to a cell of 40 and its neighbours
PAIR_CASES = {
    "edges": (9, [(0, 0, 0, 6), (0, 0, 1, 4), (0, 9, 9, 6), (9, 0, 5, 6),
                  (9, 9, 9, 6), (1, 1, 0, 4), (0, 4, 3, 6), (1, 4, 2, 4),
                  (4, 9, 1, 6), (4, 8, 2, 4), (8, 8, 8, 4), (5, 5, 1, 6),
                  (5, 5, 7, 6), (5, 6, 6, 4), (6, 5, 2, 4)]),
    "crowded": (9, [(4, 4, 4, 40), (4, 4, 5, 20), (4, 5, 4, 20),
                    (5, 4, 4, 20)]),
    "single": (9, [(3, 4, 5, 1)]),
    "empty": (9, []),
}


def _pair_inputs(name):
    """Candidate rows [n, 4] (vertex id; zero and sign bits of the 5
    active columns; cell offsets + 1 and on-plane flags) of ``PAIR_CASES``
    and their vertices' words [nV, 2], drawn from small pools so that many
    pairs are compatible and some fail the future-sign pre-filter."""
    rng = np.random.default_rng(len(name))
    M, cells = PAIR_CASES[name]
    if name == "crowded":
        cells = cells + [(*rng.integers(0, M + 1, 3), 1) for _ in range(200)]
    offs = np.array([c[:3] for c in cells for _ in range(c[3])],
                    np.int64).reshape(-1, 3)
    n = offs.shape[0]
    nV = n + 7
    on = rng.random((n, 3)) < 0.5
    zs = rng.choice([0, 2, 4, 6], n)
    sb = rng.choice([0b01001, 0b01011, 0b11001], n) & ~zs & 0x1F
    go = offs[:, 0] | offs[:, 1] << 9 | offs[:, 2] << 18
    for d in range(3):
        go |= on[:, d].astype(np.int64) << (27 + d)
    C = np.stack([rng.permutation(nV)[:n], zs, sb, go], 1).astype(np.int32)
    words = rng.integers(-2 ** 31, 2 ** 31, (4, 2))
    SBx = words[rng.integers(0, 2, nV)].astype(np.int32)
    ZBx = words[rng.integers(2, 4, nV)].astype(np.int32)
    return M, *(torch.from_numpy(a) for a in (C, SBx, ZBx))


def _pair_run(kern, M, C, SBx, ZBx, idx=5):
    """The column table, then for a hidden and the final insertion the
    counts, used marks, split histogram and pairs."""
    skey, perm = torch.sort(dv._cell_key(C[:, 3], M), stable=True)
    perm = perm.to(torch.int32)
    cols, Cs = dv.connect_table(C, skey, perm, M, kern=kern)
    out = {"cols": cols, "Cs": Cs}
    for final in (False, True):
        used = torch.zeros(SBx.shape[0], dtype=torch.int32)
        meta = torch.zeros(dv.META, dtype=torch.int32)
        cnt = dv.connect_count(C, skey, perm, cols, Cs, SBx, ZBx, idx, M,
                               final, None if final else used, meta,
                               kern=kern)
        ccum = torch.cumsum(cnt.reshape(-1), 0, dtype=torch.int32)
        n_conn = int(ccum[-1]) if ccum.numel() else 0
        pairs = dv.connect_fill(C, skey, perm, cols, Cs, SBx, ZBx, idx, M,
                                final, ccum, n_conn, kern=kern)
        out.update({f"cnt{final}": cnt, f"used{final}": used,
                    f"meta{final}": meta, f"pairs{final}": pairs})
    return out


@pytest.mark.parametrize("build", ENGINE_BUILDS)
@pytest.mark.parametrize("case", PAIR_CASES)
def test_emulated_pair_scan_is_bitwise_plain(engine_libs, case, build):
    """K5's column table (but for the first design, which builds none)
    and its two passes, bitwise the plain versions, in scan order."""
    M, C, SBx, ZBx = _pair_inputs(case)
    want = _pair_run(None, M, C, SBx, ZBx)
    got = _pair_run(engine_libs[build], M, C, SBx, ZBx)
    for key, w in want.items():
        if build == "first" and key in ("cols", "Cs"):
            continue
        assert got[key].shape == w.shape and torch.equal(got[key], w), key
    n_pairs = want["pairsTrue"].shape[0]
    assert want["pairsFalse"].shape[0] < n_pairs or case in ("single",
                                                              "empty")
    if case == "crowded":
        assert n_pairs > 1000 and want["Cs"].shape[0] > 256
    if case == "edges":  # columns on every side of the grid hold pairs
        ends = torch.stack([want["pairsTrue"].min(1).values,
                            want["pairsTrue"].max(1).values])
        cells = C[:, 3][torch.isin(C[:, 0], ends.reshape(-1))]
        x, y = cells & 511, (cells >> 9) & 511
        assert {0, M} <= set(x.tolist()) and {0, M} <= set(y.tolist())


@pytest.mark.parametrize("build", ["design", "first"])
@pytest.mark.parametrize("width", [1, 2, 33])
def test_emulated_compact_rows_is_bitwise_plain(engine_libs, width, build):
    """``compact_rows`` of 300 rows (float32 at width 33, as the outputs'
    pool; int32 otherwise) with none kept, some and all."""
    rng = np.random.default_rng(width)
    if width == 33:
        src = torch.from_numpy(rng.normal(size=(300, 33)).astype(np.float32))
        src[7, 3] = float("nan")
    else:
        src = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (300, width),
                                            dtype=np.int64).astype(np.int32))
    if width == 1:
        src = src[:, 0].contiguous()
    for keep in (np.zeros(300), rng.random(300) < 0.3, np.ones(300)):
        cum = torch.cumsum(torch.from_numpy(keep.astype(np.int32)), 0,
                           dtype=torch.int32)
        n = int(cum[-1])
        got = dv.compact_rows(src, cum, n, kern=engine_libs[build])
        want = dv.compact_rows(src, cum, n)
        assert got.shape == want.shape and torch.equal(
            _bits(got), _bits(want))


@pytest.mark.parametrize("build", ENGINE_BUILDS)
def test_emulated_connect_stages_record_their_launches(engine_libs, build):
    """The launches K5's stages record are those their builds make: the
    column table one in the design and none in the first design, then a
    launch a pass and a compaction."""
    M, C, SBx, ZBx = _pair_inputs("crowded")
    launches.reset()
    _pair_run(engine_libs[build], M, C, SBx, ZBx)
    table = 1 if build == "design" else 0
    assert launches.LAUNCHES["connect_step"] == table + 4
    src = torch.zeros((5, 33), dtype=torch.float32)
    cum = torch.arange(1, 6, dtype=torch.int32)
    dv.compact_rows(src, cum, 5, kern=engine_libs[build])
    assert launches.LAUNCHES["connect_step"] == table + 5


def test_emulated_compact_rows_refuses_a_pool_past_int32(engine_kernels):
    """The outputs' pool's word kernel indexes in 32 bits: a pool of 2^31
    words or more is refused before any launch."""
    n = 2 ** 31 // 33 + 1
    src = torch.zeros((2, 33), dtype=torch.int32)
    cum = torch.zeros(2, dtype=torch.int32)
    launches.reset()
    with pytest.raises(RuntimeError, match="compact_rows kernel launch "
                                           "failed: CUDA error 1"):
        engine_kernels("connect_step", "compact_rows", n, src, cum, n, 33,
                       src)
    assert launches.LAUNCHES["connect_step"] == 0


@pytest.mark.parametrize("build", ["design", "first"])
def test_emulated_faces_are_bitwise_plain(engine_libs, net11, build):
    """K6 on the 11-mark net's complex: the build's engine (the design's
    stages, or the first design's) records its stage calls, each held
    bitwise to its plain version; the stage's result equals the plain
    engine's; each of K6's kernels launches twice."""
    kern = engine_libs[build]
    eng = dv.Engine(net11)
    sk = eng.skeleton("dist")
    args = eng.loop(*eng.pools(sk[0], sk[1], sk[5], sk[2:5]))
    want = eng.faces(*args)
    assert want[2].shape[0] > 500
    launches.reset()
    got, calls = faces_cases.record(
        dv, lambda: dv.Engine(net11, kern=kern).faces(*args))
    stages = (faces_cases.K6_STAGES if build == "design"
              else faces_cases.K6_FIRST_STAGES)
    assert [c[0] for c in calls] == list(stages)
    assert got[0] == want[0]
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert {k: launches.LAUNCHES[k] for k in (
        "final_keep", "face_keys", "face_regions", "face_fans")} == {
        "final_keep": 2, "face_keys": 2, "face_regions": 2, "face_fans": 2}
    assert faces_cases.held(dv, calls, kern) == len(stages)


@pytest.mark.parametrize("build", ["design", "first"])
def test_emulated_faces_planted_cases(engine_libs, build):
    """Every planted K6 call of the build's stages (``faces_cases.
    planted_calls``: five tiles with every zero count, regions past the
    shared-memory path, one kept region and none) bitwise its plain
    version."""
    calls = faces_cases.planted_calls(dv, "cpu", first=build == "first")
    assert faces_cases.held(dv, calls, engine_libs[build]) == len(calls)
