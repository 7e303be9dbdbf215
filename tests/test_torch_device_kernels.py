"""The device engine's CUDA sources, run on the CPU: ``csrc/lattice_encode.cu``
(K2) and ``csrc/device_engine.cu`` (K3, K4, K5) built with g++ against
``tests/cuda_emulation.h`` (one thread a lane, a barrier in each
``__syncthreads``) and held bitwise to their plain versions.

- K2 at the three presets' grids (large's finest level hashes), with and
  without the derivatives, on lattices of marks and of uniform draws.
- K3-K5 through the whole engine: a seeded 11-mark net (its table scaled so
  that its zero set crosses the cube, the final bias shifted onto it) from
  the dist skeleton to the final insertion, and its sign skeleton; every
  output of the emulated kernels equals the plain versions' and every
  kernel launched.
- Stage edge cases: the max-pool with a NaN, empty compactions.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_encode_forward import emulated_source
from tropical_torch.core import hashgrid as thg
from tropical_torch.extract import device as dv
from tropical_torch.ops import launches

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the plain versions run many small operations, which
    a thread pool only slows when the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _build(tmp_path_factory, name):
    compiler = shutil.which("g++")
    if compiler is None:
        pytest.skip("needs g++ to emulate the CUDA source")
    out = tmp_path_factory.mktemp(name)
    cpp = out / f"{name}.cpp"
    cpp.write_text(emulated_source(
        (ROOT / "tropical_torch" / "csrc" / f"{name}.cu").read_text()))
    so = out / f"lib{name}.so"
    proc = subprocess.run([compiler, "-std=c++20", "-O1", "-ffp-contract=off",
                           "-fPIC", "-shared", "-pthread",
                           f"-I{ROOT / 'tests'}", "-include", "cuda_emulation.h",
                           "-o", str(so), str(cpp)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, f"g++ failed for {name}:\n{proc.stderr}"
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def lattice_lib(tmp_path_factory):
    return _build(tmp_path_factory, "lattice_encode")


@pytest.fixture(scope="module")
def engine_kernels(tmp_path_factory):
    return dv.Kernels(_build(tmp_path_factory, "device_engine"),
                      torch.device("cpu"))


def _emulated_level(lib, spec, G, l, xs, ys, zs, need_grad):
    """The K2 launch of the emulated build on CPU tensors."""
    n = xs.shape[0] * ys.shape[0] * zs.shape[0]
    LF = spec.levels * 2
    feat = torch.full((n, LF), float("nan"))
    grad = torch.full((3, n, LF), float("nan")) if need_grad else None
    fn = thg._lattice_fn(lib)
    rc = fn(xs.data_ptr(), ys.data_ptr(), zs.data_ptr(), xs.shape[0],
            ys.shape[0], zs.shape[0], G.data_ptr(), thg.corner_bins(spec, l),
            np.float32(spec.level_scale(l)).item(),
            float(thg._tangent(spec, l, 1.0)), feat.data_ptr() + 8 * l,
            None if grad is None else grad.data_ptr() + 8 * l, LF, n * LF,
            None)
    assert rc == 0
    cols = slice(2 * l, 2 * l + 2)
    return feat[:, cols], None if grad is None else grad[:, :, cols]


@pytest.mark.parametrize("r_max", [32, 64, 128])
def test_emulated_lattice_encode_is_bitwise_plain(lattice_lib, r_max):
    spec = thg.HashGridSpec(levels=4, n_min=r_max // 16, n_max=r_max,
                            log2_table=19)
    rng = np.random.default_rng(r_max)
    table = torch.from_numpy(
        rng.normal(size=(spec.n_entries, 2)).astype(np.float32))
    marks = thg.compute_marks(spec)
    axes = [np.sort(rng.choice(marks, n, replace=False)) for n in (5, 4, 6)]
    axes[1] = np.sort(rng.uniform(0, 1, 4)).astype(np.float32)
    xs, ys, zs = (torch.from_numpy(a.astype(np.float32)) for a in axes)
    for l in range(spec.levels):
        G = thg.corner_table(spec, table, l)
        for need_grad in (False, True):
            f, g = _emulated_level(lattice_lib, spec, G, l, xs, ys, zs,
                                   need_grad)
            pf, pg = thg.lattice_level_plain(spec, G, l, xs, ys, zs,
                                             need_grad)
            assert torch.equal(f.contiguous().view(torch.int32),
                               pf.view(torch.int32))
            if need_grad:
                assert torch.equal(g.contiguous().view(torch.int32),
                                   pg.view(torch.int32))
    assert spec.level_uses_hash(3) == (r_max == 128)


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


@pytest.mark.parametrize("mode", ["dist", "sign"])
def test_emulated_engine_is_bitwise_plain(engine_kernels, net11, mode):
    """The dist run through the loop; the sign run's skeleton (its loop is
    the same run here: the distance bound prunes nothing at 11 marks)."""
    runs = {}
    for name, kern in (("plain", None), ("kernels", engine_kernels)):
        launches.reset()
        eng = dv.Engine(net11, kern=kern)
        sk = eng.skeleton(mode)
        out = []
        if mode == "dist":
            P, counts = eng.pools(sk[0], sk[1], sk[5], sk[2:5])
            out = list(eng.loop(P, counts))
        runs[name] = (list(sk) + out, eng.stats.busy,
                      dict(launches.LAUNCHES))
    if mode == "sign":
        for x, y in zip(runs["plain"][0], runs["kernels"][0]):
            assert x.shape == y.shape and torch.equal(_bits(x), _bits(y))
        assert runs["kernels"][2]["skeleton_mark"] == 3
        return
    (a, busy_a, _), (b, busy_b, count) = runs["plain"], runs["kernels"]
    assert busy_a == busy_b and len(busy_a) >= 6
    assert any(c for *_, c in busy_a[:-1]) and any(h for _, _, h, _ in busy_a)
    for x, y in zip(a, b):
        assert x.shape == y.shape and torch.equal(_bits(x), _bits(y))
    # every stage launched: the skeleton's 6 (3 of them pools), then per
    # busy insertion 4 of K4 and at least 6 of K5
    assert count["skeleton_mark"] == 6
    assert count["split_step"] >= 4 * len(busy_a) + 2
    assert count["connect_step"] >= 6 * len(busy_a)


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
    cnt = dv.connect_count(C, e, e, e, e, 3, M, True, None, None, kern=k)
    assert cnt.shape == (0,) and launches.LAUNCHES["connect_step"] == before
