"""K4 ``split_step`` of the device engine (``csrc/device_engine.cu``) run on the
CPU: the source built with g++ against ``tests/cuda_emulation.h`` in its
design (``split_select``; ``split_finish``: ``split_check`` and the
finish) and its first design
(``cuda_build.DEVICE_ENGINE_FIRST``: ``split_mark``, a torch.cumsum,
``split_lerp``, ``split_override``, ``split_append``), each held bitwise to
the plain versions on synthetic pools:

- the selection on 3,509 edges (three tiles of 1,024 and a ragged one):
  about a quarter split, one edge split (in the last tile), every edge split;
- the override and the append on the ragged selection (a few blocks of 256
  rows, the last ragged), the override firing in the first block only, in
  the last block only and nowhere, at a hidden insertion and at the final
  one;
- the kernels' counters and flags back at zero after every launch (a
  second launch on the same inputs gives the same bits), the launches each
  build records, and a misaligned ``OUTn`` refused;
- one overridden case held to the JAX package's expression
  (``tropical/extract/device.py``, s5: ``jnp.where(viol & b, 0.0,
  cand_out)``, packed by ``_pack_out_words``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_device_kernels import ENGINE_BUILDS, _bits, _build
from tropical.extract import device as jdv
from tropical_torch.extract import device as dv
from tropical_torch.ops import launches

EPS = 1e-4
N_VERTICES, N_EDGES = 2000, 3 * 1024 + 437
# a hidden insertion's plane (columns below it in word 0) and the final one
# (columns 0-31 below it, itself in word 1)
PLANES = {False: 20, True: 32}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def kernels(tmp_path_factory):
    return {k: dv.Kernels(lib, torch.device("cpu")) for k, lib in
            _build(tmp_path_factory, "device_engine", ENGINE_BUILDS).items()}


def _band(rng, shape):
    """Normal outputs with about 30 % of them in or on the eps band."""
    out = rng.normal(size=shape).astype(np.float32)
    band = rng.random(shape) < 0.3
    out[band] = rng.choice([0.0, EPS / 2, -EPS / 2, EPS, -EPS],
                           band.sum()).astype(np.float32)
    return out


def _pool(case, idx):
    """(V, OUT, SB, ZB, E, EB, LD) of a synthetic pool, EB's bit ``idx``
    as ``case`` says: "ragged" the edges' own, "one" the last edge only,
    "all" every edge."""
    rng = np.random.default_rng(idx)
    V = torch.from_numpy(rng.uniform(-1, 1, (N_VERTICES, 3)).astype(np.float32))
    OUT = torch.from_numpy(_band(rng, (N_VERTICES, dv.R_COLS)))
    SB, ZB, _ = dv._pack_out_words(OUT, EPS)
    a = rng.integers(0, N_VERTICES, N_EDGES)
    b = (a + rng.integers(1, N_VERTICES, N_EDGES)) % N_VERTICES
    E = torch.from_numpy(np.stack([a, b], 1).astype(np.int32))
    EB, LD = dv._edge_bits(SB[E[:, 0].long()], ZB[E[:, 0].long()],
                           SB[E[:, 1].long()], ZB[E[:, 1].long()])
    bit = torch.tensor(1 << (idx % 32)).to(torch.int32)
    if case == "one":
        EB[:, idx // 32] &= ~bit
        EB[-1, idx // 32] |= bit
    elif case == "all":
        EB[:, idx // 32] |= bit
    return V, OUT, SB, ZB, E, EB.contiguous(), LD


def _select(kern, build, E, EB, V, OUT, ZB, idx, n_split):
    """The selection by a build's stages (the first design's four-pass
    stages with their torch.cumsum), or the plain version for None."""
    if kern is not None and build == "first":
        cum = dv.split_cumsum(dv.split_mark(EB, idx, kern=kern))
        return dv.split_lerp(E, cum, V, OUT, ZB, idx, n_split, kern=kern)
    return dv.split_select(E, EB, V, OUT, ZB, idx, n_split, kern=kern)


def _finish(kern, build, args, final):
    """The override and the append by a build's stages on clones of
    ``args`` (OUTn, bz, lanes, ce, E, EB, LD, SB, ZB, nV, idx): the
    results, then the arguments changed in place (OUTn, E, EB, LD)."""
    OUTn, bz, lanes, ce, E, EB, LD, SB, ZB, nV, idx = [
        a.clone() if torch.is_tensor(a) else a for a in args]
    if kern is not None and build == "first":
        viol = dv.split_override(OUTn, bz, idx, EPS, kern=kern)
        res = dv.split_append(OUTn, bz, viol, lanes, ce, E, EB, LD, SB, ZB,
                              nV, idx, EPS, final, kern=kern)
    else:
        res = dv.split_finish(OUTn, bz, lanes, ce, E, EB, LD, SB, ZB, nV, idx,
                              EPS, final, kern=kern)
    return [*res, OUTn, E, EB, LD]


def _same(want, got):
    assert len(want) == len(got)
    for i, (x, y) in enumerate(zip(want, got)):
        if x is None:
            assert y is None, i
            continue
        assert x.shape == y.shape and torch.equal(_bits(x), _bits(y)), i


@pytest.mark.parametrize("build", ENGINE_BUILDS)
@pytest.mark.parametrize("case", ["ragged", "one", "all"])
def test_emulated_split_select_cases(kernels, case, build):
    """The split edges' lanes, ends, new vertices and shared zero words,
    bitwise the plain version's, in edge order; a second launch gives the
    same bits (the tile counter and status words back at zero); the
    launches each build records (1, or the first design's 2)."""
    idx = PLANES[False]
    V, OUT, SB, ZB, E, EB, LD = _pool(case, idx)
    n_split = int(dv._bit(EB, idx).sum())
    want = _select(None, build, E, EB, V, OUT, ZB, idx, n_split)
    launches.reset()
    got = _select(kernels[build], build, E, EB, V, OUT, ZB, idx, n_split)
    again = _select(kernels[build], build, E, EB, V, OUT, ZB, idx, n_split)
    _same(want, got)
    _same(want, again)
    assert launches.LAUNCHES["split_step"] == 2 * (1 if build == "design"
                                                   else 2)
    if case == "ragged":
        assert 600 < n_split < 1200
    elif case == "one":
        assert n_split == 1 and int(want[0][0]) == N_EDGES - 1
    else:
        assert n_split == N_EDGES


def _finish_args(fire, final):
    """The override and append's arguments at the ragged selection: OUTn
    with every override column in or on the eps band but, where ``fire``
    says, one row's plane-idx output off it, in the first block (row 5) or
    the last (the last row)."""
    idx = PLANES[final]
    V, OUT, SB, ZB, E, EB, LD = _pool("ragged", idx)
    n_split = int(dv._bit(EB, idx).sum())
    lanes, ce, Vn, bz = dv.split_select(E, EB, V, OUT, ZB, idx, n_split)
    rng = np.random.default_rng(7)
    OUTn = torch.from_numpy(_band(rng, (n_split, dv.R_COLS)))
    mask = dv._override_mask(bz, idx)
    small = rng.choice([0.0, EPS / 2, -EPS / 2, EPS, -EPS], int(mask.sum()))
    OUTn[mask] = torch.from_numpy(small.astype(np.float32))
    if fire == "first":
        OUTn[5, idx] = 0.5
    elif fire == "last":
        OUTn[-1, idx] = -0.5
    return OUTn, bz, lanes, ce, E, EB, LD, SB, ZB, N_VERTICES, idx


@pytest.mark.parametrize("build", ENGINE_BUILDS)
@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("fire", ["first", "last", "none"])
def test_emulated_split_finish_cases(kernels, fire, final, build):
    """The new vertices' words, the right edges and their words, and OUTn,
    E, EB and LD as changed in place, bitwise the plain version's; the
    override zeroes every row's override columns when one row violates,
    wherever that row lies; a second launch on the same inputs gives the
    same bits (the ticket and flag back at zero); each build records 2
    launches a call (the check and the finish, or the first design's
    override and append)."""
    args = _finish_args(fire, final)
    S = args[0].shape[0]
    assert S > 3 * 256 and S % 256
    want = _finish(None, build, args, final)
    launches.reset()
    got = _finish(kernels[build], build, args, final)
    again = _finish(kernels[build], build, args, final)
    _same(want, got)
    _same(want, again)
    assert launches.LAUNCHES["split_step"] == 4
    mask = dv._override_mask(args[1], args[10])
    changed = _bits(want[6]) != _bits(args[0])
    if fire == "none":
        assert not changed.any()
    else:
        assert changed.any() and not (changed & ~mask).any()
        assert (want[6][mask] == 0).all()
    if final:
        assert want[4] is None and want[5] is None
        assert torch.equal(want[8], args[5]) and torch.equal(want[9], args[6])


@pytest.mark.parametrize("build", ENGINE_BUILDS)
def test_emulated_override_is_jax_s5(kernels, build):
    """An overridden hidden insertion: the port's new words and zeroed
    OUTn against the JAX package's s5 (``b = (both_zero_col & (col <
    idx)) | (col == idx)``, ``jnp.where(viol & b, 0.0, cand_out)``) packed
    by its ``_pack_out_words``."""
    args = _finish_args("last", False)
    OUTn, bz, idx = args[0], args[1], args[10]
    got = _finish(kernels[build], build, args, False)
    S = OUTn.shape[0]
    both = np.stack([dv._bit(bz, c).numpy() for c in range(dv.R_COLS)], 1)
    col = np.arange(dv.R_COLS)[None, :]
    cand_out = jnp.asarray(OUTn.numpy())
    b = (jnp.asarray(both) & (col < idx)) | (col == idx)
    viol = (jnp.ones((S, 1), bool) & b & (jnp.abs(cand_out) > EPS)).any()
    cand_out = jnp.where(viol & b, 0.0, cand_out)
    assert bool(viol)
    words = jdv._pack_out_words(cand_out, EPS)
    for w, port in zip(words, got[:3]):
        assert np.array_equal(np.asarray(w).T,
                              port.numpy().view(np.uint32))
    assert np.array_equal(np.asarray(cand_out).view(np.int32),
                          got[6].numpy().view(np.int32))


@pytest.mark.parametrize("build", ENGINE_BUILDS)
def test_emulated_split_finish_refuses_misaligned_rows(kernels, build):
    """The design stages OUTn's rows by 16-byte loads: an OUTn 4 bytes off
    alignment is refused before any launch; the first design takes it."""
    args = list(_finish_args("none", False))
    S = args[0].shape[0]
    buf = torch.empty(S * dv.R_COLS + 1)
    OUTn = buf[1:].view(S, dv.R_COLS)
    OUTn.copy_(args[0])
    kern = kernels[build]
    launches.reset()
    if build == "first":
        viol = dv.split_override(OUTn, args[1], args[10], EPS, kern=kern)
        assert int(viol[0]) == 0
        return
    with pytest.raises(RuntimeError, match="split_finish kernel launch "
                                           "failed: CUDA error 1"):
        dv.split_finish(OUTn, *args[1:], EPS, False, kern=kern)
    assert launches.LAUNCHES["split_step"] == 0
