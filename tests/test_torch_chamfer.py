"""The port's nearest-neighbour search against the JAX package's XLA twins.

The Pallas kernel ``min_dist_pallas`` cannot run on the CPU, so the port's
plain version is held against ``min_dist_xla`` (matmul expansion for the
argmin, then an exact direct-difference distance) and ``_min_dist_scan``
(direct difference).  Tolerances: the scan sums the same three squares, so
the distances agree to rounding (rtol 1e-6); the XLA expansion may pick a
different neighbour within its cancellation noise (~1e-3 absolute in d2 at
these coordinate scales), so its squared distances agree to 1e-5 absolute.

The CUDA kernel itself is checked on the card by tests/test_torch_gpu.py
and by ``chip_smoke.py``.  Here its arithmetic is: the FMA expansion it
filters with stays within ``expansion_margin`` (with 2x slack) of the exact
distance, and a plain emulation of its filtered, split scan returns the plain
version's (d2, idx) bit for bit, on sets chosen to be hard for the filter.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tropical.ops.chamfer_tpu import min_dist_xla
from tropical.utils.chamfer import PT_CHUNK, _min_dist_scan, _pad_pts
from tropical.utils.chamfer import chamfer_distance as jax_chamfer
from tropical_torch.ops import chamfer as tch
from tropical_torch.ops.launches import LAUNCHES
from tropical_torch.utils.chamfer import chamfer_distance


def _sphere(n, rng):
    # the chamfer stage's inputs: first-hit samples on a surface of radius 0.6
    p = rng.normal(size=(n, 3))
    return (0.6 * p / np.linalg.norm(p, axis=1, keepdims=True)).astype(np.float32)


def _hard_sets():
    """(x, y) float32 pairs that stress the filter: the chamfer stage's
    sphere samples; a cloud offset by +100 on each axis whose nearest
    distances are ~1e-3 (cancellation in |y|^2 - 2 x.y); exact duplicate
    rows; points mirrored across z = 0 (exact ties) and across z = 0.3
    (near-ties), looked up from points on the plane."""
    rng = np.random.default_rng(7)
    sets = {"sphere": (_sphere(2500, rng), _sphere(3000, rng))}
    off = 100.0 + rng.uniform(0.0, 0.0126, size=(3500, 3))
    sets["offset"] = (off[:1500].astype(np.float32),
                      off[1500:].astype(np.float32))
    p = rng.uniform(-1.0, 1.0, size=(1500, 3)).astype(np.float32)
    sets["duplicates"] = (p[::2].copy(), np.concatenate([p[:700], p, p[:300]]))
    for label, c in (("mirror_ties", 0.0), ("mirror_near_ties", 0.3)):
        q = rng.uniform(-0.5, 0.5, size=(1200, 3)).astype(np.float32)
        q[:, 2] = c + np.abs(q[:, 2])
        m = q.copy()
        m[:, 2] = np.float32(2 * c) - q[:, 2]
        x = rng.uniform(-0.5, 0.5, size=(1000, 3)).astype(np.float32)
        x[:, 2] = c
        sets[label] = (x, np.concatenate([q, m]))
    return sets


HARD = _hard_sets()


def _fma(a, b, c):
    # f64 product (exact for f32 inputs) and sum, one rounding to f32
    return (a.double() * b.double() + c.double()).float()


def _sq_norm(p):
    return (p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]) + p[..., 2] * p[..., 2]


def _pack(y):
    """The kernel's packed y: (-2 y, |y|^2) per row, and the largest |y|^2."""
    yq = torch.cat([-2.0 * y, _sq_norm(y)[:, None]], dim=1)
    return yq, yq[:, 3].max()


def _expansion(x, q):
    """d' [n, k] = fma(x0,q0, fma(x1,q1, fma(x2,q2, q3))) as the kernel has it."""
    t = _fma(x[:, None, 2], q[None, :, 2], q[None, :, 3])
    t = _fma(x[:, None, 1], q[None, :, 1], t)
    return _fma(x[:, None, 0], q[None, :, 0], t)


def _threshold(xx, ymax, b):
    return (b - xx) + tch.expansion_margin(xx, ymax, b)


def _filtered_scan(x, y, splits, warm, group=16):
    """The kernel's algorithm in plain torch: per split of the y range, a
    group min of d' against each row's threshold, the exact direct
    difference for each candidate within it, then the splits merged as the
    kernel's (d2 bits, j) atomicMin does.  With ``warm``, each threshold
    starts from the exact distance to a few y points (any points give a
    bound on the final best; the kernel takes those of the row's cell)."""
    yq, ymax = _pack(y)
    xx = _sq_norm(x)
    n, m = x.shape[0], y.shape[0]
    start = torch.full((n,), torch.inf)
    if warm:
        for k in range(8):
            j = (torch.arange(n) * 7 + k * 13) % m
            start = torch.minimum(start, _sq_norm(x - y[j]))
    span = -(-m // splits)
    best = torch.full((n,), torch.inf)
    best_j = torch.zeros(n, dtype=torch.int64)
    for lo in range(0, m, span):
        hi = min(m, lo + span)
        b = torch.full((n,), torch.inf)
        bj = torch.zeros(n, dtype=torch.int64)
        thr = _threshold(xx, ymax, start)
        for g0 in range(lo, hi, group):
            q = yq[g0:min(hi, g0 + group)]
            dp = _expansion(x, q)
            walk = dp.min(dim=1).values <= thr
            if not bool(walk.any()):
                continue
            for k in range(q.shape[0]):
                cand = walk & (dp[:, k] <= thr)
                d2 = _sq_norm(x - (-0.5 * q[k, :3]))
                upd = cand & (d2 < b)
                b = torch.where(upd, d2, b)
                bj = torch.where(upd, g0 + k, bj)
                thr = torch.where(upd, torch.minimum(thr, _threshold(xx, ymax, b)),
                                  thr)
        better = b < best  # earlier splits hold lower j: they keep ties
        best = torch.where(better, b, best)
        best_j = torch.where(better, bj, best_j)
    return best, best_j.to(torch.int32)


@pytest.mark.parametrize("name", sorted(HARD))
def test_expansion_margin_bounds_the_filter_error(name):
    """For every pair, |d' - (d2 - |x|^2)| (d2 the f32 direct difference)
    is at most half of expansion_margin taken at best = d2."""
    x, y = (torch.from_numpy(a) for a in HARD[name])
    yq, ymax = _pack(y)
    assert torch.equal(-0.5 * yq[:, :3], y)  # the kernel recovers y exactly
    xx = _sq_norm(x)
    worst = 0.0
    for r0 in range(0, x.shape[0], 256):
        xb = x[r0:r0 + 256]
        dp = _expansion(xb, yq)
        d2 = _sq_norm(xb[:, None, :] - y[None, :, :])
        err = (dp.double() - (d2.double() - xx[r0:r0 + 256, None].double())).abs()
        margin = tch.expansion_margin(xx[r0:r0 + 256, None], ymax, d2).double()
        worst = max(worst, float((err / margin).max()))
    assert worst <= 0.5, f"{name}: error reaches {worst:.3f} of the margin"


@functools.lru_cache(maxsize=None)
def _plain(name):
    """``min_dist_plain`` of a hard set, shared by its four scans."""
    return tch.min_dist_plain(*(torch.from_numpy(a) for a in HARD[name]))


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("name", sorted(HARD))
def test_filtered_scan_is_plain_bit_for_bit(name, splits, warm):
    x, y = (torch.from_numpy(a) for a in HARD[name])
    d2, idx = _filtered_scan(x, y, splits, warm)
    p2, pidx = _plain(name)
    torch.testing.assert_close(d2, p2, rtol=0, atol=0)
    torch.testing.assert_close(idx, pidx, rtol=0, atol=0)
    if name == "mirror_ties":  # every lookup is a tie: the first copy wins
        assert bool((pidx < 1200).all())


@pytest.mark.parametrize("n, m", [(100_000, 100_000), (60_000, 100_000),
                                  (2_000, 50_000), (1, 1), (900, 1500),
                                  (400_000, 400_000), (2_000_000, 1_000),
                                  (0, 1_000)])
def test_split_plan_covers_y_in_one_wave(n, m):
    rows, panel, sms, resident = 512, 1024, 132, 8
    splits, per_split = tch.split_plan(n, m, sms, resident, rows, panel)
    panels = -(-m // panel)
    assert 1 <= splits <= tch.MAX_SPLITS
    # every panel in exactly one split, and no split empty
    assert (splits - 1) * per_split < panels <= splits * per_split
    x_blocks = max(1, -(-n // rows))
    assert splits == 1 or x_blocks * splits <= sms * resident
    if splits > 1:
        assert per_split >= tch.MIN_SPLIT_PANELS
    if (n, m) == (100_000, 100_000):  # 196 x blocks: four splits, 6 per SM
        assert splits == 4
    if (n, m) == (2_000, 50_000):
        assert splits > 1


def _pair(n, m, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)).astype(np.float32),
            rng.normal(size=(m, 3)).astype(np.float32))


def test_plain_matches_xla_twins_on_ragged_sizes():
    x, y = _pair(3001, 5003, 0)
    d2, idx = tch.min_dist_plain(torch.from_numpy(x), torch.from_numpy(y),
                                 block=1000)
    d2, idx = d2.numpy(), idx.numpy()
    assert d2.shape == (3001,) and idx.dtype == np.int32

    # exact: the distance to the returned neighbour, and the brute-force min
    diff = x - y[idx]
    np.testing.assert_array_equal(
        d2, (diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1])
        + diff[:, 2] * diff[:, 2])
    full = ((x[:, None, :].astype(np.float64) - y[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(idx, full.argmin(1))

    scan = np.asarray(_min_dist_scan(
        jnp.asarray(x), jnp.asarray(_pad_pts(y, PT_CHUNK))))
    np.testing.assert_allclose(np.sqrt(d2), scan, rtol=1e-6)

    by = 1024
    yp = np.concatenate([y, np.full((5 * by - len(y), 3), 1e8, np.float32)])
    xla = np.asarray(min_dist_xla(jnp.asarray(x), jnp.asarray(yp), by=by))
    np.testing.assert_allclose(d2, xla, atol=1e-5)


def test_self_distance_exactly_zero_and_ties_take_first_index():
    x, _ = _pair(2000, 1, 1)
    d2, idx = tch.min_dist_plain(torch.from_numpy(x), torch.from_numpy(x),
                                 block=512)
    assert float(d2.max()) == 0.0
    np.testing.assert_array_equal(idx.numpy(), np.arange(2000))

    # duplicated y rows: every tie resolves to the first copy, as argmin does
    y = np.concatenate([x[:700], x[:700], x[700:]])
    d2, idx = tch.min_nn_distance(torch.from_numpy(x), torch.from_numpy(y))
    assert float(d2.max()) == 0.0
    want = np.concatenate([np.arange(700), np.arange(1400, 2700)])
    np.testing.assert_array_equal(idx.numpy(), want)


def test_chamfer_distance_matches_jax():
    x, y = _pair(1500, 2500, 2)
    got = chamfer_distance(torch.from_numpy(x), torch.from_numpy(y))
    want = jax_chamfer(x, y)
    assert abs(got - want) <= 1e-6 * want


def test_cuda_tensors_never_take_the_plain_path():
    """Anything not on the CPU goes to the kernel's checks; nothing falls
    back quietly.  (Meta tensors stand in for a device here.)"""
    meta = torch.empty((8, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tch.min_nn_distance(meta, meta)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tch.min_dist_cuda(torch.zeros(8, 3), torch.zeros(8, 3))
    before = LAUNCHES["min_dist"]
    tch.min_nn_distance(torch.zeros(8, 3), torch.ones(4, 3))
    assert LAUNCHES["min_dist"] == before

