"""Parity of the port's curved extraction path (``force=False``) with the
JAX package, on the CPU.

Tolerances, each measured here, and their cause:

- ``quartic_coeffs`` and ``_quad_y`` equal the JAX functions run op by op
  (eager) bit for bit.  Under ``jax.jit``, as the JAX host engine runs
  them, XLA contracts products and sums to FMAs: coefficients then differ
  by up to 2.2e-6 x max|p| max|q| (held to 1e-5).
- ``poly_roots_01`` equals the jitted JAX function bit for bit once the
  port's Horner step is computed as an FMA (``_fma_poly_eval``): the
  algorithm is the same, and the difference is XLA contracting each Horner
  step.  With the port's own unfused steps, the sentinel pattern is equal
  and the roots agree to the polynomial's conditioning: 1.2e-7 on random
  rows (held to 1e-6), 1.9e-5 for two roots in one cell, 4.7e-3 for a
  quadruple root.
- ``intersection_of_two_planes``: the -1 sentinel pattern equal to the
  jitted JAX function on every row; x within 1.8e-5 on random cubes (held
  to 5e-5).  Hard cubes (double roots, a coefficient straddling the 1e-9
  zeroing threshold: x moved by up to 0.5) are held to the sentinel pattern
  only, and y, a ratio with a small denominator, is held through
  ``_quad_y`` alone.
- ``strict_check`` and the diagnostics: exact.
- ``gradient_descent_failover`` on the rows the JAX engine rescued on the
  30000x-table fixture (none converges; each runs all 500 steps): within
  1e-5 of JAX's coordinates (measured 4.2e-6) and 2e-6 of its residuals
  (measured 7.7e-7), since gradients through the MLP sum in another order.
- End to end, the port's host engine against the JAX host engine (both
  ``engine="host"``; ``test_torch_device_curved.py`` holds the port's
  device engine to the host engine and to JAX's device engine): sphere-small
  curved keeps the JAX vertices in the same order within 5e-6 (measured
  1.34e-6) with exact post-filter counts.  On the synthetic kinked nets of
  ``tests/test_device_curved.py`` the MLP's matrix products round in
  another order, and on their scaled tables ulp-level differences flip
  eps decisions.  ``KINKED`` states each fixture's bounds beside what was
  measured (``scripts/curved_eps_flips.py``): the port against JAX, the
  JAX package's own device engine against its host engine, and the JAX
  host engine against itself with every weight moved by one ulp.  The port
  lies no farther from the host engine than the device engine does (in the
  count and in the larger far share), and
  ``test_ulp_weight_change_flips_jax_vertices`` keeps the one-ulp witness.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import trilinear_cases as cases
from test_device_curved import _kinked_net
from tropical.core import roots as jroots
from tropical.core import trilinear as jtri
from tropical.extract import failover as jfo
from tropical_torch.core import roots as troots
from tropical_torch.core import trilinear as ttri
from tropical_torch.core.net import NetSpec, TorchNet
from tropical_torch.extract import failover as tfo

ROOT = os.path.join(os.path.dirname(__file__), "..")
T = torch.from_numpy
EPS = 1e-4

# the kinked nets of tests/test_device_curved.py and, for each, the bounds
# on the port's vertex count (``count``) and on the share of vertices
# farther than 1e-5 from the other set (``far``: JAX's vertices from the
# port's, the port's from JAX's).  Measured on
# the CPU, (JAX vertices, port vertices), the count gap and each way's far
# share; then the JAX device engine against the host engine, and the host
# engine with weights moved by one ulp (two seeds):
#   kinked, table x3000:  1617/1625, 0.49 %, 0.80 %/1.29 %; device 0.62 %,
#     0.87 %/1.48 %; one ulp 0.12-0.49 %, 0.99-1.92 %/1.11-2.40 %.
#   GD, table x30000:  327/303, 7.3 %, 16.2 %/9.6 %; device 13.5 %,
#     19.6 %/7.1 %; one ulp 2.8-7.0 %, 11.9-14.4 %/7.9-14.3 %.
# ``ulp_far`` is the least far share (the larger way) that the one-ulp
# witness must show.
KINKED = {
    "kinked": dict(kw={}, count=0.005, far=(0.01, 0.015), ulp_far=0.015),
    "gd": dict(kw=dict(r_max=6, levels=3, scale=30000.0), count=0.10,
               far=(0.20, 0.15), ulp_far=0.05),
}


def _fma_poly_eval(coeffs, t):
    """Horner with each step one FMA: the product is exact in float64 and
    the sum rounds once to float32 (double rounding never bit here)."""
    acc = torch.zeros_like(t) + coeffs[:, :1]
    for i in range(1, coeffs.shape[-1]):
        acc = (acc.double() * t.double()
               + coeffs[:, i:i + 1].double()).float()
    return acc


def _ulp_perturbed(jnet, seed: int):
    """A copy of the JAX net with every float32 weight moved one ulp up or
    down, the direction drawn from ``seed``."""
    from tropical.core import TropicalNet

    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a)
        if a.dtype != np.float32:
            return jnp.asarray(a)
        toward = np.where(rng.random(a.shape) < 0.5, np.float32(np.inf),
                          np.float32(-np.inf))
        return jnp.asarray(np.nextafter(a, toward))

    return TropicalNet(jnet.spec,
                       params=jax.tree_util.tree_map(move, jnet.params))


def _far_shares(A, B):
    """Share of A's rows farther than 1e-5 from every row of B, and of B's
    from A."""
    return (float((cKDTree(B).query(A)[0] > 1e-5).mean()),
            float((cKDTree(A).query(B)[0] > 1e-5).mean()))


def _torch_twin(jnet) -> TorchNet:
    s = jnet.spec
    net = TorchNet(NetSpec(num_layers=s.num_layers, num_hidden=s.num_hidden,
                           levels=s.levels, r_min=s.r_min, r_max=s.r_max,
                           T=s.T, eps=s.eps), device="cpu")
    return net.params_from_numpy(jax.tree_util.tree_map(np.array,
                                                        jnet.params))


# --- the root solve ---------------------------------------------------------

def test_corner_points_and_interpolation_match_jax():
    rng = np.random.default_rng(2)
    e = rng.normal(size=(64, 2, 3)).astype(np.float32)
    np.testing.assert_array_equal(ttri.corner_points(T(e)).numpy(),
                                  np.asarray(jtri.corner_points(e)))
    p = rng.normal(size=(64, 8)).astype(np.float32)
    w = rng.uniform(size=(64, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        ttri.trilinear_interpolation(T(p), T(w)).numpy(),
        np.asarray(jtri.trilinear_interpolation(p, w)))


def test_quartic_coeffs_and_quad_y_match_jax():
    p, q, _ = cases.hard_pq(n_random=512)
    c = ttri.quartic_coeffs(T(p), T(q)).numpy()
    np.testing.assert_array_equal(c, np.asarray(jtri.quartic_coeffs(p, q)))
    cj = np.asarray(jax.jit(jtri.quartic_coeffs)(p, q))
    scale = np.abs(p).max(1) * np.abs(q).max(1)
    assert np.all(np.abs(cj - c) <= 1e-5 * scale[:, None])

    x = np.random.default_rng(1).uniform(-0.1, 1.1, len(p)).astype(np.float32)
    np.testing.assert_array_equal(
        ttri._quad_y(T(q), T(x)).numpy(),
        np.asarray(jtri._quad_y(jnp.asarray(q), jnp.asarray(x))))


@pytest.mark.parametrize("label", ["pair_in_cell", "tangent", "ends",
                                   "zero_const", "tiny", "random"])
def test_poly_roots_match_jax(label, monkeypatch):
    c, labels = cases.hard_quartics()
    c = c[labels == label]
    want = np.asarray(jax.jit(jroots.poly_roots_01)(c))
    got = troots.poly_roots_01(T(c)).numpy()
    np.testing.assert_array_equal(got < 0, want < 0)
    tol = {"pair_in_cell": 5e-5, "tangent": 1e-2}.get(label, 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    if label == "pair_in_cell":  # the probe finds the later of each pair
        assert np.all(got > 0)

    monkeypatch.setattr(troots, "_poly_eval", _fma_poly_eval)
    np.testing.assert_array_equal(troots.poly_roots_01(T(c)).numpy(), want)


def test_intersection_matches_jax():
    p, q, labels = cases.hard_pq(n_random=2048)
    got = ttri.intersection_of_two_planes(T(p), T(q)).numpy()
    want = np.asarray(jax.jit(jtri.intersection_of_two_planes)(p, q))
    np.testing.assert_array_equal(got == -1, want == -1)
    rnd = labels == "random"
    np.testing.assert_allclose(got[rnd, 0], want[rnd, 0], rtol=0, atol=5e-5)
    np.testing.assert_array_equal(got[:, 0], got[:, 2])
    for label in ("constant_x", "constant_y", "constant_z", "zero_cube"):
        assert np.all(got[labels == label] == -1), label
    # a zero y denominator sets y alone to -1
    yz = got[labels == "y_denominator_zero"]
    assert np.all(yz[:, 1] == -1) and np.all(yz[:, 0] != -1)


def _f(v):
    return np.float32(v)


LANES = 4  # csrc/trilinear_roots.cu's threads a row


def _kernel_row(P, Q):
    """One row of csrc/trilinear_roots.cu in float32 scalar arithmetic, in
    the kernel's own order, its lanes replayed one after another: each
    lane's share of the scan, the OR of their bracket masks, phase A (lane
    0 bisects p in its last bracket, lanes 1-3 the padded p' in the three
    highest derivative brackets), phase B (lanes 1-3 probe their extremum)
    and the max over the lanes in the order of the shuffle tree.  Returns
    (out [3], branches taken)."""
    taken = set()

    def horner(c, t):
        acc = _f(0) + c[0]
        for ci in c[1:]:
            acc = acc * t + ci
        return acc

    def nan_max(a, b):
        return a if (a != a or a > b) else b

    def sample(i):
        return _f(i) * _f(1 / 64)

    def bracket(lv, rv):
        return lv * rv <= 0 and not (lv == 0 and rv == 0)

    def bisect(c, lo, hi, flo):
        for _ in range(40):
            mid = _f(0.5) * (lo + hi)
            fmid = horner(c, mid)
            if flo * fmid <= 0:
                hi = mid
            else:
                lo, flo = mid, fmid
        return _f(0.5) * (lo + hi)

    deg = any(all(P[t] == P[u] and Q[t] == Q[u] for t, u in zip(*pair))
              for pair in cases.AXIS_PAIRS.values())
    qr = [Q[0], Q[1] + Q[4], Q[5]]
    ps = [P[2], P[3] + P[6], P[7]]
    qs = [Q[2], Q[3] + Q[6], Q[7]]
    pr = [P[0], P[1] + P[4], P[5]]
    Tm = [[_f(v) for v in row] for row in ttri._T]
    A = [[qr[i] * ps[j] - qs[i] * pr[j] for j in range(3)] for i in range(3)]
    M = [[(Tm[0][a] * A[0][j] + Tm[1][a] * A[1][j]) + Tm[2][a] * A[2][j]
          for j in range(3)] for a in range(3)]
    B = [[(M[a][0] * Tm[0][b] + M[a][1] * Tm[1][b]) + M[a][2] * Tm[2][b]
          for b in range(3)] for a in range(3)]
    c = [B[0][0], B[1][0] + B[0][1], (B[2][0] + B[1][1]) + B[0][2],
         B[1][2] + B[2][1], B[2][2]]
    c = [_f(0) if abs(v) < _f(1e-9) else v for v in c]
    lead = ((abs(c[0]) + abs(c[1])) + abs(c[2])) + abs(c[3])
    tau = _f(1e-7) * (lead + abs(c[4]))
    dc = [c[0] * _f(4), c[1] * _f(3), c[2] * _f(2), c[3] * _f(1)]
    dpad = [_f(0)] + dc

    # the scan: each lane's cells, OR-ed into the row's masks
    per_lane = 64 // LANES
    bm = dm = 0
    for lane in range(LANES):
        first = lane * per_lane
        vl, dvl = horner(c, sample(first)), horner(dc, sample(first))
        for i in range(first, first + per_lane):
            vr, dvr = horner(c, sample(i + 1)), horner(dc, sample(i + 1))
            bm |= int(bracket(vl, vr)) << i
            dm |= int(bracket(dvl, dvr)) << i
            vl, dvl = vr, dvr
    if not lead > _f(1e-9):
        bm = dm = 0
    cells = [(bm != 0, bm.bit_length() - 1 if bm else 63)]
    for _ in range(3):
        d = dm.bit_length() - 1 if dm else 63
        cells.append((dm != 0, d))
        dm &= ~(1 << d)
    taken.add(f"derivative_brackets_{sum(f for f, _ in cells[1:])}")
    if dm:
        taken.add("fourth_derivative_bracket_left")

    # phases A and B, one task a lane
    cands = []
    for lane in range(LANES):
        found, cell = cells[lane]
        k = dpad if lane else c
        lo, hi = sample(cell), sample(cell + 1)
        a = bisect(k, lo, hi, horner(k, lo))
        cand = a if found else _f(-1)
        if lane:
            pm = horner(c, a)
            cross = pm * horner(c, hi) < 0
            pair = bisect(c, a, hi, pm)
            if not found:
                cand = _f(-1)
            elif cross:
                cand = pair
                taken.add("hidden_pair")
            elif abs(pm) <= tau:
                cand = a
                taken.add("tangent")
            else:
                cand = _f(-1)
        elif found:
            taken.add("bracket")
        if not found and lead > _f(1e-9):
            taken.add("lane_without_bracket")
        cands.append(nan_max(_f(-1), cand))
    off = 1
    while off < LANES:  # the shuffle tree
        cands = [nan_max(cands[i], cands[i ^ off]) for i in range(LANES)]
        off *= 2
    x = cands[0]
    u = _f(1) - x
    X0, X1, X3 = u * u, x * u, x * x
    AX = ((Q[0] * X0 + Q[1] * X1) + Q[4] * X1) + Q[5] * X3
    BX = ((Q[2] * X0 + Q[3] * X1) + Q[6] * X1) + Q[7] * X3
    with np.errstate(divide="ignore", invalid="ignore"):
        y = AX / (AX - BX)
    xo = _f(-1) if deg or not np.isfinite(x) else x
    yo = _f(-1) if deg or not np.isfinite(y) else y
    taken |= {"degenerate"} if deg else set()
    taken |= {"y_sentinel"} if not deg and yo == -1 else set()
    return np.array([xo, yo, xo], np.float32), taken


def test_kernel_order_matches_plain_bitwise():
    """The kernel's order (the scan split over lanes, the three highest
    derivative brackets taken from the merged mask, four bisections side by
    side, then the probes) gives the plain version's bits on every hard
    case, and the cases take every branch."""
    p, q, _ = cases.kernel_pq(n_random=64)
    plain = ttri.intersection_of_two_planes_plain(T(p), T(q)).numpy()
    taken = set()
    with np.errstate(over="ignore", invalid="ignore"):
        for r in range(len(p)):
            out, branches = _kernel_row(p[r], q[r])
            taken |= branches
            assert out.tobytes() == plain[r].tobytes(), (r, out, plain[r])
    assert taken >= {"bracket", "hidden_pair", "tangent",
                     "derivative_brackets_3", "lane_without_bracket",
                     "fourth_derivative_bracket_left", "degenerate",
                     "y_sentinel"}, taken


def _coeffs(p, q):
    c = ttri.quartic_coeffs(T(p), T(q))
    return torch.where(c.abs() < 1e-9, 0.0, c)


def test_padded_derivative_horner_is_bitwise():
    """The kernel bisects p' as the 5-term [0, 4c0, 3c1, 2c2, c3]: for t in
    [0, 1], 0 + 0 = +0 and +0 * t = +0, then +0 + d0 = 0 + d0, so it gives
    the 4-term Horner's bits (inf and NaN coefficients included)."""
    p, q, _ = cases.kernel_pq(n_random=64)
    dco = troots._deriv(_coeffs(p, q))
    padded = torch.cat([torch.zeros_like(dco[:, :1]), dco], dim=1)
    rng = np.random.default_rng(3)
    ts = torch.from_numpy(np.concatenate([
        np.arange(65) / 64, [np.float32(1) - np.float32(2 ** -24), 2 ** -149],
        rng.uniform(0, 1, 4096)]).astype(np.float32))
    with np.errstate(over="ignore", invalid="ignore"):
        four = troots._poly_eval(dco, ts)
        five = troots._poly_eval(padded, ts)
    assert torch.equal(four.view(torch.int32), five.view(torch.int32))
    assert not torch.isfinite(dco).all()  # the overflow rows are in


@pytest.mark.parametrize("label", cases.LANE_LABELS)
def test_lane_cases_have_their_brackets(label):
    """Each row of ``cases.lane_pq`` has, in float32, the brackets it is
    named for."""
    p, q, labels = cases.lane_pq()
    r = int(np.nonzero(labels == label)[0][0])
    c = _coeffs(p[r:r + 1], q[r:r + 1])
    ts = torch.arange(65, dtype=torch.float32) / 64
    nonconst = troots._abs_sum(c, 4) > 1e-9
    vals, dco = troots._poly_eval(c, ts), troots._deriv(c)
    dvals = troots._poly_eval(dco, ts)
    br = troots._brackets(vals, nonconst)[0].nonzero()[:, 0].tolist()
    dbr = troots._brackets(dvals, nonconst)[0].nonzero()[:, 0].tolist()
    if label == "first_and_last_lane":
        assert br == [6] and dbr == [54]
        return
    assert len(dbr) == int(label[-1]), dbr
    if label == "derivative_brackets_4":
        # an exact zero of p' at t = 1/2, and the row's root hidden in the
        # highest bracket
        assert br == [] and dbr == [12, 31, 32, 51] and dvals[0, 32] == 0
        x = ttri.intersection_of_two_planes_plain(T(p[r:r + 1]),
                                                  T(q[r:r + 1]))[0, 0]
        assert 51 / 64 < float(x) < 52 / 64
    if label == "derivative_brackets_3":
        # no root above the lowest extremum's cell, and a pair hidden in it
        d = dbr[0]
        assert br == [] and d == 19
        m = troots._bisect(dco, ts[d:d + 1], ts[d + 1:d + 2], dvals[:, d])
        pm = troots._poly_eval(c, m[:, None])[0, 0]
        assert float(pm * vals[0, d + 1]) < 0
        x = ttri.intersection_of_two_planes_plain(T(p[r:r + 1]),
                                                  T(q[r:r + 1]))[0, 0]
        assert 0.3 < float(x) < 0.31


def test_overflow_rows_are_sentinels():
    """|p|, |q| = 1e20 overflow the coefficients to +-inf alone, and to
    NaN: no bracket, x = -1, y computed at x = -1."""
    p, q, labels = cases.lane_pq()
    rows = np.isin(labels, ["overflow_inf", "overflow_nan"])
    with np.errstate(over="ignore", invalid="ignore"):
        c = _coeffs(p[rows], q[rows])
        out = ttri.intersection_of_two_planes_plain(T(p[rows]), T(q[rows]))
    assert torch.isinf(c[0]).all() and torch.isnan(c[1]).all()
    assert (out[:, 0] == -1).all() and (out[:, 2] == -1).all()
    assert torch.isfinite(out[:, 1]).all()


def test_wrapper_takes_the_kernel_for_non_cpu_tensors():
    """CPU tensors take the plain version; anything else goes to the
    kernel's checks (meta tensors stand in for a device here), and nothing
    is counted without a launch."""
    from tropical_torch.ops.launches import LAUNCHES

    before = LAUNCHES["trilinear_roots"]
    p = torch.zeros(4, 8)
    assert ttri.intersection_of_two_planes(p, p).shape == (4, 3)
    meta = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ttri.intersection_of_two_planes(meta, meta)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ttri.intersection_of_two_planes(p, meta)
    assert LAUNCHES["trilinear_roots"] == before


# --- the failover mechanisms ------------------------------------------------

def _strict_inputs(kind, seed=0):
    rng = np.random.default_rng(seed)
    n_edges, idx, R = 60, 5, 9
    m = rng.random(n_edges) < 0.7
    if kind == "empty":
        m[:] = False
    n = int(m.sum())
    has_curved = kind == "curved"
    c = (rng.random(n) < 0.5) if has_curved else np.zeros(n, bool)
    nc = int(c.sum())
    ints = rng.uniform(-0.2, 1.2, (nc, 3)).astype(np.float32)
    mags = np.float32([0, 2e-5, 8e-5, 1.2e-4, 3e-3])
    if has_curved:
        d_new = (rng.choice(mags, (nc, 2))
                 * rng.choice([-1, 1], (nc, 2))).astype(np.float32)
    else:
        d_new = np.zeros((1 if n else 0, 2), np.float32)
    outputs_new = rng.normal(size=(n, R)).astype(np.float32)
    chk_mags = mags if kind != "flat_clean" else mags[:3]
    outputs_new[:, idx] = rng.choice(chk_mags, n) * rng.choice([-1, 1], n)
    m_rgn = rng.integers(-1, 2, (n, 3 + idx)).astype(np.int32)
    m_rgn_ = rng.integers(-1, 2, (n, R - idx)).astype(np.int32)
    offset = rng.integers(0, 5, (n, 3)).astype(np.int32)
    v_new = rng.normal(size=(n, 3)).astype(np.float32)
    return (c, d_new, EPS, idx, ints, m, m_rgn, m_rgn_, offset, outputs_new,
            has_curved, v_new)


@pytest.mark.parametrize("kind", ["curved", "flat_over_eps", "flat_clean",
                                  "empty"])
def test_strict_check_matches_jax(kind):
    args = _strict_inputs(kind)
    jfo.reset_counters()
    tfo.reset_counters()
    want = jfo.strict_check(*[a.copy() if isinstance(a, np.ndarray) else a
                              for a in args])
    got = tfo.strict_check(*[T(a.copy()) if isinstance(a, np.ndarray) else a
                             for a in args])
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert tfo.COUNTERS["strict_drops"] == jfo.COUNTERS["strict_drops"]
    if kind == "curved":
        assert tfo.COUNTERS["strict_drops"] > 0
    if kind in ("flat_clean", "empty"):
        np.testing.assert_array_equal(got[0].numpy(), args[5])


@pytest.mark.parametrize("name", ["two_planes", "planary", "on_surface"])
def test_diagnostics_match_jax(name, capsys):
    rng = np.random.default_rng(4)
    if name == "two_planes":
        regions = rng.choice([-1, 0, 1], (80, 3 + 12), p=[0.2, 0.6, 0.2])
        offset = rng.integers(0, 3, (80, 3))
        edges_m = rng.integers(0, 80, (50, 2))
        c = rng.random(50) < 0.6
        args = (edges_m, regions, offset, 0, 7, c, 7)
        want = jfo.check_new_vertices_on_two_planes(*args)
        got = tfo.check_new_vertices_on_two_planes(
            *[T(a) if isinstance(a, np.ndarray) else a for a in args])
    elif name == "planary":
        vertices = rng.normal(size=(60, 3)).astype(np.float32)
        vertices[:30, 2] = 0.25           # the first 30 lie on one plane
        v_indices = np.full((40, 6), -1)
        for r in range(40):
            k = rng.integers(2, 7)
            pool = 30 if r % 2 else 60
            v_indices[r, :k] = rng.choice(pool, k, replace=False)
        want = jfo.check_planary_among_vertices(vertices, v_indices)
        got = tfo.check_planary_among_vertices(T(vertices), T(v_indices))
    else:
        ints = rng.uniform(0, 1, (40, 3)).astype(np.float32)
        d_new = rng.choice(np.float32([0, 5e-5, 3e-4]), (40, 2))
        gg = rng.random(40) < 0.3
        want = jfo.check_new_vertices_on_surface(ints, d_new, gg, EPS, 1, 2)
        got = tfo.check_new_vertices_on_surface(T(ints), T(d_new), T(gg),
                                                EPS, 1, 2)
    assert got == want and want > 0
    capsys.readouterr()


# --- end to end -------------------------------------------------------------

@pytest.fixture(scope="module")
def gd_fixture_run():
    """The JAX host engine on the fixture whose table is scaled 30000x, with
    the inputs and results of every gradient-descent rescue that moved a
    row."""
    from tropical.extract.subdivide import subpoly

    jnet = _kinked_net(**KINKED["gd"]["kw"])
    calls = []
    real = jfo.gradient_descent_failover

    def recording(net, e_c, ints, d_new, gg, plane_cols, idx, eps, **kw):
        out = real(net, e_c, ints, d_new, gg, plane_cols, idx, eps, **kw)
        if ((~gg) & (np.abs(d_new) > eps).any(-1)).any():
            calls.append(((e_c, ints, d_new, gg, plane_cols, idx, eps), out))
        return out

    jfo.gradient_descent_failover = recording
    try:
        _, V, _ = subpoly(jnet, 3, 1.2, force=False, verbose=False,
                          engine="host")
    finally:
        jfo.gradient_descent_failover = real
    return jnet, V, dict(jfo.COUNTERS), calls


def test_gd_failover_matches_jax(gd_fixture_run):
    jnet, _, _, calls = gd_fixture_run
    net = _torch_twin(jnet)
    assert calls
    for (e_c, ints, d_new, gg, cols, idx, eps), (want_x, want_d) in calls:
        before = dict(tfo.COUNTERS)
        got_x, got_d = tfo.gradient_descent_failover(
            net, *(T(np.array(a)) for a in (e_c, ints, d_new, gg, cols)),
            idx, eps)
        assert tfo.COUNTERS["gd_rows"] - before["gd_rows"] == int(
            ((~gg) & (np.abs(d_new) > eps).any(-1)).sum())
        np.testing.assert_allclose(got_x.numpy(), want_x, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got_d.numpy(), want_d, rtol=0, atol=2e-6)


def _counters_agree(port, jax_counters):
    """Sentinels and strict drops within max(20, 2 %), GD rows within 5."""
    for k in ("sentinels", "strict_drops"):
        assert abs(port[k] - jax_counters[k]) <= max(
            20, int(0.02 * jax_counters[k])), (k, port, jax_counters)
    assert abs(port["gd_rows"] - jax_counters["gd_rows"]) <= 5


def _on_surface(net, V):
    return float(net.sdf(T(np.ascontiguousarray(V))).abs().max()) < 2e-4


def test_sphere_small_curved_matches_jax_host_engine():
    from tropical.extract import stats as jstats
    from tropical.extract.subdivide import subpoly as jsubpoly
    from tropical.stanford.model import Net
    from tropical.utils import checkpoint as jckpt
    from tropical_torch.extract import stats as tstats
    from tropical_torch.extract.subdivide import subpoly

    g = json.load(open(os.path.join(ROOT, "tests/golden/self_golden.json")))
    path = os.path.join(ROOT, g["sphere"]["checkpoint"])
    jnet = Net(r_min=2, r_max=32, key=jax.random.PRNGKey(1))
    jckpt.load_into(jnet, jckpt.find_checkpoint(path))
    _, Vj, Tj = jsubpoly(jnet, 3, 1.2, force=False, verbose=False,
                         engine="host")
    js, jc = dict(jstats.LAST), dict(jfo.COUNTERS)
    net = _torch_twin(jnet)
    _, Vt, Tt = subpoly(net, 3, 1.2, force=False, verbose=False,
                        engine="host")

    # post-filter funnel exact, pre-filter within eps-boundary flips
    for k in ("post_v", "post_e", "n_faces"):
        assert tstats.LAST[k] == js[k], (tstats.LAST, js)
    for k in ("pre_v", "pre_e"):
        assert abs(tstats.LAST[k] - js[k]) <= 0.005 * js[k]
    assert tuple(Tt.shape) == Tj.shape
    np.testing.assert_allclose(Vt.numpy(), Vj, rtol=0, atol=5e-6)
    _counters_agree(tfo.COUNTERS, jc)
    assert tfo.COUNTERS["curved_steps"] > 0
    assert _on_surface(net, Vt.numpy())


@pytest.fixture(scope="module")
def kinked_run():
    """The JAX host engine on the kinked net whose table is scaled 3000x."""
    from tropical.extract.subdivide import subpoly

    jnet = _kinked_net(**KINKED["kinked"]["kw"])
    _, V, _ = subpoly(jnet, 3, 1.2, force=False, verbose=False,
                      engine="host")
    return jnet, V, dict(jfo.COUNTERS)


def _vertex_sets_agree(Vt, Vj, fixture):
    bounds = KINKED[fixture]
    assert abs(len(Vt) - len(Vj)) <= max(5, bounds["count"] * len(Vj)), (
        len(Vt), len(Vj))
    far = _far_shares(Vj, Vt)
    assert far[0] <= bounds["far"][0] and far[1] <= bounds["far"][1], far


def test_kinked_net_matches_jax_host_engine(kinked_run):
    """Thousands of sentinels and strict drops (the stage fires massively);
    counters within the contract of tests/test_device_curved.py for two
    engines, vertex sets within ``KINKED["kinked"]`` both ways."""
    from tropical_torch.extract.subdivide import subpoly

    jnet, Vj, jc = kinked_run
    net = _torch_twin(jnet)
    _, Vt, _ = subpoly(net, 3, 1.2, force=False, verbose=False,
                       engine="host")
    Vt = Vt.numpy()

    assert jc["sentinels"] > 1000 and tfo.COUNTERS["sentinels"] > 1000
    assert tfo.COUNTERS["strict_drops"] > 1000
    _counters_agree(tfo.COUNTERS, jc)
    _vertex_sets_agree(Vt, np.asarray(Vj), "kinked")
    assert _on_surface(net, Vt)


def test_gd_fixture_matches_jax_host_engine(gd_fixture_run):
    """The gradient-descent rescue fires in both packages; counters within
    the contract of tests/test_device_curved.py for this fixture, vertex
    sets within ``KINKED["gd"]`` both ways: on a table scaled 30000x, eps
    decisions flip at the ulp level (see the witness below)."""
    from tropical_torch.extract.subdivide import subpoly

    jnet, Vj, jc, _ = gd_fixture_run
    net = _torch_twin(jnet)
    _, Vt, _ = subpoly(net, 3, 1.2, force=False, verbose=False,
                       engine="host")
    Vt = Vt.numpy()
    assert jc["gd_rows"] > 0 and tfo.COUNTERS["gd_rows"] > 0
    _counters_agree(tfo.COUNTERS, jc)
    _vertex_sets_agree(Vt, np.asarray(Vj), "gd")
    assert _on_surface(net, Vt)


@pytest.mark.parametrize("fixture", ["kinked", "gd"])
def test_ulp_weight_change_flips_jax_vertices(fixture, request):
    """The witness for the bounds above: the JAX host engine against itself
    with every weight moved by one ulp moves at least ``ulp_far`` of its
    vertices beyond 1e-5, so differences of rounding alone, such as the
    port's summation order, move vertex sets this far."""
    from tropical.extract.subdivide import subpoly

    run = request.getfixturevalue(
        "kinked_run" if fixture == "kinked" else "gd_fixture_run")
    jnet, Vj = run[0], np.asarray(run[1])
    _, Vp, _ = subpoly(_ulp_perturbed(jnet, seed=0), 3, 1.2, force=False,
                       verbose=False, engine="host")
    far = _far_shares(Vj, np.asarray(Vp))
    assert max(far) >= KINKED[fixture]["ulp_far"], far
