"""Inputs that drive every branch of the curved path's root solve.

Shared by the CPU parity tests (``test_torch_curved.py``), the GPU tests
(``test_torch_gpu.py``) and ``chip_smoke.py``; numpy only, no JAX.

- ``hard_quartics``: coefficient rows [K, 5] (descending powers) with two
  roots in one 1/64 sample cell, tangent (double) roots, roots at 0 and at
  1, coefficients below the 1e-9 zeroing threshold, and all-zero and
  constant rows;
- ``hard_pq``: corner values (p, q) [K, 8] whose quartics are those rows
  (float32 rounding moves them slightly: a double root may split into a
  close pair or lift off), plus cubes constant along x, y or z, cubes whose
  q is constant along y alone (a zero y denominator), all-zero cubes, and
  seeded random cubes;
- ``lane_pq``: rows aimed at the kernel's split of a row over lanes:
  exactly 0, 1, 2, 3 and 4 derivative brackets (a hidden pair in the
  third, and in the highest of four), brackets at both ends of the cell
  range, and coefficients that overflow;
- ``kernel_pq``: both, the rows the kernel is held to bit for bit.
"""

from __future__ import annotations

import numpy as np

# corner ids equal on a cube constant along y, z and x (idx = 4i + 2j + k)
AXIS_PAIRS = {"y": ((0, 1, 4, 5), (2, 3, 6, 7)),
              "z": ((0, 1, 2, 3), (4, 5, 6, 7)),
              "x": ((0, 4, 2, 6), (1, 5, 3, 7))}


def _poly(roots, extra=(1.0, 0.0, 1.0), scale=1.0):
    """Descending coefficients of scale * prod(t - r) * (extra quadratic or
    linear factor), as float64."""
    c = np.poly(roots) if len(roots) else np.ones(1)
    return scale * np.polymul(c, extra)


def hard_quartics(seed: int = 0):
    """(coeffs [K, 5] float32, labels [K])."""
    rng = np.random.default_rng(seed)
    rows, labels = [], []

    def add(c, label):
        c = np.asarray(c, np.float64)
        rows.append(np.concatenate([np.zeros(5 - c.size), c]))
        labels.append(label)

    for k in (0, 5, 31, 32, 50, 63):
        for lo, hi in ((0.2, 0.7), (0.45, 0.55), (0.01, 0.99)):
            a, b = (k + lo) / 64, (k + hi) / 64
            add(_poly([a, b], scale=rng.uniform(0.5, 3.0)), "pair_in_cell")
            add(_poly([a, b], extra=(1.0, 2.0)), "pair_in_cell")
    for a in (0.1, 17 / 64, 0.3, 0.5, 0.77, 1 - 1 / 128):
        add(_poly([a, a]), "tangent")
        add(_poly([a, a], extra=(1.0, -1.0, -6.0)), "tangent")   # (t+2)(t-3)
        add(-_poly([a, a], extra=(1.0, 0.0, 0.5)), "tangent")
        add(_poly([a, a, a, a], extra=(1.0,)), "tangent")         # quadruple
    add(_poly([0.0, 1.0]), "ends")
    add(_poly([0.0], extra=(1.0, 6.0, 11.0, 6.0)), "ends")       # 0, -1, -2, -3
    add(_poly([1.0], extra=(1.0, 6.0, 11.0, 6.0)), "ends")
    add(_poly([1.0, 1.0]), "ends")
    add(_poly([0.0, 0.0]), "ends")
    add([1.0, 0.0], "ends")                                      # t
    add([1.0, -1.0], "ends")                                     # t - 1
    add(np.zeros(5), "zero_const")
    add([3.0], "zero_const")
    add([-2.5], "zero_const")
    add([5e-10, 4e-10, -3e-10, 2e-10, 7.0], "zero_const")        # all zeroed
    add([5e-10, 1.0, -1.2, 0.3, 0.0], "tiny")                    # leading zeroed
    add([2.0, -3.0, 1.0, 4e-10, -6e-10], "tiny")
    add([0.0, 0.0, 8e-10, 1.0, -0.5], "tiny")
    for _ in range(24):
        add(rng.normal(size=5), "random")
    return np.asarray(rows, np.float32), np.asarray(labels)


def _quartic_map(q: np.ndarray) -> np.ndarray:
    """The linear map p -> quartic coefficients for fixed q [8], [5, 8]
    (float64, the same algebra as ``quartic_coeffs``)."""
    R, S = (0, 1, 4, 5), (2, 3, 6, 7)
    T = np.array([[1.0, -2.0, 1.0], [-1.0, 1.0, 0.0], [1.0, 0.0, 0.0]])

    def dq(v, f):
        return np.array([v[f[0]], v[f[1]] + v[f[2]], v[f[3]]])

    cols = []
    for k in range(8):
        p = np.zeros(8)
        p[k] = 1.0
        A = np.outer(dq(q, R), dq(p, S)) - np.outer(dq(q, S), dq(p, R))
        B = T.T @ A @ T
        cols.append([B[0, 0], B[1, 0] + B[0, 1], B[2, 0] + B[1, 1] + B[0, 2],
                     B[1, 2] + B[2, 1], B[2, 2]])
    return np.asarray(cols).T


def hard_pq(seed: int = 0, n_random: int = 256):
    """(p [K, 8] float32, q [K, 8] float32, labels [K])."""
    rng = np.random.default_rng(seed)
    coeffs, clabels = hard_quartics(seed)
    ps, qs, labels = [], [], []
    for c, label in zip(coeffs.astype(np.float64), clabels):
        q = rng.normal(size=8)
        p = np.linalg.lstsq(_quartic_map(q), c, rcond=None)[0]
        ps.append(p)
        qs.append(q)
        labels.append(label)
    for axis, (t, u) in AXIS_PAIRS.items():
        for _ in range(4):
            p, q = rng.normal(size=8), rng.normal(size=8)
            p[list(u)], q[list(u)] = p[list(t)], q[list(t)]
            ps.append(p)
            qs.append(q)
            labels.append(f"constant_{axis}")
    for _ in range(4):           # q alone constant along y: AX == BX
        p, q = rng.normal(size=8), rng.normal(size=8)
        t, u = AXIS_PAIRS["y"]
        q[list(u)] = q[list(t)]
        ps.append(p)
        qs.append(q)
        labels.append("y_denominator_zero")
    ps.append(np.zeros(8))
    qs.append(np.zeros(8))
    labels.append("zero_cube")
    ps += list(rng.normal(size=(n_random, 8)))
    qs += list(rng.normal(size=(n_random, 8)))
    labels += ["random"] * n_random
    return (np.asarray(ps, np.float32), np.asarray(qs, np.float32),
            np.asarray(labels))


# quartics (descending, float64) with exactly k derivative brackets on the
# 1/64 grid, checked on their float32 rows by test_torch_curved.py
LANE_QUARTICS = {
    "derivative_brackets_0": np.polymul([1.0, -0.3], [1.0, 0.0, 1.0]),
    "derivative_brackets_1": np.polymul(np.poly([0.3, 0.8]), [1.0, 0.0, 4.0]),
    "derivative_brackets_2": np.polymul(np.poly([0.2, 0.5, 0.9]), [1.0, 3.0]),
    # roots 0.3 and 0.305 in cell 19 under the lowest of three extrema, and
    # no root above them: the row's root is the later of that hidden pair
    "derivative_brackets_3": np.polymul(np.poly([0.3, 0.305]),
                                        [1.0, -1.5, 0.5645]),
    # -(t - 0.1)(t - 1.6): p's bracket in cell 6, p''s in cell 54
    "first_and_last_lane": np.array([-1.0, 1.7, -0.16]),
}
# integer corners whose float32 quartic is exact: 245760 t^4 - 493056 t^3
# + 326016 t^2 - 79104 t + 6416, with p' = 0 exactly at t = 1/2 (so cells
# 31 and 32 both bracket) and extrema in cells 12 and 51: four derivative
# brackets, and the row's root is the later of a pair hidden in cell 51,
# the highest, which only the three highest brackets reach
FOUR_BRACKETS = ([0.0, 52672.0, 6416.0, -53440.0,
                  0.0, -6032.0, 0.0, 127200.0],
                 [1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0])
LANE_LABELS = tuple(LANE_QUARTICS) + ("derivative_brackets_4",)


def lane_pq(seed: int = 5):
    """(p [K, 8], q [K, 8], labels [K]) float32: the rows of
    ``LANE_QUARTICS`` (seeded as ``hard_pq`` seeds its rows), the row of
    ``FOUR_BRACKETS``, and two rows with |p|, |q| = 1e20 whose
    coefficients overflow, one to +-inf alone and one to NaN."""
    rng = np.random.default_rng(seed)
    ps, qs, labels = [], [], []
    for label, c in LANE_QUARTICS.items():
        c = np.concatenate([np.zeros(5 - len(c)), c])
        q = rng.normal(size=8)
        ps.append(np.linalg.lstsq(_quartic_map(q), c, rcond=None)[0])
        qs.append(q)
        labels.append(label)
    ps.append(np.asarray(FOUR_BRACKETS[0]))
    qs.append(np.asarray(FOUR_BRACKETS[1]))
    labels.append("derivative_brackets_4")
    # q only at corner 0 and p's x = z diagonal of the y = 1 face only at
    # corner 2: A has one entry, 1e40 = inf, and T^T A T no inf - inf
    p, q = 1e20 * rng.normal(size=8), np.zeros(8)
    p[[3, 6, 7]] = 0.0
    q[0] = 1e20
    ps += [p, 1e20 * rng.normal(size=8)]
    qs += [q, 1e20 * rng.normal(size=8)]
    labels += ["overflow_inf", "overflow_nan"]
    return (np.asarray(ps, np.float32), np.asarray(qs, np.float32),
            np.asarray(labels))


def kernel_pq(seed: int = 0, n_random: int = 256):
    """``hard_pq`` and ``lane_pq`` together: every row the root-solve
    kernel is held to bit for bit."""
    parts = [hard_pq(seed, n_random), lane_pq()]
    return tuple(np.concatenate(a) for a in zip(*parts))
