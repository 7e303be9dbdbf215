"""Inputs hard for the hash-grid encode's index arithmetic, shared by the
CPU tests, the GPU tests and ``chip_smoke.py``.  Imports neither jax nor the
JAX package.

- ``far_points``: points far outside the unit cube, where a dense level's
  base index gx + gy r + gz r^2 leaves int32 (the kernels' 32-bit
  remainder must give way to the 64-bit one);
- ``wrap_points`` on a ``WRAP_SPEC`` grid: bases within 63 of the int64
  limit, so that the index of a corner above corner 0 wraps past it, where
  the plain version's int64 arithmetic wraps too.
"""

import numpy as np

# one level with s = 5, r = 6 and E = 216 entries: 216 does not divide 2^64,
# so an index that wraps past the int64 limit lands on another row
WRAP_SPEC = dict(levels=1, n_min=6, n_max=32, log2_table=12)


def far_points(rng, n, reach=2e5):
    """n points in [-reach, reach]^3: sphere-small's finer levels take dense
    bases beyond +-2^31 there."""
    return rng.uniform(-reach, reach, (n, 3)).astype(np.float32)


def wrap_points(n=64):
    """n points on ``WRAP_SPEC``'s level with corner 0 at (32767 - j,
    18325192704, 256204763530526720), j < n: a dense base of 2^63 - 1 - j,
    so each corner whose index lies more than j above corner 0's (by
    b_x + b_y r + b_z r^2) wraps.  The y and z fractions are 0, so only
    corners 0 and 1 weigh in the features."""
    gx = 32767 - np.arange(n)
    return np.stack([(gx / 5.0).astype(np.float32),
                     np.full(n, 18325192704.0, np.float32),
                     np.full(n, 51240952706105344.0, np.float32)], 1)
