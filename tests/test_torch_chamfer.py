"""The port's nearest-neighbour search against the JAX package's XLA twins.

The Pallas kernel ``min_dist_pallas`` cannot run on the CPU, so the port's
plain version is held against ``min_dist_xla`` (matmul expansion for the
argmin, then an exact direct-difference distance) and ``_min_dist_scan``
(direct difference).  Tolerances: the scan sums the same three squares, so
the distances agree to rounding (rtol 1e-6); the XLA expansion may pick a
different neighbour within its cancellation noise (~1e-3 absolute in d2 at
these coordinate scales), so its squared distances agree to 1e-5 absolute.

The CUDA kernel itself is checked on the card by tests/test_torch_gpu.py
and by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tropical.ops.chamfer_tpu import min_dist_xla
from tropical.utils.chamfer import PT_CHUNK, _min_dist_scan, _pad_pts
from tropical.utils.chamfer import chamfer_distance as jax_chamfer
from tropical_torch.ops import chamfer as tch
from tropical_torch.utils.chamfer import chamfer_distance


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
    before = tch.LAUNCHES["min_dist"]
    tch.min_nn_distance(torch.zeros(8, 3), torch.ones(4, 3))
    assert tch.LAUNCHES["min_dist"] == before

