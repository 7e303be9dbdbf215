"""The hash-grid encode's backward where only x is asked for, and the
backwards' privatisation plan, on the CPU.

- ``TorchNet.normal`` and the curved path's gradient-descent rescue take
  gradients in x alone.  They encode with the table detached, so the
  encode's backward runs with ``need_table`` False (no table gradient is
  scattered), and their results are bitwise what the route with the table
  in autograd gives.
- ``hashgrid.private_levels``: the levels whose table-gradient rows the CUDA
  backwards sum in shared memory, for each preset and for a hashed level,
  within the shared-memory budget.
"""

import numpy as np
import pytest
import torch

from tropical_torch.core import hashgrid as thg
from tropical_torch.extract import failover as tfo
from tropical_torch.stanford.model import SIZE_PRESETS, net_for_size


@pytest.fixture
def backward_calls(monkeypatch):
    """The ``need_table`` of every call of the encode's plain backward."""
    calls = []
    plain = thg.encode_backward_plain

    def spy(spec, table, x, dfeat, need_x=True, need_table=True):
        calls.append(need_table)
        return plain(spec, table, x, dfeat, need_x, need_table)

    monkeypatch.setattr(thg, "encode_backward_plain", spy)
    return calls


def _net():
    net = net_for_size("small", "sphere", 1, device="cpu")
    with torch.no_grad():
        net.enc.table.mul_(3000.0)  # features well above the init's 1e-4
    return net


def _points(n, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32))


def _bits_equal(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _table_route_normal(net, x, idx):
    """The normal as computed before: autograd with the table a parameter
    of the graph."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        f = (net._sdf(xx) if idx is None
             else net(xx, gather=True)[1][:, idx:idx + 1])
        (g,) = torch.autograd.grad(f.sum(), xx)
    return g


@pytest.mark.parametrize("column", ["sdf", "neuron_1_3"])
def test_normal_backward_scatters_no_table_gradient(backward_calls, column):
    net = _net()
    x = _points(257, 1)
    l_h = {} if column == "sdf" else {"l": 1, "h": 3}
    got = net.normal(x, **l_h)
    assert backward_calls == [False]
    want = _table_route_normal(net, x, None if column == "sdf" else 19)
    assert backward_calls == [False, True]
    assert _bits_equal(got, want)
    assert net.enc.table.grad is None


def _rescue_inputs(net, n, seed):
    rng = np.random.default_rng(seed)
    R = net.spec.n_neuron_cols
    e_c = torch.from_numpy(rng.uniform(-0.8, 0.8, (n, 2, 3)).astype(np.float32))
    ints = torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32))
    d_new = torch.ones((n, 2))
    gg = torch.from_numpy(rng.uniform(size=n) < 0.2)
    plane_cols = torch.from_numpy(rng.integers(0, R - 1, n))
    return e_c, ints, d_new, gg, plane_cols, R - 1


def test_gd_rescue_backward_scatters_no_table_gradient(backward_calls,
                                                       monkeypatch):
    net = _net()
    args = _rescue_inputs(net, 64, 2)
    steps = 4
    got = tfo.gradient_descent_failover(net, *args, eps=1e-4,
                                        max_iters=steps)
    assert backward_calls == [False] * steps

    # the route with the table in autograd, through the same net
    forward = net.forward
    monkeypatch.setattr(net, "forward", lambda x, gather=False, group=1,
                        table_grad=True: forward(x, gather, group, True))
    del backward_calls[:]
    want = tfo.gradient_descent_failover(net, *args, eps=1e-4,
                                         max_iters=steps)
    assert backward_calls == [True] * steps
    for a, b in zip(got, want):
        assert _bits_equal(a, b)
    assert net.enc.table.grad is None


def _hashed_spec():
    """Medium's grid with a table of 2^13 rows: level 2 (26^3 cells) hashes."""
    return thg.HashGridSpec(levels=4, n_min=4, n_max=64, log2_table=13)


@pytest.mark.parametrize("name, levels, rows", [
    ("small", 3, 2424), ("medium", 2, 1400), ("large", 2, 9776),
    ("hashed", 3, 9592)])
def test_private_levels_fit_the_budget(name, levels, rows):
    spec = (_hashed_spec() if name == "hashed"
            else net_for_size(name, device="cpu").spec.grid)
    if name != "hashed":
        assert (spec.n_min, spec.n_max) == SIZE_PRESETS[name]
    else:
        assert spec.level_uses_hash(2) and not spec.level_uses_hash(1)
    assert thg.private_levels(spec) == levels
    assert thg.private_rows(spec) == rows
    assert rows == sum(spec.level_entries(l) for l in range(levels))
    assert 8 * rows <= thg.PRIVATE_BYTES
    # the plan is the longest prefix that fits: one more level does not
    assert 8 * (rows + spec.level_entries(levels)) > thg.PRIVATE_BYTES


def test_private_levels_take_every_level_that_fits():
    spec = thg.HashGridSpec(levels=5, n_min=2, n_max=16, log2_table=10)
    assert thg.private_levels(spec) == 5
    assert thg.private_rows(spec) == spec.n_entries
