"""Parity of the port's training path with the JAX package on the CPU.

The same numpy inputs go through the JAX functions and their counterparts
in the port, on small nets: 2 levels and T = 10, once with both levels
dense and once with the second level hashed.  Tolerances, beside the spread
measured on this CPU:

- encode forward: bitwise (both the same f32 operations in one order);
- encode backward against ``jax.vjp`` and against torch autograd of
  ``encode_plain``: dx to 1e-6 of its largest value (measured 1.3e-7),
  dtable to 2e-6 (measured 2.9e-7): each sums its corners, axes, levels
  and scattered rows in its own order;
- double backward: 1e-6 of the largest value (measured 1.2e-7);
- the loss and each gradient leaf: 2e-6 of the leaf's largest value
  (measured 2.5e-7); the eikonal term's gradient alone as well (measured
  2.5e-7), since its 1e-2 weight would hide an error in the total;
- the cosine schedule: rtol 1e-6, atol 1e-9 (optax computes it in f32:
  5e-12 apart at the last step, where it is 1e-8);
- six Adam steps: losses rtol 1e-5 (measured 3.5e-7), params atol 1e-6
  (measured 1.5e-7, about 1e-4 of one step): optax folds the bias
  correction into the step and torch divides by it, and Adam's g/sqrt(v)
  turns the gradients' last-bit differences on small entries into
  differences of the step;
- the checkpoint written by the port and read by JAX: sdf within 1e-6
  (the MLP's matrix products sum in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tropical.core import hashgrid as jhg
from tropical.core.net import NetSpec as JaxNetSpec
from tropical.core.net import init_net_params, net_sdf
from tropical.stanford import training as jtr
from tropical.utils import checkpoint as jckpt
from tropical_torch.core import hashgrid as thg
from tropical_torch.core.net import NetSpec, TorchNet
from tropical_torch.stanford import training as ttr
from tropical_torch.utils import checkpoint as tckpt

# (r_min, r_max): the second level at resolution 5 (dense: 125 rows) or
# 16 (4,096 corners > 2^10: hashed)
SPECS = {"dense": (2, 4), "hashed": (2, 16)}


def _specs(kind):
    r_min, r_max = SPECS[kind]
    kw = dict(num_layers=3, num_hidden=16, levels=2, r_min=r_min,
              r_max=r_max, T=10)
    return JaxNetSpec(**kw), NetSpec(**kw)


def _inputs(spec, n=257, seed=0):
    """Table, points in the unit cube (some on grid planes and at 1.0),
    feature and dx gradients, float32 numpy."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(spec.n_entries, spec.features)).astype(
        np.float32)
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    x[:16] = np.round(x[:16] * 4) / 4
    dfeat = rng.normal(size=(n, spec.levels * spec.features)).astype(
        np.float32)
    ddx = rng.normal(size=(n, 3)).astype(np.float32)
    return table, x, dfeat, ddx


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, rtol, atol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=atol + rtol * scale)


@pytest.mark.parametrize("kind", SPECS)
def test_encode_forward_bitwise_and_spec(kind):
    js, ts = _specs(kind)
    gj, gt = js.grid, ts.grid
    assert gt.level_uses_hash(1) == (kind == "hashed") == gj.level_uses_hash(1)
    table, x, _, _ = _inputs(gt)
    want = np.asarray(jhg.encode(gj, jnp.asarray(table), jnp.asarray(x)))
    got = thg.encode(gt, _t(table), _t(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("kind", SPECS)
def test_encode_backward_against_jax_and_autograd(kind):
    js, ts = _specs(kind)
    table, x, dfeat, _ = _inputs(ts.grid)
    _, vjp = jax.vjp(lambda t, p: jhg.encode(js.grid, t, p),
                     jnp.asarray(table), jnp.asarray(x))
    jdt, jdx = vjp(jnp.asarray(dfeat))
    dx, dt = thg.encode_backward_plain(ts.grid, _t(table), _t(x), _t(dfeat))
    _close(dx, jdx, 1e-6)
    _close(dt, jdt, 2e-6)

    xt = _t(x).requires_grad_()
    tt = _t(table).requires_grad_()
    adx, adt = torch.autograd.grad(thg.encode_plain(ts.grid, tt, xt),
                                   (xt, tt), _t(dfeat))
    _close(dx, adx, 1e-6)
    _close(dt, adt, 2e-6)
    # HashGridEncode's backward on the CPU is the plain version, and skips
    # what is not asked for
    xt = _t(x).requires_grad_()
    fdx, = torch.autograd.grad(thg.encode(ts.grid, _t(table), xt), xt,
                               _t(dfeat))
    assert torch.equal(fdx, dx)
    assert thg.encode_backward_plain(ts.grid, _t(table), _t(x), _t(dfeat),
                                     need_table=False)[1] is None


@pytest.mark.parametrize("kind", SPECS)
def test_encode_double_backward_against_jax(kind):
    """d/d(table, dfeat, x) of sum(ddx * dx), dx the x-gradient of
    sum(dfeat * encode)."""
    js, ts = _specs(kind)
    table, x, dfeat, ddx = _inputs(ts.grid)

    def h(t, p, v):
        _, vjp = jax.vjp(lambda pp: jhg.encode(js.grid, t, pp), p)
        return jnp.sum(jnp.asarray(ddx) * vjp(v)[0])

    jdt2, jdx2, jdd = jax.grad(h, argnums=(0, 1, 2))(
        jnp.asarray(table), jnp.asarray(x), jnp.asarray(dfeat))
    dd, dt2, dx2 = thg.encode_double_backward_plain(
        ts.grid, _t(table), _t(x), _t(dfeat), _t(ddx))
    _close(dd, jdd, 1e-6)
    _close(dt2, jdt2, 1e-6)
    _close(dx2, jdx2, 1e-6)

    # the same through HashGridEncode's autograd on the CPU
    xt, tt, vt = (_t(a).requires_grad_() for a in (x, table, dfeat))
    dx, = torch.autograd.grad(thg.encode(ts.grid, tt, xt), xt, vt,
                              create_graph=True)
    g = torch.autograd.grad((dx * _t(ddx)).sum(), (tt, xt, vt))
    for got, want in zip(g, (dt2, dx2, dd)):
        assert torch.equal(got, want)


def test_encode_gradgradcheck_float64():
    """Numerical second derivatives of the CPU HashGridEncode, in float64,
    on the hashed spec; points away from the cells' planes."""
    _, ts = _specs("hashed")
    table, x, dfeat, _ = _inputs(ts.grid, n=24, seed=5)
    table = _t(table).double()
    x = _t(x[16:]).double().requires_grad_()
    assert torch.autograd.gradgradcheck(
        lambda p: thg.encode(ts.grid, table, p), (x,), fast_mode=True)

    # the table's and dfeat's part: the x-gradient as a function of all three
    def dx_of(p, t, v):
        return torch.autograd.grad(thg.encode(ts.grid, t, p), p, v,
                                   create_graph=True)[0]

    assert torch.autograd.gradcheck(dx_of, (
        x, table.clone().requires_grad_(),
        _t(dfeat[16:]).double().requires_grad_()), fast_mode=True)


def test_gradient_of_the_table_gradient_raises():
    _, ts = _specs("dense")
    table, x, dfeat, _ = _inputs(ts.grid, n=8)
    xt, tt = _t(x).requires_grad_(), _t(table).requires_grad_()
    _, dt = torch.autograd.grad(thg.encode(ts.grid, tt, xt), (xt, tt),
                                _t(dfeat), create_graph=True)
    with pytest.raises(NotImplementedError, match="table gradient"):
        torch.autograd.grad(dt.sum(), xt)


def _nets(kind, seed=0):
    """A JAX params pytree and the port's net carrying the same values."""
    js, ts = _specs(kind)
    params = init_net_params(js, jax.random.PRNGKey(seed))
    net = TorchNet(ts, device="cpu").params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params))
    return js, params, net


def _batch(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    y = rng.uniform(-0.3, 0.3, n).astype(np.float32)
    return x, y


def _leaves(net):
    """The port's gradients in the JAX pytree's leaf order (table, then
    b0..b2 and w0..w2 as [in, out])."""
    grads = {"table": net.enc.table.grad,
             "mlp": {"w": [l.weight.grad.T for l in net.fc],
                     "b": [l.bias.grad for l in net.fc]}}
    return jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda g: g.numpy(), grads))


@pytest.mark.parametrize("kind", SPECS)
def test_loss_and_gradients_against_jax(kind):
    js, params, net = _nets(kind)
    # a larger table puts the net's sdf inside the clamp window
    params["table"] = params["table"] * 3000.0
    net.params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    x, y = _batch()
    (jtotal, jl1), jgrads = jax.value_and_grad(
        lambda p: jtr.loss_fn(js, p, jnp.asarray(x), jnp.asarray(y), 64),
        has_aux=True)(params)
    total, l1 = ttr.loss_fn(net, _t(x), _t(y), 64)
    total.backward()
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    np.testing.assert_allclose(float(l1), float(jl1), rtol=1e-5)
    for got, want in zip(_leaves(net), jax.tree_util.tree_leaves(jgrads)):
        _close(got, want, 2e-6)


@pytest.mark.parametrize("kind", SPECS)
def test_eikonal_gradient_alone_against_jax(kind):
    js, params, net = _nets(kind)
    params["table"] = params["table"] * 3000.0
    net.params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    x, _ = _batch()

    def jeik(p):
        J = jax.grad(lambda pts: net_sdf(js, p, pts).sum())(jnp.asarray(x))
        return jtr.EIKONAL_W * (jnp.linalg.norm(J) - 1.0) ** 2 / 64

    jval, jgrads = jax.value_and_grad(jeik)(params)
    _, eik, _ = ttr.loss_terms(net, _t(x), torch.zeros(64), 64)
    eik.backward()
    np.testing.assert_allclose(float(eik), float(jval), rtol=1e-5)
    leaves = jax.tree_util.tree_leaves(jgrads)
    assert max(float(np.abs(g).max()) for g in leaves) > 0
    for got, want in zip(_leaves(net), leaves):
        _close(got, want, 2e-6)


def test_cosine_schedule_equals_optax():
    _, schedule = jtr.make_optimizer(1e-3, 500)
    for step in (0, 1, 250, 499, 500, 600):
        np.testing.assert_allclose(ttr.cosine_decay(1e-3, 500, step),
                                   float(schedule(step)), rtol=1e-6,
                                   atol=1e-9)
    # the scheduler gives the k-th update schedule(k), from schedule(0)
    _, _, net = _nets("dense")
    opt, sched = ttr.make_optimizer(net.parameters(), 1e-3, 500)
    for k in range(3):
        assert opt.param_groups[0]["lr"] == pytest.approx(
            float(schedule(k)), rel=1e-6)
        opt.step()
        sched.step()


def test_six_steps_equal_jax_train_step():
    """The fixture of tests/test_training.py's scan-vs-loop test."""
    js, params, net = _nets("dense")
    rng = np.random.default_rng(3)
    n_batches, B = 6, 32
    xs = rng.uniform(-1, 1, (n_batches, B, 3)).astype(np.float32)
    ys = rng.uniform(-0.3, 0.3, (n_batches, B)).astype(np.float32)

    tx, _ = jtr.make_optimizer(1e-3, n_batches)
    step = jtr.make_train_step(js, tx, B)
    opt_state = tx.init(params)
    opt, sched = ttr.make_optimizer(net.parameters(), 1e-3, n_batches)
    for i in range(n_batches):
        params, opt_state, jtotal, jl1 = step(
            params, opt_state, jnp.asarray(xs[i]), jnp.asarray(ys[i]))
        total, l1 = ttr.train_step(net, opt, sched, _t(xs[i]), _t(ys[i]), B)
        np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
        np.testing.assert_allclose(float(l1), float(jl1), rtol=1e-5)
    got = jax.tree_util.tree_leaves(net.params_to_numpy())
    for a, b in zip(got, jax.tree_util.tree_leaves(params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)


def test_train_loop_prints_and_losses(capsys):
    """``train`` on a fixed dataset: the JAX package's print lines, one
    loss a step, and the epoch callback between epochs."""
    _, _, net = _nets("dense")
    rng = np.random.default_rng(0)

    class Fixed:
        X = _t(rng.uniform(-1, 1, (40, 3)).astype(np.float32))
        Y = _t(rng.uniform(-0.3, 0.3, 40).astype(np.float32))

        def __len__(self):
            return 40

        def resample(self):
            raise AssertionError("resample=False")

        def batches(self, batch_size):
            for i in range(0, 40, batch_size):
                yield self.X[i:i + batch_size], self.Y[i:i + batch_size]

    seen = []
    totals, l1s = ttr.train(net, Fixed(), epochs=2, batch_size=4,
                            resample=False, epoch_callback=seen.append)
    assert totals.shape == l1s.shape == (20,) and np.isfinite(totals).all()
    assert seen == [1]
    lines = capsys.readouterr().out.splitlines()
    assert [ln[:11] for ln in lines] == ["[1,    10] ", "[2,    10] "]
    assert lines[1].startswith("[2,    10] lr: 0.0000, loss: ")


@pytest.mark.parametrize("kind", SPECS)
def test_checkpoint_written_by_the_port_reads_in_jax(kind, tmp_path):
    js, params, net = _nets(kind, seed=3)
    path = tckpt.save_params(str(tmp_path / "m" / "net.pth"),
                             net.params_to_numpy())
    assert path.endswith("net.pth.npz")
    loaded = jckpt.load_params(path)
    for a, b in zip(jax.tree_util.tree_leaves(loaded),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    x, _ = _batch(128, seed=4)
    want = np.asarray(net_sdf(js, loaded, jnp.asarray(x)))
    got = net.sdf(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_cli_saves_its_own_checkpoint_and_reads_it_first(tmp_path,
                                                         monkeypatch):
    """Without -c the CLI saves under its own models directory (never the
    JAX package's), and a later run finds that checkpoint before the
    committed one; with -c it saves nothing.  Training itself is stubbed."""
    from tropical_torch.stanford import dataset as tds
    from tropical_torch.stanford import train as cli
    from tropical_torch.stanford import training as ttr_mod

    monkeypatch.setattr(cli, "MODELS_DIR", tmp_path / "models")
    monkeypatch.setattr(tds.StanfordDataset, "__init__",
                        lambda self, *a, **k: None)
    trained = []
    monkeypatch.setattr(ttr_mod, "train",
                        lambda net, *a, **k: trained.append(net))
    args = cli.parse_args(["-m", "small", "-d", "sphere", "-s", "1",
                           "--epochs", "1"])
    assert cli.cached_checkpoint("sphere", "small", 1).startswith(
        str(cli.COMMITTED_MODELS_DIR))
    net = TorchNet(NetSpec(r_min=2, r_max=32), device="cpu")
    cli.train_net(net, args, torch.device("cpu"))
    saved = tmp_path / "models" / "sphere" / "sphere_sdf_small_1.pth.npz"
    assert trained == [net] and saved.is_file()
    assert cli.cached_checkpoint("sphere", "small", 1) == str(saved)
    np.testing.assert_array_equal(jckpt.load_params(str(saved))["table"],
                                  net.enc.table.detach().numpy())
    saved.unlink()
    cli.train_net(net, cli.parse_args(["-c", "-d", "sphere", "-s", "1"]),
                  torch.device("cpu"))
    assert not saved.exists() and len(trained) == 2
