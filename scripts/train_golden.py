"""Write the training golden of sphere-small, seed 1, with the JAX package.

    JAX_PLATFORMS=cpu python scripts/train_golden.py

Trains the JAX package's ``net_for_size("small", "sphere", 1)`` on
``StanfordDataset("sphere", rng=np.random.default_rng(1))`` for 10 epochs of
50 steps of 1,000 points, as ``tropical.stanford.train`` does (the epoch
loop of ``tropical.stanford.training.train``, keeping every step's losses),
on the CPU:

- the golden: from the initial params;
- the witness: from the initial params with every leaf moved by one ulp, up
  or down as a seeded draw says;
- the adam run: from the initial params, with Adam in torch.optim.Adam's
  arithmetic (the first moment by ``lerp``, the bias corrections divided
  out of the step size and the second moment's root, the step size and
  the cosine rate in float64 on the host) in place of optax's, which folds
  them into the moments.  It is the golden with the port's optimizer;
- ``ORDER_RUNS`` order witnesses: from the initial params, with the rows of
  every batch in a seeded order.  The loss is a mean over the rows, so only
  the order of its sums changes: the summation noise of a loss that is
  read out in another order.

It saves to ``tests/golden/sphere_small_train_1.npz`` the initial params
(the JAX ``.npz`` layout: ``table``, ``w{i}`` [in, out], ``b{i}``), the
per-step total and L1 losses of every run (``order_*`` stacked over the
order witnesses), seeded probe points and the sdf of every trained net
there.  The port's GPU smoke run trains from these params and is held per
10-step window of the losses: first to the adam run, within twice the
order witnesses' largest gap to the golden; from the window where twice
the one-ulp witness's spread covers the adam run's own gap, to the golden
within twice that spread; and at the probes to the golden within twice the
one-ulp witness's spread.  About fifteen minutes on eight CPU cores.
"""

from __future__ import annotations

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "tests", "golden", "sphere_small_train_1.npz")
SEED = 1
EPOCHS = 10
BATCH = 1000
WITNESS_SEED = 2
ORDER_RUNS = 3
ORDER_SEED = 3
N_PROBES = 4096


def probes(rng):
    """Half uniform over the extraction canvas, half within 0.1 of the
    unit sphere the dataset is built around."""
    import numpy as np

    n = N_PROBES // 2
    uniform = rng.uniform(-1.2, 1.2, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    near = d * rng.uniform(0.9, 1.1, (n, 1))
    return np.concatenate([uniform, near]).astype(np.float32)


def ulp_moved(params, rng):
    import jax
    import numpy as np

    def move(a):
        a = np.asarray(a)
        toward = np.where(rng.random(a.shape) < 0.5, np.float32(np.inf),
                          np.float32(-np.inf))
        return np.nextafter(a, toward).astype(np.float32)

    return jax.tree_util.tree_map(move, params)


def torch_adam(lr, total_steps, b1=0.9, b2=0.999, eps=1e-8):
    """An optax transformation with torch.optim.Adam's arithmetic and the
    cosine rate torch's LambdaLR gives the port: at update k (from 0),
    m += (1 - b1) (g - m); v = v b2 + (1 - b2) g g; the update is
    (-(lr_k / (1 - b1^(k+1))) m) / (sqrt(v) / sqrt(1 - b2^(k+1)) + eps), its
    two host factors computed in float64 and rounded to float32."""
    import math

    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    k = np.arange(total_steps + 1)
    rate = lr * 0.5 * (1.0 + np.cos(math.pi * k / total_steps))
    step_size = jnp.asarray((-(rate / (1.0 - b1 ** (k + 1)))).astype(np.float32))
    bc2_sqrt = jnp.asarray(np.sqrt(1.0 - b2 ** (k + 1)).astype(np.float32))
    w1, w2 = np.float32(1.0 - b1), np.float32(1.0 - b2)

    def init(params):
        zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
        return jnp.zeros([], jnp.int32), zeros, zeros

    def update(grads, state, params=None):
        count, m, v = state
        m = jax.tree_util.tree_map(lambda m, g: m + w1 * (g - m), m, grads)
        v = jax.tree_util.tree_map(
            lambda v, g: v * np.float32(b2) + w2 * g * g, v, grads)
        i = jnp.minimum(count, total_steps)
        updates = jax.tree_util.tree_map(
            lambda m, v: step_size[i] * m / (jnp.sqrt(v) / bc2_sqrt[i]
                                             + np.float32(eps)), m, v)
        return updates, (count + 1, m, v)

    return optax.GradientTransformation(init, update)


def run(spec, params, order_rng=None, adam=None):
    """The JAX package's training loop from ``params``: (trained params,
    per-step totals, per-step l1s).  With ``order_rng``, each batch's rows
    are taken in an order it draws; ``adam`` replaces the package's
    optimizer (``torch_adam``)."""
    import jax.numpy as jnp
    import numpy as np

    from tropical.stanford.dataset import StanfordDataset
    from tropical.stanford.training import make_optimizer, make_scan_epoch

    dataset = StanfordDataset("sphere", rng=np.random.default_rng(SEED))
    total_steps = int(EPOCHS * len(dataset) / BATCH)
    tx = (adam or (lambda lr, n: make_optimizer(lr, n)[0]))(1e-3, total_steps)
    opt_state = tx.init(params)
    epoch_fn = make_scan_epoch(spec, tx, BATCH)
    totals, l1s = [], []
    for _ in range(EPOCHS):
        dataset.resample()
        xs, ys = zip(*dataset.batches(BATCH))
        if order_rng is not None:
            perms = [order_rng.permutation(len(x)) for x in xs]
            xs = [x[p] for x, p in zip(xs, perms)]
            ys = [y[p] for y, p in zip(ys, perms)]
        params, opt_state, t, l = epoch_fn(params, opt_state,
                                           jnp.asarray(np.stack(xs)),
                                           jnp.asarray(np.stack(ys)))
        totals.append(np.asarray(t))
        l1s.append(np.asarray(l))
    return params, np.concatenate(totals), np.concatenate(l1s)


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from tropical.core.net import net_sdf
    from tropical.stanford.model import net_for_size

    t0 = time.time()
    net = net_for_size("small", "sphere", SEED)
    init = jax.tree_util.tree_map(np.asarray, net.params)
    witness_init = ulp_moved(init, np.random.default_rng(WITNESS_SEED))
    pts = probes(np.random.default_rng(SEED))

    runs = [("golden", init, None, None),
            ("witness", witness_init, None, None),
            ("adam", init, None, torch_adam)]
    runs += [(f"order{k}", init, np.random.default_rng(ORDER_SEED + k), None)
             for k in range(ORDER_RUNS)]
    out = {}
    for name, p0, order_rng, adam in runs:
        params, totals, l1s = run(net.spec, jax.tree_util.tree_map(
            jnp.asarray, p0), order_rng, adam)
        out[f"{name}_totals"] = totals
        out[f"{name}_l1s"] = l1s
        out[f"{name}_sdf"] = np.asarray(
            net_sdf(net.spec, params, jnp.asarray(pts)))[:, 0]
        print(f"{name}: last loss {totals[-1]:.6f}, l1 {l1s[-1]:.6f} "
              f"({time.time() - t0:.0f} s)", flush=True)
    for key in ("totals", "l1s", "sdf"):
        out[f"order_{key}"] = np.stack(
            [out.pop(f"order{k}_{key}") for k in range(ORDER_RUNS)])

    flat = {"table": init["table"]}
    for i, (w, b) in enumerate(zip(init["mlp"]["w"], init["mlp"]["b"])):
        flat[f"w{i}"], flat[f"b{i}"] = w, b
    for name in ("witness", "adam", "order"):
        gap = np.abs(out["golden_totals"] - out[f"{name}_totals"])
        print(f"{name} gap: losses max {gap.max():.3e} (first window "
              f"{gap[..., :10].max():.3e}), probes max "
              f"{np.abs(out['golden_sdf'] - out[f'{name}_sdf']).max():.3e}")
    np.savez_compressed(OUT, probes=pts, **flat, **out)
    print(f"wrote {OUT} ({time.time() - t0:.0f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
