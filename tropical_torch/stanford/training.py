"""SDF training: L1 + eikonal + weight-norm loss, Adam with cosine decay.

Counterpart of ``tropical/stanford/training.py``: clamped L1 on the signed
distances, an eikonal penalty on the *global* Frobenius norm of the batch
Jacobian (the reference's own form), and a weight-norm term that keeps each
output unit's weight row at unit norm.  The Jacobian comes from autograd
with ``create_graph``, so a step runs the hash-grid encode forward once, its
backward twice (for J and for the loss) and its double backward once.

A step makes no host sync: the losses stay on the device and are read once
an epoch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

CLAMP = 0.2
EIKONAL_W = 1e-2
WEIGHT_NORM_W = 1e-1


def loss_terms(net, x: torch.Tensor, y: torch.Tensor, batch_size: int):
    """(l1, eikonal, weight norm) of the batch (x [B, 3], y [B]),
    differentiable in the net's parameters."""
    x = x.detach().requires_grad_(True)
    sdf = net._sdf(x)
    pred_c = torch.clamp(sdf[:, 0], -CLAMP, CLAMP)
    gt = torch.clamp(y, -CLAMP, CLAMP)
    l1 = (pred_c - gt).abs().mean()

    (J,) = torch.autograd.grad(sdf.sum(), x, create_graph=True)
    eik = EIKONAL_W * (torch.linalg.vector_norm(J) - 1.0) ** 2 / batch_size

    # nn.Linear's weight is [out, in]: one row an output unit
    ws = [lin.weight for lin in net.fc]
    wn = sum(((1.0 - torch.linalg.vector_norm(w, dim=1)) ** 2).mean()
             for w in ws)
    wn = WEIGHT_NORM_W * wn / len(ws)
    return l1, eik, wn


def loss_fn(net, x: torch.Tensor, y: torch.Tensor, batch_size: int):
    """(total, l1) of the batch."""
    l1, eik, wn = loss_terms(net, x, y, batch_size)
    return l1 + eik + wn, l1


def cosine_decay(lr: float, total_steps: int, step: int) -> float:
    """``optax.cosine_decay_schedule(lr, total_steps)`` at ``step``."""
    step = min(step, total_steps)
    return lr * 0.5 * (1.0 + math.cos(math.pi * step / total_steps))


def make_optimizer(params, lr: float, total_steps: int):
    """Adam (0.9, 0.999, eps 1e-8) and the cosine schedule as a scheduler:
    the k-th update (from 0) uses ``cosine_decay(lr, total_steps, k)``."""
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda k: cosine_decay(1.0, total_steps, k))
    return opt, sched


def train_step(net, opt, sched, x, y, batch_size: int):
    """One update; returns the (total, l1) losses on the device."""
    opt.zero_grad(set_to_none=True)
    total, l1 = loss_fn(net, x, y, batch_size)
    total.backward()
    opt.step()
    sched.step()
    return total.detach(), l1.detach()


def train(net, dataset, epochs: int, batch_size: int = 1000, lr: float = 1e-3,
          verbose: bool = True, resample: bool = True, epoch_callback=None):
    """Train ``net`` in place; returns the per-step (total, l1) losses as
    float64 arrays.

    ``epoch_callback(epoch)`` fires after each completed epoch but the last,
    inside the one run (Adam and the schedule are not restarted)."""
    total_steps = int(epochs * len(dataset) / batch_size)
    opt, sched = make_optimizer(net.parameters(), lr, total_steps)
    totals, l1s = [], []
    it = 0
    running = 0.0
    for epoch in range(epochs):
        if resample:
            dataset.resample()
        losses = [train_step(net, opt, sched, x, y, batch_size)
                  for x, y in dataset.batches(batch_size)]
        # one read of the epoch's losses
        epoch_totals, epoch_l1s = torch.stack(
            [torch.stack(pair) for pair in losses]).T.tolist()
        totals += epoch_totals
        l1s += epoch_l1s
        for i, total in enumerate(epoch_totals):
            running += total
            it += 1
            if verbose and i % 10 == 9:
                cur_lr = cosine_decay(lr, total_steps, it)
                print(f"[{epoch + 1}, {i + 1:5d}] lr: {cur_lr:.4f}, "
                      f"loss: {running / 10:.5f} l1: {epoch_l1s[i]:.5f}")
                running = 0.0
        if epoch_callback is not None and epoch + 1 < epochs:
            epoch_callback(epoch + 1)
    return np.asarray(totals), np.asarray(l1s)
