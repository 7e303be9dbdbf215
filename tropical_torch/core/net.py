"""TorchNet: hash-grid + MLP SDF network with region indicators.

Counterpart of ``tropical/core/net.py``.  Contract consumed by the extraction
engine:

- ``num_layers`` / ``num_hidden`` / ``eps`` / ``marks`` attributes,
- ``forward(x, gather, group)`` -> out [B,2] (and the R=33 gathered columns),
- ``sdf(x)`` = tanh(out1 - out0),
- ``region(x, output, eps)`` -> ternary sign vector [B, D+R] prepended with
  the grid on-plane mask, plus per-axis cell offsets,
- ``normal(x, l, h)`` = d sdf / dx (or of a chosen neuron) via autograd
  (through the encode's backward, in x alone),
- ``preprocess``/``preprocess_inverse`` world <-> unit-cube maps.

Parameters: ``enc.table`` [n_entries, F] and ``fc.{i}`` ``nn.Linear`` layers,
the reference PyTorch checkpoint's own layout.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch
from torch import nn

from tropical_torch import resolve_device
from tropical_torch.core.hashgrid import (HashGridSpec, TropicalHashGrid,
                                          encode_lattice)
from tropical_torch.core.mlp import mlp_forward


@dataclass(frozen=True)
class NetSpec:
    """Static architecture config."""

    num_layers: int = 3
    num_hidden: int = 16
    levels: int = 4
    r_min: int = 2
    r_max: int = 32
    T: int = 19
    eps: float = 1e-4
    features: int = 2
    dim: int = 3
    scale: float = 1.0  # world range is [-scale, scale]^D

    @cached_property
    def grid(self) -> HashGridSpec:
        return HashGridSpec(
            scale=1.0, dim=self.dim, levels=self.levels, features=self.features,
            log2_table=self.T, n_min=self.r_min, n_max=self.r_max, eps=self.eps)

    @cached_property
    def num_nodes(self):
        return ([self.levels * self.features]
                + [self.num_hidden] * (self.num_layers - 1) + [2])

    @property
    def n_neuron_cols(self) -> int:
        """R: hidden pre-activations plus the final difference column."""
        return (self.num_layers - 1) * self.num_hidden + 1


def preprocess(spec: NetSpec, x):
    """World [-scale, scale]^D -> unit cube."""
    return (x + spec.scale) / (spec.scale * 2)


def preprocess_inverse(spec: NetSpec, x):
    return x * (spec.scale * 2) - spec.scale


def lattice_features(net, xw, yw, zw, tables=None, need_grad: bool = False,
                     plain: bool = False):
    """The hash-grid features of the separable world-coordinate lattice
    {xw} x {yw} x {zw} (x-major point order), and with ``need_grad`` their
    derivatives along the world axes (``encode_lattice``; ``plain``: its
    plain version on any device)."""
    spec = net.spec
    xs, ys, zs = (preprocess(spec, a) for a in (xw, yw, zw))
    return encode_lattice(spec.grid, net.enc.table.detach(), xs, ys, zs,
                          tables, need_grad, world_scale=spec.scale,
                          plain=plain)


@torch.no_grad()
def net_outputs_lattice(net, xw, yw, zw, tables=None) -> torch.Tensor:
    """The R gathered columns over the separable world-coordinate lattice
    {xw} x {yw} x {zw} -> [Nx*Ny*Nz, R], x-major point order: the forward
    of ``outputs`` over the meshgrid, the encode factored
    (``encode_lattice``), equal to it to f32 rounding."""
    feats = lattice_features(net, xw, yw, zw, tables)
    return mlp_forward([l.weight for l in net.fc], [l.bias for l in net.fc],
                       feats, gather=True, eps=net.spec.eps)[1]


@torch.no_grad()
def net_sdf_lattice(net, xw, yw, zw, tables=None) -> torch.Tensor:
    """The sdf over the separable world-coordinate lattice -> [N]."""
    feats = lattice_features(net, xw, yw, zw, tables)
    out, _ = mlp_forward([l.weight for l in net.fc],
                         [l.bias for l in net.fc], feats)
    return torch.tanh(out[:, 1] - out[:, 0])


class TorchNet(nn.Module):
    """The SDF network on one device."""

    def __init__(self, spec: NetSpec, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        self.spec = spec
        self.enc = TropicalHashGrid(spec.grid, generator=generator)
        layers = []
        for fan_in, fan_out in zip(spec.num_nodes[:-1], spec.num_nodes[1:]):
            # torch.nn.Linear's bound, drawn from the caller's generator
            bound = 1.0 / fan_in ** 0.5
            lin = nn.Linear(fan_in, fan_out)
            with torch.no_grad():
                lin.weight.uniform_(-bound, bound, generator=generator)
                lin.bias.uniform_(-bound, bound, generator=generator)
            layers.append(lin)
        self.fc = nn.ModuleList(layers)
        self.to(device)

    # --- reference-API surface -------------------------------------------
    @property
    def num_layers(self) -> int:
        return self.spec.num_layers

    @property
    def num_hidden(self) -> int:
        return self.spec.num_hidden

    @property
    def eps(self) -> float:
        return self.spec.eps

    @property
    def marks(self) -> torch.Tensor:
        return self.enc.marks

    @property
    def device(self) -> torch.device:
        return self.enc.table.device

    def preprocess(self, x):
        return preprocess(self.spec, x)

    def preprocess_inverse(self, x):
        return preprocess_inverse(self.spec, x)

    def forward(self, x: torch.Tensor, gather: bool = False, group: int = 1,
                table_grad: bool = True):
        """out [B, 2] (and the gathered columns); ``table_grad`` False
        leaves the hash table out of autograd, for gradients in x alone."""
        feats = self.enc(preprocess(self.spec, x), table_grad)
        out, g = mlp_forward([l.weight for l in self.fc],
                             [l.bias for l in self.fc], feats,
                             gather=gather, group=group, eps=self.spec.eps)
        return (out, g) if gather else out

    def _sdf(self, x: torch.Tensor, table_grad: bool = True) -> torch.Tensor:
        out = self(x, table_grad=table_grad)
        # tanh does not move the zero level set
        return torch.tanh(out[:, 1:] - out[:, :1])

    @torch.no_grad()
    def sdf(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 1] signed distance (inside positive)."""
        return self._sdf(x)

    @torch.no_grad()
    def outputs(self, x: torch.Tensor, group: int = 1) -> torch.Tensor:
        """The R gathered 'neuron distance' columns [B, R]."""
        return self(x, gather=True, group=group)[1]

    @torch.no_grad()
    def region(self, x: torch.Tensor, output: torch.Tensor | None = None,
               eps: float | None = None):
        """Ternary region indicator (Def. 3.4) + grid mask/offset.

        Returns (m [B, D+R] int32 in {-1,0,1} with the first D columns the
        {0,1} grid mask, offset [B, D] int32, output [B, R] float32).
        """
        eps = self.spec.eps if eps is None else eps
        if output is None:
            output = self.outputs(x)
        m = torch.where(output > 0, 1, -1).to(torch.int32)
        m[output.abs() <= eps] = 0
        xu = preprocess(self.spec, x)
        marks = self.marks
        offset = torch.searchsorted(marks, (xu + eps).contiguous()) - 1
        # index -1 wraps to the last mark, as torch's own indexing would
        mark_at = marks[torch.remainder(offset, marks.shape[0])]
        grid_mask = ((mark_at - xu).abs() > eps).to(torch.int32)
        return torch.cat([grid_mask, m], dim=-1), offset.to(torch.int32), output

    def sdf_and_grad(self, x: torch.Tensor):
        """(sdf [B, 1], its gradient in x [B, 3]); the table detached, so
        the encode's backward computes dx alone."""
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            s = self._sdf(xx, table_grad=False)
            (g,) = torch.autograd.grad(s.sum(), xx)
        return s.detach(), g

    def normal(self, x: torch.Tensor, l: int | None = None,
               h: int | None = None) -> torch.Tensor:
        """Per-point gradient of the sdf (or of neuron column l*H+h) w.r.t. x
        (the table detached: the encode's backward computes dx alone)."""
        if l is None or h is None or h == self.num_hidden:
            idx = None
        else:
            idx = l * self.num_hidden + h
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            if idx is None:
                f = self._sdf(xx, table_grad=False).sum()
            else:
                f = self(xx, gather=True, table_grad=False)[1][:, idx].sum()
            (g,) = torch.autograd.grad(f, xx)
        return g

    # --- checkpoint interop ----------------------------------------------
    @torch.no_grad()
    def params_from_numpy(self, params) -> "TorchNet":
        """Load the JAX package's params pytree, as numpy arrays:
        ``table`` [n_entries, F], ``mlp.w[i]`` [in, out], ``mlp.b[i]``."""
        dev = self.device
        self.enc.table.copy_(torch.as_tensor(
            np.asarray(params["table"], np.float32), device=dev))
        for lin, w, b in zip(self.fc, params["mlp"]["w"], params["mlp"]["b"]):
            lin.weight.copy_(torch.as_tensor(np.asarray(w, np.float32).T,
                                             device=dev))
            lin.bias.copy_(torch.as_tensor(np.asarray(b, np.float32),
                                           device=dev))
        return self

    @torch.no_grad()
    def params_to_numpy(self):
        """The inverse of ``params_from_numpy``: the JAX package's params
        pytree as numpy arrays, ``mlp.w[i]`` in [in, out] layout."""
        return {"table": self.enc.table.detach().cpu().numpy(),
                "mlp": {"w": [lin.weight.detach().cpu().numpy().T.copy()
                              for lin in self.fc],
                        "b": [lin.bias.detach().cpu().numpy()
                              for lin in self.fc]}}

    @torch.no_grad()
    def load_reference_state_dict(self, state) -> "TorchNet":
        """Load a reference PyTorch checkpoint: ``enc.module.params`` (flat
        float32 table, feature-fastest) and ``fc.{i}.weight``/``bias``."""
        dev = self.device
        self.enc.table.copy_(
            state["enc.module.params"].detach().reshape(
                self.spec.grid.n_entries, self.spec.grid.features)
            .to(dev, torch.float32))
        for i, lin in enumerate(self.fc):
            lin.weight.copy_(state[f"fc.{i}.weight"].to(dev, torch.float32))
            lin.bias.copy_(state[f"fc.{i}.bias"].to(dev, torch.float32))
        return self

    def load_reference_checkpoint(self, path: str) -> "TorchNet":
        return self.load_reference_state_dict(
            torch.load(path, map_location="cpu", weights_only=True))
