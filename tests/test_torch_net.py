"""Parity of the port's net forward (tropical_torch.core) with the JAX net.

The same seeded numpy inputs go through both on the CPU.  Tolerances:

- outputs / sdf: rtol 1e-5, atol 1e-6.  The hash-grid encode is the same
  f32 arithmetic in the same order; the MLP's matrix products sum in another
  order (XLA's dot vs PyTorch's BLAS), a few f32 ulps.
- marks and table indices: exact (host float64 and integer arithmetic).
- region masks/offsets: exact, except rows holding a value within 1e-6 of
  +-eps, where those ulps may flip the eps test; such rows must stay < 0.1%.
- normals: atol 1e-5 (the same ulps through the backward pass).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tropical.core import hashgrid as jhg
from tropical.stanford.model import Net as JaxNet
from tropical.utils import checkpoint as jckpt
from tropical_torch.core import hashgrid as thg
from tropical_torch.stanford.model import Net as TorchNetFactory
from tropical_torch.utils import checkpoint as tckpt

ROOT = os.path.join(os.path.dirname(__file__), "..")

# (checkpoint, r_min, r_max); large (r_max=128) is the only preset whose
# levels hash (129^3 > 2^19), so it alone exercises the uint32 hash path
CHECKPOINTS = {
    "sphere_small": ("sphere/sphere_sdf_small_1", 2, 32),
    "sphere_medium": ("sphere/sphere_sdf_medium_1", 4, 64),
    "sphere_large": ("sphere/sphere_sdf_large_1", 8, 128),
    "torus_small": ("torus/torus_sdf_small_1", 2, 32),
}


def _ckpt_path(name):
    rel, _, _ = CHECKPOINTS[name]
    return os.path.join(ROOT, "tropical/stanford/models", rel + ".pth.npz")


def _nets(name):
    _, r_min, r_max = CHECKPOINTS[name]
    path = _ckpt_path(name)
    jnet = JaxNet(r_min=r_min, r_max=r_max, key=jax.random.PRNGKey(1))
    jckpt.load_into(jnet, path)
    tnet = TorchNetFactory(r_min=r_min, r_max=r_max, device="cpu")
    tckpt.load_into(tnet, path)
    return jnet, tnet


def _points(n=4096, seed=0):
    # the extraction canvas [-1.2, 1.2]^3 reaches outside the unit cube of
    # the encoding, where the index wrap and the clip gather act
    return np.random.default_rng(seed).uniform(-1.2, 1.2, (n, 3)).astype(
        np.float32)


@pytest.mark.parametrize("name", list(CHECKPOINTS))
def test_outputs_sdf_regions_normals_match_jax(name):
    jnet, tnet = _nets(name)
    x = _points()
    xt = torch.from_numpy(x)

    out_j, g_j = jnet(jnp.asarray(x), gather=True)
    out_t, g_t = tnet(xt, gather=True)
    g_t = g_t.detach().numpy()
    assert g_t.shape == (x.shape[0], 33)
    np.testing.assert_allclose(g_t, np.asarray(g_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tnet.sdf(xt).numpy(),
                               np.asarray(jnet.sdf(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    # group=8: one activation pattern per 8 consecutive rows
    np.testing.assert_allclose(
        tnet.outputs(xt, group=8).numpy(),
        np.asarray(jnet.outputs(jnp.asarray(x), group=8)),
        rtol=1e-5, atol=1e-6)

    m_j, off_j, _ = jnet.region(jnp.asarray(x))
    m_t, off_t, _ = tnet.region(xt)
    np.testing.assert_array_equal(off_t.numpy(), np.asarray(off_j))
    eps = jnet.spec.eps
    near = (np.abs(np.abs(np.asarray(g_j)) - eps) < 1e-6).any(1)
    differ = (m_t.numpy() != np.asarray(m_j)).any(1)
    assert not (differ & ~near).any()
    assert differ.sum() <= near.sum() < 1e-3 * x.shape[0]

    np.testing.assert_allclose(tnet.normal(xt).numpy(),
                               np.asarray(jnet.normal(jnp.asarray(x))),
                               atol=1e-5)
    np.testing.assert_allclose(tnet.normal(xt, l=1, h=3).numpy(),
                               np.asarray(jnet.normal(jnp.asarray(x), 1, 3)),
                               atol=1e-5)


@pytest.mark.parametrize("name", ["sphere_small", "sphere_large"])
def test_marks_and_table_indices_exact(name):
    jnet, tnet = _nets(name)
    spec_j, spec_t = jnet.spec.grid, tnet.spec.grid
    np.testing.assert_array_equal(thg.compute_marks(spec_t),
                                  jhg.compute_marks(spec_j))
    np.testing.assert_array_equal(tnet.marks.numpy(), np.asarray(jnet.marks))
    assert spec_t.level_offsets == spec_j.level_offsets
    assert spec_t.n_entries == spec_j.n_entries

    rng = np.random.default_rng(1)
    for l in range(spec_j.levels):
        res = spec_j.level_resolution(l)
        # corner coordinates from below the cube to past its far side
        grid = rng.integers(-2, res + 3, (2048, 3)).astype(np.int32)
        want = np.asarray(jhg._level_indices(spec_j, l, jnp.asarray(grid)))
        got = thg._level_indices(
            spec_t, l, [torch.from_numpy(grid[:, d].astype(np.int64))
                        for d in range(3)])
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    if name == "sphere_large":
        assert any(spec_j.level_uses_hash(l) for l in range(spec_j.levels))


def test_params_from_numpy_roundtrip():
    params = tckpt.load_params(_ckpt_path("sphere_small"))
    tnet = TorchNetFactory(r_min=2, r_max=32, device="cpu")
    tnet.params_from_numpy(params)
    np.testing.assert_array_equal(tnet.enc.table.detach().numpy(),
                                  params["table"])
    for lin, w, b in zip(tnet.fc, params["mlp"]["w"], params["mlp"]["b"]):
        np.testing.assert_array_equal(lin.weight.detach().numpy().T, w)
        np.testing.assert_array_equal(lin.bias.detach().numpy(), b)


def test_reference_pth_import_matches_jax(tmp_path):
    """A reference-layout state dict (``enc.module.params`` flat, ``fc.i``
    weights [out, in]) loads into both packages with equal outputs."""
    params = tckpt.load_params(_ckpt_path("torus_small"))
    state = {"enc.module.params": torch.from_numpy(params["table"].ravel())}
    for i, (w, b) in enumerate(zip(params["mlp"]["w"], params["mlp"]["b"])):
        state[f"fc.{i}.weight"] = torch.from_numpy(np.ascontiguousarray(w.T))
        state[f"fc.{i}.bias"] = torch.from_numpy(b)
    path = str(tmp_path / "torus_sdf_small_1.pth")
    torch.save(state, path)

    tnet = TorchNetFactory(r_min=2, r_max=32, device="cpu")
    tckpt.load_into(tnet, path)
    jnet = JaxNet(r_min=2, r_max=32, key=jax.random.PRNGKey(1))
    jckpt.load_into(jnet, path)
    x = _points(512, seed=2)
    np.testing.assert_allclose(tnet.outputs(torch.from_numpy(x)).numpy(),
                               np.asarray(jnet.outputs(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


def test_net_for_size_is_seeded_and_needs_a_device():
    from tropical_torch.stanford.model import net_for_size

    a = net_for_size("small", "sphere", 3, device="cpu")
    b = net_for_size("small", "sphere", 3, device="cpu")
    torch.testing.assert_close(a.enc.table, b.enc.table, rtol=0, atol=0)
    assert float(a.enc.table.detach().abs().max()) <= 1e-4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            net_for_size("small", "sphere", 3)
