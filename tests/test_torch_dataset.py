"""Parity of the port's training data with the JAX package on the CPU.

- ``icosphere(4)`` and ``torus()``: equal bit for bit (the same numpy code);
- signed distance: 4,096 seeded points near each mesh; distances within
  2e-7 (measured 8.9e-8 on the sphere, 6.0e-8 on the torus: XLA contracts
  the closest-point arithmetic into FMAs, torch rounds every product),
  signs equal wherever |distance| > 1e-5 (no sign differs at all here);
- ``StanfordDataset("sphere", n_samples=2000)``: the points and the batch
  order equal bit for bit (one generator, its calls in one order), labels
  within 2e-7;
- the PLY path, on a torus written with ``utils/ply``;
- ``bunny_npy``: the mesh marching tetrahedra rebuild from a synthetic
  density grid bitwise JAX's, points bitwise, labels within 2e-7.
"""

import os

import jax
import numpy as np
import pytest
import torch

from tropical.ops.mesh_queries import MeshQuery as JaxMeshQuery
from tropical.stanford import dataset as jds
from tropical.utils import procedural as jproc
from tropical_torch.ops.mesh_queries import MeshQuery
from tropical_torch.stanford import dataset as tds
from tropical_torch.utils import procedural as tproc
from tropical_torch.utils.ply import write_ply

DIST_ATOL = 2e-7
SIGN_MARGIN = 1e-5


@pytest.mark.parametrize("name", ["icosphere", "torus"])
def test_procedural_meshes_bitwise(name):
    if name == "icosphere":
        want, got = jproc.icosphere(4), tproc.icosphere(4)
        assert got.faces.shape == (5120, 3)
    else:
        want, got = jproc.torus(), tproc.torus()
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.faces, want.faces)
    assert got.vertices.dtype == want.vertices.dtype
    assert got.faces.dtype == want.faces.dtype


def _near(mesh, n=4096, seed=0):
    """Points within 0.2 of the mesh's vertices, some on them exactly."""
    rng = np.random.default_rng(seed)
    v = np.asarray(mesh.vertices, np.float32)
    p = v[rng.integers(0, len(v), n)] + rng.normal(
        scale=0.1, size=(n, 3)).astype(np.float32)
    p[:64] = v[:64]
    return p.astype(np.float32)


@pytest.mark.parametrize("name", ["icosphere", "torus"])
def test_signed_distance_against_jax(name):
    mesh = jproc.icosphere(4) if name == "icosphere" else jproc.torus()
    p = _near(mesh)
    want = JaxMeshQuery(mesh.vertices, mesh.faces).signed_distance(p)
    q = MeshQuery(mesh.vertices, mesh.faces, "cpu")
    got = q.signed_distance(torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(np.abs(got), np.abs(want), rtol=0,
                               atol=DIST_ATOL)
    away = np.abs(want) > SIGN_MARGIN
    assert away.mean() > 0.9
    np.testing.assert_array_equal(np.sign(got[away]), np.sign(want[away]))
    # both signs occur, and the vertices themselves are at distance 0
    assert (want[away] > 0).any() and (want[away] < 0).any()
    assert np.abs(got[:64]).max() == 0.0
    np.testing.assert_array_equal(
        q.unsigned_distance(torch.from_numpy(p[:256])).numpy(),
        np.abs(got[:256]))


def test_sphere_dataset_against_jax():
    jdata = jds.StanfordDataset("sphere", rng=np.random.default_rng(5),
                                n_samples=2000)
    tdata = tds.StanfordDataset("sphere", rng=np.random.default_rng(5),
                                n_samples=2000, device="cpu")
    for resample in (False, True):
        if resample:
            jdata.resample()
            tdata.resample()
        np.testing.assert_array_equal(tdata.X.numpy(), jdata.X)
        np.testing.assert_allclose(tdata.Y.numpy(), jdata.Y, rtol=0,
                                   atol=DIST_ATOL)
        jb = list(jdata.batches(512))
        tb = list(tdata.batches(512))
        assert [len(b[0]) for b in tb] == [512, 512, 512, 464]
        for (jx, jy), (tx, ty) in zip(jb, tb):
            np.testing.assert_array_equal(tx.numpy(), jx)
            np.testing.assert_allclose(ty.numpy(), jy, rtol=0, atol=DIST_ATOL)
    assert tdata.R == jdata.R
    assert tdata.Y.dtype == torch.float32 and tdata.X.device.type == "cpu"


def test_ply_dataset_path(tmp_path, monkeypatch):
    """A scan is read from its PLY, normalised and labelled as the JAX
    package does it."""
    mesh = jproc.torus(nu=48, nv=24)
    for mod in (jds, tds):
        root = tmp_path / mod.__name__
        path = root / "bunny" / "reconstruction" / "bun_zipper.ply"
        os.makedirs(path.parent)
        write_ply(str(path), mesh.vertices * 3.0 + 1.0, mesh.faces)
        monkeypatch.setattr(mod, "BASE_DIR" if mod is jds else "SCANS_DIR",
                            str(root))
    jdata = jds.StanfordDataset("bunny", rng=np.random.default_rng(2),
                                n_samples=1000)
    tdata = tds.StanfordDataset("bunny", rng=np.random.default_rng(2),
                                n_samples=1000, device="cpu")
    np.testing.assert_array_equal(tdata.mesh.vertices, jdata.mesh.vertices)
    np.testing.assert_array_equal(tdata.X.numpy(), jdata.X)
    np.testing.assert_allclose(tdata.Y.numpy(), jdata.Y, rtol=0,
                               atol=DIST_ATOL)


def _sphere_density(n=16, radius=5.0):
    """An n^3 density grid, positive inside a sphere of ``radius`` cells
    about the grid's centre."""
    g = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), -1)
    return (radius - np.linalg.norm(g - (n - 1) / 2, axis=-1)).astype(
        np.float32)


def test_bunny_npy_dataset_against_jax(tmp_path, monkeypatch):
    """``bunny_npy`` on a synthetic 16^3 density grid written where both
    packages read ``models/bunny.npy``: the mesh marching tetrahedra
    rebuild from it bitwise JAX's (vertices in [-R, R], not renormalised),
    the points bitwise, the labels within DIST_ATOL."""
    models = tmp_path / "models"
    models.mkdir()
    np.save(models / "bunny.npy", _sphere_density())
    monkeypatch.setattr(jds, "BASE_DIR", str(tmp_path))
    monkeypatch.setattr(tds, "SCANS_DIR", str(tmp_path))
    jdata = jds.StanfordDataset("bunny_npy", rng=np.random.default_rng(3),
                                n_samples=1000)
    tdata = tds.StanfordDataset("bunny_npy", rng=np.random.default_rng(3),
                                n_samples=1000, device="cpu")
    assert jdata.mesh.faces.shape[0] > 100
    np.testing.assert_array_equal(tdata.mesh.vertices, jdata.mesh.vertices)
    np.testing.assert_array_equal(tdata.mesh.faces, jdata.mesh.faces)
    assert tdata.mesh.vertices.dtype == jdata.mesh.vertices.dtype
    assert np.abs(tdata.mesh.vertices).max() <= tdata.R
    np.testing.assert_array_equal(tdata.X.numpy(), jdata.X)
    np.testing.assert_allclose(tdata.Y.numpy(), jdata.Y, rtol=0,
                               atol=DIST_ATOL)
    assert (jdata.Y > 0).any() and (jdata.Y < 0).any()


def test_dataset_names():
    with pytest.raises(FileNotFoundError, match="bunny.npy"):
        tds.StanfordDataset("bunny_npy", device="cpu")
    with pytest.raises(ValueError, match="unknown dataset"):
        tds.StanfordDataset("teapot", device="cpu")
    with pytest.raises(FileNotFoundError, match="Stanford scans"):
        tds.StanfordDataset("lucy", device="cpu")
