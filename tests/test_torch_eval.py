"""Parity of the port's evaluation path with the JAX package on the CPU.

Marching cubes tables and topology are exact.  The SDF grid values differ
by f32 rounding (matrix-product order, tanh), so meshes are compared vertex
for vertex within 1e-6 after matching each vertex to its nearest twin.  The
ray tracer is Möller-Trumbore in both; its hit points agree within 1e-6.
The CD/AD table is compared as printed (6 and 1 decimals).

The evaluation runs 8,192 rays here instead of the CLI's 100,000: the
brute-force ray tracer on the CPU is the test's cost, and the comparison
does not need more.
"""

import io
import os
import re
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from tropical.utils import marching_cubes as jmc
from tropical_torch.utils import marching_cubes as tmc

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(ROOT, "tropical/stanford/models/sphere/sphere_sdf_small_1.pth.npz")
N_RAYS = 8192


def _nets():
    from tropical.stanford.model import Net
    from tropical.utils import checkpoint as jckpt
    from tropical_torch.stanford.model import Net as TNet
    from tropical_torch.utils import checkpoint as tckpt

    jnet = Net(r_min=2, r_max=32, key=jax.random.PRNGKey(1))
    jckpt.load_into(jnet, CKPT)
    tnet = TNet(r_min=2, r_max=32, device="cpu")
    tckpt.load_into(tnet, CKPT)
    return jnet, tnet


def _match(v_port, v_ref, atol):
    """Index of each port vertex's nearest reference vertex; asserts the
    match is a bijection within ``atol``."""
    from tropical_torch.ops.chamfer import min_dist_plain

    d2, idx = min_dist_plain(torch.from_numpy(np.asarray(v_port, np.float32)),
                             torch.from_numpy(np.asarray(v_ref, np.float32)))
    idx = idx.numpy().astype(np.int64)
    np.testing.assert_allclose(v_port, np.asarray(v_ref)[idx], rtol=0,
                               atol=atol)
    assert len(np.unique(idx)) == len(idx) == len(v_ref)
    return idx


def test_mc_tables_equal_jax():
    np.testing.assert_array_equal(tmc._TRI_TABLE, jmc._TRI_TABLE)
    np.testing.assert_array_equal(tmc._NTRIS, jmc._NTRIS)


@pytest.mark.parametrize("seed", [0, 1])
def test_mc_core_bitwise_on_seeded_field(seed):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(9, 11, 10))
    xs = np.linspace(-1, 1, 9, dtype=np.float32)
    ys = np.linspace(-1.2, 1, 11, dtype=np.float32)
    zs = np.linspace(-1, 0.7, 10, dtype=np.float32)
    v_j, t_j = jmc.marching_cubes(vals, xs, ys, zs)
    v_t, t_t = tmc.marching_cubes(*(torch.from_numpy(a) for a in
                                    (vals, xs, ys, zs)))
    np.testing.assert_array_equal(v_t.numpy(), v_j)
    np.testing.assert_array_equal(t_t.numpy(), t_j)


def test_run_marching_cubes_matches_jax_cpu_path():
    jnet, tnet = _nets()
    m_j = jmc.run_marching_cubes(jnet, 32, 1.2, R=0.8)
    m_t = tmc.run_marching_cubes(tnet, 32, 1.2, R=0.8)
    assert m_t.vertices.shape == m_j.vertices.shape
    assert m_t.faces.shape == m_j.faces.shape
    idx = _match(m_t.vertices, m_j.vertices, atol=1e-6)
    np.testing.assert_array_equal(idx[m_t.faces], m_j.faces)


def test_ray_trace_matches_jax_on_icosphere():
    from tropical.ops.mesh_queries import MeshQuery as JMQ
    from tropical.utils.chamfer import get_rays as jrays
    from tropical.utils.procedural import icosphere
    from tropical_torch.ops.mesh_queries import MeshQuery as TMQ
    from tropical_torch.utils.chamfer import get_rays

    mesh = icosphere(3)
    o_j, d_j = jrays(3000)
    o_t, d_t = get_rays(3000, device="cpu")
    np.testing.assert_array_equal(d_t.numpy(), d_j)
    # off-centre origins exercise misses and grazing hits too
    o = np.random.default_rng(0).uniform(-1.5, 1.5, (3000, 3)).astype(np.float32)
    pos_j, fid_j, t_j = JMQ(mesh.vertices, mesh.faces).ray_trace(o, d_j)
    pos_t, fid_t, t_t = TMQ(mesh.vertices, mesh.faces, "cpu").ray_trace(
        torch.from_numpy(o), d_t)
    assert (fid_j < 0).any() and (fid_j >= 0).any()
    np.testing.assert_array_equal(fid_t.numpy() < 0, fid_j < 0)
    assert (fid_t.numpy() == fid_j).mean() > 0.999  # edge hits may swap faces
    np.testing.assert_allclose(t_t.numpy(), t_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(pos_t.numpy(), pos_j, rtol=0, atol=1e-6)


def _rows(text):
    return re.findall(r"^(Ours|\s*\d+), +(\d+), ([\d.]+), +([\d.]+), ",
                      text, re.M)


def test_evaluate_against_grid_gt_matches_jax(monkeypatch, tmp_path):
    import tropical.stanford.train as jtrain
    import tropical.utils.chamfer as jchamfer
    import tropical_torch.stanford.train as ttrain
    import tropical_torch.utils.chamfer as tchamfer
    from tropical.utils.ply import read_ply

    jnet, tnet = _nets()
    mesh = read_ply(os.path.join(ROOT, "meshes/sphere/our_mesh_small_1.ply"))
    monkeypatch.setenv("TROPICAL_RAYS", "tpu")  # JAX's brute-force tracer
    jget, tget = jchamfer.get_rays, tchamfer.get_rays
    monkeypatch.setattr(jchamfer, "get_rays", lambda n, rng=None: jget(N_RAYS))
    monkeypatch.setattr(tchamfer, "get_rays",
                        lambda n, rng=None, *, device: tget(N_RAYS,
                                                            device=device))
    outs = []
    for mod, net, sub in ((jtrain, jnet, "jax"), (ttrain, tnet, "torch")):
        os.makedirs(tmp_path / sub)
        buf = io.StringIO()
        with redirect_stdout(buf):
            mod.evaluate_against_grid_gt(net, mesh, 1.0, 0.8, 32,
                                         str(tmp_path / sub), "t",
                                         resolutions=[32, 16])
        outs.append(_rows(buf.getvalue()))
    rows_j, rows_t = outs
    assert [r[0].strip() for r in rows_t] == ["Ours", "32", "16"]
    assert [r[:2] for r in rows_t] == [r[:2] for r in rows_j]
    for rj, rt in zip(rows_j, rows_t):
        assert abs(float(rt[2]) - float(rj[2])) <= 1e-6, (rj, rt)
        assert abs(float(rt[3]) - float(rj[3])) <= 0.1, (rj, rt)
    assert float(rows_t[0][2]) > 0


def test_cli_cache_hit_path_on_cpu(monkeypatch, tmp_path):
    """The CLI without -e: golden funnel, and the exported mesh is the
    committed JAX one within 1e-4."""
    from tropical_torch.extract import stats
    from tropical_torch.stanford.train import main
    from tropical_torch.utils.ply import read_ply

    monkeypatch.chdir(tmp_path)
    argv = ["-m", "small", "-d", "sphere", "-s", "1"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
    assert main(argv + ["--device", "cpu"]) == 0
    assert stats.LAST == {"pre_v": 51455, "pre_e": 69581, "post_v": 10138,
                          "post_e": 20396, "n_faces": 20336}
    ours = read_ply(str(tmp_path / "meshes_torch/sphere/our_mesh_small_1.ply"))
    ref = read_ply(os.path.join(ROOT, "meshes/sphere/our_mesh_small_1.ply"))
    assert ours.faces.shape == ref.faces.shape
    idx = _match(ours.vertices, ref.vertices, atol=1e-4)
    assert (idx == np.arange(len(idx))).mean() > 0.99
    # -c skips the cache and trains (here cut short before any step)
    from tropical_torch.stanford import train as cli

    class Trained(Exception):
        pass

    def fake_train(net, args, device):
        assert not args.cache and device.type == "cpu"
        raise Trained

    monkeypatch.setattr(cli, "train_net", fake_train)
    with pytest.raises(Trained):
        main(argv + ["--device", "cpu", "-c"])
