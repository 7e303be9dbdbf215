"""Parity of the port's ``evaluate`` CLI with the JAX package's on the CPU.

Both CLIs score the committed JAX mesh of sphere-small against a
marching-cubes pseudo-GT at 32 with marching-cubes (``-t mc``) or
marching-tetrahedra (``-t mtet``) baselines below it.  The on-grid count
must be equal, and every row of the table: vertex counts exact, CD within
1e-6 and AD within 0.1 (the printed digits; the two nets' fields differ by
f32 rounding of the MLP, so the meshes and hit points differ in the last
digits).  8,192 rays instead of 100,000, as ``test_torch_eval.py``
traces.
"""

import io
import os
import shutil
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from test_torch_eval import N_RAYS, ROOT, _nets, _rows

MESH = os.path.join(ROOT, "meshes/sphere/our_mesh_small_1.ply")
# the golden writer's score recorder
sys.path.insert(0, os.path.join(ROOT, "scripts"))


@pytest.fixture
def few_rays(monkeypatch):
    """Both packages' evaluations trace N_RAYS rays, JAX's through its host
    BVH (the same Moller-Trumbore first hits as the port's tiles)."""
    import tropical.utils.chamfer as jchamfer
    import tropical_torch.utils.chamfer as tchamfer

    jget, tget = jchamfer.get_rays, tchamfer.get_rays
    monkeypatch.setattr(jchamfer, "get_rays", lambda n, rng=None: jget(N_RAYS))
    monkeypatch.setattr(tchamfer, "get_rays",
                        lambda n, rng=None, *, device: tget(N_RAYS,
                                                            device=device))


def _assert_rows_match(rows_t, rows_j, labels):
    assert [r[0].strip() for r in rows_t] == labels
    assert [r[:2] for r in rows_t] == [r[:2] for r in rows_j]
    for rj, rt in zip(rows_j, rows_t):
        assert abs(float(rt[2]) - float(rj[2])) <= 1e-6, (rj, rt)
        assert abs(float(rt[3]) - float(rj[3])) <= 0.1, (rj, rt)
    assert float(rows_t[0][2]) > 0


def test_evaluate_against_grid_gt_mtet_matches_jax(few_rays, tmp_path):
    """The printed tables match; so do the port's returned rows, unrounded,
    and JAX's evaluation (recorded as ``scripts/evaluate_golden.py``
    records the golden): the CD of JAX's samples with exact nearest
    neighbours, and JAX's AD."""
    import tropical.stanford.train as jtrain
    import tropical_torch.stanford.train as ttrain
    from evaluate_golden import exact_rows, recorded
    from evaluate_table import parse_table
    from tropical.utils.ply import read_ply

    jnet, tnet = _nets()
    mesh = read_ply(MESH)
    outs, recs = [], []
    for mod, net, sub in ((jtrain, jnet, "jax"), (ttrain, tnet, "torch")):
        os.makedirs(tmp_path / sub)
        buf = io.StringIO()
        with recorded() as rec, redirect_stdout(buf):
            returned = mod.evaluate_against_grid_gt(
                net, mesh, 1.0, 0.8, 32, str(tmp_path / sub), "t",
                resolutions=[32, 16], method="mtet")
        outs.append(buf.getvalue())
        recs.append(rec)
    assert "Marching Tetrahedra Results:" in outs[1]
    _assert_rows_match(_rows(outs[1]), _rows(outs[0]), ["Ours", "32", "16"])

    golden = parse_table(outs[0])
    exact_rows(golden, recs[0])
    assert recs[1]["cd"] == []  # the port computes its own
    printed = parse_table(outs[1])["rows"]
    assert [(r["label"], r["vertices"], f"{r['cd']:0.6f}", f"{r['ad']:4.1f}")
            for r in printed] == [(lb, n, f"{cd:0.6f}", f"{ad:4.1f}")
                                  for lb, n, cd, ad, _ in returned]
    for (lb, n, cd, ad, _), g in zip(returned, golden["rows"]):
        assert n == g["vertices"]
        assert abs(cd - g["cd_nn"]) <= 1e-6, (lb, cd, g)
        assert abs(ad - g["ad_jax"]) <= 0.1, (lb, ad, g)
    # the pseudo-GT row is marching cubes, named by the method as JAX's is
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(
        os.listdir(tmp_path / "jax")) == ["mtet016_mesh_t.ply",
                                          "mtet032_mesh_t.ply"]


@pytest.mark.parametrize("method,labels", [("mtet", ["Ours", "32", "16"]),
                                           ("mc", ["Ours", "32", "16", "24"])])
def test_cli_matches_jax(few_rays, monkeypatch, tmp_path, method, labels):
    from evaluate_table import parse_table
    from tropical.stanford import evaluate as jeval
    from tropical_torch.stanford import evaluate as teval

    monkeypatch.chdir(tmp_path)
    for d in ("meshes", "meshes_torch"):
        os.makedirs(f"{d}/sphere")
        shutil.copy(MESH, f"{d}/sphere/our_mesh_small_1.ply")
    argv = ["-d", "sphere", "-m", "small", "-s", "1", "-t", method,
            "--gt_res", "32"]
    outs = []
    for main, extra in ((jeval.main, []), (teval.main, ["--device", "cpu"])):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main(argv + extra) == 0
        outs.append(buf.getvalue())
    text_j, text_t = outs
    table_j, table_t = parse_table(text_j), parse_table(text_t)
    assert table_t["on_grid"] == table_j["on_grid"] == 10138
    assert table_t["on_grid_frac"] == table_j["on_grid_frac"]
    _assert_rows_match(_rows(text_t), _rows(text_j), labels)
    want = sorted(f"{method}{r:03d}_mesh_small_1.ply" for r in
                  map(int, labels[1:]))
    assert sorted(p for p in os.listdir("meshes_torch/sphere")
                  if p.startswith(method)) == want


def test_ladders_match_jax():
    """The resolution ladders of both methods and sizes, and the gt_res
    default, as the JAX CLI builds them."""
    from tropical_torch.stanford.evaluate import resolutions_for

    assert resolutions_for("mc", "small", 256) == [256, 16, 24, 32, 40, 48,
                                                  56, 64, 128, 192, 224]
    assert resolutions_for("mtet", "small", 256) == [256, 16, 32, 48, 64, 96]
    assert resolutions_for("mtet", "large", 512) == [512, 16, 32, 48, 64, 96,
                                                    128, 192]
    assert resolutions_for("mc", "small", 128) == [128, 16, 24, 32, 40, 48,
                                                  56, 64]
    assert resolutions_for("mtet", "small", 32) == [32, 16]


def test_count_vertices_near_values_matches_jax():
    from tropical.stanford.evaluate import count_vertices_near_values as jc
    from tropical_torch.stanford.evaluate import count_vertices_near_values

    rng = np.random.default_rng(0)
    v = rng.uniform(-1, 1, (2000, 3)).astype(np.float32)
    marks = np.linspace(-1, 1, 9, dtype=np.float32)
    v[:300, 1] = marks[rng.integers(0, 9, 300)] + rng.uniform(
        -2e-4, 2e-4, 300).astype(np.float32)
    assert count_vertices_near_values(v, marks) == jc(v, marks) > 0


@pytest.mark.parametrize("argv,message", [
    (["-d", "torus", "-m", "medium", "-s", "1"], "Model path is not found"),
    (["-d", "sphere", "-m", "small", "-s", "1"], "Mesh path is not found")])
def test_missing_model_or_mesh_returns_1(monkeypatch, tmp_path, argv,
                                         message):
    from tropical.stanford import evaluate as jeval
    from tropical_torch.stanford import evaluate as teval

    monkeypatch.chdir(tmp_path)
    for main, extra in ((jeval.main, []), (teval.main, ["--device", "cpu"])):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main(argv + extra) == 1
        assert message in buf.getvalue()


def test_cli_defaults_to_the_card(monkeypatch, tmp_path):
    from tropical_torch.stanford.evaluate import main

    monkeypatch.chdir(tmp_path)
    argv = ["-d", "sphere", "-m", "small", "-s", "1"]
    if torch.cuda.is_available():
        assert main(argv) == 1  # no mesh here
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)

