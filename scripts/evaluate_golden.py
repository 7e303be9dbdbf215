"""Write the golden tables of the ``evaluate`` CLI on sphere-small.

    JAX_PLATFORMS=cpu python scripts/evaluate_golden.py

Runs the JAX package's CLI, ``python -m tropical.stanford.evaluate -d
sphere -m small -s 1``, on the CPU, twice: ``-t mtet`` at the default
``--gt_res`` (256) and ``-t mc --gt_res 128``.  Both score the committed
mesh ``meshes/sphere/our_mesh_small_1.ply`` with 100,000 rays, traced by
the JAX package's default CPU tracer (the C++ host BVH of
``tropical/utils/bvh_host.py``: Moller-Trumbore first hits, as the port's
brute-force tiles find them).  The CLI runs in a temporary directory that
holds a copy of the mesh, so the baseline meshes it writes never touch the
committed ones; the marching-tetrahedra meshes at 16, 32, 48 and 64 are
then held against the committed ``meshes/sphere/mtet0??_mesh_small_1.ply``
(face counts, faces under a nearest-neighbour bijection, and the largest
vertex distance).

Besides the printed table, each row keeps its CD and AD unrounded
(``cd_jax``, ``ad_jax``: the values the CLI's ``chamfer_distance`` and
``angular_distance`` returned) and the CD of the same samples with exact
nearest neighbours (``cd_nn``: a k-d tree in float64).  The two CDs
differ: the JAX package's nearest-neighbour search picks each neighbour by
the expanded form |x|^2 + |y|^2 - 2 x.y, whose cancellation sometimes
picks a farther one, so its CD lies above the exact one.  Each grid
resolution keeps the grid values within ``NEAR_ZERO`` of 0 that the CLI's
net evaluations gave (``near_zero``: ``[i, j, k, value]``).  A grid value
that rounds to exactly 0 in another implementation's field moves the
vertices at that point, so a vertex count is compared once such a value
takes this sign.

Last, ``ours_port_mesh`` scores the port's own mesh of sphere-small, as
its CLI writes it on the CPU (``python -m tropical_torch.stanford.train
-m small -d sphere -s 1 --device cpu``, run in its own process), against
the same 256 pseudo-GT with the same rays: the gap between the port's
mesh and the JAX mesh in the "Ours" row.

It writes ``tests/golden/sphere_small_evaluate_1.json``: per run the
arguments, the on-grid line's count and fraction, each table row (label,
vertices, CD, AD, printed and unrounded, and the exact-neighbour CD), the
near-zero grid values and the run's seconds; the committed meshes' check;
the port mesh's row and its gaps to the JAX mesh's (exact-neighbour CD,
AD).
``chip_smoke.py`` holds the port's CLI on the card to it.  About 30
minutes on 8 cores.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(
    __file__)), ".."))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
from evaluate_table import parse_table  # noqa: E402
OUT = os.path.join(ROOT, "tests", "golden", "sphere_small_evaluate_1.json")
MESH = os.path.join(ROOT, "meshes", "sphere", "our_mesh_small_1.ply")
BASE_ARGV = ["-d", "sphere", "-m", "small", "-s", "1"]
RUNS = {"mtet": ["-t", "mtet"], "mc": ["-t", "mc", "--gt_res", "128"]}
COMMITTED_MT = (16, 32, 48, 64)
# grid values kept per resolution: |value| at most this
NEAR_ZERO = 1e-6
PORT_MESH_ARGV = ["-m", "small", "-d", "sphere", "-s", "1", "--device",
                  "cpu"]


def nearest(a, b):
    """(index of each a row's nearest b row, its distance)."""
    import numpy as np
    from scipy.spatial import cKDTree

    d, idx = cKDTree(np.asarray(b, np.float64)).query(np.asarray(a,
                                                                 np.float64))
    return idx, d


def committed_check(tmp: str) -> dict:
    """The CLI's marching-tetrahedra meshes against the committed ones."""
    import numpy as np

    from tropical.utils.ply import read_ply

    out = {}
    for res in COMMITTED_MT:
        name = f"mtet{res:03d}_mesh_small_1.ply"
        ours = read_ply(os.path.join(tmp, "meshes", "sphere", name))
        ref = read_ply(os.path.join(ROOT, "meshes", "sphere", name))
        idx, d = nearest(ours.vertices, ref.vertices)
        out[str(res)] = {
            "faces": [int(ours.faces.shape[0]), int(ref.faces.shape[0])],
            "bijection": bool(len(np.unique(idx)) == len(idx)
                              == len(ref.vertices)),
            "faces_equal_under_it": bool(
                ours.faces.shape == ref.faces.shape
                and np.array_equal(idx[ours.faces], ref.faces)),
            "max_vertex_distance": float(d.max())}
    return out


def exact_cd(x, y) -> float:
    """The symmetric mean nearest-neighbour distance of two point sets,
    each neighbour found exactly (a k-d tree in float64)."""
    import numpy as np
    from scipy.spatial import cKDTree

    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    return float((cKDTree(x).query(y)[0].mean()
                  + cKDTree(y).query(x)[0].mean()) / 2)


@contextlib.contextmanager
def recorded():
    """Record, while open, the CD and AD the evaluation computes (in call
    order) and the grid values within NEAR_ZERO of 0 (per resolution,
    ``(linear index, value)``)."""
    import numpy as np

    import tropical.utils.chamfer as ch
    import tropical.utils.isosurface as iso

    rec = {"cd": [], "cd_nn": [], "ad": [], "near_zero": {}}
    cd_fn, ad_fn, vals_fn = (ch.chamfer_distance, ch.angular_distance,
                             iso._sdf_grid_vals)

    def cd(x, y):
        out = cd_fn(x, y)
        rec["cd"].append(float(out))
        rec["cd_nn"].append(exact_cd(x, y))
        return out

    def ad(x, y):
        out = ad_fn(x, y)
        rec["ad"].append(float(out[0]))
        return out

    def vals(net, res, canvas, lin0, count, *args, **kwargs):
        out = vals_fn(net, res, canvas, lin0, count, *args, **kwargs)
        near = rec["near_zero"].setdefault(res, set())
        for i in np.nonzero(np.abs(out) <= NEAR_ZERO)[0]:
            near.add((int(lin0 + i), float(out[i])))
        return out

    ch.chamfer_distance, ch.angular_distance, iso._sdf_grid_vals = cd, ad, \
        vals
    try:
        yield rec
    finally:
        ch.chamfer_distance, ch.angular_distance, iso._sdf_grid_vals = \
            cd_fn, ad_fn, vals_fn


def exact_rows(table: dict, rec: dict) -> None:
    """Give each scored row of ``table`` its unrounded CD and AD and its
    exact-neighbour CD from ``rec``.  Every row but the pseudo-GT's (row 1,
    printed as zeros) is scored once, in the table's order."""
    scored = [r for k, r in enumerate(table["rows"]) if k != 1]
    if len(scored) != len(rec["cd"]) or len(scored) != len(rec["ad"]):
        raise RuntimeError(f"{len(scored)} scored rows, {len(rec['cd'])} CDs "
                           f"and {len(rec['ad'])} ADs")
    for r, cd, cd_nn, ad in zip(scored, rec["cd"], rec["cd_nn"], rec["ad"]):
        r.update(cd_jax=cd, cd_nn=cd_nn, ad_jax=ad)
    table["rows"][1].update(cd_jax=0.0, cd_nn=0.0, ad_jax=0.0)


def near_zero_table(rec: dict) -> dict:
    """{res: [[i, j, k, value], ...]} sorted, from ``rec["near_zero"]``."""
    return {str(res): [[lin // res ** 2, lin // res % res, lin % res, v]
                       for lin, v in sorted(found)]
            for res, found in sorted(rec["near_zero"].items())}


def cli_run(method: str) -> dict:
    """One evaluate run in the current directory: its table, unrounded
    scores, near-zero grid values and seconds."""
    from tropical.stanford import evaluate

    argv = BASE_ARGV + RUNS[method]
    buf = io.StringIO()
    t = time.time()
    with recorded() as rec, contextlib.redirect_stdout(buf):
        rc = evaluate.main(argv)
    seconds = time.time() - t
    print(buf.getvalue())
    if rc != 0:
        raise RuntimeError(f"evaluate {argv} returned {rc}")
    table = parse_table(buf.getvalue())
    exact_rows(table, rec)
    return {"argv": argv, "seconds": seconds, **table,
            "near_zero": near_zero_table(rec)}


def port_mesh_row(tmp: str, gt_res: int) -> dict:
    """The port's CPU mesh (its CLI, in its own process) scored as "Ours"
    against the pseudo-GT at ``gt_res``, unrounded, by the JAX package."""
    from tropical.stanford.evaluate import TRAINING_DATA_R
    from tropical.stanford.model import net_for_size
    from tropical.stanford.train import (evaluate_against_grid_gt,
                                         model_path_for)
    from tropical.utils import checkpoint as ckpt
    from tropical.utils.ply import read_ply

    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-m", "tropical_torch.stanford.train",
                    *PORT_MESH_ARGV], cwd=tmp, env=env, check=True,
                   stdout=subprocess.DEVNULL)
    mesh = read_ply(os.path.join(tmp, "meshes_torch", "sphere",
                                 "our_mesh_small_1.ply"))
    net = net_for_size("small", "sphere", 1)
    ckpt.load_into(net, ckpt.find_checkpoint(model_path_for("sphere", "small",
                                                            1)))
    out_dir = os.path.join(tmp, "port_scored")
    os.makedirs(out_dir)
    buf = io.StringIO()
    with recorded() as rec, contextlib.redirect_stdout(buf):
        evaluate_against_grid_gt(net, mesh, -1.0, TRAINING_DATA_R,
                                 gt_res, out_dir, "port",
                                 resolutions=[gt_res])
    row = parse_table(buf.getvalue())["rows"][0]
    return {"argv": PORT_MESH_ARGV, "gt_res": gt_res, "label": row["label"],
            "vertices": row["vertices"], "cd": row["cd"], "ad": row["ad"],
            "cd_jax": rec["cd"][0], "cd_nn": rec["cd_nn"][0],
            "ad_jax": rec["ad"][0]}


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")

    golden = {"mesh": "meshes/sphere/our_mesh_small_1.ply", "rays": 100000,
              "tracer": "tropical/utils/bvh_host.py (C++ host BVH, CPU)",
              "near_zero_limit": NEAR_ZERO, "runs": {}}
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "meshes", "sphere"))
        shutil.copy(MESH, os.path.join(tmp, "meshes", "sphere"))
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            for method in RUNS:
                golden["runs"][method] = cli_run(method)
        finally:
            os.chdir(cwd)
        golden["committed_mtet"] = committed_check(tmp)
        gt_res = int(golden["runs"]["mtet"]["rows"][1]["label"])
        ours = golden["runs"]["mtet"]["rows"][0]
        port = port_mesh_row(tmp, gt_res)
        port.update(cd_gap=port["cd_nn"] - ours["cd_nn"],
                    ad_gap=port["ad_jax"] - ours["ad_jax"])
        golden["ours_port_mesh"] = port
    golden["seconds"] = time.time() - t0
    with open(OUT, "w") as f:
        json.dump(golden, f, indent=1)
        f.write("\n")
    print(json.dumps({"committed_mtet": golden["committed_mtet"],
                      "ours_port_mesh": golden["ours_port_mesh"]}))
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
