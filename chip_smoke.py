#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``tropical_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each fatal on failure:

1. device: the card's name and power limit;
2. build: every kernel of the main paths from ``tropical_torch/csrc/`` (one
   ``nvcc`` per source, all started together), with the ``-Xptxas -v``
   register and shared-memory summary; no spills;
3. kernels vs plain: each kernel against its plain PyTorch version, bit for
   bit (the encode's table gradients, scattered by atomicAdd, to a stated
   tolerance), on inputs hard for it.  ``min_dist`` at the flat path's shapes, its
   launch plan and the share of its work that took the exact path (from an
   instrumented build), then kernel, plain and library times (CUDA
   events); ``trilinear_roots`` on the rows of
   ``tests/trilinear_cases.py:kernel_pq`` and 100,000 seeded rows; the
   encode's forward, backward (also in x alone, as the normals take it)
   and double backward on the small, medium and large grids (the large one
   hashes a level) at B = 0, 1, 1,000 and 278,528, and on sphere-small with
   every point in one cell of every level, with every point on cell
   boundaries, far outside the cube (dense bases past int32) and at a
   ragged B = 100,003, on grids of 1, 5 and 16 levels and on a grid whose
   corner indices wrap past the int64 limit, the scatters' spread printed;
   timed at B = 1,000, beside a CUDA graph's cost of one node;
4. flat main path: the CLI ``-e -m small -d sphere -s 1 --gt_res 128`` on
   ``cuda``, held to the golden funnel, the committed mesh and the kernel
   launch counts (the encode's forward on every net evaluation, its
   backward for the faces' normals, in x alone: no backward of the flat or
   the curved run scatters a table gradient);
5. curved main path: the CLI ``-e -m medium -d sphere -s 1 -f --gt_res
   128`` on ``cuda``, held to the golden funnel (or, where only eps-boundary
   flips move it, to the committed JAX vertex set), |sdf| < 2e-4 on every
   vertex, the launch counts (one ``trilinear_roots`` launch per insertion
   step with curved rows) and finite CD/AD;
6. each kernel at the largest shape its main path gave it: ``min_dist``
   timed; ``trilinear_roots`` held bitwise to its plain version on every
   input the curved path gave it, their device times summed beside the
   extraction's ``take``, and on the largest of them and on the 100,000
   seeded rows its device time (a CUDA graph of calls, ``graph_ms``), one
   wrapper call, the plain version and ``torch.linalg.eigvals`` on the
   companion matrices timed; the three hash-grid encode kernels held to
   their plain versions and timed at the flat run's largest forward and at
   its largest backward (the faces' normals), and the forward also on that
   largest forward's own points, a marching-cubes slab at 128;
7. training path: ``train()`` on the sphere dataset at sphere-small's full
   width (10 epochs of 50 steps of 1,000 points) from the JAX initial
   params in ``tests/golden/sphere_small_train_1.npz``
   (``scripts/train_golden.py``): one forward, two backwards and one double
   backward of the encode a step, each backward scattering its table
   gradient; every 10-step window of the losses held
   to the golden's JAX runs (``golden_verdict``) and the sdf at its probes
   to twice the one-ulp JAX witness's spread, and the same check shown to
   fail a run with the double backward's table gradient zeroed;
   the trained net extracted on the flat path and evaluated at ``--gt_res
   128``, its "Ours" CD at most twice the committed checkpoint's (phase 4);
   a training step timed with the kernels and with the plain encode, the
   labels' time per epoch, each epoch and the whole run, and the device's
   busy share over ten steps (torch.profiler);
8. training CLI: ``python -m tropical_torch.stanford.train -c -m small -d
   sphere -s 1 --epochs 1`` in a process of its own: it trains, extracts,
   and writes nothing under ``tropical/`` nor a checkpoint;
9. evaluate CLI: ``python -m tropical_torch.stanford.evaluate -d sphere -m
   small -s 1 -t mtet`` (pseudo-GT at 256, marching tetrahedra at 16..96)
   and ``... -t mc --gt_res 128``, in-process on phase 4's mesh: every row
   of each table (unrounded) and the on-grid count held to the JAX CLI's
   (``tests/golden/sphere_small_evaluate_1.json``,
   ``scripts/evaluate_golden.py``), a row's vertex count exactly once the
   grid values that are exactly 0 in the port's field take JAX's; the
   launches (the encode forward once a grid slab, ``min_dist`` twice a
   scored row), the stage times; the exported tetrahedra meshes at 16..64
   against the committed ones; marching tetrahedra at 48 on the card
   bitwise the CPU's over the card's field; every crossing on the slabs'
   shared planes merged (tetrahedra at 32..96, cubes at 128 and 256); the
   encode forward at the run's largest forward (the 256 pseudo-GT's first
   slab, 17 * 256^2 points) bitwise its plain version and timed;
10. one JSON line of kernel records, the card's line, and the result line.

It exits non-zero without a result line when CUDA is unavailable or the
package is missing.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import math
import os
import re
import subprocess
import sys
import time

# the evaluation stage timers read this when the package is imported
os.environ["TROPICAL_PROFILE"] = "1"

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
PEAK_F32_OPS = 67e12
# an unfused f32 product or sum issues as one instruction, at half the rate
# the FMA-counting peak gives
PEAK_F32_UNFUSED_OPS = PEAK_F32_OPS / 2
PEAK_BYTES = 3.35e12

GOLDEN = {"pre_v": 51455, "pre_e": 69581, "post_v": 10138, "post_e": 20396,
          "n_faces": 20336}
MAIN_ARGV = ["-e", "-m", "small", "-d", "sphere", "-s", "1", "--gt_res", "128"]
# tests/golden/self_golden.json "sphere_medium_curved"
CURVED_GOLDEN = {"pre_v": 154654, "pre_e": 231531, "post_v": 43493,
                 "post_e": 87795, "n_faces": 87142}
CURVED_ARGV = ["-e", "-m", "medium", "-d", "sphere", "-s", "1", "-f",
               "--gt_res", "128"]
# the JAX host engine's vertices of that extraction (scripts/curved_golden.py)
CURVED_VERTICES = "tests/golden/sphere_medium_curved_vertices.npy"
# "Ours" plus the seven MC rows 16..64 below the 128 pseudo-GT, two
# nearest-neighbour searches each
MAIN_LAUNCHES = {"min_dist": 16, "trilinear_roots": 0}
# each kernel's time before its redesign, for the printed comparison only
# (H100 80GB HBM3, 700 W; min_dist at 100k x 100k, trilinear_roots' device
# time at the curved run's largest input, B = 8,460)
PREV_MS = {"min_dist": 4.486, "trilinear_roots": 0.0563}
# the encode kernels' device times before their redesigns, by B (H100 80GB
# HBM3, 700 W; for the printed comparison only)
PREV_ENCODE_MS = {"hashgrid_encode_fwd": {1000: 0.0054, 10171: 0.0065,
                                          278528: 0.0440},
                  "hashgrid_encode_bwd": {1000: 0.0147, 278528: 3.007},
                  "hashgrid_encode_bwd_bwd": {1000: 0.0134, 278528: 3.014}}
# the flat run's largest forward is its first marching-cubes slab at 128
# (SLAB + 1 x-planes of 128 x 128 points; later slabs evaluate SLAB, the
# shared plane reused); the one timed has SLAB + 1 planes from this x
# index, through the middle of the sphere
SLAB_RES, SLAB_X0 = 128, 48

EXACT_COUNT = ("min_dist", ("MIN_DIST_COUNT_EXACT",))
ENCODE = ("hashgrid_encode_fwd", "hashgrid_encode_bwd",
          "hashgrid_encode_bwd_bwd")
ENCODE_REPLACES = {"hashgrid_encode_fwd": "tropical/core/hashgrid.py:163",
                   "hashgrid_encode_bwd": "tropical/stanford/training.py:42",
                   "hashgrid_encode_bwd_bwd": "tropical/stanford/training.py:65"}
# float operations a (point, level) of each encode kernel, unfused (counted
# in csrc/hashgrid_encode.cu: the cell, then per corner the weight, the
# gather's products and sums, the gradients' products and sums)
ENCODE_OPS = {"hashgrid_encode_fwd": 61, "hashgrid_encode_bwd": 150,
              "hashgrid_encode_bwd_bwd": 250}
# the table gradients are atomicAdd scatters in a free order (and so is
# index_add_, the plain version's, on the card): a row that sums n terms in
# another order moves by about 2^-24 sqrt(n) of its size, and a row takes
# at most one term a point and corner.  Held: within SCATTER_ULPS 2^-24
# sqrt(B) of the plain version's largest row (measured 0.3 to 1.0 of
# 2^-24 sqrt(B) at B = 1,000 and 278,528)
SCATTER_ULPS = 4.0
# encode launches of the flat and curved CLI runs, one a net evaluation
# with rows and one backward a normal() call (counted on the CPU with the
# plain versions): flat, 17 forwards in the extraction (the largest
# 117,649 rows) and 27 in the MC ladder (the largest, 278,528 rows, a
# slab at 128), the faces' normals once; curved, 46 forwards in the
# extraction and 27 in the ladder, the faces' normals once, and one forward
# and one backward a step of the GD rescue (``failover.COUNTERS``; 3 steps
# on the CPU)
FLAT_ENCODE = {"hashgrid_encode_fwd": 44, "hashgrid_encode_bwd": 1,
               "hashgrid_encode_bwd_bwd": 0}
CURVED_ENCODE = {"hashgrid_encode_fwd": 73, "hashgrid_encode_bwd": 1,
                 "hashgrid_encode_bwd_bwd": 0}
TRAIN_GOLDEN = "tests/golden/sphere_small_train_1.npz"
TRAIN_EPOCHS, TRAIN_BATCH, TRAIN_SEED = 10, 1000, 1
# a step: the forward, the backward for J and for the loss, and the double
# backward the eikonal term's create_graph adds
STEP_LAUNCHES = {"hashgrid_encode_fwd": 1, "hashgrid_encode_bwd": 2,
                 "hashgrid_encode_bwd_bwd": 1}
# the port's losses are held per window of this many steps
WINDOW = 10
CLI_TRAIN_ARGV = ["-c", "-m", "small", "-d", "sphere", "-s", "1",
                  "--epochs", "1"]
# the evaluate CLI on phase 4's mesh: -t mtet at its default --gt_res (256)
# and -t mc at 128, held to the JAX CLI's tables on the committed mesh
# (scripts/evaluate_golden.py, JAX on the CPU, 100,000 rays)
EVAL_ARGV = {"mtet": ["-d", "sphere", "-m", "small", "-s", "1", "-t", "mtet"],
             "mc": ["-d", "sphere", "-m", "small", "-s", "1", "-t", "mc",
                    "--gt_res", "128"]}
EVAL_GOLDEN = "tests/golden/sphere_small_evaluate_1.json"
# a row: CD and AD, unrounded, to these of the golden's: the CD of JAX's
# samples with exact nearest neighbours ("cd_nn"; JAX's own CD lies up to
# some 1e-6 above it, its search picking neighbours by the expanded form),
# JAX's AD.  The "Ours" row scores the port's mesh, not the JAX mesh of
# the golden: the golden's "ours_port_mesh" measures the gap between the
# two meshes' "Ours" CD on the CPU at 256 with 100,000 rays, far inside
# the same 1e-6.  A row's vertex count is exact.  A grid value exactly 0 in the port's field and
# not in JAX's (f32 rounding of the MLP; sphere-small at 256 has one, on
# the CPU and on the card, where JAX's value is 4.47e-8) moves the vertices
# at that point: such a row is rebuilt with JAX's value there (the
# golden's "near_zero"), and that count must be the golden's
EVAL_CD_TOL, EVAL_AD_TOL = 1e-6, 0.1
# the card's marching-tetrahedra meshes against the committed TPU-written
# ones: the same topology, vertices within this (JAX on the CPU reproduces
# them to 3.5e-5, tests/test_torch_isosurface.py)
COMMITTED_MT_TOL = 1e-4
MT_BITWISE_RES = 48
# the -t mtet run's pseudo-GT (the CLI's default for small)
EVAL_GT_RES = 256


class Tee(io.TextIOBase):
    """Write to stdout and keep a copy."""

    def __init__(self, out):
        self.out = out
        self.buf = io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def check(ok, message):
    """Fail the run (an assert would vanish under python -O)."""
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {message}")


def phase(name):
    print(f"\n=== {name} ===", flush=True)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call over ``iters`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, reps: int = 100) -> float:
    """Device milliseconds per call of ``fn``: ``reps`` calls captured in one
    CUDA graph and replayed, so the host's work per call is not timed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, iters=10) / reps


def device_phase():
    phase("1. device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device count {torch.cuda.device_count()}")
    print(f"device: {name}")
    print(smi)
    return name, smi


def build_phase():
    phase("2. build")
    from tropical_torch.ops import cuda_build

    t = time.time()
    targets = ["min_dist", EXACT_COUNT, "trilinear_roots", "hashgrid_encode"]
    logs = cuda_build.build(targets)
    for target in targets:
        name = cuda_build.label(target)
        print(f"--- {name} ({cuda_build.library_path(target).name})")
        print(logs[name].strip() or "(already built)")
        spills = [int(v) for v in re.findall(r"(\d+) bytes spill", logs[name])]
        check(not any(spills), f"{name}: register spills {spills}")
    print(f"build {time.time() - t:.1f} s")


def min_dist_bound_ms(n: int, m: int) -> tuple[float, str]:
    """Least time for the nearest-neighbour search: 8 f32 operations per
    pair (3 sub, 3 mul, 2 add) against the bytes read and written once."""
    ops = 8.0 * n * m
    nbytes = (n + m) * 3 * 4 + n * (4 + 4)
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def sphere_points(n, rng, dev):
    # first-hit samples lie on a surface of radius ~0.6
    p = rng.normal(size=(n, 3))
    p = 0.6 * p / np.linalg.norm(p, axis=1, keepdims=True)
    return torch.from_numpy(p.astype(np.float32)).to(dev)


def kernel_phase():
    phase("3. kernels vs plain")
    return [min_dist_phase(), trilinear_roots_phase(), *encode_phase()]


def min_dist_phase():
    print("--- min_dist")
    from tropical_torch.ops import chamfer as ch
    from tropical_torch.ops import cuda_build

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def pts(n):
        return sphere_points(n, rng, dev)

    x, y = pts(100_000), pts(100_000)
    cases = {"100000x100000": (x, y),
             "99871x100003": (pts(99_871), pts(100_003))}
    dup = pts(50_000)
    cases["duplicates 60000x100000"] = (dup[:60_000 // 2].repeat(2, 1),
                                        torch.cat([dup, dup]))
    # a cloud offset by +100 with nearest distances ~1e-3: |y|^2 - 2 x.y
    # cancels, and the filter's margin lets most pairs through
    off = torch.from_numpy(
        (100.0 + rng.uniform(0.0, 0.03, size=(50_000, 3))).astype(np.float32))
    cases["offset cloud 20000x30000"] = (off[:20_000].to(dev),
                                         off[20_000:].to(dev))
    # points mirrored across z = 0.3, looked up from the plane: near-ties
    q = rng.uniform(-0.5, 0.5, size=(30_000, 3)).astype(np.float32)
    q[:, 2] = 0.3 + np.abs(q[:, 2])
    mirrored = q.copy()
    mirrored[:, 2] = np.float32(0.6) - q[:, 2]
    on_plane = rng.uniform(-0.5, 0.5, size=(30_000, 3)).astype(np.float32)
    on_plane[:, 2] = 0.3
    cases["mirrored near-ties 30000x60000"] = (
        torch.from_numpy(on_plane).to(dev),
        torch.from_numpy(np.concatenate([q, mirrored])).to(dev))

    max_err = 0.0
    results = {}
    for label, (a, b) in cases.items():
        d2, idx = results[label] = ch.min_nn_distance(a, b)  # CUDA -> kernel
        torch.cuda.synchronize()
        p2, pidx = ch.min_dist_plain(a, b)
        err = float((d2 - p2).abs().max())
        max_err = max(max_err, err)
        bits = int((d2.view(torch.int32) != p2.view(torch.int32)).sum())
        mismatches = int((idx != pidx).sum())
        print(f"{label}: max |d2 - plain| = {err:.3e}, d2 bit mismatches "
              f"{bits}, index mismatches {mismatches}")
        check(bits == 0, f"{label}: kernel d2 differs from plain in {bits} rows")
        check(mismatches == 0,
              f"{label}: kernel index differs from plain in {mismatches} rows")

    n, m = x.shape[0], y.shape[0]
    lib = cuda_build.load("min_dist")
    cfg = ch.kernel_config(lib, 0)
    splits, per_split = ch.split_plan(n, m, cfg["sms"], cfg["resident"],
                                      cfg["rows_per_block"], cfg["panel"])
    plan = {"R": cfg["rows_per_block"] // cfg["threads"], "S": splits,
            "panel": cfg["panel"], "threads": cfg["threads"],
            "group": cfg["group"], "panels_per_split": per_split,
            "sms": cfg["sms"], "blocks_per_sm": cfg["resident"]}
    print(f"min_dist {n}x{m} launch plan: {json.dumps(plan)}")

    # the exact path's share, from the instrumented build (not the main path's)
    counted = cuda_build.load(EXACT_COUNT)
    counts = (ctypes.c_ulonglong * 4)()
    counted.min_dist_exact_counts.argtypes = [ctypes.c_void_p]
    counted.min_dist_exact_counts.restype = ctypes.c_int
    check(counted.min_dist_exact_counts(counts) == 0, "exact counters reset")
    d2c, idxc = ch.run_kernel(counted, x, y)
    torch.cuda.synchronize()
    check(counted.min_dist_exact_counts(counts) == 0, "exact counters read")
    warp_groups, warp_exact, row_groups, row_walks = list(counts)
    check(torch.equal(d2c, results["100000x100000"][0])
          and torch.equal(idxc, results["100000x100000"][1]),
          "the instrumented build disagrees with the kernel")
    exact_share = {"warp_groups": warp_groups, "warp_groups_exact": warp_exact,
                   "warp_share": warp_exact / max(1, warp_groups),
                   "row_groups": row_groups, "row_walks": row_walks,
                   "row_share": row_walks / max(1, row_groups)}
    print(f"min_dist {n}x{m} exact path: {json.dumps(exact_share)}")

    ms = cuda_ms(lambda: ch.min_nn_distance(x, y), iters=20, warmup=2)
    plain_ms = cuda_ms(lambda: ch.min_dist_plain(x, y), iters=3)

    def library():
        # torch.cdist + min, chunked over x: the yardstick, not used by the port
        for r0 in range(0, n, 8192):
            torch.cdist(x[r0:r0 + 8192], y).min(dim=1)

    library_ms = cuda_ms(library, iters=3)
    bound_ms, bound_by = min_dist_bound_ms(n, m)
    print(f"min_dist {n}x{m}: kernel {ms:.3f} ms (before the redesign "
          f"{PREV_MS['min_dist']} ms), plain {plain_ms:.3f} ms, cdist+min "
          f"{library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}); kernel "
          f"at {bound_ms / ms:.1%} of the bound")
    return {"name": "min_dist", "route": "cuda",
            "source": "tropical_torch/csrc/min_dist.cu",
            "replaces": "tropical/ops/chamfer_tpu.py:83",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "shape": [n, m], "plan": plan,
            "exact_share": exact_share}


def seeded_rows():
    """100,000 seeded rows (p, q) on the card, a size the path does not
    reach."""
    rng = np.random.default_rng(7)
    return tuple(torch.from_numpy(rng.normal(size=(100_000, 8))
                                  .astype(np.float32)).cuda()
                 for _ in range(2))


def trilinear_roots_phase():
    print("--- trilinear_roots")
    sys.path.insert(0, "tests")
    import trilinear_cases as cases

    p, q, _ = cases.kernel_pq(n_random=0)
    sets = {f"hard cases ({p.shape[0]} rows)":
            tuple(torch.from_numpy(a).cuda() for a in (p, q)),
            "100000 seeded rows": seeded_rows()}
    max_err = max(roots_vs_plain(label, *pq) for label, pq in sets.items())
    return {"name": "trilinear_roots", "route": "cuda",
            "source": "tropical_torch/csrc/trilinear_roots.cu",
            "replaces": "tropical/core/trilinear.py:91",
            "max_abs_err": max_err}


def roots_vs_plain(label, p, q) -> float:
    """The kernel against its plain version on (p, q), to the bit; returns
    the largest absolute difference."""
    from tropical_torch.core import trilinear as tl

    out = tl.intersection_of_two_planes(p, q)  # CUDA -> kernel
    torch.cuda.synchronize()
    plain = tl.intersection_of_two_planes_plain(p, q)
    rows = int((out.view(torch.int32) != plain.view(torch.int32))
               .any(1).sum())
    err = float((out - plain).abs().max())
    sentinels = int((out[:, 0] == -1).sum())
    print(f"trilinear_roots {label}: max |out - plain| = {err:.3e}, rows "
          f"with a bit mismatch {rows}, x sentinels {sentinels}")
    check(rows == 0, f"{label}: kernel differs from plain in {rows} rows")
    return err


def trilinear_roots_bound_ms(p: torch.Tensor, q: torch.Tensor
                             ) -> tuple[float, str]:
    """Least time for the root solve of these rows: the operations each row
    needs, counted as in csrc/trilinear_roots.cu's note (134 for the
    coefficients and 20 for y; on a non-constant row 16 for the first
    samples, 19 a cell scanned, 483 for the last bracket's bisection, 413 a
    probe and 482 more where it bisects a hidden pair), against 76 bytes a
    row read and written once.  The operations are unfused (one rounded
    product, sum or quotient each), so they run at PEAK_F32_UNFUSED_OPS."""
    from tropical_torch.core import roots as rt
    from tropical_torch.core import trilinear as tl

    c = tl.quartic_coeffs(p, q)
    c = torch.where(c.abs() < 1e-9, 0.0, c)
    ts = torch.arange(65, dtype=c.dtype, device=c.device) / 64
    vals, dco = rt._poly_eval(c, ts), rt._deriv(c)
    dvals = rt._poly_eval(dco, ts)
    nonconst = rt._abs_sum(c, 4) > 1e-9
    br, dbr = rt._brackets(vals, nonconst), rt._brackets(dvals, nonconst)
    has = br.any(-1)
    # the scan stops at the lower of the last bracket and the third-highest
    # derivative bracket, once it has both
    above = dbr.flip(1).cumsum(1).flip(1)   # derivative brackets >= a cell
    nd = above[:, 0].clamp(max=3)
    third = (above >= 3).sum(-1) - 1
    stop = torch.minimum(rt._last_true(br), third)
    cells = torch.where(has & (nd == 3), 64 - stop, 64)
    cross = torch.zeros_like(nd)
    cell_ids = torch.arange(64, device=c.device)
    for _ in range(3):  # probes with a hidden pair: one more bisection of p
        dhas = dbr.any(-1)
        didx = rt._last_true(dbr)
        dbr = dbr & (cell_ids[None, :] != didx[:, None])
        m = rt._bisect(dco, ts[didx], ts[didx + 1],
                       dvals.gather(1, didx[:, None])[:, 0])
        pm = rt._poly_eval(c, m[:, None])[:, 0]
        pr = vals.gather(1, didx[:, None] + 1)[:, 0]
        cross += (dhas & (pm * pr < 0)).long()
    per_row = 154 + nonconst.long() * (16 + 19 * cells + 483 * has.long()
                                       + 413 * nd + 482 * cross)
    ops = float(per_row.sum())
    nbytes = 76.0 * p.shape[0]
    t_ops, t_bytes = ops / PEAK_F32_UNFUSED_OPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def shapes_phase(records, largest, curved_inputs, curved_take):
    """Each kernel at the largest shape its main path gave it."""
    phase("6. kernels at the main paths' largest shapes")
    from tropical_torch.ops import chamfer as ch

    rec = records["min_dist"]
    shape = largest["min_dist"]
    check(shape is not None, "the flat path recorded no min_dist shape")
    rng = np.random.default_rng(1)
    x = sphere_points(shape[0], rng, torch.device("cuda"))
    y = sphere_points(shape[1], rng, torch.device("cuda"))
    ms = cuda_ms(lambda: ch.min_nn_distance(x, y), iters=20, warmup=2)
    bound_ms, _ = min_dist_bound_ms(*shape)
    print(f"min_dist {shape[0]}x{shape[1]} (largest on the flat path): "
          f"kernel {ms:.3f} ms, bound {bound_ms:.3f} ms, at "
          f"{bound_ms / ms:.1%} of the bound")
    rec.update(main_shape=list(shape), main_ms=ms, main_bound_ms=bound_ms)
    trilinear_roots_timing(records["trilinear_roots"], curved_inputs,
                           curved_take)
    encode_at_largest(records, largest)


def trilinear_roots_timing(rec, inputs, extract_s):
    """``trilinear_roots`` on every input of the curved path: bitwise
    against its plain version, the summed device time beside the
    extraction's ``take``; then the largest input and the seeded rows
    timed (``solve_times``)."""
    from tropical_torch.core import trilinear as tl

    rows = [p.shape[0] for p, _ in inputs]
    for i, (p, q) in enumerate(inputs):
        label = f"curved input {i + 1}/{len(inputs)} ({rows[i]} rows)"
        rec["max_abs_err"] = max(rec["max_abs_err"],
                                 roots_vs_plain(label, p, q))
    total_ms = sum(graph_ms(lambda p=p, q=q: tl.intersection_of_two_planes(
        p, q)) for p, q in inputs)
    print(f"trilinear_roots on the curved run's {len(inputs)} inputs "
          f"({sum(rows)} rows): {total_ms:.4f} ms of device time summed, "
          f"against the extraction's take {extract_s} s "
          f"({total_ms / 1e3 / extract_s:.4%} of it)")
    largest = inputs[rows.index(max(rows))]
    rec.update(solve_times(*largest, prev_ms=PREV_MS["trilinear_roots"]),
               shape=[max(rows)], curved_rows=rows, curved_sum_ms=total_ms,
               extract_s=extract_s)
    # eigvals takes seconds a call here, and is warm
    rec["seeded_100000"] = solve_times(*seeded_rows(), library_iters=1,
                                       library_warmup=0)


def solve_times(p, q, prev_ms=None, library_iters=3, library_warmup=1):
    """Device time (``graph_ms``), one wrapper call as the path makes it
    (host work included), the plain version, ``eigvals`` and the bound of
    ``trilinear_roots`` on (p, q)."""
    from tropical_torch.core import trilinear as tl

    n = p.shape[0]
    ms = graph_ms(lambda: tl.intersection_of_two_planes(p, q))
    call_ms = cuda_ms(lambda: tl.intersection_of_two_planes(p, q), iters=50,
                      warmup=3)
    plain_ms = cuda_ms(lambda: tl.intersection_of_two_planes_plain(p, q),
                       iters=3)
    # the upstream solver: eigenvalues of the monic companion matrices
    # [B, 4, 4] (the yardstick, not used by the port)
    c = tl.quartic_coeffs(p, q)
    lead = torch.where(c[:, 0] == 0, 1.0, c[:, 0])
    comp = torch.zeros((n, 4, 4), dtype=torch.float32, device=p.device)
    comp[:, 0, :] = torch.nan_to_num(-c[:, 1:] / lead[:, None])
    comp[:, 1, 0] = comp[:, 2, 1] = comp[:, 3, 2] = 1.0
    library_ms = cuda_ms(lambda: torch.linalg.eigvals(comp),
                         iters=library_iters, warmup=library_warmup)
    bound_ms, bound_by = trilinear_roots_bound_ms(p, q)
    before = "" if prev_ms is None else f" (before the redesign {prev_ms} ms)"
    print(f"trilinear_roots B={n}: kernel {ms:.4f} ms{before} (a wrapper "
          f"call {call_ms:.4f} ms), plain {plain_ms:.3f} ms, eigvals "
          f"{library_ms:.3f} ms, bound {bound_ms:.5f} ms ({bound_by}); kernel "
          f"at {bound_ms / ms:.1%} of the bound")
    return {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def encode_spec(size):
    from tropical_torch.stanford.model import net_for_size

    return net_for_size(size, device="cpu").spec.grid


def boundary_points(spec, n, rng):
    """n points on cell boundaries: on every axis, x s_l + 0.5 (in f32, two
    roundings) an integer for a level l drawn per point."""
    out = np.empty((0, 3), np.float32)
    while out.shape[0] < n:
        lv = rng.integers(0, spec.levels, 4 * n)
        s = np.array([spec.level_scale(int(l)) for l in lv], np.float32)[:, None]
        k = rng.integers(0, 40, (4 * n, 3)).astype(np.float32)
        x = ((k - np.float32(0.5)) / s).astype(np.float32)
        pos = (x * s).astype(np.float32) + np.float32(0.5)
        out = np.concatenate([out, x[(pos == np.floor(pos)).all(1)]])
    return out[:n]


def encode_inputs(spec, n, seed, kind="mixed"):
    """Seeded (table, x, dfeat, ddx) on the card.  Points ("mixed") over the
    unit cube and its margin (the extraction canvas reaches past it), a
    quarter on grid planes and faces; or ("one_cell") every point in one
    cell of every level, the table gradients' worst contention; or
    ("boundaries") on cell boundaries; or ("far") far outside the cube,
    where dense bases leave int32; or ("wrap", on the grid
    ``tests/encode_cases.WRAP_SPEC``) with bases at the int64 limit."""
    sys.path.insert(0, "tests")
    import encode_cases

    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    x[: n // 4] = np.round(x[: n // 4] * 4) / 4
    if kind == "one_cell":
        x[:] = np.float32([0.3141, 0.5926, 0.5358])
    elif kind == "boundaries":
        x = boundary_points(spec, n, rng)
    elif kind == "far":
        x = encode_cases.far_points(rng, n)
    elif kind == "wrap":
        x = encode_cases.wrap_points(n)
    table = (0.1 * rng.normal(size=(spec.n_entries, 2))).astype(np.float32)
    dfeat = rng.normal(size=(n, spec.levels * 2)).astype(np.float32)
    ddx = rng.normal(size=(n, 3)).astype(np.float32)
    return tuple(torch.from_numpy(a).cuda() for a in (table, x, dfeat, ddx))


def encode_vs_plain(recs, label, spec, table, x, dfeat, ddx):
    """The three kernels against their plain versions: features, dx,
    d_dfeat and dx2 to the bit, dtable and dtable2 within SCATTER_ULPS
    2^-24 sqrt(B) of the plain version's largest row.  Updates each record's
    max_abs_err."""
    from tropical_torch.core import hashgrid as hg

    feat = hg.hashgrid_encode_fwd(spec, table, x)
    dx, dt = hg.hashgrid_encode_bwd(spec, table, x, dfeat)
    # the x-only backward, as normal() and the GD rescue launch it
    dx_only, none = hg.hashgrid_encode_bwd(spec, table, x, dfeat,
                                           need_table=False)
    dd, dt2, dx2 = hg.hashgrid_encode_bwd_bwd(spec, table, x, dfeat, ddx)
    torch.cuda.synchronize()
    check(none is None, "an x-only backward returned a table gradient")
    pdx, pdt = hg.encode_backward_plain(spec, table, x, dfeat)
    pdd, pdt2, pdx2 = hg.encode_double_backward_plain(spec, table, x, dfeat,
                                                      ddx)
    pairs = {"feat": (feat, hg.encode_plain(spec, table, x)), "dx": (dx, pdx),
             "dx_only": (dx_only, pdx), "d_dfeat": (dd, pdd),
             "dx2": (dx2, pdx2)}
    bits = {k: int((a.view(torch.int32) != b.view(torch.int32)).sum())
            for k, (a, b) in pairs.items()}

    def err(a, b):
        return float((a - b).abs().max()) if a.numel() else 0.0

    def rel(a, b):
        return err(a, b) / max(float(b.abs().max()), 1e-30)

    scatter = {"dtable": rel(dt, pdt), "dtable2": rel(dt2, pdt2)}
    unit = 2.0 ** -24 * math.sqrt(max(x.shape[0], 1))
    tol = SCATTER_ULPS * unit
    print(f"encode {label}: bit mismatches {bits}; table gradients against "
          f"the plain version's largest row {scatter} (held to {tol:.3e}; "
          f"{max(scatter.values()) / unit:.3f} of 2^-24 sqrt(B))")
    check(not any(bits.values()), f"encode {label}: kernel differs from "
          f"plain: {bits}")
    check(all(v <= tol for v in scatter.values()),
          f"encode {label}: table gradients beyond {tol}: {scatter}")
    errs = {"hashgrid_encode_fwd": [err(*pairs["feat"])],
            "hashgrid_encode_bwd": [err(dx, pdx), err(dt, pdt)],
            "hashgrid_encode_bwd_bwd": [err(dd, pdd), err(dt2, pdt2),
                                        err(dx2, pdx2)]}
    for k, v in errs.items():
        recs[k]["max_abs_err"] = max(recs[k]["max_abs_err"], *v)
    for k, key in (("hashgrid_encode_bwd", "dtable"),
                   ("hashgrid_encode_bwd_bwd", "dtable2")):
        recs[k]["scatter_units_max"] = max(recs[k].get("scatter_units_max", 0.0),
                                           scatter[key] / unit)


def encode_phase():
    print("--- hashgrid encode: forward, backward, double backward")
    from tropical_torch.core import hashgrid as hg

    recs = {k: {"name": k, "route": "cuda",
                "source": "tropical_torch/csrc/hashgrid_encode.cu",
                "replaces": ENCODE_REPLACES[k], "max_abs_err": 0.0}
            for k in ENCODE}
    for size in ("small", "medium", "large"):
        spec = encode_spec(size)
        hashed = [l for l in range(spec.levels) if spec.level_uses_hash(l)]
        print(f"{size}: backwards' private levels {hg.private_levels(spec)} "
              f"({hg.private_rows(spec)} rows)")
        for n in (0, 1, 1000, 278528):
            encode_vs_plain(recs, f"{size} (hashed levels {hashed}) B={n}",
                            spec, *encode_inputs(spec, n, seed=n + 7))
    spec = encode_spec("small")
    for kind in ("one_cell", "boundaries"):
        for n in (1000, 278528):
            encode_vs_plain(recs, f"small {kind} B={n}", spec,
                            *encode_inputs(spec, n, seed=n + 5, kind=kind))
    # the forward's index arithmetic: its 32-bit remainder where the base
    # fits, the 64-bit one where it does not, a remainder a corner where a
    # corner's index wraps past the int64 limit
    encode_vs_plain(recs, "small far outside the cube (bases past int32) "
                    "B=1000", spec, *encode_inputs(spec, 1000, seed=17,
                                                   kind="far"))
    sys.path.insert(0, "tests")
    import encode_cases

    wrap = hg.HashGridSpec(**encode_cases.WRAP_SPEC)
    encode_vs_plain(recs, "one level, bases at the int64 limit B=64", wrap,
                    *encode_inputs(wrap, 64, seed=19, kind="wrap"))
    # level counts that are no power of two, or one, or many; a ragged B
    for levels in (1, 5, 16):
        lspec = hg.HashGridSpec(levels=levels, n_min=2, n_max=32,
                                log2_table=12)
        encode_vs_plain(recs, f"{levels} levels B=1001", lspec,
                        *encode_inputs(lspec, 1001, seed=levels))
    encode_vs_plain(recs, "small ragged B=100003", spec,
                    *encode_inputs(spec, 100_003, seed=23))
    for k, v in encode_times(spec, *encode_inputs(spec, 1000, seed=3)).items():
        recs[k].update(v)
    floor_ms = graph_floor_ms()
    print(f"a CUDA graph's node floor (a one-element in-place add, "
          f"graph_ms): {floor_ms:.5f} ms; the kernels above at B=1000 over "
          f"it: " + ", ".join(f"{k} {recs[k]['ms'] - floor_ms:+.5f} ms"
                              for k in ENCODE))
    recs["hashgrid_encode_fwd"]["graph_floor_ms"] = floor_ms
    return list(recs.values())


def graph_floor_ms() -> float:
    """What one kernel node of a CUDA graph costs on this card: a
    one-element in-place add, captured 100 times by ``graph_ms``."""
    t = torch.zeros(1, device="cuda")
    return graph_ms(lambda: t.add_(1.0))


def encode_rows_touched(spec, x) -> int:
    """The distinct table rows that the corners of the points x reach, over
    every level."""
    from tropical_torch.core import hashgrid as hg

    rows = []
    for l in range(spec.levels):
        pos_grid, frac = hg._level_grid(spec, x, l)
        rows += [idx for _, idx, _ in hg._corners(spec, l, pos_grid, frac,
                                                  spec.n_entries)]
    return int(torch.unique(torch.cat(rows)).numel()) if rows else 0


def encode_bound_ms(name, spec, x):
    """Least time of one encode kernel on the points x: the bytes it must
    move at 3.35 TB/s against its unfused float operations at
    PEAK_F32_UNFUSED_OPS.  Bytes: the points and the gradients read, each
    table row the corners reach read once (the corners' later reads of a
    row are not counted: the table, 281 KB for sphere-small, stays in the
    50 MB L2), the outputs written, a table gradient written once whole."""
    n, L, rows = x.shape[0], spec.levels, spec.n_entries
    points, feats, table = 12 * n, 8 * L * n, 8 * encode_rows_touched(spec, x)
    nbytes = {"hashgrid_encode_fwd": points + table + feats,
              "hashgrid_encode_bwd": points + feats + table + points + 8 * rows,
              "hashgrid_encode_bwd_bwd": (2 * points + feats + table + feats
                                          + 8 * rows + points)}
    t_bytes = nbytes[name] / PEAK_BYTES
    t_ops = ENCODE_OPS[name] * L * n / PEAK_F32_UNFUSED_OPS
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def encode_times(spec, table, x, dfeat, ddx):
    """Each kernel's device time (graph_ms), one wrapper call, its plain
    version (CUDA events) and its bound on these inputs."""
    from tropical_torch.core import hashgrid as hg

    calls = {
        "hashgrid_encode_fwd": (
            lambda: hg.hashgrid_encode_fwd(spec, table, x),
            lambda: hg.encode_plain(spec, table, x)),
        "hashgrid_encode_bwd": (
            lambda: hg.hashgrid_encode_bwd(spec, table, x, dfeat),
            lambda: hg.encode_backward_plain(spec, table, x, dfeat)),
        "hashgrid_encode_bwd_bwd": (
            lambda: hg.hashgrid_encode_bwd_bwd(spec, table, x, dfeat, ddx),
            lambda: hg.encode_double_backward_plain(spec, table, x, dfeat,
                                                    ddx))}
    n = x.shape[0]
    out = {}
    for name, (kernel, plain) in calls.items():
        ms = graph_ms(kernel)
        call_ms = cuda_ms(kernel, iters=50, warmup=10)
        plain_ms = cuda_ms(plain, iters=10, warmup=2)
        bound_ms, bound_by = encode_bound_ms(name, spec, x)
        prev = PREV_ENCODE_MS.get(name, {}).get(n)
        before = "" if prev is None else f" (before the redesign {prev} ms)"
        print(f"{name} B={n}: kernel {ms:.4f} ms{before} (a wrapper call "
              f"{call_ms:.4f} ms), plain {plain_ms:.3f} ms, bound "
              f"{bound_ms:.5f} ms ({bound_by}); kernel at "
              f"{bound_ms / ms:.1%} of the bound")
        out[name] = {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None, "shape": [n, spec.levels]}
    # the forward's lanes a (point, level) at this B
    out["hashgrid_encode_fwd"]["lanes"] = hg._launcher(
        spec, x.get_device(), None).lanes(n)
    # the backward in x alone (normal(), the GD rescue), and the host cost
    # of a zero-filled table gradient against an unfilled one (the launch
    # zero-fills it with cudaMemsetAsync in the same call)
    def x_only():
        return hg.hashgrid_encode_bwd(spec, table, x, dfeat, need_table=False)

    fills = {"x_only_ms": graph_ms(x_only),
             "x_only_call_ms": cuda_ms(x_only, iters=50, warmup=10),
             "zeros_like_call_ms": cuda_ms(lambda: torch.zeros_like(table),
                                           iters=50, warmup=10),
             "empty_like_call_ms": cuda_ms(lambda: torch.empty_like(table),
                                           iters=50, warmup=10)}
    print(f"hashgrid_encode_bwd B={n} in x alone: {json.dumps(fills)}")
    out["hashgrid_encode_bwd"].update(fills)
    return out


def encode_at_largest(records, largest):
    """The encode kernels at the flat run's largest forward (``main_*`` keys
    of each record) and at its largest backward, the faces' normals
    (``normals_*``): held to their plain versions and timed; then the
    forward on the points that largest forward serves, a marching-cubes
    slab (``slab_*``)."""
    spec = encode_spec("small")
    recs = {k: records[k] for k in ENCODE}
    for key, name in (("main", "hashgrid_encode_fwd"),
                      ("normals", "hashgrid_encode_bwd")):
        shape = largest[name]
        check(shape is not None and shape[1] == spec.levels,
              f"flat path's largest {name}: {shape}")
        inputs = encode_inputs(spec, shape[0], seed=11)
        encode_vs_plain(recs, f"small B={shape[0]} (largest {name} on the "
                        "flat path)", spec, *inputs)
        for k, v in encode_times(spec, *inputs).items():
            records[k].update({f"{key}_{f}": val for f, val in v.items()})
        if key == "main":
            encode_on_slab(records["hashgrid_encode_fwd"], "slab", spec,
                           inputs[0], shape)


def slab_points(res=SLAB_RES, x0=SLAB_X0):
    """SLAB + 1 x-planes of the marching-cubes grid at res from x index x0,
    built as ``utils/marching_cubes.slab_fields`` builds a slab's points
    (``np.linspace`` axis in f32, row-major, z fastest), then
    ``preprocess``ed into the unit cube as the net's forward does."""
    from tropical_torch.core.net import preprocess
    from tropical_torch.stanford.model import net_for_size
    from tropical_torch.stanford.train import CANVAS_SIZE
    from tropical_torch.utils import marching_cubes as mc

    s = mc.grid_axis(res, CANVAS_SIZE, torch.device("cuda"))
    pts = mc.grid_points(s, x0 * res ** 2, (mc.SLAB + 1) * res ** 2)
    return preprocess(net_for_size("small", device="cpu").spec, pts)


def encode_on_slab(rec, key, spec, table, largest, res=SLAB_RES,
                   x0=SLAB_X0):
    """The forward on a marching-cubes slab's own points (``slab_points``),
    the shape ``largest`` a main path gave it: bitwise its plain version,
    then its device time, one wrapper call, the plain version and its
    bound (``{key}_*`` keys of the record)."""
    from tropical_torch.core import hashgrid as hg

    x = slab_points(res, x0).contiguous()
    check(tuple(largest) == (x.shape[0], spec.levels),
          f"the slab at {res} has {x.shape[0]} points, the path's largest "
          f"forward {largest}")
    feat = hg.hashgrid_encode_fwd(spec, table, x)
    torch.cuda.synchronize()
    bad = int((feat.view(torch.int32)
               != hg.encode_plain(spec, table, x).view(torch.int32)).sum())
    print(f"encode slab at {res} from x index {x0} ({x.shape[0]} points): "
          f"forward bit mismatches {bad}")
    check(bad == 0, f"the forward differs from its plain version on the "
          f"slab at {res}")

    def fwd():
        return hg.hashgrid_encode_fwd(spec, table, x)

    ms, call_ms = graph_ms(fwd), cuda_ms(fwd, iters=50, warmup=10)
    plain_ms = cuda_ms(lambda: hg.encode_plain(spec, table, x), iters=3)
    bound_ms, bound_by = encode_bound_ms("hashgrid_encode_fwd", spec, x)
    print(f"hashgrid_encode_fwd on the slab at {res}: kernel {ms:.4f} ms (a "
          f"wrapper call {call_ms:.4f} ms), plain {plain_ms:.3f} ms, bound "
          f"{bound_ms:.5f} ms ({bound_by}); at {bound_ms / ms:.1%} of the "
          "bound")
    rec.update({f"{key}_{k}": v for k, v in dict(
        shape=list(largest), ms=ms, call_ms=call_ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        max_abs_err=0.0).items()})


def golden_params(g):
    return {"table": g["table"],
            "mlp": {"w": [g[f"w{i}"] for i in range(3)],
                    "b": [g[f"b{i}"] for i in range(3)]}}


def window_max(a, width=WINDOW):
    """The largest |a| in each window of ``width`` steps; where ``a``
    stacks several runs ([runs, steps]), the largest over them too."""
    w = np.abs(a).reshape(*a.shape[:-1], -1, width).max(axis=-1)
    return w.max(axis=0) if w.ndim > 1 else w


def golden_verdict(g, totals, l1s, sdf):
    """A training run against the JAX golden: (report, failures).

    The port's Adam rounds as torch.optim.Adam does; the golden's ``adam``
    run is the JAX package with that arithmetic.  Each 10-step window of
    both losses is held:

    - until the first window where twice the one-ulp witness's spread
      covers the adam run's own gap to the golden: to the adam run, within
      twice the summation noise of a loss read out in another order (the
      order witnesses' largest gap to the golden over those windows);
    - from that window on: to the golden, within twice the one-ulp
      witness's spread.

    The sdf at the probes: to the golden, within twice the one-ulp
    witness's spread."""
    report, failures = {}, []
    for key, port in (("totals", totals), ("l1s", l1s)):
        gold = g[f"golden_{key}"]
        spread = window_max(g[f"witness_{key}"] - gold)
        covered = np.nonzero(2 * spread >= window_max(g[f"adam_{key}"] - gold))
        switch = int(covered[0][0]) if len(covered[0]) else len(spread)
        noise = float(window_max(g[f"order_{key}"] - gold)[:switch].max(
            initial=0.0))
        early = window_max(port - g[f"adam_{key}"])[:switch]
        gap = window_max(port - gold)
        over = np.nonzero(early > 2 * noise)[0].tolist()
        over += (switch + np.nonzero(gap[switch:] > 2 * spread[switch:])[0]
                 ).tolist()
        opened = np.nonzero(np.maximum.accumulate(gap) > 1e-6)[0]
        report[key] = {
            "held_to_golden_from_window": switch,
            "gap_to_adam_run": early.tolist(), "early_limit": 2 * noise,
            "gap_to_golden": gap.tolist(), "witness_spread": spread.tolist(),
            "windows_over": over,
            "gap_to_golden_opens_at_window": (int(opened[0]) if len(opened)
                                              else None)}
        if over:
            failures.append(f"{key}: windows {over} beyond their limits")
    gap_p = float(np.abs(sdf - g["golden_sdf"]).max())
    spread_p = float(np.abs(g["witness_sdf"] - g["golden_sdf"]).max())
    report["probes"] = {"gap_to_golden": gap_p, "witness_spread": spread_p}
    if gap_p > 2 * spread_p:
        failures.append(f"probe sdf {gap_p} from the golden, beyond twice "
                        f"the witness's {spread_p}")
    return report, failures


def dtable2_dropped(bwd_bwd):
    """A planted fault: ``bwd_bwd`` with its table gradient zeroed (the
    eikonal term's gradient of the table lost)."""
    def faulty(*args, **kwargs):
        d_dfeat, dtable2, dx2 = bwd_bwd(*args, **kwargs)
        return d_dfeat, None if dtable2 is None else dtable2.zero_(), dx2

    return faulty


def step_ms(net_init, x, y, plain_encode: bool) -> float:
    """One training step on a fixed batch (CUDA events over 10 steps),
    through the kernels or, for the comparison only, through autograd of
    the plain encode."""
    from tropical_torch.core import hashgrid as hg
    from tropical_torch.stanford import training as tr

    net = net_init()
    opt, sched = tr.make_optimizer(net.parameters(), 1e-3, 100)
    encode = hg.encode
    if plain_encode:
        hg.encode = lambda spec, table, xu: hg.encode_plain(spec, table, xu)
    try:
        return cuda_ms(lambda: tr.train_step(net, opt, sched, x, y,
                                             TRAIN_BATCH), iters=10, warmup=3)
    finally:
        hg.encode = encode


def kernel_events(prof):
    """The device's kernel events of a profile: CUDA events that are not
    user annotations (the spans of record_function scopes)."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]


def profiled_steps(net, opt, sched, x, y, steps):
    """``steps`` training steps under torch.profiler: (profile, host wall
    in us)."""
    from torch.profiler import ProfilerActivity, profile

    from tropical_torch.stanford import training as tr

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.time()
        for _ in range(steps):
            tr.train_step(net, opt, sched, x, y, TRAIN_BATCH)
        torch.cuda.synchronize()
        wall_us = (time.time() - t) * 1e6
    return prof, wall_us


def first_step(net_init, x, y):
    """The first training step of the process, profiled: its wall and the
    host operations that take most of it (one-time set-up the later steps
    do not pay)."""
    from tropical_torch.stanford import training as tr

    net = net_init()
    opt, sched = tr.make_optimizer(net.parameters(), 1e-3, 100)
    prof, wall_us = profiled_steps(net, opt, sched, x, y, 1)
    top = sorted(prof.key_averages(), key=lambda e: -e.cpu_time_total)[:8]
    return {"wall_s": wall_us / 1e6,
            "top_host_s": {e.key[:60]: e.cpu_time_total / 1e6 for e in top}}


def step_busy_share(net_init, x, y, steps: int = 10):
    """The device's busy share over ``steps`` warm training steps through
    the kernels: the summed time of the kernel events (torch.profiler) over
    the host clock of the steps, and the kernels a step."""
    from tropical_torch.stanford import training as tr

    net = net_init()
    opt, sched = tr.make_optimizer(net.parameters(), 1e-3, 100)
    for _ in range(3):
        tr.train_step(net, opt, sched, x, y, TRAIN_BATCH)
    prof, wall_us = profiled_steps(net, opt, sched, x, y, steps)
    events = kernel_events(prof)
    busy_us = sum(e.device_time_total for e in events)
    by_name = {}
    for e in events:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.device_time_total
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"device_busy_share": busy_us / wall_us,
            "device_us_per_step": busy_us / steps,
            "wall_us_per_step": wall_us / steps,
            "kernels_per_step": len(events) / steps,
            "top_device_us_per_step": {k: v / steps for k, v in top}}


def training_phase(flat_cd):
    """Train from the golden's JAX init; returns the encode launches."""
    phase("7. training path: train() on sphere-small, 10 epochs of 50 steps "
          "of 1,000")
    from tropical_torch.ops import launches
    from tropical_torch.stanford import train as cli
    from tropical_torch.stanford.dataset import StanfordDataset
    from tropical_torch.stanford.model import net_for_size
    from tropical_torch.stanford.training import train
    from tropical_torch.utils.ply import Mesh

    g = np.load(TRAIN_GOLDEN)
    dev = torch.device("cuda")

    def net_init():
        return net_for_size("small", "sphere", TRAIN_SEED,
                            device=dev).params_from_numpy(golden_params(g))

    t = time.time()
    ds = StanfordDataset("sphere", rng=np.random.default_rng(TRAIN_SEED),
                         device=dev)
    torch.cuda.synchronize()
    dataset_s = time.time() - t
    label_s = []
    resample = ds.resample

    def timed_resample():
        torch.cuda.synchronize()
        t0 = time.time()
        resample()
        torch.cuda.synchronize()
        label_s.append(time.time() - t0)

    ds.resample = timed_resample
    epoch_end = []

    def epoch_done(_):
        torch.cuda.synchronize()
        epoch_end.append(time.time())

    # the process's first training step, on a net of its own, before the
    # run: the one-time set-up it pays is reported, not timed in the run
    x0, y0 = ds.X[:TRAIN_BATCH], ds.Y[:TRAIN_BATCH]
    print(json.dumps({"first_training_step": first_step(net_init, x0, y0)}))
    net = net_init()
    launches.reset()
    t = time.time()
    totals, l1s = train(net, ds, TRAIN_EPOCHS, TRAIN_BATCH,
                        epoch_callback=epoch_done)
    torch.cuda.synchronize()
    train_s = time.time() - t
    epoch_s = np.diff([t, *epoch_end, t + train_s]).tolist()
    counts = dict(launches.LAUNCHES)
    counts.update({f"{k}_scatters": v for k, v in launches.SCATTERS.items()})
    steps = len(totals)
    print(f"trained {steps} steps in {train_s:.3f} s (epochs {epoch_s}; "
          f"labels {np.mean(label_s):.4f} s an epoch, {label_s}; dataset "
          f"built in {dataset_s:.3f} s); kernel launches {counts}")
    check(steps == TRAIN_EPOCHS * 50, f"{steps} steps")
    want = {k: v * steps for k, v in STEP_LAUNCHES.items()}
    check(all(counts[k] == want[k] for k in ENCODE)
          and counts["min_dist"] == counts["trilinear_roots"] == 0,
          f"training launches {counts}, want {want}")
    # every training backward scatters its table gradient (the J pass's too,
    # which autograd.grad(..., x) then discards)
    check(all(counts[f"{k}_scatters"] == want[k] for k in launches.SCATTERS),
          f"training backwards that scattered: {counts}, want {want}")

    # against the JAX golden and its witnesses
    probes = torch.from_numpy(g["probes"]).to(dev)
    report, failures = golden_verdict(g, totals, l1s,
                                      net.sdf(probes)[:, 0].cpu().numpy())
    print(json.dumps({"train_vs_golden": report}))
    check(not failures, "; ".join(failures))

    # a control: the same check fails a run with a wrong training step
    from tropical_torch.core import hashgrid as hg

    bwd_bwd = hg.hashgrid_encode_bwd_bwd
    hg.hashgrid_encode_bwd_bwd = dtable2_dropped(bwd_bwd)
    try:
        fault_net = net_init()
        fault_totals, fault_l1s = train(
            fault_net, StanfordDataset("sphere", rng=np.random.default_rng(
                TRAIN_SEED), device=dev), TRAIN_EPOCHS, TRAIN_BATCH,
            verbose=False)
    finally:
        hg.hashgrid_encode_bwd_bwd = bwd_bwd
    fault_report, fault_failures = golden_verdict(
        g, fault_totals, fault_l1s, fault_net.sdf(probes)[:, 0].cpu().numpy())
    print(json.dumps({"planted_fault_dtable2_zeroed": {
        "failures": fault_failures,
        **{k: {"windows_over": fault_report[k]["windows_over"],
               "gap_to_adam_run": fault_report[k]["gap_to_adam_run"]}
           for k in ("totals", "l1s")},
        "probes": fault_report["probes"]}}))
    check(fault_failures, "the golden check passed a run with the double "
          "backward's table gradient zeroed")

    # the trained net on the flat path, evaluated
    out_dir = os.path.join(cli.OUT_ROOT, "sphere_trained")
    os.makedirs(out_dir, exist_ok=True)
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        _, V, F, take = cli.extract_mesh(net, True)
        mesh = Mesh(V.cpu().numpy() / cli.DATASET_R, F.cpu().numpy())
        check(mesh.vertices.shape[0] > 0, "the trained net's mesh is empty")
        cli.evaluate_against_grid_gt(net, mesh, take, cli.DATASET_R, 128,
                                     out_dir, "small_1")
    cd = float(re.search(r"^Ours, +\d+, ([-\d.naif]+), ", tee.buf.getvalue(),
                         re.M).group(1))
    print(f"trained net: {mesh.vertices.shape[0]} vertices, "
          f"{mesh.faces.shape[0]} faces, Ours CD {cd} against the committed "
          f"checkpoint's {flat_cd}")
    check(math.isfinite(cd) and 0 < cd <= 2 * flat_cd,
          f"trained net's CD {cd} beyond twice the committed {flat_cd}")

    # one step, through the kernels and through the plain encode
    x, y = next(ds.batches(TRAIN_BATCH))
    times = {"kernels": step_ms(net_init, x, y, False),
             "plain_encode": step_ms(net_init, x, y, True)}
    print(json.dumps({"train_step_ms": times,
                      "speedup": times["plain_encode"] / times["kernels"],
                      "labels_s_per_epoch": float(np.mean(label_s)),
                      "train_s": train_s, "epoch_s": epoch_s,
                      "steps": steps,
                      "step_profile": step_busy_share(net_init, x, y)}))
    return counts


def tree_state(root):
    """(path, size, mtime) of every file under ``root``."""
    state = set()
    for dirpath, _, names in os.walk(root):
        for n in names:
            st = os.stat(os.path.join(dirpath, n))
            state.add((os.path.join(dirpath, n), st.st_size, st.st_mtime_ns))
    return state


def cli_training_phase():
    argv = ["-m", "tropical_torch.stanford.train", *CLI_TRAIN_ARGV]
    phase("8. training CLI: python " + " ".join(argv))
    from tropical_torch.stanford import train as cli

    watched = ("tropical", str(cli.MODELS_DIR))
    before = [tree_state(r) for r in watched]
    t = time.time()
    proc = subprocess.run([sys.executable, *argv], capture_output=True,
                          text=True, timeout=900)
    wall = time.time() - t
    print(proc.stdout[-4000:])
    print(proc.stderr[-2000:], file=sys.stderr)
    after = [tree_state(r) for r in watched]
    changed = [sorted(a ^ b)[:5] for a, b in zip(before, after)]
    print(f"CLI exit {proc.returncode} in {wall:.1f} s; files changed under "
          f"{watched}: {changed}")
    check("Finished training." in proc.stdout, "the CLI did not train")
    check("# of vertices and edges" in proc.stdout, "the CLI did not extract")
    check(not any(changed), f"the CLI wrote under {watched}: {changed}")
    # one epoch leaves the sphere without a zero level set (the JAX
    # package's CLI gives the same empty mesh): the CLI then exits 2 with
    # its warning, as the JAX package's does
    empty = "empty extraction" in proc.stdout
    check(proc.returncode == (2 if empty else 0),
          f"CLI exit {proc.returncode} (empty extraction: {empty})")


def run_cli(argv):
    """The CLI once, with every kernel's count and largest shape and the
    stage timers zeroed just before it.  Returns (stdout, launches, largest
    shapes, wall seconds)."""
    from tropical_torch.extract import subdivide as sp
    from tropical_torch.ops import launches
    from tropical_torch.stanford import train

    for phases in (sp.PHASES, train.PHASES):
        phases.totals.clear()
        phases.counts.clear()
    launches.reset()
    tee = Tee(sys.stdout)
    t = time.time()
    with contextlib.redirect_stdout(tee):
        rc = train.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t
    counts, largest = dict(launches.LAUNCHES), dict(launches.LARGEST)
    counts.update({f"{k}_scatters": v for k, v in launches.SCATTERS.items()})
    check(rc == 0, f"CLI returned {rc}")
    print(f"main path wall {wall:.2f} s; kernel launches (and the encode "
          f"backwards' that scattered a table gradient) {counts}")
    # the paths differentiate in x alone (faces' normals, the GD rescue):
    # none of their backwards scatters a table gradient
    for k in launches.SCATTERS:
        check(counts[f"{k}_scatters"] == 0,
              f"{k}: {counts[k + '_scatters']} launches scattered a table "
              "gradient nobody reads")
    return tee.buf.getvalue(), counts, largest, wall


def summary(text, wall) -> tuple[float, float]:
    """Check the 'Ours' CD/AD row; print the funnel and the stage times.
    Returns the extraction's ``take`` (s) and the "Ours" CD."""
    from tropical_torch.extract import subdivide as sp
    from tropical_torch.stanford import train

    ours_row = re.search(r"^Ours, +\d+, ([-\d.naif]+), +([-\d.naif]+), ",
                         text, re.M)
    check(ours_row, "no 'Ours' row in the evaluation table")
    cd, ad = float(ours_row.group(1)), float(ours_row.group(2))
    print(f"Ours: CD {cd}, AD {ad}")
    check(math.isfinite(cd) and math.isfinite(ad) and cd > 0,
          f"Ours CD {cd} / AD {ad}")
    extract_s = float(re.search(r" take ([\d.]+)", text).group(1))
    funnel = re.search(r"# of vertices and edges = .*faces", text).group(0)
    print(json.dumps({
        "funnel": funnel, "extract_s": extract_s,
        "extract_stage_s": {k: round(v, 4) for k, v in sp.PHASES.totals.items()},
        "eval_stage_s": {k: round(v, 4) for k, v in train.PHASES.totals.items()},
        "wall_s": round(wall, 4), "ours_cd": cd, "ours_ad": ad}))
    return extract_s, cd


def fan_contract(v, ours, ref):
    """The triangles of two meshes on one vertex set (``ours`` mapped onto
    ``ref``'s vertices) under the fan-diagonal contract of
    tests/test_device_faces.py: the rows that differ are as many on each
    side, at most 0.5 % of them, on the same vertices, with the same area
    (a fan's diagonal taken the other way)."""
    s1 = set(map(tuple, np.sort(ours, 1)))
    s2 = set(map(tuple, np.sort(ref, 1)))
    d1, d2 = s1 - s2, s2 - s1

    def area(tris):
        if not tris:
            return 0.0
        p = np.asarray(v, np.float64)[np.asarray(sorted(tris))]
        cr = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        return float(0.5 * np.linalg.norm(cr, axis=1).sum())

    a1, a2 = area(d1), area(d2)
    print(f"triangles against the committed mesh: {len(d1)} / {len(d2)} "
          f"rows differ of {len(s2)}, their areas {a1:.6e} / {a2:.6e}")
    check(len(d1) == len(d2) and len(d1) <= 0.005 * len(s2)
          and {i for t in d1 for i in t} == {i for t in d2 for i in t}
          and abs(a1 - a2) <= 1e-6 * area(s2) + 1e-12,
          "triangles outside the fan-diagonal contract")


def main_path_phase():
    phase("4. flat main path: " + " ".join(MAIN_ARGV))
    from tropical_torch.extract import stats
    from tropical_torch.ops.chamfer import min_dist_plain
    from tropical_torch.utils.ply import read_ply

    text, launches, largest, wall = run_cli(MAIN_ARGV)
    check(stats.LAST == GOLDEN, f"funnel {stats.LAST} != golden {GOLDEN}")
    for k, want in {**MAIN_LAUNCHES, **FLAT_ENCODE}.items():
        check(launches[k] == want, f"{k}: {launches[k]} launches, want {want}")

    # the exported mesh is the committed JAX one: same counts, and each
    # vertex within 1e-4 of its own twin (nearest-neighbour matching that
    # must be one to one)
    ours = read_ply("meshes_torch/sphere/our_mesh_small_1.ply")
    ref = read_ply("meshes/sphere/our_mesh_small_1.ply")
    check(ours.faces.shape == ref.faces.shape
          and ours.vertices.shape == ref.vertices.shape,
          f"mesh {ours.vertices.shape}/{ours.faces.shape} != committed "
          f"{ref.vertices.shape}/{ref.faces.shape}")
    d2, idx = min_dist_plain(
        torch.from_numpy(ours.vertices.astype(np.float32)).cuda(),
        torch.from_numpy(ref.vertices.astype(np.float32)).cuda())
    vmax = math.sqrt(float(d2.max()))
    one_to_one = int(torch.unique(idx).numel()) == ref.vertices.shape[0]
    print(f"exported vs committed mesh: max vertex distance {vmax:.3e}, "
          f"one to one: {one_to_one}")
    check(vmax <= 1e-4 and one_to_one, "exported mesh differs from committed")
    fan_contract(ref.vertices, idx.cpu().numpy()[ours.faces], ref.faces)
    _, cd = summary(text, wall)
    return launches, largest, cd


def curved_path_phase():
    """The curved CLI run.  Returns (launches, every (p, q) the root
    solve was given, the extraction's ``take``)."""
    phase("5. curved main path: " + " ".join(CURVED_ARGV))
    from tropical_torch.core import trilinear as tl
    from tropical_torch.extract import failover as fo
    from tropical_torch.extract import stats
    from tropical_torch.ops.chamfer import min_dist_plain
    from tropical_torch.stanford import train

    # keep the extracted vertices and the root solve's inputs
    kept = {"inputs": []}
    solve, extract = tl.intersection_of_two_planes, train.extract_mesh

    def keep_inputs(p, q):
        if p.shape[0]:
            kept["inputs"].append((p.clone(), q.clone()))
        return solve(p, q)

    def keep_mesh(net, force):
        out = extract(net, force)
        kept.update(net=net, vertices=out[1])
        return out

    tl.intersection_of_two_planes, train.extract_mesh = keep_inputs, keep_mesh
    try:
        text, launches, _, wall = run_cli(CURVED_ARGV)
    finally:
        tl.intersection_of_two_planes, train.extract_mesh = solve, extract
    print(f"failover counters {fo.COUNTERS}")

    # the funnel against the golden; the vertices against the JAX set
    V = kept["vertices"]
    ref = torch.from_numpy(np.load(CURVED_VERTICES)).cuda()
    d_ours, _ = min_dist_plain(V, ref)
    d_ref, _ = min_dist_plain(ref, V)
    far_ours = int((d_ours.sqrt() > 1e-5).sum())
    far_ref = int((d_ref.sqrt() > 1e-5).sum())
    exact = stats.LAST == CURVED_GOLDEN
    diff = {k: stats.LAST[k] - v for k, v in CURVED_GOLDEN.items()}
    print(json.dumps({"funnel_exact": exact, "funnel_minus_golden": diff,
                      "vertices": V.shape[0], "jax_vertices": ref.shape[0],
                      "ours_beyond_1e-5_of_jax": far_ours,
                      "jax_beyond_1e-5_of_ours": far_ref,
                      "max_nn_distance": math.sqrt(float(torch.maximum(
                          d_ours.max(), d_ref.max())))}))
    if not exact:
        allowed = 0.005 * ref.shape[0]
        check(abs(V.shape[0] - ref.shape[0]) <= allowed
              and far_ours <= allowed and far_ref <= allowed,
              f"funnel {stats.LAST} != golden {CURVED_GOLDEN}, and outside "
              "the eps-boundary contract against the JAX vertex set")

    sdf = float(kept["net"].sdf(V).abs().max())
    print(f"max |sdf| on the curved vertices: {sdf:.3e}")
    check(sdf < 2e-4, f"curved vertices off the surface: |sdf| {sdf}")
    steps = fo.COUNTERS["curved_steps"]
    check(launches["min_dist"] == 16,
          f"min_dist: {launches['min_dist']} launches, want 16")
    check(steps > 0 and launches["trilinear_roots"] == steps
          == len(kept["inputs"]),
          f"trilinear_roots: {launches['trilinear_roots']} launches and "
          f"{len(kept['inputs'])} inputs, want one per curved insertion step "
          f"({steps})")
    gd_steps = fo.COUNTERS["gd_steps"]
    for k, want in CURVED_ENCODE.items():
        want += gd_steps if k != "hashgrid_encode_bwd_bwd" else 0
        check(launches[k] == want, f"{k}: {launches[k]} launches, want {want} "
              f"({gd_steps} GD steps)")
    return launches, kept["inputs"], summary(text, wall)[0]


def file_digest(path) -> str:
    import hashlib

    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def run_evaluate(argv):
    """The evaluate CLI once, in-process, with every kernel's count and
    largest shape and the stage timers zeroed just before it.  Returns
    (stdout, the table's rows unrounded, launches, largest shapes, wall
    seconds, stage seconds)."""
    from tropical_torch.ops import launches
    from tropical_torch.stanford import evaluate, train

    scored = evaluate.evaluate_against_grid_gt
    kept = []

    def keep_rows(*args, **kwargs):
        kept.append(scored(*args, **kwargs))
        return kept[-1]

    train.PHASES.totals.clear()
    train.PHASES.counts.clear()
    launches.reset()
    tee = Tee(sys.stdout)
    evaluate.evaluate_against_grid_gt = keep_rows
    t = time.time()
    try:
        with contextlib.redirect_stdout(tee):
            rc = evaluate.main(argv)
        torch.cuda.synchronize()
    finally:
        evaluate.evaluate_against_grid_gt = scored
    wall = time.time() - t
    counts, largest = dict(launches.LAUNCHES), dict(launches.LARGEST)
    check(rc == 0 and len(kept) == 1, f"evaluate {argv} returned {rc}")
    return (tee.buf.getvalue(), kept[0], counts, largest, wall,
            dict(train.PHASES.totals))


class PatchedField:
    """A net's field with its values at some grid points replaced: the
    same batches through ``net.sdf``, then the values of the rows at those
    points overwritten."""

    def __init__(self, net, points, values):
        self.net, self.device = net, net.device
        self.points, self.values = points, values

    def sdf(self, x):
        out = self.net.sdf(x).clone()
        rows, which = (x[:, None, :] == self.points[None]).all(-1).nonzero(
            as_tuple=True)
        out[rows, 0] = self.values[which]
        return out


def zeros_as_jax(net, res, near_zero):
    """The grid indices where the port's field at res is exactly 0, and the
    field with JAX's values there (``near_zero``: the golden's ``[i, j, k,
    value]`` at this resolution).  Fails where JAX's field is not near 0
    at such a point, or gave it two values."""
    from tropical_torch.utils.isosurface import sdf_grid
    from tropical_torch.utils.marching_cubes import grid_axis

    zeros = [tuple(z) for z in
             torch.nonzero(sdf_grid(net, res, 1.2) == 0).tolist()]
    jax_vals = {}
    for i, j, k, v in near_zero:
        jax_vals.setdefault((i, j, k), set()).add(v)
    check(all(len(jax_vals.get(z, ())) == 1 for z in zeros),
          f"at {res} the port's field is 0 at {zeros}, JAX's values there "
          f"{[jax_vals.get(z) for z in zeros]}")
    s = grid_axis(res, 1.2, net.device)
    points = torch.stack([torch.stack([s[i], s[j], s[k]])
                          for i, j, k in zeros]) if zeros else s.new_empty(0, 3)
    values = torch.tensor([next(iter(jax_vals[z])) for z in zeros],
                          dtype=torch.float32, device=net.device)
    return zeros, PatchedField(net, points, values)


def hold_eval_table(method, text, rows, golden, net):
    """Each row (unrounded) and the on-grid count against the JAX CLI's
    golden.  A row whose vertex count differs is rebuilt with JAX's values
    at the port's exact zeros and must then give the golden's count."""
    from evaluate_table import parse_table
    from tropical_torch.utils.isosurface import run_marching_tetrahedra
    from tropical_torch.utils.marching_cubes import run_marching_cubes

    printed = parse_table(text)
    want = golden["runs"][method]
    check([(r["label"], r["vertices"]) for r in printed["rows"]]
          == [r[:2] for r in rows], f"{method}: printed rows "
          f"{printed['rows']} are not the returned {rows}")
    check([r[0] for r in rows] == [r["label"] for r in want["rows"]],
          f"{method}: rows {[r[0] for r in rows]}")
    check(printed["on_grid"] == want["on_grid"],
          f"{method}: {printed['on_grid']} vertices on the grid marks, "
          f"golden {want['on_grid']}")
    gt_res = int(rows[1][0])
    for (label, n_verts, cd, ad, t), g in zip(rows, want["rows"]):
        dcd, dad = abs(cd - g["cd_nn"]), abs(ad - g["ad_jax"])
        rebuilt = ""
        if n_verts != g["vertices"]:
            res = int(label)
            zeros, field = zeros_as_jax(net, res,
                                        want["near_zero"].get(str(res), []))
            run = (run_marching_cubes if method == "mc" or res == gt_res
                   else run_marching_tetrahedra)
            n_as_jax = run(field, res, 1.2).vertices.shape[0]
            rebuilt = (f"; exact zeros at {zeros}, with JAX's values there "
                       f"{n_as_jax}")
            check(n_as_jax == g["vertices"], f"{method} row {label}: "
                  f"{n_verts} vertices{rebuilt}, golden {g['vertices']}")
        print(f"  {label:>4}: {n_verts} vertices (golden {g['vertices']}"
              f"{rebuilt}), CD {cd:.9f} (exact neighbours {g['cd_nn']:.9f}, "
              f"off {cd - g['cd_nn']:.3e}; JAX's {g['cd_jax']:.9f}), AD "
              f"{ad:.4f} ({g['ad_jax']:.4f}), {t:.2f} s")
        check(dcd <= EVAL_CD_TOL and dad <= EVAL_AD_TOL,
              f"{method} row {label}: CD {cd}, AD {ad} against the golden "
              f"{g}")
    return rows


def hold_committed_mt(tag):
    """The exported marching-tetrahedra meshes at 16..64 against the
    committed ones: equal faces under a nearest-neighbour bijection."""
    from tropical_torch.ops.chamfer import min_dist_plain
    from tropical_torch.utils.ply import read_ply

    out = {}
    for res in (16, 32, 48, 64):
        name = f"mtet{res:03d}_mesh_{tag}.ply"
        ours = read_ply(os.path.join("meshes_torch", "sphere", name))
        ref = read_ply(os.path.join("meshes", "sphere", name))
        check(ours.faces.shape == ref.faces.shape
              and ours.vertices.shape == ref.vertices.shape,
              f"{name}: {ours.vertices.shape}/{ours.faces.shape} != committed "
              f"{ref.vertices.shape}/{ref.faces.shape}")
        d2, idx = min_dist_plain(
            torch.from_numpy(ours.vertices.astype(np.float32)).cuda(),
            torch.from_numpy(ref.vertices.astype(np.float32)).cuda())
        idx = idx.cpu().numpy()
        dist = float(np.abs(ours.vertices - ref.vertices[idx]).max())
        bijection = len(np.unique(idx)) == len(idx)
        faces = bool(np.array_equal(idx[ours.faces], ref.faces))
        out[res] = {"faces": int(ours.faces.shape[0]), "bijection": bijection,
                    "faces_equal": faces, "max_vertex_distance": dist}
        check(bijection and faces and dist <= COMMITTED_MT_TOL,
              f"{name} against the committed mesh: {out[res]}")
    print(json.dumps({"committed_mtet": out}))


def mt_card_vs_cpu(net):
    """Marching tetrahedra on the card and on the CPU over one field the
    card computed: vertices and triangles bitwise."""
    from tropical_torch.utils import isosurface as iso
    from tropical_torch.utils.marching_cubes import grid_axis, grid_points

    res = MT_BITWISE_RES
    vals = iso.sdf_grid(net, res, 1.2).reshape(-1)
    pts = grid_points(grid_axis(res, 1.2, net.device), 0,
                      res ** 3).to(torch.float64)
    tets = iso.grid_tetrahedra(res, res, net.device)
    v_gpu, t_gpu = iso.marching_tetrahedra(pts, tets, vals)
    v_cpu, t_cpu = iso.marching_tetrahedra(pts.cpu(), tets.cpu(), vals.cpu())
    same = (torch.equal(v_gpu.cpu(), v_cpu)
            and torch.equal(t_gpu.cpu(), t_cpu))
    print(f"marching tetrahedra at {res} on the card's field: "
          f"{v_gpu.shape[0]} vertices, {t_gpu.shape[0]} triangles; card and "
          f"CPU bitwise: {same}")
    check(same and t_gpu.shape[0] > 0,
          "marching tetrahedra differ between the card and the CPU")


def slab_merges(net):
    """Every crossing on the slabs' shared x-planes merges, for marching
    tetrahedra at the ladder's sizes and marching cubes at both pseudo-GTs."""
    from tropical_torch.utils import isosurface as iso
    from tropical_torch.utils import marching_cubes as mc

    out = {}
    for name, slabs, res in [("mt", iso.mt_slabs, r) for r in (32, 48, 64, 96)] \
            + [("mc", mc.mc_slabs, r) for r in (128, 256)]:
        merged, crossings = mc.slab_merge_counts(slabs(net, res, 1.2))
        out[f"{name}{res}"] = [merged, crossings]
        check(merged == crossings > 0,
              f"{name} at {res}: {merged} vertices merged across slabs, "
              f"{crossings} crossings on the shared planes")
    print(json.dumps({"slab_merges_and_crossings": out}))


def evaluate_phase(mesh_digest, records):
    """The evaluate CLI, -t mtet and -t mc, on phase 4's mesh; then the
    encode forward at the runs' largest forward.  Returns each run's
    kernel launches."""
    from tropical_torch.stanford.model import net_for_size
    from tropical_torch.stanford.evaluate import resolutions_for
    from tropical_torch.stanford.train import cached_checkpoint
    from tropical_torch.utils import checkpoint as ckpt
    from tropical_torch.utils.marching_cubes import SLAB

    sys.path.insert(0, "tests")
    mesh = "meshes_torch/sphere/our_mesh_small_1.ply"
    golden = json.load(open(EVAL_GOLDEN))
    net = net_for_size("small", "sphere", 1, device="cuda")
    ckpt.load_into(net, cached_checkpoint("sphere", "small", 1))
    launches, largest = {}, {}
    for method, argv in EVAL_ARGV.items():
        phase("9. evaluate CLI: python -m tropical_torch.stanford.evaluate "
              + " ".join(argv))
        check(file_digest(mesh) == mesh_digest,
              f"{mesh} is not the mesh phase 4 wrote")
        text, rows, counts, shapes, wall, stages = run_evaluate(argv)
        hold_eval_table(method, text, rows, golden, net)
        gt_res = int(rows[1][0])
        ladder = resolutions_for(method, "small", gt_res)
        want = {"hashgrid_encode_fwd": sum(len(range(0, r - 1, SLAB))
                                           for r in ladder),
                # "Ours" and each baseline row, two searches each
                "min_dist": 2 * (len(rows) - 1)}
        print(json.dumps({"method": method, "wall_s": wall,
                          "eval_stage_s": stages,
                          "row_s": {r[0]: r[4] for r in rows},
                          "launches": counts, "largest": shapes}))
        for k, n in want.items():
            check(counts[k] == n, f"{method}: {k} {counts[k]} launches, "
                  f"want {n}")
        check(counts["trilinear_roots"] == 0
              and counts["hashgrid_encode_bwd"] == 0,
              f"{method}: unexpected launches {counts}")
        launches[method] = counts
        for k, shape in shapes.items():
            if shape and math.prod(shape) > math.prod(largest.get(k, (0,))):
                largest[k] = shape
        if method == "mtet":
            hold_committed_mt("small_1")

    mt_card_vs_cpu(net)
    slab_merges(net)
    # no search larger than the 100,000 x 100,000 held in phase 3
    check(max(largest["min_dist"]) <= 100000,
          f"evaluate's largest min_dist {largest['min_dist']}")
    phase("9. the encode forward at the evaluate runs' largest forward, the "
          f"{EVAL_GT_RES} pseudo-GT's first slab, on the checkpoint's table")
    encode_on_slab(records["hashgrid_encode_fwd"], "evaluate", net.spec.grid,
                   net.enc.table.detach(), largest["hashgrid_encode_fwd"],
                   EVAL_GT_RES, 0)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    import tropical_torch  # noqa: F401  (fails outside a checkout)

    name, smi = device_phase()
    build_phase()
    records = {r["name"]: r for r in kernel_phase()}
    flat_launches, flat_largest, flat_cd = main_path_phase()
    mesh_digest = file_digest("meshes_torch/sphere/our_mesh_small_1.ply")
    curved_launches, curved_inputs, curved_take = curved_path_phase()
    records["min_dist"]["launches"] = flat_launches["min_dist"]
    records["min_dist"]["launches_curved"] = curved_launches["min_dist"]
    records["trilinear_roots"]["launches"] = curved_launches["trilinear_roots"]
    shapes_phase(records, flat_largest, curved_inputs, curved_take)
    train_launches = training_phase(flat_cd)
    for k in ENCODE:
        records[k].update(launches=train_launches[k],
                          launches_flat=flat_launches[k],
                          launches_curved=curved_launches[k])
        if f"{k}_scatters" in train_launches:
            records[k].update(
                scatters=train_launches[f"{k}_scatters"],
                scatters_flat=flat_launches[f"{k}_scatters"],
                scatters_curved=curved_launches[f"{k}_scatters"])
    cli_training_phase()
    eval_launches = evaluate_phase(mesh_digest, records)
    for k in ("min_dist", "hashgrid_encode_fwd"):
        records[k].update(
            launches_evaluate=sum(c[k] for c in eval_launches.values()),
            **{f"launches_evaluate_{m}": c[k]
               for m, c in eval_launches.items()})

    phase("10. result")
    print(json.dumps({"kernels": list(records.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
