#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``tropical_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each fatal on failure:

1. device: the card's name and power limit;
2. build: every kernel of the main paths from ``tropical_torch/csrc/`` (one
   ``nvcc`` per source, all started together), with the ``-Xptxas -v``
   register and shared-memory summary; no spills;
3. kernels vs plain: each kernel against its plain PyTorch version, bit for
   bit, on inputs hard for it.  ``min_dist`` at the flat path's shapes, its
   launch plan and the share of its work that took the exact path (from an
   instrumented build), then kernel, plain and library times (CUDA
   events); ``trilinear_roots`` on the rows of
   ``tests/trilinear_cases.py:kernel_pq`` and 100,000 seeded rows;
4. flat main path: the CLI ``-e -m small -d sphere -s 1 --gt_res 128`` on
   ``cuda``, held to the golden funnel, the committed mesh and the kernel
   launch counts;
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
   companion matrices timed;
7. one JSON line of kernel records, the card's line, and the result line.

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
EXACT_COUNT = ("min_dist", ("MIN_DIST_COUNT_EXACT",))


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
    targets = ["min_dist", EXACT_COUNT, "trilinear_roots"]
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
    return [min_dist_phase(), trilinear_roots_phase()]


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
    check(rc == 0, f"CLI returned {rc}")
    print(f"main path wall {wall:.2f} s; kernel launches {counts}")
    return tee.buf.getvalue(), counts, largest, wall


def summary(text, wall) -> float:
    """Check the 'Ours' CD/AD row; print the funnel and the stage times.
    Returns the extraction's ``take`` (s)."""
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
    return extract_s


def main_path_phase():
    phase("4. flat main path: " + " ".join(MAIN_ARGV))
    from tropical_torch.extract import stats
    from tropical_torch.ops.chamfer import min_dist_plain
    from tropical_torch.utils.ply import read_ply

    text, launches, largest, wall = run_cli(MAIN_ARGV)
    check(stats.LAST == GOLDEN, f"funnel {stats.LAST} != golden {GOLDEN}")
    for k, want in MAIN_LAUNCHES.items():
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
    summary(text, wall)
    return launches, largest


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
    return launches, kept["inputs"], summary(text, wall)


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
    flat_launches, flat_largest = main_path_phase()
    curved_launches, curved_inputs, curved_take = curved_path_phase()
    records["min_dist"]["launches"] = flat_launches["min_dist"]
    records["min_dist"]["launches_curved"] = curved_launches["min_dist"]
    records["trilinear_roots"]["launches"] = curved_launches["trilinear_roots"]
    shapes_phase(records, flat_largest, curved_inputs, curved_take)

    phase("7. result")
    print(json.dumps({"kernels": list(records.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
