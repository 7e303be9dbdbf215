#!/usr/bin/env python3
"""Time variants of the BVH's ``bvh_closest`` and ``bvh_refit`` kernels on
one card.

    python3 scripts/bvh_variants.py [--variants design,first,...] [--json PATH]

Each variant is ``tropical_torch/csrc/bvh.cu`` built by ``ops/cuda_build``
with other ``-D`` macros:

- ``design``: as committed (pass 1 on a budget of 256 box tests, pass 2
  four warps a queued point, node records, the closest point's case by
  selects, idle lanes handed subtrees; the refit's block levels in shared
  memory);
- ``first``: the first designs (``-DBVH_CLOSEST_ONE_THREAD``, one thread a
  point to the end; ``-DBVH_REFIT_FENCES``, every level in device memory
  between two ``__threadfence``);
- ``split``: ``-DBVH_CLOSEST_SPLIT_LOADS``, the two passes reading a
  node's children and then their boxes, and a triangle, a float at a time
  (the first design's layout), instead of the 64-byte node records and the
  padded triangles;
- ``branches``: ``-DBVH_CLOSEST_BRANCHES``, the closest point's case
  picked by branches (on which a warp's lanes part) instead of selects;
- ``no_donate``: ``-DBVH_CLOSEST_NO_DONATE``, pass 2's lanes kept to the
  subtrees the breadth-first start gave them;
- ``warps1``, ``warps2``: ``-DBVH_CLOSEST_WARPS=k``, pass 2's warps a
  queued point (the design's 4);
- ``budget0``, ``budget64``, ``budget1024``: ``-DBVH_CLOSEST_BUDGET=k``
  (0: every point through pass 2);
- ``device_only``: ``-DBVH_REFIT_DEVICE_ONLY``, the refit's one
  acquire-release fetch_add a level, every level in device memory;
- ``no_records``: ``-DBVH_REFIT_NO_RECORDS``, the refit without the node
  records and padded triangles that the two-pass query reads (its boxes
  checked only).

``design`` is also timed on the label points sorted by the Morton code of
their cell in their box (``sorted``; the sort's own time apart): whether
neighbouring lanes that walk the same part of the tree are worth a sort.

Inputs: the training labels' resample (50,000 points on the 5,120-triangle
icosphere, ``StanfordDataset("sphere")``, seed 1), 2,000 points within
0.05 of that icosphere's centre, and 256 within 0.05 of the centre of the
256 marching-cubes pseudo-GT of the committed sphere-small checkpoint
(``tests/bvh_cases.py``); for the refit, that pseudo-GT and the flat
run's largest ladder mesh (marching cubes at 128).  For each variant it
prints whether it returns the plain versions' bits on every input, each
kernel's registers and shared memory (``-Xptxas -v``), the points queued
for pass 2, and device times (``graph_ms``: 100 calls in one CUDA graph;
the first design on the pseudo-GT's centre points, CUDA events over 3
calls).  ``--json`` writes the whole result to a file.

A measurement tool: the port never loads these builds.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import bvh_cases  # noqa: E402
from tropical_torch.ops import bvh, cuda_build  # noqa: E402
from tropical_torch.ops import mesh_queries as mq  # noqa: E402

VARIANTS = {"design": (), "first": ("BVH_CLOSEST_ONE_THREAD",
                                    "BVH_REFIT_FENCES"),
            "split": ("BVH_CLOSEST_SPLIT_LOADS",),
            "branches": ("BVH_CLOSEST_BRANCHES",),
            "no_donate": ("BVH_CLOSEST_NO_DONATE",),
            "warps1": ("BVH_CLOSEST_WARPS=1",),
            "warps2": ("BVH_CLOSEST_WARPS=2",),
            "device_only": ("BVH_REFIT_DEVICE_ONLY",),
            "no_records": ("BVH_REFIT_NO_RECORDS",)}
VARIANTS.update({f"budget{k}": (f"BVH_CLOSEST_BUDGET={k}",)
                 for k in (0, 64, 1024)})
# the variants that change only one kernel, and are timed only on it
REFIT_ONLY = {"device_only", "no_records"}
CLOSEST_ONLY = {"split", "branches", "no_donate", "warps1", "warps2",
                "budget0", "budget64", "budget1024"}


def cuda_ms(fn, iters: int = 10) -> float:
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
    """Device milliseconds per call: ``reps`` calls in one CUDA graph."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay) / reps


def build(names):
    """Each variant's library and, by kernel, its registers, shared bytes,
    stack frame and spilled bytes, from ptxas."""
    targets = {name: ("bvh", VARIANTS[name]) for name in names}
    logs = cuda_build.build(targets.values())
    libs, usage = {}, {}
    for name, target in targets.items():
        log = logs[cuda_build.label(target)]
        libs[name] = cuda_build.load(target)
        usage[name] = {}
        kernel = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '_Z\w*?N\d+_GLOBAL__N_\w*?"
                          r"(\d+)(\w+?_kernel)", line)
            if m:
                kernel = m.group(2)
            frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores", line)
            if kernel and frame:
                usage[name].setdefault(kernel, {}).update(
                    stack_frame=int(frame.group(1)),
                    spill_stores=int(frame.group(2)))
            used = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?",
                             line)
            if kernel and used:
                usage[name].setdefault(kernel, {}).update(
                    registers=int(used.group(1)),
                    smem=int(used.group(2) or 0))
    return libs, usage


def same_bits(a, b) -> bool:
    nan = torch.isnan(b)
    return (torch.equal(torch.isnan(a), nan)
            and torch.equal(a[~nan].view(torch.int32),
                            b[~nan].view(torch.int32)))


def morton_order(p: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts points [N, 3] by the Morton code of their
    cell (10 bits an axis) in their box."""
    lo = p.amin(dim=0)
    ext = (p.amax(dim=0) - lo).clamp_min(1e-30)
    cell = ((p - lo) / ext * 1024).floor().clamp(0, 1023).to(torch.int64)
    code = ((bvh._spread(cell[:, 0]) << 2) | (bvh._spread(cell[:, 1]) << 1)
            | bvh._spread(cell[:, 2]))
    return torch.sort(code).indices


def inputs():
    """(labels' MeshQuery, label points, labels' centre points, pseudo-GT
    MeshQuery, its centre points, ladder MeshQuery)."""
    from tropical_torch.stanford import train
    from tropical_torch.stanford.dataset import StanfordDataset
    from tropical_torch.stanford.model import net_for_size
    from tropical_torch.utils import checkpoint as ckpt
    from tropical_torch.utils.marching_cubes import run_marching_cubes

    with contextlib.redirect_stdout(io.StringIO()):
        ds = StanfordDataset("sphere", rng=np.random.default_rng(1),
                             device="cuda")
    net = net_for_size("small", "sphere", 1, device="cuda")
    ckpt.load_into(net, ckpt.find_checkpoint(
        train.model_path_for("sphere", "small", 1,
                             train.COMMITTED_MODELS_DIR)))
    meshes = {}
    for res in (256, 128):
        m = run_marching_cubes(net, res, train.CANVAS_SIZE, R=train.DATASET_R)
        meshes[res] = mq.MeshQuery(m.vertices, m.faces, "cuda")
    return (ds.query, ds.X,
            bvh_cases.centre_points(ds.query.tris, 2000, 11), meshes[256],
            bvh_cases.centre_points(meshes[256].tris, 256, 11), meshes[128])


def closest_run(lib, tree, p):
    d2 = torch.empty(p.shape[0], dtype=torch.float32, device=p.device)
    state = torch.zeros(2, dtype=torch.int32, device=p.device)
    queue = torch.empty((p.shape[0], 2), dtype=torch.int32, device=p.device)

    def run():
        bvh.launch_closest(lib, tree, p, d2, state, queue)

    return run, d2, state


def refit_run(lib, tree):
    arrivals = torch.zeros(max(tree.n - 1, 1), dtype=torch.int32,
                           device="cuda")
    out = [torch.empty_like(t) for t in (tree.boxes, tree.records,
                                         tree.tris_padded)]

    def run():
        arrivals.zero_()
        bvh.launch_refit(lib, tree.tris, tree.children, tree.parents,
                         tree.far, tree.pad, arrivals, *out)

    return run, out


def time_closest(name, lib, sets, plain):
    out = {}
    for label, (tree, p) in sets.items():
        run, d2, state = closest_run(lib, tree, p)
        run()
        torch.cuda.synchronize()
        ok = same_bits(d2, plain[label]) and int(state[0]) == 0
        queued = int(state[1])
        slow = name == "first" and label == "pseudo-GT centre"
        ms = cuda_ms(run, 3) if slow else graph_ms(run)
        out[label] = {"bitwise": ok, "queued": queued, "ms": ms,
                      "points": p.shape[0], "triangles": tree.n}
    return out


def time_refit(name, lib, trees):
    """Device ms of the refit at each tree, and whether its boxes (and where
    it writes them its node records and padded triangles) are the
    wrapper's bits."""
    out = {}
    for label, tree in trees.items():
        run, got = refit_run(lib, tree)
        ms = graph_ms(run)
        torch.cuda.synchronize()
        want = (tree.boxes, tree.records, tree.tris_padded)
        kept = 1 if name in ("first", "no_records") else 3
        out[label] = {"bitwise": all(
            torch.equal(a.view(torch.int32), b.view(torch.int32))
            for a, b in zip(got[:kept], want[:kept])),
            "ms": ms, "triangles": tree.n}
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variants", default=",".join(VARIANTS),
                        help="comma-separated names (default: all)")
    parser.add_argument("--json", type=Path, default=None,
                        help="write the whole result here")
    args = parser.parse_args()
    names = args.variants.split(",")
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("bvh_variants: CUDA is not available", file=sys.stderr)
        return 1
    os.chdir(ROOT)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    libs, usage = build(names)
    lq, points, centre, gt, gt_centre, ladder = inputs()
    order = morton_order(points)
    sort_ms = cuda_ms(lambda: points[morton_order(points)])
    sorted_points = points[order].contiguous()
    sets = {"labels": (lq.bvh, points), "labels centre": (lq.bvh, centre),
            "pseudo-GT centre": (gt.bvh, gt_centre)}
    plain = {label: mq.min_dist2_plain(
        lq.tris if tree is lq.bvh else gt.tris, p)
        for label, (tree, p) in sets.items()}
    trees = {"pseudo-GT": gt.bvh, "ladder": ladder.bvh}
    print(f"labels {points.shape[0]} x {lq.bvh.n}; centre sets 2000 x "
          f"{lq.bvh.n}, 256 x {gt.bvh.n}; refit at {gt.bvh.n} and "
          f"{ladder.bvh.n}; the Morton sort of the labels {sort_ms:.4f} ms",
          flush=True)
    results = []
    for name in names:
        lib = libs[name]
        rec = {"variant": name, "defines": VARIANTS[name],
               "kernels": usage[name]}
        if name not in REFIT_ONLY:
            rec["closest"] = time_closest(name, lib, sets, plain)
            if name == "design":
                rec["closest"]["labels sorted"] = time_closest(
                    name, lib, {"labels": (lq.bvh, sorted_points)},
                    {"labels": plain["labels"][order]})["labels"]
        if name not in CLOSEST_ONLY:
            rec["refit"] = time_refit(name, lib, trees)
        results.append(rec)
        print(json.dumps(rec), flush=True)
    ok = all(r["bitwise"] for rec in results
             for kind in ("closest", "refit") for r in rec.get(kind, {}).values())
    summary = {"device": smi, "sort_ms": sort_ms, "variants": results,
               "bitwise": ok}
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(summary, indent=1))
    for rec in results:
        c = rec.get("closest", {})
        r = rec.get("refit", {})
        print(f"{rec['variant']:12s} " + "; ".join(
            [f"{k} {v['ms']:.4f} ms (queued {v['queued']})"
             for k, v in c.items()]
            + [f"refit {k} {v['ms']:.4f} ms" for k, v in r.items()]))
    print(f"all bitwise: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
