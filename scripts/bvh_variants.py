#!/usr/bin/env python3
"""Time variants of the BVH's kernels on one card.

    python3 scripts/bvh_variants.py [--variants design,first,...] [--json PATH]

Each variant is ``tropical_torch/csrc/bvh.cu`` built by ``ops/cuda_build``
with other ``-D`` macros:

- ``design``: as committed (``bvh_closest``: pass 1 on a budget of 256 box
  tests, pass 2 four warps a queued point, node records, the closest
  point's case by selects, idle lanes handed subtrees; ``bvh_refit``: the
  block's levels in shared memory; ``bvh_ray``: node records and padded
  triangles, one lane a ray, the stack in local memory with its top in
  registers, the slab test's NaN told by a sum; ``bvh_hierarchy``: pass 1
  from the block's
  window of keys, in 32 bits, a node whose range passes 256 keys queued
  for a warp in pass 2);
- ``first``: the first designs (``-DBVH_CLOSEST_ONE_THREAD``, one thread a
  point to the end; ``-DBVH_REFIT_FENCES``, every level in device memory
  between two ``__threadfence``; ``-DBVH_RAY_ONE_THREAD``, one thread a
  ray, children then boxes, its stack in local memory;
  ``-DBVH_HIERARCHY_ONE_THREAD``, one kernel, every search on the node's
  thread, in 64 bits);
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
  checked only);
- ``ray_split``: ``-DBVH_RAY_SPLIT_LOADS``, ``bvh_ray`` reading children
  and then boxes, and a triangle a float at a time;
- ``ray_lanes2``, ``ray_lanes4``: ``-DBVH_RAY_LANES=k``, k lanes a ray
  (the design's 1) sharing the best by shuffles;
- ``hier_warp4`` .. ``hier_warp11``: ``-DBVH_HIERARCHY_WARP_LOG=k``, the
  warp pass's threshold 2^k (the design's 2^8).

``design`` is also timed on the label points sorted by the Morton code of
their cell in their box (``sorted``; the sort's own time apart): whether
neighbouring lanes that walk the same part of the tree are worth a sort;
and ``bvh_ray`` on the rays sorted by a key of origin and direction
(``ray_order``), the key, the sort, the gathers and the scatter of the
results counted in the call.

Inputs: the training labels' resample (50,000 points on the 5,120-triangle
icosphere, ``StanfordDataset("sphere")``, seed 1), 2,000 points within
0.05 of that icosphere's centre, and 256 within 0.05 of the centre of the
256 marching-cubes pseudo-GT of the committed sphere-small checkpoint
(``tests/bvh_cases.py``); for the build, that pseudo-GT and the flat
run's largest ladder mesh (marching cubes at 128); for ``bvh_ray``, the
100,000 evaluation rays on the pseudo-GT and the labels' parity rays.  For
each variant it prints whether it returns the plain versions' bits on
every input, each kernel's registers, shared memory and stack frame
(``-Xptxas -v``), the points queued for pass 2, the nodes queued for
the hierarchy's warp pass, and device times (``graph_ms``: 100 calls in one CUDA graph; the first design
on the pseudo-GT's centre points, CUDA events over 3 calls).  ``--json``
writes the whole result to a file.

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
                                    "BVH_REFIT_FENCES", "BVH_RAY_ONE_THREAD",
                                    "BVH_HIERARCHY_ONE_THREAD"),
            "split": ("BVH_CLOSEST_SPLIT_LOADS",),
            "branches": ("BVH_CLOSEST_BRANCHES",),
            "no_donate": ("BVH_CLOSEST_NO_DONATE",),
            "warps1": ("BVH_CLOSEST_WARPS=1",),
            "warps2": ("BVH_CLOSEST_WARPS=2",),
            "device_only": ("BVH_REFIT_DEVICE_ONLY",),
            "no_records": ("BVH_REFIT_NO_RECORDS",)}
VARIANTS.update({f"budget{k}": (f"BVH_CLOSEST_BUDGET={k}",)
                 for k in (0, 64, 1024)})
VARIANTS["ray_split"] = ("BVH_RAY_SPLIT_LOADS",)
VARIANTS.update({f"ray_lanes{k}": (f"BVH_RAY_LANES={k}",) for k in (2, 4)})
VARIANTS.update({f"hier_warp{k}": (f"BVH_HIERARCHY_WARP_LOG={k}",)
                 for k in (4, 6, 7, 9, 10, 11)})
# the hierarchy's sizes of the sweep (the pseudo-GT's keys cut short)
HIERARCHY_SWEEP = (2_000, 20_000, 50_000, 200_000)
# the variants that change only one kernel, and are timed only on it
REFIT_ONLY = {"device_only", "no_records"}
CLOSEST_ONLY = {"split", "branches", "no_donate", "warps1", "warps2",
                "budget0", "budget64", "budget1024"}


def kernels_of(name):
    """The kernels a variant is timed on."""
    if name in REFIT_ONLY:
        return ("refit",)
    if name in CLOSEST_ONLY:
        return ("closest",)
    if name.startswith("ray_"):
        return ("ray",)
    if name.startswith("hier_"):
        return ("hierarchy",)
    return ("closest", "refit", "ray", "hierarchy")


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
                          r"(\d+)(\w+?_kernel)(I(?:L\w+?E)+E)?", line)
            if m:  # a template's instance keeps its mangled arguments
                kernel = m.group(2) + (m.group(3) or "")
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


def ray_keys(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """int64 keys [N] of rays: the Morton code of the origin's cell in the
    origins' box, then that of the direction's cell in [-1, 1]^3 (10 bits
    an axis each)."""
    def code(x, lo, ext):
        cell = ((x - lo) / ext * 1024).floor().clamp(0, 1023).to(torch.int64)
        return ((bvh._spread(cell[:, 0]) << 2) | (bvh._spread(cell[:, 1]) << 1)
                | bvh._spread(cell[:, 2]))

    lo = o.amin(dim=0)
    ext = (o.amax(dim=0) - lo).clamp_min(1e-30)
    return (code(o, lo, ext) << 30) | code(d.expand_as(o), -1.0, 2.0)


def ordered_ray(lib, tree, o, d, count, t, ids, overflow):
    """``launch_ray`` on the rays sorted by ``ray_keys``, the results
    scattered back into ``t`` and ``ids``: the ray-order variant, whole."""
    perm = torch.sort(ray_keys(o, d)).indices
    so = o[perm]
    sd = d[perm] if d.shape[0] == o.shape[0] else d
    st, sid = torch.empty_like(t), torch.empty_like(ids)
    bvh.launch_ray(lib, tree, so, sd, count, st, sid, overflow)
    t[perm] = st
    ids[perm] = sid


def time_ray(lib, sets, plain):
    """Device ms of ``bvh_ray`` on each (tree, o, d, count) of ``sets``, and
    whether it returns the plain tiles' bits."""
    out = {}
    for label, (tree, o, d, count) in sets.items():
        n = o.shape[0]
        t = torch.empty(n, dtype=torch.float32, device=o.device)
        ids = torch.empty(n, dtype=torch.int32, device=o.device)
        overflow = torch.zeros(1, dtype=torch.int32, device=o.device)

        def run():
            bvh.launch_ray(lib, tree, o, d, count, t, ids, overflow)

        run()
        torch.cuda.synchronize()
        out[label] = {"bitwise": ray_same(t, ids, plain[label], count)
                      and int(overflow) == 0,
                      "ms": graph_ms(run), "rays": n, "triangles": tree.n}
    return out


def ray_same(t, ids, want, count) -> bool:
    if count:
        return torch.equal(ids.long(), want)
    return (torch.equal(t.view(torch.int32), want[0].view(torch.int32))
            and torch.equal(ids.long(), want[1]))


def time_ray_order(lib, sets, plain):
    """``ordered_ray`` on each set: bitwise, its device ms (a CUDA graph,
    None where the sort will not capture) and one call's ms (CUDA events
    over 20 calls) beside the unsorted launch's call."""
    out = {}
    for label, (tree, o, d, count) in sets.items():
        n = o.shape[0]
        t = torch.empty(n, dtype=torch.float32, device=o.device)
        ids = torch.empty(n, dtype=torch.int32, device=o.device)
        overflow = torch.zeros(1, dtype=torch.int32, device=o.device)

        def run():
            ordered_ray(lib, tree, o, d, count, t, ids, overflow)

        def plain_call():
            bvh.launch_ray(lib, tree, o, d, count, t, ids, overflow)

        run()
        torch.cuda.synchronize()
        ok = ray_same(t, ids, plain[label], count) and int(overflow) == 0
        try:
            ms = graph_ms(run)
        except RuntimeError:
            ms = None
        out[label] = {"bitwise": ok, "ms": ms, "call_ms": cuda_ms(run, 20),
                      "unsorted_call_ms": cuda_ms(plain_call, 20),
                      "sort_keys_ms": cuda_ms(
                          lambda: torch.sort(ray_keys(o, d)), 20)}
    return out


def time_hierarchy(lib, trees):
    """Device ms of ``bvh_hierarchy`` at each (keys, its children, parents
    and far ends), and whether it returns them."""
    out = {}
    for label, (keys, want) in trees.items():
        got = (torch.empty_like(want[0]), torch.full_like(want[1], -1),
               torch.empty_like(want[2]))
        # zeroed once: the first design leaves it so
        queue = torch.zeros(keys.shape[0], dtype=torch.int32,
                            device=keys.device)

        def run():
            bvh.launch_hierarchy(lib, keys, *got, queue)

        ms = graph_ms(run)
        torch.cuda.synchronize()
        out[label] = {"bitwise": all(torch.equal(a, b)
                                     for a, b in zip(got, want)),
                      "ms": ms, "keys": keys.shape[0],
                      "queued": int(queue[0])}
    return out


def time_presorted(lib, sets, plain):
    """``bvh_ray``'s device ms on the rays sorted by ``ray_keys`` ahead of
    the timing: what the order alone is worth to the kernel."""
    out = {}
    for label, (tree, o, d, count) in sets.items():
        perm = torch.sort(ray_keys(o, d)).indices
        so = o[perm].contiguous()
        sd = d[perm].contiguous() if d.shape[0] == o.shape[0] else d
        t = torch.empty(o.shape[0], dtype=torch.float32, device=o.device)
        ids = torch.empty(o.shape[0], dtype=torch.int32, device=o.device)
        overflow = torch.zeros(1, dtype=torch.int32, device=o.device)

        def run():
            bvh.launch_ray(lib, tree, so, sd, count, t, ids, overflow)

        ms = graph_ms(run)
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(perm.shape[0], device=perm.device)
        out[label] = {"bitwise": ray_same(t[inv], ids[inv], plain[label],
                                          count),
                      "ms": ms}
    return out


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
    from tropical_torch.utils.chamfer import get_rays

    o, d = get_rays(100_000, device="cuda")
    direction = torch.from_numpy(mq._PARITY_DIR).cuda().reshape(1, 3)
    ray_sets = {"first hits": (gt.bvh, o, d, False),
                "labels parity": (lq.bvh, points, direction, True)}
    ray_plain = {"first hits": mq.first_hits_plain(gt.tris, o, d),
                 "labels parity": mq.crossings_plain(lq.tris, points,
                                                     direction[0])}
    hier_trees = {label: (bvh.morton_keys(q.tris),
                          (q.bvh.children, q.bvh.parents, q.bvh.far))
                  for label, q in (("pseudo-GT", gt), ("ladder", ladder))}
    gt_keys = hier_trees["pseudo-GT"][0]
    sweep = {f"first {m}": (gt_keys[:m], bvh.hierarchy_plain(gt_keys[:m]))
             for m in HIERARCHY_SWEEP}
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
        timed = kernels_of(name)
        if "closest" in timed:
            rec["closest"] = time_closest(name, lib, sets, plain)
            if name == "design":
                rec["closest"]["labels sorted"] = time_closest(
                    name, lib, {"labels": (lq.bvh, sorted_points)},
                    {"labels": plain["labels"][order]})["labels"]
        if "refit" in timed:
            rec["refit"] = time_refit(name, lib, trees)
        if "ray" in timed:
            rec["ray"] = time_ray(lib, ray_sets, ray_plain)
            if name == "design":
                rec["ray_order"] = time_ray_order(lib, ray_sets, ray_plain)
                rec["ray_presorted"] = time_presorted(lib, ray_sets, ray_plain)
        if "hierarchy" in timed:
            rec["hierarchy"] = time_hierarchy(lib, hier_trees)
            if name in ("design", "first"):
                rec["hierarchy_sweep"] = time_hierarchy(lib, sweep)
        results.append(rec)
        print(json.dumps(rec), flush=True)
    kinds = ("closest", "refit", "ray", "ray_order", "ray_presorted",
             "hierarchy", "hierarchy_sweep")
    ok = all(r["bitwise"] for rec in results
             for kind in kinds for r in rec.get(kind, {}).values())
    summary = {"device": smi, "sort_ms": sort_ms, "variants": results,
               "bitwise": ok}
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(summary, indent=1))
    for rec in results:
        c = rec.get("closest", {})
        r = rec.get("refit", {})
        print(f"{rec['variant']:14s} " + "; ".join(
            [f"{k} {v['ms']:.4f} ms (queued {v['queued']})"
             for k, v in c.items()]
            + [f"refit {k} {v['ms']:.4f} ms" for k, v in r.items()]
            + [f"ray {k} {v['ms']:.4f} ms"
               for k, v in rec.get("ray", {}).items()]
            + [f"ordered rays {k} {v['ms']} ms, a call {v['call_ms']:.4f} "
               f"(unsorted {v['unsorted_call_ms']:.4f}, key and sort "
               f"{v['sort_keys_ms']:.4f})"
               for k, v in rec.get("ray_order", {}).items()]
            + [f"presorted rays {k} {v['ms']:.4f} ms"
               for k, v in rec.get("ray_presorted", {}).items()]
            + [f"hierarchy {k} {v['ms']:.4f} ms"
               for k, v in {**rec.get("hierarchy", {}),
                            **rec.get("hierarchy_sweep", {})}.items()]))
    print(f"all bitwise: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
