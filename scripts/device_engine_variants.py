#!/usr/bin/env python3
"""Time variants of the device engine's K2, K3, K4 and K5 kernels on one card.

    python3 scripts/device_engine_variants.py [--variants design,first,...]
        [--parts k2,k3,k4,k5] [--sizes small,large] [--json PATH]

Each variant is ``tropical_torch/csrc/device_engine.cu`` (K3-K5) or
``csrc/lattice_encode.cu`` (K2) built by ``ops/cuda_build`` with other
``-D`` macros:

- ``design``: as committed (K5: the column table of (start, end) pairs
  scattered at the runs' ends, the rows gathered into sorted order, a
  block of 32 candidates with a warp a neighbour column and a lane a
  candidate: the column's table entry, two searches for the z window's
  ends in lockstep, then the window's rows a row a round; the fill pass
  skipping a column that found nothing; ``compact_rows`` a word a thread
  for the outputs' pool (33 words a row), a row a thread otherwise; K2:
  one launch for every level, a thread a point, its rows staged in shared
  memory and copied out a float4 a thread; K3: two pools, a warp a line
  by doubling runs, a point's canonical words (9 bytes) and the third
  axis's max from its block's rows and values staged in shared memory,
  the edges and used points as bit masks by ballot with block counts, one
  block's scan of the counts, the compaction ranking by popcounts; K4: two
  launches a busy insertion, the split edges ranked and lerped in one pass
  by ballots and a decoupled look-back, then the override and the append
  from rows staged in shared memory, the override applied by the last
  block where any row violates it);
- ``first``: the first designs (``cuda_build.DEVICE_ENGINE_FIRST``,
  ``-DCONNECT_SEARCHES``: no table, a lower and an upper bound over the
  whole sorted key array for each of the 9 columns, rows through the
  permutation, ``-DCOMPACT_ROW_THREAD``: a thread a row, and
  ``-DSKELETON_CUMSUM``: K3 a thread a value, row or edge with int32
  flags and two torch.cumsum calls, and ``-DSPLIT_FOUR_PASS``: K4's
  split_mark, a torch.cumsum, split_lerp, split_override and
  split_append, a thread an item;
  ``cuda_build.LATTICE_FIRST``, ``-DLATTICE_LEVEL_LAUNCH``: a launch a
  level, 8 bytes a thread at the row's stride);
- ``row_thread``: ``-DCOMPACT_ROW_THREAD`` alone, ``compact_rows`` a
  thread a row at every width (the pair scan as designed).

The ablations this script once also timed (a window's rows read k a round,
column windows shared across a warp by shuffles, the block's rows staged
in shared memory, the fill pass over every column, 4 words a thread in the
compaction, K2's rows stored straight to device memory; K3's earlier
iterations: the pool's window read from a tile a value at a time, its
groups of lines pipelined in a block, a third pool launch, 16-byte
canonical words, the scan a tile of 1,024 or a chunk a thread, the
compaction a warp a row, a thread a point, or its rows copied coalesced
through shared memory; K4's two launches with the override applied by a
last block, selection tiles of 256 or 1,024 edges, an acq_rel fetch_add
for a fence and an atomicAdd) measured no better than the design and were
deleted; PERF.md keeps their readings.

Inputs: the committed sphere-small and sphere-large checkpoints.  K3:
each variant's whole skeleton, dist and sign, bitwise the plain versions,
the launches of its dist skeleton, and that skeleton's stage calls,
recorded from the variant's own run and replayed as recorded
(``chip_smoke.k3_stage_times``).  K4: the stage calls of the busiest hidden
insertion and the final one, recorded from the variant's own run, each
bitwise the plain version (also with the override planted) and replayed
as recorded (``chip_smoke.k4_stage_times``), by stage and plane, with the
variant's launches on the run and the bound (``chip_smoke.k4_bytes``).  K5's
calls (``connect_table``, ``connect_count``, ``connect_fill``,
``compact_rows``) are recorded from a run of the engine at the busiest
hidden insertion and the final one (``chip_smoke.StageLog``); K2 runs at
the M^3 skeleton lattice with its derivatives.  For each variant it prints
whether every call returns the plain version's bits, each kernel's
registers and shared memory (``-Xptxas -v``) and the device times
(``graph_ms``: the calls in one CUDA graph), summed by stage and plane;
``compact_rows`` also beside ``index_select`` on the same rows.
``--json`` writes the whole result to a file.

A measurement tool: the port never loads these builds.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from tropical_torch.core import hashgrid as thg  # noqa: E402
from tropical_torch.extract import device as dv  # noqa: E402
from tropical_torch.ops import cuda_build  # noqa: E402

ENGINE = {"design": (), "first": cuda_build.DEVICE_ENGINE_FIRST[1],
          "row_thread": ("COMPACT_ROW_THREAD",)}
LATTICE = {"design": (), "first": cuda_build.LATTICE_FIRST[1]}
STAGES = ("connect_table", "connect_count", "connect_fill", "compact_rows")
PARTS = ("k2", "k3", "k4", "k5")


def build(source, variants):
    """Each variant's library and, by kernel, its registers and shared
    bytes, from ptxas."""
    targets = {name: (source, macros) for name, macros in variants.items()}
    logs = cuda_build.build(targets.values())
    libs, usage = {}, {}
    for name, target in targets.items():
        libs[name] = cuda_build.load(target)
        usage[name] = {}
        kernel = None
        for line in logs[cuda_build.label(target)].splitlines():
            m = re.search(r"Compiling entry function '_Z\w*?N\d+_GLOBAL__N_"
                          r"\w*?(\d+)(\w+?_kernel)", line)
            if m:
                kernel = m.group(2)
            used = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?",
                             line)
            if kernel and used:
                usage[name][kernel] = {"registers": int(used.group(1)),
                                       "smem": int(used.group(2) or 0)}
    return libs, usage


def record(net):
    """K5's redesigned calls at the busiest hidden insertion and the final
    one: [(plane, name, args, kw)], and the planes."""
    eng = dv.Engine(net)
    sk = eng.skeleton("dist")
    eng.loop(*eng.pools(sk[0], sk[1], sk[5], sk[2:5]))
    hidden = [b for b in eng.stats.busy if b[0] < eng.n_hidden]
    planes = {eng.n_hidden, max(hidden, key=lambda b: b[1])[0]}
    with cs.StageLog() as log:
        class Logged(dv.Engine):
            def step(self, P, idx, *a, **k):
                log.on, log.plane = idx in planes, idx
                try:
                    return super().step(P, idx, *a, **k)
                finally:
                    log.on = False

        eng = Logged(net)
        sk = eng.skeleton("dist")
        eng.loop(*eng.pools(sk[0], sk[1], sk[5], sk[2:5]))
        calls = [(plane, name, args, kw) for name, args, kw, plane in
                 log.calls if name in STAGES]
        return calls, log.orig, sorted(planes)


def outputs(fn, args, kw, kern):
    a = cs.clones(args)
    return cs._outputs(fn(*a, **{**kw, "kern": kern}), a)


def time_engine(libs, calls, orig, reps):
    """{variant: {"bitwise", "ms": {stage@plane: ms}}}, and index_select's
    times of the compaction calls."""
    dev = torch.device("cuda", 0)
    kerns = {k: dv.Kernels(lib, dev) for k, lib in libs.items()}
    out = {k: {"bitwise": True, "ms": {}} for k in kerns}
    library = {}
    for plane, name, args, kw in calls:
        fn = orig[name]
        want = outputs(fn, args, kw, dv.PLAIN)
        key = f"{name}@{plane}"
        for variant, kern in kerns.items():
            if variant == "first" and name == "connect_table":
                out[variant]["ms"][key] = out[variant]["ms"].get(key, 0.0)
                continue
            got = outputs(fn, args, kw, kern)
            out[variant]["bitwise"] &= all(
                cs.bits_equal(x, y) for x, y in zip(got, want))
            fixed = cs.clones(args)
            out[variant]["ms"][key] = out[variant]["ms"].get(key, 0.0) + \
                cs.graph_ms(lambda: fn(*fixed, **{**kw, "kern": kern}),
                            reps=reps)
        if name == "compact_rows":
            src, cum = args[0], args[1]
            rows = torch.nonzero(torch.diff(cum, prepend=cum.new_zeros(1))
                                 > 0)[:, 0]
            library[key] = library.get(key, 0.0) + cs.graph_ms(
                lambda: src.index_select(0, rows), reps=reps)
    return out, library


def time_skeleton(libs, net, reps):
    """{variant: {"bitwise", "launches", "ms": {stage: ms}}} of K3."""
    dev = torch.device("cuda", 0)
    out = {}
    for variant, lib in libs.items():
        kern = dv.Kernels(lib, dev)
        same = True
        for mode in ("dist", "sign"):
            want = dv.Engine(net, kern=dv.PLAIN).skeleton(mode)
            got = dv.Engine(net, kern=kern).skeleton(mode)
            same &= len(got) == len(want) and all(
                cs.bits_equal(x, y) for x, y in zip(got, want))
        ms, count = cs.k3_stage_times(net, reps, kern, variant)
        out[variant] = {"bitwise": bool(same), "launches": count, "ms": ms}
    return out


def time_split(libs, net, reps):
    """{variant: {"ms", "bound_ms", "launches", "stages": {stage@plane:
    ms}}} of K4 at the busiest hidden insertion and the final one."""
    dev = torch.device("cuda", 0)
    eng = dv.Engine(net)
    sk = eng.skeleton("dist")
    eng.loop(*eng.pools(sk[0], sk[1], sk[5], sk[2:5]))
    hidden = [b for b in eng.stats.busy if b[0] < eng.n_hidden]
    planes = {eng.n_hidden, max(hidden, key=lambda b: b[1])[0]}
    out = {}
    for variant, lib in libs.items():
        r = cs.k4_stage_times(net, reps, dv.Kernels(lib, dev), planes,
                              variant)
        out[variant] = {"bitwise": True, "planes": sorted(planes),
                        **{k: r[k] for k in ("ms", "bound_ms", "launches",
                                             "stages")}}
    return out


def time_lattice(libs, net, reps):
    """{variant: {"bitwise", "ms"}} of K2 at the net's skeleton lattice."""
    spec = net.spec.grid
    xs = net.preprocess(net.marks * (net.spec.scale * 2) - net.spec.scale)
    n, LF = xs.shape[0] ** 3, spec.levels * 2
    tables = thg.lattice_tables(spec, net.enc.table.detach(), n)
    want = [thg.lattice_level_plain(spec, tables[l], l, xs, xs, xs, True)
            for l in range(spec.levels)]
    feat = torch.empty((n, LF), device="cuda")
    grad = torch.empty((3, n, LF), device="cuda")
    out = {}
    for variant, lib in libs.items():
        def run():
            thg.lattice_encode(spec, tables, xs, xs, xs, feat, grad, lib=lib)

        feat.fill_(float("nan"))
        grad.fill_(float("nan"))
        run()
        same = True
        for l, (f, g) in enumerate(want):
            cols = slice(2 * l, 2 * l + 2)
            same &= cs.bits_equal(feat[:, cols].contiguous(), f)
            same &= cs.bits_equal(grad[:, :, cols].contiguous(), g)
        out[variant] = {"bitwise": bool(same),
                        "ms": cs.graph_ms(run, reps=reps)}
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variants",
                        default=",".join(dict.fromkeys([*ENGINE, *LATTICE])),
                        help="comma-separated variants")
    parser.add_argument("--parts", default=",".join(PARTS),
                        help="comma-separated kernels: k2, k3, k4, k5")
    parser.add_argument("--sizes", default="small,large")
    parser.add_argument("--json", type=Path, default=None,
                        help="write the whole result here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("device_engine_variants: CUDA is not available",
              file=sys.stderr)
        return 1
    wanted = args.variants.split(",")
    parts = args.parts.split(",")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    engine_libs, engine_usage = build(
        "device_engine", {k: v for k, v in ENGINE.items() if k in wanted})
    lattice_libs, lattice_usage = build(
        "lattice_encode", {k: v for k, v in LATTICE.items()
                           if k in wanted and "k2" in parts})
    print(json.dumps({"registers": {"device_engine": engine_usage,
                                    "lattice_encode": lattice_usage}}))
    result = {"device": smi, "usage": {"device_engine": engine_usage,
                                       "lattice_encode": lattice_usage}}
    for size in args.sizes.split(","):
        reps = 50 if size == "small" else 10
        net = cs.sphere_net(size)
        res = result[size] = {}
        print(f"\n{size}:")
        if "k2" in parts:
            k2 = res["lattice_encode"] = time_lattice(lattice_libs, net, reps)
            for variant, r in k2.items():
                print(f"  K2 {variant}: {r['ms']:.4f} ms, bitwise "
                      f"{r['bitwise']}")
        if "k3" in parts:
            k3 = res["skeleton_mark"] = time_skeleton(engine_libs, net, reps)
            for variant, r in k3.items():
                total = sum(r["ms"].values())
                stages = ", ".join(f"{k} {v:.5f}" for k, v in r["ms"].items())
                print(f"  K3 {variant}: {total:.5f} ms ({stages}), "
                      f"{r['launches']} launches, bitwise {r['bitwise']}")
        if "k4" in parts:
            k4 = res["split_step"] = time_split(engine_libs, net, reps)
            for variant, r in k4.items():
                stages = ", ".join(f"{k} {v:.5f}" for k, v in
                                   r["stages"].items())
                print(f"  K4 {variant}: {r['ms']:.5f} ms ({stages}), "
                      f"{r['launches']} launches on the run, bound "
                      f"{r['bound_ms']:.5f} ms "
                      f"({r['bound_ms'] / r['ms']:.1%}), bitwise")
        if "k5" in parts:
            calls, orig, planes = record(net)
            k5, library = time_engine(engine_libs, calls, orig, reps)
            res.update(planes=planes, connect_step=k5, index_select=library)
            print(f"  K5 planes {planes}")
            for variant, r in k5.items():
                total = sum(r["ms"].values())
                stages = ", ".join(f"{k} {v:.5f}" for k, v in r["ms"].items())
                print(f"  K5 {variant}: {total:.5f} ms ({stages}), bitwise "
                      f"{r['bitwise']}")
            print(f"  index_select: {sum(library.values()):.5f} ms "
                  f"({', '.join(f'{k} {v:.5f}' for k, v in library.items())})")
        del net
        torch.cuda.empty_cache()
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    ok = all(r["bitwise"] for size in args.sizes.split(",")
             for part in ("lattice_encode", "skeleton_mark", "split_step",
                          "connect_step")
             for r in result[size].get(part, {}).values())
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
