#!/usr/bin/env python3
"""Time variants of the ``trilinear_roots`` CUDA kernel on one card.

    python3 scripts/trilinear_roots_variants.py [--variants kernel,serial]

Each variant is built by ``ops/cuda_build``:

- ``kernel``: ``tropical_torch/csrc/trilinear_roots.cu`` as committed;
- ``lanes1``, ``lanes2``, ``lanes4``, ``lanes8``: the same source with
  ``-DTRILINEAR_ROOTS_LANES=k``, k threads a row;
- ``serial``: ``scripts/trilinear_roots_serial.cu``, the kernel's first
  design (one thread a row, the scan from the last cell down with each
  derivative bracket probed where it is met, an early stop).

Inputs: every root solve of the curved sphere-medium extraction (the
checkpoint of ``-m medium -d sphere -s 1``, extracted with ``force=False``
on the card), and the 100,000 seeded rows of ``chip_smoke.py``.  For each
variant it prints whether it returns the plain version's bits on every
input, its registers, and its device time (``graph_ms``: 100 calls in one
CUDA graph) on the largest curved input, on the seeded rows, and on the
largest curved input laid out so that each warp holds copies of one row
(``uniform_ms``, the mean over every choice of that row within the warp's
own rows).  ``ms - uniform_ms`` is what the lanes of a warp going
different ways cost.

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

from tropical_torch.core import trilinear as tl  # noqa: E402
from tropical_torch.ops import cuda_build  # noqa: E402

SERIAL = str(ROOT / "scripts" / "trilinear_roots_serial.cu")
VARIANTS = {"kernel": ("trilinear_roots", ()), "serial": (SERIAL, ())}
VARIANTS.update({f"lanes{k}": ("trilinear_roots",
                               (f"TRILINEAR_ROOTS_LANES={k}",))
                 for k in (1, 2, 4, 8)})


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


def curved_inputs():
    """Every (p, q) the curved sphere-medium extraction gives the solve."""
    from tropical_torch.stanford import train
    from tropical_torch.stanford.model import net_for_size
    from tropical_torch.utils import checkpoint as ckpt

    net = net_for_size("medium", "sphere", 1, device="cuda")
    ckpt.load_into(net, ckpt.find_checkpoint(
        train.model_path_for("sphere", "medium", 1)))
    kept = []
    solve = tl.intersection_of_two_planes

    def keep(p, q):
        kept.append((p.clone(), q.clone()))
        return solve(p, q)

    tl.intersection_of_two_planes = keep
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            train.extract_mesh(net, force=False)
    finally:
        tl.intersection_of_two_planes = solve
    return kept


def build(names):
    targets = {name: VARIANTS[name] for name in names}
    logs = cuda_build.build(targets.values())
    libs, regs = {}, {}
    for name, target in targets.items():
        log = logs[cuda_build.label(target)]
        if any(int(v) for v in re.findall(r"(\d+) bytes spill", log)):
            raise SystemExit(f"{name}: register spills\n{log}")
        libs[name] = cuda_build.load(target)
        regs[name] = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    return libs, regs


def bitwise(lib, p, q) -> bool:
    out = tl.run_kernel(lib, p, q)
    torch.cuda.synchronize()
    return torch.equal(out.view(torch.int32),
                       tl.intersection_of_two_planes_plain(p, q)
                       .view(torch.int32))


def uniform_ms(lib, p, q) -> float:
    """Mean device time over the layouts in which every row of a warp is a
    copy of one of that warp's own rows."""
    _, lanes = tl._launcher(lib)
    per_warp = 32 // lanes
    n = p.shape[0]
    base = torch.arange(n, device=p.device) // per_warp * per_warp
    times = []
    for k in range(per_warp):
        idx = (base + k).clamp(max=n - 1)
        pu, qu = p[idx].contiguous(), q[idx].contiguous()
        times.append(graph_ms(lambda: tl.run_kernel(lib, pu, qu)))
    return float(np.mean(times))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variants", default=",".join(VARIANTS),
                        help="comma-separated names (default: all)")
    args = parser.parse_args()
    names = args.variants.split(",")
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("trilinear_roots_variants: CUDA is not available",
              file=sys.stderr)
        return 1
    os.chdir(ROOT)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs, regs = build(names)
    curved = curved_inputs()
    rows = [p.shape[0] for p, _ in curved]
    print(f"curved inputs: {len(curved)} solves, rows {rows}")
    largest = max(curved, key=lambda pq: pq[0].shape[0])
    rng = np.random.default_rng(7)
    seeded = tuple(torch.from_numpy(rng.normal(size=(100_000, 8))
                                    .astype(np.float32)).cuda()
                   for _ in range(2))
    results = []
    for name in names:
        lib = libs[name]
        exact = all(bitwise(lib, p, q) for p, q in curved + [seeded])
        ms = graph_ms(lambda: tl.run_kernel(lib, *largest))
        seeded_ms = graph_ms(lambda: tl.run_kernel(lib, *seeded))
        uni = uniform_ms(lib, *largest)
        results.append({"variant": name, "bitwise": exact,
                        "registers": regs[name], "rows": largest[0].shape[0],
                        "ms": ms, "uniform_ms": uni,
                        "seeded_rows": seeded[0].shape[0],
                        "seeded_ms": seeded_ms})
        print(f"{name:8s} bitwise {exact!s:5s} B={largest[0].shape[0]}: "
              f"{ms:.5f} ms, uniform warps {uni:.5f} ms; B=100000: "
              f"{seeded_ms:.5f} ms; registers {regs[name]}", flush=True)
    print(json.dumps({"curved_rows": rows, "variants": results}))
    return 0 if all(r["bitwise"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
