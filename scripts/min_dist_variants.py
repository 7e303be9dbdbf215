#!/usr/bin/env python3
"""Time variants of the ``min_dist`` CUDA kernel on one card.

    python3 scripts/min_dist_variants.py [--n 100000] [--m 100000]

Each variant is ``tropical_torch/csrc/min_dist.cu`` with one design step
taken out or one constant changed, written to
``tropical_torch/_build/variants/`` and built by ``ops/cuda_build``.  On random sphere samples (the
chamfer stage's inputs, radius 0.6) it prints each variant's time (CUDA
events, mean of 20 searches), whether it still returns the plain version's
(d2, idx) bit for bit, and the share of warp and row groups that took the
exact path (from a second build with ``-DMIN_DIST_COUNT_EXACT``):

- ``kernel``: the kernel as committed;
- ``no_warm``: every row's threshold starts at inf;
- ``no_sort``: rows in input order (the y points are still sorted, for the
  warm start);
- ``no_sort_no_warm``: both;
- ``fast_only``: the exact path only in a split's first panel, so the time
  is the fast path's (results are not exact);
- ``rows8``, ``group8``, ``rows8_group8``: other register tilings.

A measurement tool: the port never loads these builds.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tropical_torch.ops import chamfer as ch  # noqa: E402
from tropical_torch.ops import cuda_build  # noqa: E402

OUT_DIR = cuda_build.BUILD_DIR / "variants"

NO_WARM = [("const int last = min(ends[kCells + c], first + kWarm);",
            "const int last = first;")]
NO_SORT = [("    order[atomicAdd(offsets + cells[i], 1)] = i;",
            "    order[i] = i;")]
FAST_ONLY = [
    ("      if (hit) {",
     "      skipped += hit && p > 0;\n      if (hit && p == 0) {"),
    ("  for (int p = 0; p < n_panels; ++p) {",
     "  int skipped = 0;\n  for (int p = 0; p < n_panels; ++p) {"),
    ("#pragma unroll\n  for (int r = 0; r < kRows; ++r) {\n"
     "    const long long i = row0 + r * kThreads;\n    if (i < n && best[r]",
     "  if (skipped == -1) keys[0] = 0;  // keeps the fast path live\n"
     "#pragma unroll\n  for (int r = 0; r < kRows; ++r) {\n"
     "    const long long i = row0 + r * kThreads;\n    if (i < n && best[r]"),
]
ROWS8 = [("constexpr int kRows = 4;", "constexpr int kRows = 8;")]
GROUP8 = [("constexpr int kGroup = 16;", "constexpr int kGroup = 8;")]
COUNT = ("MIN_DIST_COUNT_EXACT",)

VARIANTS = {"kernel": [], "no_warm": NO_WARM, "no_sort": NO_SORT,
            "no_sort_no_warm": NO_SORT + NO_WARM, "fast_only": FAST_ONLY,
            "rows8": ROWS8, "group8": GROUP8, "rows8_group8": ROWS8 + GROUP8}


def write_source(name, subs):
    src = (cuda_build.CSRC_DIR / "min_dist.cu").read_text()
    for old, new in subs:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: the kernel no longer has {old!r}")
        src = src.replace(old, new)
    path = OUT_DIR / f"{name}.cu"
    path.write_text(src)
    return str(path)


def build_all():
    """Every variant and its counting build, by the package's own build
    (one nvcc each, all at once)."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    targets = {}
    for name, subs in VARIANTS.items():
        src = write_source(name, subs)
        targets[name] = (src, ())
        targets[name + "_count"] = (src, COUNT)
    logs = cuda_build.build(targets.values())
    libs, regs = {}, {}
    for name, target in targets.items():
        log = logs[cuda_build.label(target)]
        if any(int(v) for v in re.findall(r"(\d+) bytes spill", log)):
            raise SystemExit(f"{name}: register spills\n{log}")
        libs[name] = cuda_build.load(target)
        # the scan kernel is the one with the shared panels
        regs[name] = [int(r) for r, _ in re.findall(
            r"Used (\d+) registers, used 1 barriers, (\d{5}) bytes smem", log)]
    return libs, regs


def cuda_ms(fn, iters=20):
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


def exact_share(lib, x, y):
    counts = (ctypes.c_ulonglong * 4)()
    read = lib.min_dist_exact_counts
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    if read(counts) != 0:
        raise SystemExit("exact counters: CUDA error")
    ch.run_kernel(lib, x, y)
    torch.cuda.synchronize()
    if read(counts) != 0:
        raise SystemExit("exact counters: CUDA error")
    warp_groups, warp_exact, row_groups, row_walks = counts
    return warp_exact / warp_groups, row_walks / row_groups


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--n", type=int, default=100_000)
    parser.add_argument("--m", type=int, default=100_000)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("min_dist_variants: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs, regs = build_all()
    rng = np.random.default_rng(0)

    def sphere(k):
        p = rng.normal(size=(k, 3))
        p = 0.6 * p / np.linalg.norm(p, axis=1, keepdims=True)
        return torch.from_numpy(p.astype(np.float32)).cuda()

    x, y = sphere(args.n), sphere(args.m)
    want = ch.min_dist_plain(x, y)
    rows = []
    for name in VARIANTS:
        lib = libs[name]
        d2, idx = ch.run_kernel(lib, x, y)
        torch.cuda.synchronize()
        exact = bool(torch.equal(d2, want[0]) and torch.equal(idx, want[1]))
        ms = cuda_ms(lambda: ch.run_kernel(lib, x, y))
        warp, row = exact_share(libs[name + "_count"], x, y)
        rows.append({"variant": name, "ms": ms, "bitwise": exact,
                     "warp_share": warp, "row_share": row,
                     "scan_registers": regs[name]})
        print(f"{name:16s} {ms:7.3f} ms  bitwise {exact!s:5s}  exact path: "
              f"warp groups {warp:.4f}, row groups {row:.6f}, scan registers "
              f"{regs[name]}", flush=True)
    print(json.dumps({"n": args.n, "m": args.m, "variants": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
