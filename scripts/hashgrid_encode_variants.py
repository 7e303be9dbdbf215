#!/usr/bin/env python3
"""Time variants of the hash-grid encode's backward kernels on one card.

    python3 scripts/hashgrid_encode_variants.py [--variants kernel,lanes1]

Each variant is ``tropical_torch/csrc/hashgrid_encode.cu`` built by
``ops/cuda_build`` with one step of the backwards' design taken out:

- ``kernel``: as committed (a lane per corner, the coarse levels' table
  gradient summed in shared memory, float2 atomics);
- ``lanes1``: ``-DHASHGRID_ENCODE_CORNER_LANES=1``, one thread a (point,
  level) that takes its 8 corners in turn (the first design's mapping);
- ``no_private``: ``-DHASHGRID_ENCODE_NO_PRIVATE``, every table-gradient row
  to device-memory atomics;
- ``scalar_atomics``: ``-DHASHGRID_ENCODE_SCALAR_ATOMICS``, two scalar
  atomicAdds where the kernel makes one float2 atomicAdd.

On sphere-small's grid (seeded points over the unit cube and its margin, a
quarter on grid planes, as ``chip_smoke.py`` draws them) at B = 1,000 (a
training batch), 10,171 (the flat run's normals) and 278,528 (its largest
forward) it checks that each variant's dx, d_dfeat and dx2 are the plain
versions' bits and its table gradients within 4 2^-24 sqrt(B) of the plain
version's largest row, and prints its registers and the device time of
both backwards (``graph_ms``: 100 calls in one CUDA graph).

A measurement tool: the port never loads these builds.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tropical_torch.core import hashgrid as hg  # noqa: E402
from tropical_torch.ops import cuda_build  # noqa: E402

VARIANTS = {"kernel": ("hashgrid_encode", ()),
            "lanes1": ("hashgrid_encode", ("HASHGRID_ENCODE_CORNER_LANES=1",)),
            "no_private": ("hashgrid_encode", ("HASHGRID_ENCODE_NO_PRIVATE",)),
            "scalar_atomics": ("hashgrid_encode",
                               ("HASHGRID_ENCODE_SCALAR_ATOMICS",))}
SIZES = (1000, 10171, 278528)


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


def inputs(spec, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    x[: n // 4] = np.round(x[: n // 4] * 4) / 4
    table = (0.1 * rng.normal(size=(spec.n_entries, 2))).astype(np.float32)
    dfeat = rng.normal(size=(n, spec.levels * 2)).astype(np.float32)
    ddx = rng.normal(size=(n, 3)).astype(np.float32)
    return tuple(torch.from_numpy(a).cuda() for a in (table, x, dfeat, ddx))


def build(names):
    targets = {name: VARIANTS[name] for name in names}
    logs = cuda_build.build(targets.values())
    libs, regs = {}, {}
    for name, target in targets.items():
        log = logs[cuda_build.label(target)]
        libs[name] = cuda_build.load(target)
        # per kernel: registers and bytes spilled (stores)
        regs[name] = {"registers": [int(r) for r in re.findall(
                          r"Used (\d+) registers", log)],
                      "spill_bytes": [int(v) for v in re.findall(
                          r"(\d+) bytes spill stores", log)]}
    return libs, regs


def held(lib, spec, table, x, dfeat, ddx) -> dict:
    """Bitwise (dx, d_dfeat, dx2) and the scatters' spread in 2^-24 sqrt(B)
    of the plain version's largest row."""
    dx, dt = hg.hashgrid_encode_bwd(spec, table, x, dfeat, lib=lib)
    dd, dt2, dx2 = hg.hashgrid_encode_bwd_bwd(spec, table, x, dfeat, ddx,
                                              lib=lib)
    torch.cuda.synchronize()
    pdx, pdt = hg.encode_backward_plain(spec, table, x, dfeat)
    pdd, pdt2, pdx2 = hg.encode_double_backward_plain(spec, table, x, dfeat,
                                                      ddx)
    bitwise = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                  for a, b in ((dx, pdx), (dd, pdd), (dx2, pdx2)))
    unit = 2.0 ** -24 * math.sqrt(x.shape[0])
    spread = max(float((a - b).abs().max()) / float(b.abs().max())
                 for a, b in ((dt, pdt), (dt2, pdt2))) / unit
    return {"bitwise": bitwise, "scatter_units": spread,
            "held": bitwise and spread <= 4.0}


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
        print("hashgrid_encode_variants: CUDA is not available",
              file=sys.stderr)
        return 1
    os.chdir(ROOT)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    from tropical_torch.stanford.model import net_for_size

    spec = net_for_size("small", device="cpu").spec.grid
    libs, regs = build(names)
    data = {n: inputs(spec, n, seed=3) for n in SIZES}
    results = []
    for name in names:
        lib = libs[name]
        row = {"variant": name, "registers": regs[name]}
        for n, (table, x, dfeat, ddx) in data.items():
            check = held(lib, spec, table, x, dfeat, ddx)
            bwd = graph_ms(lambda: hg.hashgrid_encode_bwd(
                spec, table, x, dfeat, lib=lib))
            bwd_bwd = graph_ms(lambda: hg.hashgrid_encode_bwd_bwd(
                spec, table, x, dfeat, ddx, lib=lib))
            row[str(n)] = {**check, "bwd_ms": bwd, "bwd_bwd_ms": bwd_bwd}
            print(f"{name:15s} B={n:6d}: bwd {bwd:.5f} ms, bwd_bwd "
                  f"{bwd_bwd:.5f} ms; bitwise {check['bitwise']}, scatters "
                  f"{check['scatter_units']:.3f} of 2^-24 sqrt(B); registers "
                  f"{regs[name]}", flush=True)
        results.append(row)
    print(json.dumps({"private_rows": hg.private_rows(spec),
                      "variants": results}))
    return 0 if all(r[str(n)]["held"] for r in results for n in SIZES) else 1


if __name__ == "__main__":
    sys.exit(main())
