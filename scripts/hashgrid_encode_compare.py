#!/usr/bin/env python3
"""Time the hash-grid encode forward of two checkouts on one card, in turns.

    python3 scripts/hashgrid_encode_compare.py OLD NEW NEW OLD

Each argument is the root of a checkout of this repository (for example
the parent commit unpacked by ``git archive`` into a directory that
``.gitignore`` lists, and ``.``); each is run in a process of its own, in
the order given, so that two versions are compared inside one call on one
card.  For each it prints one JSON line: the forward's device time
(``graph_ms``: 100 calls in one CUDA graph) on sphere-small's grid at
B = 1,000, 10,171 and 278,528 seeded points (as
``scripts/hashgrid_encode_variants.py`` draws them) and on the flat run's
largest forward, a marching-cubes slab at 128; and the host time of one
wrapper call at B = 10,171 (the least of 5 rounds of 400 calls by
``time.perf_counter``, and CUDA events over 50 calls).

A measurement tool: it uses only ``hashgrid_encode_fwd`` and
``net_for_size``, which every checkout since the encode kernels has.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

SIZES = (1000, 10171, 278528)
# the slab at 128 that starts at this x index (17 x-planes, z fastest), over
# the CLI's canvas [-1.2, 1.2]^3
SLAB_RES, SLAB_X0, SLAB_PLANES, CANVAS = 128, 48, 17, 1.2


def measure(root: str) -> dict:
    sys.path.insert(0, str(Path(root).resolve()))
    import numpy as np
    import torch
    from tropical_torch.core import hashgrid as hg
    from tropical_torch.stanford.model import net_for_size

    def cuda_ms(fn, iters):
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

    def graph_ms(fn, reps=100):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        return cuda_ms(graph.replay, 10) / reps

    net = net_for_size("small", device="cpu")
    spec = net.spec.grid
    rng = np.random.default_rng(3)
    table = torch.from_numpy((0.1 * rng.normal(size=(spec.n_entries, 2)))
                             .astype(np.float32)).cuda()
    points = {}
    for n in SIZES:
        x = rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
        x[: n // 4] = np.round(x[: n // 4] * 4) / 4
        points[str(n)] = torch.from_numpy(x).cuda()
    # the slab as utils/marching_cubes builds it, then into the unit cube
    s = torch.from_numpy(np.linspace(-CANVAS, CANVAS, SLAB_RES,
                                     dtype=np.float32)).cuda()
    idx = (SLAB_X0 * SLAB_RES ** 2
           + torch.arange(SLAB_PLANES * SLAB_RES ** 2, device="cuda"))
    pts = torch.stack([s[idx // SLAB_RES ** 2], s[(idx // SLAB_RES) % SLAB_RES],
                       s[idx % SLAB_RES]], -1)
    points["slab"] = net.preprocess(pts).contiguous()
    out = {"root": root, "fwd_ms": {}}
    for label, x in points.items():
        feat = hg.hashgrid_encode_fwd(spec, table, x)
        torch.cuda.synchronize()
        if not torch.equal(feat.view(torch.int32),
                           hg.encode_plain(spec, table, x).view(torch.int32)):
            raise SystemExit(f"{root}: the forward differs from its plain "
                             f"version at {label}")
        out["fwd_ms"][label] = graph_ms(
            lambda x=x: hg.hashgrid_encode_fwd(spec, table, x))
    x = points["10171"]

    def call():
        return hg.hashgrid_encode_fwd(spec, table, x)

    for _ in range(20):
        call()
    best = math.inf
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(400):
            call()
        best = min(best, (time.perf_counter() - t) / 400)
    out["call_host_us"] = best * 1e6
    out["call_events_us"] = cuda_ms(call, 50) * 1e3
    return out


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    rc = 0
    for root in sys.argv[1:]:
        rc |= subprocess.run([sys.executable, __file__, "--one", root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
