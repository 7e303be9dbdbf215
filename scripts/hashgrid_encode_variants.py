#!/usr/bin/env python3
"""Time variants of the hash-grid encode kernels on one card.

    python3 scripts/hashgrid_encode_variants.py [--forward kernel,lanes1]
        [--backward kernel,lanes1]

Each variant is ``tropical_torch/csrc/hashgrid_encode.cu`` built by
``ops/cuda_build`` with one step of a kernel's design taken out.

The forward's (``--forward``):

- ``kernel``: as committed (lanes a (point, level) chosen from B, one
  remainder a (point, level), 32-bit where the base fits, level rows in the
  kernel's parameters);
- ``lanes1``, ``lanes2``, ``lanes4``, ``lanes8``:
  ``-DHASHGRID_ENCODE_FWD_LANES=K``, K lanes a (point, level) whatever B
  (``lanes1`` is the earlier design's one thread a (point, level));
- ``eight_remainders``: ``-DHASHGRID_ENCODE_FWD_EIGHT_REMAINDERS``, a
  64-bit remainder a corner;
- ``wide_remainder``: ``-DHASHGRID_ENCODE_FWD_WIDE``, the one remainder
  always in 64 bits;
- ``device_rows``: ``-DHASHGRID_ENCODE_FWD_DEVICE_ROWS``, each thread loads
  its level's row from device memory first;
- ``earlier``: all three at once (one thread a (point, level), eight
  64-bit remainders, rows from device memory): the earlier design.

The backwards' (``--backward``):

- ``kernel``: as committed (a lane per corner, the coarse levels' table
  gradient summed in shared memory, float2 atomics);
- ``lanes1``: ``-DHASHGRID_ENCODE_CORNER_LANES=1``, one thread a (point,
  level) that takes its 8 corners in turn;
- ``no_private``: ``-DHASHGRID_ENCODE_NO_PRIVATE``, every table-gradient row
  to device-memory atomics;
- ``scalar_atomics``: ``-DHASHGRID_ENCODE_SCALAR_ATOMICS``, two scalar
  atomicAdds where the kernel makes one float2 atomicAdd.

On sphere-small's grid (seeded points over the unit cube and its margin, a
quarter on grid planes, as ``chip_smoke.py`` draws them) at B = 1,000 (a
training batch), 10,171 (the flat run's normals) and 278,528 (its largest
forward), and for the forward also on the points of that forward, a slab of
the marching-cubes grid at 128 (``slab``), it checks that each variant's
features (forward) or dx, d_dfeat and dx2 (backwards) are the plain
versions' bits and the table gradients within 4 2^-24 sqrt(B) of the plain
version's largest row, and prints the device time (``graph_ms``: 100 calls
in one CUDA graph), each kernel's registers (``-Xptxas -v``) and the
forward kernels' SASS instruction counts (``cuobjdump -sass``).  Then the
host cost of one forward wrapper call at B = 10,171, split into its parts.

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
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tropical_torch.core import hashgrid as hg  # noqa: E402
from tropical_torch.ops import cuda_build, launches  # noqa: E402

SOURCE = "hashgrid_encode"
FORWARD = {"kernel": (),
           "lanes1": ("HASHGRID_ENCODE_FWD_LANES=1",),
           "lanes2": ("HASHGRID_ENCODE_FWD_LANES=2",),
           "lanes4": ("HASHGRID_ENCODE_FWD_LANES=4",),
           "lanes8": ("HASHGRID_ENCODE_FWD_LANES=8",),
           "eight_remainders": ("HASHGRID_ENCODE_FWD_EIGHT_REMAINDERS",),
           "wide_remainder": ("HASHGRID_ENCODE_FWD_WIDE",),
           "device_rows": ("HASHGRID_ENCODE_FWD_DEVICE_ROWS",),
           "earlier": ("HASHGRID_ENCODE_FWD_LANES=1",
                       "HASHGRID_ENCODE_FWD_EIGHT_REMAINDERS",
                       "HASHGRID_ENCODE_FWD_DEVICE_ROWS")}
BACKWARD = {"kernel": (),
            "lanes1": ("HASHGRID_ENCODE_CORNER_LANES=1",),
            "no_private": ("HASHGRID_ENCODE_NO_PRIVATE",),
            "scalar_atomics": ("HASHGRID_ENCODE_SCALAR_ATOMICS",)}
# a training batch, the flat run's normals, its largest forward
SIZES = (1000, 10171, 278528)
# the forward also at two sizes past its switch from 4 lanes a (point,
# level) to 1 (at about B = 10,500 on an H100), where 2 lanes might pay
FORWARD_SIZES = (1000, 10171, 20000, 50000, 278528)
# the flat run's largest forward: the marching-cubes slab at 128 (17 x-planes)
# that starts at this x index, through the middle of the sphere
SLAB_RES, SLAB_X0 = 128, 48


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


def slab_x(net_spec):
    """The flat run's largest forward: the points of one marching-cubes slab
    at 128 as its SDF sweep takes them, in the unit cube."""
    from tropical_torch.core.net import preprocess
    from tropical_torch.stanford.train import CANVAS_SIZE
    from tropical_torch.utils import marching_cubes as mc

    s = mc.grid_axis(SLAB_RES, CANVAS_SIZE, torch.device("cuda"))
    pts = mc.grid_points(s, SLAB_X0 * SLAB_RES ** 2,
                         (mc.SLAB + 1) * SLAB_RES ** 2)
    return preprocess(net_spec, pts).contiguous()


def function_stats(log: str) -> dict:
    """Registers and spilled bytes of each kernel in a ``-Xptxas -v`` log,
    by short name (``fwd_kernel<1>``, ``bwd_kernel``, ...)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?(\S+?)'?\s*(?:for|$)", line)
        if m:
            name = short_name(m.group(1))
            out.setdefault(name, {})
        if name is None:
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out[name]["spill_bytes"] = int(m.group(1))
    return out


def short_name(mangled: str) -> str:
    m = re.search(r"(fwd_kernel|bwd_bwd_kernel|bwd_kernel)(?:ILi(\d+)E)?",
                  mangled)
    if not m:
        return mangled
    return m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")


def sass_counts(so: Path) -> dict:
    """SASS instructions of each forward kernel in a built library, and
    how many of them are calls (of the 64-bit remainder routine)."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME, "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = short_name(m.group(1))
            counts[name] = {"instructions": 0, "calls": 0}
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[name]["instructions"] += 1
            counts[name]["calls"] += " CALL" in line
    return {k: v for k, v in counts.items() if k.startswith("fwd_kernel")}


def build(variants):
    targets = {name: (SOURCE, defines) for name, defines in variants.items()}
    logs = cuda_build.build(set(targets.values()))
    libs, stats = {}, {}
    for name, target in targets.items():
        libs[name] = cuda_build.load(target)
        stats[name] = {"kernels": function_stats(logs[cuda_build.label(target)]),
                       "sass": sass_counts(cuda_build.library_path(target))}
    return libs, stats


def forward_held(lib, spec, table, x) -> bool:
    feat = hg.hashgrid_encode_fwd(spec, table, x, lib=lib)
    torch.cuda.synchronize()
    want = hg.encode_plain(spec, table, x)
    return torch.equal(feat.view(torch.int32), want.view(torch.int32))


def backward_held(lib, spec, table, x, dfeat, ddx) -> dict:
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


def host_us(fn, reps: int = 400, rounds: int = 5) -> float:
    """Host microseconds per call of ``fn``: the least over ``rounds`` of
    ``reps`` calls (a sync between rounds keeps the launch queue short)."""
    best = math.inf
    for _ in range(rounds):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, (time.perf_counter() - t) / reps)
    torch.cuda.synchronize()
    return best * 1e6


def wrapper_split(spec, table, x) -> dict:
    """Host microseconds of one forward wrapper call and of its parts."""
    n = x.shape[0]
    run = hg._launcher(spec, x.get_device(), None)
    feat = hg.hashgrid_encode_fwd(spec, table, x)
    ptrs = (x.data_ptr(), table.data_ptr(), n, feat.data_ptr())
    index = x.get_device()
    parts = {
        "call": lambda: hg.hashgrid_encode_fwd(spec, table, x),
        "check_inputs": lambda: hg._check_inputs(spec, table, x),
        "new_empty": lambda: x.new_empty((n, spec.levels * 2)),
        "torch_empty": lambda: torch.empty((n, spec.levels * 2),
                                           device=x.device),
        "launcher_lookup": lambda: hg._launcher(spec, index, None),
        "launch_and_count": lambda: run(run.fwd, "hashgrid_encode_fwd", n,
                                        *ptrs),
        "stream_query": lambda: torch._C._cuda_getCurrentRawStream(index),
        "ctypes_launch": lambda: run.fwd(
            run.ref, *ptrs, torch._C._cuda_getCurrentRawStream(index)),
        "count": lambda: launches.record("hashgrid_encode_fwd",
                                         (n, spec.levels)),
        "data_ptrs": lambda: (x.data_ptr(), table.data_ptr(),
                              feat.data_ptr()),
    }
    return {k: host_us(fn) for k, fn in parts.items()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--forward", default=",".join(FORWARD),
                        help="comma-separated forward variants ('' for none)")
    parser.add_argument("--backward", default=",".join(BACKWARD),
                        help="comma-separated backward variants ('' for "
                        "none)")
    args = parser.parse_args()
    fwd_names = [v for v in args.forward.split(",") if v]
    bwd_names = [v for v in args.backward.split(",") if v]
    unknown = (set(fwd_names) - set(FORWARD)) | (set(bwd_names) - set(BACKWARD))
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

    net_spec = net_for_size("small", device="cpu").spec
    spec = net_spec.grid
    variants = {**{f"fwd:{k}": FORWARD[k] for k in fwd_names},
                **{f"bwd:{k}": BACKWARD[k] for k in bwd_names}}
    libs, stats = build(variants)
    data = {str(n): inputs(spec, n, seed=3)
            for n in sorted(set(SIZES + FORWARD_SIZES))}
    table = data[str(SIZES[-1])][0]
    data["slab"] = (table, slab_x(net_spec))
    results, held = [], True
    for key in variants:
        kind, name = key.split(":")
        lib = libs[key]
        row = {"variant": key, **stats[key]}
        print(f"{key}: {json.dumps(stats[key])}", flush=True)
        for label, (table, x, *grads) in data.items():
            if kind == "fwd":
                ok = forward_held(lib, spec, table, x)
                ms = graph_ms(lambda: hg.hashgrid_encode_fwd(spec, table, x,
                                                             lib=lib))
                lanes = hg._launcher(spec, x.get_device(), lib).lanes(
                    x.shape[0])
                row[label] = {"bitwise": ok, "fwd_ms": ms, "lanes": lanes}
                print(f"{key:22s} {label:>7s}: fwd {ms:.5f} ms at {lanes} "
                      f"lanes; bitwise {ok}", flush=True)
            elif grads and int(label) in SIZES:
                check = backward_held(lib, spec, table, x, *grads)
                ok = check["held"]
                bwd = graph_ms(lambda: hg.hashgrid_encode_bwd(
                    spec, table, x, grads[0], lib=lib))
                bwd_bwd = graph_ms(lambda: hg.hashgrid_encode_bwd_bwd(
                    spec, table, x, *grads, lib=lib))
                row[label] = {**check, "bwd_ms": bwd, "bwd_bwd_ms": bwd_bwd}
                print(f"{key:22s} {label:>7s}: bwd {bwd:.5f} ms, bwd_bwd "
                      f"{bwd_bwd:.5f} ms; bitwise {check['bitwise']}, "
                      f"scatters {check['scatter_units']:.3f} of 2^-24 "
                      "sqrt(B)", flush=True)
            else:
                continue
            held = held and ok
        results.append(row)
    split = wrapper_split(spec, *data["10171"][:2])
    print(f"forward wrapper at B = 10171, host us: {json.dumps(split)}")
    print(json.dumps({"private_rows": hg.private_rows(spec),
                      "wrapper_us": split, "variants": results}))
    return 0 if held else 1


if __name__ == "__main__":
    sys.exit(main())
