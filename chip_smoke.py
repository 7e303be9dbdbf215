#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``tropical_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each fatal on failure:

1. device: the card's name and power limit;
2. build: every kernel of the main path from ``tropical_torch/csrc/`` (one
   ``nvcc`` per source, all started together), with the ``-Xptxas -v``
   register and shared-memory summary;
3. kernels vs plain: each kernel against its plain PyTorch version at the
   main path's shapes, then kernel, plain and library times (CUDA events);
4. main path: the CLI ``-e -m small -d sphere -s 1 --gt_res 128`` on
   ``cuda``, held to the golden funnel, the committed mesh and the kernel
   launch counts;
5. one JSON line of kernel records, the card's line, and the result line.

It exits non-zero without a result line when CUDA is unavailable or the
package is missing.
"""

from __future__ import annotations

import contextlib
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
PEAK_BYTES = 3.35e12

GOLDEN = {"pre_v": 51455, "pre_e": 69581, "post_v": 10138, "post_e": 20396,
          "n_faces": 20336}
MAIN_ARGV = ["-e", "-m", "small", "-d", "sphere", "-s", "1", "--gt_res", "128"]
# "Ours" plus the seven MC rows 16..64 below the 128 pseudo-GT, two
# nearest-neighbour searches each
MAIN_LAUNCHES = {"min_dist": 16}


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
    logs = cuda_build.build(["min_dist"])
    for name, log in logs.items():
        print(f"--- {name}.cu ({cuda_build.library_path(name).name})")
        print(log.strip() or "(already built)")
    print(f"build {time.time() - t:.1f} s")


def min_dist_bound_ms(n: int, m: int) -> tuple[float, str]:
    """Least time for the nearest-neighbour search: 8 f32 operations per
    pair (3 sub, 3 mul, 2 add) against the bytes read and written once."""
    ops = 8.0 * n * m
    nbytes = (n + m) * 3 * 4 + n * (4 + 4)
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def kernel_phase():
    phase("3. kernels vs plain")
    from tropical_torch.ops import chamfer as ch

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def pts(n):
        # first-hit samples lie on a surface of radius ~0.6
        p = rng.normal(size=(n, 3))
        p = 0.6 * p / np.linalg.norm(p, axis=1, keepdims=True)
        return torch.from_numpy(p.astype(np.float32)).to(dev)

    x, y = pts(100_000), pts(100_000)
    cases = {"100000x100000": (x, y),
             "99871x100003": (pts(99_871), pts(100_003))}
    dup = pts(50_000)
    cases["duplicates 60000x100000"] = (dup[:60_000 // 2].repeat(2, 1),
                                        torch.cat([dup, dup]))

    max_err = 0.0
    for label, (a, b) in cases.items():
        d2, idx = ch.min_nn_distance(a, b)  # the wrapper: CUDA -> kernel
        torch.cuda.synchronize()
        p2, pidx = ch.min_dist_plain(a, b)
        err = float((d2 - p2).abs().max())
        max_err = max(max_err, err)
        # indices agree except at exact ties, where the kernel's pick must
        # attain the same distance
        diff = torch.nonzero(idx != pidx).squeeze(1)
        e = a[diff] - b[idx[diff].long()]
        tie_d2 = (e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1]) + e[:, 2] * e[:, 2]
        ties_ok = bool((tie_d2 == p2[diff]).all())
        print(f"{label}: max |d2 - plain| = {err:.3e}, index mismatches "
              f"{diff.numel()} (all exact ties: {ties_ok})")
        check(err == 0.0, f"{label}: kernel disagrees with plain by {err}")
        check(ties_ok, f"{label}: index mismatch outside exact ties")

    n, m = x.shape[0], y.shape[0]
    ms = cuda_ms(lambda: ch.min_nn_distance(x, y), iters=20, warmup=2)
    plain_ms = cuda_ms(lambda: ch.min_dist_plain(x, y), iters=3)

    def library():
        # torch.cdist + min, chunked over x: the yardstick, not used by the port
        for r0 in range(0, n, 8192):
            torch.cdist(x[r0:r0 + 8192], y).min(dim=1)

    library_ms = cuda_ms(library, iters=3)
    bound_ms, bound_by = min_dist_bound_ms(n, m)
    print(f"min_dist {n}x{m}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"cdist+min {library_ms:.3f} ms, bound {bound_ms:.3f} ms "
          f"({bound_by}); kernel at {bound_ms / ms:.1%} of the bound")
    return {"name": "min_dist", "route": "cuda",
            "source": "tropical_torch/csrc/min_dist.cu",
            "replaces": "tropical/ops/chamfer_tpu.py:83",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "shape": [n, m]}


def main_path_phase():
    phase("4. main path: " + " ".join(MAIN_ARGV))
    from tropical_torch.extract import stats
    from tropical_torch.ops import chamfer as ch
    from tropical_torch.ops.chamfer import min_dist_plain
    from tropical_torch.stanford import train
    from tropical_torch.utils.ply import read_ply

    # every kernel's launch count, zeroed just before the main path
    for k in ch.LAUNCHES:
        ch.LAUNCHES[k] = 0
    tee = Tee(sys.stdout)
    t = time.time()
    with contextlib.redirect_stdout(tee):
        rc = train.main(MAIN_ARGV)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = dict(ch.LAUNCHES)
    text = tee.buf.getvalue()

    check(rc == 0, f"CLI returned {rc}")
    print(f"main path wall {wall:.2f} s; kernel launches {launches}")
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

    ours_row = re.search(r"^Ours, +\d+, ([-\d.naif]+), +([-\d.naif]+), ",
                         text, re.M)
    check(ours_row, "no 'Ours' row in the evaluation table")
    cd, ad = float(ours_row.group(1)), float(ours_row.group(2))
    print(f"Ours: CD {cd}, AD {ad}")
    check(math.isfinite(cd) and math.isfinite(ad) and cd > 0,
          f"Ours CD {cd} / AD {ad}")

    extract_s = float(re.search(r" take ([\d.]+)", text).group(1))
    stages = {k: round(v, 4) for k, v in train.PHASES.totals.items()}
    funnel = re.search(r"# of vertices and edges = .*faces", text).group(0)
    print(json.dumps({"funnel": funnel, "extract_s": extract_s,
                      "eval_stage_s": stages, "wall_s": round(wall, 4)}))
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
    record = kernel_phase()
    launches = main_path_phase()
    record["launches"] = launches[record["name"]]

    phase("5. result")
    print(json.dumps({"kernels": [record]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
