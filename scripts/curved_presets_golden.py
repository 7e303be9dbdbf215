"""Write the JAX package's curved funnels of the sphere presets.

    JAX_PLATFORMS=cpu python scripts/curved_presets_golden.py [small medium]

Runs the JAX package's own ``subpoly`` (``engine="auto"``, ``force=False``:
its fused device engine with the distance skeleton, the route the JAX CLI's
``-f`` takes) on the committed sphere-small and sphere-medium checkpoints on
the CPU and writes each preset's funnel, triangle count, the curved stage
meters (``LAST_HW[13:16]``: sentinel rows, rows the gradient-descent rescue
moved, curved rows the strict filter dropped) and the seconds the run took
to ``tests/golden/sphere_curved_presets.json``.  The engine memoizes its
capacities in a file; the script points ``TROPICAL_CAPS_FILE`` at a
temporary one, so nothing under ``tropical/`` is written.  The port's CPU
test of sphere-small and its GPU smoke run hold the port's curved device
engine to these counts.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["TROPICAL_CAPS_FILE"] = os.path.join(
    tempfile.mkdtemp(prefix="curved-golden-caps-"), "caps_cache.json")
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "tests", "golden", "sphere_curved_presets.json")


def main(sizes) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")

    from tropical.extract import device as dv
    from tropical.extract import stats
    from tropical.extract.subdivide import subpoly
    from tropical.stanford.model import net_for_size
    from tropical.utils import checkpoint as ckpt

    golden = json.load(open(OUT)) if os.path.exists(OUT) else {}
    for size in sizes:
        net = net_for_size(size, seed=1)
        path = f"tropical/stanford/models/sphere/sphere_sdf_{size}_1.pth"
        ckpt.load_into(net, ckpt.find_checkpoint(os.path.join(ROOT, path)))
        t = time.time()
        _, vertices, tris = subpoly(net, 3, 1.2, force=False, verbose=False,
                                    engine="auto")
        took = time.time() - t
        sent, gd, drops = (int(x) for x in dv.LAST_HW[13:16])
        golden[f"sphere_{size}_curved"] = {
            "checkpoint": path, "marks": int(net.marks.shape[0]),
            **{k: stats.LAST[k] for k in ("pre_v", "pre_e", "post_v",
                                          "post_e")},
            "n_tris": int(tris.shape[0]), "sentinels": sent, "gd_rows": gd,
            "strict_drops": drops, "seconds": round(took, 1)}
        print(f"{size}: {golden[f'sphere_{size}_curved']}", flush=True)
        with open(OUT, "w") as fh:
            json.dump(golden, fh, indent=1, sort_keys=True)
            fh.write("\n")
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["small", "medium"]))
