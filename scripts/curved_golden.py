"""Write the reference vertex set of the sphere-medium curved extraction.

    JAX_PLATFORMS=cpu python scripts/curved_golden.py

Runs the JAX package's exact host engine (``engine="host"``,
``force=False``) on the committed sphere-medium checkpoint on the CPU
(about two minutes) and saves its vertices, float32 [V, 3], to
``tests/golden/sphere_medium_curved_vertices.npy``.  The port's GPU smoke
run holds its own curved extraction against this set.  The funnel must be
the ``sphere_medium_curved`` self-golden of ``tests/golden/self_golden.json``;
the script refuses to write otherwise.
"""

from __future__ import annotations

import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "tests", "golden", "sphere_medium_curved_vertices.npy")


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from tropical.extract import failover as fo
    from tropical.extract import stats
    from tropical.extract.subdivide import subpoly
    from tropical.stanford.model import Net
    from tropical.utils import checkpoint as ckpt

    golden = json.load(open(os.path.join(
        ROOT, "tests", "golden", "self_golden.json")))["sphere_medium_curved"]
    net = Net(r_min=golden["r_min"], r_max=golden["r_max"],
              key=jax.random.PRNGKey(1))
    ckpt.load_into(net, ckpt.find_checkpoint(
        os.path.join(ROOT, golden["checkpoint"])))
    t = time.time()
    _, vertices, tris = subpoly(net, 3, 1.2, force=False, verbose=False,
                                engine="host")
    print(f"extraction {time.time() - t:.1f} s, funnel {stats.LAST}, "
          f"counters {fo.COUNTERS}")
    want = {k: golden[k] for k in ("pre_v", "pre_e", "post_v", "post_e")}
    got = {k: stats.LAST[k] for k in want}
    if got != want or tris.shape[0] != golden["n_tris"]:
        print(f"funnel {got}, {tris.shape[0]} triangles != golden {want}, "
              f"{golden['n_tris']}: not written", file=sys.stderr)
        return 1
    np.save(OUT, np.asarray(vertices, np.float32))
    print(f"wrote {OUT}: {vertices.shape}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
