"""Measure how far vertex sets of the curved path move by rounding alone.

    JAX_PLATFORMS=cpu python scripts/curved_eps_flips.py [--seeds 2]

On each synthetic kinked net of ``tests/test_device_curved.py`` (tables
scaled 3000x and 30000x), runs the JAX package's host engine
(``engine="host"``, ``force=False``) on the CPU and compares its vertex set
with three others:

- the port's curved path on the CPU (``tropical_torch``, the same weights);
- the JAX package's own device engine (``subpoly_device``);
- the JAX host engine with every weight moved by one ulp (one run a seed).

For each it prints the vertex counts, the count gap and the share of each
set's vertices farther than 1e-5 from the other set.  The bounds in
``KINKED`` of ``tests/test_torch_curved.py`` come from this output.  Takes
about five minutes.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=2,
                    help="one-ulp perturbations to run per net")
    args = ap.parse_args()

    # the device engine persists the caps it learns; keep them out of the
    # package's committed caps file
    caps = tempfile.TemporaryDirectory()
    os.environ["TROPICAL_CAPS_FILE"] = os.path.join(caps.name, "caps.json")
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from test_device_curved import _kinked_net
    from test_torch_curved import KINKED, _far_shares, _torch_twin, \
        _ulp_perturbed
    from tropical.extract import failover as jfo
    from tropical.extract.device import subpoly_device
    from tropical.extract.subdivide import subpoly as jsubpoly
    from tropical_torch.extract import failover as tfo
    from tropical_torch.extract.subdivide import subpoly as tsubpoly

    def report(fixture, other, Vj, V, counters):
        V = np.asarray(V)
        far = _far_shares(Vj, V)
        print(f"{fixture}: JAX host vs {other}: vertices {len(Vj)}/{len(V)}, "
              f"count gap {abs(len(V) - len(Vj)) / len(Vj):.4%}, far "
              f"{far[0]:.4%} of JAX / {far[1]:.4%} of the other; counters "
              f"{counters}", flush=True)

    for fixture, cfg in KINKED.items():
        jnet = _kinked_net(**cfg["kw"])
        _, Vj, _ = jsubpoly(jnet, 3, 1.2, force=False, verbose=False,
                            engine="host")
        Vj = np.asarray(Vj)
        print(f"{fixture}: JAX host counters {jfo.COUNTERS}")
        _, Vt, _ = tsubpoly(_torch_twin(jnet), 3, 1.2, force=False,
                            verbose=False)
        report(fixture, "port", Vj, Vt.numpy(), dict(tfo.COUNTERS))
        _, Vd, _ = subpoly_device(jnet, force=False, verbose=False)
        report(fixture, "JAX device", Vj, Vd, "-")
        for seed in range(args.seeds):
            _, Vp, _ = jsubpoly(_ulp_perturbed(jnet, seed), 3, 1.2,
                                force=False, verbose=False, engine="host")
            report(fixture, f"JAX host, weights one ulp off (seed {seed})",
                   Vj, Vp, dict(jfo.COUNTERS))
    caps.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
