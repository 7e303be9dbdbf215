"""Write the JAX package's device faces of sphere-large, flat.

    JAX_PLATFORMS=cpu python scripts/device_faces_golden.py

Runs the JAX package's ``subpoly_device`` (``force=True``) twice on the
committed sphere-large checkpoint on the CPU, as
``tests/test_torch_device_faces.py::_jax_device_faces`` does: the first
call goes through the ramp and the host faces and memoises the caps, the
second takes the fused program, whose faces are assembled on the device.
Writes ``tests/golden/sphere_large_device_faces.npz`` (about 80 s):

- ``triangles``: the fused call's triangles, each row sorted, int32;
- ``vertices``: its vertices, f32;
- ``funnel``: (pre_v, pre_e, post_v, post_e, n_tris), int64;
- ``host_only`` / ``device_only``: the rows (sorted) in which the first
  call's host faces and the fused call's device faces differ, each side's
  own, and ``jax_share``: their count over the device faces' distinct rows.

The engine memoizes its capacities in a file; the script points
``TROPICAL_CAPS_FILE`` at a temporary one, so nothing under ``tropical/``
is written.  ``chip_smoke.py`` holds the port's faces at sphere-large to
this file; ``tests/test_torch_device_faces.py`` checks its counts.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["TROPICAL_CAPS_FILE"] = os.path.join(
    tempfile.mkdtemp(prefix="device-faces-golden-caps-"), "caps_cache.json")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "tests", "golden", "sphere_large_device_faces.npz")
CHECKPOINT = "tropical/stanford/models/sphere/sphere_sdf_large_1.pth"


def rows(tris):
    """The distinct triangles, each row sorted, as a set of tuples."""
    return set(map(tuple, np.sort(np.asarray(tris), 1).tolist()))


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")

    from tropical.extract import device as jdv
    from tropical.extract import stats
    from tropical.stanford.model import net_for_size
    from tropical.utils import checkpoint as ckpt

    net = net_for_size("large", seed=1)
    ckpt.load_into(net, ckpt.find_checkpoint(os.path.join(ROOT, CHECKPOINT)))
    t = time.time()
    _, v_host, t_host = jdv.subpoly_device(net, verbose=False, force=True)
    funnel_host = dict(stats.LAST)
    _, v_dev, t_dev = jdv.subpoly_device(net, verbose=False, force=True)
    assert any(k[-1] == "fused" and k[3] for k in jdv._EXTRACT_CACHE), \
        "the second call did not take the fused program"
    funnel = dict(stats.LAST)
    assert funnel == funnel_host, (funnel, funnel_host)
    v_host, v_dev = np.asarray(v_host), np.asarray(v_dev)
    assert np.array_equal(v_host, v_dev), "the two calls' vertices differ"
    s_host, s_dev = rows(t_host), rows(t_dev)
    host_only = np.asarray(sorted(s_host - s_dev), np.int32).reshape(-1, 3)
    device_only = np.asarray(sorted(s_dev - s_host), np.int32).reshape(-1, 3)
    share = len(device_only) / len(s_dev)
    np.savez_compressed(
        OUT, triangles=np.sort(np.asarray(t_dev), 1).astype(np.int32),
        vertices=v_dev.astype(np.float32),
        funnel=np.asarray([funnel[k] for k in ("pre_v", "pre_e", "post_v",
                                               "post_e", "n_faces")],
                          np.int64),
        host_only=host_only, device_only=device_only,
        jax_share=np.float64(share))
    print(f"funnel {funnel}; host against device faces: {len(host_only)} / "
          f"{len(device_only)} rows differ of {len(s_dev)} ({share:.4%}); "
          f"{time.time() - t:.1f} s; wrote {OUT} "
          f"({os.path.getsize(OUT) / 1e6:.2f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
