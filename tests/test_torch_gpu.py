"""Tests of the port that need a CUDA card; each skips without one.

Imports neither jax nor the JAX package, so it runs where only PyTorch is
installed.  On a machine with a card, from the repository root:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""

import json
import os

import numpy as np
import pytest
import torch

from tropical_torch.ops import chamfer as tch

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_min_dist_kernel_matches_plain_bitwise():
    """Ragged sizes, with exact ties; d2 and the first-index tie rule are
    the plain version's to the bit."""
    _need_cuda()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(9871, 3)).astype(np.float32)
    y = rng.normal(size=(10003, 3)).astype(np.float32)
    y[5000:5100] = y[:100]
    x[:50] = y[:50]
    xc, yc = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    before = tch.LAUNCHES["min_dist"]
    d2, idx = tch.min_nn_distance(xc, yc)
    torch.cuda.synchronize()
    assert tch.LAUNCHES["min_dist"] == before + 1
    p2, pidx = tch.min_dist_plain(xc, yc)
    torch.testing.assert_close(d2, p2, rtol=0, atol=0)
    torch.testing.assert_close(idx, pidx, rtol=0, atol=0)
    assert float(d2[:50].max()) == 0.0


@pytest.mark.gpu
def test_min_dist_kernel_rejects_what_it_does_not_take():
    _need_cuda()
    good = torch.zeros(16, 3, device="cuda")
    with pytest.raises(TypeError):
        tch.min_nn_distance(good.double(), good)
    with pytest.raises(ValueError, match="shape"):
        tch.min_nn_distance(torch.zeros(16, 4, device="cuda"), good)
    with pytest.raises(ValueError, match="contiguous"):
        tch.min_nn_distance(torch.zeros(3, 16, device="cuda").T, good)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tch.min_nn_distance(good, torch.zeros(16, 3))
    with pytest.raises(ValueError, match="empty"):
        tch.min_nn_distance(good, good[:0])


@pytest.mark.gpu
def test_sphere_small_golden_funnel_on_cuda():
    _need_cuda()
    from tropical_torch.extract import stats
    from tropical_torch.extract.subdivide import subpoly
    from tropical_torch.stanford.model import Net
    from tropical_torch.utils import checkpoint as ckpt

    golden = json.load(open(os.path.join(ROOT, "tests/golden/self_golden.json")))
    net = ckpt.load_into(Net(r_min=2, r_max=32, device="cuda"), os.path.join(
        ROOT, "tropical/stanford/models/sphere/sphere_sdf_small_1.pth.npz"))
    faces, vertices, tris = subpoly(net, 3, 1.2, force=True, verbose=False)
    g = golden["sphere"]
    assert stats.LAST == {"pre_v": g["pre_v"], "pre_e": g["pre_e"],
                          "post_v": g["post_v"], "post_e": g["post_e"],
                          "n_faces": g["n_tris"]}
    assert vertices.is_cuda and tris.shape == (g["n_tris"], 3)
