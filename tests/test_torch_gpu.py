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

import trilinear_cases as cases
from tropical_torch.core import trilinear as ttri
from tropical_torch.ops import chamfer as tch
from tropical_torch.ops.launches import LAUNCHES

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
    before = LAUNCHES["min_dist"]
    d2, idx = tch.min_nn_distance(xc, yc)
    torch.cuda.synchronize()
    assert LAUNCHES["min_dist"] == before + 1
    p2, pidx = tch.min_dist_plain(xc, yc)
    torch.testing.assert_close(d2, p2, rtol=0, atol=0)
    torch.testing.assert_close(idx, pidx, rtol=0, atol=0)
    assert float(d2[:50].max()) == 0.0


def _case(name):
    """(x, y) float32 for one bitwise case of the kernel."""
    rng = np.random.default_rng(11)
    if name == "offset":  # |y|^2 - 2 x.y cancels: the filter lets much through
        p = 100.0 + rng.uniform(0.0, 0.02, size=(7000, 3))
        return p[:3000], p[3000:]
    if name == "duplicates":
        p = rng.normal(size=(5000, 3))
        return p[::3], np.concatenate([p[:1500], p, p[:700]])
    if name in ("mirror_ties", "mirror_near_ties"):
        c = 0.0 if name == "mirror_ties" else 0.3
        q = rng.uniform(-0.5, 0.5, size=(4000, 3)).astype(np.float32)
        q[:, 2] = c + np.abs(q[:, 2])
        m = q.copy()
        m[:, 2] = np.float32(2 * c) - q[:, 2]
        x = rng.uniform(-0.5, 0.5, size=(3000, 3)).astype(np.float32)
        x[:, 2] = c
        return x, np.concatenate([q, m])
    shape = {"n0": (0, 5000), "n1": (1, 5000), "m1": (3000, 1),
             "n1_m1": (1, 1),
             # fewer rows than one block's, y not a multiple of the panel
             "ragged": (300, 2500),
             # few x blocks over a long y: the y range is split
             "split": (2000, 50_000)}[name]
    return rng.normal(size=(shape[0], 3)), rng.normal(size=(shape[1], 3))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["offset", "duplicates", "mirror_ties",
                                  "mirror_near_ties", "n0", "n1", "m1",
                                  "n1_m1",
                                  "ragged", "split"])
def test_min_dist_kernel_bitwise_on_hard_cases(name):
    _need_cuda()
    from tropical_torch.ops import cuda_build

    x, y = (torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()
            for a in _case(name))
    cfg = tch.kernel_config(cuda_build.load("min_dist"), 0)
    splits, _ = tch.split_plan(x.shape[0], y.shape[0], cfg["sms"],
                               cfg["resident"], cfg["rows_per_block"],
                               cfg["panel"])
    if name == "split":
        assert splits > 1
    if name == "ragged":
        assert x.shape[0] < cfg["rows_per_block"] and y.shape[0] % cfg["panel"]
    before = LAUNCHES["min_dist"]
    d2, idx = tch.min_nn_distance(x, y)
    torch.cuda.synchronize()
    # one launch per search; with no x rows there is nothing to launch
    assert LAUNCHES["min_dist"] == before + (x.shape[0] > 0)
    assert d2.is_cuda and d2.shape == idx.shape == (x.shape[0],)
    p2, pidx = tch.min_dist_plain(x, y)
    torch.testing.assert_close(d2, p2, rtol=0, atol=0)
    torch.testing.assert_close(idx, pidx, rtol=0, atol=0)


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


def _rows(name):
    """(p, q) float32 [B, 8] for one bitwise case of trilinear_roots."""
    if name == "hard":
        p, q, _ = cases.kernel_pq(n_random=0)
        return p, q
    if name == "one_row":  # a pair of roots inside one sample cell
        p, q, labels = cases.hard_pq(n_random=0)
        i = int(np.nonzero(labels == "pair_in_cell")[0][0])
        return p[i:i + 1], q[i:i + 1]
    # 32 rows a block at 4 lanes a row, 8 a warp: a ragged last block, a
    # ragged last warp, and fewer rows than one block
    n = {"ragged": 128 * 3 + 17, "ragged_block": 32 * 5 + 12,
         "ragged_warp": 8 * 3 + 5, "seeded": 100_000}[name]
    rng = np.random.default_rng(7)
    return (rng.normal(size=(n, 8)).astype(np.float32),
            rng.normal(size=(n, 8)).astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["hard", "one_row", "ragged",
                                  "ragged_block", "ragged_warp", "seeded"])
def test_trilinear_roots_kernel_bitwise(name):
    """All three outputs to the bit, sentinels included, and one launch
    counted per call."""
    _need_cuda()
    p, q = (torch.from_numpy(a).cuda() for a in _rows(name))
    before = LAUNCHES["trilinear_roots"]
    out = ttri.intersection_of_two_planes(p, q)
    torch.cuda.synchronize()
    assert LAUNCHES["trilinear_roots"] == before + 1
    plain = ttri.intersection_of_two_planes_plain(p, q)
    assert out.is_cuda and out.shape == plain.shape == (p.shape[0], 3)
    mismatched = (out.view(torch.int32) != plain.view(torch.int32)).any(1)
    assert int(mismatched.sum()) == 0, out[mismatched][:5]
    if name == "hard":
        assert bool((out == -1).any()) and bool((out[:, 0] >= 0).any())


@pytest.mark.gpu
def test_trilinear_roots_kernel_launch_rules():
    _need_cuda()
    before = LAUNCHES["trilinear_roots"]
    empty = torch.zeros(0, 8, device="cuda")
    assert ttri.intersection_of_two_planes(empty, empty).shape == (0, 3)
    assert LAUNCHES["trilinear_roots"] == before   # B = 0 launches nothing
    good = torch.zeros(16, 8, device="cuda")
    with pytest.raises(TypeError):
        ttri.intersection_of_two_planes(good.double(), good)
    with pytest.raises(ValueError, match="shape"):
        ttri.intersection_of_two_planes(torch.zeros(16, 4, device="cuda"),
                                        good)
    with pytest.raises(ValueError, match="contiguous"):
        ttri.intersection_of_two_planes(torch.zeros(8, 16, device="cuda").T,
                                        good)
    with pytest.raises(ValueError, match="aligned"):
        shifted = torch.zeros(16 * 8 + 1, device="cuda")[1:].view(16, 8)
        ttri.intersection_of_two_planes(shifted, good)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ttri.intersection_of_two_planes(good, torch.zeros(16, 8))
    with pytest.raises(ValueError, match="do not match"):
        ttri.intersection_of_two_planes(good, good[:8])
    # a thread count past int32 is refused before anything is allocated
    from tropical_torch.ops import cuda_build

    huge = torch.empty((2 ** 29, 8), device="meta")
    with pytest.raises(ValueError, match="int32"):
        ttri.run_kernel(cuda_build.load("trilinear_roots"), huge, huge)
    assert LAUNCHES["trilinear_roots"] == before
