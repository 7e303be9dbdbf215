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

import encode_cases
import faces_cases
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
    faces, vertices, tris = subpoly(net, 3, 1.2, force=True, verbose=False,
                                    engine="host")
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


def _encode_case(name):
    """(spec, table, x, dfeat, ddx) on the card for one case of the encode
    kernels: preset specs at ragged B, one point, and the unit cube's faces
    (x = 1.0 on a level of integer scale reaches the corner at the
    resolution, which wraps within the level); every point in one cell of
    every level (the table gradients' worst contention); custom grids of 1,
    5 and 16 levels (a point of more than 4 levels takes several passes in
    the backwards); a ragged B over many blocks' grid-stride loops; points
    far outside the cube (dense bases past int32) and a grid whose corner
    indices wrap past the int64 limit (``encode_cases``)."""
    from tropical_torch.core import hashgrid as thg
    from tropical_torch.stanford.model import SIZE_PRESETS, net_for_size

    size, n = {"small_1000": ("small", 1000), "medium_777": ("medium", 777),
               "large_hashed_1031": ("large", 1031), "small_1": ("small", 1),
               "small_faces": ("small", 600), "large_0": ("large", 0),
               "small_one_cell": ("small", 5000),
               "levels_1": (1, 333), "levels_5": (5, 1001),
               "levels_16": (16, 257),
               "small_ragged_100003": ("small", 100_003),
               "small_far": ("small", 1000), "wrap": ("wrap", 64)}[name]
    if size == "wrap":
        spec = thg.HashGridSpec(**encode_cases.WRAP_SPEC)
    elif isinstance(size, int):
        spec = thg.HashGridSpec(levels=size, n_min=2, n_max=32, log2_table=12)
    else:
        spec = net_for_size(size, device="cpu").spec.grid
        assert (spec.n_min, spec.n_max) == SIZE_PRESETS[size]
    rng = np.random.default_rng(len(name))
    x = rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    if name == "small_faces":
        x = rng.choice(np.float32([0.0, 0.25, 0.5, 1.0]), size=(n, 3))
        x[: n // 2, 0] = rng.uniform(0, 1, n // 2)
        assert float(spec.level_scale(spec.levels - 1)).is_integer()
    if name == "small_one_cell":
        x[:] = x[0]
    if name == "small_far":
        x = encode_cases.far_points(rng, n)
    if name == "wrap":
        x = encode_cases.wrap_points(n)
    table = rng.normal(size=(spec.n_entries, 2)).astype(np.float32)
    dfeat = rng.normal(size=(n, spec.levels * 2)).astype(np.float32)
    ddx = rng.normal(size=(n, 3)).astype(np.float32)
    return (spec,) + tuple(torch.from_numpy(a).cuda()
                           for a in (table, x, dfeat, ddx))


def _bits_equal(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _scatter_close(got, plain, n):
    """A scattered table gradient against its plain version: within
    4 2^-24 sqrt(n) of the plain version's largest row (the order of the
    atomicAdds is free: a row of n terms moves by about 2^-24 sqrt(n) of its
    size)."""
    err = float((got - plain).abs().max())
    assert err <= 4 * 2.0 ** -24 * n ** 0.5 * float(plain.abs().max()), err


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["small_1000", "medium_777",
                                  "large_hashed_1031", "small_1",
                                  "small_faces", "large_0", "small_one_cell",
                                  "levels_1", "levels_5", "levels_16",
                                  "small_ragged_100003", "small_far",
                                  "wrap"])
def test_hashgrid_encode_kernels_match_plain(name):
    """Forward, dx, d_dfeat and dx2 to the bit; the table gradients to a
    tolerance; one launch counted per kernel call, none for B = 0."""
    _need_cuda()
    from tropical_torch.core import hashgrid as thg

    spec, table, x, dfeat, ddx = _encode_case(name)
    n = x.shape[0]
    names = ("hashgrid_encode_fwd", "hashgrid_encode_bwd",
             "hashgrid_encode_bwd_bwd")
    before = [LAUNCHES[k] for k in names]
    feat = thg.hashgrid_encode_fwd(spec, table, x)
    dx, dtable = thg.hashgrid_encode_bwd(spec, table, x, dfeat)
    dd, dtable2, dx2 = thg.hashgrid_encode_bwd_bwd(spec, table, x, dfeat, ddx)
    torch.cuda.synchronize()
    assert [LAUNCHES[k] - b for k, b in zip(names, before)] == [int(n > 0)] * 3
    assert _bits_equal(feat, thg.encode_plain(spec, table, x))
    pdx, pdt = thg.encode_backward_plain(spec, table, x, dfeat)
    assert _bits_equal(dx, pdx)
    dx_only, none = thg.hashgrid_encode_bwd(spec, table, x, dfeat,
                                            need_table=False)
    assert none is None and _bits_equal(dx_only, pdx)
    pdd, pdt2, pdx2 = thg.encode_double_backward_plain(spec, table, x, dfeat,
                                                       ddx)
    assert _bits_equal(dd, pdd) and _bits_equal(dx2, pdx2)
    if n == 0:
        assert not dtable.any() and not dtable2.any()
        return
    _scatter_close(dtable, pdt, n)
    _scatter_close(dtable2, pdt2, n)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [4, 1])
def test_hashgrid_encode_forward_bitwise_at_each_lane_count(lanes):
    """The forward takes 4 or 1 lanes a (point, level) by B: at a B that
    takes each, bitwise ``encode_plain``, on points in and around the cube
    and far outside it."""
    _need_cuda()
    from tropical_torch.core import hashgrid as thg
    from tropical_torch.stanford.model import net_for_size

    spec = net_for_size("small", device="cpu").spec.grid
    run = thg._launcher(spec, torch.cuda.current_device(), None)
    # slots x lanes at three quarters of the card's resident threads
    n = int(0.75 * run.plan.fwd_wave / (thg._group(spec) * lanes))
    assert run.lanes(n) == lanes
    rng = np.random.default_rng(lanes)
    x = rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    x[: n // 8] = encode_cases.far_points(rng, n // 8)
    table = rng.normal(size=(spec.n_entries, 2)).astype(np.float32)
    xc, tc = torch.from_numpy(x).cuda(), torch.from_numpy(table).cuda()
    feat = thg.hashgrid_encode_fwd(spec, tc, xc)
    torch.cuda.synchronize()
    assert _bits_equal(feat, thg.encode_plain(spec, tc, xc))


def _normal_with_table(net, x):
    """The sdf's normal with the table in autograd (the route before
    normal() detached it)."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(net._sdf(xx).sum(), xx)
    return g


@pytest.mark.gpu
def test_normal_and_gd_rescue_scatter_no_table_gradient():
    """normal() and the GD rescue launch the backward without a table
    scatter, and their results are bitwise the table route's."""
    _need_cuda()
    from tropical_torch.extract import failover as tfo
    from tropical_torch.ops import launches
    from tropical_torch.stanford.model import net_for_size

    net = net_for_size("small", "sphere", 1, device="cuda")
    with torch.no_grad():
        net.enc.table.mul_(3000.0)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.uniform(-1, 1, (10171, 3)).astype(np.float32))
    x = x.cuda()
    launches.reset()
    got = net.normal(x)
    torch.cuda.synchronize()
    assert LAUNCHES["hashgrid_encode_bwd"] == 1
    assert launches.SCATTERS["hashgrid_encode_bwd"] == 0
    assert _bits_equal(got, _normal_with_table(net, x))
    assert launches.SCATTERS["hashgrid_encode_bwd"] == 1

    n, R = 512, net.spec.n_neuron_cols
    args = [torch.from_numpy(a).cuda() for a in (
        rng.uniform(-0.8, 0.8, (n, 2, 3)).astype(np.float32),
        rng.uniform(0, 1, (n, 3)).astype(np.float32),
        np.ones((n, 2), np.float32), rng.uniform(size=n) < 0.2,
        rng.integers(0, R - 1, n))]
    launches.reset()
    got = tfo.gradient_descent_failover(net, *args, R - 1, eps=1e-4,
                                        max_iters=3)
    assert LAUNCHES["hashgrid_encode_bwd"] == 3
    assert launches.SCATTERS["hashgrid_encode_bwd"] == 0
    forward = net.forward
    net.forward = lambda x, gather=False, group=1, table_grad=True: forward(
        x, gather, group, True)
    try:
        want = tfo.gradient_descent_failover(net, *args, R - 1, eps=1e-4,
                                             max_iters=3)
    finally:
        del net.forward
    assert launches.SCATTERS["hashgrid_encode_bwd"] == 3
    for a, b in zip(got, want):
        assert _bits_equal(a, b)


@pytest.mark.gpu
def test_hashgrid_encode_autograd_on_cuda_counts_a_training_step():
    """One training step on the card: one forward, two backwards (J and the
    loss) and one double backward, and the same loss as on the CPU."""
    _need_cuda()
    from tropical_torch.stanford import training as ttr
    from tropical_torch.stanford.model import net_for_size

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-1, 1, (1000, 3)).astype(np.float32))
    y = torch.from_numpy(rng.uniform(-0.3, 0.3, 1000).astype(np.float32))
    nets = {dev: net_for_size("small", "sphere", 1, device=dev)
            for dev in ("cpu", "cuda")}
    losses = {}
    for dev, net in nets.items():
        opt, sched = ttr.make_optimizer(net.parameters(), 1e-3, 10)
        before = dict(LAUNCHES)
        losses[dev] = ttr.train_step(net, opt, sched, x.to(dev), y.to(dev),
                                     1000)
        counts = [LAUNCHES[k] - before[k] for k in (
            "hashgrid_encode_fwd", "hashgrid_encode_bwd",
            "hashgrid_encode_bwd_bwd")]
        assert counts == ([1, 2, 1] if dev == "cuda" else [0, 0, 0])
    for a, b in zip(losses["cuda"], losses["cpu"]):
        assert abs(float(a) - float(b)) <= 1e-6 * abs(float(b))


@pytest.mark.gpu
def test_hashgrid_encode_kernels_reject_what_they_do_not_take():
    _need_cuda()
    from tropical_torch.core import hashgrid as thg
    from tropical_torch.stanford.model import net_for_size

    spec = net_for_size("small", device="cpu").spec.grid
    table = torch.zeros(spec.n_entries, 2, device="cuda")
    x = torch.zeros(16, 3, device="cuda")
    with pytest.raises(TypeError):
        thg.hashgrid_encode_fwd(spec, table, x.double())
    with pytest.raises(ValueError, match="shape"):
        thg.hashgrid_encode_fwd(spec, table[:-1], x)
    with pytest.raises(ValueError, match="contiguous"):
        thg.hashgrid_encode_fwd(spec, table,
                                torch.zeros(3, 16, device="cuda").T)
    with pytest.raises(ValueError, match="CUDA tensor"):
        thg.hashgrid_encode_fwd(spec, table, x.cpu())
    with pytest.raises(ValueError, match="aligned"):
        shifted = torch.zeros(spec.n_entries * 2 + 1, device="cuda")[1:]
        thg.hashgrid_encode_fwd(spec, shifted.view(-1, 2), x)
    with pytest.raises(ValueError, match="D = 3 and F = 2"):
        thg.hashgrid_encode_fwd(
            thg.HashGridSpec(levels=2, features=4, log2_table=10), table, x)


class _PolyField:
    """A seeded cubic field on the host (numpy, elementwise, so bitwise the
    same whatever the batch), handed out on ``device``: stands in for a
    net's ``sdf``."""

    def __init__(self, device, seed=7):
        self.device = torch.device(device)
        self.c = np.random.default_rng(seed).normal(size=(3, 3, 3)) * 0.08

    def sdf(self, x):
        p = x.cpu().numpy().astype(np.float64)
        x0, x1, x2 = p[:, 0], p[:, 1], p[:, 2]
        val = 0.5 - (x0 * x0 + x1 * x1) - x2 * x2
        for i in range(3):
            for j in range(3):
                for k in range(3):
                    val = val + self.c[i, j, k] * (x0 ** i) * (x1 ** j) * (x2 ** k)
        return torch.from_numpy(val.astype(np.float32)[:, None]).to(self.device)


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["mt", "mc"])
def test_grid_meshes_on_cuda_bitwise_cpu_and_slabs_merge(method):
    """Marching tetrahedra (and cubes) on the card are bitwise the same on
    the CPU, over a field of 3 slabs (res 40), and every crossing on the
    two shared x-planes merges with its twin."""
    _need_cuda()
    from tropical_torch.utils import isosurface as iso
    from tropical_torch.utils import marching_cubes as mc

    slabs = iso.mt_slabs if method == "mt" else mc.mc_slabs
    meshes = {dev: mc.merge_slabs(slabs(_PolyField(dev), 40, 1.2), R=0.8)
              for dev in ("cuda", "cpu")}
    assert meshes["cuda"].faces.shape[0] > 1000
    np.testing.assert_array_equal(meshes["cuda"].vertices,
                                  meshes["cpu"].vertices)
    np.testing.assert_array_equal(meshes["cuda"].faces, meshes["cpu"].faces)
    merged, crossings = mc.slab_merge_counts(slabs(_PolyField("cuda"), 40, 1.2))
    assert merged == crossings > 0


@pytest.mark.gpu
def test_bvh_kernels_match_plain_on_a_ladder_mesh():
    """The BVH on the card, built from the committed sphere-small
    checkpoint's marching-cubes mesh at 64 (a mesh of the flat run's
    ladder): hierarchy, boxes and node records bitwise their plain
    versions; first hits (100,000 evaluation rays and adversarial ones),
    crossing counts and squared distances bitwise the plain tiles'; one
    launch of each kernel a call."""
    _need_cuda()
    import bvh_cases
    from tropical_torch.ops import bvh
    from tropical_torch.ops import mesh_queries as mq
    from tropical_torch.stanford.model import Net
    from tropical_torch.utils import checkpoint as ckpt
    from tropical_torch.utils.chamfer import get_rays
    from tropical_torch.utils.marching_cubes import run_marching_cubes

    net = ckpt.load_into(Net(r_min=2, r_max=32, device="cuda"), os.path.join(
        ROOT, "tropical/stanford/models/sphere/sphere_sdf_small_1.pth.npz"))
    mesh = run_marching_cubes(net, 64, 1.2, R=0.8)
    before = dict(LAUNCHES)
    q = mq.MeshQuery(mesh.vertices, mesh.faces, "cuda")
    tree = q.bvh
    n = tree.n
    assert n == mesh.faces.shape[0] > 1000
    assert LAUNCHES["bvh_hierarchy"] == before["bvh_hierarchy"] + 1
    assert LAUNCHES["bvh_refit"] == before["bvh_refit"] + 1
    children, parents, far = bvh.hierarchy_plain(bvh.morton_keys(q.tris))
    assert torch.equal(children, tree.children)
    assert torch.equal(parents, tree.parents)
    assert torch.equal(far, tree.far)
    boxes = bvh.refit_plain(tree.tris, children, tree.pad)
    assert torch.equal(boxes.view(torch.int32), tree.boxes.view(torch.int32))
    assert torch.equal(bvh.records_plain(children, boxes).view(torch.int32),
                       tree.records.view(torch.int32))
    assert torch.equal(tree.tris_padded[:, :9], tree.tris)
    assert not tree.tris_padded[:, 9:].any()

    o, d = get_rays(100_000, device="cuda")
    o2, d2 = bvh_cases.adversarial_rays(q.tris, 2000, 5)
    o, d = torch.cat([o, o2]), torch.cat([d, d2])
    t, fid = bvh.first_hits(tree, o, d)
    want_t, want_id = mq.first_hits_plain(q.tris, o, d)
    assert torch.equal(t.view(torch.int32), want_t.view(torch.int32))
    assert torch.equal(fid, want_id)
    assert (fid >= 0).float().mean() > 0.9

    p = bvh_cases.near_points(q.tris, 20_000, 6)
    direction = torch.from_numpy(mq._PARITY_DIR).cuda()
    assert torch.equal(bvh.crossings(tree, p, direction),
                       mq.crossings_plain(q.tris, p, direction))
    got = bvh.min_dist2(tree, p)
    assert torch.equal(got.view(torch.int32),
                       mq.min_dist2_plain(q.tris, p).view(torch.int32))
    assert LAUNCHES["bvh_ray"] == before["bvh_ray"] + 2
    assert LAUNCHES["bvh_closest"] == before["bvh_closest"] + 1


@pytest.mark.gpu
def test_bvh_kernels_on_empty_and_one_triangle_meshes():
    _need_cuda()
    from tropical_torch.ops import mesh_queries as mq

    v = np.array([[0, 0, 0.5], [1, 0, 0.5], [0, 1, 0.5]], np.float32)
    o = torch.zeros((3, 3), device="cuda")
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [0.3, 0.3, 0.53]],
                     device="cuda")
    d = d / d.norm(dim=1, keepdim=True)
    p = torch.tensor([[0.2, 0.2, 0.0], [0.2, 0.2, 1.0]], device="cuda")
    for faces in (np.zeros((0, 3), np.int64), np.array([[0, 1, 2]])):
        before = dict(LAUNCHES)
        got = mq.MeshQuery(v, faces, "cuda")
        want = mq.MeshQuery(v, faces, "cpu")
        for a, b in zip(got.ray_trace(o, d), want.ray_trace(o.cpu(), d.cpu())):
            assert torch.equal(a.cpu(), b)
        assert torch.equal(got.signed_distance(p).cpu(),
                           want.signed_distance(p.cpu()))
        launched = {k: LAUNCHES[k] - before[k] for k in
                    ("bvh_hierarchy", "bvh_refit", "bvh_ray", "bvh_closest")}
        assert launched == ({k: 0 for k in launched} if len(faces) == 0 else
                            {"bvh_hierarchy": 0, "bvh_refit": 1, "bvh_ray": 2,
                             "bvh_closest": 1})


def _same_bits(a, b):
    """Bitwise equal, a NaN matching any NaN."""
    nan = torch.isnan(b)
    return (torch.equal(torch.isnan(a), nan)
            and torch.equal(a[~nan].view(torch.int32),
                            b[~nan].view(torch.int32)))


@pytest.mark.gpu
def test_bvh_closest_two_passes_bitwise_on_hard_sets():
    """``bvh_closest`` on the labels' icosphere (5,120 triangles), bitwise
    the plain tiles on points near its centre (all through the warp pass),
    on vertices, on edge midpoints, on duplicates and with a NaN point;
    its first design (one thread a point) too; one launch counted a
    ``min_dist2`` call."""
    _need_cuda()
    import bvh_cases
    from tropical_torch.ops import bvh, cuda_build
    from tropical_torch.ops import mesh_queries as mq
    from tropical_torch.utils.procedural import icosphere

    ico = icosphere(4)
    q = mq.MeshQuery(ico.vertices, ico.faces, "cuda")
    assert q.bvh.n == 5120
    lib = cuda_build.load("bvh")
    first = cuda_build.load(("bvh", ("BVH_CLOSEST_ONE_THREAD",
                                     "BVH_REFIT_FENCES")))
    sets = bvh_cases.closest_sets(q.tris, 2000, 11)
    for name, p in sets.items():
        want = mq.min_dist2_plain(q.tris, p)
        got, queued = bvh.run_closest(lib, q.bvh, p)
        assert _same_bits(got, want), name
        got, first_queued = bvh.run_closest(first, q.bvh, p)
        assert _same_bits(got, want) and first_queued == 0, name
        if name == "centre":
            assert queued == p.shape[0]
        if name == "nan":
            assert int(torch.isnan(got).sum()) == 1
    before = LAUNCHES["bvh_closest"]
    bvh.min_dist2(q.bvh, sets["centre"])
    assert LAUNCHES["bvh_closest"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("faces", [1, 2, 3])
def test_bvh_refit_bitwise_on_small_meshes(faces):
    """The build of 1, 2 and 3 triangles on the card: hierarchy, far ends,
    boxes, node records and padded triangles bitwise the plain build, the
    boxes also in the refit's first design."""
    _need_cuda()
    from tropical_torch.ops import bvh, cuda_build

    tris = torch.tensor([[[0.0, 0.0, 0.5], [1.0, 0.0, 0.5], [0.0, 1.0, 0.5]],
                         [[1.0, 0.0, 0.5], [1.0, 1.0, 0.2], [0.0, 1.0, 0.5]],
                         [[2.0, 0.0, 0.0], [2.0, 3.0, 1.0],
                          [3.0, 1.0, 0.0]]])[:faces]
    want = bvh.build(tris)
    before = dict(LAUNCHES)
    got = bvh.build(tris.cuda())
    assert LAUNCHES["bvh_refit"] == before["bvh_refit"] + 1
    assert LAUNCHES["bvh_hierarchy"] == before["bvh_hierarchy"] + (faces > 1)
    for name in ("children", "parents", "far", "order"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name))
    for name in ("boxes", "records", "tris_padded"):
        assert torch.equal(getattr(got, name).cpu().view(torch.int32),
                           getattr(want, name).view(torch.int32))
    first = cuda_build.load(("bvh", ("BVH_CLOSEST_ONE_THREAD",
                                     "BVH_REFIT_FENCES")))
    boxes, _, _ = bvh.run_refit(first, got.tris, got.children, got.parents,
                                got.far, got.pad)
    assert torch.equal(boxes.view(torch.int32), got.boxes.view(torch.int32))


# bvh_ray at 2 and 4 lanes a ray (the design takes 1), and the first
# designs of bvh_ray and bvh_hierarchy; the hierarchy with every node past
# 2 keys, or only those past 2^11, through its warp pass
BVH_RAY_BUILDS = {"lanes2": ("BVH_RAY_LANES=2",),
                  "lanes4": ("BVH_RAY_LANES=4",),
                  "first": ("BVH_RAY_ONE_THREAD", "BVH_HIERARCHY_ONE_THREAD")}
BVH_HIERARCHY_BUILDS = {"warp2": ("BVH_HIERARCHY_WARP_LOG=1",),
                        "warp2048": ("BVH_HIERARCHY_WARP_LOG=11",),
                        "first": BVH_RAY_BUILDS["first"]}


def _bvh_libs(builds):
    from tropical_torch.ops import cuda_build

    targets = {k: ("bvh", v) for k, v in builds.items()}
    cuda_build.build(["bvh", *targets.values()])
    return {"design": cuda_build.load("bvh"),
            **{k: cuda_build.load(t) for k, t in targets.items()}}


@pytest.mark.gpu
def test_bvh_ray_designs_bitwise_on_hard_cases():
    """``bvh_ray`` as built (one lane a ray), at 2 and 4 lanes a ray and in
    its first design, bitwise the plain tiles:
    100,000 rays from the origin in shuffled order and adversarial ones
    over the closed icosphere(4); icosphere(2) with 100 of its faces
    repeated under higher ids (equal t); the 33-deep caterpillar along x;
    1 and 2 triangles; first hits and counts along one direction."""
    _need_cuda()
    import bvh_cases
    from tropical_torch.ops import bvh
    from tropical_torch.ops import mesh_queries as mq
    from tropical_torch.utils.chamfer import get_rays
    from tropical_torch.utils.procedural import icosphere

    libs = _bvh_libs(BVH_RAY_BUILDS)
    parity = torch.from_numpy(mq._PARITY_DIR).cuda()

    def tris_of(mesh):
        v = torch.from_numpy(np.asarray(mesh.vertices, np.float32))
        return v[torch.from_numpy(np.asarray(mesh.faces, np.int64))].cuda()

    ico = tris_of(icosphere(4))
    o, d = get_rays(100_000, device="cuda")
    o2, d2 = bvh_cases.adversarial_rays(ico, 0, 21)
    perm = torch.from_numpy(np.random.default_rng(21).permutation(
        100_000 + o2.shape[0])).cuda()
    ico2 = tris_of(icosphere(2))
    twice = torch.cat([ico2, ico2[:100]])
    cat = bvh_cases.caterpillar().cuda()
    co, cd = (t.cuda() for t in bvh_cases.caterpillar_rays(500, 22))
    cases = [("origin_shuffled", ico, torch.cat([o, o2])[perm],
              torch.cat([d, d2])[perm], bvh_cases.near_points(ico, 20_000, 21),
              parity),
             ("repeated_faces", twice,
              *bvh_cases.adversarial_rays(twice, 5000, 23),
              bvh_cases.near_points(twice, 5000, 23), parity),
             ("caterpillar", cat, co, cd, co[:500],
              torch.tensor([1.0, 0.0, 0.0], device="cuda"))]
    for k in (1, 2):
        small = ico[:k]
        cases.append((f"{k} triangle(s)", small,
                      *bvh_cases.adversarial_rays(small, 1000, 24),
                      bvh_cases.near_points(small, 1000, 24), parity))
    for name, tris, ro, rd, p, direction in cases:
        tree = bvh.build(tris)
        want_t, want_id = mq.first_hits_plain(tris, ro, rd)
        want_hits = mq.crossings_plain(tris, p, direction)
        assert (want_id >= 0).any(), name
        for build, lib in libs.items():
            t, fid = bvh.run_ray(lib, tree, ro, rd, False)
            assert torch.equal(t.view(torch.int32),
                               want_t.view(torch.int32)), (name, build)
            assert torch.equal(fid.long(), want_id), (name, build)
            _, hits = bvh.run_ray(lib, tree, p, direction.reshape(1, 3), True)
            assert torch.equal(hits.long(), want_hits), (name, build)


@pytest.mark.gpu
def test_bvh_hierarchy_designs_bitwise_on_deep_keys():
    """``bvh_hierarchy`` as built, with every node past 2 keys or past
    2,048 through its warp pass, and in its first design, bitwise
    ``hierarchy_plain`` on 300,000 random codes (repeats among them), 4
    codes over 100,000 keys (the ids' bits split them), the caterpillar and
    the labels' icosphere."""
    _need_cuda()
    import bvh_cases
    from tropical_torch.ops import bvh
    from tropical_torch.utils.procedural import icosphere

    libs = _bvh_libs(BVH_HIERARCHY_BUILDS)
    rng = np.random.default_rng(25)

    def keys_of(codes):
        codes = torch.from_numpy(np.asarray(codes, np.int64))
        return torch.sort((codes << 32) | torch.arange(codes.shape[0])
                          ).values.cuda()

    ico = icosphere(4)
    v = torch.from_numpy(np.asarray(ico.vertices, np.float32))
    sets = {"random": keys_of(rng.integers(0, 1 << 20, 300_000)),
            "four_codes": keys_of(rng.integers(0, 4, 100_000)),
            "caterpillar": bvh.morton_keys(bvh_cases.caterpillar().cuda()),
            "icosphere": bvh.morton_keys(
                v[torch.from_numpy(np.asarray(ico.faces))].cuda())}
    for name, keys in sets.items():
        want = bvh.hierarchy_plain(keys)
        for build, lib in libs.items():
            got = bvh.run_hierarchy(lib, keys)
            for a, b in zip(got, want):
                assert torch.equal(a, b), (name, build)


def _sphere_net(size):
    from tropical_torch.stanford.model import net_for_size
    from tropical_torch.utils import checkpoint as ckpt

    net = net_for_size(size, seed=1, device="cuda")
    return ckpt.load_into(net, ckpt.find_checkpoint(os.path.join(
        ROOT, f"tropical/stanford/models/sphere/sphere_sdf_{size}_1.pth")))


@pytest.mark.gpu
def test_device_engine_funnel_on_cuda():
    """The flat path through the device engine (the CLI's route): JAX's own
    funnel of the same route (``tests/golden/sphere_flat_presets.json``),
    with the four device-engine kernels launched and one host read a busy
    insertion."""
    _need_cuda()
    from tropical_torch.extract import device as dv
    from tropical_torch.extract import stats
    from tropical_torch.extract.subdivide import subpoly

    golden = json.load(open(os.path.join(
        ROOT, "tests/golden/sphere_flat_presets.json")))["sphere_small_flat"]
    before = dict(LAUNCHES)
    _, vertices, tris = subpoly(_sphere_net("small"), 3, 1.2, force=True,
                                verbose=False)
    assert stats.LAST == {k: golden[k] for k in ("pre_v", "pre_e", "post_v",
                                                 "post_e")} | {
        "n_faces": golden["n_tris"]}
    assert vertices.is_cuda and tris.shape == (golden["n_tris"], 3)
    for k in ("lattice_encode", "skeleton_mark", "split_step",
              "connect_step"):
        assert LAUNCHES[k] > before[k], k
    for k in ("final_keep", "face_keys", "face_regions", "face_fans"):
        assert LAUNCHES[k] == before[k] + 2, k
    assert dv.LAST.reads == len(dv.LAST.busy) + 4


@pytest.mark.gpu
@pytest.mark.parametrize("build", ["design", "first"])
def test_faces_kernels_match_plain_on_cuda(build):
    """K6 on the card, in the design and in the first design of face_keys
    and face_fans (``cuda_build.FACES_FIRST``): every stage call of the
    build's faces at sphere-small flat, and every planted one
    (tests/faces_cases.py), bitwise its plain version."""
    _need_cuda()
    from tropical_torch.extract import device as dv
    from tropical_torch.ops import cuda_build

    kern, stages = None, faces_cases.K6_STAGES
    if build == "first":
        kern = dv.Kernels(cuda_build.load(cuda_build.FACES_FIRST),
                          torch.device("cuda", 0))
        stages = faces_cases.K6_FIRST_STAGES
    eng = dv.Engine(_sphere_net("small"), kern=kern)
    sk = eng.skeleton("dist")
    args = eng.loop(*eng.pools(sk[0], sk[1], sk[5], sk[2:5]))
    _, calls = faces_cases.record(dv, lambda: eng.faces(*args))
    assert [c[0] for c in calls] == list(stages)
    assert faces_cases.held(dv, calls, kern) == len(stages)
    planted = faces_cases.planted_calls(dv, "cuda", first=kern is not None)
    assert faces_cases.held(dv, planted, kern) == len(planted)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["dist", "sign"])
def test_device_engine_kernels_match_plain_on_cuda(mode):
    """K2-K5 against their plain versions on the card, through the whole
    engine on sphere-small: the skeleton and the complex after the final
    insertion, bit for bit."""
    _need_cuda()
    from tropical_torch.extract import device as dv

    net = _sphere_net("small")
    runs = []
    for kern in (None, dv.PLAIN):
        eng = dv.Engine(net, kern=kern)
        sk = eng.skeleton(mode)
        P, counts = eng.pools(sk[0], sk[1], sk[5], sk[2:5])
        runs.append(list(sk) + list(eng.loop(P, counts)))
    for a, b in zip(*runs):
        a, b = (t.view(torch.int32) if t.dtype == torch.float32 else t
                for t in (a, b))
        assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["dist", "sign"])
def test_skeleton_mark_designs_bitwise_on_cuda(mode):
    """K3 at sphere-small (49^3 lattice points) in its design and its first
    design (``cuda_build.DEVICE_ENGINE_FIRST``) against the plain versions:
    the whole skeleton bitwise, and the launches each build records (dist:
    2 pools, the words, flags, scan and compaction, or the first design's
    3 pools, points, edges and squeeze; sign: 4, or 3)."""
    _need_cuda()
    from tropical_torch.extract import device as dv
    from tropical_torch.ops import cuda_build

    net = _sphere_net("small")
    first = dv.Kernels(cuda_build.load(cuda_build.DEVICE_ENGINE_FIRST),
                       torch.device("cuda", 0))
    want = dv.Engine(net, kern=dv.PLAIN).skeleton(mode)
    for build, kern, launched in (
            ("design", None, 6 if mode == "dist" else 4),
            ("first", first, 6 if mode == "dist" else 3)):
        before = LAUNCHES["skeleton_mark"]
        got = dv.Engine(net, kern=kern).skeleton(mode)
        torch.cuda.synchronize()
        assert LAUNCHES["skeleton_mark"] - before == launched, build
        assert len(got) == len(want) == 6
        for x, y in zip(want, got):
            x, y = (t.view(torch.int32) if t.dtype == torch.float32 else t
                    for t in (x, y))
            assert x.shape == y.shape and torch.equal(x, y), build


@pytest.mark.gpu
def test_lattice_encode_designs_bitwise_on_cuda():
    """K2 at sphere-small's skeleton lattice (49^3 points), in one launch and
    in its first design (a launch a level), with and without the
    derivatives, bitwise ``lattice_level_plain`` level by level; each
    build records the launches it makes (1, or one a level)."""
    _need_cuda()
    from tropical_torch.core import hashgrid as thg
    from tropical_torch.ops import cuda_build

    net = _sphere_net("small")
    spec = net.spec.grid
    xs = net.preprocess(net.marks * (net.spec.scale * 2) - net.spec.scale)
    n, LF = xs.shape[0] ** 3, spec.levels * 2
    tables = thg.lattice_tables(spec, net.enc.table.detach(), n)
    libs = {"design": cuda_build.load("lattice_encode"),
            "first": cuda_build.load(cuda_build.LATTICE_FIRST)}
    for need_grad in (False, True):
        want = [thg.lattice_level_plain(spec, tables[l], l, xs, xs, xs,
                                        need_grad)
                for l in range(spec.levels)]
        for build, lib in libs.items():
            feat = torch.full((n, LF), float("nan"), device="cuda")
            grad = (torch.full((3, n, LF), float("nan"), device="cuda")
                    if need_grad else None)
            before = LAUNCHES["lattice_encode"]
            thg.lattice_encode(spec, tables, xs, xs, xs, feat, grad, lib=lib)
            torch.cuda.synchronize()
            assert LAUNCHES["lattice_encode"] == before + (
                1 if build == "design" else
                sum(G is not None for G in tables))
            for l, (f, g) in enumerate(want):
                cols = slice(2 * l, 2 * l + 2)
                assert torch.equal(feat[:, cols].contiguous().view(
                    torch.int32), f.view(torch.int32)), (build, l)
                if need_grad:
                    assert torch.equal(grad[:, :, cols].contiguous().view(
                        torch.int32), g.view(torch.int32)), (build, l)


@pytest.mark.gpu
def test_connect_stages_designs_bitwise_on_cuda(monkeypatch):
    """Every call of K5's column table, pair scan and row compaction in a
    flat extraction of sphere-small, recorded, then replayed by the kernels,
    by their first designs and by the plain versions: bitwise (every result
    and every argument after the call; the first design builds no column
    table)."""
    _need_cuda()
    from tropical_torch.extract import device as dv
    from tropical_torch.ops import cuda_build

    first = dv.Kernels(cuda_build.load(cuda_build.DEVICE_ENGINE_FIRST),
                       torch.device("cuda", 0))
    calls = []
    names = ("connect_table", "connect_count", "connect_fill", "compact_rows")
    orig = {k: getattr(dv, k) for k in names}

    def recorder(name):
        def stage(*args, **kw):
            calls.append((name, [a.clone() if torch.is_tensor(a) else a
                                 for a in args], kw))
            return orig[name](*args, **kw)
        return stage

    for k in names:
        monkeypatch.setattr(dv, k, recorder(k))
    eng = dv.Engine(_sphere_net("small"))
    sk = eng.skeleton("dist")
    eng.loop(*eng.pools(sk[0], sk[1], sk[5], sk[2:5]))
    assert {c[0] for c in calls} == set(names)
    for name, args, kw in calls:
        runs = {}
        for build, kern in (("design", None), ("first", first),
                            ("plain", dv.PLAIN)):
            if build == "first" and name == "connect_table":
                continue
            a = [x.clone() if torch.is_tensor(x) else x for x in args]
            res = orig[name](*a, **{**kw, "kern": kern})
            res = res if isinstance(res, tuple) else (res,)
            runs[build] = [t for t in (*res, *a) if torch.is_tensor(t)]
        for build, out in runs.items():
            for x, y in zip(runs["plain"], out):
                assert x.shape == y.shape and torch.equal(
                    x.view(torch.int32), y.view(torch.int32)), (name, build)


@pytest.mark.gpu
def test_split_step_designs_bitwise_on_cuda(monkeypatch):
    """K4 on sphere-small: the whole engine in the design and in the first
    design (``cuda_build.DEVICE_ENGINE_FIRST``) bitwise the plain versions,
    with each build's launches (3 or 4 a busy insertion, one ``edge_words``
    for the starting pools and one for each hidden insertion's connecting
    edges); then every design call, recorded, replayed twice by the kernel
    (its counters back at zero) and by the first design's stages, as
    recorded and with the override planted (one row's plane-idx output off
    the eps band), bitwise the plain version."""
    _need_cuda()
    from tropical_torch.extract import device as dv
    from tropical_torch.ops import cuda_build

    net = _sphere_net("small")
    first = dv.Kernels(cuda_build.load(cuda_build.DEVICE_ENGINE_FIRST),
                       torch.device("cuda", 0))
    calls = []
    orig = {k: getattr(dv, k) for k in ("split_select", "split_finish")}

    def recorder(name):
        def stage(*args, **kw):
            calls.append((name, [a.clone() if torch.is_tensor(a) else a
                                 for a in args]))
            return orig[name](*args, **kw)
        return stage

    def bits(ts):
        return [t.view(torch.int32) if t.dtype == torch.float32 else t
                for t in ts if torch.is_tensor(t)]

    runs = {}
    for build, kern in (("plain", dv.PLAIN), ("first", first),
                        ("design", None)):
        if build == "design":
            for k in orig:
                monkeypatch.setattr(dv, k, recorder(k))
        before = LAUNCHES["split_step"]
        eng = dv.Engine(net, kern=kern)
        sk = eng.skeleton("dist")
        runs[build] = bits(list(eng.loop(*eng.pools(sk[0], sk[1], sk[5],
                                                    sk[2:5]))))
        torch.cuda.synchronize()
        busy = eng.stats.busy
        per = {"plain": 0, "first": 4, "design": 3}[build]
        assert LAUNCHES["split_step"] - before == per * len(busy) + (
            0 if build == "plain" else
            1 + sum(c > 0 for i, *_, c in busy if i < eng.n_hidden)), build
        for x, y in zip(runs["plain"], runs[build]):
            assert x.shape == y.shape and torch.equal(x, y), build
    assert {c[0] for c in calls} == set(orig)

    def clone(args):
        return [a.clone() if torch.is_tensor(a) else a for a in args]

    fired = 0
    for name, args in calls:
        cases = [args]
        if name == "split_finish":
            planted = clone(args)
            planted[0][-1, planted[10]] = 1.0  # OUTn at plane idx
            cases.append(planted)
        for case in cases:
            a = clone(case)
            want = bits([*orig[name](*a, kern=dv.PLAIN), *a])
            for _ in range(2):
                a = clone(case)
                got = bits([*orig[name](*a), *a])
                for x, y in zip(want, got):
                    assert x.shape == y.shape and torch.equal(x, y), name
            a = clone(case)
            if name == "split_select":
                E, EB, V, OUT, ZB, idx, n_split = a
                cum = dv.split_cumsum(dv.split_mark(EB, idx, kern=first))
                got = bits([*dv.split_lerp(E, cum, V, OUT, ZB, idx, n_split,
                                           kern=first), *a])
            else:
                OUTn, bz, lanes, ce, E, EB, LD, SB, ZB, nV, idx, eps, \
                    final = a
                viol = dv.split_override(OUTn, bz, idx, eps, kern=first)
                fired += int(viol[0])
                got = bits([*dv.split_append(OUTn, bz, viol, lanes, ce, E,
                                             EB, LD, SB, ZB, nV, idx, eps,
                                             final, kern=first), *a])
            for x, y in zip(want, got):
                assert x.shape == y.shape and torch.equal(x, y), (name,
                                                                 "first")
    # the planted override fired at every busy insertion, the recorded
    # calls at none
    assert fired == len(calls) // 2
