"""The port's BVH (``tropical_torch/ops/bvh.py``, ``csrc/bvh.cu``) on the CPU.

- the plain hierarchy against Karras's algorithm written out a node at a
  time in Python, on small key sets with equal Morton codes, and the tree's
  invariants: every triangle in one leaf, every box holding its children's
  and its triangle;
- the four kernels' CUDA source, built with g++ against
  ``tests/cuda_emulation.h`` (one thread a lane, a block's lanes at once;
  the refit's atomics are ``std::atomic_ref``), bitwise against the plain
  versions on at most 2,000 triangles: children, parents, far ends and
  boxes, and each query's t, face id, crossing count and squared distance,
  on adversarial rays (zero direction components, rays through shared
  vertices and edges, origins on box faces); the closest-point query's two
  passes also with a budget of 2 box tests (nearly every point through the
  warp pass), from the centre of a closed mesh, on vertices, edge
  midpoints, duplicates and a NaN point; the refit's designs on meshes of
  1, 2 and 3 triangles and across blocks; the ray query at 1, 4 and 2
  lanes a ray (1 with and without the records) and in its first design on
  rays from the origin in shuffled order, repeated faces (equal t), a
  33-deep tree (``bvh_cases.caterpillar``, whose count overflows a
  32-entry stack) and 1 and 2 triangles; the
  hierarchy's two passes with low thresholds and in its first design on
  key sets up to 5,000 keys, pass 2 given exactly the long nodes;
- the port's ``MeshQuery`` against the JAX package's ``HostBVH`` and its
  ``MeshQuery`` on ``icosphere(3)`` and on a marching-cubes mesh of
  sphere-small at 32: face ids equal but at edge ties, t within 1e-6, the
  signed distance within 2e-7 of JAX's (XLA contracts the closest-point
  arithmetic into FMAs, as tests/test_torch_dataset.py measures) with the
  same signs;
- empty and one-triangle meshes; a tensor off the CPU never takes the
  brute-force tiles.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import bvh_cases
from bvh_cases import adversarial_rays, near_points
from test_torch_encode_forward import emulated_source
from tropical.ops.mesh_queries import MeshQuery as JaxMeshQuery
from tropical.utils import bvh_host
from tropical_torch.ops import bvh
from tropical_torch.ops import mesh_queries as mq
from tropical_torch.ops.launches import LAUNCHES
from tropical_torch.utils.procedural import icosphere

ROOT = Path(__file__).resolve().parents[1]
DIST_ATOL = 2e-7
# random rays from the origin ahead of the adversarial ones
RANDOM_RAYS = 1000


# --- Karras's hierarchy, a node at a time ------------------------------------

def karras_reference(keys):
    """(children, parents, far ends j) of sorted unique int keys, one
    internal node at a time, as Karras (2012) writes it."""
    n = len(keys)

    def delta(i, j):
        if j < 0 or j >= n:
            return -1
        return 64 - int(keys[i] ^ keys[j]).bit_length()

    children = [[0, 0] for _ in range(n - 1)]
    parents = [-1] * (2 * n - 1)
    far = [0] * (n - 1)
    for i in range(n - 1):
        d = 1 if delta(i, i + 1) - delta(i, i - 1) > 0 else -1
        dmin = delta(i, i - d)
        lmax = 2
        while delta(i, i + lmax * d) > dmin:
            lmax *= 2
        l, t = 0, lmax // 2
        while t >= 1:
            if delta(i, i + (l + t) * d) > dmin:
                l += t
            t //= 2
        j = i + l * d
        dnode = delta(i, j)
        s, div = 0, 2
        while True:
            t = -(-l // div)
            if delta(i, i + (s + t) * d) > dnode:
                s += t
            div *= 2
            if t <= 1:
                break
        split = i + s * d + min(d, 0)
        left = n - 1 + split if min(i, j) == split else split
        right = n + split if max(i, j) == split + 1 else split + 1
        children[i] = [left, right]
        parents[left] = parents[right] = i
        far[i] = j
    return children, parents, far


def _keys(codes):
    """Sorted keys code << 32 | index, as ``morton_keys`` makes them."""
    codes = np.asarray(codes, np.int64)
    return np.sort((codes << 32) | np.arange(len(codes), dtype=np.int64))


def _key_sets():
    rng = np.random.default_rng(0)
    yield "two", _keys([5, 3])
    yield "three_equal", _keys([7, 7, 7])
    yield "all_equal_17", _keys([0] * 17)
    yield "pairs", _keys(np.repeat(rng.integers(0, 1 << 30, 20), 2))
    yield "few_codes_300", _keys(rng.integers(0, 4, 300))
    yield "random_1000", _keys(rng.integers(0, 1 << 30, 1000))


@pytest.mark.parametrize("name,keys", list(_key_sets()),
                         ids=[k for k, _ in _key_sets()])
def test_plain_hierarchy_is_karras(name, keys):
    children, parents, far = bvh.hierarchy_plain(torch.from_numpy(keys))
    want_c, want_p, want_f = karras_reference([int(k) for k in keys])
    assert children.tolist() == want_c
    assert parents.tolist() == want_p
    assert far.tolist() == want_f


def test_clz64_is_the_bit_length():
    rng = np.random.default_rng(1)
    x = np.concatenate([[0, 1, 2, 3, (1 << 62) - 1, 1 << 62, (1 << 63) - 1],
                        rng.integers(0, 1 << 62, 500)]).astype(np.int64)
    got = bvh.clz64(torch.from_numpy(x)).tolist()
    assert got == [64 - int(v).bit_length() for v in x]


def _tris(mesh):
    v = torch.from_numpy(np.asarray(mesh.vertices, np.float32))
    return v[torch.from_numpy(np.asarray(mesh.faces, np.int64))]


def _meshes():
    """(name, [T, 3, 3] f32) meshes of at most 2,000 triangles."""
    rng = np.random.default_rng(2)
    yield "icosphere3", _tris(icosphere(3))
    soup = rng.uniform(-1, 1, (700, 1, 3)) + rng.normal(scale=0.05,
                                                        size=(700, 3, 3))
    yield "soup700", torch.from_numpy(soup.astype(np.float32))
    # axis-aligned squares on a grid: shared edges and vertices on the axis
    # planes, coplanar triangles, equal centroids in x
    g = np.stack(np.meshgrid(np.arange(12), np.arange(12), indexing="ij"),
                 -1).reshape(-1, 2).astype(np.float32) / 6 - 1
    quads = []
    for x, y in g:
        a, b = [x, y, 0.0], [x + 1 / 6, y, 0.0]
        c, d = [x + 1 / 6, y + 1 / 6, 0.0], [x, y + 1 / 6, 0.0]
        quads += [[a, b, c], [a, c, d]]
    yield "grid288", torch.tensor(quads, dtype=torch.float32)


MESHES = list(_meshes())


@pytest.mark.parametrize("name,tris", MESHES, ids=[m for m, _ in MESHES])
def test_plain_tree_invariants(name, tris):
    tree = bvh.build(tris)
    n = tree.n
    ch = tree.children.long()
    # every node but the root is one node's child, every leaf once
    assert sorted(ch.flatten().tolist()) == list(range(1, 2 * n - 1))
    assert sorted(tree.order.tolist()) == list(range(n))
    np.testing.assert_array_equal(tree.tris.numpy(),
                                  tris.reshape(n, 9)[tree.order.long()].numpy())
    assert tree.parents[0] == -1
    assert (tree.parents[ch[:, 0]] == torch.arange(n - 1)).all()
    assert (tree.parents[ch[:, 1]] == torch.arange(n - 1)).all()
    lo, hi = tree.boxes[:, :3], tree.boxes[:, 3:]
    for k in (0, 1):
        assert (lo[:n - 1] <= lo[ch[:, k]]).all()
        assert (hi[:n - 1] >= hi[ch[:, k]]).all()
    v = tree.tris.view(n, 3, 3)
    assert (lo[n - 1:] < v.amin(1)).all() and (hi[n - 1:] > v.amax(1)).all()
    # each internal node's box is exactly its children's union
    assert torch.equal(lo[:n - 1], torch.minimum(lo[ch[:, 0]], lo[ch[:, 1]]))
    assert torch.equal(hi[:n - 1], torch.maximum(hi[ch[:, 0]], hi[ch[:, 1]]))
    # node i covers the leaves from min(i, far) to max(i, far): its left
    # child's first and its right child's last
    i = torch.arange(n - 1)
    first, last = torch.minimum(i, tree.far.long()), torch.maximum(
        i, tree.far.long())
    span = torch.stack([first, last], 1)
    leaf_span = torch.cat([span, torch.arange(n)[:, None].repeat(1, 2)])
    assert torch.equal(leaf_span[ch[:, 0], 0], first)
    assert torch.equal(leaf_span[ch[:, 1], 1], last)
    assert torch.equal(leaf_span[ch[:, 0], 1] + 1, leaf_span[ch[:, 1], 0])
    # node i's record: its children's boxes, then their ids' bits
    assert torch.equal(tree.records[:, :6], tree.boxes[ch[:, 0]])
    assert torch.equal(tree.records[:, 6:12], tree.boxes[ch[:, 1]])
    assert torch.equal(tree.records[:, 12:14].contiguous().view(torch.int32),
                       tree.children)
    assert torch.equal(tree.tris_padded[:, :9], tree.tris)


# --- the CUDA source under the emulation ---------------------------------------

# the emulated builds: the design (4 warps a point in pass 2; one lane a
# ray; the hierarchy's warp pass past 256 keys); pass 1 on a budget of 2 box
# tests, 2 warps a point, the refit without the block's shared levels, 4
# lanes a ray, the warp pass past 8 keys; 1 warp a point without the node
# records (the refit writing none), the selects and the handing over of
# subtrees, one lane a ray without the records and with a 32-entry stack,
# the warp pass past 16 keys; 2 lanes a ray, every node past 2 keys through
# the warp pass; the first design of the four kernels; and the instrumented
# builds of the bound (one thread a point or ray) and of the design's own
# tests
BUILDS = {"design": (), "budget2": ("BVH_CLOSEST_BUDGET=2",
                                    "BVH_CLOSEST_WARPS=2",
                                    "BVH_REFIT_DEVICE_ONLY", "BVH_RAY_LANES=4",
                                    "BVH_HIERARCHY_WARP_LOG=3"),
          "ablated": ("BVH_CLOSEST_BUDGET=2", "BVH_CLOSEST_WARPS=1",
                      "BVH_CLOSEST_SPLIT_LOADS", "BVH_CLOSEST_BRANCHES",
                      "BVH_CLOSEST_NO_DONATE", "BVH_REFIT_NO_RECORDS",
                      "BVH_RAY_SPLIT_LOADS", "BVH_STACK=32",
                      "BVH_HIERARCHY_WARP_LOG=4"),
          "lanes2": ("BVH_RAY_LANES=2", "BVH_HIERARCHY_WARP_LOG=1"),
          "first": ("BVH_CLOSEST_ONE_THREAD", "BVH_REFIT_FENCES",
                    "BVH_RAY_ONE_THREAD", "BVH_HIERARCHY_ONE_THREAD"),
          "count": ("BVH_COUNT_VISITS",),
          "count_design": ("BVH_COUNT_VISITS", "BVH_COUNT_DESIGN")}
# the lanes a ray of each build, and the hierarchy's warp threshold (a
# node whose far end lies this many keys away or more takes pass 2)
RAY_LANES = {"design": 1, "budget2": 4, "ablated": 1, "lanes2": 2,
             "first": 1}
WARP_SPAN = {"design": 256, "budget2": 8, "ablated": 16, "lanes2": 2,
             "first": None}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """csrc/bvh.cu built with g++ against the emulation header, once a
    build of BUILDS, the compiles side by side."""
    compiler = shutil.which("g++")
    if compiler is None:
        pytest.skip("needs g++ to emulate the CUDA source")
    out = tmp_path_factory.mktemp("bvh_emulated")
    cpp = out / "bvh.cpp"
    cpp.write_text(emulated_source(
        (ROOT / "tropical_torch" / "csrc" / "bvh.cu").read_text()))
    running = {}
    for name, defines in BUILDS.items():
        so = out / f"libbvh_{name}.so"
        running[name] = (so, subprocess.Popen(
            [compiler, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
             "-shared", "-pthread", f"-I{ROOT / 'tests'}",
             *(f"-D{m}" for m in defines), "-include", "cuda_emulation.h",
             "-o", str(so), str(cpp)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for name, (so, proc) in running.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"g++ failed for {name}:\n{log}"
    return {name: ctypes.CDLL(str(so)) for name, (so, _) in running.items()}


@pytest.fixture(scope="module")
def emulated(libs):
    return libs["design"]


def _bits(t):
    return t.contiguous().view(torch.int32)


def _same_bits(got, want):
    """Bitwise equal, a NaN matching any NaN (its payload is the
    platform's)."""
    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(_bits(got)[~nan], _bits(want)[~nan]))


@pytest.mark.parametrize("name,tris", MESHES, ids=[m for m, _ in MESHES])
def test_emulated_kernels_bitwise_plain(emulated, name, tris):
    n = tris.shape[0]
    keys = bvh.morton_keys(tris)
    tree = bvh.build(tris)
    children, parents, far = bvh.run_hierarchy(emulated, keys)
    assert torch.equal(children, tree.children)
    assert torch.equal(parents, tree.parents)
    assert torch.equal(far, tree.far)
    boxes, records, padded = bvh.run_refit(emulated, tree.tris, children,
                                           parents, far, tree.pad)
    assert torch.equal(_bits(boxes), _bits(tree.boxes))
    assert torch.equal(_bits(records), _bits(tree.records))
    assert torch.equal(_bits(padded), _bits(tree.tris_padded))

    o, d = adversarial_rays(tris, 1200, n)
    t, fid = bvh.run_ray(emulated, tree, o, d, False)
    want_t, want_id = mq.first_hits_plain(tris, o, d)
    assert (want_id >= 0).any() and (want_id < 0).any()
    assert torch.equal(_bits(t), _bits(want_t))
    assert torch.equal(fid.long(), want_id)

    p = torch.cat([o[-200:], near_points(tris, 300, n)])
    direction = torch.from_numpy(mq._PARITY_DIR)
    _, hits = bvh.run_ray(emulated, tree, p, direction.reshape(1, 3), True)
    want_hits = mq.crossings_plain(tris, p, direction)
    assert torch.equal(hits.long(), want_hits)
    d2, _ = bvh.run_closest(emulated, tree, p)
    want_d2 = mq.min_dist2_plain(tris, p)
    assert torch.equal(_bits(d2), _bits(want_d2))
    assert float(want_d2[200:230].max()) == 0.0  # on vertices
    if name == "icosphere3":  # a closed mesh: points inside cross it oddly
        assert (want_hits % 2 == 1).any() and (want_hits % 2 == 0).any()


def _ray_cases():
    """(name, triangles, first-hit rays (o, d), count points, their one
    direction): rays from the origin in shuffled order (and adversarial
    ones) over the closed icosphere(3); icosphere(2) with 100 of its faces
    repeated under higher ids (equal t: the lower id wins); the 33-deep
    caterpillar along x, its count stacking 33 far children; 1 and 2
    triangles."""
    rng = np.random.default_rng(12)
    direction = torch.from_numpy(mq._PARITY_DIR)
    ico = MESHES[0][1]
    o, d = adversarial_rays(ico, 400, 12)
    perm = torch.from_numpy(rng.permutation(o.shape[0]))
    yield "origin_shuffled", ico, o[perm], d[perm], near_points(ico, 200, 12), \
        direction
    ico2 = _tris(icosphere(2))
    twice = torch.cat([ico2, ico2[:100]])
    o, d = adversarial_rays(twice, 300, 13)
    yield "repeated_faces", twice, o, d, near_points(twice, 100, 13), direction
    cat = bvh_cases.caterpillar()
    o, d = bvh_cases.caterpillar_rays(60, 14)
    yield "caterpillar", cat, o, d, o[:60], torch.tensor([1.0, 0.0, 0.0])
    for name, tris in SMALL_MESHES[:2]:
        o, d = adversarial_rays(tris, 100, 15)
        yield name, tris, o, d, near_points(tris, 50, 15), direction


@pytest.mark.parametrize("build", list(RAY_LANES))
def test_emulated_ray_designs_bitwise_plain(libs, build):
    """``bvh_ray`` at 1, 4, 1 and 2 lanes a ray (``RAY_LANES``; the design
    as the card runs it: node records, the stack's top in registers, the
    rest in local memory, the slab test's NaN by a sum; the ablated build
    without the records, with a 32-entry stack) and in its first design,
    bitwise the plain tiles on every case of ``_ray_cases``: first hits and
    counts.  The 32-entry stack of the ablated build overflows on the
    caterpillar, and the wrapper raises."""
    lib = libs[build]
    for name, tris, o, d, p, direction in RAY_CASES:
        tree = bvh.build(tris)
        one = direction.reshape(1, 3)
        if build == "ablated" and name == "caterpillar":
            for rays, count in (((o, d), False), ((p, one), True)):
                with pytest.raises(RuntimeError, match="stack overflowed"):
                    bvh.run_ray(lib, tree, *rays, count)
            continue
        t, fid = bvh.run_ray(lib, tree, o, d, False)
        want_t, want_id = mq.first_hits_plain(tris, o, d)
        assert torch.equal(_bits(t), _bits(want_t)), (build, name)
        assert torch.equal(fid.long(), want_id), (build, name)
        assert (want_id >= 0).any(), name
        if name == "repeated_faces":  # hits of a repeated face
            assert (want_id[(want_id >= 0) & (want_id < 100)] >= 0).any()
        _, hits = bvh.run_ray(lib, tree, p, one, True)
        want_hits = mq.crossings_plain(tris, p, direction)
        assert torch.equal(hits.long(), want_hits), (build, name)
        if name == "caterpillar":
            assert int(want_hits.max()) == tris.shape[0]


def test_caterpillar_is_deep():
    """The caterpillar's tree is 33 deep, and a ray along x crosses every
    triangle, those in x = 0 at one t (the least id wins)."""
    tris = bvh_cases.caterpillar()
    tree = bvh.build(tris)
    n = tree.n
    node, depth = torch.arange(n - 1, 2 * n - 1), 0
    while bool((node >= 0).any()):
        node = torch.where(node >= 0, tree.parents[node.clamp_min(0)], node)
        depth += 1
    assert depth - 1 == 33
    o, d = bvh_cases.caterpillar_rays(4, 1)
    t, fid = mq.first_hits_plain(tris, o[:4], d[:4])
    # every triangle of the y and z axes lies in x = 0 too: 30 at one t
    assert fid.tolist() == [0] * 4
    assert (t[1:3] == 10.0).all() and (t - 10.0).abs().max() < 1e-5


def _deep_key_sets():
    """The key sets of the plain hierarchy's test, and two deep enough for
    the warp's searches: 5,000 random codes and the caterpillar's."""
    yield from _key_sets()
    rng = np.random.default_rng(3)
    yield "random_5000", _keys(rng.integers(0, 1 << 30, 5000))
    yield "caterpillar", bvh.morton_keys(bvh_cases.caterpillar()).numpy()


DEEP_KEY_SETS = list(_deep_key_sets())


@pytest.mark.parametrize("build", list(RAY_LANES))
def test_emulated_hierarchy_designs_bitwise_plain(libs, build):
    """``bvh_hierarchy``: the design (a node whose far end lies 256 keys
    away or more through the warp pass, the rest from the block's window
    of keys in shared memory), the same past 8, 16 and 2 keys, and the
    first design, bitwise ``hierarchy_plain`` on every key set of
    ``_deep_key_sets``, twice into one scratch queue that starts with
    garbage: each call zeroes the queue's length itself, and pass 2 gets
    exactly the nodes past the threshold."""
    lib, span_at = libs[build], WARP_SPAN[build]
    reached = False
    for name, keys in DEEP_KEY_SETS:
        keys = torch.from_numpy(keys)
        n = keys.shape[0]
        want = bvh.hierarchy_plain(keys)
        queue = torch.full((n,), n + 7, dtype=torch.int32)
        span = (want[2].long() - torch.arange(n - 1)).abs()
        for _ in range(2):
            got = (torch.empty_like(want[0]), torch.full_like(want[1], -1),
                   torch.empty_like(want[2]))
            bvh.launch_hierarchy(lib, keys, *got, queue)
            for a, b in zip(got, want):
                assert torch.equal(a, b), (build, name)
            if span_at is not None:
                assert int(queue[0]) == int((span >= span_at).sum()), \
                    (build, name)
        reached |= span_at is not None and int(queue[0]) > 0
    assert reached or span_at is None  # the warp pass ran


def test_emulated_count_design_of_rays(libs):
    """The rays' instrumented design build (one lane a ray): results the
    plain tiles', each ray's tests adding up to the totals."""
    lib = libs["count_design"]
    name, tris, o, d, p, direction = RAY_CASES[0]
    tree = bvh.build(tris)
    for count, rays in ((False, (o, d)), (True, (p, direction.reshape(1, 3)))):
        out, _, per_query, totals = _counted(
            lib, tree, rays[0].shape[0],
            lambda: bvh.run_ray(lib, tree, *rays, count))
        if count:
            assert torch.equal(out[1].long(),
                               mq.crossings_plain(tris, p, direction))
        else:
            want_t, want_id = mq.first_hits_plain(tris, o, d)
            assert torch.equal(_bits(out[0]), _bits(want_t))
            assert torch.equal(out[1].long(), want_id)
        assert per_query.sum(dim=0).tolist() == totals
        assert (per_query[:, 0] % 2 == 0).all()


def test_emulated_one_triangle(emulated):
    tris = torch.tensor([[[0.0, 0.0, 0.5], [1.0, 0.0, 0.5], [0.0, 1.0, 0.5]]])
    tree = bvh.build(tris)
    assert tree.children.shape == (0, 2) and tree.parents.tolist() == [-1]
    boxes, records, padded = bvh.run_refit(emulated, tree.tris, tree.children,
                                           tree.parents, tree.far, tree.pad)
    assert torch.equal(boxes, tree.boxes) and records.shape == (0, 16)
    assert torch.equal(padded[:, :9], tree.tris) and not padded[:, 9:].any()
    o = torch.tensor([[0.2, 0.2, 0.0], [0.9, 0.9, 0.0], [0.0, 0.0, 0.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    t, fid = bvh.run_ray(emulated, tree, o, d, False)
    want_t, want_id = mq.first_hits_plain(tris, o, d)
    assert torch.equal(t, want_t) and fid.long().tolist() == want_id.tolist()
    assert want_id.tolist() == [0, -1, 0]  # (0, 0) is a vertex: a hit


def _counted(lib, tree, queries, launch):
    """``launch()`` of the instrumented build with its marks on: (its
    result, the marks [3, 2n-1] (box, children or triangle, face id), each
    query's (box, triangle) tests, the totals)."""
    touched = torch.zeros((3, 2 * tree.n - 1), dtype=torch.uint8)
    per_query = torch.zeros((queries, 2), dtype=torch.int32)
    lib.bvh_count_buffers.argtypes = [ctypes.c_void_p] * 2
    totals = (ctypes.c_ulonglong * 2)()
    lib.bvh_visit_counts.argtypes = [ctypes.c_void_p]
    assert lib.bvh_count_buffers(touched.data_ptr(), per_query.data_ptr()) == 0
    assert lib.bvh_visit_counts(totals) == 0
    out = launch()
    assert lib.bvh_visit_counts(totals) == 0
    assert lib.bvh_count_buffers(None, None) == 0
    return out, touched.bool(), per_query.long(), list(totals)


def test_emulated_count_build_marks_what_the_queries_read(libs):
    """The instrumented build (-DBVH_COUNT_VISITS) that chip_smoke.py's
    bounds read: its results are the plain versions'; each query's tests
    add up to the totals; it marks a box only with its sibling's, below a
    node whose children it read, and never the root's; it reads a face id
    only at a leaf it tested, and at the leaf of every first hit."""
    lib = libs["count"]
    tris = MESHES[0][1]
    tree = bvh.build(tris)
    n = tree.n
    o, d = adversarial_rays(tris, 200, 3)
    p = near_points(tris, 300, 3)
    direction = torch.from_numpy(mq._PARITY_DIR)
    runs = {
        "first": (o.shape[0], lambda: bvh.run_ray(lib, tree, o, d, False)),
        "parity": (p.shape[0], lambda: bvh.run_ray(
            lib, tree, p, direction.reshape(1, 3), True)),
        "closest": (p.shape[0], lambda: bvh.run_closest(lib, tree, p)[0])}
    want_t, want_id = mq.first_hits_plain(tris, o, d)
    for name, (queries, launch) in runs.items():
        out, marks, per_query, totals = _counted(lib, tree, queries, launch)
        if name == "first":
            assert torch.equal(_bits(out[0]), _bits(want_t))
            assert torch.equal(out[1].long(), want_id)
        elif name == "parity":
            assert torch.equal(out[1].long(),
                               mq.crossings_plain(tris, p, direction))
        else:
            assert torch.equal(_bits(out), _bits(mq.min_dist2_plain(tris, p)))
        assert per_query.sum(dim=0).tolist() == totals
        assert (per_query[:, 0] % 2 == 0).all() and (per_query[:, 0] > 0).all()
        box, expanded, face_id = marks
        assert not box[0] and expanded[0]
        ch = tree.children.long()
        assert torch.equal(box[ch[:, 0]], box[ch[:, 1]])
        assert torch.equal(box[ch].any(dim=1), expanded[:n - 1])
        assert (box[1:] | ~expanded[1:]).all()
        assert int(expanded[n - 1:].sum()) <= totals[1]
        # a face id is read at each triangle hit on the way, the first
        # hits' among them
        assert not face_id[:n - 1].any()
        assert (expanded | ~face_id).all()
        leaf_of = torch.empty(n, dtype=torch.long)
        leaf_of[tree.order.long()] = torch.arange(n)
        if name == "first":
            assert face_id[n - 1 + leaf_of[want_id[want_id >= 0]]].all()
        else:
            assert not face_id.any()


CLOSEST_MESHES = [("icosphere2", _tris(icosphere(2))), MESHES[2]]


@pytest.mark.parametrize("name,tris", CLOSEST_MESHES,
                         ids=[m for m, _ in CLOSEST_MESHES])
def test_emulated_closest_two_passes_bitwise_plain(libs, name, tris):
    """The closest-point query's two passes, and its first design, bitwise
    the plain tiles on points from the centre of the mesh's box, on
    vertices, on edge midpoints, on duplicates and with a NaN point: with
    the design's budget (the centre points through the warp pass on the
    closed icosphere) and with a budget of 2 box tests (every point
    through it), and with each step of the design taken out."""
    tree = bvh.build(tris)
    sets = bvh_cases.closest_sets(tris, 24, 7)
    p = torch.cat(list(sets.values()))
    want = mq.min_dist2_plain(tris, p)
    assert torch.isnan(want).sum() == 1 and (want == 0).sum() >= 24
    queued = {}
    for build in ("design", "budget2", "ablated", "first"):
        d2, queued[build] = bvh.run_closest(libs[build], tree, p)
        assert _same_bits(d2, want), build
    assert queued["budget2"] == queued["ablated"] == p.shape[0]
    assert queued["first"] == 0
    d2, centre_queued = bvh.run_closest(libs["design"], tree, sets["centre"])
    assert _same_bits(d2, mq.min_dist2_plain(tris, sets["centre"]))
    if name == "icosphere2":
        assert centre_queued == sets["centre"].shape[0]
        assert queued["design"] >= centre_queued


def _small_meshes():
    """Meshes of 1, 2 and 3 triangles (shared edges, a NaN coordinate in
    the third's), and one whose tree spans three blocks of leaves."""
    tri = [[0.0, 0.0, 0.5], [1.0, 0.0, 0.5], [0.0, 1.0, 0.5]]
    yield "one", torch.tensor([tri])
    yield "two", torch.tensor([tri, [[1.0, 0.0, 0.5], [1.0, 1.0, 0.2],
                                     [0.0, 1.0, 0.5]]])
    yield "three", torch.tensor([tri, [[1.0, 0.0, 0.5], [1.0, 1.0, 0.2],
                                       [0.0, 1.0, 0.5]],
                                 [[2.0, 0.0, 0.0], [2.0, float("nan"), 1.0],
                                  [3.0, 1.0, 0.0]]])
    yield MESHES[1]


SMALL_MESHES = list(_small_meshes())
RAY_CASES = list(_ray_cases())


@pytest.mark.parametrize("name,tris", SMALL_MESHES,
                         ids=[m for m, _ in SMALL_MESHES])
def test_emulated_refit_designs_bitwise_plain(libs, name, tris):
    """The refit with the block's shared levels, without them (device-scope
    counts only), without its records and in its first design (fences),
    bitwise ``refit_plain``, NaN coordinates and all; the node records and
    padded triangles of the first two bitwise ``records_plain`` and the
    triangles."""
    tree = bvh.build(tris)
    for build in ("design", "budget2", "ablated", "first"):
        boxes, records, padded = bvh.run_refit(
            libs[build], tree.tris, tree.children, tree.parents, tree.far,
            tree.pad)
        assert torch.equal(_bits(boxes), _bits(tree.boxes)), build
        if build in ("design", "budget2"):
            assert torch.equal(_bits(records), _bits(tree.records)), build
            assert torch.equal(_bits(padded), _bits(tree.tris_padded)), build
    if name == "three":
        assert torch.isnan(tree.boxes).any()


def test_emulated_count_design_adds_both_passes(libs):
    """The design's instrumented build (-DBVH_COUNT_DESIGN): each point's
    tests are its pass 1's plus its warp's, and add up to the totals; the
    centre points make more tests in all than one thread a point makes for
    them (the warp's subtrees start without a best of their own), and the
    results are the plain tiles'."""
    tris = CLOSEST_MESHES[0][1]
    tree = bvh.build(tris)
    p = bvh_cases.centre_points(tris, 32, 8)
    want = mq.min_dist2_plain(tris, p)
    runs = {}
    for build in ("count", "count_design"):
        lib = libs[build]
        out, _, per_query, totals = _counted(
            lib, tree, p.shape[0], lambda: bvh.run_closest(lib, tree, p))
        assert _same_bits(out[0], want)
        assert per_query.sum(dim=0).tolist() == totals
        assert (per_query[:, 0] % 2 == 0).all() and (per_query[:, 0] > 0).all()
        runs[build] = (out[1], totals)
    assert runs["count"][0] == 0 and runs["count_design"][0] == p.shape[0]
    assert runs["count_design"][1][0] >= runs["count"][1][0]


# --- MeshQuery against the JAX package ------------------------------------------

def _mc_mesh():
    """Marching cubes of sphere-small's checkpoint at 32 (the port's, on the
    CPU), in the canvas' units."""
    from test_torch_eval import _nets
    from tropical_torch.utils.marching_cubes import run_marching_cubes

    _, tnet = _nets()
    return run_marching_cubes(tnet, 32, 1.2, R=0.8)


@pytest.fixture(scope="module", params=["icosphere3", "mc32"])
def mesh(request):
    return icosphere(3) if request.param == "icosphere3" else _mc_mesh()


def test_mesh_query_against_jax(mesh):
    v = np.asarray(mesh.vertices, np.float32)
    f = np.asarray(mesh.faces, np.int64)
    ours = mq.MeshQuery(v, f, "cpu")
    host = bvh_host.HostBVH(v, f)
    jax_mq = JaxMeshQuery(v, f)
    o, d = adversarial_rays(ours.tris, RANDOM_RAYS, 3)
    pos, fid, t = ours.ray_trace(o, d)
    fid, t = fid.numpy(), t.numpy()
    # On the rays aimed at vertices and edges (after the first RANDOM_RAYS) both JAX
    # tracers may miss what the port's plain tiles hit: XLA contracts
    # Moller-Trumbore into FMAs (u or v rounds below 0), and HostBVH's slab
    # test culls a box the ray only touches.  So both are held on the random
    # rays, where a hit on a shared edge may still go to either face.
    _, fid_h, t_h = host.ray_trace(o.numpy(), d.numpy())
    _, fid_j, t_j = jax_mq.ray_trace(o.numpy(), d.numpy())
    for want_id, want_t in ((fid_h, t_h), (fid_j, t_j)):
        np.testing.assert_array_equal(fid[:RANDOM_RAYS] < 0,
                                      want_id[:RANDOM_RAYS] < 0)
        np.testing.assert_allclose(t[:RANDOM_RAYS], want_t[:RANDOM_RAYS],
                                   rtol=0, atol=1e-6)
    for want in (fid_h, fid_j):
        assert (fid == want)[:RANDOM_RAYS].mean() >= 0.998
    assert (fid >= 0).any() and (fid < 0).any()
    np.testing.assert_array_equal(pos.numpy()[fid < 0], o.numpy()[fid < 0])

    rng = np.random.default_rng(4)
    p = np.concatenate([v[rng.integers(0, len(v), 300)]
                        + rng.normal(scale=0.05, size=(300, 3)),
                        rng.uniform(-1.2, 1.2, (200, 3))]).astype(np.float32)
    sd = ours.signed_distance(torch.from_numpy(p)).numpy()
    want = jax_mq.signed_distance(p)
    np.testing.assert_allclose(np.abs(sd), np.abs(want), rtol=0,
                               atol=DIST_ATOL)
    np.testing.assert_array_equal(np.sign(sd), np.sign(want))
    np.testing.assert_allclose(np.abs(sd), host.unsigned_distance(p),
                               rtol=0, atol=DIST_ATOL)


@pytest.mark.parametrize("faces", [0, 1])
def test_empty_and_one_triangle_meshes(faces):
    """No triangle: misses and infinities, as the JAX package's HostBVH
    (tests/test_bvh_host.py); one: a tree of one leaf and no internal
    node."""
    v = np.array([[0, 0, 0.5], [1, 0, 0.5], [0, 1, 0.5]], np.float32)
    f = np.zeros((0, 3), np.int64) if faces == 0 else np.array([[0, 1, 2]])
    q = mq.MeshQuery(v, f, "cpu")
    o = torch.zeros((3, 3))
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [0.3, 0.3, 0.53]])
    d = d / d.norm(dim=1, keepdim=True)
    pos, fid, t = q.ray_trace(o, d)
    p = torch.tensor([[0.2, 0.2, 0.0], [0.2, 0.2, 1.0]])
    sd = q.signed_distance(p)
    if faces == 0:
        assert fid.tolist() == [-1] * 3 and t.tolist() == [0.0] * 3
        assert torch.equal(pos, o)
        assert sd.tolist() == [-np.inf, -np.inf]
        tree = bvh.build(q.tris)
        assert tree.n == 0 and tree.boxes.shape == (0, 6)
    else:
        assert fid.tolist() == [0, -1, 0]
        assert sd.tolist() == [-0.5, -0.5]
        host = bvh_host.HostBVH(v, f)
        np.testing.assert_array_equal(host.ray_trace(o.numpy(),
                                                     d.numpy())[1], [0, -1, 0])


def test_tensors_off_the_cpu_never_take_the_plain_tiles():
    """A mesh anywhere but on the CPU goes to the kernels' checks, which
    raise off the card; nothing falls back quietly.  (Meta tensors stand
    in for a device here.)"""
    v = np.asarray(icosphere(1).vertices, np.float32)
    f = np.asarray(icosphere(1).faces, np.int64)
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        mq.MeshQuery(v, f, "meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        bvh.build(torch.zeros((4, 3, 3), device="meta"))
    tree = bvh.build(mq.MeshQuery(v, f, "cpu").tris)  # the plain build
    for call in (lambda: bvh.first_hits(tree, torch.zeros(2, 3),
                                        torch.ones(2, 3)),
                 lambda: bvh.crossings(tree, torch.zeros(2, 3),
                                       torch.ones(3)),
                 lambda: bvh.min_dist2(tree, torch.zeros(2, 3))):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    assert dict(LAUNCHES) == before
