"""A linear BVH over a triangle mesh, built and queried on the card.

Counterpart of ``tropical/csrc/bvh.cpp`` and ``tropical/utils/bvh_host.py``
(the JAX package's host BVH), and of the brute-force tiles it stands in for.
The kernels are ``csrc/bvh.cu`` (its header comment gives the design):

- ``bvh_hierarchy``: Karras's hierarchy over the sorted keys, one thread an
  internal node, each node whose range passes 256 keys finished by a warp
  in a second pass (a queue in the scratch ``launch_hierarchy`` takes);
- ``bvh_refit``: the boxes, bottom-up with an arrival count a node, in
  shared memory for the nodes within a block's leaves; and for the
  queries each internal node's 64-byte record (both children's boxes and
  ids) and the triangles padded to 48 bytes;
- ``bvh_ray``: first hits (``first_hits``), or crossing counts
  (``crossings``, the parity ray of a signed distance), one thread a ray
  reading the node records;
- ``bvh_closest``: the least squared distance to a triangle
  (``min_dist2``): a thread a point on a budget, then a block of warps for
  each point the budget did not finish.

The build's plain versions live here (``hierarchy_plain``, a vectorised
Karras build whose common-prefix length is a 6-step bit search on int64,
``refit_plain``, level by level, and ``records_plain``); the queries'
plain versions are the brute-force tiles of
:mod:`tropical_torch.ops.mesh_queries`, which the kernels are bitwise
equal to on every mesh ``chip_smoke.py`` traces.
``build`` takes the plain versions for a mesh on the CPU and the kernels
for any other, which must be on a CUDA device; the queries take only a
tree built on the card.  Each kernel has a raw launch (``launch_*``, into
outputs the caller allocates) and, for the build and the queries, a
checking wrapper (``run_*``) that allocates them and raises on a stack
(or pass 2's queue) overflow.

The Morton keys are made and sorted in plain torch (``morton_keys``): that
orders the leaves, and is glue, not the port of a kernel.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import torch

from tropical_torch.ops import cuda_build, launches

# bits of the Morton code an axis
MORTON_BITS = 10
# each leaf box is widened by this fraction of the mesh's largest coordinate
# (or of 1, if that is larger): the slack that keeps culling conservative
# (csrc/bvh.cu)
PAD = 2.0 ** -16

_BOUND = set()


@dataclass
class Bvh:
    """A tree over ``n`` triangles.  Internal nodes are 0 .. n-2 (the root
    is 0), leaf k is node n - 1 + k; a mesh of one triangle is its root
    leaf."""

    tris: torch.Tensor      # [n, 9] f32, the triangles in leaf order
    order: torch.Tensor     # [n] int32, the face id of each leaf
    children: torch.Tensor  # [n - 1, 2] int32
    parents: torch.Tensor   # [2n - 1] int32, -1 at the root
    far: torch.Tensor       # [n - 1] int32, the far end j of internal node
                            # i's leaves [min(i, j), max(i, j)]
    boxes: torch.Tensor     # [2n - 1, 6] f32, lo xyz then hi xyz
    records: torch.Tensor   # [n - 1, 16] f32, node i's children's boxes
                            # (left, right), their ids' int32 bits, 0, 0
    tris_padded: torch.Tensor  # [n, 12] f32, tris with three zeros a row
    pad: float

    @property
    def n(self) -> int:
        return self.tris.shape[0]


def _spread(v: torch.Tensor) -> torch.Tensor:
    """The 10 low bits of ``v`` (int64) moved to every third bit."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def morton_keys(tris: torch.Tensor) -> torch.Tensor:
    """Sorted int64 keys ``code << 32 | triangle id`` of ``tris`` [n, 3, 3]:
    ``code`` interleaves 10 bits an axis of the centroid's cell in the
    centroids' box.  The ids make every key unique, so the order is the
    same on every run."""
    return torch.sort(morton_codes(tris)).values


def morton_codes(tris: torch.Tensor) -> torch.Tensor:
    """``morton_keys`` before the sort, in triangle order."""
    c = tris[:, 0] + tris[:, 1] + tris[:, 2]  # 3x the centroid: no division
    lo = c.amin(dim=0)
    ext = (c.amax(dim=0) - lo).clamp_min(1e-30)
    cell = ((c - lo) / ext * (1 << MORTON_BITS)).floor()
    cell = cell.clamp(0, (1 << MORTON_BITS) - 1).to(torch.int64)
    code = ((_spread(cell[:, 0]) << 2) | (_spread(cell[:, 1]) << 1)
            | _spread(cell[:, 2]))
    ids = torch.arange(tris.shape[0], dtype=torch.int64, device=tris.device)
    return (code << 32) | ids


def box_pad(tris: torch.Tensor) -> float:
    """The margin a face of every leaf box (``PAD`` of the largest
    coordinate, at least ``PAD``), an f32 value."""
    return float(tris.abs().amax().clamp_min(1.0) * PAD)


# ---- plain versions of the build ---------------------------------------------

def clz64(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of each non-negative int64 (64 for 0): the highest set
    bit found in six halving steps."""
    high = torch.zeros_like(x)
    y = x
    for s in (32, 16, 8, 4, 2, 1):
        up = (y >> s) != 0
        y = torch.where(up, y >> s, y)
        high = high + up * s
    return torch.where(x == 0, 64, 63 - high)


def _delta(keys: torch.Tensor, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """The common-prefix length of keys i and j, -1 where j is out of range."""
    n = keys.shape[0]
    valid = (j >= 0) & (j < n)
    return torch.where(valid, clz64(keys[i] ^ keys[j.clamp(0, n - 1)]), -1)


def hierarchy_plain(keys: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(children [n-1, 2] int32, parents [2n-1] int32, far [n-1] int32) of
    Karras's hierarchy over ``n`` sorted unique int64 keys, every internal
    node at once: the same searches as ``csrc/bvh.cu``'s, each step of a
    loop taken by all nodes, a node whose own loop has ended masked out.
    ``far[i]`` is j, the other end of node i's leaves."""
    n = keys.shape[0]
    dev = keys.device
    parents = torch.full((max(2 * n - 1, 0),), -1, dtype=torch.int32,
                         device=dev)
    if n < 2:
        return (torch.zeros((0, 2), dtype=torch.int32, device=dev), parents,
                torch.zeros(0, dtype=torch.int32, device=dev))
    i = torch.arange(n - 1, dtype=torch.int64, device=dev)
    d = torch.where(_delta(keys, i, i + 1) - _delta(keys, i, i - 1) > 0, 1, -1)
    dmin = _delta(keys, i, i - d)
    lmax = torch.full_like(i, 2)
    while True:
        grow = _delta(keys, i, i + lmax * d) > dmin
        if not bool(grow.any()):
            break
        lmax = torch.where(grow, lmax * 2, lmax)
    l = torch.zeros_like(i)
    t = int(lmax.max()) // 2
    while t >= 1:
        step = (t < lmax) & (_delta(keys, i, i + (l + t) * d) > dmin)
        l = l + step * t
        t //= 2
    j = i + l * d
    dnode = _delta(keys, i, j)
    s = torch.zeros_like(i)
    active = torch.ones_like(i, dtype=torch.bool)
    div = 2
    while bool(active.any()):
        t = (l + div - 1) // div
        step = active & (_delta(keys, i, i + (s + t) * d) > dnode)
        s = s + step * t
        active = active & (t > 1)
        div *= 2
    split = i + s * d + torch.where(d < 0, -1, 0)
    left = torch.where(torch.minimum(i, j) == split, n - 1 + split, split)
    right = torch.where(torch.maximum(i, j) == split + 1, n + split, split + 1)
    children = torch.stack([left, right], dim=1).to(torch.int32)
    parents[left] = i.to(torch.int32)
    parents[right] = i.to(torch.int32)
    return children, parents, j.to(torch.int32)


def records_plain(children: torch.Tensor, boxes: torch.Tensor
                  ) -> torch.Tensor:
    """The [n-1, 16] f32 node records of a tree: each internal node's left
    and right child's boxes, then the two children's int32 ids as their
    bits, then two zeros (the 64 bytes the closest-point query loads a
    visit)."""
    ids = children.contiguous().view(torch.float32)
    ch = children.long()
    return torch.cat([boxes[ch[:, 0]], boxes[ch[:, 1]], ids,
                      torch.zeros_like(ids)], dim=1)


def refit_plain(tris: torch.Tensor, children: torch.Tensor, pad: float
                ) -> torch.Tensor:
    """Boxes [2n-1, 6] f32 of the tree over ``tris`` [n, 9] (leaf order):
    each leaf's from its vertices, widened by ``pad`` a face, then each
    internal node's from its children's, the deepest level first."""
    n = tris.shape[0]
    v = tris.view(n, 3, 3)
    boxes = torch.empty((2 * n - 1, 6), dtype=torch.float32, device=tris.device)
    boxes[n - 1:, :3] = v.amin(dim=1) - pad
    boxes[n - 1:, 3:] = v.amax(dim=1) + pad
    levels = []
    level = torch.zeros(1 if n > 1 else 0, dtype=torch.int64, device=tris.device)
    while level.numel():
        levels.append(level)
        below = children[level].reshape(-1).to(torch.int64)
        level = below[below < n - 1]
    for level in reversed(levels):
        left = boxes[children[level, 0].to(torch.int64)]
        right = boxes[children[level, 1].to(torch.int64)]
        boxes[level, :3] = torch.minimum(left[:, :3], right[:, :3])
        boxes[level, 3:] = torch.maximum(left[:, 3:], right[:, 3:])
    return boxes


# ---- the kernels --------------------------------------------------------------

def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the library's C signatures, once a library."""
    if id(lib) not in _BOUND:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.bvh_hierarchy_launch.argtypes = [p, i, p, p, p, p, p]
        lib.bvh_refit_launch.argtypes = [p, p, p, p, i, f, p, p, p, p, p]
        lib.bvh_ray_launch.argtypes = [p, p, p, p, p, p, i, p, p, i, i, i, p,
                                       p, p, p]
        lib.bvh_closest_launch.argtypes = [p, p, p, p, p, i, p, i, p, p, p, p]
        for fn in (lib.bvh_hierarchy_launch, lib.bvh_refit_launch,
                   lib.bvh_ray_launch, lib.bvh_closest_launch):
            fn.restype = ctypes.c_int
        _BOUND.add(id(lib))
    return lib


def _stream(dev: torch.device):
    return torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" \
        else None


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def launch_hierarchy(lib: ctypes.CDLL, keys: torch.Tensor,
                     children: torch.Tensor, parents: torch.Tensor,
                     far: torch.Tensor, queue: torch.Tensor) -> None:
    """One ``bvh_hierarchy`` call (its two passes) over n >= 2 keys into
    ``children`` [n-1, 2], ``parents`` [2n-1] (the root's -1 set by the
    caller) and ``far`` [n-1].  ``queue`` [n] int32 is scratch; after a
    call [0] holds the number of nodes pass 1 gave pass 2 (the first design
    leaves it as it was)."""
    _raise_on(_bind(lib).bvh_hierarchy_launch(
        keys.data_ptr(), keys.shape[0], children.data_ptr(),
        parents.data_ptr(), far.data_ptr(), queue.data_ptr(),
        _stream(keys.device)), "bvh_hierarchy")


def run_hierarchy(lib: ctypes.CDLL, keys: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``hierarchy_plain`` by the kernel in ``lib`` (n >= 2 keys)."""
    n = keys.shape[0]
    children = torch.empty((n - 1, 2), dtype=torch.int32, device=keys.device)
    parents = torch.full((2 * n - 1,), -1, dtype=torch.int32,
                         device=keys.device)
    far = torch.empty(n - 1, dtype=torch.int32, device=keys.device)
    queue = torch.empty(n, dtype=torch.int32, device=keys.device)
    launch_hierarchy(lib, keys, children, parents, far, queue)
    return children, parents, far


def launch_refit(lib: ctypes.CDLL, tris: torch.Tensor, children: torch.Tensor,
                 parents: torch.Tensor, far: torch.Tensor, pad: float,
                 arrivals: torch.Tensor, boxes: torch.Tensor,
                 records: torch.Tensor, tris_padded: torch.Tensor) -> None:
    """One ``bvh_refit`` launch over n >= 1 triangles into ``boxes`` [2n-1,
    6], ``records`` [n-1, 16] and ``tris_padded`` [n, 12] (the last two
    left as they were by the first design, -DBVH_REFIT_FENCES), with
    ``arrivals`` [max(n-1, 1)] zeroed by the caller."""
    _raise_on(_bind(lib).bvh_refit_launch(
        tris.data_ptr(), parents.data_ptr(), children.data_ptr(),
        far.data_ptr(), tris.shape[0], pad, arrivals.data_ptr(),
        boxes.data_ptr(), records.data_ptr(), tris_padded.data_ptr(),
        _stream(tris.device)), "bvh_refit")


def run_refit(lib: ctypes.CDLL, tris: torch.Tensor, children: torch.Tensor,
              parents: torch.Tensor, far: torch.Tensor, pad: float
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(``refit_plain``, ``records_plain``, ``tris`` padded) by the kernel
    in ``lib`` (n >= 1 triangles)."""
    n, dev = tris.shape[0], tris.device
    arrivals = torch.zeros(max(n - 1, 1), dtype=torch.int32, device=dev)
    boxes = torch.empty((2 * n - 1, 6), dtype=torch.float32, device=dev)
    records = torch.empty((n - 1, 16), dtype=torch.float32, device=dev)
    tris_padded = torch.empty((n, 12), dtype=torch.float32, device=dev)
    launch_refit(lib, tris, children, parents, far, pad, arrivals, boxes,
                 records, tris_padded)
    return boxes, records, tris_padded


def _check(t: torch.Tensor, name: str, dtype=torch.float32, cols=3) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != 2 or t.shape[1] != cols:
        raise ValueError(f"{name} must have shape [N, {cols}], got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.shape[0] >= 2 ** 31:
        raise ValueError(f"{name} has too many rows for int32 indices")


def build(tris: torch.Tensor) -> Bvh:
    """The tree over ``tris`` [n, 3, 3] f32: the plain versions for a mesh
    on the CPU, the kernels for one on the card (``bvh_hierarchy`` for n >=
    2, ``bvh_refit`` for n >= 1; nothing for an empty mesh)."""
    n, dev = tris.shape[0], tris.device
    flat = tris.reshape(n, 9)
    if dev.type != "cpu":
        _check(flat, "tris", cols=9)
    if n == 0:
        none = torch.empty(0, dtype=torch.int32, device=dev)
        return Bvh(flat, none, torch.empty((0, 2), dtype=torch.int32,
                                           device=dev), none, none,
                   torch.empty((0, 6), dtype=torch.float32, device=dev),
                   torch.empty((0, 16), dtype=torch.float32, device=dev),
                   torch.empty((0, 12), dtype=torch.float32, device=dev), PAD)
    keys = morton_keys(tris)
    order = (keys & 0xFFFFFFFF).to(torch.int32)
    leaf_tris = flat[order.to(torch.int64)].contiguous()
    pad = box_pad(tris)
    if dev.type == "cpu":
        children, parents, far = hierarchy_plain(keys)
        boxes = refit_plain(leaf_tris, children, pad)
        return Bvh(leaf_tris, order, children, parents, far, boxes,
                   records_plain(children, boxes),
                   torch.nn.functional.pad(leaf_tris, (0, 3)), pad)
    lib = cuda_build.load("bvh")
    if n >= 2:
        children, parents, far = run_hierarchy(lib, keys)
        launches.record("bvh_hierarchy", (n,))
    else:  # the root is the one leaf: no internal node
        children, parents, far = hierarchy_plain(keys)
    boxes, records, tris_padded = run_refit(lib, leaf_tris, children, parents,
                                            far, pad)
    launches.record("bvh_refit", (n,))
    return Bvh(leaf_tris, order, children, parents, far, boxes, records,
               tris_padded, pad)


def launch_ray(lib: ctypes.CDLL, bvh: Bvh, o: torch.Tensor, d: torch.Tensor,
               count: bool, t: torch.Tensor, ids: torch.Tensor,
               overflow: torch.Tensor) -> None:
    """One ``bvh_ray`` launch on n >= 1 triangles and checked rays ``o``
    [N, 3] (``d`` [N, 3], or one direction [1, 3]) into ``t`` [N] f32 and
    ``ids`` [N] int32 (the crossings in count mode); sets ``overflow`` [1]
    int32, zeroed by the caller, if a stack overflowed."""
    rays = o.shape[0]
    _raise_on(_bind(lib).bvh_ray_launch(
        bvh.boxes.data_ptr(), bvh.children.data_ptr(), bvh.tris.data_ptr(),
        bvh.records.data_ptr(), bvh.tris_padded.data_ptr(),
        bvh.order.data_ptr(), bvh.n, o.data_ptr(), d.data_ptr(),
        3 if d.shape[0] == rays else 0, rays, int(count), t.data_ptr(),
        ids.data_ptr(), overflow.data_ptr(), _stream(o.device)), "bvh_ray")


def launch_closest(lib: ctypes.CDLL, bvh: Bvh, p: torch.Tensor,
                   d2: torch.Tensor, state: torch.Tensor,
                   queue: torch.Tensor) -> None:
    """One ``bvh_closest`` call (its two passes) on n >= 1 triangles and
    checked points ``p`` [N, 3] into ``d2`` [N] f32.  ``state`` [2] int32:
    [0], zeroed by the caller, set to 1 if a stack overflowed (2 the
    queue); [1] the number of points pass 1 queued for pass 2, zeroed by the
    call.  ``queue`` [N, 2] int32 is scratch."""
    _raise_on(_bind(lib).bvh_closest_launch(
        bvh.boxes.data_ptr(), bvh.children.data_ptr(), bvh.tris.data_ptr(),
        bvh.records.data_ptr(), bvh.tris_padded.data_ptr(), bvh.n,
        p.data_ptr(), p.shape[0], d2.data_ptr(), state.data_ptr(),
        queue.data_ptr(), _stream(p.device)), "bvh_closest")


def _raise_on_overflow(flag: int, name: str) -> None:
    if flag == 2:
        raise RuntimeError(f"{name}: the queue of pass 2 overflowed")
    if flag:
        raise RuntimeError(f"{name}: a traversal stack overflowed")


def run_ray(lib: ctypes.CDLL, bvh: Bvh, o: torch.Tensor, d: torch.Tensor,
            count: bool):
    """(t, id int32) of one ``launch_ray``, or the crossings in ``id``.
    Raises if a stack overflowed."""
    t = torch.empty(o.shape[0], dtype=torch.float32, device=o.device)
    ids = torch.empty(o.shape[0], dtype=torch.int32, device=o.device)
    overflow = torch.zeros(1, dtype=torch.int32, device=o.device)
    launch_ray(lib, bvh, o, d, count, t, ids, overflow)
    _raise_on_overflow(int(overflow), "bvh_ray")
    return t, ids


def run_closest(lib: ctypes.CDLL, bvh: Bvh, p: torch.Tensor
                ) -> Tuple[torch.Tensor, int]:
    """(the squared distances, the points that took pass 2) of one
    ``launch_closest``.  Raises if a stack or the queue overflowed."""
    d2 = torch.empty(p.shape[0], dtype=torch.float32, device=p.device)
    state = torch.zeros(2, dtype=torch.int32, device=p.device)
    queue = torch.empty((p.shape[0], 2), dtype=torch.int32, device=p.device)
    launch_closest(lib, bvh, p, d2, state, queue)
    flag, queued = state.tolist()
    _raise_on_overflow(flag, "bvh_closest")
    return d2, queued


def _query_rows(bvh: Bvh, x: torch.Tensor, name: str) -> None:
    _check(x, name)
    if x.device != bvh.tris.device:
        raise ValueError(f"{name} on {x.device} but the tree on "
                         f"{bvh.tris.device}")


def first_hits(bvh: Bvh, rays_o: torch.Tensor, rays_d: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t [N] f32, face id [N] int64) of each ray's first hit, +inf and -1
    on a miss: ``mesh_queries.first_hits_plain`` by the kernel."""
    _query_rows(bvh, rays_o, "rays_o")
    _query_rows(bvh, rays_d, "rays_d")
    n, dev = rays_o.shape[0], rays_o.device
    if rays_d.shape[0] != n:
        raise ValueError(f"{n} origins but {rays_d.shape[0]} directions")
    if bvh.n == 0 or n == 0:
        return (torch.full((n,), torch.inf, device=dev),
                torch.full((n,), -1, dtype=torch.int64, device=dev))
    t, fid = run_ray(cuda_build.load("bvh"), bvh, rays_o, rays_d, False)
    launches.record("bvh_ray", (n, bvh.n))
    return t, fid.to(torch.int64)


def crossings(bvh: Bvh, points: torch.Tensor, direction: torch.Tensor
              ) -> torch.Tensor:
    """How many triangles [N] int64 the ray from each point along the one
    ``direction`` [3] crosses: ``mesh_queries.crossings_plain`` by the
    kernel."""
    _query_rows(bvh, points, "points")
    d = direction.reshape(1, 3)
    _query_rows(bvh, d, "direction")
    n = points.shape[0]
    if bvh.n == 0 or n == 0:
        return torch.zeros(n, dtype=torch.int64, device=points.device)
    _, hits = run_ray(cuda_build.load("bvh"), bvh, points, d, True)
    launches.record("bvh_ray", (n, bvh.n))
    return hits.to(torch.int64)


def min_dist2(bvh: Bvh, points: torch.Tensor) -> torch.Tensor:
    """The least squared distance [N] f32 from each point to a triangle
    (+inf for an empty mesh): ``mesh_queries.min_dist2_plain`` by the
    kernel."""
    _query_rows(bvh, points, "points")
    n = points.shape[0]
    if bvh.n == 0 or n == 0:
        return torch.full((n,), torch.inf, device=points.device)
    d2, _ = run_closest(cuda_build.load("bvh"), bvh, points)
    launches.record("bvh_closest", (n, bvh.n))
    return d2
