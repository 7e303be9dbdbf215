// A linear BVH over a triangle mesh, built and queried on the card: the
// counterpart of tropical/csrc/bvh.cpp (the JAX package's host BVH, reached
// through tropical/utils/bvh_host.py), and of the brute-force XLA programs
// it stands in for (tropical/ops/mesh_queries.py: _ray_trace_scan :170,
// _parity_scan :145, _min_dist2_scan :123, with _ray_tri_t :84 and
// _closest_dist2 :27 the tests of one pair).
//
// Build (Karras 2012, "Maximizing parallelism in the construction of BVHs,
// octrees, and k-d trees"), one triangle a leaf.  The leaves are sorted by
// 64-bit keys (code << 32 | triangle id, made and sorted in torch by
// ops/bvh.py), so every key is unique and the tree is the same on every run.
// Node numbering: internal nodes 0 .. n-2 (the root is 0), leaf k is node
// n - 1 + k; a mesh of one triangle is its root leaf.  Internal node i
// covers the leaves [min(i, j), max(i, j)], j its far end.
//   - bvh_hierarchy: each internal node's range's direction from the sign
//     of delta, its far end j by an exponential then a binary search, the
//     split by a binary search on __clzll of the XOR of keys; writes the
//     children, the parents and j.  In two passes: pass 1, one thread a
//     node, reads the block's keys and 2^BVH_HIERARCHY_WARP_LOG (256) on
//     each side from a window in shared memory and counts in 32 bits (the
//     split's ceil(l / 2^m) a shift); a node whose exponential search
//     reaches 256 keys joins a queue in device memory instead, and pass 2
//     gives it a warp, which probes 32 keys a round and takes the last that
//     holds by __ballot_sync (the far end, then the split: the largest m
//     whose key shares more than dmin, or dnode, leading bits with key i,
//     one place whatever the search).  The launch zeroes the queue's
//     length.  -DBVH_HIERARCHY_ONE_THREAD builds the first design (one
//     kernel, one thread a node, every search on it, in 64 bits with a
//     division a step of the split).
//   - bvh_refit: one thread a leaf.  The leaf box from its triangle's
//     vertices, widened by `pad` a face; then up the tree, with an arrival
//     count on each internal node: the second thread to arrive merges the
//     two child boxes.  A node whose leaves all lie in the block's own
//     (kBuildThreads consecutive leaves) counts its arrivals in shared
//     memory and keeps its box there too, with block-scope atomics; only a
//     node across a block boundary counts in device memory, with one
//     device-scope acquire-release fetch_add a level; the next level's
//     read-only loads (children, far end, parent) are issued before it.  The
//     merging thread also writes the node's record (both children's boxes
//     and ids, for the closest-point query) once its next count is made, so
//     that the count's release does not wait for it; a leaf's thread writes
//     its triangle padded to 48 bytes.  Min and max are exact (and propagate
//     a NaN, as the plain version's do), so the boxes are bitwise the same
//     in any order of arrival.
//     -DBVH_REFIT_FENCES builds the first design (every level in device
//     memory, a __threadfence on each side of the atomicAdd, the children
//     and both boxes loaded after it, no records); -DBVH_REFIT_DEVICE_ONLY
//     the acquire-release climb without the block's shared levels;
//     -DBVH_REFIT_NO_RECORDS the design without the records.
//
// Queries: a stack of at most kStack far children, the nearer child first.
//   - bvh_ray: the first hit of each ray, the lexicographic least (t, face
//     id) over the triangles that Moller-Trumbore hits (the plain tiles'
//     `min` takes the first, lowest, id on an equal t); or, in count mode,
//     how many triangles the ray crosses (the parity ray of a signed
//     distance), which visits every box the ray meets.  A visit reads the
//     node's 64-byte record (four 16-byte loads) or the leaf's padded
//     triangle (three); the stack's top entry is held in registers, the
//     rest in local memory; the slab test tells a NaN end by the ends' sum.
//     One lane a ray.  For the ablation, -DBVH_RAY_LANES=2 or 4 walks a
//     ray on that many lanes: they split at the first nodes whose both
//     boxes the ray enters, then share the least (t bits, id) by shuffles
//     every kSyncVisits visits (first hits) or sum their subtrees'
//     crossings (count).  -DBVH_RAY_ONE_THREAD builds the first design
//     (one thread a ray, children then boxes, its whole stack in local
//     memory).
//   - bvh_closest: the least squared distance from each point to a triangle
//     (Ericson's closest point), in two passes.  Pass 1, one thread a
//     point, stops after a budget of box tests (BVH_CLOSEST_BUDGET, 256); a
//     point not done by then joins a queue in device memory with its best
//     so far, an upper bound of its answer.  Pass 2 gives each queued point
//     a block of kPointWarps warps: its first warp expands the tree
//     breadth-first from the root (culled by that bound) until the frontier
//     holds a subtree for every lane of the block; each lane walks one or
//     two of them depth-first with its own stack; every kSyncVisits visits
//     a warp shares its best by __reduce_min_sync on its bits (a
//     non-negative float orders as its bits; a NaN, whose bits order above
//     +inf, is voted on apart and wins) and, across the block, by atomicMin
//     in shared memory, and its lanes with no subtree left take the bottom
//     (largest) subtree of a lane that holds one.  A visit reads a node's
//     64-byte record (four 16-byte loads: both children's boxes and ids)
//     or a leaf's triangle padded to 48 bytes (three), and picks the
//     closest point's case by selects, so that a warp's lanes do not part
//     on it.  The least of exact values does not depend on the order of
//     the search, so any split gives the same bits.
//     -DBVH_CLOSEST_ONE_THREAD builds the first design (pass 1 with no
//     budget, one thread a point to the end, reading children and then
//     boxes, the case picked by branches).
//
// Each per-pair test rounds every operation alone, in the order of the
// plain version in ops/mesh_queries.py (the dot and cross products written
// out element by element there): __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn,
// which nvcc never contracts into an FMA.  So t, the face id, the crossing
// count and the squared distance are bitwise the plain version's.
//
// Culling is conservative, so that no triangle the plain version would pick
// is skipped, for every triangle but a sliver seen edge-on (whose pair test
// can round by more than the widening; chip_smoke.py holds the results
// bitwise on every mesh it traces): the boxes are widened by `pad` (2^-16
// of the mesh's largest coordinate, at least 2^-16; far beyond the
// rounding of the slab test and of each pair test), the slab test's far end is scaled up and its near end down by
// 2^-20 (above 2 gamma_3, Ize 2013), a NaN of 0 * inf (a zero direction
// component on a box face) opens that slab instead of closing it, and a
// node is culled only when its entry t (or its box distance) is strictly
// greater than the best so far (in pass 2 the best shared so far, a
// distance to some triangle).  A stack overflow sets *overflow (for
// bvh_closest state[0] = 1, and a queue overflow state[0] = 2), which the
// wrapper raises on; no node is ever dropped.
//
// What bounds it on this card: the traversal is latency-bound pointer
// chasing (a node's record, or its children and then their boxes), some
// tens of box tests and a few triangle tests a ray, with a warp's lanes on
// unrelated paths (scripts/bvh_variants.py: more lanes a ray only add
// work); the bound chip_smoke.py
// states counts those tests at the f32 rate and, once each, the bytes of
// the inputs, the outputs and the boxes, children, triangles and face ids
// that the queries read (an instrumented build, -DBVH_COUNT_VISITS, counts
// and marks them;
// its bvh_closest is the one-thread design, the yardstick, unless
// -DBVH_COUNT_DESIGN asks for the two passes' own counts).  A closest-point
// query from deep inside a closed mesh finds every box about as near as
// its best and prunes little: thousands of dependent visits on one thread,
// which the budget hands to a block.  There a visit's dependent loads and
// the lanes' divergent paths (leaf or node, push or pop) set the time,
// not the bytes or the operations (scripts/bvh_variants.py).  The refit's
// climb is a chain of atomics, one a level, as deep as the tree: the
// block's levels take the chain's bottom out of device memory.  The
// hierarchy is two waves of threads each waiting on its own chain of
// dependent key loads: the window, the 32-bit counts and the queue shorten
// the chains without adding registers, which would add a wave.

#include <cuda/atomic>
#include <cuda_runtime.h>

#include <cmath>

// pass 1's budget of box tests a point (0: every point to pass 2)
#ifndef BVH_CLOSEST_BUDGET
#define BVH_CLOSEST_BUDGET 256
#endif
// pass 2's warps a queued point
#ifndef BVH_CLOSEST_WARPS
#define BVH_CLOSEST_WARPS 4
#endif

// a traversal stack's entries (a power of 2; the tests shrink it to reach
// an overflow)
#ifndef BVH_STACK
#define BVH_STACK 64
#endif

namespace {

constexpr int kStack = BVH_STACK;
constexpr int kBuildThreads = 256;
constexpr int kQueryThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
// visits a lane between two shares of the best (bvh_closest's pass 2, and
// bvh_ray's lanes)
constexpr int kSyncVisits = 8;
// The closest-point query's design: two passes, node records, the case of
// the closest point picked by selects, pass 2's idle lanes given subtrees.
// The first design (-DBVH_CLOSEST_ONE_THREAD, and the instrumented build's
// yardstick unless -DBVH_COUNT_DESIGN) has none of these; the ablation
// takes one out at a time: -DBVH_CLOSEST_SPLIT_LOADS reads a node's
// children and then their boxes, and a triangle, a float at a time;
// -DBVH_CLOSEST_BRANCHES picks the case by branches; -DBVH_CLOSEST_NO_DONATE
// keeps each lane to its own subtrees.
#if defined(BVH_CLOSEST_ONE_THREAD) || \
    (defined(BVH_COUNT_VISITS) && !defined(BVH_COUNT_DESIGN))
constexpr bool kTwoPass = false;
#else
constexpr bool kTwoPass = true;
#endif
#ifdef BVH_CLOSEST_SPLIT_LOADS
constexpr bool kRecords = false;
#else
constexpr bool kRecords = kTwoPass;
#endif
#ifdef BVH_CLOSEST_BRANCHES
constexpr bool kSelectCase = false;
#else
constexpr bool kSelectCase = kTwoPass;
#endif
#ifdef BVH_CLOSEST_NO_DONATE
constexpr bool kDonate = false;
#else
constexpr bool kDonate = true;
#endif
// pass 2's warps a queued point, a block of them
constexpr int kPointWarps = BVH_CLOSEST_WARPS;
constexpr int kPointLanes = 32 * kPointWarps;
// the breadth-first start's frontier: below 2 kPointLanes subtrees
constexpr int kFrontier = 2 * kPointLanes;
constexpr unsigned kClosestBudget = kTwoPass ? BVH_CLOSEST_BUDGET : 0xffffffffu;
#ifdef BVH_REFIT_DEVICE_ONLY
constexpr bool kBlockLevels = false;
#else
constexpr bool kBlockLevels = true;
#endif
// -DBVH_REFIT_NO_RECORDS (a measurement of their cost only: the two-pass
// query needs them) leaves the node records and padded triangles unwritten
#ifdef BVH_REFIT_NO_RECORDS
constexpr bool kWriteRecords = false;
#else
constexpr bool kWriteRecords = true;
#endif
// bvh_hierarchy's design: two passes.  Pass 1 (hierarchy_kernel) one
// thread an internal node, as the first design, but a node whose
// exponential search reaches kWarpSpan = 2^BVH_HIERARCHY_WARP_LOG keys joins
// a queue in device memory; pass 2 (hierarchy_warp_kernel) gives each
// queued node a warp.  -DBVH_HIERARCHY_ONE_THREAD builds the first design
// (pass 1 with no threshold).
#ifndef BVH_HIERARCHY_WARP_LOG
#define BVH_HIERARCHY_WARP_LOG 8
#endif
#ifdef BVH_HIERARCHY_ONE_THREAD
constexpr bool kWarpSearch = false;
#else
constexpr bool kWarpSearch = true;
#endif
constexpr long long kWarpSpan =
    kWarpSearch ? 1LL << BVH_HIERARCHY_WARP_LOG : 1LL << 62;
static_assert(BVH_HIERARCHY_WARP_LOG >= 1 && BVH_HIERARCHY_WARP_LOG <= 11,
              "a warp threshold of 2^1 .. 2^11 keys");
static_assert(8 * (kBuildThreads + (2LL << BVH_HIERARCHY_WARP_LOG)) <= 48 * 1024,
              "pass 1's window of keys fits 48 KB of shared memory");
// bvh_ray's design: one lane a ray (BVH_RAY_LANES, 2 or 4 for the
// ablation, splits a ray over lanes); node records and padded triangles
// (but with -DBVH_RAY_SPLIT_LOADS); a lane's stack in local memory, its top
// entry in registers (RayStack).  The first design (-DBVH_RAY_ONE_THREAD,
// and the instrumented build's yardstick unless -DBVH_COUNT_DESIGN) walks
// a ray on one thread, reading a node's children and then their boxes,
// with its whole stack in local memory.
#if defined(BVH_RAY_ONE_THREAD) || \
    (defined(BVH_COUNT_VISITS) && !defined(BVH_COUNT_DESIGN))
constexpr bool kRayDesign = false;
#else
constexpr bool kRayDesign = true;
#endif
#ifdef BVH_RAY_SPLIT_LOADS
constexpr bool kRayRecords = false;
#else
constexpr bool kRayRecords = true;
#endif
#ifndef BVH_RAY_LANES
#define BVH_RAY_LANES 1
#endif
constexpr int kRayLanes = BVH_RAY_LANES;
static_assert(kRayLanes == 1 || kRayLanes == 2 || kRayLanes == 4,
              "1, 2 or 4 lanes a ray");
// 2^-20, above 2 gamma_3 = 6u / (1 - 3u) with u = 2^-24
constexpr float kSlack = 9.5367431640625e-07f;
// the plain version's Moller-Trumbore and Ericson constants
constexpr float kDetEps = 1e-9f;
constexpr float kMinT = 1e-6f;
constexpr float kDivEps = 1e-30f;

#ifdef BVH_COUNT_VISITS
// box tests and triangle tests of the query kernels since the last read
__device__ unsigned long long g_visits[2];
// where set (bvh_count_buffers), what the query kernels read of the tree:
// g_touched[kind * (2n - 1) + node] = 1 for kind 0, the node's box; 1, its
// children (a leaf: its triangle); 2, its leaf's face id.  A plain store:
// every writer stores the same byte.  And g_query_tests[2q], [2q + 1]: the
// box and triangle tests of query q.
__device__ unsigned char* g_touched;
__device__ unsigned int* g_query_tests;
#endif

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* p) {
  return V3{p[0], p[1], p[2]};
}
__device__ __forceinline__ V3 vsub(V3 a, V3 b) {
  return V3{__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y), __fsub_rn(a.z, b.z)};
}
// a + b * s, each operation rounded
__device__ __forceinline__ V3 vaxpy(V3 a, V3 b, float s) {
  return V3{__fadd_rn(a.x, __fmul_rn(b.x, s)), __fadd_rn(a.y, __fmul_rn(b.y, s)),
            __fadd_rn(a.z, __fmul_rn(b.z, s))};
}
// (a.x b.x + a.y b.y) + a.z b.z
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                   __fmul_rn(a.z, b.z));
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return V3{__fsub_rn(__fmul_rn(a.y, b.z), __fmul_rn(a.z, b.y)),
            __fsub_rn(__fmul_rn(a.z, b.x), __fmul_rn(a.x, b.z)),
            __fsub_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x))};
}

// ---- build ------------------------------------------------------------------

// NaN-propagating min and max, as torch.minimum / amin in the plain refit
// (fminf and fmaxf would drop a NaN coordinate)
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// the common-prefix length of keys i and j, -1 where j is out of range
__device__ __forceinline__ int delta(const long long* keys, int n, int i,
                                     long long j) {
  if (j < 0 || j >= n) return -1;
  return __clzll(keys[i] ^ keys[j]);
}

// node i's children, parents and far end j from its direction d, far end
// offset l and split offset s
__device__ __forceinline__ void write_node(int n, long long i, int d,
                                           long long l, long long s,
                                           int* __restrict__ children,
                                           int* __restrict__ parents,
                                           int* __restrict__ far) {
  const long long j = i + l * d;
  const long long split = i + s * d + (d < 0 ? -1 : 0);
  const long long first = i < j ? i : j;
  const long long last = i < j ? j : i;
  const int left = static_cast<int>(first == split ? n - 1 + split : split);
  const int right =
      static_cast<int>(last == split + 1 ? n - 1 + split + 1 : split + 1);
  children[2 * i] = left;
  children[2 * i + 1] = right;
  parents[left] = static_cast<int>(i);
  parents[right] = static_cast<int>(i);
  far[i] = static_cast<int>(j);
}

// The largest m in [lo, hi) whose key i + m d shares more than `above`
// leading bits with key i (`ki`), given that m = lo does; the common prefix
// shrinks as m grows, so the answer is one place whatever the search.  The
// warp probes 32 evenly spaced m a round and keeps the last that holds:
// about log32 of the range in rounds, each one load a lane.  Every lane
// calls it with the same arguments.
__device__ __forceinline__ long long warp_last_above(
    const long long* __restrict__ keys, long long ki, long long i, int d,
    int above, long long lo, long long hi, int lane) {
  while (hi - lo > 1) {
    const long long step = (hi - lo + 31) / 32;
    const long long m = lo + lane * step;
    const bool holds = m < hi && __clzll(ki ^ __ldg(keys + i + m * d)) > above;
    const unsigned ballot = __ballot_sync(kFull, holds);
    lo += (31 - __clz(ballot)) * step;  // lane 0's m = lo holds
    hi = min(lo + step, hi);
  }
  return lo;
}

// Pass 1: one thread an internal node: its direction, its far end by an
// exponential then a binary search, its split by a binary search, as the
// first design, but counting in 32 bits (every range is below 2^30 keys)
// with key i held in a register and the split's ceil(l / 2^m) a shift, not
// a 64-bit division.  A node whose exponential search reaches kWarpSpan (a
// range of more than kWarpSpan keys) joins the queue (queue[*queued]) for
// pass 2 instead.  The first design (-DBVH_HIERARCHY_ONE_THREAD) is
// hierarchy_one_thread_kernel.
__global__ void __launch_bounds__(kBuildThreads)
    hierarchy_kernel(const long long* __restrict__ keys, int n,
                     int* __restrict__ children, int* __restrict__ parents,
                     int* __restrict__ far, int* __restrict__ queue,
                     int* queued) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // the block's keys and kWarpSpan on each side, read once into shared
  // memory: every key pass 1 reads
  constexpr int kSide = static_cast<int>(kWarpSpan);
  __shared__ long long window[kBuildThreads + 2 * kSide];
  const int w0 = blockIdx.x * kBuildThreads - kSide;
  for (int k = threadIdx.x; k < kBuildThreads + 2 * kSide; k += kBuildThreads)
    if (w0 + k >= 0 && w0 + k < n) window[k] = __ldg(keys + w0 + k);
  __syncthreads();
  const auto delta_of = [&](long long ki, long long j) {
    return j < 0 || j >= n ? -1 : __clzll(ki ^ window[j - w0]);
  };
  if (i >= n - 1) return;
  const long long ki = window[i - w0];
  const int d = delta_of(ki, i + 1) - delta_of(ki, i - 1) > 0 ? 1 : -1;
  const int dmin = delta_of(ki, i - d);
  // the key m places from i in the node's direction
  const auto at = [&](int m) { return static_cast<long long>(i) + m * d; };
  int lmax = 2;
  while (lmax < kWarpSpan && delta_of(ki, at(lmax)) > dmin) lmax *= 2;
  if (lmax == kWarpSpan && delta_of(ki, at(lmax)) > dmin) {
    queue[atomicAdd(queued, 1)] = i;
    return;
  }
  int l = 0;
  for (int t = lmax / 2; t >= 1; t /= 2)
    if (delta_of(ki, at(l + t)) > dmin) l += t;
  const int dnode = delta_of(ki, at(l));
  int s = 0;
  for (int m = 1;; ++m) {
    const int t = (l + (1 << m) - 1) >> m;
    if (delta_of(ki, at(s + t)) > dnode) s += t;
    if (t <= 1) break;
  }
  write_node(n, i, d, l, s, children, parents, far);
}

// The first design: one thread an internal node, every search on it, in
// 64 bits with a division a step of the split.
__global__ void __launch_bounds__(kBuildThreads)
    hierarchy_one_thread_kernel(const long long* __restrict__ keys, int n,
                                int* __restrict__ children,
                                int* __restrict__ parents,
                                int* __restrict__ far) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n - 1) return;
  const int d = delta(keys, n, i, i + 1) - delta(keys, n, i, i - 1) > 0 ? 1 : -1;
  const int dmin = delta(keys, n, i, i - d);
  long long lmax = 2;
  while (delta(keys, n, i, i + lmax * d) > dmin) lmax *= 2;
  long long l = 0;
  for (long long t = lmax / 2; t >= 1; t /= 2)
    if (delta(keys, n, i, i + (l + t) * d) > dmin) l += t;
  const long long j = i + l * d;
  const int dnode = delta(keys, n, i, j);
  long long s = 0;
  long long t;
  long long div = 2;
  do {
    t = (l + div - 1) / div;
    if (delta(keys, n, i, i + (s + t) * d) > dnode) s += t;
    div *= 2;
  } while (t > 1);
  write_node(n, i, d, l, s, children, parents, far);
}

// Pass 2: a warp a queued node, warps striding over the queue, whose length
// it reads here: one round of the exponential search (lane k probes
// kWarpSpan 2^k), then warp_last_above for the far end within that
// doubling and for the split.
__global__ void __launch_bounds__(kBuildThreads)
    hierarchy_warp_kernel(const long long* __restrict__ keys, int n,
                          int* __restrict__ children, int* __restrict__ parents,
                          int* __restrict__ far, const int* __restrict__ queue,
                          const int* __restrict__ queued) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (kBuildThreads / 32);
  const int length = *queued;
  for (int q = blockIdx.x * (kBuildThreads / 32) + threadIdx.x / 32; q < length;
       q += warps) {
    const int i = queue[q];
    const long long ki = __ldg(keys + i);
    const int d =
        delta(keys, n, i, i + 1) - delta(keys, n, i, i - 1) > 0 ? 1 : -1;
    const int dmin = delta(keys, n, i, i - d);
    // the far end lies in [kWarpSpan 2^a, kWarpSpan 2^(a+1)), a the last
    // lane whose probe holds (lane 0's, kWarpSpan, does)
    const long long end = (d > 0 ? n - 1 - static_cast<long long>(i) : i) + 1;
    const long long probe = kWarpSpan << lane;
    const unsigned grows = __ballot_sync(
        kFull, probe < end && __clzll(ki ^ __ldg(keys + i + probe * d)) > dmin);
    const long long lo = kWarpSpan << (31 - __clz(grows));
    const long long l =
        warp_last_above(keys, ki, i, d, dmin, lo, min(2 * lo, end), lane);
    const int dnode = __clzll(ki ^ __ldg(keys + i + l * d));
    const long long s = warp_last_above(keys, ki, i, d, dnode, 0, l, lane);
    if (lane == 0) write_node(n, i, d, l, s, children, parents, far);
  }
}

// the leaf box of triangle v (9 floats), widened by pad
__device__ __forceinline__ void leaf_box(const float* v, float pad, float* b) {
  for (int a = 0; a < 3; ++a) {
    b[a] = __fsub_rn(nan_min(nan_min(v[a], v[3 + a]), v[6 + a]), pad);
    b[3 + a] = __fadd_rn(nan_max(nan_max(v[a], v[3 + a]), v[6 + a]), pad);
  }
}

#ifdef BVH_REFIT_FENCES
__global__ void __launch_bounds__(kBuildThreads)
    refit_kernel(const float* __restrict__ tris, const int* __restrict__ parents,
                 const int* __restrict__ children, const int* __restrict__,
                 int n, float pad, int* arrivals, float* boxes, float4*,
                 float4*) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  int node = n - 1 + k;
  leaf_box(tris + 9 * static_cast<long long>(k), pad,
           boxes + 6 * static_cast<long long>(node));
  int p = parents[node];
  while (p >= 0) {
    // this node's box is written before the arrival is counted; the second
    // thread to arrive reads both boxes from L2 after its count
    __threadfence();
    if (atomicAdd(arrivals + p, 1) == 0) return;
    __threadfence();
    const float* l = boxes + 6 * static_cast<long long>(children[2 * p]);
    const float* r = boxes + 6 * static_cast<long long>(children[2 * p + 1]);
    float* out = boxes + 6 * static_cast<long long>(p);
    for (int a = 0; a < 3; ++a) {
      out[a] = nan_min(__ldcg(l + a), __ldcg(r + a));
      out[3 + a] = nan_max(__ldcg(l + 3 + a), __ldcg(r + 3 + a));
    }
    p = parents[p];
  }
}
#else
// A block's leaves are b0 .. b0 + kBuildThreads - 1; a node whose range
// lies among them is the block's own.  Its shared slot: leaf k at k - b0,
// internal node i (one end of its own range, so also among them) at
// kBuildThreads + i - b0.
//
// Besides the boxes, each internal node's record (records[4i .. 4i + 3]:
// its left child's box, its right child's, their ids' bits, two zeros) and
// each leaf's triangle padded to 12 floats (tris_padded[3k .. 3k + 2]),
// for the closest-point query.
__global__ void __launch_bounds__(kBuildThreads)
    refit_kernel(const float* __restrict__ tris, const int* __restrict__ parents,
                 const int* __restrict__ children, const int* __restrict__ far,
                 int n, float pad, int* arrivals, float* boxes,
                 float4* __restrict__ records,
                 float4* __restrict__ tris_padded) {
  __shared__ float shared_box[2 * kBuildThreads][6];
  __shared__ int shared_arrivals[kBuildThreads];
  shared_arrivals[threadIdx.x] = 0;
  __syncthreads();
  const int b0 = blockIdx.x * kBuildThreads;
  const int k = b0 + threadIdx.x;
  if (k >= n) return;
  const float* v = tris + 9 * static_cast<long long>(k);
  float box[6];
  leaf_box(v, pad, box);
  if (kWriteRecords) {
    float4* padded = tris_padded + 3 * static_cast<long long>(k);
    padded[0] = make_float4(v[0], v[1], v[2], v[3]);
    padded[1] = make_float4(v[4], v[5], v[6], v[7]);
    padded[2] = make_float4(v[8], 0.0f, 0.0f, 0.0f);
  }
  int node = n - 1 + k;
  for (int a = 0; a < 6; ++a) {
    boxes[6 * static_cast<long long>(node) + a] = box[a];
    shared_box[threadIdx.x][a] = box[a];
  }
  // a merged node's record waits in registers until the next count has
  // been made: the count's release need not wait for its stores
  float4 record[4];
  long long record_at = -1;
  int p = parents[node];
  // the level's read-only loads (children, far end, parent), one level
  // ahead: the next level's are issued before this level's count
  int left = 0, right = 0, j = 0, up = -1;
  if (p >= 0) {
    left = children[2 * p];
    right = children[2 * p + 1];
    j = far[p];
    up = parents[p];
  }
  while (p >= 0) {
    int next_left = 0, next_right = 0, next_j = 0, next_up = -1;
    if (up >= 0) {
      next_left = children[2 * up];
      next_right = children[2 * up + 1];
      next_j = far[up];
      next_up = parents[up];
    }
    const bool own = kBlockLevels && (p < j ? p : j) >= b0 &&
                     (p < j ? j : p) < b0 + kBuildThreads;
    const bool is_left = left == node;
    const int sibling = is_left ? right : left;
    // this node's box is in shared memory (a node of the block's own) or
    // in device memory before the count releases it
    const bool first =
        own ? cuda::atomic_ref<int, cuda::thread_scope_block>(
                  shared_arrivals[p - b0])
                      .fetch_add(1, cuda::std::memory_order_acq_rel) == 0
            : cuda::atomic_ref<int, cuda::thread_scope_device>(arrivals[p])
                      .fetch_add(1, cuda::std::memory_order_acq_rel) == 0;
    if (kWriteRecords && record_at >= 0)
      for (int a = 0; a < 4; ++a) records[record_at + a] = record[a];
    if (first) return;
    float other[6];
    if (own) {
      const int slot = sibling >= n - 1 ? sibling - (n - 1) - b0
                                        : kBuildThreads + sibling - b0;
      for (int a = 0; a < 6; ++a) other[a] = shared_box[slot][a];
    } else {
      for (int a = 0; a < 6; ++a)
        other[a] = __ldcg(boxes + 6 * static_cast<long long>(sibling) + a);
    }
    float l[6], r[6];
    for (int a = 0; a < 6; ++a) {
      l[a] = is_left ? box[a] : other[a];
      r[a] = is_left ? other[a] : box[a];
    }
    record[0] = make_float4(l[0], l[1], l[2], l[3]);
    record[1] = make_float4(l[4], l[5], r[0], r[1]);
    record[2] = make_float4(r[2], r[3], r[4], r[5]);
    record[3] = make_float4(__int_as_float(left), __int_as_float(right), 0.0f,
                            0.0f);
    record_at = 4 * static_cast<long long>(p);
    for (int a = 0; a < 3; ++a) {
      box[a] = nan_min(l[a], r[a]);
      box[3 + a] = nan_max(l[3 + a], r[3 + a]);
    }
    for (int a = 0; a < 6; ++a) {
      boxes[6 * static_cast<long long>(p) + a] = box[a];
      if (own) shared_box[kBuildThreads + p - b0][a] = box[a];
    }
    node = p;
    p = up;
    left = next_left;
    right = next_right;
    j = next_j;
    up = next_up;
  }
  if (kWriteRecords && record_at >= 0)  // the root's
    for (int a = 0; a < 4; ++a) records[record_at + a] = record[a];
}
#endif

// ---- the pair tests, in the plain version's order ---------------------------

// Moller-Trumbore: the hit's t, or +inf (mesh_queries._ray_tri_t)
__device__ __forceinline__ float ray_tri_t(V3 o, V3 d, V3 a, V3 b, V3 c) {
  const V3 e1 = vsub(b, a);
  const V3 e2 = vsub(c, a);
  const V3 h = cross(d, e2);
  const float det = dot(e1, h);
  const float inv = __fdiv_rn(1.0f, fabsf(det) < kDetEps ? kDetEps : det);
  const V3 s = vsub(o, a);
  const float u = __fmul_rn(dot(s, h), inv);
  const V3 q = cross(s, e1);
  const float v = __fmul_rn(dot(d, q), inv);
  const float t = __fmul_rn(dot(e2, q), inv);
  const bool hit = fabsf(det) > kDetEps && u >= 0.0f && v >= 0.0f &&
                   __fadd_rn(u, v) <= 1.0f && t > kMinT;
  return hit ? t : INFINITY;
}

__device__ __forceinline__ float safe_div(float x, float y) {
  return __fdiv_rn(x, fabsf(y) < kDivEps ? kDivEps : y);
}

// Ericson's closest point, its cases in the plain version's order of
// precedence (a later case there overrides an earlier one: vertex a, b, c,
// then edges AB, AC, BC, then the interior); the squared distance
// (mesh_queries._closest_dist2)
template <bool kSelect>
__device__ __forceinline__ float closest_dist2(V3 p, V3 a, V3 b, V3 c) {
  const V3 ab = vsub(b, a);
  const V3 ac = vsub(c, a);
  const V3 ap = vsub(p, a);
  const float d1 = dot(ab, ap);
  const float d2 = dot(ac, ap);
  const V3 bp = vsub(p, b);
  const float d3 = dot(ab, bp);
  const float d4 = dot(ac, bp);
  const V3 cp = vsub(p, c);
  const float d5 = dot(ab, cp);
  const float d6 = dot(ac, cp);
  const float va = __fsub_rn(__fmul_rn(d3, d6), __fmul_rn(d5, d4));
  const float vb = __fsub_rn(__fmul_rn(d5, d2), __fmul_rn(d1, d6));
  const float vc = __fsub_rn(__fmul_rn(d1, d4), __fmul_rn(d3, d2));
  const float d43 = __fsub_rn(d4, d3);
  const float d56 = __fsub_rn(d5, d6);
  V3 q;
  if (kSelect) {
    // every case computed, the one that holds picked in the plain version's
    // order: the same operations on the picked case, and no branch for the
    // lanes of a warp to part on
    const float denom = safe_div(1.0f, __fadd_rn(__fadd_rn(va, vb), vc));
    q = vaxpy(vaxpy(a, ab, __fmul_rn(vb, denom)), ac, __fmul_rn(vc, denom));
    const V3 on_bc = vaxpy(b, vsub(c, b), safe_div(d43, __fadd_rn(d43, d56)));
    const V3 on_ac = vaxpy(a, ac, safe_div(d2, __fsub_rn(d2, d6)));
    const V3 on_ab = vaxpy(a, ab, safe_div(d1, __fsub_rn(d1, d3)));
    if (va <= 0.0f && d43 >= 0.0f && d56 >= 0.0f) q = on_bc;
    if (vb <= 0.0f && d2 >= 0.0f && d6 <= 0.0f) q = on_ac;
    if (vc <= 0.0f && d1 >= 0.0f && d3 <= 0.0f) q = on_ab;
    if (d6 >= 0.0f && d5 <= d6) q = c;
    if (d3 >= 0.0f && d4 <= d3) q = b;
    if (d1 <= 0.0f && d2 <= 0.0f) q = a;
  } else if (d1 <= 0.0f && d2 <= 0.0f) {
    q = a;
  } else if (d3 >= 0.0f && d4 <= d3) {
    q = b;
  } else if (d6 >= 0.0f && d5 <= d6) {
    q = c;
  } else if (vc <= 0.0f && d1 >= 0.0f && d3 <= 0.0f) {
    q = vaxpy(a, ab, safe_div(d1, __fsub_rn(d1, d3)));
  } else if (vb <= 0.0f && d2 >= 0.0f && d6 <= 0.0f) {
    q = vaxpy(a, ac, safe_div(d2, __fsub_rn(d2, d6)));
  } else if (va <= 0.0f && d43 >= 0.0f && d56 >= 0.0f) {
    q = vaxpy(b, vsub(c, b), safe_div(d43, __fadd_rn(d43, d56)));
  } else {
    const float denom = safe_div(1.0f, __fadd_rn(__fadd_rn(va, vb), vc));
    q = vaxpy(vaxpy(a, ab, __fmul_rn(vb, denom)), ac, __fmul_rn(vc, denom));
  }
  const V3 diff = vsub(p, q);
  return dot(diff, diff);
}

// ---- traversal ----------------------------------------------------------------

// one axis of the slab test: (near, far); a NaN (0 * inf: a zero direction
// component and the origin on the box's face) opens the slab.  kSum tells a
// NaN by the sum of the two ends, which is NaN also for +inf and -inf (a
// zero component and the origin inside the slab), whose (near, far) is the
// open slab's anyway: the same (near, far), fewer operations.
template <bool kSum>
__device__ __forceinline__ void slab_axis(float lo, float hi, float o, float inv,
                                          float& near, float& far) {
  const float t0 = __fmul_rn(__fsub_rn(lo, o), inv);
  const float t1 = __fmul_rn(__fsub_rn(hi, o), inv);
  if (kSum) {
    const float sum = __fadd_rn(t0, t1);
    const bool open = sum != sum;
    near = open ? -INFINITY : fminf(t0, t1);
    far = open ? INFINITY : fmaxf(t0, t1);
  } else {
    near = fminf(t0 != t0 ? -INFINITY : t0, t1 != t1 ? -INFINITY : t1);
    far = fmaxf(t0 != t0 ? INFINITY : t0, t1 != t1 ? INFINITY : t1);
  }
}

// the conservative entry t of the ray into the box, or +inf on a miss
template <bool kSum = false>
__device__ __forceinline__ float box_entry(const float* box, V3 o, V3 inv) {
  float nx, fx, ny, fy, nz, fz;
  slab_axis<kSum>(box[0], box[3], o.x, inv.x, nx, fx);
  slab_axis<kSum>(box[1], box[4], o.y, inv.y, ny, fy);
  slab_axis<kSum>(box[2], box[5], o.z, inv.z, nz, fz);
  float near = fmaxf(fmaxf(nx, ny), nz);
  float far = fminf(fminf(fx, fy), fz);
  near = near - fabsf(near) * kSlack;
  far = far + fabsf(far) * kSlack;
  // a NaN here (inf - inf) is a slab the ray never enters: a miss
  if (!(near <= far) || !(far >= 0.0f)) return INFINITY;
  return fmaxf(near, 0.0f);
}

// the squared distance from p to the box (0 inside)
__device__ __forceinline__ float box_dist2(const float* box, V3 p) {
  const float dx = fmaxf(fmaxf(box[0] - p.x, 0.0f), p.x - box[3]);
  const float dy = fmaxf(fmaxf(box[1] - p.y, 0.0f), p.y - box[4]);
  const float dz = fmaxf(fmaxf(box[2] - p.z, 0.0f), p.z - box[5]);
  return dx * dx + dy * dy + dz * dz;
}

// the tree as the closest-point query reads it: a node's children and their
// boxes, a leaf's triangle
struct Tree {
  const float* __restrict__ boxes;
  const int* __restrict__ children;
  const float* __restrict__ tris;
  const float4* __restrict__ records;
  const float4* __restrict__ tris_padded;
  int n;
};

struct Children {
  int left, right;
  float lbox[6], rbox[6];
};

// internal node `node`'s children and their boxes: its record, four
// independent 16-byte loads; or its children, then their boxes
template <bool kRec>
__device__ __forceinline__ Children read_children(const Tree& t, int node) {
  Children c;
  if (kRec) {
    const float4* rec = t.records + 4 * static_cast<long long>(node);
    const float4 r0 = __ldg(rec), r1 = __ldg(rec + 1), r2 = __ldg(rec + 2),
                 r3 = __ldg(rec + 3);
    c.left = __float_as_int(r3.x);
    c.right = __float_as_int(r3.y);
    const float l[6] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y};
    const float r[6] = {r1.z, r1.w, r2.x, r2.y, r2.z, r2.w};
    for (int a = 0; a < 6; ++a) {
      c.lbox[a] = l[a];
      c.rbox[a] = r[a];
    }
  } else {
    c.left = t.children[2 * node];
    c.right = t.children[2 * node + 1];
    for (int a = 0; a < 6; ++a) {
      c.lbox[a] = t.boxes[6 * static_cast<long long>(c.left) + a];
      c.rbox[a] = t.boxes[6 * static_cast<long long>(c.right) + a];
    }
  }
  return c;
}

// the squared distance from p to leaf k's triangle
__device__ __forceinline__ float leaf_dist2(const Tree& t, int k, V3 p) {
  if (kRecords) {
    const float4* v = t.tris_padded + 3 * static_cast<long long>(k);
    const float4 v0 = __ldg(v), v1 = __ldg(v + 1), v2 = __ldg(v + 2);
    return closest_dist2<kSelectCase>(p, V3{v0.x, v0.y, v0.z},
                                      V3{v0.w, v1.x, v1.y},
                                      V3{v1.z, v1.w, v2.x});
  }
  const float* v = t.tris + 9 * static_cast<long long>(k);
  return closest_dist2<kSelectCase>(p, load3(v), load3(v + 3), load3(v + 6));
}

// the instrumented build marks a read of the tree (g_touched); a no-op
// otherwise
__device__ __forceinline__ void touch(int kind, int n, int node) {
#ifdef BVH_COUNT_VISITS
  if (g_touched)
    g_touched[static_cast<long long>(kind) * (2 * n - 1) + node] = 1;
#else
  (void)kind;
  (void)n;
  (void)node;
#endif
}

// the instrumented build adds query r's tests to the totals and keeps them
__device__ __forceinline__ void count_tests(int r, unsigned box_tests,
                                            unsigned tri_tests) {
#ifdef BVH_COUNT_VISITS
  atomicAdd(&g_visits[0], static_cast<unsigned long long>(box_tests));
  atomicAdd(&g_visits[1], static_cast<unsigned long long>(tri_tests));
  if (g_query_tests) {
    g_query_tests[2 * static_cast<long long>(r)] = box_tests;
    g_query_tests[2 * static_cast<long long>(r) + 1] = tri_tests;
  }
#else
  (void)r;
  (void)box_tests;
  (void)tri_tests;
#endif
}

// ... or adds them (pass 2's lanes, after pass 1's)
__device__ __forceinline__ void add_tests(int r, unsigned box_tests,
                                          unsigned tri_tests) {
#ifdef BVH_COUNT_VISITS
  atomicAdd(&g_visits[0], static_cast<unsigned long long>(box_tests));
  atomicAdd(&g_visits[1], static_cast<unsigned long long>(tri_tests));
  if (g_query_tests) {
    atomicAdd(g_query_tests + 2 * static_cast<long long>(r), box_tests);
    atomicAdd(g_query_tests + 2 * static_cast<long long>(r) + 1, tri_tests);
  }
#else
  (void)r;
  (void)box_tests;
  (void)tri_tests;
#endif
}

struct Entry {
  int node;
  float key;  // the node's entry t, or its box's squared distance
};

// The first design of bvh_ray: one thread a ray, its stack in local memory.
// kCount: count every crossing (no culling by the best hit); else the first
// hit.  d_stride 0 gives every ray the one direction d[0..2].
template <bool kCount>
__global__ void __launch_bounds__(kQueryThreads)
    ray_one_thread_kernel(const float* __restrict__ boxes, const int* __restrict__ children,
               const float* __restrict__ tris, const int* __restrict__ order,
               int n, const float* __restrict__ rays_o,
               const float* __restrict__ rays_d, int d_stride, int rays,
               float* __restrict__ out_t, int* __restrict__ out_id,
               int* overflow) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rays) return;
  const V3 o = load3(rays_o + 3 * static_cast<long long>(r));
  const V3 d = load3(rays_d + d_stride * static_cast<long long>(r));
  const V3 inv{__fdiv_rn(1.0f, d.x), __fdiv_rn(1.0f, d.y), __fdiv_rn(1.0f, d.z)};
  float best = INFINITY;
  int best_id = -1;
  int hits = 0;
  unsigned box_tests = 0, tri_tests = 0;
  Entry stack[kStack];
  int sp = 0;
  int node = 0;  // the root: internal node 0, or leaf 0 of a 1-triangle mesh
  bool full = false;
  while (true) {
    if (node >= n - 1) {  // a leaf: its triangle
      const int k = node - (n - 1);
      const float* v = tris + 9 * static_cast<long long>(k);
      const float t = ray_tri_t(o, d, load3(v), load3(v + 3), load3(v + 6));
      ++tri_tests;
      touch(1, n, node);
      if (kCount) {
        hits += t < INFINITY;
      } else if (t < INFINITY) {
        const int id = order[k];
        touch(2, n, node);
        if (t < best || (t == best && id < best_id)) {
          best = t;
          best_id = id;
        }
      }
    } else {
      const int left = children[2 * node];
      const int right = children[2 * node + 1];
      const float tl = box_entry(boxes + 6 * static_cast<long long>(left), o, inv);
      const float tr = box_entry(boxes + 6 * static_cast<long long>(right), o, inv);
      box_tests += 2;
      touch(1, n, node);
      touch(0, n, left);
      touch(0, n, right);
      // a miss enters at +inf, which a best of +inf must not take
      const bool in_l = tl < INFINITY && tl <= best;
      const bool in_r = tr < INFINITY && tr <= best;
      if (in_l && in_r) {
        const bool l_first = tl <= tr;
        if (sp == kStack) {
          full = true;
          break;
        }
        stack[sp++] = l_first ? Entry{right, tr} : Entry{left, tl};
        node = l_first ? left : right;
        continue;
      }
      if (in_l || in_r) {
        node = in_l ? left : right;
        continue;
      }
    }
    // the next stacked node that may still hold a better hit
    bool found = false;
    while (sp > 0) {
      const Entry e = stack[--sp];
      if (e.key <= best) {
        node = e.node;
        found = true;
        break;
      }
    }
    if (!found) break;
  }
  if (full) *overflow = 1;
  if (kCount) {
    out_id[r] = hits;
  } else {
    out_t[r] = best;
    out_id[r] = best_id;
  }
  count_tests(r, box_tests, tri_tests);
}

// A lane's stack of far children: its top entry in registers, the rest in
// local memory.  sp counts them all.
struct RayStack {
  Entry below[kStack];
  Entry top;
  int sp;
  __device__ __forceinline__ void push(Entry e) {
    if (sp > 0) below[sp - 1] = top;
    top = e;
    ++sp;
  }
  __device__ __forceinline__ Entry pop() {
    --sp;
    const Entry e = top;
    if (sp > 0) top = below[sp - 1];
    return e;
  }
};

// one lane's walk of a ray: the node to visit, the best hit (t, face id) or
// the crossings so far, the tests made
struct RayWalk {
  int node;
  float best;
  int best_id;
  int hits;
  unsigned box_tests, tri_tests;
  bool full;
};

// the ray's t at leaf k's triangle: its padded row (three 16-byte loads)
// or its nine floats
template <bool kRec>
__device__ __forceinline__ float leaf_t(const Tree& t, int k, V3 o, V3 d) {
  if (kRec) {
    const float4* v = t.tris_padded + 3 * static_cast<long long>(k);
    const float4 v0 = __ldg(v), v1 = __ldg(v + 1), v2 = __ldg(v + 2);
    return ray_tri_t(o, d, V3{v0.x, v0.y, v0.z}, V3{v0.w, v1.x, v1.y},
                     V3{v1.z, v1.w, v2.x});
  }
  const float* v = t.tris + 9 * static_cast<long long>(k);
  return ray_tri_t(o, d, load3(v), load3(v + 3), load3(v + 6));
}

// Visits w.node (a leaf's triangle, or an internal node's two child boxes)
// and moves to the next node: the nearer child the ray enters not beyond
// the best, else the next stacked node that is not.  False once none is
// left, or the stack overflowed (w.full).  The face id is read only for a
// hit that may become the best.
template <bool kCount>
__device__ __forceinline__ bool ray_visit(RayWalk& w, RayStack& s, V3 o, V3 d,
                                          V3 inv, const Tree& t,
                                          const int* __restrict__ order) {
  const int node = w.node;
  const int n = t.n;
  if (node >= n - 1) {
    const int k = node - (n - 1);
    const float hit = leaf_t<kRayRecords>(t, k, o, d);
    ++w.tri_tests;
    touch(1, n, node);
    if (kCount) {
      w.hits += hit < INFINITY;
    } else if (hit <= w.best && hit < INFINITY) {
      const int id = __ldg(order + k);
      touch(2, n, node);
      if (hit < w.best || id < w.best_id) {
        w.best = hit;
        w.best_id = id;
      }
    }
  } else {
    const Children c = read_children<kRayRecords>(t, node);
    const float tl = box_entry<true>(c.lbox, o, inv);
    const float tr = box_entry<true>(c.rbox, o, inv);
    w.box_tests += 2;
    touch(1, n, node);
    touch(0, n, c.left);
    touch(0, n, c.right);
    // a miss enters at +inf, which a best of +inf must not take
    const bool in_l = tl < INFINITY && tl <= w.best;
    const bool in_r = tr < INFINITY && tr <= w.best;
    if (in_l && in_r) {
      const bool l_first = tl <= tr;
      if (s.sp == kStack) {
        w.full = true;
        return false;
      }
      s.push(l_first ? Entry{c.right, tr} : Entry{c.left, tl});
      w.node = l_first ? c.left : c.right;
      return true;
    }
    if (in_l || in_r) {
      w.node = in_l ? c.left : c.right;
      return true;
    }
  }
  while (s.sp > 0) {
    const Entry e = s.pop();
    if (e.key <= w.best) {
      w.node = e.node;
      return true;
    }
  }
  return false;
}

// a first hit as one 64-bit key, least first: t (> 0, or +inf on a miss)
// orders as its bits, then the face id (a miss's -1 as the largest)
__device__ __forceinline__ unsigned long long hit_key(float t, int id) {
  return (static_cast<unsigned long long>(__float_as_uint(t)) << 32) |
         static_cast<unsigned>(id);
}

// The design of bvh_ray: one lane a ray, or for the ablation kLanes
// consecutive lanes a ray (BVH_RAY_LANES).  The ray's lanes
// walk down from the root together (the same loads, made once by the
// memory system), splitting their lanes between the two children at each
// node whose both boxes the ray enters, until each lane holds a subtree of
// its own (a leaf or a dead end reached first leaves its spare lanes idle).
// Each lane then walks its subtree depth-first.  First hits: every
// kSyncVisits visits the warp's lanes share their ray's least (t, id) by
// shuffles, so that a lane culls by the best any of the ray's lanes has
// found; the least of exact values is the same in any order and under any
// such culling.  Count mode: the lanes sum the crossings of their disjoint
// subtrees.  kCount and d_stride as ray_one_thread_kernel's.
template <bool kCount, int kLanes>
__global__ void __launch_bounds__(kQueryThreads)
    ray_kernel(const Tree t, const int* __restrict__ order,
               const float* __restrict__ rays_o,
               const float* __restrict__ rays_d, int d_stride, int rays,
               float* __restrict__ out_t, int* __restrict__ out_id,
               int* overflow) {
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int r = static_cast<int>(g / kLanes);
  const bool valid = r < rays;
  const int n = t.n;
  V3 o{0.0f, 0.0f, 0.0f}, d{1.0f, 1.0f, 1.0f};
  if (valid) {
    o = load3(rays_o + 3 * static_cast<long long>(r));
    d = load3(rays_d + d_stride * static_cast<long long>(r));
  }
  const V3 inv{__fdiv_rn(1.0f, d.x), __fdiv_rn(1.0f, d.y), __fdiv_rn(1.0f, d.z)};
  RayStack s;
  s.sp = 0;
  RayWalk w{0, INFINITY, -1, 0, 0, 0, false};
  // the start: `span` lanes share the walk to w.node, this one `rel`-th;
  // the first of them counts the tests
  bool alive = valid;
  int span = kLanes, rel = static_cast<int>(threadIdx.x % kLanes);
  while (alive && span > 1 && w.node < n - 1) {
    const Children c = read_children<kRayRecords>(t, w.node);
    const float tl = box_entry<true>(c.lbox, o, inv);
    const float tr = box_entry<true>(c.rbox, o, inv);
    if (rel == 0) w.box_tests += 2;
    touch(1, n, w.node);
    touch(0, n, c.left);
    touch(0, n, c.right);
    const bool in_l = tl < INFINITY, in_r = tr < INFINITY;
    if (in_l && in_r) {
      const bool l_first = tl <= tr;
      span /= 2;
      w.node = (rel < span) == l_first ? c.left : c.right;
      rel %= span;
    } else if (in_l || in_r) {
      w.node = in_l ? c.left : c.right;
    } else {
      alive = false;
    }
  }
  alive = alive && rel == 0;
  if (kCount || kLanes == 1) {
    while (alive) alive = ray_visit<kCount>(w, s, o, d, inv, t, order);
  } else {
    while (true) {
      for (int v = 0; alive && v < kSyncVisits; ++v)
        alive = ray_visit<kCount>(w, s, o, d, inv, t, order);
      unsigned long long best = hit_key(w.best, w.best_id);
      for (int m = 1; m < kLanes; m *= 2)
        best = min(best, __shfl_xor_sync(kFull, best, m));
      w.best = __uint_as_float(static_cast<unsigned>(best >> 32));
      w.best_id = static_cast<int>(static_cast<unsigned>(best));
      if (!__ballot_sync(kFull, alive)) break;
    }
  }
  if (kCount)
    for (int m = 1; m < kLanes; m *= 2)
      w.hits += __shfl_xor_sync(kFull, w.hits, m);
  if (w.full) *overflow = 1;
  if (valid) {
    add_tests(r, w.box_tests, w.tri_tests);
    if (threadIdx.x % kLanes == 0) {
      if (kCount) {
        out_id[r] = w.hits;
      } else {
        out_t[r] = w.best;
        out_id[r] = w.best_id;
      }
    }
  }
}

// one point's depth-first walk: the node to visit, the stack of far
// children (a ring: stack[base .. top - 1], indices mod kStack; pass 2 hands
// its bottom entry, the largest subtree, to an idle lane), the best squared
// distance so far and the tests made
struct Walk {
  Entry stack[kStack];
  unsigned base, top;
  int node;
  float best;
  unsigned box_tests, tri_tests;
  bool full;
};
static_assert((kStack & (kStack - 1)) == 0, "the ring's size is a power of 2");

// Visits w.node (a leaf's triangle, or an internal node's two child boxes)
// and moves to the next node: the nearer child whose box is not beyond the
// best, else the next stacked node that is not.  False once none is left,
// or the stack overflowed (w.full).
__device__ __forceinline__ bool closest_visit(Walk& w, V3 p, const Tree& t) {
  const int node = w.node;
  const int n = t.n;
  if (node >= n - 1) {
    const float d2 = leaf_dist2(t, node - (n - 1), p);
    ++w.tri_tests;
    touch(1, n, node);
    // NaN-propagating, as the plain version's amin and minimum
    if (d2 < w.best || d2 != d2) w.best = d2;
  } else {
    const Children c = read_children<kRecords>(t, node);
    const int left = c.left;
    const int right = c.right;
    const float dl = box_dist2(c.lbox, p);
    const float dr = box_dist2(c.rbox, p);
    w.box_tests += 2;
    touch(1, n, node);
    touch(0, n, left);
    touch(0, n, right);
    const bool in_l = dl <= w.best;
    const bool in_r = dr <= w.best;
    if (in_l && in_r) {
      const bool l_first = dl <= dr;
      if (w.top - w.base == kStack) {
        w.full = true;
        return false;
      }
      w.stack[w.top++ % kStack] = l_first ? Entry{right, dr} : Entry{left, dl};
      w.node = l_first ? left : right;
      return true;
    }
    if (in_l || in_r) {
      w.node = in_l ? left : right;
      return true;
    }
  }
  while (w.top != w.base) {
    const Entry e = w.stack[--w.top % kStack];
    if (e.key <= w.best) {
      w.node = e.node;
      return true;
    }
  }
  return false;
}

// Pass 1: one thread a point, from the root, until done or `budget` box
// tests are spent.  A point not done joins the queue (queue[2q] its index,
// queue[2q + 1] its best's bits; state[1] the queue's length) and pass 2
// writes its distance.  With no budget this is the one-thread design.
__global__ void __launch_bounds__(kQueryThreads)
    closest_kernel(const Tree t, const float* __restrict__ points, int count,
                   unsigned budget, float* __restrict__ out_d2,
                   int* __restrict__ queue, int* state) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= count) return;
  const V3 p = load3(points + 3 * static_cast<long long>(r));
  Walk w;
  w.base = w.top = 0;
  w.node = 0;  // the root: internal node 0, or leaf 0 of a 1-triangle mesh
  w.best = INFINITY;
  w.box_tests = w.tri_tests = 0;
  w.full = false;
  bool alive = true;
  while (alive && w.box_tests < budget) alive = closest_visit(w, p, t);
  count_tests(r, w.box_tests, w.tri_tests);
  if (w.full) {
    state[0] = 1;
  } else if (alive) {
    const int q = atomicAdd(state + 1, 1);
    if (q >= count) {
      state[0] = 2;
      return;
    }
    queue[2 * q] = r;
    queue[2 * q + 1] = __float_as_int(w.best);
    return;
  }
  out_d2[r] = w.best;
}

// Pairs the warp's idle lanes with its lanes that hold stacked subtrees,
// the k-th with the k-th: each such holder hands over its bottom entry (the
// shallowest, so the largest), which the idle lane walks if its box is not
// beyond the best.  Every lane calls it.
__device__ __forceinline__ void donate(Walk& w, bool& alive, int lane) {
  const unsigned idle = __ballot_sync(kFull, !alive);
  const unsigned holders = __ballot_sync(kFull, w.top != w.base);
  const int pairs = min(__popc(idle), __popc(holders));
  if (pairs == 0) return;
  const unsigned below = (1u << lane) - 1u;
  const Entry bottom = w.stack[w.base % kStack];
  if (((holders >> lane) & 1u) && __popc(holders & below) < pairs) ++w.base;
  const int rank = __popc(idle & below);
  unsigned from = holders;  // the holder of this lane's rank
  for (int k = 0; k < rank && from; ++k) from &= from - 1u;
  const int src = from ? __ffs(from) - 1 : 0;
  const int node = __shfl_sync(kFull, bottom.node, src);
  const float key = __shfl_sync(kFull, bottom.key, src);
  if (!alive && rank < pairs && key <= w.best) {
    w.node = node;
    alive = true;
  }
}

// The breadth-first start of pass 2, by one warp: from the root, every
// internal node of the frontier replaced by its children whose boxes are not
// beyond the best (a leaf kept), until the frontier holds at least
// kPointLanes subtrees or no internal node.  buf[0] and buf[1] take turns;
// returns (the frontier's buffer << 16) | its size.  Every lane calls it.
__device__ __forceinline__ int expand(Walk& w, V3 p, const Tree& t,
                                      Entry (*buf)[kFrontier], int lane) {
  const int n = t.n;
  const unsigned below = (1u << lane) - 1u;
  int cur = 0, total = 1;
  if (lane == 0) buf[0][0] = Entry{0, 0.0f};
  __syncwarp();
  while (total < kPointLanes) {
    int size = 0;
    unsigned expanded = 0;
    for (int j = 0; j < kFrontier / 32; ++j) {
      const int m = lane + 32 * j;
      Entry e{0, 0.0f}, e2{0, 0.0f};
      int outs = 0;
      bool internal = false;
      if (m < total) {
        e = buf[cur][m];
        outs = 1;
        internal = e.node < n - 1;
        if (internal) {
          const Children c = read_children<kRecords>(t, e.node);
          const float dl = box_dist2(c.lbox, p);
          const float dr = box_dist2(c.rbox, p);
          w.box_tests += 2;
          touch(1, n, e.node);
          touch(0, n, c.left);
          touch(0, n, c.right);
          const bool in_l = dl <= w.best;
          const bool in_r = dr <= w.best;
          outs = in_l + in_r;
          e = in_l ? Entry{c.left, dl} : Entry{c.right, dr};
          e2 = Entry{c.right, dr};
        }
      }
      expanded |= __ballot_sync(kFull, internal);
      const unsigned one = __ballot_sync(kFull, outs >= 1);
      const unsigned two = __ballot_sync(kFull, outs == 2);
      const int at = size + __popc(one & below) + __popc(two & below);
      if (outs >= 1) buf[cur ^ 1][at] = e;
      if (outs == 2) buf[cur ^ 1][at + 1] = e2;
      size += __popc(one) + __popc(two);
    }
    __syncwarp();
    if (!expanded) break;
    cur ^= 1;
    total = size;
  }
  return (cur << 16) | total;
}

// Pass 2: a block of kPointWarps warps a queued point, blocks striding over
// the queue, whose length it reads here.  The first warp expands the tree;
// thread g takes subtrees g and g + kPointLanes.  Each warp shares its best
// by __reduce_min_sync and, across the block, by atomicMin on the bits in
// shared memory; a NaN sets a flag there that ends every warp.
__global__ void __launch_bounds__(kPointLanes)
    closest_warp_kernel(const Tree t, const float* __restrict__ points,
                        float* __restrict__ out_d2,
                        const int* __restrict__ queue, int* state) {
  __shared__ Entry frontier[2][kFrontier];
  __shared__ int frontier_made;
  __shared__ unsigned best_bits;
  __shared__ int nan_seen;
  __shared__ float nan_value;
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x;
  const int queued = state[1];
  for (int q = blockIdx.x; q < queued; q += gridDim.x) {
    const int r = queue[2 * q];
    const V3 p = load3(points + 3 * static_cast<long long>(r));
    Walk w;
    w.base = w.top = 0;
    w.best = __int_as_float(queue[2 * q + 1]);
    w.box_tests = w.tri_tests = 0;
    w.full = false;
    if (g < 32) {
      const int made = expand(w, p, t, frontier, lane);
      if (lane == 0) {
        frontier_made = made;
        best_bits = __float_as_uint(w.best);
        nan_seen = 0;
      }
    }
    __syncthreads();
    const Entry* f = frontier[frontier_made >> 16];
    const int total = frontier_made & 0xffff;
    bool alive = g < total;
    if (alive) w.node = f[g].node;
    if (g + kPointLanes < total) w.stack[w.top++] = f[g + kPointLanes];
    while (true) {
      for (int v = 0; alive && v < kSyncVisits; ++v)
        alive = closest_visit(w, p, t);
      const unsigned nan = __ballot_sync(kFull, w.best != w.best);
      if (nan) {
        if (lane == __ffs(nan) - 1) {
          nan_value = w.best;
          cuda::atomic_ref<int, cuda::thread_scope_block>(nan_seen).store(
              1, cuda::std::memory_order_relaxed);
        }
        break;
      }
      unsigned bits = __reduce_min_sync(kFull, __float_as_uint(w.best));
      int stop = 0;
      if (lane == 0) {
        bits = min(bits, atomicMin(&best_bits, bits));
        stop = cuda::atomic_ref<int, cuda::thread_scope_block>(nan_seen).load(
            cuda::std::memory_order_relaxed);
      }
      if (__shfl_sync(kFull, stop, 0)) break;
      w.best = __uint_as_float(__shfl_sync(kFull, bits, 0));
      if (kDonate) donate(w, alive, lane);
      if (!__ballot_sync(kFull, alive)) break;
    }
    __syncthreads();
    if (g == 0) out_d2[r] = nan_seen ? nan_value : __uint_as_float(best_bits);
    if (w.full) state[0] = 1;
    add_tests(r, w.box_tests, w.tri_tests);
  }
}

int blocks(long long n, int threads) {
  return static_cast<int>((n + threads - 1) / threads);
}

// bvh_hierarchy's pass 2 blocks: a warp for each node that can have more
// than kWarpSpan keys (at most 2 n / kWarpSpan of them), at most the card's
// resident blocks
int hierarchy_warp_blocks(int n) {
  static int resident = 0;
  if (resident == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hierarchy_warp_kernel,
                                                  kBuildThreads, 0);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long warps = 2LL * n / kWarpSpan + 1;
  const int wanted = blocks(warps, kBuildThreads / 32);
  return wanted < resident ? wanted : resident;
}

// pass 2's blocks: one a point, at most the card's resident blocks
int point_blocks(int count) {
  static int resident = 0;
  if (resident == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, closest_warp_kernel,
                                                  kPointLanes, 0);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  return count < resident ? count : resident;
}

template <bool kCount>
void launch_rays(const Tree& t, const int* order, const float* rays_o,
                 const float* rays_d, int d_stride, int rays, float* out_t,
                 int* out_id, int* overflow, cudaStream_t stream) {
  if constexpr (!kRayDesign) {
    ray_one_thread_kernel<kCount><<<blocks(rays, kQueryThreads), kQueryThreads,
                                    0, stream>>>(
        t.boxes, t.children, t.tris, order, t.n, rays_o, rays_d, d_stride, rays,
        out_t, out_id, overflow);
  } else {
    ray_kernel<kCount, kRayLanes><<<blocks(static_cast<long long>(rays) *
                                               kRayLanes,
                                           kQueryThreads),
                                    kQueryThreads, 0, stream>>>(
        t, order, rays_o, rays_d, d_stride, rays, out_t, out_id, overflow);
  }
}

}  // namespace

extern "C" {

// children [n-1, 2] int32, parents [2n-1] int32 (the root's, -1, set by the
// caller) and far [n-1] int32 (each internal node's far end j) of n >= 2
// sorted unique keys: pass 1, then pass 2 on the nodes it queued (the first
// design: one kernel).  queue [n] int32 scratch: [0] the queue's length,
// zeroed here, then the queued nodes (untouched by the first design).
int bvh_hierarchy_launch(const void* keys, int n, void* children, void* parents,
                         void* far, void* queue, cudaStream_t stream) {
  const long long* k = static_cast<const long long*>(keys);
  int* c = static_cast<int*>(children);
  int* p = static_cast<int*>(parents);
  int* f = static_cast<int*>(far);
  if (!kWarpSearch) {
    hierarchy_one_thread_kernel<<<blocks(n - 1, kBuildThreads), kBuildThreads,
                                  0, stream>>>(k, n, c, p, f);
    return static_cast<int>(cudaGetLastError());
  }
  int* q = static_cast<int*>(queue);
  cudaError_t rc = cudaMemsetAsync(q, 0, sizeof(int), stream);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  hierarchy_kernel<<<blocks(n - 1, kBuildThreads), kBuildThreads, 0, stream>>>(
      k, n, c, p, f, q + 1, q);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  hierarchy_warp_kernel<<<hierarchy_warp_blocks(n), kBuildThreads, 0, stream>>>(
      k, n, c, p, f, q + 1, q);
  return static_cast<int>(cudaGetLastError());
}

// boxes [2n-1, 6] f32 (lo xyz, hi xyz) of the tree over tris [n, 9] f32 in
// leaf order, with records [n-1, 16] f32 and tris_padded [n, 12] f32 (but in
// the first design); arrivals [max(n-1, 1)] int32 zeroed by the caller
int bvh_refit_launch(const void* tris, const void* parents, const void* children,
                     const void* far, int n, float pad, void* arrivals,
                     void* boxes, void* records, void* tris_padded,
                     cudaStream_t stream) {
  refit_kernel<<<blocks(n, kBuildThreads), kBuildThreads, 0, stream>>>(
      static_cast<const float*>(tris), static_cast<const int*>(parents),
      static_cast<const int*>(children), static_cast<const int*>(far), n, pad,
      static_cast<int*>(arrivals), static_cast<float*>(boxes),
      static_cast<float4*>(records), static_cast<float4*>(tris_padded));
  return static_cast<int>(cudaGetLastError());
}

// first hits (out_t f32, out_id int32 face id, -1 and +inf on a miss), or in
// count mode the crossings in out_id, of the tree's boxes, children,
// triangles, node records and padded triangles (the first design reads the
// first three, the design the last two); *overflow (zeroed by the caller)
// set if a stack overflowed
int bvh_ray_launch(const void* boxes, const void* children, const void* tris,
                   const void* records, const void* tris_padded,
                   const void* order, int n, const void* rays_o,
                   const void* rays_d, int d_stride, int rays, int count_mode,
                   void* out_t, void* out_id, void* overflow,
                   cudaStream_t stream) {
  const Tree t{static_cast<const float*>(boxes),
               static_cast<const int*>(children),
               static_cast<const float*>(tris),
               static_cast<const float4*>(records),
               static_cast<const float4*>(tris_padded), n};
  const int* ids = static_cast<const int*>(order);
  const float* o = static_cast<const float*>(rays_o);
  const float* d = static_cast<const float*>(rays_d);
  if (count_mode)
    launch_rays<true>(t, ids, o, d, d_stride, rays, static_cast<float*>(out_t),
                      static_cast<int*>(out_id), static_cast<int*>(overflow),
                      stream);
  else
    launch_rays<false>(t, ids, o, d, d_stride, rays, static_cast<float*>(out_t),
                       static_cast<int*>(out_id), static_cast<int*>(overflow),
                       stream);
  return static_cast<int>(cudaGetLastError());
}

// the least squared distance out_d2 [count] f32 from each point: pass 1,
// then (but in the one-thread design) pass 2 on the points it queued.
// state [2] int32: [0] set if a stack (1) or the queue (2) overflowed,
// zeroed by the caller; [1] the queue's length, zeroed here.  queue [count,
// 2] int32 scratch.
int bvh_closest_launch(const void* boxes, const void* children, const void* tris,
                       const void* records, const void* tris_padded, int n,
                       const void* points, int count, void* out_d2,
                       void* state, void* queue, cudaStream_t stream) {
  int* flags = static_cast<int*>(state);
  cudaError_t rc = cudaMemsetAsync(flags + 1, 0, sizeof(int), stream);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const Tree t{static_cast<const float*>(boxes),
               static_cast<const int*>(children),
               static_cast<const float*>(tris),
               static_cast<const float4*>(records),
               static_cast<const float4*>(tris_padded), n};
  closest_kernel<<<blocks(count, kQueryThreads), kQueryThreads, 0, stream>>>(
      t, static_cast<const float*>(points), count, kClosestBudget,
      static_cast<float*>(out_d2), static_cast<int*>(queue), flags);
  if (kTwoPass) {
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
    closest_warp_kernel<<<point_blocks(count), kPointLanes, 0, stream>>>(
        t, static_cast<const float*>(points), static_cast<float*>(out_d2),
        static_cast<const int*>(queue), flags);
  }
  return static_cast<int>(cudaGetLastError());
}

#ifdef BVH_COUNT_VISITS
// the device buffers the next query launches mark and fill (see g_touched,
// g_query_tests; null turns either off)
int bvh_count_buffers(void* touched, void* query_tests) {
  cudaError_t rc = cudaMemcpyToSymbol(g_touched, &touched, sizeof(touched));
  if (rc == cudaSuccess)
    rc = cudaMemcpyToSymbol(g_query_tests, &query_tests, sizeof(query_tests));
  return static_cast<int>(rc);
}

// the box tests and triangle tests since the last call into out[2], then
// zeroes them
int bvh_visit_counts(unsigned long long* out) {
  cudaError_t rc = cudaDeviceSynchronize();
  if (rc == cudaSuccess) rc = cudaMemcpyFromSymbol(out, g_visits, sizeof(g_visits));
  const unsigned long long zero[2] = {0, 0};
  if (rc == cudaSuccess) rc = cudaMemcpyToSymbol(g_visits, zero, sizeof(zero));
  return static_cast<int>(rc);
}
#endif

}  // extern "C"
