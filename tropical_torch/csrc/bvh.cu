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
// n - 1 + k; a mesh of one triangle is its root leaf.
//   - bvh_hierarchy: one thread an internal node.  Its range's direction
//     from the sign of delta, its far end by an exponential then a binary
//     search, the split by a binary search on __clzll of the XOR of keys;
//     writes the children and the parents.
//   - bvh_refit: one thread a leaf.  The leaf box from its triangle's
//     vertices, widened by `pad` a face; then up the tree, with an arrival
//     counter on each internal node: the second thread to arrive merges the
//     two child boxes.  Min and max are exact (and propagate a NaN, as the
//     plain version's do), so the boxes are bitwise the same in any order
//     of arrival.
//
// Queries: one thread a ray or a point, a stack of at most kStack far
// children, the nearer child first.
//   - bvh_ray: the first hit of each ray, the lexicographic least (t, face
//     id) over the triangles that Moller-Trumbore hits (the plain tiles'
//     `min` takes the first, lowest, id on an equal t); or, in count mode,
//     how many triangles the ray crosses (the parity ray of a signed
//     distance), which visits every box the ray meets.
//   - bvh_closest: the least squared distance from each point to a triangle
//     (Ericson's closest point).
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
// greater than the best so far.  A stack overflow sets *overflow, which the
// wrapper raises on; no node is ever dropped.
//
// What bounds it on this card: the traversal is latency-bound pointer
// chasing (a node's box, then its children), some tens of box tests and a
// few triangle tests a ray; the bound chip_smoke.py states counts those
// tests at the f32 rate and, once each, the bytes of the inputs, the
// outputs and the boxes, children, triangles and face ids that the queries
// read (an instrumented build, -DBVH_COUNT_VISITS, counts and marks them).
// This first design keeps one box a node and reads the children's boxes on
// a visit; a later one may keep both child boxes in the parent (one 64-byte
// line a visit).

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kStack = 64;
constexpr int kBuildThreads = 256;
constexpr int kQueryThreads = 128;
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

__global__ void __launch_bounds__(kBuildThreads)
    hierarchy_kernel(const long long* __restrict__ keys, int n,
                     int* __restrict__ children, int* __restrict__ parents) {
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
  const long long split = i + s * d + (d < 0 ? -1 : 0);
  const long long first = i < j ? i : j;
  const long long last = i < j ? j : i;
  const int left = static_cast<int>(first == split ? n - 1 + split : split);
  const int right =
      static_cast<int>(last == split + 1 ? n - 1 + split + 1 : split + 1);
  children[2 * i] = left;
  children[2 * i + 1] = right;
  parents[left] = i;
  parents[right] = i;
}

__global__ void __launch_bounds__(kBuildThreads)
    refit_kernel(const float* __restrict__ tris, const int* __restrict__ parents,
                 const int* __restrict__ children, int n, float pad,
                 int* arrivals, float* boxes) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const float* v = tris + 9 * static_cast<long long>(k);
  int node = n - 1 + k;
  float* b = boxes + 6 * static_cast<long long>(node);
  for (int a = 0; a < 3; ++a) {
    b[a] = __fsub_rn(nan_min(nan_min(v[a], v[3 + a]), v[6 + a]), pad);
    b[3 + a] = __fadd_rn(nan_max(nan_max(v[a], v[3 + a]), v[6 + a]), pad);
  }
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

// ---- the pair tests, in the plain version's order ---------------------------

// Moller-Trumbore: the hit's t, or +inf (mesh_queries._ray_tri_t)
__device__ __forceinline__ float ray_tri_t(V3 o, V3 d, const float* tri) {
  const V3 a = load3(tri), b = load3(tri + 3), c = load3(tri + 6);
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
__device__ __forceinline__ float closest_dist2(V3 p, const float* tri) {
  const V3 a = load3(tri), b = load3(tri + 3), c = load3(tri + 6);
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
  if (d1 <= 0.0f && d2 <= 0.0f) {
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
// component and the origin on the box's face) opens the slab
__device__ __forceinline__ void slab_axis(float lo, float hi, float o, float inv,
                                          float& near, float& far) {
  const float t0 = __fmul_rn(__fsub_rn(lo, o), inv);
  const float t1 = __fmul_rn(__fsub_rn(hi, o), inv);
  near = fminf(t0 != t0 ? -INFINITY : t0, t1 != t1 ? -INFINITY : t1);
  far = fmaxf(t0 != t0 ? INFINITY : t0, t1 != t1 ? INFINITY : t1);
}

// the conservative entry t of the ray into the box, or +inf on a miss
__device__ __forceinline__ float box_entry(const float* box, V3 o, V3 inv) {
  float nx, fx, ny, fy, nz, fz;
  slab_axis(box[0], box[3], o.x, inv.x, nx, fx);
  slab_axis(box[1], box[4], o.y, inv.y, ny, fy);
  slab_axis(box[2], box[5], o.z, inv.z, nz, fz);
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

struct Entry {
  int node;
  float key;  // the node's entry t, or its box's squared distance
};

// kCount: count every crossing (no culling by the best hit); else the first
// hit.  d_stride 0 gives every ray the one direction d[0..2].
template <bool kCount>
__global__ void __launch_bounds__(kQueryThreads)
    ray_kernel(const float* __restrict__ boxes, const int* __restrict__ children,
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
      const float t = ray_tri_t(o, d, tris + 9 * static_cast<long long>(k));
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

__global__ void __launch_bounds__(kQueryThreads)
    closest_kernel(const float* __restrict__ boxes,
                   const int* __restrict__ children,
                   const float* __restrict__ tris, int n,
                   const float* __restrict__ points, int count,
                   float* __restrict__ out_d2, int* overflow) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= count) return;
  const V3 p = load3(points + 3 * static_cast<long long>(r));
  float best = INFINITY;
  unsigned box_tests = 0, tri_tests = 0;
  Entry stack[kStack];
  int sp = 0;
  int node = 0;
  bool full = false;
  while (true) {
    if (node >= n - 1) {
      const float d2 = closest_dist2(
          p, tris + 9 * static_cast<long long>(node - (n - 1)));
      ++tri_tests;
      touch(1, n, node);
      // NaN-propagating, as the plain version's amin and minimum
      if (d2 < best || d2 != d2) best = d2;
    } else {
      const int left = children[2 * node];
      const int right = children[2 * node + 1];
      const float dl = box_dist2(boxes + 6 * static_cast<long long>(left), p);
      const float dr = box_dist2(boxes + 6 * static_cast<long long>(right), p);
      box_tests += 2;
      touch(1, n, node);
      touch(0, n, left);
      touch(0, n, right);
      const bool in_l = dl <= best;
      const bool in_r = dr <= best;
      if (in_l && in_r) {
        const bool l_first = dl <= dr;
        if (sp == kStack) {
          full = true;
          break;
        }
        stack[sp++] = l_first ? Entry{right, dr} : Entry{left, dl};
        node = l_first ? left : right;
        continue;
      }
      if (in_l || in_r) {
        node = in_l ? left : right;
        continue;
      }
    }
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
  out_d2[r] = best;
  count_tests(r, box_tests, tri_tests);
}

int blocks(long long n, int threads) {
  return static_cast<int>((n + threads - 1) / threads);
}

}  // namespace

extern "C" {

// children [n-1, 2] int32, parents [2n-1] int32 (the root's, -1, set by the
// caller) of n >= 2 sorted unique keys
int bvh_hierarchy_launch(const void* keys, int n, void* children, void* parents,
                         cudaStream_t stream) {
  hierarchy_kernel<<<blocks(n - 1, kBuildThreads), kBuildThreads, 0, stream>>>(
      static_cast<const long long*>(keys), n, static_cast<int*>(children),
      static_cast<int*>(parents));
  return static_cast<int>(cudaGetLastError());
}

// boxes [2n-1, 6] f32 (lo xyz, hi xyz) of the tree over tris [n, 9] f32 in
// leaf order; arrivals [max(n-1, 1)] int32 zeroed by the caller
int bvh_refit_launch(const void* tris, const void* parents, const void* children,
                     int n, float pad, void* arrivals, void* boxes,
                     cudaStream_t stream) {
  refit_kernel<<<blocks(n, kBuildThreads), kBuildThreads, 0, stream>>>(
      static_cast<const float*>(tris), static_cast<const int*>(parents),
      static_cast<const int*>(children), n, pad, static_cast<int*>(arrivals),
      static_cast<float*>(boxes));
  return static_cast<int>(cudaGetLastError());
}

// first hits (out_t f32, out_id int32 face id, -1 and +inf on a miss), or in
// count mode the crossings in out_id; *overflow (zeroed by the caller) set
// if a stack overflowed
int bvh_ray_launch(const void* boxes, const void* children, const void* tris,
                   const void* order, int n, const void* rays_o,
                   const void* rays_d, int d_stride, int rays, int count_mode,
                   void* out_t, void* out_id, void* overflow,
                   cudaStream_t stream) {
  const int grid = blocks(rays, kQueryThreads);
  if (count_mode) {
    ray_kernel<true><<<grid, kQueryThreads, 0, stream>>>(
        static_cast<const float*>(boxes), static_cast<const int*>(children),
        static_cast<const float*>(tris), static_cast<const int*>(order), n,
        static_cast<const float*>(rays_o), static_cast<const float*>(rays_d),
        d_stride, rays, static_cast<float*>(out_t), static_cast<int*>(out_id),
        static_cast<int*>(overflow));
  } else {
    ray_kernel<false><<<grid, kQueryThreads, 0, stream>>>(
        static_cast<const float*>(boxes), static_cast<const int*>(children),
        static_cast<const float*>(tris), static_cast<const int*>(order), n,
        static_cast<const float*>(rays_o), static_cast<const float*>(rays_d),
        d_stride, rays, static_cast<float*>(out_t), static_cast<int*>(out_id),
        static_cast<int*>(overflow));
  }
  return static_cast<int>(cudaGetLastError());
}

// the least squared distance out_d2 [count] f32 from each point
int bvh_closest_launch(const void* boxes, const void* children, const void* tris,
                       int n, const void* points, int count, void* out_d2,
                       void* overflow, cudaStream_t stream) {
  closest_kernel<<<blocks(count, kQueryThreads), kQueryThreads, 0, stream>>>(
      static_cast<const float*>(boxes), static_cast<const int*>(children),
      static_cast<const float*>(tris), n, static_cast<const float*>(points),
      count, static_cast<float*>(out_d2), static_cast<int*>(overflow));
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
