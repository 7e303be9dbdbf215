// Multiresolution hash-grid encode (tiny-cuda-nn's grid semantics): its
// forward, its backward and the backward of its backward.
//
// Replaces the jitted XLA programs of tropical/core/hashgrid.py:163 (encode,
// with _encode_level :134 and _level_indices :112) and their jax.grad and
// grad-of-grad in tropical/stanford/training.py:42,65: the encode part of K1
// in ROADMAP.md.  The JAX package wrote no Pallas kernel for them; XLA fused
// each into a program.  In eager PyTorch the encode is some 500 small
// launches a forward and a training step some 2,500, so each of the three
// is one kernel here.
//
// Result: the forward and dx of the backward are bitwise the plain PyTorch
// versions in tropical_torch/core/hashgrid.py (encode_plain,
// encode_backward_plain), and so are d_dfeat and dx2 of the double backward
// (encode_double_backward_plain).  Every product and sum is one IEEE
// round-to-nearest operation (__fmul_rn, __fadd_rn, __fsub_rn, which nvcc
// never contracts to an FMA) in the plain version's order:
//   pos = x * s_l + 0.5 with s_l the level scale rounded to f32, two
//   roundings; frac = pos - floor(pos); w = (w_x * w_y) * w_z; the corners
//   summed 0..7 in order; the levels of dx summed 0..L-1 in order.
// The tables' gradients (dtable, dtable2) are atomic scatters, whose order
// of adds is free: they hold to a tolerance.
//
// Indices: the dense index gx + gy r + gz r^2 of a level, taken modulo the
// level's entry count with a non-negative result (torch.remainder), or the
// hash (gx * 1) ^ (gy * 2654435761) ^ (gz * 805459861) in uint32 with
// wraparound, masked to 2^T - 1; then the level's offset is added and the
// row clamped to the table, as the plain version does (the forward factors
// both per level: level_rows_of).
//
// Forward (fwd_kernel): K lanes a (point, level), the levels of a point on
// neighbouring lane groups (G of them, G the power of two at or above L, so
// a point never straddles a warp); K = 4 where 4 lanes a pair keep the
// launch within one wave of resident threads, else 1 (fwd_lanes).  What
// bounds it, and what the design does about it:
//   - a training batch (B = 1,000: 4,000 (point, level) pairs) fills a
//     tenth of the card, so a thread's serial chain is the time: the chain
//     starts at the load of x (the level rows are kernel parameters, not a
//     load from device memory), takes one integer remainder a (point,
//     level) instead of one a corner (the card has no integer divider: a
//     64-bit remainder is a call to a software routine, a 32-bit one some
//     ten instructions, and the one remainder is 32-bit where the base
//     fits), and 4 lanes split the 8 corners' gathers; shuffles of the
//     whole warp bring the products to the first lane in corner order;
//   - at the flat run's 278,528 points (1.1 M pairs) the card is full and
//     the instructions and the L1's scattered 8-byte gathers are the time:
//     one lane a pair, so no work is repeated across lanes.
// Stores are one float2 a (point, level), a warp's a contiguous run.
//
// Backwards (bwd_kernel, bwd_bwd_kernel): one lane per (point, level,
// corner).  A point takes P = 8 min(G, 4) lanes (at 4 levels a warp is one
// point); a point of more than 4 levels takes its levels in passes of 4, in
// order.  Each lane computes its corner's row, weights and terms; shuffles
// bring a level's 8 corner terms to every lane of the level in corner order
// 0..7 and the levels' sums in level order, so every sum is the plain
// version's.  The table gradients:
//   - the coarse levels' rows [0, private_rows) (the host's plan,
//     core/hashgrid.py:private_levels) are summed in a block-private copy in
//     shared memory with shared-memory atomics, and flushed once per block,
//     a row only where it is non-zero, by one float2 atomicAdd a row;
//   - the finer levels' rows take one float2 atomicAdd a corner (sm_90's
//     vector atomic) to device memory;
//   - lanes of a warp that hit one row add their terms first (match_any),
//     and one of them makes the atomic.
// The grid is at most one wave of resident blocks, and each warp walks over
// points in a grid-stride loop, so a block flushes its private rows once
// for many points.
//
// Bound.  A forward reads a point (12 bytes) and writes 8 bytes a level, and
// must read each table row its corners reach once: the table (281 KB for
// sphere-small) stays in the 50 MB L2, so the corners' further gathers of a
// row are not HBM traffic.  At a batch the bound (0.03 us) is far below a
// launch's own cost on the card; chip_smoke.py prints a CUDA graph's cost of
// a node beside it.  The backwards also read 8 bytes a level of the
// feature gradient and write the table gradient whole; they bound by bytes
// at a batch and by their 150 and 250 unfused operations a (point, level) at
// the flat run's 278,528 rows.  chip_smoke.py counts each kernel's bytes and
// operations.  What each design buys, step by step, is measured by
// scripts/hashgrid_encode_variants.py, which builds this file with
//   -DHASHGRID_ENCODE_FWD_LANES=1, 2, 4, 8   the forward's lanes fixed
//   -DHASHGRID_ENCODE_FWD_EIGHT_REMAINDERS   a 64-bit remainder a corner
//   -DHASHGRID_ENCODE_FWD_WIDE               the one remainder in 64 bits
//   -DHASHGRID_ENCODE_FWD_DEVICE_ROWS        level rows from device memory
//   -DHASHGRID_ENCODE_CORNER_LANES=1   one thread a (point, level) in the
//                                      backwards (their first design)
//   -DHASHGRID_ENCODE_NO_PRIVATE       every row to device-memory atomics
//   -DHASHGRID_ENCODE_SCALAR_ATOMICS   two scalar atomicAdds for a float2
// and the times are in PERF.md.

#include <cuda_runtime.h>

#include <climits>
#include <cstring>

#ifndef HASHGRID_ENCODE_CORNER_LANES
#define HASHGRID_ENCODE_CORNER_LANES 8
#endif
// lanes a (point, level) in the forward: 0 chooses them from the batch
// (fwd_lanes), 1, 2, 4 or 8 fixes them (an ablation)
#ifndef HASHGRID_ENCODE_FWD_LANES
#define HASHGRID_ENCODE_FWD_LANES 0
#endif

// A spec's launch constants, kept on the host by core/hashgrid.py:_Plan
// (same layout) and passed by pointer (outside the unnamed namespace: the
// extern "C" functions that take it keep external linkage).
struct HashgridEncodePlan {
  const void* rows;       // LevelRow [levels] on the device
  int levels;
  int group;              // a power of two >= levels, <= 32
  int n_rows;
  unsigned hash_mask;     // 2^T - 1
  int private_rows;       // the backwards' rows reduced in shared memory
  int blocks_bwd;         // one wave of resident blocks of each backward,
  int blocks_bwd_bwd;     // set by hashgrid_encode_configure
  int fwd_wave;           // resident forward threads of the card, set there
  int level_rows[32 * 5]; // LevelRow [levels] on the host
};

namespace {

using Plan = HashgridEncodePlan;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxLevels = 32;
// lanes a (point, level) in the backwards, and the corners each lane takes
constexpr int kCornerLanes = HASHGRID_ENCODE_CORNER_LANES;
constexpr int kCornersPerLane = 8 / kCornerLanes;
static_assert(kCornerLanes == 1 || kCornerLanes == 2 || kCornerLanes == 4 ||
                  kCornerLanes == 8,
              "HASHGRID_ENCODE_CORNER_LANES must be 1, 2, 4 or 8");
// the private rows' budget (core/hashgrid.py:PRIVATE_BYTES), and a warp's
// scratch of 32 float2 for the same-row pre-sums
constexpr int kPrivateBytes = 80 * 1024;
constexpr int kScratchBytes = kThreads * 8;
constexpr int kMaxSharedBytes = kPrivateBytes + kScratchBytes;

// One level's constants, as tropical_torch/core/hashgrid.py:_level_rows
// writes them (the plan's level_rows on the host).
struct LevelRow {
  float scale;   // s_l rounded to f32
  int offset;    // the level's first table row
  int entries;   // the level's table rows
  int res;       // the level's resolution
  int hashed;    // 1 where the level hashes
};
static_assert(sizeof(LevelRow) == 5 * sizeof(int), "LevelRow is 5 words");

struct Grid {
  const float* x;          // [n, 3]
  const float2* table;     // [n_rows, 2]
  const LevelRow* rows;    // [levels]
  int levels;
  int group;               // a power of two >= levels, <= 32
  int n_rows;
  unsigned hash_mask;      // 2^T - 1
  int n;
};

// The level's cell of the point: corner 0 and the fraction in the cell.
struct Cell {
  long long g[3];
  float f[3], lo[3];  // frac and 1 - frac
};

__device__ __forceinline__ Cell cell_of(const float* x, float s) {
  Cell c;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = __fadd_rn(__fmul_rn(x[d], s), 0.5f);
    const float fl = floorf(pos);
    c.g[d] = static_cast<long long>(fl);
    c.f[d] = __fsub_rn(pos, fl);
    c.lo[d] = __fsub_rn(1.0f, c.f[d]);
  }
  return c;
}

__device__ __forceinline__ long long corner_row(const Grid& g,
                                                const LevelRow& lr,
                                                long long gx, long long gy,
                                                long long gz) {
  long long idx;
  if (lr.hashed) {
    unsigned h = static_cast<unsigned>(gx);
    h ^= static_cast<unsigned>(gy) * 2654435761u;
    h ^= static_cast<unsigned>(gz) * 805459861u;
    idx = static_cast<long long>(h & g.hash_mask);
  } else {
    const long long r = lr.res;
    idx = (gx + gy * r + gz * (r * r)) % lr.entries;
    if (idx < 0) idx += lr.entries;
  }
  idx += lr.offset;
  return min(max(idx, 0LL), static_cast<long long>(g.n_rows) - 1);
}

// Corner c's row and per-axis weights (frac where bit d of c is set, else
// 1 - frac).
struct Corner {
  int row;
  float w[3];
};

__device__ __forceinline__ Corner corner_of(const Grid& g, const LevelRow& lr,
                                            const Cell& cl, int c) {
  Corner k;
  const int bx = c & 1, by = (c >> 1) & 1, bz = (c >> 2) & 1;
  k.row = static_cast<int>(
      corner_row(g, lr, cl.g[0] + bx, cl.g[1] + by, cl.g[2] + bz));
  k.w[0] = bx ? cl.f[0] : cl.lo[0];
  k.w[1] = by ? cl.f[1] : cl.lo[1];
  k.w[2] = bz ? cl.f[2] : cl.lo[2];
  return k;
}

__device__ __forceinline__ float neg_unless(float v, bool keep) {
  return keep ? v : -v;
}

// --- the forward -------------------------------------------------------------

// The forward's arguments, passed by value: the level rows live in the
// kernel's parameter space (the constant bank), so the head of a thread's
// chain is the load of x, not a load of its level's row.
struct FwdArgs {
  const float* x;          // [n, 3]
  const float2* table;     // [n_rows, 2]
  float2* feat;            // [n, levels]
  const LevelRow* rows;    // the plan's device copy (an ablation reads it)
  int n, levels, log2_group;
  unsigned hash_mask;
  LevelRow level[kMaxLevels];
};

__device__ __forceinline__ LevelRow level_row(const FwdArgs& a, int l) {
#ifdef HASHGRID_ENCODE_FWD_DEVICE_ROWS
  return a.rows[l];
#else
  return a.level[l];
#endif
}

// Table rows (within the level) of the lane's corners c = k J + j, j < J,
// for corner 0 at g.  Dense: the index V_c = g_x + g_y r + g_z r^2 + delta_c
// with delta_c = b_x + b_y r + b_z r^2 (b the corner's bits) is reduced
// modulo E with a non-negative result.  For a dense level E >= r^3 >
// delta_c (r >= 2; E >= 8 > 3 for r = 1), so with m = base mod E the row is
// m + delta_c, less E where that reaches E: one remainder for the 8
// corners, taken in 32 bits where the base fits in them.  A base within
// r^2 + r + 1 of the int64 limit (|x s_l| near 2^63 / r^2) would wrap
// between the corners: there each corner takes its own remainder of the
// wrapped V_c, as the plain version computes it.  Hashed: the six products
// of the axes' two coordinates with their primes, in uint32, then one XOR
// pair a corner.
template <int J>
__device__ __forceinline__ void level_rows_of(const FwdArgs& a,
                                              const LevelRow& lr,
                                              const long long (&g)[3], int k,
                                              unsigned (&row)[J]) {
  if (lr.hashed) {
    const unsigned hx = static_cast<unsigned>(g[0]);
    const unsigned hy = static_cast<unsigned>(g[1]) * 2654435761u;
    const unsigned hz = static_cast<unsigned>(g[2]) * 805459861u;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = k * J + j;
      row[j] = ((c & 1 ? hx + 1u : hx) ^ (c & 2 ? hy + 2654435761u : hy) ^
                (c & 4 ? hz + 805459861u : hz)) & a.hash_mask;
    }
    return;
  }
  const unsigned long long r = static_cast<unsigned>(lr.res);
  const unsigned long long ubase =
      static_cast<unsigned long long>(g[0]) +
      static_cast<unsigned long long>(g[1]) * r +
      static_cast<unsigned long long>(g[2]) * (r * r);
  const long long base = static_cast<long long>(ubase);
  const unsigned e = static_cast<unsigned>(lr.entries);
  unsigned delta[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = k * J + j;
    delta[j] = static_cast<unsigned>((c & 1) + (c & 2 ? r : 0) +
                                     (c & 4 ? r * r : 0));
  }
#ifndef HASHGRID_ENCODE_FWD_EIGHT_REMAINDERS
  if (base <= LLONG_MAX - static_cast<long long>(r * r + r + 1)) {
    unsigned m;
#ifndef HASHGRID_ENCODE_FWD_WIDE
    if (base >= INT_MIN && base <= INT_MAX) {
      const int q = static_cast<int>(base) % lr.entries;
      m = static_cast<unsigned>(q < 0 ? q + lr.entries : q);
    } else
#endif
    {
      const long long q = base % lr.entries;
      m = static_cast<unsigned>(q < 0 ? q + lr.entries : q);
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const unsigned v = m + delta[j];
      row[j] = v >= e ? v - e : v;
    }
    return;
  }
#endif
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const long long q = static_cast<long long>(ubase + delta[j]) % lr.entries;
    row[j] = static_cast<unsigned>(q < 0 ? q + lr.entries : q);
  }
}

// K lanes a (point, level), J = 8 / K corners a lane; the slots (point,
// level) of a point on neighbouring lane groups, G of them (the power of
// two at or above L).  Each lane computes the cell and its corners' rows,
// gathers their features and weights them; shuffles bring the 8 products
// to the slot's first lane in corner order 0..7, which sums them and
// writes the slot's float2: a warp's stores are one contiguous run.
// Rows need no clamp: a row within the level is below E, and the level's
// offset + E is at most the table's row count (the plain version's clamp
// never binds).
template <int K>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const __grid_constant__ FwdArgs a) {
  constexpr int J = 8 / K;
  const long long slot = static_cast<long long>(blockIdx.x) * (kThreads / K) +
                         threadIdx.x / K;
  const int k = threadIdx.x % K;
  const long long bw = slot >> a.log2_group;
  const int lw = static_cast<int>(slot & ((1 << a.log2_group) - 1));
  // a slot past the points or the levels computes the last one's and
  // stores nothing: every lane of a warp takes the shuffles, which then
  // need no partial-warp synchronisation
  const bool live = bw < a.n && lw < a.levels;
  const long long b = min(bw, static_cast<long long>(a.n) - 1);
  const int l = min(lw, a.levels - 1);
  const LevelRow lr = level_row(a, l);
  const Cell cl = cell_of(a.x + 3 * b, lr.scale);
  unsigned row[J];
  level_rows_of<J>(a, lr, cl.g, k, row);
  float2 p[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = k * J + j;
    const float w = __fmul_rn(__fmul_rn(c & 1 ? cl.f[0] : cl.lo[0],
                                        c & 2 ? cl.f[1] : cl.lo[1]),
                              c & 4 ? cl.f[2] : cl.lo[2]);
    const float2 v = __ldg(a.table + lr.offset + row[j]);
    p[j] = make_float2(__fmul_rn(w, v.x), __fmul_rn(w, v.y));
  }
  // corners 0..J-1 are the first lane's own; corner c >= J comes from
  // lane c / J of the slot
  float2 acc = p[0];
#pragma unroll
  for (int c = 1; c < 8; ++c) {
    float2 v = p[c % J];
    if (c >= J) {
      v.x = __shfl_sync(kFullMask, v.x, c / J, K);
      v.y = __shfl_sync(kFullMask, v.y, c / J, K);
    }
    acc = make_float2(__fadd_rn(acc.x, v.x), __fadd_rn(acc.y, v.y));
  }
  if (live && k == 0) a.feat[b * a.levels + l] = acc;
}

// --- the backwards ----------------------------------------------------------

// Levels a pass of a point in the backwards: min(group, 32 / corner lanes).
__host__ __device__ __forceinline__ int levels_per_pass(int group) {
  return group < 32 / kCornerLanes ? group : 32 / kCornerLanes;
}

// A lane's place in the backwards: its point (b, live_point), its level in
// the pass (li), its corner lane (k), the lanes of its point and level.
struct Lane {
  int lane, li, k;
  int point_base;   // the point's first lane in the warp
  int level_base;   // the (point, level)'s first lane
  int lp;           // levels a pass
  bool point_lead;  // the point's first lane
};

__device__ __forceinline__ Lane lane_of(const Grid& g) {
  Lane a;
  a.lane = threadIdx.x & 31;
  a.lp = levels_per_pass(g.group);
  const int pl = a.lp * kCornerLanes;
  a.point_base = a.lane & ~(pl - 1);
  a.li = (a.lane & (pl - 1)) / kCornerLanes;
  a.k = a.lane % kCornerLanes;
  a.level_base = a.point_base + a.li * kCornerLanes;
  a.point_lead = a.lane == a.point_base;
  return a;
}

// The 8 corner terms of the lane's level, t[j] its own corner k + K j's,
// summed in corner order 0..7 (the same value in every lane of the level).
__device__ __forceinline__ float corner_sum(const float (&t)[kCornersPerLane],
                                            const Lane& a) {
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float v;
    if constexpr (kCornerLanes == 1)
      v = t[c];
    else
      v = __shfl_sync(kFullMask, t[c / kCornerLanes],
                      a.level_base + c % kCornerLanes);
    acc = c == 0 ? v : __fadd_rn(acc, v);
  }
  return acc;
}

// Adds the pass's level values v (one a level group) to sum in level order;
// the levels before the pass are in sum already.
__device__ __forceinline__ float add_levels(const Grid& g, const Lane& a,
                                            int pass, float v, float sum) {
  for (int j = 0; j < a.lp; ++j) {
    const int l = pass * a.lp + j;
    if (l >= g.levels) break;  // uniform across the warp
    const float lv = __shfl_sync(kFullMask, v, a.point_base + j * kCornerLanes);
    sum = l == 0 ? lv : __fadd_rn(sum, lv);
  }
  return sum;
}

__device__ __forceinline__ void global_add(float2* p, float2 v) {
#ifdef HASHGRID_ENCODE_SCALAR_ATOMICS
  atomicAdd(&p->x, v.x);
  atomicAdd(&p->y, v.y);
#else
  atomicAdd(p, v);
#endif
}

// The table gradient's shared state of a block: its private rows and its
// warps' scratch.
struct Scatter {
  float2* table;      // [n_rows] in device memory, or null
  float2* priv;       // [private_rows] in shared memory
  float2* scratch;    // the warp's 32 float2
  int private_rows;
};

// Adds v to row (row < 0: nothing) of the table gradient.  Every lane of
// the warp calls it together.
__device__ __forceinline__ void scatter_add(const Scatter& s, int lane,
                                            int row, float2 v) {
  const unsigned peers = __match_any_sync(kFullMask, row);
  const int leader = __ffs(peers) - 1;
  if (__any_sync(kFullMask, row >= 0 && peers != (1u << lane))) {
    s.scratch[lane] = v;
    __syncwarp();
    if (row >= 0 && lane == leader) {
      for (unsigned m = peers & (peers - 1); m != 0; m &= m - 1) {
        const float2 o = s.scratch[__ffs(m) - 1];
        v.x += o.x;
        v.y += o.y;
      }
    }
    __syncwarp();
  }
  if (row < 0 || lane != leader) return;
  if (row < s.private_rows) {
    atomicAdd(&s.priv[row].x, v.x);
    atomicAdd(&s.priv[row].y, v.y);
  } else {
    global_add(s.table + row, v);
  }
}

__device__ __forceinline__ Scatter scatter_begin(float* table,
                                                 int private_rows) {
  extern __shared__ float2 smem[];
  Scatter s;
  s.table = reinterpret_cast<float2*>(table);
  s.private_rows = table != nullptr ? private_rows : 0;
  s.priv = smem;
  s.scratch = smem + s.private_rows + (threadIdx.x & ~31);
  for (int r = threadIdx.x; r < s.private_rows; r += kThreads)
    s.priv[r] = make_float2(0.0f, 0.0f);
  __syncthreads();
  return s;
}

__device__ __forceinline__ void scatter_end(const Scatter& s) {
  if (s.private_rows == 0) return;
  __syncthreads();
  for (int r = threadIdx.x; r < s.private_rows; r += kThreads) {
    const float2 v = s.priv[r];
    if (v.x != 0.0f || v.y != 0.0f) global_add(s.table + r, v);
  }
}

// The warps' points: warp w of the grid-stride loop takes points
// w P/32 ... (P points a warp, P = 32 / lanes a point).
__device__ __forceinline__ long long first_warp() {
  return static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
}

// dx [n, 3] and dtable [n_rows, 2] (zeroed by the caller), each skipped
// where null.
__global__ void __launch_bounds__(kThreads)
    bwd_kernel(Grid g, int private_rows, const float2* __restrict__ dfeat,
               float* __restrict__ dx, float* __restrict__ dtable) {
  const Scatter sc = scatter_begin(dtable, private_rows);
  const Lane a = lane_of(g);
  const int per_warp = 32 / (a.lp * kCornerLanes);
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long w = first_warp(); w * per_warp < g.n; w += stride) {
    const long long bw = w * per_warp + a.lane / (a.lp * kCornerLanes);
    const bool live_point = bw < g.n;
    const int b = static_cast<int>(min(bw, static_cast<long long>(g.n) - 1));
    float sum[3] = {0.0f, 0.0f, 0.0f};
    for (int pass = 0; pass * a.lp < g.levels; ++pass) {
      const int lw = pass * a.lp + a.li;
      const bool live = live_point && lw < g.levels;
      const int l = min(lw, g.levels - 1);
      const LevelRow lr = g.rows[l];
      const Cell cl = cell_of(g.x + 3LL * b, lr.scale);
      const float2 dl = dfeat[static_cast<long long>(b) * g.levels + l];
      float term[3][kCornersPerLane];
#pragma unroll
      for (int j = 0; j < kCornersPerLane; ++j) {
        const int c = a.k + kCornerLanes * j;
        const Corner k = corner_of(g, lr, cl, c);
        if (dtable != nullptr) {
          const float wt = __fmul_rn(__fmul_rn(k.w[0], k.w[1]), k.w[2]);
          scatter_add(sc, a.lane, live ? k.row : -1,
                      make_float2(__fmul_rn(wt, dl.x), __fmul_rn(wt, dl.y)));
        }
        if (dx != nullptr) {
          const float2 t = g.table[k.row];
          const float gc =
              __fadd_rn(__fmul_rn(dl.x, t.x), __fmul_rn(dl.y, t.y));
          const float p[3] = {__fmul_rn(k.w[1], k.w[2]),
                              __fmul_rn(k.w[0], k.w[2]),
                              __fmul_rn(k.w[0], k.w[1])};
#pragma unroll
          for (int d = 0; d < 3; ++d)
            term[d][j] = neg_unless(__fmul_rn(gc, p[d]), (c >> d) & 1);
        }
      }
      if (dx == nullptr) continue;
#pragma unroll
      for (int d = 0; d < 3; ++d)
        sum[d] = add_levels(g, a, pass,
                            __fmul_rn(corner_sum(term[d], a), lr.scale),
                            sum[d]);
    }
    if (dx != nullptr && live_point && a.point_lead) {
#pragma unroll
      for (int d = 0; d < 3; ++d) dx[3LL * b + d] = sum[d];
    }
  }
  scatter_end(sc);
}

// For the gradient ddx [n, 3] of dx: d_dfeat [n, 2L], dtable2 [n_rows, 2]
// (zeroed by the caller) and dx2 [n, 3], each skipped where null.
__global__ void __launch_bounds__(kThreads)
    bwd_bwd_kernel(Grid g, int private_rows, const float2* __restrict__ dfeat,
                   const float* __restrict__ ddx, float2* __restrict__ d_dfeat,
                   float* __restrict__ dtable2, float* __restrict__ dx2) {
  const Scatter sc = scatter_begin(dtable2, private_rows);
  const Lane a = lane_of(g);
  const int per_warp = 32 / (a.lp * kCornerLanes);
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  const bool gather = d_dfeat != nullptr || dx2 != nullptr;
  for (long long w = first_warp(); w * per_warp < g.n; w += stride) {
    const long long bw = w * per_warp + a.lane / (a.lp * kCornerLanes);
    const bool live_point = bw < g.n;
    const int b = static_cast<int>(min(bw, static_cast<long long>(g.n) - 1));
    float sum[3] = {0.0f, 0.0f, 0.0f};
    for (int pass = 0; pass * a.lp < g.levels; ++pass) {
      const int lw = pass * a.lp + a.li;
      const bool live = live_point && lw < g.levels;
      const int l = min(lw, g.levels - 1);
      const LevelRow lr = g.rows[l];
      const Cell cl = cell_of(g.x + 3LL * b, lr.scale);
      const long long pl = static_cast<long long>(b) * g.levels + l;
      const float2 dl = dfeat[pl];
      float u[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) u[d] = __fmul_rn(ddx[3LL * b + d], lr.scale);
      float dd[2][kCornersPerLane], hx[3][kCornersPerLane];
#pragma unroll
      for (int j = 0; j < kCornersPerLane; ++j) {
        const int c = a.k + kCornerLanes * j;
        const Corner k = corner_of(g, lr, cl, c);
        const bool bit[3] = {(c & 1) != 0, ((c >> 1) & 1) != 0,
                             ((c >> 2) & 1) != 0};
        const float p[3] = {__fmul_rn(k.w[1], k.w[2]),
                            __fmul_rn(k.w[0], k.w[2]),
                            __fmul_rn(k.w[0], k.w[1])};
        // a_c = grad(w_c) . u, axes in order
        float ac = neg_unless(__fmul_rn(p[0], u[0]), bit[0]);
        ac = __fadd_rn(ac, neg_unless(__fmul_rn(p[1], u[1]), bit[1]));
        ac = __fadd_rn(ac, neg_unless(__fmul_rn(p[2], u[2]), bit[2]));
        if (dtable2 != nullptr)
          scatter_add(sc, a.lane, live ? k.row : -1,
                      make_float2(__fmul_rn(ac, dl.x), __fmul_rn(ac, dl.y)));
        if (!gather) continue;
        const float2 t = g.table[k.row];
        dd[0][j] = __fmul_rn(ac, t.x);
        dd[1][j] = __fmul_rn(ac, t.y);
        if (dx2 != nullptr) {
          const float gc =
              __fadd_rn(__fmul_rn(dl.x, t.x), __fmul_rn(dl.y, t.y));
          // h_e = sum over d != e (in order) of the weight on the third
          // axis times u_d, minus where bits d and e differ
          const float h0 = __fadd_rn(
              neg_unless(__fmul_rn(k.w[2], u[1]), bit[1] == bit[0]),
              neg_unless(__fmul_rn(k.w[1], u[2]), bit[2] == bit[0]));
          const float h1 = __fadd_rn(
              neg_unless(__fmul_rn(k.w[2], u[0]), bit[0] == bit[1]),
              neg_unless(__fmul_rn(k.w[0], u[2]), bit[2] == bit[1]));
          const float h2 = __fadd_rn(
              neg_unless(__fmul_rn(k.w[1], u[0]), bit[0] == bit[2]),
              neg_unless(__fmul_rn(k.w[0], u[1]), bit[1] == bit[2]));
          hx[0][j] = __fmul_rn(gc, h0);
          hx[1][j] = __fmul_rn(gc, h1);
          hx[2][j] = __fmul_rn(gc, h2);
        }
      }
      if (d_dfeat != nullptr) {
        const float2 v = make_float2(corner_sum(dd[0], a), corner_sum(dd[1], a));
        if (live && a.k == 0) d_dfeat[pl] = v;
      }
      if (dx2 == nullptr) continue;
#pragma unroll
      for (int e = 0; e < 3; ++e)
        sum[e] = add_levels(g, a, pass,
                            __fmul_rn(corner_sum(hx[e], a), lr.scale),
                            sum[e]);
    }
    if (dx2 != nullptr && live_point && a.point_lead) {
#pragma unroll
      for (int e = 0; e < 3; ++e) dx2[3LL * b + e] = sum[e];
    }
  }
  scatter_end(sc);
}

// cudaErrorInvalidValue, without a launch, for arguments the kernels do not
// take; else 0.
int check(const Grid& g) {
  if (g.levels < 1 || g.group < g.levels || g.group > 32 ||
      (g.group & (g.group - 1)) != 0 || g.n_rows < 1 || g.n < 0 ||
      static_cast<long long>(g.n) * g.group > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

Grid make_grid(const Plan* p, const float* x, const float* table, int n) {
  return Grid{x, reinterpret_cast<const float2*>(table),
              static_cast<const LevelRow*>(p->rows), p->levels, p->group,
              p->n_rows, p->hash_mask, n};
}

int private_rows_of(const Plan* p) {
#ifdef HASHGRID_ENCODE_NO_PRIVATE
  (void)p;
  return 0;
#else
  return p->private_rows;
#endif
}

// Blocks of a backward launch: enough for every point, at most one wave.
int backward_blocks(const Grid& g, int wave) {
  const int per_block = kWarps * 32 /
                        (levels_per_pass(g.group) * kCornerLanes);
  const long long need = (static_cast<long long>(g.n) + per_block - 1) /
                         per_block;
  return static_cast<int>(need < wave ? need : wave);
}

// Zero-fills the table gradient on the stream; returns the dynamic shared
// memory of a backward launch.
int begin_scatter(const Plan* p, float* table_grad, cudaStream_t stream) {
  if (table_grad == nullptr) return 0;
  cudaMemsetAsync(table_grad, 0, static_cast<size_t>(p->n_rows) * 8, stream);
  return private_rows_of(p) * 8 + kScratchBytes;
}

// Lanes a (point, level) of a forward over `slots` (point, level) pairs: 4
// where their threads stay within one wave of resident threads, else 1.  (In
// the ablation 8 lanes were never faster than 4, nor 2 than the better of 4
// and 1.)
int fwd_lanes(long long slots, int wave) {
#if HASHGRID_ENCODE_FWD_LANES
  (void)slots;
  (void)wave;
  return HASHGRID_ENCODE_FWD_LANES;
#else
  return slots * 4 <= wave ? 4 : 1;
#endif
}

template <int K>
void launch_fwd(const FwdArgs& a, long long slots, cudaStream_t stream) {
  const long long blocks = (slots * K + kThreads - 1) / kThreads;
  fwd_kernel<K><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
}

template <typename Kernel>
int wave_of(Kernel kernel, int shared_bytes, int sms, int* wave) {
  int per_sm = 0;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kMaxSharedBytes);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                shared_bytes);
  *wave = per_sm * sms;
  return per_sm;
}

}  // namespace

// Each launch function takes the spec's plan, x [n, 3] and the table
// [n_rows, 2] (f32 on the device, contiguous, 8-byte aligned), launches on
// `stream` and returns the CUDA error of the launch, or 0.  n = 0 launches
// nothing.

// Fills the plan's waves of the backwards (and lets them take
// kMaxSharedBytes of dynamic shared memory) and the forward's resident
// threads on the current device; returns the CUDA error, or
// cudaErrorInvalidValue where the private rows exceed the budget or no block
// fits.
extern "C" int hashgrid_encode_configure(Plan* p) {
  if (p->private_rows < 0 || p->private_rows * 8 > kPrivateBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int shared = private_rows_of(p) * 8 + kScratchBytes;
  const int a = wave_of(bwd_kernel, shared, sms, &p->blocks_bwd);
  const int b = wave_of(bwd_bwd_kernel, shared, sms, &p->blocks_bwd_bwd);
  int fwd_per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fwd_per_sm, fwd_kernel<1>,
                                                kThreads, 0);
  p->fwd_wave = fwd_per_sm * kThreads * sms;
  if (const int rc = static_cast<int>(cudaGetLastError())) return rc;
  return a > 0 && b > 0 && fwd_per_sm > 0
             ? 0
             : static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int hashgrid_encode_fwd_launch(const Plan* p, const float* x,
                                          const float* table, int n,
                                          float* feat, cudaStream_t stream) {
  const Grid g = make_grid(p, x, table, n);
  if (const int rc = check(g)) return rc;
  if (p->fwd_wave < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  FwdArgs a{};
  a.x = x;
  a.table = g.table;
  a.feat = reinterpret_cast<float2*>(feat);
  a.rows = g.rows;
  a.n = n;
  a.levels = g.levels;
  while ((1 << a.log2_group) < g.group) ++a.log2_group;
  a.hash_mask = g.hash_mask;
  std::memcpy(a.level, p->level_rows, sizeof(LevelRow) * g.levels);
  const long long slots = static_cast<long long>(n) * g.group;
  switch (fwd_lanes(slots, p->fwd_wave)) {
    case 1: launch_fwd<1>(a, slots, stream); break;
    case 2: launch_fwd<2>(a, slots, stream); break;
    case 4: launch_fwd<4>(a, slots, stream); break;
    default: launch_fwd<8>(a, slots, stream); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// The lanes a (point, level) a forward over n points takes on this plan.
extern "C" int hashgrid_encode_fwd_lanes(const Plan* p, int n) {
  return fwd_lanes(static_cast<long long>(n) * p->group, p->fwd_wave);
}

extern "C" int hashgrid_encode_bwd_launch(const Plan* p, const float* x,
                                          const float* table, int n,
                                          const float* dfeat, float* dx,
                                          float* dtable, cudaStream_t stream) {
  const Grid g = make_grid(p, x, table, n);
  if (const int rc = check(g)) return rc;
  if (p->blocks_bwd < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || (dx == nullptr && dtable == nullptr))
    return static_cast<int>(cudaGetLastError());
  const int shared = begin_scatter(p, dtable, stream);
  bwd_kernel<<<backward_blocks(g, p->blocks_bwd), kThreads, shared, stream>>>(
      g, private_rows_of(p), reinterpret_cast<const float2*>(dfeat), dx,
      dtable);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hashgrid_encode_bwd_bwd_launch(
    const Plan* p, const float* x, const float* table, int n,
    const float* dfeat, const float* ddx, float* d_dfeat, float* dtable2,
    float* dx2, cudaStream_t stream) {
  const Grid g = make_grid(p, x, table, n);
  if (const int rc = check(g)) return rc;
  if (p->blocks_bwd_bwd < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || (d_dfeat == nullptr && dtable2 == nullptr && dx2 == nullptr))
    return static_cast<int>(cudaGetLastError());
  const int shared = begin_scatter(p, dtable2, stream);
  bwd_bwd_kernel<<<backward_blocks(g, p->blocks_bwd_bwd), kThreads, shared,
                   stream>>>(
      g, private_rows_of(p), reinterpret_cast<const float2*>(dfeat), ddx,
      reinterpret_cast<float2*>(d_dfeat), dtable2, dx2);
  return static_cast<int>(cudaGetLastError());
}
