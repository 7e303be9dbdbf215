// Nearest neighbour under squared Euclidean distance, for the chamfer metric.
//
// Replaces the Pallas TPU kernel tropical/ops/chamfer_tpu.py:min_dist_pallas
// (kernel body _min_dist_kernel), which took the argmin through the
// matrix-unit expansion |x|^2 + |y|^2 - 2 x.y and left the exact distance to a
// second pass.  Here the result is bitwise the plain PyTorch version's
// (tropical_torch/ops/chamfer.py:min_dist_plain): d2 = (dx*dx + dy*dy) + dz*dz
// with every step rounded, and the first index on an exact tie.  Inputs are
// finite.
//
// Bound: operations.  The plain direct difference costs 8 f32 operations per
// pair (3 sub, 3 mul, 2 add); at 100,000 x 100,000 points that is 8e10
// operations, 1.19 ms at the H100 SXM's 67 TFLOP/s f32 peak.  The bytes (12
// per point read, 8 per x row written) take about 1 us at 3.35 TB/s.  What
// limits a kernel here is instruction issue, so the design cuts the
// instructions per pair.
//
// Design: min_dist_launch enqueues six kernels on one stream, with no host
// synchronisation and no other library call.  The times below are for random
// sphere samples at 100k x 100k on an H100 80GB HBM3 at 700 W, from
// scripts/min_dist_variants.py, which builds this file with one step taken
// out: 1.94 ms as it is, 2.06 without the spatial order, 2.06 without the
// warm start, 2.58 without either.
//
// 1. pack_kernel writes yq[j] = (-2 y0, -2 y1, -2 y2, |y|^2) (the scale by
//    -2 is exact, so y = -0.5 * yq.xyz bit for bit), the largest |y|^2 as its
//    bits (non-negative floats order like their bits), each row's merge key
//    set to (inf, 0) (the plain version's answer when nothing is below inf),
//    and the bounding box of x.
// 2. cell_kernel, offsets_kernel and scatter_kernel: a counting sort of the
//    x rows, and of the y points, by their cell of a 32^3 grid over that box,
//    in Morton order.  The scan takes the rows in that order, so rows near in
//    space share a warp and take the exact path together (without the warm
//    start, the share of warp groups on the exact path falls from 24 % to
//    6 %, though only 0.5 % of row groups take it).
// 3. scan_kernel.  Each thread holds kRows x rows in registers, so one
//    broadcast 16-byte shared-memory load of a y point feeds kRows pairs.
//    Panels of yq arrive by bulk asynchronous copy (TMA, cp.async.bulk) into
//    two shared buffers, each with its own mbarrier: while the block scans
//    one panel the next is in flight.  The ragged last panel is copied and
//    scanned only as far as it goes; nothing is padded.
//    Warm start: a row's threshold starts from the exact distance to (up to
//    kWarm of) the y points of its own cell, an upper bound on its final
//    best, so few later points are walked (0.02 % of row groups and 2 % of
//    warp groups, against 0.5 % and 6 % from inf).  A row whose cell holds no
//    y point starts at inf, and then every pair up to its first hit is
//    walked.
//    Fast path: d' = fma(x0,q0, fma(x1,q1, fma(x2,q2, q3))) ~ d2 - |x|^2 costs
//    3 FFMA per pair; a running min over a group of kGroup points costs one
//    FMNMX per pair, and one compare per group and row against the row's
//    threshold thr.  A row whose group min is <= thr walks that group in
//    ascending j: each j with d'_j <= thr gets the exact direct difference
//    (__fmul_rn/__fadd_rn, no contraction), a strict '<' update of
//    (best, best_j), and then thr = min(thr, best - |x|^2 + margin).
//    What is left is the fast path itself: with the exact path cut to a
//    split's first panel it takes 1.86 ms, about 70 % of the issue rate that
//    its 4.3 instructions per pair allow.  An integer or three-way DPX min
//    in place of FMNMX was tried and gained little; other tilings (8 rows,
//    groups of 8: see the script) are slower.
// 4. unpack_kernel turns each row's merge key into d2 and idx.
//
// The filter is exact.  Let u = 2^-24, X = |x|, Y = |y_j| <= Ym (the largest
// norm of y), xx = fl(|x|^2), ny = fl(|y|^2) and d2_j the f32 direct
// difference.  Rounding bounds (gamma_k = k u / (1 - k u)):
//   |ny - Y^2|                    <= gamma_3 Y^2            (3 rounded steps)
//   |xx - X^2|                    <= gamma_3 X^2
//   |d'_j - (ny - 2 x.y)|         <= 3 u (1 + 4u) (Y^2 + 2 X Y)  (3 FMAs, each
//                                    partial bounded by ny + 2 X Y)
//   |d2_j - |x - y|^2|            <= gamma_5 |x - y|^2      (sub, mul, 2 adds)
// and |x - y|^2 = X^2 + Y^2 - 2 x.y exactly.  So for any b with d2_j <= b,
//   d'_j <= b - xx + 5.01 u b + 9.01 u (X + Ym)^2.
// The kernel's threshold for a bound b is thr = fma(b, 1 + 2^-20, fl(K - xx))
// with K = fma(fl(s * s), 2^-20, 2^-126), s = fl(sqrt(xx) + sqrt(fl(Ym^2))):
// that is b - xx + margin(x, b), margin = 16 u ((|x| + Ym)^2 + b) + 2^-126,
// the formula of expansion_margin() in tropical_torch/ops/chamfer.py.  Its own
// roundings (the square roots, s * s, K - xx, the final FMA; |thr| and |K - xx|
// are at most (X + Ym)^2 + b) lose at most 2.1 u b + 4.5 u (X + Ym)^2, and the
// 2^-126 term covers the absolute error of results that underflow.  So
// thr > b - xx + 13.9 u b + 11.4 u (X + Ym)^2, strictly above the bound on
// d'_j: every j with d2_j <= b passes.  The scan's b is the best so far or
// the warm bound, each at least the final best, so every j that attains the
// final best, ties included, reaches the exact update; a skipped j has d2_j
// above the final best.  With the strict '<' over ascending j, the filtered
// scan returns exactly the plain (d2, idx).
//
// Split-y grid with an exact merge: the grid is (x blocks, splits), chosen by
// the wrapper so that the card's SMs get equal shares even for a few x blocks.
// Each split scans its own contiguous range of j in ascending order and merges
// its (best, best_j) by a 64-bit atomicMin on (float_bits(best) << 32) | best_j.
// Non-negative float bits order like the floats, and on equal distances the
// low word keeps the lowest j, so the merge gives the plain version's first
// index whatever order the splits finish in: exact and deterministic.
//
// Why not the tensor cores: with a depth of 3 (padded to 8 for TF32 mma), a
// 3xTF32 split for f32 accuracy costs about 48 tensor operations per pair,
// about 0.97 ms at 100k^2 and 495 TFLOP/s, no better than 3 FFMA per pair at
// the issue rate, and the min/argmin epilogue stays on the CUDA cores either
// way.  Plain TF32 (2^-11 relative, ~1e-3 absolute at these scales) would
// flood the filter with false candidates.
//
// Built with -DMIN_DIST_COUNT_EXACT, the scan also counts the groups that took
// the exact path (a measurement build; the main path never loads it).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 4;  // x rows per thread
constexpr int kRowsPerBlock = kThreads * kRows;
constexpr int kPanel = 1024;  // y points per panel: 16 KiB of float4
constexpr int kGroup = 16;    // pairs per row between threshold compares
constexpr int kPackThreads = 256;
constexpr int kCellSide = 32;  // rows are ordered by cell of a 32^3 grid
constexpr int kCells = kCellSide * kCellSide * kCellSide;
constexpr int kScanThreads = 1024;
constexpr int kWarm = 32;  // y points of a row's own cell seeding its bound
constexpr float kMarginScale = 9.5367431640625e-07f;  // 2^-20 = 16 u
constexpr float kOnePlusScale = 1.00000095367431640625f;  // 1 + 2^-20, exact
constexpr float kMarginFloor = 1.17549435082228750797e-38f;  // 2^-126
constexpr unsigned long long kEmptyKey = 0x7f80000000000000ull;  // (inf, 0)

#ifdef MIN_DIST_COUNT_EXACT
// warp groups, warp groups that took the exact path, row groups, row walks
__device__ unsigned long long g_counts[4];
#endif

__device__ __forceinline__ float sq_norm(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)),
                   __fmul_rn(c, c));
}

// d' = |y|^2 - 2 x.y by three FMAs, each rounded once
__device__ __forceinline__ float expansion(float x0, float x1, float x2,
                                           float4 q) {
  return __fmaf_rn(x0, q.x, __fmaf_rn(x1, q.y, __fmaf_rn(x2, q.z, q.w)));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// one thread: copy `count` packed points from global to shared, completing
// on the mbarrier `bar`
__device__ __forceinline__ void load_panel(float4* dst, const float4* src,
                                           int count, uint32_t bar) {
  const uint32_t bytes = static_cast<uint32_t>(count) * sizeof(float4);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// The plain version's d2 between x and the point packed in p: y = -0.5 p.xyz
// exactly, then (dx*dx + dy*dy) + dz*dz with every step rounded.
__device__ __forceinline__ float exact_d2(float x0, float x1, float x2,
                                         float4 p) {
  return sq_norm(__fsub_rn(x0, __fmul_rn(-0.5f, p.x)),
                 __fsub_rn(x1, __fmul_rn(-0.5f, p.y)),
                 __fsub_rn(x2, __fmul_rn(-0.5f, p.z)));
}

// The exact path for one row over `len` points from `q` (global index j0):
// the exact difference for each candidate that passes the threshold.
__device__ __forceinline__ void walk(float x0, float x1, float x2, float a,
                                     float& best, int& best_j, float& thr,
                                     const float4* q, int j0, int len) {
#pragma unroll 1
  for (int k = 0; k < len; ++k) {
    const float4 p = q[k];
    if (expansion(x0, x1, x2, p) <= thr) {
      const float d2 = exact_d2(x0, x1, x2, p);
      if (d2 < best) {
        best = d2;
        best_j = j0 + k;
        thr = fminf(thr, __fmaf_rn(best, kOnePlusScale, a));
      }
    }
  }
}

// A float's order-preserving unsigned key, and back.
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The low 5 bits of v spread to every third bit.
__device__ __forceinline__ unsigned spread3(unsigned v) {
  v &= 0x1fu;
  v = (v | v << 8) & 0x100fu;
  v = (v | v << 4) & 0x10c3u;
  v = (v | v << 2) & 0x1249u;
  return v;
}

// yq, the largest |y|^2, the merge keys, and the bounding box of x (as
// order keys: stats[1 + a] holds the complement of the axis' smallest key,
// so that every entry of stats is an atomicMax from 0).
__global__ void __launch_bounds__(kPackThreads)
pack_kernel(const float* __restrict__ x, const float* __restrict__ y, int n,
            int m, float4* __restrict__ yq, unsigned* __restrict__ stats,
            unsigned long long* __restrict__ keys) {
  float ymax = 0.f;
  unsigned lo[3] = {0u, 0u, 0u}, hi[3] = {0u, 0u, 0u};
  const int stride = gridDim.x * blockDim.x;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < max(n, m);
       j += stride) {
    if (j < m) {
      const size_t r = 3 * static_cast<size_t>(j);
      const float a = y[r], b = y[r + 1], c = y[r + 2];
      const float ny = sq_norm(a, b, c);
      yq[j] = make_float4(-2.f * a, -2.f * b, -2.f * c, ny);
      ymax = fmaxf(ymax, ny);
    }
    if (j < n) {
      keys[j] = kEmptyKey;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const unsigned k = order_key(x[3 * static_cast<size_t>(j) + a]);
        lo[a] = max(lo[a], ~k);
        hi[a] = max(hi[a], k);
      }
    }
  }
  const unsigned ybits = __reduce_max_sync(0xffffffffu, __float_as_uint(ymax));
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = __reduce_max_sync(0xffffffffu, lo[a]);
    hi[a] = __reduce_max_sync(0xffffffffu, hi[a]);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicMax(stats, ybits);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      atomicMax(stats + 1 + a, lo[a]);
      atomicMax(stats + 4 + a, hi[a]);
    }
  }
}

// The cell of each x row and then of each y point in a kCellSide^3 grid over
// the bounding box of x (y clamped to it), numbered in Morton order, and the
// count of each side's points in each cell.
__global__ void __launch_bounds__(kPackThreads)
cell_kernel(const float* __restrict__ x, const float* __restrict__ y, int n,
            int m, const unsigned* __restrict__ stats, int* __restrict__ cells,
            int* __restrict__ counts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n + m) return;
  const float* p = i < n ? x + 3 * static_cast<size_t>(i)
                         : y + 3 * static_cast<size_t>(i - n);
  unsigned cell = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float lo = key_float(~stats[1 + a]);
    const float extent = key_float(stats[4 + a]) - lo;
    const float t = extent > 0.f ? (p[a] - lo) / extent : 0.f;
    const int c = min(kCellSide - 1, max(0, static_cast<int>(t * kCellSide)));
    cell |= spread3(static_cast<unsigned>(c)) << (2 - a);
  }
  cells[i] = static_cast<int>(cell);
  atomicAdd(counts + (i < n ? 0 : kCells) + cell, 1);
}

// Block b: the counts of the kCells cells of side b (x, y) become their
// exclusive offsets.
__global__ void __launch_bounds__(kScanThreads) offsets_kernel(int* counts) {
  constexpr int kPer = kCells / kScanThreads;
  __shared__ int warp_sums[kScanThreads / 32];
  int* c = counts + blockIdx.x * kCells + threadIdx.x * kPer;
  int local[kPer];
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    local[k] = c[k];
    sum += local[k];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int v = sum;  // inclusive scan over the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += t;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  int base = v - sum + (warp > 0 ? warp_sums[warp - 1] : 0);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    c[k] = base;
    base += local[k];
  }
}

// Each side's points, cell by cell: order[offset of the cell + rank] = index
// (x rows first, then y points).  The rank within a cell follows the
// atomics; the result does not depend on it.  Afterwards each offset is the
// end of its cell.
__global__ void __launch_bounds__(kPackThreads)
scatter_kernel(const int* __restrict__ cells, int n, int m,
               int* __restrict__ offsets, int* __restrict__ order) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    order[atomicAdd(offsets + cells[i], 1)] = i;
  else if (i < n + m)
    order[n + atomicAdd(offsets + kCells + cells[i], 1)] = i - n;
}

__global__ void __launch_bounds__(kThreads, 4)
scan_kernel(const float* __restrict__ x, const int* __restrict__ cells,
            const int* __restrict__ order, const int* __restrict__ ends,
            const float4* __restrict__ yq, int n, int m, int panels_per_split,
            const unsigned* __restrict__ ymax_bits,
            unsigned long long* __restrict__ keys) {
  __shared__ __align__(128) float4 panel[2][kPanel];
  __shared__ __align__(8) unsigned long long full[2];

  const long long span = static_cast<long long>(panels_per_split) * kPanel;
  const long long begin = blockIdx.y * span;
  if (begin >= m) return;  // an empty split: the whole block leaves
  const int j_begin = static_cast<int>(begin);
  const int j_end = static_cast<int>(min(static_cast<long long>(m),
                                         begin + span));
  const int n_panels = (j_end - j_begin + kPanel - 1) / kPanel;

  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_addr(&full[0])) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_addr(&full[1])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int p = 0; p < min(2, n_panels); ++p) {
      const int base = j_begin + p * kPanel;
      load_panel(panel[p], yq + base, min(kPanel, j_end - base),
                 smem_addr(&full[p]));
    }
  }

  const float ym = __fsqrt_rn(__uint_as_float(*ymax_bits));
  float x0[kRows], x1[kRows], x2[kRows], a[kRows], best[kRows], thr[kRows];
  int best_j[kRows];
  const long long row0 =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long i = row0 + r * kThreads;
    best[r] = CUDART_INF_F;
    best_j[r] = 0;
    x0[r] = x1[r] = x2[r] = a[r] = 0.f;
    thr[r] = -CUDART_INF_F;  // a row past the end never takes the exact path
    if (i < n) {
      const long long row = order[i];  // widened for the offsets below
      x0[r] = x[3 * row];
      x1[r] = x[3 * row + 1];
      x2[r] = x[3 * row + 2];
      const float xx = sq_norm(x0[r], x1[r], x2[r]);
      const float s = __fadd_rn(__fsqrt_rn(xx), ym);
      const float k = __fmaf_rn(__fmul_rn(s, s), kMarginScale, kMarginFloor);
      a[r] = __fsub_rn(k, xx);
      // Warm start: the exact distance to a few y points of the row's own
      // cell bounds its final best, so it bounds the threshold too.
      const int c = cells[row];
      const int* ys = order + n;
      const int first = c > 0 ? ends[kCells + c - 1] : 0;
      const int last = min(ends[kCells + c], first + kWarm);
      float bound = CUDART_INF_F;
      for (int t = first; t < last; ++t)
        bound = fminf(bound, exact_d2(x0[r], x1[r], x2[r], yq[ys[t]]));
      thr[r] = __fmaf_rn(bound, kOnePlusScale, a[r]);
    }
  }
#ifdef MIN_DIST_COUNT_EXACT
  unsigned long long warp_groups = 0, warp_exact = 0, row_groups = 0,
                     row_walks = 0;
#endif
  __syncthreads();  // the barriers' init is visible to every thread

  for (int p = 0; p < n_panels; ++p) {
    const int buf = p & 1;
    mbar_wait(smem_addr(&full[buf]), (p >> 1) & 1);
    const int base = j_begin + p * kPanel;
    const int count = min(kPanel, j_end - base);
    const int groups = count / kGroup;
    for (int g = 0; g < groups; ++g) {
      const float4* q = panel[buf] + g * kGroup;
      float gm[kRows];
      {
        const float4 p0 = q[0];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          gm[r] = expansion(x0[r], x1[r], x2[r], p0);
      }
#pragma unroll
      for (int k = 1; k < kGroup; ++k) {
        const float4 pk = q[k];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          gm[r] = fminf(gm[r], expansion(x0[r], x1[r], x2[r], pk));
      }
      bool hit = false;
#pragma unroll
      for (int r = 0; r < kRows; ++r) hit |= gm[r] <= thr[r];
#ifdef MIN_DIST_COUNT_EXACT
      const bool warp_hit = __any_sync(0xffffffffu, hit);
      if ((threadIdx.x & 31) == 0) {
        ++warp_groups;
        warp_exact += warp_hit;
      }
      row_groups += kRows;
#pragma unroll
      for (int r = 0; r < kRows; ++r) row_walks += gm[r] <= thr[r];
#endif
      if (hit) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (gm[r] <= thr[r])
            walk(x0[r], x1[r], x2[r], a[r], best[r], best_j[r], thr[r], q,
                 base + g * kGroup, kGroup);
        }
      }
    }
    const int tail = groups * kGroup;
    if (tail < count) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        walk(x0[r], x1[r], x2[r], a[r], best[r], best_j[r], thr[r],
             panel[buf] + tail, base + tail, count - tail);
    }
    __syncthreads();  // every thread is done with this buffer
    if (threadIdx.x == 0 && p + 2 < n_panels) {
      // order this block's generic reads of the buffer before the async write
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const int next = base + 2 * kPanel;
      load_panel(panel[buf], yq + next, min(kPanel, j_end - next),
                 smem_addr(&full[buf]));
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long i = row0 + r * kThreads;
    if (i < n && best[r] < CUDART_INF_F) {
      const unsigned long long key =
          (static_cast<unsigned long long>(__float_as_uint(best[r])) << 32) |
          static_cast<unsigned>(best_j[r]);
      atomicMin(keys + order[i], key);
    }
  }
#ifdef MIN_DIST_COUNT_EXACT
  atomicAdd(&g_counts[0], warp_groups);
  atomicAdd(&g_counts[1], warp_exact);
  atomicAdd(&g_counts[2], row_groups);
  atomicAdd(&g_counts[3], row_walks);
#endif
}

__global__ void __launch_bounds__(kPackThreads)
unpack_kernel(const unsigned long long* __restrict__ keys, int n,
              float* __restrict__ d2, int* __restrict__ idx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const unsigned long long key = keys[i];
    d2[i] = __uint_as_float(static_cast<unsigned>(key >> 32));
    idx[i] = static_cast<int>(static_cast<unsigned>(key & 0xffffffffu));
  }
}

// The scratch of one search, carved from one buffer: yq [m] float4, stats
// (8 unsigned), keys [n] u64, and cells [n + m], counts [2 kCells] and
// order [n + m] int32 (x rows, then y points), each at a 256-byte boundary.
struct Scratch {
  float4* yq;
  unsigned* stats;
  unsigned long long* keys;
  int* cells;
  int* counts;
  int* order;
};

size_t carve(void* base, int n, int m, Scratch* s) {
  size_t at = 0;
  auto take = [&](size_t bytes) {
    void* p = reinterpret_cast<void*>(reinterpret_cast<uintptr_t>(base) + at);
    at += (bytes + 255) / 256 * 256;
    return p;
  };
  const size_t un = static_cast<size_t>(n), um = static_cast<size_t>(m);
  s->yq = static_cast<float4*>(take(um * sizeof(float4)));
  s->stats = static_cast<unsigned*>(take(8 * sizeof(unsigned)));
  s->keys = static_cast<unsigned long long*>(take(un * 8));
  s->cells = static_cast<int*>(take((un + um) * sizeof(int)));
  s->counts = static_cast<int*>(take(2 * kCells * sizeof(int)));
  s->order = static_cast<int*>(take((un + um) * sizeof(int)));
  return at;
}

}  // namespace

// The kernel's shape, for the wrapper's choice of splits: threads per block,
// x rows per block, y points per panel, points per group, and how many scan
// blocks one SM of the current device holds at once.  Returns the CUDA error.
extern "C" int min_dist_config(int* out) {
  out[0] = kThreads;
  out[1] = kRowsPerBlock;
  out[2] = kPanel;
  out[3] = kGroup;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 4, scan_kernel, kThreads, 0));
}

// Bytes of scratch that min_dist_launch needs for an n x m search.
extern "C" size_t min_dist_scratch_bytes(int n, int m) {
  Scratch s;
  return carve(nullptr, n, m, &s);
}

// x [n, 3] and y [m, 3] row-major f32 on the device, m >= 1; writes d2 [n]
// f32 and idx [n] int32.  `scratch` holds min_dist_scratch_bytes(n, m)
// bytes.  The x rows are scanned in the order of their cells (rows near in
// space share a warp, so they take the exact path together); the y range is
// cut into splits of `panels_per_split` panels (grid.y = `splits`).  Launches
// on `stream` and returns the first non-zero CUDA error, or 0.
extern "C" int min_dist_launch(const float* x, const float* y, int n, int m,
                               int splits, int panels_per_split,
                               void* scratch, float* d2, int* idx,
                               cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  Scratch s;
  carve(scratch, n, m, &s);
  cudaError_t err = cudaMemsetAsync(s.stats, 0, 8 * sizeof(unsigned), stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(s.counts, 0, 2 * kCells * sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_blocks = (n + kPackThreads - 1) / kPackThreads;
  const int pack_blocks =
      std::min((std::max(n, m) + kPackThreads - 1) / kPackThreads, 4096);
  pack_kernel<<<pack_blocks, kPackThreads, 0, stream>>>(x, y, n, m, s.yq,
                                                        s.stats, s.keys);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int point_blocks = (n + m + kPackThreads - 1) / kPackThreads;
  cell_kernel<<<point_blocks, kPackThreads, 0, stream>>>(x, y, n, m, s.stats,
                                                         s.cells, s.counts);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  offsets_kernel<<<2, kScanThreads, 0, stream>>>(s.counts);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  scatter_kernel<<<point_blocks, kPackThreads, 0, stream>>>(s.cells, n, m,
                                                            s.counts, s.order);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, splits);
  scan_kernel<<<grid, kThreads, 0, stream>>>(x, s.cells, s.order, s.counts,
                                             s.yq, n, m, panels_per_split,
                                             s.stats, s.keys);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  unpack_kernel<<<row_blocks, kPackThreads, 0, stream>>>(s.keys, n, d2, idx);
  return static_cast<int>(cudaGetLastError());
}

#ifdef MIN_DIST_COUNT_EXACT
// Copies the four exact-path counters to `out` (host) and zeroes them;
// synchronises with the device.
extern "C" int min_dist_exact_counts(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_counts, sizeof(g_counts));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[4] = {0, 0, 0, 0};
  return static_cast<int>(cudaMemcpyToSymbol(g_counts, zero, sizeof(zero)));
}
#endif
