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
// The tables' gradients (dtable, dtable2) are atomicAdd scatters, whose
// order of adds is free: they hold to a tolerance.
//
// Indices: the dense index gx + gy r + gz r^2 of a level, taken modulo the
// level's entry count with a non-negative result (torch.remainder), or the
// hash (gx * 1) ^ (gy * 2654435761) ^ (gz * 805459861) in uint32 with
// wraparound, masked to 2^T - 1; then the level's offset is added and the
// row clamped to the table, as the plain version does.
//
// Design: one thread per (point, level), the points' levels on neighbouring
// lanes (a group of G lanes, G the power of two at or above L, so a group
// never straddles a warp).  A thread computes its level's 8 corners, reads
// each corner's F = 2 features as one float2, and writes its level's two
// features; dx and dx2 sum the group's levels in order by shuffles, lane 0
// of the group writing the point's row.  Per-level constants come from a
// small table in device memory (LevelRow), read through the L1 cache.
//
// Bound: bytes.  A forward reads a point (12 bytes) and writes 8 bytes a
// level, and must read each table row its corners reach once: the table
// (281 KB for sphere-small) stays in the 50 MB L2, so the corners' further
// gathers of a row are not HBM traffic.  That is 12 + 8 L bytes a point
// plus 8 bytes a row reached, at 3.35 TB/s; the arithmetic is some 60
// operations a level.  chip_smoke.py counts each kernel's bytes.  This
// simple design gathers the corners with no reuse between the points of a
// block and scatters the tables' gradients with one atomicAdd per corner
// and feature.  Measured on an NVIDIA H100 80GB HBM3 at 700 W: at a
// training batch of 1,000 points the kernels take 5-15 us, latency-bound
// (16 blocks for 132 SMs); at 278,528 points the forward takes some 44 us,
// about a tenth of the speed its bound allows, while the backwards'
// atomicAdds serialise on the coarse levels' few rows (3 ms).

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

// One level's constants, as tropical_torch/core/hashgrid.py:_level_rows
// writes them.
struct LevelRow {
  float scale;   // s_l rounded to f32
  int offset;    // the level's first table row
  int entries;   // the level's table rows
  int res;       // the level's resolution
  int hashed;    // 1 where the level hashes
};

struct Grid {
  const float* x;          // [n, 3]
  const float2* table;     // [n_rows, 2]
  const LevelRow* rows;    // [levels]
  int levels;
  int group;               // lanes a point: a power of two >= levels, <= 32
  int n_rows;
  unsigned hash_mask;      // 2^T - 1
  int n;
};

// The thread's point and level; `live` is false for the lanes past the last
// point or the last level, which compute a copy of a live lane's work (so
// that every lane runs every shuffle) and write nothing.
struct Slot {
  int b, l;
  bool live;
  bool lead;  // the group's lane 0 of a live point
};

__device__ __forceinline__ Slot slot_of(const Grid& g) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = t / g.group, l = t % g.group;
  Slot s;
  s.live = b < g.n && l < g.levels;
  s.lead = b < g.n && l == 0;
  s.b = min(b, g.n - 1);
  s.l = min(l, g.levels - 1);
  return s;
}

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
  long long row;
  float w[3];
};

__device__ __forceinline__ Corner corner_of(const Grid& g, const LevelRow& lr,
                                            const Cell& cl, int c) {
  Corner k;
  const int bx = c & 1, by = (c >> 1) & 1, bz = (c >> 2) & 1;
  k.row = corner_row(g, lr, cl.g[0] + bx, cl.g[1] + by, cl.g[2] + bz);
  k.w[0] = bx ? cl.f[0] : cl.lo[0];
  k.w[1] = by ? cl.f[1] : cl.lo[1];
  k.w[2] = bz ? cl.f[2] : cl.lo[2];
  return k;
}

__device__ __forceinline__ float neg_unless(float v, bool keep) {
  return keep ? v : -v;
}

// The group's values of v summed over its levels 0..levels-1 in order, in
// every lane.
__device__ __forceinline__ float level_sum(const Grid& g, float v) {
  const int base = (threadIdx.x & 31) & ~(g.group - 1);
  float sum = __shfl_sync(kFullMask, v, base);
  for (int j = 1; j < g.levels; ++j)
    sum = __fadd_rn(sum, __shfl_sync(kFullMask, v, base + j));
  return sum;
}

// Whether the whole warp lies past the last point (it then returns whole,
// and no lane of a warp that runs shuffles has left).
__device__ __forceinline__ bool warp_done(const Grid& g) {
  const int first = (blockIdx.x * blockDim.x + (threadIdx.x & ~31));
  return first / g.group >= g.n;
}

__global__ void __launch_bounds__(kThreads)
    fwd_kernel(Grid g, float2* __restrict__ feat) {
  const Slot s = slot_of(g);
  if (!s.live) return;
  const LevelRow lr = g.rows[s.l];
  const Cell cl = cell_of(g.x + 3LL * s.b, lr.scale);
  float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const Corner k = corner_of(g, lr, cl, c);
    const float w = __fmul_rn(__fmul_rn(k.w[0], k.w[1]), k.w[2]);
    const float2 t = g.table[k.row];
    if (c == 0) {
      acc.x = __fmul_rn(w, t.x);
      acc.y = __fmul_rn(w, t.y);
    } else {
      acc.x = __fadd_rn(acc.x, __fmul_rn(w, t.x));
      acc.y = __fadd_rn(acc.y, __fmul_rn(w, t.y));
    }
  }
  feat[static_cast<long long>(s.b) * g.levels + s.l] = acc;
}

// dx [n, 3] and dtable [n_rows, 2] (zeroed by the caller), each skipped
// where null.
__global__ void __launch_bounds__(kThreads)
    bwd_kernel(Grid g, const float2* __restrict__ dfeat, float* __restrict__ dx,
               float* __restrict__ dtable) {
  if (warp_done(g)) return;
  const Slot s = slot_of(g);
  const LevelRow lr = g.rows[s.l];
  const Cell cl = cell_of(g.x + 3LL * s.b, lr.scale);
  const float2 dl = dfeat[static_cast<long long>(s.b) * g.levels + s.l];
  float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const Corner k = corner_of(g, lr, cl, c);
    if (dtable != nullptr && s.live) {
      const float w = __fmul_rn(__fmul_rn(k.w[0], k.w[1]), k.w[2]);
      atomicAdd(dtable + 2 * k.row, __fmul_rn(w, dl.x));
      atomicAdd(dtable + 2 * k.row + 1, __fmul_rn(w, dl.y));
    }
    if (dx != nullptr) {
      const float2 t = g.table[k.row];
      const float gc = __fadd_rn(__fmul_rn(dl.x, t.x), __fmul_rn(dl.y, t.y));
      const float p[3] = {__fmul_rn(k.w[1], k.w[2]),
                          __fmul_rn(k.w[0], k.w[2]),
                          __fmul_rn(k.w[0], k.w[1])};
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float term = neg_unless(__fmul_rn(gc, p[d]), (c >> d) & 1);
        acc[d] = c == 0 ? term : __fadd_rn(acc[d], term);
      }
    }
  }
  if (dx == nullptr) return;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float sum = level_sum(g, __fmul_rn(acc[d], lr.scale));
    if (s.lead) dx[3LL * s.b + d] = sum;
  }
}

// For the gradient ddx [n, 3] of dx: d_dfeat [n, 2L], dtable2 [n_rows, 2]
// (zeroed by the caller) and dx2 [n, 3], each skipped where null.
__global__ void __launch_bounds__(kThreads)
    bwd_bwd_kernel(Grid g, const float2* __restrict__ dfeat,
                   const float* __restrict__ ddx, float2* __restrict__ d_dfeat,
                   float* __restrict__ dtable2, float* __restrict__ dx2) {
  if (warp_done(g)) return;
  const Slot s = slot_of(g);
  const LevelRow lr = g.rows[s.l];
  const Cell cl = cell_of(g.x + 3LL * s.b, lr.scale);
  const long long pl = static_cast<long long>(s.b) * g.levels + s.l;
  const float2 dl = dfeat[pl];
  float u[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) u[d] = __fmul_rn(ddx[3LL * s.b + d], lr.scale);
  float2 dd = make_float2(0.0f, 0.0f);
  float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const Corner k = corner_of(g, lr, cl, c);
    const bool bit[3] = {(c & 1) != 0, ((c >> 1) & 1) != 0,
                         ((c >> 2) & 1) != 0};
    const float p[3] = {__fmul_rn(k.w[1], k.w[2]), __fmul_rn(k.w[0], k.w[2]),
                        __fmul_rn(k.w[0], k.w[1])};
    // a_c = grad(w_c) . u, axes in order
    float a = neg_unless(__fmul_rn(p[0], u[0]), bit[0]);
    a = __fadd_rn(a, neg_unless(__fmul_rn(p[1], u[1]), bit[1]));
    a = __fadd_rn(a, neg_unless(__fmul_rn(p[2], u[2]), bit[2]));
    if (dtable2 != nullptr && s.live) {
      atomicAdd(dtable2 + 2 * k.row, __fmul_rn(a, dl.x));
      atomicAdd(dtable2 + 2 * k.row + 1, __fmul_rn(a, dl.y));
    }
    if (d_dfeat == nullptr && dx2 == nullptr) continue;
    const float2 t = g.table[k.row];
    if (d_dfeat != nullptr) {
      if (c == 0) {
        dd.x = __fmul_rn(a, t.x);
        dd.y = __fmul_rn(a, t.y);
      } else {
        dd.x = __fadd_rn(dd.x, __fmul_rn(a, t.x));
        dd.y = __fadd_rn(dd.y, __fmul_rn(a, t.y));
      }
    }
    if (dx2 != nullptr) {
      const float gc = __fadd_rn(__fmul_rn(dl.x, t.x), __fmul_rn(dl.y, t.y));
      // h_e = sum over d != e (in order) of the weight on the third axis
      // times u_d, minus where bits d and e differ
      const float h0 = __fadd_rn(
          neg_unless(__fmul_rn(k.w[2], u[1]), bit[1] == bit[0]),
          neg_unless(__fmul_rn(k.w[1], u[2]), bit[2] == bit[0]));
      const float h1 = __fadd_rn(
          neg_unless(__fmul_rn(k.w[2], u[0]), bit[0] == bit[1]),
          neg_unless(__fmul_rn(k.w[0], u[2]), bit[2] == bit[1]));
      const float h2 = __fadd_rn(
          neg_unless(__fmul_rn(k.w[1], u[0]), bit[0] == bit[2]),
          neg_unless(__fmul_rn(k.w[0], u[1]), bit[1] == bit[2]));
      const float h[3] = {h0, h1, h2};
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const float term = __fmul_rn(gc, h[e]);
        acc[e] = c == 0 ? term : __fadd_rn(acc[e], term);
      }
    }
  }
  if (d_dfeat != nullptr && s.live) d_dfeat[pl] = dd;
  if (dx2 == nullptr) return;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float sum = level_sum(g, __fmul_rn(acc[e], lr.scale));
    if (s.lead) dx2[3LL * s.b + e] = sum;
  }
}

int blocks_for(const Grid& g) {
  return static_cast<int>(
      (static_cast<long long>(g.n) * g.group + kThreads - 1) / kThreads);
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

Grid make_grid(const float* x, const float* table, const void* rows,
               int levels, int group, int n_rows, unsigned hash_mask, int n) {
  return Grid{x, reinterpret_cast<const float2*>(table),
              static_cast<const LevelRow*>(rows), levels, group, n_rows,
              hash_mask, n};
}

}  // namespace

// Each launch function takes x [n, 3], the table [n_rows, 2] and the level
// rows [levels] (f32 and int32 on the device, contiguous, 8-byte aligned),
// launches on `stream` and returns the CUDA error of the launch, or 0.
// n = 0 launches nothing.

extern "C" int hashgrid_encode_fwd_launch(const float* x, const float* table,
                                          const void* rows, int levels,
                                          int group, int n_rows,
                                          unsigned hash_mask, int n,
                                          float* feat, cudaStream_t stream) {
  const Grid g = make_grid(x, table, rows, levels, group, n_rows, hash_mask, n);
  if (const int rc = check(g)) return rc;
  if (n == 0) return static_cast<int>(cudaGetLastError());
  fwd_kernel<<<blocks_for(g), kThreads, 0, stream>>>(
      g, reinterpret_cast<float2*>(feat));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hashgrid_encode_bwd_launch(const float* x, const float* table,
                                          const void* rows, int levels,
                                          int group, int n_rows,
                                          unsigned hash_mask, int n,
                                          const float* dfeat, float* dx,
                                          float* dtable, cudaStream_t stream) {
  const Grid g = make_grid(x, table, rows, levels, group, n_rows, hash_mask, n);
  if (const int rc = check(g)) return rc;
  if (n == 0 || (dx == nullptr && dtable == nullptr))
    return static_cast<int>(cudaGetLastError());
  bwd_kernel<<<blocks_for(g), kThreads, 0, stream>>>(
      g, reinterpret_cast<const float2*>(dfeat), dx, dtable);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hashgrid_encode_bwd_bwd_launch(
    const float* x, const float* table, const void* rows, int levels,
    int group, int n_rows, unsigned hash_mask, int n, const float* dfeat,
    const float* ddx, float* d_dfeat, float* dtable2, float* dx2,
    cudaStream_t stream) {
  const Grid g = make_grid(x, table, rows, levels, group, n_rows, hash_mask, n);
  if (const int rc = check(g)) return rc;
  if (n == 0 || (d_dfeat == nullptr && dtable2 == nullptr && dx2 == nullptr))
    return static_cast<int>(cudaGetLastError());
  bwd_bwd_kernel<<<blocks_for(g), kThreads, 0, stream>>>(
      g, reinterpret_cast<const float2*>(dfeat), ddx,
      reinterpret_cast<float2*>(d_dfeat), dtable2, dx2);
  return static_cast<int>(cudaGetLastError());
}
