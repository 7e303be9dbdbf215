// K2: the hash-grid encode of a separable lattice, every factored level in
// one launch.
//
// Replaces the XLA program of the JAX package's encode_lattice
// (tropical/core/hashgrid.py:232, the corner grid of _corner_table :182 and
// the jvp tangents of _sdf_dist_grad_lattice, tropical/extract/device.py
// :1870): per lattice point (x, y, z) of {xs} x {ys} x {zs} and level, the
// trilinear interpolation against the level's corner-value grid G [K^3, 2]
// (core/hashgrid.corner_table), factored as the JAX package contracts it:
// over z first, then y, then x, each contraction A[g] * w0 + A[g + 1] * w1
// with the products rounded, then the sum (__fmul_rn / __fadd_rn: nvcc
// would contract an FMA).  With grad, also the three world-axis
// derivatives, the axis's weights (1 - frac, frac) swapped for (-t, t).
// Bitwise core/hashgrid.lattice_level_plain, level by level.
//
// Bound: bytes.  A point writes its feature row (2 floats a level) and,
// with grad, a row in each of the three derivative planes: 128 bytes a
// point at 4 levels, 1.04 GB at sphere-large's 8.1 M lattice points, far
// past the 50 MB L2.  The corner grids cache well (neighbouring threads
// share corners); 54 float operations a point and level (120 with grad).
//
// Design: one launch for every level the lattice factors (the levels'
// descriptors, LatticeLevels, in one kernel parameter) and one thread a
// point, which walks the levels two at a time into its rows, staged in
// shared memory; the block then copies its rows out a float4 a thread,
// consecutive threads on consecutive addresses, so that each row is
// written once and a warp's stores fill whole sectors.  A launch that
// leaves a level alone, or whose rows are not a multiple of 4 floats up to
// kStageRow, stores each pair's 4 floats of a row as one float4 (a float2
// a level where they are not 16-byte aligned) straight to device memory.
// The first design (-DLATTICE_LEVEL_LAUNCH)
// launched once a level, a thread a point and level storing 8 bytes at
// the row's 32-byte stride: a warp wrote a quarter of each sector, and
// each launch rewrote the sectors the one before had left partial, which
// device memory merged sector by sector.

#include <cuda_runtime.h>

// the launch's levels (core/hashgrid._LatticeLevels mirrors it): G null
// for a level this launch leaves alone; the rows are 2 count floats.  At
// namespace scope: the extern "C" launch function takes a pointer to it.
constexpr int kMaxLevels = 16;
struct LatticeLevels {
  const float2* G[kMaxLevels];
  int K[kMaxLevels];
  float scale[kMaxLevels];
  float t[kMaxLevels];
  int count;
};

namespace {

constexpr int kThreads = 256;
// the longest row (floats) the launch stages in shared memory: 4 levels
constexpr int kStageRow = 8;

#ifdef LATTICE_LEVEL_LAUNCH
constexpr bool kOneLaunch = false;
#else
constexpr bool kOneLaunch = true;
#endif

struct Axis {
  int g;
  float w0, w1;
};

__device__ __forceinline__ Axis axis_of(float a, float scale, int K) {
  const float pos = __fadd_rn(__fmul_rn(a, scale), 0.5f);
  const float g = floorf(pos);
  const float frac = __fsub_rn(pos, g);
  // unit-cube coordinates keep the corners inside the grid; clamp so that
  // nothing else can read past it
  const int gi = min(max(static_cast<int>(g), 0), K - 2);
  return Axis{gi, __fsub_rn(1.0f, frac), frac};
}

__device__ __forceinline__ float2 lerp2(float2 a, float2 b, float w0,
                                        float w1) {
  return make_float2(__fadd_rn(__fmul_rn(a.x, w0), __fmul_rn(b.x, w1)),
                     __fadd_rn(__fmul_rn(a.y, w0), __fmul_rn(b.y, w1)));
}

// one level at the point (x, y, z): the features f and, with grad, the
// three axis derivatives d
__device__ __forceinline__ void level_at(const float2* __restrict__ G, int K,
                                         float scale, float t, float x,
                                         float y, float z, bool grad,
                                         float2* f, float2* d) {
  const Axis ax = axis_of(x, scale, K);
  const Axis ay = axis_of(y, scale, K);
  const Axis az = axis_of(z, scale, K);
  // t1[i][j]: the z contraction at corner column (gx + i, gy + j); dz1 its
  // z derivative
  float2 t1[2][2], dz1[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) {
      const long long row =
          (static_cast<long long>(ax.g + i) * K + (ay.g + j)) * K + az.g;
      const float2 c0 = G[row];
      const float2 c1 = G[row + 1];
      t1[i][j] = lerp2(c0, c1, az.w0, az.w1);
      dz1[i][j] = lerp2(c0, c1, -t, t);
    }
  float2 t2[2], dy2[2], dz2[2];
  for (int i = 0; i < 2; ++i) {
    t2[i] = lerp2(t1[i][0], t1[i][1], ay.w0, ay.w1);
    dy2[i] = lerp2(t1[i][0], t1[i][1], -t, t);
    dz2[i] = lerp2(dz1[i][0], dz1[i][1], ay.w0, ay.w1);
  }
  *f = lerp2(t2[0], t2[1], ax.w0, ax.w1);
  if (!grad) return;
  d[0] = lerp2(t2[0], t2[1], -t, t);
  d[1] = lerp2(dy2[0], dy2[1], ax.w0, ax.w1);
  d[2] = lerp2(dz2[0], dz2[1], ax.w0, ax.w1);
}

__device__ __forceinline__ void point_of(int p, int ny, int nz,
                                         const float* __restrict__ xs,
                                         const float* __restrict__ ys,
                                         const float* __restrict__ zs,
                                         float* x, float* y, float* z) {
  *x = xs[p / (ny * nz)];
  *y = ys[(p / nz) % ny];
  *z = zs[p % nz];
}

// The design: a thread a point, the levels two at a time, each pair's 4
// floats of a row one float4 into the block's rows in shared memory
// (staged), copied out after; or straight to device memory, a level alone
// (its pair's other level left alone) or a pair of rows not 16-byte
// aligned as float2s.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
    lattice_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                   const float* __restrict__ zs, int ny, int nz, int n,
                   const LatticeLevels lv, float* __restrict__ feat,
                   float* __restrict__ grad, long long plane) {
  // the block's rows of the 4 planes, written a float at a time
  __shared__ float4 stage[kStaged ? kThreads * kStageRow : 1];
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int LF = 2 * lv.count;
  const bool live = p < n;
  float x = 0.0f, y = 0.0f, z = 0.0f;
  if (live) point_of(p, ny, nz, xs, ys, zs, &x, &y, &z);
  const int planes = grad == nullptr ? 1 : 4;
  // unrolled, so that the descriptors are read at constant offsets
#pragma unroll
  for (int l = 0; l < kMaxLevels; l += 2) {
    if (l >= lv.count) break;
    const bool has[2] = {lv.G[l] != nullptr,
                         l + 1 < lv.count && lv.G[l + 1] != nullptr};
    if (!has[0] && !has[1]) continue;
    float2 v[2][4] = {};  // [level of the pair][feat, d/dx, d/dy, d/dz]
    for (int h = 0; h < 2; ++h)
      if (live && has[h])
        level_at(lv.G[l + h], lv.K[l + h], lv.scale[l + h], lv.t[l + h], x,
                 y, z, grad != nullptr, &v[h][0], &v[h][1]);
    // unrolled, so that v stays in registers
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (a >= planes) break;
      if (kStaged) {  // every level is in the launch
        float* row = reinterpret_cast<float*>(stage) +
                     (a * kThreads + threadIdx.x) * kStageRow + 2 * l;
        for (int h = 0; h < 2; ++h) {
          row[2 * h] = v[h][a].x;
          row[2 * h + 1] = v[h][a].y;
        }
        continue;
      }
      if (!live) continue;
      float* row = (a ? grad + (a - 1) * plane : feat) +
                   static_cast<long long>(p) * LF + 2 * l;
      if (has[0] && has[1] && LF % 4 == 0) {  // 16-byte aligned
        *reinterpret_cast<float4*>(row) =
            make_float4(v[0][a].x, v[0][a].y, v[1][a].x, v[1][a].y);
      } else {
        for (int h = 0; h < 2; ++h)
          if (has[h]) *reinterpret_cast<float2*>(row + 2 * h) = v[h][a];
      }
    }
  }
  if (!kStaged) return;
  // the block's rows, a float4 a thread
  __syncthreads();
  const int first = blockIdx.x * blockDim.x;
  const int rows = min(static_cast<int>(blockDim.x), n - first);
  const int quads = rows * LF / 4;
  for (int a = 0; a < planes; ++a) {
    float4* out = reinterpret_cast<float4*>(
        (a ? grad + (a - 1) * plane : feat) +
        static_cast<long long>(first) * LF);
    for (int i = threadIdx.x; i < quads; i += blockDim.x) {
      const int r = i / (LF / 4), c = i % (LF / 4);
      out[i] = stage[(a * kThreads + r) * (kStageRow / 4) + c];
    }
  }
}

// The first design: a thread a point and one level, 8 bytes a row.
__global__ void __launch_bounds__(kThreads)
    lattice_level_kernel(const float* __restrict__ xs,
                         const float* __restrict__ ys,
                         const float* __restrict__ zs, int ny, int nz, int n,
                         const float2* __restrict__ G, int K, float scale,
                         float t, float* __restrict__ feat,
                         float* __restrict__ grad, int stride,
                         long long plane) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  float x, y, z;
  point_of(p, ny, nz, xs, ys, zs, &x, &y, &z);
  float2 f, d[3];
  level_at(G, K, scale, t, x, y, z, grad != nullptr, &f, d);
  float* out = feat + static_cast<long long>(p) * stride;
  out[0] = f.x;
  out[1] = f.y;
  if (grad == nullptr) return;
  for (int a = 0; a < 3; ++a) {
    float* g = grad + a * plane + static_cast<long long>(p) * stride;
    g[0] = d[a].x;
    g[1] = d[a].y;
  }
}

}  // namespace

// feat [n, 2 L] and grad [3, n, 2 L] (or null), n = nx ny nz; writes the
// columns of every level of *levels with a corner grid.  Returns the count
// of kernels launched (1; the first design's, one a level), or minus a CUDA
// error.
extern "C" int lattice_encode_launch(const float* xs, const float* ys,
                                     const float* zs, int nx, int ny, int nz,
                                     const LatticeLevels* levels, float* feat,
                                     float* grad, cudaStream_t stream) {
  const int n = nx * ny * nz;
  const LatticeLevels& lv = *levels;
  if (lv.count < 1 || lv.count > kMaxLevels)
    return -static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const int LF = 2 * lv.count;
  const long long plane = static_cast<long long>(n) * LF;
  const int grid = (n + kThreads - 1) / kThreads;
  if (kOneLaunch) {
    bool staged = LF % 4 == 0 && LF <= kStageRow;
    for (int l = 0; l < lv.count; ++l) staged &= lv.G[l] != nullptr;
    if (staged)
      lattice_kernel<true><<<grid, kThreads, 0, stream>>>(
          xs, ys, zs, ny, nz, n, lv, feat, grad, plane);
    else
      lattice_kernel<false><<<grid, kThreads, 0, stream>>>(
          xs, ys, zs, ny, nz, n, lv, feat, grad, plane);
    const int rc = static_cast<int>(cudaGetLastError());
    return rc ? -rc : 1;
  }
  int launched = 0;
  for (int l = 0; l < lv.count; ++l) {
    if (lv.G[l] == nullptr) continue;
    lattice_level_kernel<<<grid, kThreads, 0, stream>>>(
        xs, ys, zs, ny, nz, n, lv.G[l], lv.K[l], lv.scale[l], lv.t[l],
        feat + 2 * l, grad == nullptr ? nullptr : grad + 2 * l, LF, plane);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return -rc;
    ++launched;
  }
  return launched;
}
