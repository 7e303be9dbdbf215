// K2: the hash-grid encode of a separable lattice, one level a launch.
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
// Bitwise core/hashgrid.lattice_level_plain.
//
// Bound: bytes.  Each point and level writes 8 bytes (32 with grad) and
// reads its 8 corners from a grid that caches well (neighbouring threads
// share corners); 54 float operations a point and level (120 with
// grad).  One thread a point and level; the x-major point order makes a
// warp's 32 points z-neighbours.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

__global__ void __launch_bounds__(kThreads)
    lattice_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                   const float* __restrict__ zs, int ny, int nz, int n,
                   const float2* __restrict__ G, int K, float scale, float t,
                   float* __restrict__ feat, float* __restrict__ grad,
                   int stride, long long plane) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int iz = p % nz;
  const int iy = (p / nz) % ny;
  const int ix = p / (ny * nz);
  const Axis ax = axis_of(xs[ix], scale, K);
  const Axis ay = axis_of(ys[iy], scale, K);
  const Axis az = axis_of(zs[iz], scale, K);

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
  const float2 f = lerp2(t2[0], t2[1], ax.w0, ax.w1);
  float* out = feat + static_cast<long long>(p) * stride;
  out[0] = f.x;
  out[1] = f.y;
  if (grad == nullptr) return;
  const float2 d[3] = {lerp2(t2[0], t2[1], -t, t),
                       lerp2(dy2[0], dy2[1], ax.w0, ax.w1),
                       lerp2(dz2[0], dz2[1], ax.w0, ax.w1)};
  for (int a = 0; a < 3; ++a) {
    float* g = grad + a * plane + static_cast<long long>(p) * stride;
    g[0] = d[a].x;
    g[1] = d[a].y;
  }
}

}  // namespace

// feat / grad point at the level's first column; stride is the row length
// (levels * 2), plane the elements between grad's axis planes.
extern "C" int lattice_encode_launch(const float* xs, const float* ys,
                                     const float* zs, int nx, int ny, int nz,
                                     const float* G, int K, float scale,
                                     float t, float* feat, float* grad,
                                     int stride, long long plane,
                                     cudaStream_t stream) {
  const int n = nx * ny * nz;
  if (n <= 0) return 0;
  lattice_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      xs, ys, zs, ny, nz, n, reinterpret_cast<const float2*>(G), K, scale, t,
      feat, grad, stride, plane);
  return static_cast<int>(cudaGetLastError());
}
