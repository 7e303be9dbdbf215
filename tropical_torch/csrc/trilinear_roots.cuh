// K7's root solve (see trilinear_roots.cu), for any layout of its rows: the
// kernel reads a row's p and q, four float4 (p's corners 0-3 and 4-7, then
// q's), through Rows::load(row, k), each float4 by one lane, and writes the
// row's x, y, x through Rows::store(row, j, value, pre), coordinate j by
// lane j mod kLanes; pre is what Rows::prefetch(row, lane) loaded for it
// before the solve, so that the stores wait on no load.
// trilinear_roots.cu instantiates it on p and q [n, 8] (PlainRows);
// device_engine.cu on the curved insertion's corner forward, its root's
// point written beside it (curved_roots).  Every instance runs the same
// arithmetic on a row, so each gives the plain version's bits.

#pragma once

#include <cuda_runtime.h>

#include <climits>

#ifndef TRILINEAR_ROOTS_LANES
#define TRILINEAR_ROOTS_LANES 4
#endif

namespace {
namespace k7 {


constexpr int kLanes = TRILINEAR_ROOTS_LANES;  // threads a row
static_assert(kLanes == 1 || kLanes == 2 || kLanes == 4 || kLanes == 8,
              "TRILINEAR_ROOTS_LANES must be 1, 2, 4 or 8");
constexpr int kThreads = 128;
constexpr int kCells = 64;                    // samples t_i = i/64, i = 0..64
constexpr int kLaneCells = kCells / kLanes;   // cells one lane scans
constexpr int kBisect = 40;
constexpr int kTasks = 4;         // the last bracket of p, three of p'
constexpr int kLaneTasks = kLanes < kTasks ? kTasks / kLanes : 1;
constexpr int kLoads = kLanes < 4 ? 4 / kLanes : 1;  // float4 a lane reads
constexpr float kZero = 1e-9f;      // coefficients below this are zeroed
constexpr float kTangent = 1e-7f;   // |p(m)| <= this * sum|c| is a touch
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// torch.maximum: NaN if either is NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float sample(int i) {
  return mul(static_cast<float>(i), 1.0f / kCells);
}

// Horner, descending coefficients, starting from 0 + c[0] as the plain
// version does
template <int K>
__device__ __forceinline__ float horner(const float (&c)[K], float t) {
  float acc = add(0.0f, c[0]);
#pragma unroll
  for (int i = 1; i < K; ++i) acc = add(mul(acc, t), c[i]);
  return acc;
}

// a cell whose end values have a product <= 0 and are not both zero
__device__ __forceinline__ bool bracket(float l, float r) {
  return mul(l, r) <= 0.0f && !(l == 0.0f && r == 0.0f);
}

__device__ __forceinline__ float bisect(const float (&c)[5], float lo,
                                        float hi, float flo) {
#pragma unroll 1
  for (int i = 0; i < kBisect; ++i) {
    const float mid = mul(0.5f, add(lo, hi));
    const float fmid = horner(c, mid);
    const bool left = mul(flo, fmid) <= 0.0f;
    hi = left ? mid : hi;
    lo = left ? lo : mid;
    flo = left ? flo : fmid;
  }
  return mul(0.5f, add(lo, hi));
}

// the index of the highest set bit of a non-zero mask
__device__ __forceinline__ int top(unsigned long long m) {
  return 63 - __clzll(static_cast<long long>(m));
}

__device__ __forceinline__ float4 shfl4(float4 v, int lane) {
  return make_float4(__shfl_sync(kFull, v.x, lane, kLanes),
                     __shfl_sync(kFull, v.y, lane, kLanes),
                     __shfl_sync(kFull, v.z, lane, kLanes),
                     __shfl_sync(kFull, v.w, lane, kLanes));
}

template <class Rows>
__global__ void __launch_bounds__(kThreads) roots_kernel(Rows rows, int n) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  // a warp past the last row leaves whole; the rest run every shuffle, the
  // ragged groups on a copy of the last row
  if ((tid & ~31ll) / kLanes >= n) return;
  const int lane = static_cast<int>(tid % kLanes);
  const int row = static_cast<int>(tid / kLanes);
  const int src = row < n ? row : n - 1;
  const auto pre = rows.prefetch(src, lane);

  // 1. the row's four float4 (p, then q), each read by one lane
  //    (rows.load)
  float4 mine[kLoads];
#pragma unroll
  for (int s = 0; s < kLoads; ++s) {
    const int k = s * kLanes + lane;
    mine[s] = k < 4 ? rows.load(src, k) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  float4 v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (kLanes == 1) {
      v[k] = mine[k];
    } else {
      v[k] = shfl4(mine[k / kLanes], k % kLanes);
    }
  }
  const float P[8] = {v[0].x, v[0].y, v[0].z, v[0].w,
                      v[1].x, v[1].y, v[1].z, v[1].w};
  const float Q[8] = {v[2].x, v[2].y, v[2].z, v[2].w,
                      v[3].x, v[3].y, v[3].z, v[3].w};

  // cubes constant along y, z or x (corner idx = 4i + 2j + k)
  constexpr int kPairs[3][2][4] = {{{0, 1, 4, 5}, {2, 3, 6, 7}},
                                   {{0, 1, 2, 3}, {4, 5, 6, 7}},
                                   {{0, 4, 2, 6}, {1, 5, 3, 7}}};
  bool deg = false;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    bool all = true;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int t = kPairs[a][0][k], u = kPairs[a][1][k];
      all = all && P[t] == P[u] && Q[t] == Q[u];
    }
    deg = deg || all;
  }

  // quartic coefficients: Bernstein quadratics of the x = z diagonal of the
  // y = 0 face (corners 0,1,4,5) and the y = 1 face (2,3,6,7)
  const float qr[3] = {Q[0], add(Q[1], Q[4]), Q[5]};
  const float ps[3] = {P[2], add(P[3], P[6]), P[7]};
  const float qs[3] = {Q[2], add(Q[3], Q[6]), Q[7]};
  const float pr[3] = {P[0], add(P[1], P[4]), P[5]};
  constexpr float T[3][3] = {{1.f, -2.f, 1.f}, {-1.f, 1.f, 0.f},
                             {1.f, 0.f, 0.f}};
  float A[3][3], M[3][3], B[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      A[i][j] = sub(mul(qr[i], ps[j]), mul(qs[i], pr[j]));
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      M[a][j] = add(add(mul(T[0][a], A[0][j]), mul(T[1][a], A[1][j])),
                    mul(T[2][a], A[2][j]));
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      B[a][b] = add(add(mul(M[a][0], T[0][b]), mul(M[a][1], T[1][b])),
                    mul(M[a][2], T[2][b]));
  float c[5] = {B[0][0], add(B[1][0], B[0][1]),
                add(add(B[2][0], B[1][1]), B[0][2]), add(B[1][2], B[2][1]),
                B[2][2]};
#pragma unroll
  for (int i = 0; i < 5; ++i) c[i] = fabsf(c[i]) < kZero ? 0.0f : c[i];
  const float lead_sum =
      add(add(add(fabsf(c[0]), fabsf(c[1])), fabsf(c[2])), fabsf(c[3]));
  const bool nonconst = lead_sum > kZero;
  const float tau = mul(kTangent, add(lead_sum, fabsf(c[4])));
  const float dc[4] = {mul(c[0], 4.0f), mul(c[1], 3.0f), mul(c[2], 2.0f),
                       mul(c[3], 1.0f)};
  const float dpad[5] = {0.0f, dc[0], dc[1], dc[2], dc[3]};

  // 2. this lane's cells, then every lane's by an OR over the group
  const int first = lane * kLaneCells;
  unsigned long long bm = 0, dm = 0;
  {
    float vl = horner(c, sample(first)), dvl = horner(dc, sample(first));
#pragma unroll
    for (int i = 0; i < kLaneCells; ++i) {
      const float t = sample(first + i + 1);
      const float vr = horner(c, t), dvr = horner(dc, t);
      bm |= static_cast<unsigned long long>(bracket(vl, vr)) << i;
      dm |= static_cast<unsigned long long>(bracket(dvl, dvr)) << i;
      vl = vr;
      dvl = dvr;
    }
  }
  bm <<= first;
  dm <<= first;
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) {
    bm |= __shfl_xor_sync(kFull, bm, off, kLanes);
    dm |= __shfl_xor_sync(kFull, dm, off, kLanes);
  }
  if (!nonconst) bm = dm = 0;

  // the cells: p's last bracket, and p''s three highest brackets (a missing
  // one takes the last cell, as the plain version's _last_true does)
  const bool has = bm != 0;
  const int idx = has ? top(bm) : kCells - 1;
  bool dhas[3];
  int didx[3];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    dhas[e] = dm != 0;
    didx[e] = dhas[e] ? top(dm) : kCells - 1;
    dm &= ~(1ull << didx[e]);
  }

  // 3-4. this lane's tasks (task 0: p in its last bracket; task e: p' in
  //      its e-th highest bracket, then the probe), and its best candidate
  float x = -1.0f;
#pragma unroll
  for (int s = 0; s < kLaneTasks; ++s) {
    const int task = (s * kLanes + lane) % kTasks;
    const bool deriv = task != 0;
    const int cell = task == 0   ? idx
                     : task == 1 ? didx[0]
                     : task == 2 ? didx[1]
                                 : didx[2];
    const bool found = task == 0   ? has
                       : task == 1 ? dhas[0]
                       : task == 2 ? dhas[1]
                                   : dhas[2];
    float k[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) k[i] = deriv ? dpad[i] : c[i];
    const float lo = sample(cell), hi = sample(cell + 1);
    const float a = bisect(k, lo, hi, horner(k, lo));  // phase A
    float cand = found ? a : -1.0f;
    if (deriv) {  // phase B: a is the extremum m
      const float pm = horner(c, a);
      const bool cross = mul(pm, horner(c, hi)) < 0.0f;
      const float pair = bisect(c, a, hi, pm);  // the later of a hidden pair
      cand = !found               ? -1.0f
             : cross              ? pair
             : fabsf(pm) <= tau   ? a  // a tangent root
                                  : -1.0f;
    }
    x = nan_max(x, cand);
  }
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1)
    x = nan_max(x, __shfl_xor_sync(kFull, x, off, kLanes));
  x = __shfl_sync(kFull, x, 0, kLanes);  // lane 0's, in every lane

  // 5. y from the root, the sentinels, and x, y, x written by lanes 0-2
  const float u = sub(1.0f, x);
  const float X0 = mul(u, u), X1 = mul(x, u), X3 = mul(x, x);
  const float AX = add(add(add(mul(Q[0], X0), mul(Q[1], X1)), mul(Q[4], X1)),
                       mul(Q[5], X3));
  const float BX = add(add(add(mul(Q[2], X0), mul(Q[3], X1)), mul(Q[6], X1)),
                       mul(Q[7], X3));
  const float y = __fdiv_rn(AX, sub(AX, BX));
  const float xo = (deg || !isfinite(x)) ? -1.0f : x;
  const float yo = (deg || !isfinite(y)) ? -1.0f : y;
  if (row < n) {
#pragma unroll
    for (int j = lane; j < 3; j += kLanes)
      rows.store(row, j, j == 1 ? yo : xo, pre);
  }
}


// p, q [n, 8] row-major, 16-byte aligned; out [n, 3]
struct PlainRows {
  struct None {};
  const float4* __restrict__ p4;
  const float4* __restrict__ q4;
  float* __restrict__ out;
  __device__ __forceinline__ None prefetch(int, int) const { return {}; }
  __device__ __forceinline__ float4 load(int row, int k) const {
    return k < 2 ? p4[2 * row + k] : q4[2 * row + k - 2];
  }
  __device__ __forceinline__ void store(int row, int j, float v,
                                        None) const {
    out[3 * row + j] = v;
  }
};

// the solve of n rows on `stream`: the CUDA error of the launch, or 0
// (cudaErrorInvalidValue, without a launch, when n * kLanes overflows an
// int)
template <class Rows>
int launch(const Rows& rows, int n, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (n > INT_MAX / kLanes) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>(
      (static_cast<long long>(n) * kLanes + kThreads - 1) / kThreads);
  roots_kernel<Rows><<<blocks, kThreads, 0, stream>>>(rows, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k7
}  // namespace
