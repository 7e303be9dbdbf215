// Intersection of two trilinear surfaces with the diagonal plane x = z of an
// edge's cube: the curved extraction path's root solve.
//
// Replaces the jitted XLA program of tropical/core/trilinear.py:91
// (intersection_of_two_planes) with tropical/core/roots.py:66
// (poly_roots_01), K7 in ROADMAP.md; the JAX package wrote no Pallas kernel
// for it, and XLA fused the whole solve into one program.  In eager PyTorch
// the same solve is some 2,000 small launches a call (seven 40-step
// bisections of several elementwise operations each), so it is one kernel
// here.
//
// Result: bitwise the plain PyTorch version's,
// tropical_torch/core/trilinear.py:intersection_of_two_planes_plain.  Every
// product, sum and quotient is one IEEE round-to-nearest operation
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, which nvcc never contracts to
// an FMA), in the plain version's order: T^T A T written out term by term,
// Horner one rounded product and one rounded sum a step, each reduction left
// to right.  The samples t_i = i/64 are exact, so any lane that evaluates a
// sample gets the plain version's bits.  Inputs are finite.
//
// A group of kLanes threads (4; 1, 2 or 8 with -DTRILINEAR_ROOTS_LANES, for
// scripts/trilinear_roots_variants.py) solves one row, and no branch depends
// on the data:
//   1. load: each lane reads one of the row's four float4 (p, then q) and
//      shuffles gather the row into every lane; each lane computes the
//      quartic's coefficients itself (|c| < 1e-9 zeroed);
//   2. scan: lane k evaluates p and p' at samples 16k .. 16k+16 and marks
//      its 16 cells; an OR of the lanes' masks by shuffle gives every lane
//      the row's 64-bit bracket masks of p and p'.  The highest set bit of
//      p's is the last bracket, the three highest of p''s the derivative
//      brackets the plain version's _last_true loop picks;
//   3. phase A, four bisections side by side, one a lane: lane 0 bisects p
//      in the last bracket, lanes 1-3 bisect p' in the 1st, 2nd and 3rd
//      highest derivative bracket, all on one 5-term Horner (p' padded as
//      [0, 4c0, 3c1, 2c2, c3], whose leading 0*t + 0 = +0 gives the 4-term
//      Horner's bits for t in [0, 1]).  A lane without a bracket bisects a
//      dummy cell and drops the result;
//   4. phase B: lanes 1-3 evaluate p at the extremum m and at the cell's
//      end; where they differ in sign, the lane bisects p on [m, cell end]
//      (the later root of a hidden pair), and |p(m)| <= 1e-7 sum|c| makes m
//      a tangent root.  Lanes 1-3 run the bisection, pair or not;
//   5. the NaN-propagating max of the lanes' candidates by shuffle (max is
//      order-free here: every candidate is -1 or a midpoint of two finite
//      samples, so none is NaN), y = AX / (AX - BX) at that root, the -1
//      sentinels (cubes constant along x, y or z, each non-finite
//      coordinate), and lanes 0-2 write x, y, x.
//
// Bound: operations.  A row reads p and q (64 bytes) and writes 12 bytes:
// 76 bytes, 0.023 us per 1,000 rows at 3.35 TB/s.  The plain algorithm
// needs 134 operations for the coefficients, 16 for the first samples and
// 19 a cell scanned, 483 for the last bracket's bisection, 413 a derivative
// probe and 482 more where it bisects a hidden pair, and 20 for y: 2,000 to
// 3,000 for a typical row.  None is fused, so each issues as one
// instruction at 33.5 Tops/s, half the H100's 67 TFLOP/s f32 peak, which
// counts an FMA as two.  chip_smoke.py counts what the run's rows need.
// This design does more: each of its four lanes computes the coefficients
// (134), a quarter of the scan (321), one bisection (493) and y (20), and
// lanes 1-3 a second bisection with its probe (501): 5,375 operations a
// row, the price of running a row's chains side by side and the same way
// in every lane.
//
// Why four lanes a row (scripts/trilinear_roots_variants.py, device time
// on an H100 80GB HBM3 at 700 W, the curved run's largest input of 8,460
// rows): one thread a row, scanning from the last cell down with an early
// stop and each probe where its bracket is met, took 56 us, and 10 us
// when every warp's rows were made copies of one row: 46 us went to
// threads of a warp waiting on each other's branches, and 8,460 rows were
// 67 blocks for 132 SMs.  With no branch on the data, 1, 2, 4 and 8 lanes
// a row take 12.9, 8.6, 5.8 and 8.5 us, each the same with uniform warps.
// At 100,000 rows, which the path does not reach, one lane is fastest
// (29 us against 34), the card being full already.

#include <cuda_runtime.h>

#include <climits>

#ifndef TRILINEAR_ROOTS_LANES
#define TRILINEAR_ROOTS_LANES 4
#endif

namespace {

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

__global__ void __launch_bounds__(kThreads)
trilinear_roots_kernel(const float4* __restrict__ p4,
                       const float4* __restrict__ q4, int n,
                       float* __restrict__ out) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  // a warp past the last row leaves whole; the rest run every shuffle, the
  // ragged groups on a copy of the last row
  if ((tid & ~31ll) / kLanes >= n) return;
  const int lane = static_cast<int>(tid % kLanes);
  const int row = static_cast<int>(tid / kLanes);
  const int src = row < n ? row : n - 1;

  // 1. the row's four float4 (p, then q), each read by one lane
  float4 mine[kLoads];
#pragma unroll
  for (int s = 0; s < kLoads; ++s) {
    const int k = s * kLanes + lane;
    mine[s] = k < 4 ? (k < 2 ? p4[2 * src + k] : q4[2 * src + k - 2])
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
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
    for (int j = lane; j < 3; j += kLanes) out[3 * row + j] = j == 1 ? yo : xo;
  }
}

}  // namespace

// threads given to each row
extern "C" int trilinear_roots_lanes() { return kLanes; }

// p, q [n, 8] row-major f32 on the device, 16-byte aligned; writes out [n, 3]
// f32.  Launches on `stream` and returns the CUDA error of the launch, or 0
// (cudaErrorInvalidValue, without a launch, when n * kLanes overflows an
// int).
extern "C" int trilinear_roots_launch(const float* p, const float* q, int n,
                                      float* out, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (n > INT_MAX / kLanes) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>(
      (static_cast<long long>(n) * kLanes + kThreads - 1) / kThreads);
  trilinear_roots_kernel<<<blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(p), reinterpret_cast<const float4*>(q),
      n, out);
  return static_cast<int>(cudaGetLastError());
}
