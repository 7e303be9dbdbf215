// The root solve of tropical_torch/csrc/trilinear_roots.cu in its first,
// one-thread-per-row design, kept for comparison by
// scripts/trilinear_roots_variants.py (the port never loads it): each
// thread scans its row's cells from the last one down, probes each
// derivative bracket where it is met, and stops once it has the last
// bracket and three derivative brackets.
//
// Result: bitwise the plain PyTorch version's,
// tropical_torch/core/trilinear.py:intersection_of_two_planes_plain.  Every
// product, sum and quotient is one IEEE round-to-nearest operation
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, which nvcc never contracts to
// an FMA), in the plain version's order: T^T A T written out term by term,
// Horner one rounded product and one rounded sum a step, each reduction left
// to right.  The samples t_i = i/64 are exact.  Inputs are finite.
//
// Per row (all in registers):
//   1. the quartic's coefficients from p, q; |c| < 1e-9 zeroed;
//   2. the scan: the 64 cells of [0, 1], from the last one down, with p and
//      p' evaluated at each sample on the fly.  The first sign-change cell of
//      p met is the last bracket; the first three of p' are the three
//      highest-index derivative brackets, the same ones the plain version
//      takes.  The scan stops once it has all four;
//   3. each derivative bracket is probed where it is met: its extremum m by
//      40 bisections of p'; a sign change of p between m and the cell's end
//      is the later root of a hidden pair (40 bisections of p), and
//      |p(m)| <= 1e-7 sum|c| a tangent root at m.  The root is the
//      NaN-propagating max over the last bracket's bisection and the probes'
//      candidates (max is order-free here: every candidate is -1 or a
//      midpoint of two finite samples, so none is NaN);
//   4. y = AX / (AX - BX) at that root, and the -1 sentinels: for cubes
//      constant along x, y or z, and for each non-finite coordinate.
//
// Its operation count is the one chip_smoke.py's bound takes (see the
// kernel's note); what its branches cost on the card is measured by
// scripts/trilinear_roots_variants.py.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCells = 64;          // samples t_i = i/64, i = 0..64
constexpr int kBisect = 40;
constexpr int kExtrema = 3;         // a quartic has at most 3 extrema
constexpr float kZero = 1e-9f;      // coefficients below this are zeroed
constexpr float kTangent = 1e-7f;   // |p(m)| <= this * sum|c| is a touch

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

template <int K>
__device__ float bisect(const float (&c)[K], float lo, float hi, float flo) {
#pragma unroll 1
  for (int i = 0; i < kBisect; ++i) {
    const float mid = mul(0.5f, add(lo, hi));
    const float fmid = horner(c, mid);
    if (mul(flo, fmid) <= 0.0f) {
      hi = mid;
    } else {
      lo = mid;
      flo = fmid;
    }
  }
  return mul(0.5f, add(lo, hi));
}

__global__ void __launch_bounds__(kThreads)
trilinear_roots_kernel(const float4* __restrict__ p4,
                       const float4* __restrict__ q4, int n,
                       float* __restrict__ out) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= n) return;
  const float4 pa = p4[2 * row], pb = p4[2 * row + 1];
  const float4 qa = q4[2 * row], qb = q4[2 * row + 1];
  const float P[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
  const float Q[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};

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

  // 1. quartic coefficients: Bernstein quadratics of the x = z diagonal of
  //    the y = 0 face (corners 0,1,4,5) and the y = 1 face (2,3,6,7)
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

  // 2-3. scan the cells from the last one down, probing each derivative
  //      bracket where it is met
  float root = -1.0f;
  float probe = -1.0f;
  if (nonconst) {
    bool has = false;
    int found = 0;
    float vr = horner(c, 1.0f), dvr = horner(dc, 1.0f);
#pragma unroll 1
    for (int i = kCells - 1; i >= 0 && !(has && found == kExtrema); --i) {
      const float t = sample(i);
      const float vl = horner(c, t), dvl = horner(dc, t);
      if (!has && bracket(vl, vr)) {
        has = true;
        root = bisect(c, t, sample(i + 1), vl);
      }
      if (found < kExtrema && bracket(dvl, dvr)) {
        ++found;
        const float hi = sample(i + 1);
        const float m = bisect(dc, t, hi, dvl);  // the extremum
        const float pm = horner(c, m);
        float cand = -1.0f;
        if (mul(pm, vr) < 0.0f) {
          cand = bisect(c, m, hi, pm);           // the later of a hidden pair
        } else if (fabsf(pm) <= tau) {
          cand = m;                              // a tangent root
        }
        probe = nan_max(probe, cand);
      }
      vr = vl;
      dvr = dvl;
    }
  }
  const float x = nan_max(root, probe);

  // 4. y from the root, and the sentinels
  const float u = sub(1.0f, x);
  const float X0 = mul(u, u), X1 = mul(x, u), X3 = mul(x, x);
  const float AX = add(add(add(mul(Q[0], X0), mul(Q[1], X1)), mul(Q[4], X1)),
                       mul(Q[5], X3));
  const float BX = add(add(add(mul(Q[2], X0), mul(Q[3], X1)), mul(Q[6], X1)),
                       mul(Q[7], X3));
  const float y = __fdiv_rn(AX, sub(AX, BX));
  const float xo = (deg || !isfinite(x)) ? -1.0f : x;
  out[3 * row + 0] = xo;
  out[3 * row + 1] = (deg || !isfinite(y)) ? -1.0f : y;
  out[3 * row + 2] = xo;
}

}  // namespace

// threads given to each row
extern "C" int trilinear_roots_lanes() { return 1; }

// p, q [n, 8] row-major f32 on the device, 16-byte aligned; writes out [n, 3]
// f32.  Launches on `stream` and returns the CUDA error of the launch, or 0.
extern "C" int trilinear_roots_launch(const float* p, const float* q, int n,
                                      float* out, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (n + kThreads - 1) / kThreads;
  trilinear_roots_kernel<<<blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(p), reinterpret_cast<const float4*>(q),
      n, out);
  return static_cast<int>(cudaGetLastError());
}
