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

#include "trilinear_roots.cuh"

// threads given to each row
extern "C" int trilinear_roots_lanes() { return k7::kLanes; }

// p, q [n, 8] row-major f32 on the device, 16-byte aligned; writes out [n, 3]
// f32.  Launches on `stream` and returns the CUDA error of the launch, or 0
// (cudaErrorInvalidValue, without a launch, when n * kLanes overflows an
// int).
extern "C" int trilinear_roots_launch(const float* p, const float* q, int n,
                                      float* out, cudaStream_t stream) {
  return k7::launch(k7::PlainRows{reinterpret_cast<const float4*>(p),
                                  reinterpret_cast<const float4*>(q), out},
                    n, stream);
}
