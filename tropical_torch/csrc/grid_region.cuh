// The grid region of a point along one axis, through the uniform lookup
// table of _grid_region_lut (tropical/extract/device.py:254): the cell
// offset (the marks below xu + eps, less one) and whether the point lies on
// the mark at that offset (within eps).  K5's candidates
// (device_engine.cu) and K6's face_keys (faces.cu) share it; its plain
// version is _grid_region_lut in tropical_torch/extract/device.py, which it
// equals bit for bit (one rounding an operation, in the plain version's
// order).
#pragma once

#include <cuda_runtime.h>

namespace {
namespace grid_region {

constexpr int kLutCells = 1024;  // device.py LUTN

// a world coordinate's unit-cube coordinate, (x + scale) / (scale * 2)
__device__ __forceinline__ float unit(float x, float scale) {
  return __fdiv_rn(__fadd_rn(x, scale), scale * 2.0f);
}

// the cell offset of the unit-cube coordinate xu, in [-1, M - 1]: lut[j]
// counts the marks below j / 1024, and lut_k reads (the most marks in one
// table cell) count those in the point's table cell; *on_plane: the mark
// at the offset (the last mark for -1) within eps of xu
__device__ __forceinline__ int cell(float xu, float eps,
                                    const float* __restrict__ marks, int M,
                                    const int* __restrict__ lut, int lut_k,
                                    bool* on_plane) {
  const float q = __fadd_rn(xu, eps);
  const int j = min(max(static_cast<int>(__fmul_rn(q, 1024.0f)), 0),
                    kLutCells - 1);
  int cnt = lut[j];
  const int start = cnt;
  for (int s = 0; s < lut_k; ++s) {
    const int pos = start + s;
    cnt += (pos < M) && (marks[min(pos, M - 1)] < q);
  }
  const int off = cnt - 1;
  const int wrapped = off < 0 ? off + M : off;
  const float at = marks[min(max(wrapped, 0), M - 1)];
  *on_plane = !(fabsf(__fsub_rn(at, xu)) > eps);
  return off;
}

}  // namespace grid_region
}  // namespace
