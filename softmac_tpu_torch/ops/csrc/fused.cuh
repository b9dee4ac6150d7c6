// The per-axis weight matrices of the door's dense-weight kernels
// (fused_rows.cuh and the eight kernels on it): (rows, n) row-major, row r
// of axis d holding every particle's weight on window row r, so reading
// one particle's column is one float per row, strided by n; across a warp
// (32 neighbouring particles) each such read is one coalesced 128-byte
// line. A particle whose stencil leaves the window has an all-zero column
// on some axis (mpm.axis_weights zeroes rows outside the window): its box
// there is empty and it contributes nothing.
#pragma once

#include "bspline.cuh"

namespace softmac {

// weight matrix w at row r of particle p, in double
__device__ __forceinline__ double at(const float* __restrict__ w, int r,
                                     int n, int p) {
  return static_cast<double>(__ldg(w + static_cast<size_t>(r) * n + p));
}

}  // namespace softmac
