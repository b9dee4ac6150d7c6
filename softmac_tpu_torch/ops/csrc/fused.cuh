// Shared by the forward dense-weight splat and gather (fused_splat.cu,
// fused_gather.cu; `at` also by fused_rows.cuh, the row-thread design of
// the other dense-weight kernels): the per-axis weight matrices are
// (rows, n) row-major, row r of axis d holding every particle's weight on
// window row r, so reading one particle's column is one float per row,
// strided by n; across a warp (32 neighbouring particles) each such read
// is one coalesced 128-byte line.
//
// A kernel first finds, for each axis, the first and the last row on which
// the particle has a nonzero weight, then visits only the cells inside
// those three row ranges. For B-spline weights that is the particle's
// 3 x 3 x 3 stencil; for dense weights, the whole window. A
// particle whose stencil leaves the window has an all-zero column on some
// axis (mpm.axis_weights zeroes rows outside the window), so its range is
// empty and it contributes nothing. N is any size: no padding to a tile.
#pragma once

#include "bspline.cuh"

namespace softmac {

// Range [*lo, *hi] of the rows r with a[r, p] != 0; *lo > *hi when there
// is none.
__device__ __forceinline__ void nonzero_rows(const float* __restrict__ a,
                                             int rows, int n, int p, int* lo,
                                             int* hi) {
  int l = rows, h = -1;
  for (int r = 0; r < rows; ++r) {
    if (__ldg(a + static_cast<size_t>(r) * n + p) != 0.0f) {
      if (r < l) l = r;
      h = r;
    }
  }
  *lo = l;
  *hi = h;
}

__device__ __forceinline__ double at(const float* __restrict__ w, int r,
                                     int n, int p) {
  return static_cast<double>(__ldg(w + static_cast<size_t>(r) * n + p));
}

}  // namespace softmac
