// Backward of the gather: cotangents of the positions and of the three
// velocity grids, from the cotangent of the gathered velocity (3, N).
//
// Replaces: softmac_tpu/ops/pallas_chunked.py _gather_c_bwd_pallas /
// _gather_c_bwd_kernel (the custom_vjp backward of pallas_chunked.family().
// gather_c), same function as jax.vjp of mpm.gather_dense composed with
// mpm.axis_weights.
//
// With dv_d the cotangent of out[d] = sum W g_d:
//   grids:     dg_d[c] += W dv_d over each particle's stencil cells inside
//              the window: G2P's backward splat without the C rows
//              (bspline.cuh splat_stencil), float64 atomics rounded once to
//              float32, so repeated runs are bit-identical;
//   positions: a gather through the weights (bspline.cuh stencil_adjoint)
//              with the per-cell weight cotangent s_W = dv . g_c.
// Cells outside the window are skipped, as in the forward kernel.
//
// What bounds it on the H100: by bytes it reads x and dv (6 floats a
// particle) and the three grids, and writes dx and three grid cotangents:
// about 2.6 MB at 1e5 particles and a (32, 32, 16) window, 0.8 us at
// 3.35 TB/s. In practice, like G2P's backward, the 81 float64 atomics a
// particle performs on a window that neighbouring particles hit at once.
//
// Simple design: one thread per particle does both parts, one stencil walk
// each; a second small launch rounds the float64 grids.
#include "bspline.cuh"

namespace {

__global__ void gather_bwd_kernel(const float* __restrict__ x,
                                  const float* __restrict__ gv0,
                                  const float* __restrict__ gv1,
                                  const float* __restrict__ gv2,
                                  const int* __restrict__ corner,
                                  const float* __restrict__ dv,
                                  float* __restrict__ dx,
                                  double* __restrict__ dgrid,
                                  int n, int wx, int wy, int wz, float inv_dx) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;

  softmac::Axis ax[3];
  int rel[3];
  softmac::particle_stencil(x, n, p, corner, inv_dx, ax, rel);
  const float g[3] = {dv[p], dv[n + p], dv[2 * n + p]};
  const float none[3][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
  const int cells = wx * wy * wz;
  softmac::splat_stencil(ax, rel, wx, wy, wz, nullptr, 0.f, dgrid, wx, cells,
                         g, none);

  auto cell = [&](int row, int cx, float, float, float, float, float s[4]) {
    const int idx = row * wx + cx;
    s[0] = g[0] * __ldg(gv0 + idx) + g[1] * __ldg(gv1 + idx)
           + g[2] * __ldg(gv2 + idx);
    s[1] = s[2] = s[3] = 0.f;
  };
  float gx[3];
  softmac::stencil_adjoint(ax, rel, wx, wy, wz, inv_dx, cell, gx);
  for (int d = 0; d < 3; ++d) dx[d * n + p] = gx[d];
}

}  // namespace

// x (3, n), gv0..gv2 (wy*wz, wx) and corner (3,) int32 as for
// softmac_gather; dv (3, n) the cotangent of its output. acc: 3 * wy*wz*wx
// doubles zeroed by the caller; out: the three grid cotangents in float32,
// one (wy*wz, wx) grid after the other; dx (3, n). Returns
// cudaGetLastError() after the launches.
extern "C" int softmac_gather_bwd(const float* x, const float* gv0,
                                  const float* gv1, const float* gv2,
                                  const int* corner, const float* dv,
                                  float* dx, double* acc, float* out, int n,
                                  int wx, int wy, int wz, float inv_dx,
                                  void* stream) {
  const int cells = wx * wy * wz;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    gather_bwd_kernel<<<softmac::blocks_for(n), softmac::kThreads, 0, s>>>(
        x, gv0, gv1, gv2, corner, dv, dx, acc, n, wx, wy, wz, inv_dx);
  }
  softmac::round_to_float<<<softmac::blocks_for(3 * cells), softmac::kThreads,
                            0, s>>>(acc, out, 3 * cells);
  return static_cast<int>(cudaGetLastError());
}
