// Backward of G2P: cotangents of the positions and of the three velocity
// grids, from the cotangents of G2P's 12 output rows (v, unscaled C).
//
// Replaces: softmac_tpu/ops/pallas_chunked.py _g2p_c_bwd_pallas /
// _g2p_c_bwd_kernel (the custom_vjp backward of pallas_chunked.family().
// g2p_c), same function as jax.vjp of mpm.g2p_dense composed with
// mpm.axis_weights. Only rows 0-11 of the cotangent exist: the port's G2P
// returns 12 rows, the TPU kernel 16 (4 of them zero padding).
//
// With dv_d = g[d] and dC_dj = g[3 + 3d + j]:
//   grids:     dg_d[c] += W dv_d + WxD dC_d0 + WDy dC_d1 + WDz dC_d2
//              over each particle's stencil cells: exactly P2G's momentum
//              splat with dv in place of the momentum and dC in place of
//              the affine rows (bspline.cuh splat_stencil, shared with
//              p2g.cu), float64 atomics rounded once to float32 for the
//              same run-to-run reproducibility as P2G;
//   positions: a gather through the weights (bspline.cuh stencil_adjoint)
//              with the per-cell cotangents s_W = dv . g_c,
//              s_WxD = dC_.0 . g_c, s_WDy = dC_.1 . g_c, s_WDz = dC_.2 . g_c.
// Cells outside the window are skipped, as in the forward kernel.
//
// What bounds it on the H100: bytes (x, 12 cotangent rows, 3 grids in;
// dx and 3 grid cotangents out: 18 floats a particle + 6 a cell, 7.7 MB
// at 1e5 particles, 2.3 us at 3.35 TB/s); in practice, like P2G, the
// 81 same-address float64 atomics a particle performs.
//
// Simple design: one thread per particle does both parts in one stencil
// walk each; a second small launch rounds the float64 grids.
#include "bspline.cuh"

namespace {

__global__ void g2p_bwd_kernel(const float* __restrict__ x,
                               const float* __restrict__ gv0,
                               const float* __restrict__ gv1,
                               const float* __restrict__ gv2,
                               const int* __restrict__ corner,
                               const float* __restrict__ g,
                               float* __restrict__ dx,
                               double* __restrict__ dgrid,
                               int n, int wx, int wy, int wz, float inv_dx) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;

  softmac::Axis ax[3];
  int rel[3];
  softmac::particle_stencil(x, n, p, corner, inv_dx, ax, rel);
  float dv[3], dC[3][3];
  for (int d = 0; d < 3; ++d) {
    dv[d] = g[d * n + p];
    for (int j = 0; j < 3; ++j) dC[d][j] = g[(3 + 3 * d + j) * n + p];
  }
  const int cells = wx * wy * wz;
  softmac::splat_stencil(ax, rel, wx, wy, wz, nullptr, 0.f, dgrid, wx, cells,
                         dv, dC);

  auto cell = [&](int row, int cx, float, float, float, float, float s[4]) {
    const int idx = row * wx + cx;
    const float gc[3] = {__ldg(gv0 + idx), __ldg(gv1 + idx), __ldg(gv2 + idx)};
    s[0] = s[1] = s[2] = s[3] = 0.f;
    for (int d = 0; d < 3; ++d) {
      s[0] += dv[d] * gc[d];
      s[1] += dC[d][0] * gc[d];
      s[2] += dC[d][1] * gc[d];
      s[3] += dC[d][2] * gc[d];
    }
  };
  float gx[3];
  softmac::stencil_adjoint(ax, rel, wx, wy, wz, inv_dx, cell, gx);
  for (int d = 0; d < 3; ++d) dx[d * n + p] = gx[d];
}

}  // namespace

// x (3, n), gv0..gv2 (wy*wz, wx) and corner (3,) int32 as for softmac_g2p;
// g (12, n) the cotangent of its output. acc: 3 * wy*wz*wx doubles zeroed
// by the caller; out: the three grid cotangents in float32, one
// (wy*wz, wx) grid after the other; dx (3, n). Returns cudaGetLastError()
// after the launches.
extern "C" int softmac_g2p_bwd(const float* x, const float* gv0,
                               const float* gv1, const float* gv2,
                               const int* corner, const float* g, float* dx,
                               double* acc, float* out, int n, int wx, int wy,
                               int wz, float inv_dx, void* stream) {
  const int cells = wx * wy * wz;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    g2p_bwd_kernel<<<softmac::blocks_for(n), softmac::kThreads, 0, s>>>(
        x, gv0, gv1, gv2, corner, g, dx, acc, n, wx, wy, wz, inv_dx);
  }
  softmac::round_to_float<<<softmac::blocks_for(3 * cells), softmac::kThreads,
                            0, s>>>(acc, out, 3 * cells);
  return static_cast<int>(cudaGetLastError());
}
