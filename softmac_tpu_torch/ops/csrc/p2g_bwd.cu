// Backward of P2G: cotangents of the 13 particle channels and of the
// positions, from the cotangents of the mass and momentum windows.
//
// Replaces: softmac_tpu/ops/pallas_chunked.py _p2g_c_bwd_pallas /
// _p2g_c_bwd_kernel (the custom_vjp backward of pallas_chunked.family().
// p2g_c), same function as jax.vjp of mpm.p2g_dense composed with
// mpm.axis_weights.
//
// P2G is linear in the channels, so their cotangent is a gather of the
// window cotangents over the particle's 27 stencil cells (the adjoint of
// the sum in transfer.p2g_plain):
//   dchan[0]      = sum W dgm          dchan[1 + d] = sum W dgmom_d
//   dchan[4 + 3d] = sum WxD dgmom_d    dchan[5 + 3d] = sum WDy dgmom_d
//   dchan[6 + 3d] = sum WDz dgmom_d
// and the positions take the cotangent through the weights
// (bspline.cuh stencil_adjoint), with the per-cell cotangents
//   s_W = mass dgm + mom . dgmom,  s_WxD = a_.0 . dgmom,
//   s_WDy = a_.1 . dgmom,          s_WDz = a_.2 . dgmom.
// Cells outside the window have zero weight and are skipped, as in the
// forward kernel. The TPU kernel builds (wy*wz, T) weight slabs and takes
// MXU dots; here one thread walks one particle's stencil.
//
// What bounds it on the H100: bytes. It reads x and the 13 channels,
// writes 16 floats a particle, and reads the two windows (L2-resident):
// 32 floats a particle + 4 a cell, 13.1 MB at 1e5 particles in a
// (40, 32, 16) window, 3.9 us at 3.35 TB/s. It is a gather: no atomics.
//
// Simple design: one thread per particle, window reads through the
// read-only path, sums in registers, coalesced row-major stores.
#include "bspline.cuh"

namespace {

__global__ void p2g_bwd_kernel(const float* __restrict__ x,
                               const float* __restrict__ chan,
                               const int* __restrict__ corner,
                               const float* __restrict__ dgm,
                               const float* __restrict__ dgmom,
                               float* __restrict__ dx,
                               float* __restrict__ dchan,
                               int n, int wx, int wy, int wz, float inv_dx) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;

  softmac::Axis ax[3];
  int rel[3];
  softmac::particle_stencil(x, n, p, corner, inv_dx, ax, rel);
  const float mass = chan[p];
  float mom[3], a[3][3];
  for (int d = 0; d < 3; ++d) {
    mom[d] = chan[(1 + d) * n + p];
    for (int j = 0; j < 3; ++j) a[d][j] = chan[(4 + 3 * d + j) * n + p];
  }

  float acc[13];
  for (int c = 0; c < 13; ++c) acc[c] = 0.f;
  const int w3 = 3 * wx;
  auto cell = [&](int row, int cx, float W, float WxD, float WDy, float WDz,
                  float s[4]) {
    const float gmc = __ldg(dgm + row * wx + cx);
    float gd[3];
    for (int d = 0; d < 3; ++d) gd[d] = __ldg(dgmom + row * w3 + d * wx + cx);
    acc[0] += W * gmc;
    s[0] = mass * gmc;
    s[1] = s[2] = s[3] = 0.f;
    for (int d = 0; d < 3; ++d) {
      acc[1 + d] += W * gd[d];
      acc[4 + 3 * d] += WxD * gd[d];
      acc[5 + 3 * d] += WDy * gd[d];
      acc[6 + 3 * d] += WDz * gd[d];
      s[0] += mom[d] * gd[d];
      s[1] += a[d][0] * gd[d];
      s[2] += a[d][1] * gd[d];
      s[3] += a[d][2] * gd[d];
    }
  };
  float g[3];
  softmac::stencil_adjoint(ax, rel, wx, wy, wz, inv_dx, cell, g);
  for (int d = 0; d < 3; ++d) dx[d * n + p] = g[d];
  for (int c = 0; c < 13; ++c) dchan[c * n + p] = acc[c];
}

}  // namespace

// x (3, n), chan (13, n) and corner (3,) int32 as for softmac_p2g; dgm
// (wy*wz, wx) and dgmom (wy*wz, 3*wx) the cotangents of its outputs.
// Writes dx (3, n) and dchan (13, n). Returns cudaGetLastError() after the
// launch.
extern "C" int softmac_p2g_bwd(const float* x, const float* chan,
                               const int* corner, const float* dgm,
                               const float* dgmom, float* dx, float* dchan,
                               int n, int wx, int wy, int wz, float inv_dx,
                               void* stream) {
  if (n > 0) {
    p2g_bwd_kernel<<<softmac::blocks_for(n), softmac::kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        x, chan, corner, dgm, dgmom, dx, dchan, n, wx, wy, wz, inv_dx);
  }
  return static_cast<int>(cudaGetLastError());
}
