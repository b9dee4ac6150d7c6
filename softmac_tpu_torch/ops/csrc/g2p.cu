// G2P: weighted gather of grid velocity and of the MLS affine field C from
// the active grid window back to the particles.
//
// Replaces: softmac_tpu/ops/pallas_chunked.py _g2p_c_pallas / _g2p_c_kernel
// (the y-chunked Pallas G2P), same function as mpm.g2p_dense.
//
// Computes, for every particle p over its 27 stencil cells inside the
// window, with g_d the three velocity grids (wy*wz, wx):
//   out[d]         = sum W g_d                   (velocity, rows 0-2)
//   out[3 + 3d + 0] = sum WxD Wy Wz g_d           (C[d][0], unscaled)
//   out[3 + 3d + 1] = sum Wx WDy Wz g_d           (C[d][1], unscaled)
//   out[3 + 3d + 2] = sum Wx Wy WDz g_d           (C[d][2], unscaled)
// The caller scales C by 4 * inv_dx (mpm._Transfers.g2p). The JAX kernel's
// output has 16 rows, rows 12-15 being zero sublane padding; nothing reads
// them, so this kernel writes the 12 rows the substep uses.
//
// What bounds it on the H100: bytes. It reads 3 position floats a particle
// and the window's three grids (240 KB at (40, 32, 16), L2-resident), and
// writes 12 floats a particle: about 6.2 MB at 1e5 particles, 1.9 us at
// 3.35 TB/s. The 81 grid reads a particle hit L1/L2, and the sorted
// particle order makes a warp read neighbouring cells.
//
// Simple design: one thread per particle, read-only loads through the
// texture path (__ldg), sums in registers, coalesced row-major stores.
#include "bspline.cuh"

namespace {

__global__ void g2p_kernel(const float* __restrict__ x,
                           const float* __restrict__ gv0,
                           const float* __restrict__ gv1,
                           const float* __restrict__ gv2,
                           const int* __restrict__ corner,
                           float* __restrict__ out,
                           int n, int wx, int wy, int wz, float inv_dx) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;

  softmac::Axis ax[3];
  int rel[3];
  for (int d = 0; d < 3; ++d) {
    ax[d] = softmac::axis_weights(x[d * n + p], inv_dx);
    rel[d] = ax[d].base - corner[d];
  }

  float v[3] = {0.f, 0.f, 0.f};
  float c[3][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
  for (int j = 0; j < 3; ++j) {
    const int cy = rel[1] + j;
    if (cy < 0 || cy >= wy) continue;
    for (int k = 0; k < 3; ++k) {
      const int cz = rel[2] + k;
      if (cz < 0 || cz >= wz) continue;
      const int row = cy * wz + cz;
      const float wyz = ax[1].w[j] * ax[2].w[k];
      const float dyz = ax[1].wd[j] * ax[2].w[k];
      const float ydz = ax[1].w[j] * ax[2].wd[k];
      for (int i = 0; i < 3; ++i) {
        const int cx = rel[0] + i;
        if (cx < 0 || cx >= wx) continue;
        const int idx = row * wx + cx;
        const float g[3] = {__ldg(gv0 + idx), __ldg(gv1 + idx), __ldg(gv2 + idx)};
        const float wgt = ax[0].w[i] * wyz;
        const float dwx = ax[0].wd[i] * wyz;
        const float dwy = ax[0].w[i] * dyz;
        const float dwz = ax[0].w[i] * ydz;
        for (int d = 0; d < 3; ++d) {
          v[d] += wgt * g[d];
          c[d][0] += dwx * g[d];
          c[d][1] += dwy * g[d];
          c[d][2] += dwz * g[d];
        }
      }
    }
  }
  for (int d = 0; d < 3; ++d) {
    out[d * n + p] = v[d];
    for (int j = 0; j < 3; ++j) out[(3 + 3 * d + j) * n + p] = c[d][j];
  }
}

}  // namespace

// x (3, n) positions, gv0..gv2 (wy*wz, wx) grid velocity, corner (3,) int32
// on the device, out (12, n). Returns cudaGetLastError() after the launch.
extern "C" int softmac_g2p(const float* x, const float* gv0, const float* gv1,
                           const float* gv2, const int* corner, float* out,
                           int n, int wx, int wy, int wz, float inv_dx,
                           void* stream) {
  if (n > 0) {
    g2p_kernel<<<softmac::blocks_for(n), softmac::kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
        x, gv0, gv1, gv2, corner, out, n, wx, wy, wz, inv_dx);
  }
  return static_cast<int>(cudaGetLastError());
}
