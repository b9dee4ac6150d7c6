// Gather: B-spline interpolation of the grid velocity at the particles
// (v_tmp of the mixed-contact substep), without G2P's affine rows.
//
// Replaces: softmac_tpu/ops/pallas_chunked.py _gather_c_pallas /
// _gather_c_kernel (the y-chunked Pallas gather), same function as
// mpm.gather_dense.
//
// Computes, for every particle p over its 27 stencil cells inside the
// window, with g_d the three velocity grids (wy*wz, wx):
//   out[d] = sum W g_d      (W = Wx Wy Wz, the bspline.cuh weights)
// Cells outside the window are skipped, as in G2P.
//
// What bounds it on the H100: bytes. It reads 3 position floats a particle
// and the window's three grids (196 KB at (32, 32, 16), L2-resident), and
// writes 3 floats a particle: about 2.6 MB at 1e5 particles, 0.8 us at
// 3.35 TB/s. The 81 grid reads a particle hit L1/L2; the y-sorted particle
// order makes a warp read neighbouring cells.
//
// Simple design: G2P's loop without the C rows. One thread per particle,
// read-only loads through the texture path (__ldg), sums in registers,
// coalesced row-major stores.
#include "bspline.cuh"

namespace {

__global__ void gather_kernel(const float* __restrict__ x,
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
  softmac::particle_stencil(x, n, p, corner, inv_dx, ax, rel);
  float v[3] = {0.f, 0.f, 0.f};
  for (int j = 0; j < 3; ++j) {
    const int cy = rel[1] + j;
    if (cy < 0 || cy >= wy) continue;
    for (int k = 0; k < 3; ++k) {
      const int cz = rel[2] + k;
      if (cz < 0 || cz >= wz) continue;
      const int row = cy * wz + cz;
      const float wyz = ax[1].w[j] * ax[2].w[k];
      for (int i = 0; i < 3; ++i) {
        const int cx = rel[0] + i;
        if (cx < 0 || cx >= wx) continue;
        const int idx = row * wx + cx;
        const float wgt = ax[0].w[i] * wyz;
        v[0] += wgt * __ldg(gv0 + idx);
        v[1] += wgt * __ldg(gv1 + idx);
        v[2] += wgt * __ldg(gv2 + idx);
      }
    }
  }
  for (int d = 0; d < 3; ++d) out[d * n + p] = v[d];
}

}  // namespace

// x (3, n) positions, gv0..gv2 (wy*wz, wx) grid velocity, corner (3,) int32
// on the device, out (3, n). Returns cudaGetLastError() after the launch.
extern "C" int softmac_gather(const float* x, const float* gv0,
                              const float* gv1, const float* gv2,
                              const int* corner, float* out, int n, int wx,
                              int wy, int wz, float inv_dx, void* stream) {
  if (n > 0) {
    gather_kernel<<<softmac::blocks_for(n), softmac::kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        x, gv0, gv1, gv2, corner, out, n, wx, wy, wz, inv_dx);
  }
  return static_cast<int>(cudaGetLastError());
}
