// Dense-weight G2P: weighted gather of the grid velocity and of the MLS
// affine field C through per-axis weight matrices back to the particles.
//
// Replaces: softmac_tpu/ops/pallas_fused.py _g2p_pallas :660 (pallas_call
// :672, kernel _g2p_kernel :295); the function of _g2p_ref :207 and of
// ops/fused.py g2p_plain, for any dense weights, over the window cells with
// g_d the three velocity grids (wy*wz, wx):
//   out[d]          = sum Wy Wz Wx g_d          (velocity, rows 0-2)
//   out[3 + 3d + 0] = sum Wy Wz WxD g_d         (C[d][0], unscaled)
//   out[3 + 3d + 1] = sum WDy Wz Wx g_d         (C[d][1], unscaled)
//   out[3 + 3d + 2] = sum Wy WDz Wx g_d         (C[d][2], unscaled)
// The caller scales C by 4 * inv_dx (mpm._Transfers.g2p). The JAX kernel
// writes 16 rows, 12-15 zero padding; this one writes the 12 that are read.
//
// What bounds it on the H100: bytes. It reads the six weight matrices
// (2 (wx + wy + wz) floats a particle) and the three grids (196 KB at
// (32, 16, 32), L2-resident), and writes 12 floats a particle: 69 MB at
// 1e5 particles, 21 us at 3.35 TB/s.
//
// Simple design: one thread per particle; the nonzero row range on each
// axis (fused.cuh), then the visited cells' grid values through the
// read-only path, summed in double registers, and coalesced row-major
// stores, rounded once.
#include "fused.cuh"

namespace {

__global__ void fused_g2p_kernel(const float* __restrict__ Wx,
                                 const float* __restrict__ WxD,
                                 const float* __restrict__ Wy,
                                 const float* __restrict__ WDy,
                                 const float* __restrict__ Wz,
                                 const float* __restrict__ WDz,
                                 const float* __restrict__ gv0,
                                 const float* __restrict__ gv1,
                                 const float* __restrict__ gv2,
                                 float* __restrict__ out, int n, int wx,
                                 int wy, int wz) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  int x0, x1, y0, y1, z0, z1;
  softmac::nonzero_rows(Wx, WxD, wx, n, p, &x0, &x1);
  softmac::nonzero_rows(Wy, WDy, wy, n, p, &y0, &y1);
  softmac::nonzero_rows(Wz, WDz, wz, n, p, &z0, &z1);

  double v[3] = {0.0, 0.0, 0.0};
  double c[3][3] = {{0.0, 0.0, 0.0}, {0.0, 0.0, 0.0}, {0.0, 0.0, 0.0}};
  for (int y = y0; y <= y1; ++y) {
    const double wy_ = softmac::at(Wy, y, n, p), dy = softmac::at(WDy, y, n, p);
    for (int z = z0; z <= z1; ++z) {
      const double wz_ = softmac::at(Wz, z, n, p);
      const double dz = softmac::at(WDz, z, n, p);
      const double wyz = wy_ * wz_, dyz = dy * wz_, ydz = wy_ * dz;
      const int row = y * wz + z;
      for (int x = x0; x <= x1; ++x) {
        const double w0 = softmac::at(Wx, x, n, p);
        const double d0 = softmac::at(WxD, x, n, p);
        const int idx = row * wx + x;
        const double g[3] = {__ldg(gv0 + idx), __ldg(gv1 + idx),
                             __ldg(gv2 + idx)};
        const double wgt = w0 * wyz, dwx = d0 * wyz;
        const double dwy = w0 * dyz, dwz = w0 * ydz;
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
    out[d * n + p] = static_cast<float>(v[d]);
    for (int j = 0; j < 3; ++j) {
      out[(3 + 3 * d + j) * n + p] = static_cast<float>(c[d][j]);
    }
  }
}

}  // namespace

// Wx, WxD (wx, n), Wy, WDy (wy, n), Wz, WDz (wz, n) weight matrices,
// gv0..gv2 (wy*wz, wx) grid velocity, out (12, n). Returns
// cudaGetLastError() after the launch.
extern "C" int softmac_fused_g2p(const float* Wx, const float* WxD,
                                 const float* Wy, const float* WDy,
                                 const float* Wz, const float* WDz,
                                 const float* gv0, const float* gv1,
                                 const float* gv2, float* out, int n, int wx,
                                 int wy, int wz, void* stream) {
  if (n > 0) {
    fused_g2p_kernel<<<softmac::blocks_for(n), softmac::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        Wx, WxD, Wy, WDy, Wz, WDz, gv0, gv1, gv2, out, n, wx, wy, wz);
  }
  return static_cast<int>(cudaGetLastError());
}
