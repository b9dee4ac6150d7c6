// Backward of the dense-weight G2P: the cotangents of the six weight
// matrices and of the three velocity grids from the cotangent of G2P's 12
// particle rows (v, then the unscaled C[d][j] in row 3 + 3d + j).
//
// Replaces: softmac_tpu/ops/pallas_fused.py _g2p_bwd_pallas :774
// (pallas_call :794, kernel _g2p_bwd_kernel :423), the custom_vjp backward
// of pallas_fused.g2p; the function of jax.vjp of _g2p_ref :207 (its rows
// 12-15 given zero cotangent) and of ops/fused.py g2p_vjp_plain, for any
// dense weights. With the particle's row cotangents cv_d = g[d] and
// cj_d = g[3 + 3d + j], the cell coefficients of fused_bwd.cuh are
//   s.h = sum_d cv_d gv_d[c],  s.dj = sum_d cj_d gv_d[c],
// and each grid cotangent gathers every particle's terms at the cell:
//   dgv_d[c] += Wy Wz Wx cv_d + Wy Wz WxD c0_d + WDy Wz Wx c1_d
//               + Wy WDz Wx c2_d.
//
// What bounds it on the H100: by bytes it reads the six weight matrices and
// the 12 row cotangents and writes the six weight cotangents (2 (wx + wy +
// wz) floats a particle each way), the grids in and out once: 7.4 MB at the
// door's 5400 particles and window (32, 16, 32), 2.2 us at 3.35 TB/s. In
// practice the cell reads of the weight rows and the float64 atomics of
// the grid cotangents, 3 per box cell.
//
// Simple design: one thread per particle: its box (fused.cuh), the weight
// rows (fused_bwd.cuh weight_adjoint), then the grid terms over the box
// with atomicAdd(double) into a zeroed window, which a second launch rounds
// to float32 once, so repeated runs agree bit for bit (as g2p_bwd.cu).
#include "fused_bwd.cuh"

namespace {

__global__ void fused_g2p_bwd_kernel(
    const float* __restrict__ Wx, const float* __restrict__ WxD,
    const float* __restrict__ Wy, const float* __restrict__ WDy,
    const float* __restrict__ Wz, const float* __restrict__ WDz,
    const float* __restrict__ gv0, const float* __restrict__ gv1,
    const float* __restrict__ gv2, const float* __restrict__ g,
    float* __restrict__ out, double* __restrict__ dgrid, int n, int wx,
    int wy, int wz) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const softmac::Box b =
      softmac::particle_box(Wx, WxD, Wy, WDy, Wz, WDz, n, p, wx, wy, wz);
  double cv[3], c[3][3];
  for (int d = 0; d < 3; ++d) {
    cv[d] = g[d * n + p];
    for (int j = 0; j < 3; ++j) c[d][j] = g[(3 + 3 * d + j) * n + p];
  }
  auto cell = [&](int row, int x) {
    const int idx = row * wx + x;
    const double v[3] = {__ldg(gv0 + idx), __ldg(gv1 + idx),
                         __ldg(gv2 + idx)};
    softmac::CellCoef s;
    s.h = cv[0] * v[0] + cv[1] * v[1] + cv[2] * v[2];
    s.d0 = c[0][0] * v[0] + c[1][0] * v[1] + c[2][0] * v[2];
    s.d1 = c[0][1] * v[0] + c[1][1] * v[1] + c[2][1] * v[2];
    s.d2 = c[0][2] * v[0] + c[1][2] * v[1] + c[2][2] * v[2];
    return s;
  };
  float* dW = out;
  float* dWxD = dW + static_cast<size_t>(wx) * n;
  float* dWy = dWxD + static_cast<size_t>(wx) * n;
  float* dWDy = dWy + static_cast<size_t>(wy) * n;
  float* dWz = dWDy + static_cast<size_t>(wy) * n;
  float* dWDz = dWz + static_cast<size_t>(wz) * n;
  softmac::weight_adjoint<true>(Wx, WxD, Wy, WDy, Wz, WDz, n, p, wx, wy, wz,
                                b, cell, dW, dWxD, dWy, dWDy, dWz, dWDz);
  if (b.empty()) return;

  const int cells = wx * wy * wz;
  for (int y = b.y0; y <= b.y1; ++y) {
    const double wy_ = softmac::at(Wy, y, n, p);
    const double dy = softmac::at(WDy, y, n, p);
    for (int z = b.z0; z <= b.z1; ++z) {
      const double wz_ = softmac::at(Wz, z, n, p);
      const double dz = softmac::at(WDz, z, n, p);
      const double wyz = wy_ * wz_, dyz = dy * wz_, ydz = wy_ * dz;
      if (wyz == 0.0 && dyz == 0.0 && ydz == 0.0) continue;
      const int row = y * wz + z;
      for (int x = b.x0; x <= b.x1; ++x) {
        const double w0 = softmac::at(Wx, x, n, p);
        const double d0 = softmac::at(WxD, x, n, p);
        const double wgt = w0 * wyz, dwx = d0 * wyz;
        const double dwy = w0 * dyz, dwz = w0 * ydz;
        if (wgt == 0.0 && dwx == 0.0 && dwy == 0.0 && dwz == 0.0) continue;
        double* dst = dgrid + row * wx + x;
        for (int d = 0; d < 3; ++d) {
          atomicAdd(dst + d * cells, wgt * cv[d] + dwx * c[d][0]
                                         + dwy * c[d][1] + dwz * c[d][2]);
        }
      }
    }
  }
}

}  // namespace

// Wx, WxD (wx, n), Wy, WDy (wy, n), Wz, WDz (wz, n) weight matrices and
// gv0..gv2 (wy*wz, wx) as for softmac_fused_g2p; g (12, n) the cotangent of
// its output. out: (2 (wx + wy + wz), n) float32, the rows dWx, dWxD, dWy,
// dWDy, dWz, dWDz one after the other, every row written. acc: 3 *
// wy*wz*wx doubles zeroed by the caller; gout: the three grid cotangents
// in float32, one (wy*wz, wx) grid after the other. Returns
// cudaGetLastError() after the launches.
extern "C" int softmac_fused_g2p_bwd(const float* Wx, const float* WxD,
                                     const float* Wy, const float* WDy,
                                     const float* Wz, const float* WDz,
                                     const float* gv0, const float* gv1,
                                     const float* gv2, const float* g,
                                     float* out, double* acc, float* gout,
                                     int n, int wx, int wy, int wz,
                                     void* stream) {
  const int count = 3 * wx * wy * wz;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    fused_g2p_bwd_kernel<<<softmac::blocks_for(n), softmac::kThreads, 0, s>>>(
        Wx, WxD, Wy, WDy, Wz, WDz, gv0, gv1, gv2, g, out, acc, n, wx, wy, wz);
  }
  softmac::round_to_float<<<softmac::blocks_for(count), softmac::kThreads, 0,
                            s>>>(acc, gout, count);
  return static_cast<int>(cudaGetLastError());
}
