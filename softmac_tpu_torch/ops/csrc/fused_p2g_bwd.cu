// Backward of the dense-weight P2G: the cotangents of the six weight
// matrices and of the 13 channels from the cotangents of the mass and
// momentum windows.
//
// Replaces: softmac_tpu/ops/pallas_fused.py _p2g_bwd_pallas :740
// (pallas_call :758, kernel _p2g_bwd_kernel :330), the custom_vjp backward
// of pallas_fused.p2g; the function of jax.vjp of _p2g_ref :181 and of
// ops/fused.py p2g_vjp_plain, for any dense weights. With G_m = dgm[c] and
// G_d = dgmom[row, d wx + x] at cell c, the cell coefficients of
// fused_bwd.cuh are
//   s.h = G_m mass + sum_d G_d mom_d,  s.dj = sum_d G_d a_dj  (a = dx*affine)
// and the channel cotangents sum over the particle's box:
//   dchan[0] = sum Wy Wz Wx G_m,  dchan[1 + d] = sum Wy Wz Wx G_d,
//   dchan[4 + 3d] = sum Wy Wz WxD G_d,  dchan[5 + 3d] = sum WDy Wz Wx G_d,
//   dchan[6 + 3d] = sum Wy WDz Wx G_d.
// The TPU kernel contracts VMEM H-slabs with bf16x3 split dots; here each
// particle reads its own cells' cotangents, in double, rounded once.
//
// What bounds it on the H100: by bytes it reads the six weight matrices and
// writes their cotangents (2 (wx + wy + wz) floats a particle each way), the
// 13 channels in and out, and the windows once: 7.7 MB at the door's 5400
// particles and window (32, 16, 32), 2.3 us at 3.35 TB/s. By operations,
// for B-spline weights, (wx + wy + wz) rows of 9 box cells a particle at
// ~35 flops each: about the same. In practice the cell reads, 4 floats a
// visited cell, from L1 and L2.
//
// Simple design: one thread per particle, no atomics (every output is the
// particle's own), so repeated runs are bit-identical. The particle's box
// (fused.cuh), then the weight rows (fused_bwd.cuh weight_adjoint), then
// the channels over the box; coalesced row-major stores.
#include "fused_bwd.cuh"

namespace {

__global__ void fused_p2g_bwd_kernel(
    const float* __restrict__ Wx, const float* __restrict__ WxD,
    const float* __restrict__ Wy, const float* __restrict__ WDy,
    const float* __restrict__ Wz, const float* __restrict__ WDz,
    const float* __restrict__ chan, const float* __restrict__ dgm,
    const float* __restrict__ dgmom, float* __restrict__ out, int n, int wx,
    int wy, int wz) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const softmac::Box b =
      softmac::particle_box(Wx, WxD, Wy, WDy, Wz, WDz, n, p, wx, wy, wz);
  const double mass = chan[p];
  double mom[3], a[3][3];
  for (int d = 0; d < 3; ++d) {
    mom[d] = chan[(1 + d) * n + p];
    for (int j = 0; j < 3; ++j) a[d][j] = chan[(4 + 3 * d + j) * n + p];
  }
  auto grads = [&](int row, int x, double* g) {
    const float* gr = dgmom + static_cast<size_t>(row) * 3 * wx + x;
    g[0] = __ldg(dgm + row * wx + x);
    for (int d = 0; d < 3; ++d) g[1 + d] = __ldg(gr + d * wx);
  };
  auto cell = [&](int row, int x) {
    double g[4];
    grads(row, x, g);
    softmac::CellCoef s;
    s.h = g[0] * mass + g[1] * mom[0] + g[2] * mom[1] + g[3] * mom[2];
    s.d0 = g[1] * a[0][0] + g[2] * a[1][0] + g[3] * a[2][0];
    s.d1 = g[1] * a[0][1] + g[2] * a[1][1] + g[3] * a[2][1];
    s.d2 = g[1] * a[0][2] + g[2] * a[1][2] + g[3] * a[2][2];
    return s;
  };
  float* dW = out;
  float* dWxD = dW + static_cast<size_t>(wx) * n;
  float* dWy = dWxD + static_cast<size_t>(wx) * n;
  float* dWDy = dWy + static_cast<size_t>(wy) * n;
  float* dWz = dWDy + static_cast<size_t>(wy) * n;
  float* dWDz = dWz + static_cast<size_t>(wz) * n;
  float* dchan = dWDz + static_cast<size_t>(wz) * n;
  softmac::weight_adjoint<true>(Wx, WxD, Wy, WDy, Wz, WDz, n, p, wx, wy, wz,
                                b, cell, dW, dWxD, dWy, dWDy, dWz, dWDz);

  double dc[13] = {0.0};
  if (!b.empty()) {
    for (int y = b.y0; y <= b.y1; ++y) {
      const double wy_ = softmac::at(Wy, y, n, p);
      const double dy = softmac::at(WDy, y, n, p);
      for (int z = b.z0; z <= b.z1; ++z) {
        const double wz_ = softmac::at(Wz, z, n, p);
        const double dz = softmac::at(WDz, z, n, p);
        const double wyz = wy_ * wz_, dyz = dy * wz_, ydz = wy_ * dz;
        const int row = y * wz + z;
        for (int x = b.x0; x <= b.x1; ++x) {
          const double w0 = softmac::at(Wx, x, n, p);
          const double d0 = softmac::at(WxD, x, n, p);
          const double wgt = w0 * wyz, dwx = d0 * wyz;
          const double dwy = w0 * dyz, dwz = w0 * ydz;
          double g[4];
          grads(row, x, g);
          dc[0] += wgt * g[0];
          for (int d = 0; d < 3; ++d) {
            dc[1 + d] += wgt * g[1 + d];
            dc[4 + 3 * d] += dwx * g[1 + d];
            dc[5 + 3 * d] += dwy * g[1 + d];
            dc[6 + 3 * d] += dwz * g[1 + d];
          }
        }
      }
    }
  }
  for (int k = 0; k < 13; ++k) {
    dchan[static_cast<size_t>(k) * n + p] = static_cast<float>(dc[k]);
  }
}

}  // namespace

// Wx, WxD (wx, n), Wy, WDy (wy, n), Wz, WDz (wz, n) weight matrices, chan
// (13, n) as for softmac_fused_p2g; dgm (wy*wz, wx) and dgmom
// (wy*wz, 3*wx) the cotangents of its outputs. out: (2 (wx + wy + wz) + 13,
// n) float32, the rows dWx, dWxD, dWy, dWDy, dWz, dWDz, dchan one after
// the other, every row written. Returns cudaGetLastError() after the
// launch.
extern "C" int softmac_fused_p2g_bwd(const float* Wx, const float* WxD,
                                     const float* Wy, const float* WDy,
                                     const float* Wz, const float* WDz,
                                     const float* chan, const float* dgm,
                                     const float* dgmom, float* out, int n,
                                     int wx, int wy, int wz, void* stream) {
  if (n > 0) {
    fused_p2g_bwd_kernel<<<softmac::blocks_for(n), softmac::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        Wx, WxD, Wy, WDy, Wz, WDz, chan, dgm, dgmom, out, n, wx, wy, wz);
  }
  return static_cast<int>(cudaGetLastError());
}
