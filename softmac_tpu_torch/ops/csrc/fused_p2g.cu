// Dense-weight P2G: splat of mass and momentum (with the MLS affine term)
// through per-axis weight matrices onto the active grid window.
//
// Replaces: softmac_tpu/ops/pallas_fused.py _p2g_pallas :627 (pallas_call
// :641, kernel _p2g_kernel :256); the function of _p2g_ref :181 and of
// ops/fused.py p2g_plain, for any dense weights:
//   gm[(y,z), x]          += Wy Wz Wx mass
//   gmom[(y,z), d wx + x] += Wy Wz (Wx mom_d + WxD a_d0) + WDy Wz Wx a_d1
//                            + Wy WDz Wx a_d2
// with every weight taken at the particle's column and a = dx * affine.
// The TPU kernel builds a (wy*wz, T) slab in VMEM and feeds the MXU with a
// bf16x3 split; here there is no matrix unit in the way and no bf16: the
// products and sums are in double, rounded to float once.
//
// What bounds it on the H100: by bytes it reads the six weight matrices
// (2 (wx + wy + wz) floats a particle) and 13 channels, and writes the
// window once: 69 MB at 1e5 particles and window (32, 16, 32), 21 us at
// 3.35 TB/s. In practice it is bound by the float64 atomics, 4 per visited
// cell: 108 a particle for B-spline weights.
//
// Simple design: one thread per particle. It finds the particle's nonzero
// row range on each axis (fused.cuh), then adds each visited cell's terms
// with atomicAdd(double) into a zeroed window; one more launch rounds the
// window to float32. As in p2g.cu, the float64 sums make repeated runs
// agree, where float32 atomics would add in another order each time.
#include "fused.cuh"

namespace {

__global__ void fused_p2g_kernel(const float* __restrict__ Wx,
                                 const float* __restrict__ WxD,
                                 const float* __restrict__ Wy,
                                 const float* __restrict__ WDy,
                                 const float* __restrict__ Wz,
                                 const float* __restrict__ WDz,
                                 const float* __restrict__ chan,
                                 double* __restrict__ gm,
                                 double* __restrict__ gmom, int n, int wx,
                                 int wy, int wz) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  int x0, x1, y0, y1, z0, z1;
  softmac::nonzero_rows(Wx, WxD, wx, n, p, &x0, &x1);
  softmac::nonzero_rows(Wy, WDy, wy, n, p, &y0, &y1);
  softmac::nonzero_rows(Wz, WDz, wz, n, p, &z0, &z1);
  if (x0 > x1 || y0 > y1 || z0 > z1) return;

  const double mass = chan[p];
  double mom[3], a[3][3];
  for (int d = 0; d < 3; ++d) {
    mom[d] = chan[(1 + d) * n + p];
    for (int j = 0; j < 3; ++j) a[d][j] = chan[(4 + 3 * d + j) * n + p];
  }
  for (int y = y0; y <= y1; ++y) {
    const double wy_ = softmac::at(Wy, y, n, p), dy = softmac::at(WDy, y, n, p);
    for (int z = z0; z <= z1; ++z) {
      const double wz_ = softmac::at(Wz, z, n, p);
      const double dz = softmac::at(WDz, z, n, p);
      const double wyz = wy_ * wz_, dyz = dy * wz_, ydz = wy_ * dz;
      if (wyz == 0.0 && dyz == 0.0 && ydz == 0.0) continue;
      const int row = y * wz + z;
      for (int x = x0; x <= x1; ++x) {
        const double w0 = softmac::at(Wx, x, n, p);
        const double d0 = softmac::at(WxD, x, n, p);
        const double wgt = w0 * wyz, dwx = d0 * wyz;
        const double dwy = w0 * dyz, dwz = w0 * ydz;
        if (wgt == 0.0 && dwx == 0.0 && dwy == 0.0 && dwz == 0.0) continue;
        atomicAdd(gm + row * wx + x, wgt * mass);
        double* g = gmom + row * 3 * wx + x;
        for (int d = 0; d < 3; ++d) {
          atomicAdd(g + d * wx,
                    wgt * mom[d] + dwx * a[d][0] + dwy * a[d][1] + dwz * a[d][2]);
        }
      }
    }
  }
}

}  // namespace

// Wx, WxD (wx, n), Wy, WDy (wy, n), Wz, WDz (wz, n) weight matrices, chan
// (13, n) [mass, mom(3), dx*affine(9) row-major]. acc: 4 * wy*wz*wx doubles
// zeroed by the caller (the mass window, then the momentum window); out:
// the same layout in float32, gm (wy*wz, wx) followed by gmom
// (wy*wz, 3*wx). Returns cudaGetLastError() after the launches.
extern "C" int softmac_fused_p2g(const float* Wx, const float* WxD,
                                 const float* Wy, const float* WDy,
                                 const float* Wz, const float* WDz,
                                 const float* chan, double* acc, float* out,
                                 int n, int wx, int wy, int wz, void* stream) {
  const int cells = wx * wy * wz;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    fused_p2g_kernel<<<softmac::blocks_for(n), softmac::kThreads, 0, s>>>(
        Wx, WxD, Wy, WDy, Wz, WDz, chan, acc, acc + cells, n, wx, wy, wz);
  }
  softmac::round_to_float<<<softmac::blocks_for(4 * cells), softmac::kThreads,
                            0, s>>>(acc, out, 4 * cells);
  return static_cast<int>(cudaGetLastError());
}
