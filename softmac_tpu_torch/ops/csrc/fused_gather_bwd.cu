// Backward of the dense-weight gather: the cotangents of the three weight
// matrices and of the three velocity grids from the cotangent of the
// gathered velocity (3, N).
//
// Replaces: softmac_tpu/ops/pallas_fused.py _gather_bwd_pallas :840
// (pallas_call :858, kernel _gather_bwd_kernel :570), the custom_vjp
// backward of pallas_fused.gather; the function of jax.vjp of _gather_ref
// :241 and of ops/fused.py gather_vjp_plain, for any dense weights. With
// dv_d the particle's cotangent, the cell coefficient of fused_bwd.cuh (no
// derivative weights) is s.h = sum_d dv_d gv_d[c], and each grid
// cotangent gathers every particle's terms at the cell:
//   dgv_d[c] += Wy Wz Wx dv_d.
//
// What bounds it on the H100: by bytes it reads the three weight matrices
// and writes their cotangents ((wx + wy + wz) floats a particle each way),
// dv, and the grids in and out once: 3.9 MB at the door's 5400 particles
// and window (32, 16, 32), 1.2 us at 3.35 TB/s. In practice the cell reads
// and the float64 atomics, 3 per box cell.
//
// Simple design: one thread per particle: its box (fused.cuh), the weight
// rows (fused_bwd.cuh weight_adjoint), then the grid terms over the box
// with atomicAdd(double) into a zeroed window, rounded to float32 once by a
// second launch (repeatable sums, as gather_bwd.cu).
#include "fused_bwd.cuh"

namespace {

__global__ void fused_gather_bwd_kernel(
    const float* __restrict__ Wx, const float* __restrict__ Wy,
    const float* __restrict__ Wz, const float* __restrict__ gv0,
    const float* __restrict__ gv1, const float* __restrict__ gv2,
    const float* __restrict__ dv, float* __restrict__ out,
    double* __restrict__ dgrid, int n, int wx, int wy, int wz) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const softmac::Box b = softmac::particle_box(Wx, nullptr, Wy, nullptr, Wz,
                                               nullptr, n, p, wx, wy, wz);
  const double c[3] = {dv[p], dv[n + p], dv[2 * n + p]};
  auto cell = [&](int row, int x) {
    const int idx = row * wx + x;
    softmac::CellCoef s;
    s.h = c[0] * __ldg(gv0 + idx) + c[1] * __ldg(gv1 + idx)
          + c[2] * __ldg(gv2 + idx);
    s.d0 = s.d1 = s.d2 = 0.0;
    return s;
  };
  float* dWy = out + static_cast<size_t>(wx) * n;
  float* dWz = dWy + static_cast<size_t>(wy) * n;
  softmac::weight_adjoint<false>(Wx, nullptr, Wy, nullptr, Wz, nullptr, n, p,
                                 wx, wy, wz, b, cell, out, nullptr, dWy,
                                 nullptr, dWz, nullptr);
  if (b.empty() || (c[0] == 0.0 && c[1] == 0.0 && c[2] == 0.0)) return;

  const int cells = wx * wy * wz;
  for (int y = b.y0; y <= b.y1; ++y) {
    const double wy_ = softmac::at(Wy, y, n, p);
    for (int z = b.z0; z <= b.z1; ++z) {
      const double wyz = wy_ * softmac::at(Wz, z, n, p);
      if (wyz == 0.0) continue;
      double* dst = dgrid + (y * wz + z) * wx;
      for (int x = b.x0; x <= b.x1; ++x) {
        const double wgt = softmac::at(Wx, x, n, p) * wyz;
        if (wgt == 0.0) continue;
        for (int d = 0; d < 3; ++d) atomicAdd(dst + d * cells + x, wgt * c[d]);
      }
    }
  }
}

}  // namespace

// Wx (wx, n), Wy (wy, n), Wz (wz, n) weight matrices and gv0..gv2
// (wy*wz, wx) as for softmac_fused_gather; dv (3, n) the cotangent of its
// output. out: (wx + wy + wz, n) float32, the rows dWx, dWy, dWz one after
// the other, every row written. acc: 3 * wy*wz*wx doubles zeroed by the
// caller; gout: the three grid cotangents in float32, one (wy*wz, wx) grid
// after the other. Returns cudaGetLastError() after the launches.
extern "C" int softmac_fused_gather_bwd(const float* Wx, const float* Wy,
                                        const float* Wz, const float* gv0,
                                        const float* gv1, const float* gv2,
                                        const float* dv, float* out,
                                        double* acc, float* gout, int n,
                                        int wx, int wy, int wz, void* stream) {
  const int count = 3 * wx * wy * wz;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    fused_gather_bwd_kernel<<<softmac::blocks_for(n), softmac::kThreads, 0,
                              s>>>(Wx, Wy, Wz, gv0, gv1, gv2, dv, out, acc, n,
                                   wx, wy, wz);
  }
  softmac::round_to_float<<<softmac::blocks_for(count), softmac::kThreads, 0,
                            s>>>(acc, gout, count);
  return static_cast<int>(cudaGetLastError());
}
