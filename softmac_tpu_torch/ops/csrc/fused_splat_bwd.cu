// Backward of the dense-weight splat: the cotangents of the three weight
// matrices and of the splatted values from the cotangent of the window.
//
// Replaces: softmac_tpu/ops/pallas_fused.py _splat_bwd_pallas :811
// (pallas_call :828, kernel _splat_bwd_kernel :534), the custom_vjp
// backward of pallas_fused.splat; the function of jax.vjp of _splat_ref
// :232 and of ops/fused.py splat_vjp_plain, for any dense weights. With
// G_d = dout[row, d wx + x] at cell c, the cell coefficient of
// fused_bwd.cuh (no derivative weights) is s.h = sum_d G_d vals_d, and
//   dvals_d = sum over the box of Wy Wz Wx G_d.
//
// What bounds it on the H100: by bytes it reads the three weight matrices
// and writes their cotangents ((wx + wy + wz) floats a particle each way),
// the values in and out, and the window once: 3.8 MB at the door's 5400
// particles and window (32, 16, 32), 1.1 us at 3.35 TB/s. In practice the
// cell reads, 3 floats a visited cell.
//
// Simple design: one thread per particle, a pure gather (no atomics,
// bit-identical repeats): its box (fused.cuh), the weight rows
// (fused_bwd.cuh weight_adjoint), then the values over the box.
#include "fused_bwd.cuh"

namespace {

__global__ void fused_splat_bwd_kernel(const float* __restrict__ Wx,
                                       const float* __restrict__ Wy,
                                       const float* __restrict__ Wz,
                                       const float* __restrict__ vals,
                                       const float* __restrict__ dout,
                                       float* __restrict__ out, int n, int wx,
                                       int wy, int wz) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const softmac::Box b = softmac::particle_box(Wx, Wy, Wz, n, p, wx, wy, wz);
  const double val[3] = {vals[p], vals[n + p], vals[2 * n + p]};
  auto cell = [&](int row, int x) {
    const float* gr = dout + static_cast<size_t>(row) * 3 * wx + x;
    return val[0] * __ldg(gr) + val[1] * __ldg(gr + wx)
           + val[2] * __ldg(gr + 2 * wx);
  };
  float* dWy = out + static_cast<size_t>(wx) * n;
  float* dWz = dWy + static_cast<size_t>(wy) * n;
  float* dvals = dWz + static_cast<size_t>(wz) * n;
  softmac::weight_adjoint(Wx, Wy, Wz, n, p, wx, wy, wz, b, cell, out, dWy,
                          dWz);

  double dv[3] = {0.0, 0.0, 0.0};
  if (!b.empty()) {
    for (int y = b.y0; y <= b.y1; ++y) {
      const double wy_ = softmac::at(Wy, y, n, p);
      for (int z = b.z0; z <= b.z1; ++z) {
        const double wyz = wy_ * softmac::at(Wz, z, n, p);
        const float* gr = dout + static_cast<size_t>(y * wz + z) * 3 * wx;
        for (int x = b.x0; x <= b.x1; ++x) {
          const double wgt = softmac::at(Wx, x, n, p) * wyz;
          for (int d = 0; d < 3; ++d) dv[d] += wgt * __ldg(gr + d * wx + x);
        }
      }
    }
  }
  for (int d = 0; d < 3; ++d) {
    dvals[static_cast<size_t>(d) * n + p] = static_cast<float>(dv[d]);
  }
}

}  // namespace

// Wx (wx, n), Wy (wy, n), Wz (wz, n) weight matrices and vals (3, n) as for
// softmac_fused_splat; dout (wy*wz, 3*wx) the cotangent of its window.
// out: (wx + wy + wz + 3, n) float32, the rows dWx, dWy, dWz, dvals one
// after the other, every row written. Returns cudaGetLastError() after the
// launch.
extern "C" int softmac_fused_splat_bwd(const float* Wx, const float* Wy,
                                       const float* Wz, const float* vals,
                                       const float* dout, float* out, int n,
                                       int wx, int wy, int wz, void* stream) {
  if (n > 0) {
    fused_splat_bwd_kernel<<<softmac::blocks_for(n), softmac::kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        Wx, Wy, Wz, vals, dout, out, n, wx, wy, wz);
  }
  return static_cast<int>(cudaGetLastError());
}
