// Dense-weight splat: three plain per-particle channels through per-axis
// weight matrices onto the active grid window (the forecast mixed
// contact's -2 dv correction, grid_op_mixed4).
//
// Replaces: softmac_tpu/ops/pallas_fused.py _splat_pallas :689
// (pallas_call :700, kernel _splat_kernel :505); the function of
// _splat_ref :232 and of ops/fused.py splat_plain, for any dense weights:
//   out[(y,z), d wx + x] += Wy Wz Wx vals_d
//
// What bounds it on the H100: by bytes it reads the three weight matrices
// (wx + wy + wz floats a particle) and 3 values, and writes the window once:
// 33 MB at 1e5 particles and window (32, 16, 32), 10 us at 3.35 TB/s. In
// practice the float64 atomics bound it, 3 per visited cell.
//
// Simple design: one thread per particle, its nonzero row range on each
// axis (fused.cuh), atomicAdd(double) into a zeroed window, one more launch
// rounding it to float32 (repeatable sums, as splat.cu).
#include "fused.cuh"

namespace {

__global__ void fused_splat_kernel(const float* __restrict__ Wx,
                                   const float* __restrict__ Wy,
                                   const float* __restrict__ Wz,
                                   const float* __restrict__ vals,
                                   double* __restrict__ acc, int n, int wx,
                                   int wy, int wz) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  int x0, x1, y0, y1, z0, z1;
  softmac::nonzero_rows(Wx, wx, n, p, &x0, &x1);
  softmac::nonzero_rows(Wy, wy, n, p, &y0, &y1);
  softmac::nonzero_rows(Wz, wz, n, p, &z0, &z1);
  if (x0 > x1 || y0 > y1 || z0 > z1) return;
  const double val[3] = {vals[p], vals[n + p], vals[2 * n + p]};
  if (val[0] == 0.0 && val[1] == 0.0 && val[2] == 0.0) return;
  for (int y = y0; y <= y1; ++y) {
    const double wy_ = softmac::at(Wy, y, n, p);
    for (int z = z0; z <= z1; ++z) {
      const double wyz = wy_ * softmac::at(Wz, z, n, p);
      if (wyz == 0.0) continue;
      double* g = acc + (y * wz + z) * 3 * wx;
      for (int x = x0; x <= x1; ++x) {
        const double wgt = softmac::at(Wx, x, n, p) * wyz;
        if (wgt == 0.0) continue;
        for (int d = 0; d < 3; ++d) atomicAdd(g + d * wx + x, wgt * val[d]);
      }
    }
  }
}

}  // namespace

// Wx (wx, n), Wy (wy, n), Wz (wz, n) weight matrices, vals (3, n). acc:
// 3 * wy*wz*wx doubles zeroed by the caller, laid out as out; out
// (wy*wz, 3*wx) float32, component d in columns d*wx .. (d+1)*wx. Returns
// cudaGetLastError() after the launches.
extern "C" int softmac_fused_splat(const float* Wx, const float* Wy,
                                   const float* Wz, const float* vals,
                                   double* acc, float* out, int n, int wx,
                                   int wy, int wz, void* stream) {
  const int count = 3 * wx * wy * wz;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    fused_splat_kernel<<<softmac::blocks_for(n), softmac::kThreads, 0, s>>>(
        Wx, Wy, Wz, vals, acc, n, wx, wy, wz);
  }
  softmac::round_to_float<<<softmac::blocks_for(count), softmac::kThreads, 0,
                            s>>>(acc, out, count);
  return static_cast<int>(cudaGetLastError());
}
