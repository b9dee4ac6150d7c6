// Dense-weight gather: the grid velocity interpolated at the particles
// through per-axis weight matrices (grid_op_mixed2's v_tmp).
//
// Replaces: softmac_tpu/ops/pallas_fused.py _gather_pallas :714
// (pallas_call :725, kernel _gather_kernel :520); the function of
// _gather_ref :241 and of ops/fused.py gather_plain, for any dense weights:
//   out[d] = sum over the window of Wy Wz Wx g_d
//
// What bounds it on the H100: bytes. It reads the three weight matrices
// (wx + wy + wz floats a particle) and the three grids (L2-resident), and
// writes 3 floats a particle: 33 MB at 1e5 particles and window
// (32, 16, 32), 10 us at 3.35 TB/s.
//
// Simple design: one thread per particle, its nonzero row range on each
// axis (fused.cuh), sums in double registers, coalesced stores rounded once.
#include "fused.cuh"

namespace {

__global__ void fused_gather_kernel(const float* __restrict__ Wx,
                                    const float* __restrict__ Wy,
                                    const float* __restrict__ Wz,
                                    const float* __restrict__ gv0,
                                    const float* __restrict__ gv1,
                                    const float* __restrict__ gv2,
                                    float* __restrict__ out, int n, int wx,
                                    int wy, int wz) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  int x0, x1, y0, y1, z0, z1;
  softmac::nonzero_rows(Wx, wx, n, p, &x0, &x1);
  softmac::nonzero_rows(Wy, wy, n, p, &y0, &y1);
  softmac::nonzero_rows(Wz, wz, n, p, &z0, &z1);
  double v[3] = {0.0, 0.0, 0.0};
  for (int y = y0; y <= y1; ++y) {
    const double wy_ = softmac::at(Wy, y, n, p);
    for (int z = z0; z <= z1; ++z) {
      const double wyz = wy_ * softmac::at(Wz, z, n, p);
      const int row = y * wz + z;
      for (int x = x0; x <= x1; ++x) {
        const double wgt = softmac::at(Wx, x, n, p) * wyz;
        const int idx = row * wx + x;
        v[0] += wgt * __ldg(gv0 + idx);
        v[1] += wgt * __ldg(gv1 + idx);
        v[2] += wgt * __ldg(gv2 + idx);
      }
    }
  }
  for (int d = 0; d < 3; ++d) out[d * n + p] = static_cast<float>(v[d]);
}

}  // namespace

// Wx (wx, n), Wy (wy, n), Wz (wz, n) weight matrices, gv0..gv2 (wy*wz, wx)
// grids, out (3, n). Returns cudaGetLastError() after the launch.
extern "C" int softmac_fused_gather(const float* Wx, const float* Wy,
                                    const float* Wz, const float* gv0,
                                    const float* gv1, const float* gv2,
                                    float* out, int n, int wx, int wy, int wz,
                                    void* stream) {
  if (n > 0) {
    fused_gather_kernel<<<softmac::blocks_for(n), softmac::kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        Wx, Wy, Wz, gv0, gv1, gv2, out, n, wx, wy, wz);
  }
  return static_cast<int>(cudaGetLastError());
}
