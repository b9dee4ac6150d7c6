// Backward of the splat: cotangents of the positions and of the splatted
// values, from the cotangent of the window (wy*wz, 3*wx).
//
// Replaces: softmac_tpu/ops/pallas_chunked.py _splat_c_bwd_pallas /
// _splat_c_bwd_kernel (the custom_vjp backward of pallas_chunked.family().
// splat_c), same function as jax.vjp of mpm.splat_channels composed with
// mpm.axis_weights.
//
// With dout_d[c] the window cotangent of component d at cell c:
//   values:    dvals_d = sum W dout_d over the particle's stencil cells
//              inside the window (a gather, as the forward gather);
//   positions: a gather through the weights (bspline.cuh stencil_adjoint)
//              with the per-cell weight cotangent s_W = vals . dout_c.
// Cells outside the window are skipped, as in the forward kernel. Each
// thread writes only its own particle's rows: no atomics.
//
// What bounds it on the H100: bytes. It reads x and the values (6 floats
// a particle) and the window cotangent (196 KB at (32, 32, 16),
// L2-resident), and writes dx and dvals (6 floats a particle): about 5 MB
// at 1e5 particles, 1.5 us at 3.35 TB/s. The 81 window reads a particle hit
// L1/L2; the y-sorted particle order makes a warp read neighbouring cells.
//
// Simple design: one thread per particle, one stencil walk that gathers
// both results, read-only loads through the texture path (__ldg).
#include "bspline.cuh"

namespace {

__global__ void splat_bwd_kernel(const float* __restrict__ x,
                                 const float* __restrict__ vals,
                                 const int* __restrict__ corner,
                                 const float* __restrict__ dout,
                                 float* __restrict__ dx,
                                 float* __restrict__ dvals,
                                 int n, int wx, int wy, int wz, float inv_dx) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;

  softmac::Axis ax[3];
  int rel[3];
  softmac::particle_stencil(x, n, p, corner, inv_dx, ax, rel);
  const float val[3] = {vals[p], vals[n + p], vals[2 * n + p]};
  float dval[3] = {0.f, 0.f, 0.f};
  auto cell = [&](int row, int cx, float w, float, float, float, float s[4]) {
    const float* c = dout + row * 3 * wx + cx;
    s[0] = 0.f;
    for (int d = 0; d < 3; ++d) {
      const float g = __ldg(c + d * wx);
      dval[d] += w * g;
      s[0] += val[d] * g;
    }
    s[1] = s[2] = s[3] = 0.f;
  };
  float gx[3];
  softmac::stencil_adjoint(ax, rel, wx, wy, wz, inv_dx, cell, gx);
  for (int d = 0; d < 3; ++d) {
    dx[d * n + p] = gx[d];
    dvals[d * n + p] = dval[d];
  }
}

}  // namespace

// x (3, n) positions, vals (3, n) and corner (3,) int32 as for
// softmac_splat; dout (wy*wz, 3*wx) the cotangent of its window. Writes dx
// and dvals (3, n). Returns cudaGetLastError() after the launch.
extern "C" int softmac_splat_bwd(const float* x, const float* vals,
                                 const int* corner, const float* dout,
                                 float* dx, float* dvals, int n, int wx,
                                 int wy, int wz, float inv_dx, void* stream) {
  if (n > 0) {
    splat_bwd_kernel<<<softmac::blocks_for(n), softmac::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        x, vals, corner, dout, dx, dvals, n, wx, wy, wz, inv_dx);
  }
  return static_cast<int>(cudaGetLastError());
}
