// Splat: B-spline scatter of three per-particle values onto the active grid
// window (the -2 (v_tmp - v_tgt) velocity correction of the mixed-contact
// substep).
//
// Replaces: softmac_tpu/ops/pallas_chunked.py _splat_c_pallas /
// _splat_c_kernel (the y-chunked Pallas splat), same function as
// mpm.splat_channels.
//
// Computes, for every particle p and each of its 27 stencil cells inside
// the window,
//   out[row, d * wx + cx] += W vals_d        (W = Wx Wy Wz)
// in P2G's momentum layout (wy*wz, 3*wx). Cells outside the window are
// skipped, as in P2G.
//
// What bounds it on the H100: by bytes it reads 6 floats a particle (x and
// the values, 2.4 MB at 1e5 particles) and writes the window once, about
// 0.8 us at 3.35 TB/s. In practice it is bound by the 81 float64 atomics a
// particle performs on a window of ~16k cells that neighbouring particles
// hit at once, like G2P's backward.
//
// Simple design: P2G's splat (bspline.cuh splat_stencil) with the values in
// place of the momentum and no mass or affine term: one thread per
// particle, float64 atomicAdd into a zeroed accumulator, then one more
// launch rounds the window to float32 once. As for P2G, this keeps
// repeated rollouts bit-identical, where float32 atomics would sum each
// cell in another order on every run. A shared-memory window tile is the
// later optimisation.
#include "bspline.cuh"

namespace {

__global__ void splat_kernel(const float* __restrict__ x,
                             const float* __restrict__ vals,
                             const int* __restrict__ corner,
                             double* __restrict__ acc,
                             int n, int wx, int wy, int wz, float inv_dx) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;

  softmac::Axis ax[3];
  int rel[3];
  softmac::particle_stencil(x, n, p, corner, inv_dx, ax, rel);
  const float val[3] = {vals[p], vals[n + p], vals[2 * n + p]};
  const float none[3][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
  softmac::splat_stencil(ax, rel, wx, wy, wz, nullptr, 0.f, acc, 3 * wx, wx,
                         val, none);
}

}  // namespace

// x (3, n) positions, vals (3, n), corner (3,) int32 on the device. acc:
// 3 * wy*wz*wx doubles zeroed by the caller; out: the same window in
// float32, (wy*wz, 3*wx) with component d in columns d*wx .. (d+1)*wx.
// Returns cudaGetLastError() after the launches.
extern "C" int softmac_splat(const float* x, const float* vals,
                             const int* corner, double* acc, float* out,
                             int n, int wx, int wy, int wz, float inv_dx,
                             void* stream) {
  const int cells = wx * wy * wz;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    splat_kernel<<<softmac::blocks_for(n), softmac::kThreads, 0, s>>>(
        x, vals, corner, acc, n, wx, wy, wz, inv_dx);
  }
  softmac::round_to_float<<<softmac::blocks_for(3 * cells), softmac::kThreads,
                            0, s>>>(acc, out, 3 * cells);
  return static_cast<int>(cudaGetLastError());
}
