// P2G: B-spline splat of mass and momentum (with the MLS affine term) from
// particles onto the active grid window.
//
// Replaces: softmac_tpu/ops/pallas_chunked.py _p2g_c_pallas / _p2g_c_kernel
// (the y-chunked Pallas P2G), same function as mpm.p2g_dense.
//
// Computes, for every particle p and each of its 27 stencil cells that lie
// inside the window,
//   gm[row, cx]            += W * mass
//   gmom[row, d * wx + cx] += W * mom_d
//                             + WxD Wy Wz a_d0 + Wx WDy Wz a_d1 + Wx Wy WDz a_d2
// with W = Wx Wy Wz, row = (cy - corner_y) * wz + (cz - corner_z) and
// a = dx * affine. Cells outside the window are skipped (the zero rows of
// mpm.axis_weights): the result is exact over the whole window, where the
// TPU kernel truncates each particle tile to a 16-row y-window.
//
// What bounds it on the H100: by bytes it reads 16 floats a particle
// (13 channels + 3 positions, 6.4 MB at 1e5 particles) and writes the
// window once, about 2 us at 3.35 TB/s. In practice it is bound by the
// 108 atomics a particle performs on a grid of ~20k cells that many
// neighbouring particles hit at once.
//
// Simple design: one thread per particle, global atomicAdd straight into
// a zeroed window, no shared memory. The sorted-by-y particle order of
// the rollout keeps a warp's atomics on a few nearby cache lines. A
// block-local shared-memory grid tile is the later optimisation. The
// splat itself (bspline.cuh splat_stencil) is shared with G2P's backward.
//
// Accumulation is in float64 (atomicAdd(double*)), then one more launch
// rounds the window to float32. This is kept for reproducibility: float32
// atomics sum the ~1e3 terms a cell gathers in another order on every run,
// so two rollouts of the same actions drift apart; in float64 the order
// shows in the float32 result only where a sum lies within ~1e-15 of a
// rounding boundary, and repeated rollouts in practice end bit-identical
// (chip_smoke.py's slice phase reports it). It also keeps the
// kernel within 3e-8 of the exact sum, where float32 atomics came to
// 5-7e-6 of the largest cell on the 1e5-particle pour scene (H100).
#include "bspline.cuh"

namespace {

__global__ void p2g_kernel(const float* __restrict__ x,
                           const float* __restrict__ chan,
                           const int* __restrict__ corner,
                           double* __restrict__ gm,
                           double* __restrict__ gmom,
                           int n, int wx, int wy, int wz, float inv_dx) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;

  softmac::Axis ax[3];
  int rel[3];
  softmac::particle_stencil(x, n, p, corner, inv_dx, ax, rel);
  const float mass = chan[p];
  float mom[3], a[3][3];
  for (int d = 0; d < 3; ++d) {
    mom[d] = chan[(1 + d) * n + p];
    for (int j = 0; j < 3; ++j) a[d][j] = chan[(4 + 3 * d + j) * n + p];
  }
  softmac::splat_stencil(ax, rel, wx, wy, wz, gm, mass, gmom, 3 * wx, wx,
                         mom, a);
}

}  // namespace

// x (3, n) positions, chan (13, n) [mass, mom(3), dx*affine(9) row-major],
// corner (3,) int32 on the device. acc: 4 * wy*wz*wx doubles zeroed by the
// caller (the mass window, then the momentum window); out: the same
// layout in float32, gm (wy*wz, wx) followed by gmom (wy*wz, 3*wx).
// Returns cudaGetLastError() after the launches.
extern "C" int softmac_p2g(const float* x, const float* chan, const int* corner,
                           double* acc, float* out, int n, int wx, int wy,
                           int wz, float inv_dx, void* stream) {
  const int cells = wx * wy * wz;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    p2g_kernel<<<softmac::blocks_for(n), softmac::kThreads, 0, s>>>(
        x, chan, corner, acc, acc + cells, n, wx, wy, wz, inv_dx);
  }
  softmac::round_to_float<<<softmac::blocks_for(4 * cells), softmac::kThreads,
                            0, s>>>(acc, out, 4 * cells);
  return static_cast<int>(cudaGetLastError());
}
