// Backward of P2G: cotangents of the 13 particle channels and of the
// positions, from the cotangents of the mass and momentum windows.
//
// Replaces: softmac_tpu/ops/pallas_chunked.py _p2g_c_bwd_pallas :661
// (pallas_call :679, kernel _p2g_c_bwd_kernel :338; the custom_vjp
// backward of pallas_chunked.family().p2g_c), same function as jax.vjp of
// mpm.p2g_dense composed with mpm.axis_weights.
//
// P2G is linear in the channels, so their cotangent is a gather of the
// window cotangents over the particle's 27 stencil cells (the adjoint of
// the sum in transfer.p2g_plain):
//   dchan[0]      = sum W dgm          dchan[1 + d] = sum W dgmom_d
//   dchan[4 + 3d] = sum WxD dgmom_d    dchan[5 + 3d] = sum WDy dgmom_d
//   dchan[6 + 3d] = sum WDz dgmom_d
// and the positions take the cotangent through the weights
// (bspline.cuh stencil_adjoint), with the per-cell cotangents
//   s_W = mass dgm + mom . dgmom,  s_WxD = a_.0 . dgmom,
//   s_WDy = a_.1 . dgmom,          s_WDz = a_.2 . dgmom.
// Cells outside the window have zero weight and are skipped, as in the
// forward kernel. The TPU kernel builds (wy*wz, T) weight slabs and takes
// MXU dots.
//
// What bounds it on the H100: bytes. It reads x and the 13 channels,
// writes 16 floats a particle, and reads the two windows once: 32 floats
// a particle + 4 a cell, 13.1 MB at 1e5 particles in a (40, 32, 16)
// window, 3.9 us at 3.35 TB/s. The first design, one thread a particle
// with 108 scattered 4-byte __ldg's of dgm and dgmom's three components,
// took 14.4 us there (NVIDIA H100 80GB HBM3, 700 W, scripts/read_ab.py in
// turns): the L1's load pipe set the pace, as for the first G2P.
//
// Design (slab_read.cuh, P2GBwdKind): the read-side tiles of G2P. A block
// of 256 threads takes 256 consecutive particles of the y-sorted order and
// stages the box of window cells their stencils reach into shared memory,
// a cell one float4 (dgm, dgmom_0, dgmom_1, dgmom_2: no padding lane);
// each particle loads its 13 channels (in the bounds phase, so that the
// loads overlap the box and the staging) and runs the first design's reverse
// sweep over its 27 cells there, the same per-cell arithmetic in the same
// order (the same bits); particles whose rows do not fit the slab read
// device memory in the same loop (counted in off_slab). A gather: no
// atomics, no scratch. One launch a call. The sweep keeps the 13 sums and
// the 13 channels live; it makes each axis's weights and derivatives
// again where it uses them (stencil_adjoint's kRemake), so that it fits
// the 80 registers of three blocks an SM without a spill.
#include "slab_read.cuh"

namespace {

// The sums of one particle: its 13 channel cotangents (out) and dx, the
// reverse sweep over its cells' (dgm, dgmom) float4s
struct P2GBwdKind {
  static constexpr int kChannels = 4, kWide = 0b1110;

  // the particle's 13 channels: mass, momentum, the affine rows
  struct Inputs {
    float mass, mom[3], af[3][3];
  };

  static __device__ __forceinline__ void load(const softmac::ReadArgs& a,
                                              int p, Inputs& in) {
    const int n = a.n;
    in.mass = __ldg(a.in + p);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      in.mom[d] = __ldg(a.in + (1 + d) * n + p);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        in.af[d][j] = __ldg(a.in + (4 + 3 * d + j) * n + p);
      }
    }
  }

  template <class Thread, class Cells>
  static __device__ __forceinline__ void sums(const softmac::ReadArgs& a,
                                              const Thread& me, Cells cells,
                                              int p) {
    const Inputs& in = me.in;
    float acc[13];
#pragma unroll
    for (int c = 0; c < 13; ++c) acc[c] = 0.f;
    auto cell = [&](int cy, int cz, int cx, float W, float WxD, float WDy,
                    float WDz, float s[4]) {
      const float4 g4 = cells(cy, cz, cx);
      const float gmc = g4.x;
      const float gd[3] = {g4.y, g4.z, g4.w};
      acc[0] += W * gmc;
      s[0] = in.mass * gmc;
      s[1] = s[2] = s[3] = 0.f;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        acc[1 + d] += W * gd[d];
        acc[4 + 3 * d] += WxD * gd[d];
        acc[5 + 3 * d] += WDy * gd[d];
        acc[6 + 3 * d] += WDz * gd[d];
        s[0] += in.mom[d] * gd[d];
        s[1] += in.af[d][0] * gd[d];
        s[2] += in.af[d][1] * gd[d];
        s[3] += in.af[d][2] * gd[d];
      }
    };
    float g[3];
    softmac::stencil_adjoint<true>(me.ax, me.rel, a.wx, a.wy, a.wz,
                                   a.inv_dx, cell, g);
    const int n = a.n;
#pragma unroll
    for (int d = 0; d < 3; ++d) a.dx[d * n + p] = g[d];
#pragma unroll
    for (int c = 0; c < 13; ++c) a.out[c * n + p] = acc[c];
  }
};

#ifdef __CUDACC__
__global__ void __launch_bounds__(softmac::kReadTile, softmac::kReadBlocks)
    p2g_bwd_kernel(softmac::ReadArgs a) {
  softmac::read_block<P2GBwdKind>(a);
}
#endif

}  // namespace

// x (3, n), chan (13, n) and corner (3,) int32 as for softmac_p2g; dgm
// (wy*wz, wx) and dgmom (wy*wz, 3*wx) the cotangents of its outputs.
// Writes dx (3, n), dchan (13, n) and off_slab (read_tiles(n)) int32: each
// tile's particles that read device memory. One launch (none for n = 0).
// Returns cudaGetLastError() after the launch.
extern "C" int softmac_p2g_bwd(const float* x, const float* chan,
                               const int* corner, const float* dgm,
                               const float* dgmom, float* dx, float* dchan,
                               int* off_slab, int n, int wx, int wy, int wz,
                               float inv_dx, void* stream) {
  const softmac::ReadArgs a = {x, {dgm, dgmom, dgmom + wx, dgmom + 2 * wx},
                               chan, corner, dchan, dx, off_slab, n, wx, wy,
                               wz, inv_dx, 0};
  static unsigned opted = 0;
  return softmac::read_launch(p2g_bwd_kernel, a,
                              static_cast<cudaStream_t>(stream), opted);
}
