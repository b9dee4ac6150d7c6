// Gather: B-spline interpolation of the grid velocity at the particles
// (v_tmp of the mixed-contact substep), without G2P's affine rows.
//
// Replaces: softmac_tpu/ops/pallas_chunked.py _gather_c_pallas /
// _gather_c_kernel (the y-chunked Pallas gather), same function as
// mpm.gather_dense.
//
// Computes, for every particle p over its 27 stencil cells inside the
// window, with g_d the three velocity grids (wy*wz, wx):
//   out[d] = sum W g_d      (W = Wx Wy Wz, the bspline.cuh weights)
// Cells outside the window are skipped, as in G2P.
//
// What bounds it on the H100: not bytes. It must move 3 position floats
// and 3 output floats a particle and the window's three grids once, about
// 2.6 MB at 1e5 particles (0.8 us at 3.35 TB/s). The first design, one
// thread a particle with G2P's 81 scattered 4-byte __ldg's, took 7.3 us on
// the flagship pour's 1e5-particle state (NVIDIA H100 80GB HBM3, 700 W),
// the L1's load pipe setting the pace as in G2P. This design takes 6.2 us
// there (scripts/read_ab.py, in turns; 6.0 against the first design's 5.8
// on pour_vel's state, which runs no gather): the tile's box and its
// staging take ~3 us as in G2P, and the sums ~3 us, bound by the shared
// loads (27 float4 a particle, at least four wavefronts a warp each; bank
// conflicts ~0.5 us of it).
//
// Design (slab_read.cuh, GatherKind): G2P's tiles without the nine C rows
// and the derivative weights. A block stages the box of grid cells its 256
// particles reach into shared memory, a cell one float4 of the three
// grids, and each particle sums its 27 cells there in the first design's
// order (the same bits); particles whose rows do not fit the slab read
// device memory in the same loop (counted in off_slab). One launch.
#include "slab_read.cuh"

namespace {

__global__ void __launch_bounds__(softmac::kReadTile,
                                  softmac::kReadBlocks)
    gather_kernel(softmac::ReadArgs a) {
  softmac::read_block<softmac::GatherKind>(a);
}

}  // namespace

// x (3, n) positions, gv0..gv2 (wy*wz, wx) grid velocity, corner (3,) int32
// on the device, out (3, n), off_slab (read_tiles(n)) int32: each tile's
// particles that read device memory. Returns cudaGetLastError() after the
// launch.
extern "C" int softmac_gather(const float* x, const float* gv0,
                              const float* gv1, const float* gv2,
                              const int* corner, float* out, int* off_slab,
                              int n, int wx, int wy, int wz, float inv_dx,
                              void* stream) {
  const softmac::ReadArgs a = {x, {gv0, gv1, gv2, nullptr}, nullptr, corner,
                               out, nullptr, off_slab, n, wx, wy, wz, inv_dx,
                               0};
  static unsigned opted = 0;
  return softmac::read_launch(gather_kernel, a,
                              static_cast<cudaStream_t>(stream), opted);
}
