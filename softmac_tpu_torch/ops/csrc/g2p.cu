// G2P: weighted gather of grid velocity and of the MLS affine field C from
// the active grid window back to the particles.
//
// Replaces: softmac_tpu/ops/pallas_chunked.py _g2p_c_pallas / _g2p_c_kernel
// (the y-chunked Pallas G2P), same function as mpm.g2p_dense.
//
// Computes, for every particle p over its 27 stencil cells inside the
// window, with g_d the three velocity grids (wy*wz, wx):
//   out[d]         = sum W g_d                   (velocity, rows 0-2)
//   out[3 + 3d + 0] = sum WxD Wy Wz g_d           (C[d][0], unscaled)
//   out[3 + 3d + 1] = sum Wx WDy Wz g_d           (C[d][1], unscaled)
//   out[3 + 3d + 2] = sum Wx Wy WDz g_d           (C[d][2], unscaled)
// The caller scales C by 4 * inv_dx (mpm._Transfers.g2p). The JAX kernel's
// output has 16 rows, rows 12-15 being zero sublane padding; nothing reads
// them, so this kernel writes the 12 rows the substep uses.
//
// What bounds it on the H100: not bytes. It must move 3 position floats
// and 12 output floats a particle and the window's three grids once, about
// 6.2 MB at 1e5 particles (1.9 us at 3.35 TB/s). The first design, one
// thread a particle with 81 scattered 4-byte __ldg's of the three separate
// grids, took 9.9 us on pour_vel's 1e5-particle state (NVIDIA H100 80GB
// HBM3, 700 W): the rollout sorts particles by y cell only, so a warp's
// lanes touched many lines a load and the L1's load pipe set the pace.
// This design takes 6.5 us there (scripts/read_ab.py, in turns), in three
// serial phases of one wave of 391 blocks: the weights and the tile's box
// (~1.7 us, the launch and the position loads), the staging (~1.3 us of L2
// reads), and the sums (~3.5 us: 27 shared float4 loads and ~600
// instructions a particle, issue-bound).
//
// Design (slab_read.cuh, G2PKind): a block of 256 threads takes 256
// consecutive particles of the y-sorted order, stages the box of grid
// cells their stencils reach into shared memory, channel-interleaved (27
// float4 loads a particle), and sums each particle's stencil there in the
// first design's order and products (the same bits); particles whose rows
// do not fit the slab read device memory in the same loop (counted in
// off_slab). One launch.
#include "slab_read.cuh"

namespace {

__global__ void __launch_bounds__(softmac::kReadTile,
                                  softmac::kReadBlocks)
    g2p_kernel(softmac::ReadArgs a) {
  softmac::read_block<softmac::G2PKind>(a);
}

}  // namespace

// x (3, n) positions, gv0..gv2 (wy*wz, wx) grid velocity, corner (3,) int32
// on the device, out (12, n), off_slab (read_tiles(n)) int32: each tile's
// particles that read device memory. Returns cudaGetLastError() after the
// launch.
extern "C" int softmac_g2p(const float* x, const float* gv0, const float* gv1,
                           const float* gv2, const int* corner, float* out,
                           int* off_slab, int n, int wx, int wy, int wz,
                           float inv_dx, void* stream) {
  const softmac::ReadArgs a = {x, {gv0, gv1, gv2, nullptr}, nullptr, corner,
                               out, nullptr, off_slab, n, wx, wy, wz, inv_dx,
                               0};
  static unsigned opted = 0;
  return softmac::read_launch(g2p_kernel, a,
                              static_cast<cudaStream_t>(stream), opted);
}
