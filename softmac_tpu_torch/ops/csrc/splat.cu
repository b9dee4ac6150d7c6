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
// 0.8 us at 3.35 TB/s. What held the first design (one thread a particle)
// back was the 81 float64 atomics in device memory that every particle
// performed, in contact or not, onto a window of ~16k cells that
// neighbouring sorted particles hit at once (0.28 ms at 1e5 particles on
// an H100).
//
// Design: P2G's shared-memory y-slab tiles (slab.cuh) with three channels:
// stage, sort by base cell, gather each slab cell without atomics, sum the
// tiles' partials in tile order in a second launch. The values are zero
// for every particle out of contact, and such a particle adds nothing:
// W >= 0 and every sum starts at +0, so skipping it is exact to the bit.
// Skipped particles do not widen their tile's slab either, so a tile with
// no particle in contact stages, sorts and writes nothing. Cells of a row
// outside the slab go to the spill window by global float64 atomics
// (exact for any order, the particles counted). The sums are float64,
// rounded to float32 once, in a fixed order: repeated rollouts end
// bit-identical as with P2G.
#include "slab.cuh"

namespace {

// one particle's three values (slab.cuh); a particle whose values are all
// zero is skipped
struct SplatValues : softmac::SlabThreeValues {
  using SlabThreeValues::SlabThreeValues;
};

}  // namespace

// x (3, n) positions, vals (3, n), corner (3,) int32 on the device. spill:
// 3 * wy*wz*wx + 1 doubles zeroed by the caller (the spill window, then
// the count of spilled particles as an unsigned 64-bit integer); partial
// and meta as softmac_slab_plan (3 channels) gives them; out: the window in
// float32, (wy*wz, 3*wx) with component d in columns d*wx .. (d+1)*wx.
// `tile` particles a block, a power of two up to kSlabMaxTile. Returns
// cudaGetLastError() after the launches.
extern "C" int softmac_splat(const float* x, const float* vals,
                             const int* corner, double* spill,
                             double* partial, int* meta, float* out, int n,
                             int tile, int wx, int wy, int wz, float inv_dx,
                             void* stream) {
  if (!softmac::slab_tile_ok(tile)) return cudaErrorInvalidValue;
  const softmac::SlabPlan plan = softmac::slab_plan(
      SplatValues::kChannels, SplatValues::kInputs, n, tile, wx, wy, wz);
  const softmac::SlabArgs a = {x, vals, corner, spill, partial, meta, n,
                               plan.tile, 0, wx, wy, wz, inv_dx, plan};
  return softmac::slab_launch<SplatValues>(a, out,
                                           static_cast<cudaStream_t>(stream));
}
