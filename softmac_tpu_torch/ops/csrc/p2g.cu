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
// window once, about 2 us at 3.35 TB/s. What held the first design (one
// thread a particle) back was the 108 float64 atomics a particle
// performed in device memory: the rollout keeps the particles sorted by
// y-cell, so neighbouring threads hit the same ~16k cells and their
// atomics queue in L2 (0.29 ms at 1e5 particles on an H100, where the
// gather, the same stencil without atomics, takes 0.04).
//
// Design (slab.cuh): the TPU kernel's idea on Hopper's shared memory. A
// block takes a tile of consecutive sorted particles and the y rows their
// stencils reach; it stages the particles in shared memory, sorts them by
// base cell, and one thread a slab cell gathers the cell's mass and
// momentum from the particles of its 27 base cells, without atomics. The
// slab goes once to the tile's own partial buffer; a second launch sums
// the partials of each cell in tile order, adds the spill window and
// rounds to float32 once. The spill path (global float64 atomics for cells
// of a row outside the block's slab, its particles counted) keeps the
// kernel exact for any particle order, and the count shows whether the
// sorted order held.
//
// Accumulation is in float64, rounded to float32 once, and without spills
// every sum is taken in a fixed order, so repeated rollouts end
// bit-identical (float32 atomics summed the ~1e3 terms a cell gathers in
// another order on every run, and two rollouts of the same actions drifted
// apart). It also keeps the kernel within 3e-8 of the exact sum, where
// float32 atomics came to 5-7e-6 of the largest cell on the 1e5-particle
// pour scene (H100).
#include "slab.cuh"

namespace {

// one particle's mass, momentum and dx * affine; channel 0 is the mass,
// 1 + d the momentum component d
struct P2GValues : softmac::SlabNoParticleOutput {
  static constexpr int kChannels = 4, kInputs = 13;
  float mass, mom[3], a[3][3];

  __device__ static bool active(const float*, int, int) { return true; }

  // the 13 channel rows of stride n at column p
  __device__ P2GValues(const float* chan, int n, int p) {
    mass = chan[p];
    for (int d = 0; d < 3; ++d) {
      mom[d] = chan[(1 + d) * n + p];
      for (int j = 0; j < 3; ++j) a[d][j] = chan[(4 + 3 * d + j) * n + p];
    }
  }

  // the same 13 floats staged in four float4s
  __device__ explicit P2GValues(const float4* v) {
    const float4 f0 = v[0], f1 = v[1], f2 = v[2], f3 = v[3];
    mass = f0.x;
    mom[0] = f0.y, mom[1] = f0.z, mom[2] = f0.w;
    a[0][0] = f1.x, a[0][1] = f1.y, a[0][2] = f1.z, a[1][0] = f1.w;
    a[1][1] = f2.x, a[1][2] = f2.y, a[2][0] = f2.z, a[2][1] = f2.w;
    a[2][2] = f3.x;
  }

  __device__ float value(int c, float wgt, float dwx, float dwy,
                         float dwz) const {
    if (c == 0) return wgt * mass;
    const int d = c - 1;
    return wgt * mom[d] + dwx * a[d][0] + dwy * a[d][1] + dwz * a[d][2];
  }
};

}  // namespace

// The cut of one call for `channels` channels of `inputs` rows (P2G 4 of
// 13, the splat 3 of 3, G2P's backward 3 of 12, the gather's backward 3
// of 3) at a requested tile: out[0..4] = tiles, the tile,
// slab rows, dynamic shared bytes a block, doubles of one tile's partial
// slab. Host only.
extern "C" int softmac_slab_plan(int channels, int inputs, int n, int tile,
                                 int wx, int wy, int wz, long long* out) {
  const softmac::SlabPlan p = softmac::slab_plan(channels, inputs, n, tile,
                                                 wx, wy, wz);
  out[0] = p.tiles;
  out[1] = p.tile;
  out[2] = p.rows;
  out[3] = p.smem;
  out[4] = p.tile_doubles;
  return 0;
}

// x (3, n) positions, chan (13, n) [mass, mom(3), dx*affine(9) row-major],
// corner (3,) int32 on the device. spill: 4 * wy*wz*wx + 1 doubles zeroed
// by the caller (the spill window, then the count of spilled particles as
// an unsigned 64-bit integer); partial: tiles * tile_doubles doubles and
// meta: 2 * tiles ints (softmac_slab_plan); out: gm (wy*wz, wx) followed
// by gmom (wy*wz, 3*wx) in float32. `tile` particles a block, a power of
// two up to kSlabMaxTile. Returns cudaGetLastError() after the launches.
extern "C" int softmac_p2g(const float* x, const float* chan, const int* corner,
                           double* spill, double* partial, int* meta,
                           float* out, int n, int tile, int wx, int wy, int wz,
                           float inv_dx, void* stream) {
  if (!softmac::slab_tile_ok(tile)) return cudaErrorInvalidValue;
  const softmac::SlabPlan plan = softmac::slab_plan(
      P2GValues::kChannels, P2GValues::kInputs, n, tile, wx, wy, wz);
  const softmac::SlabArgs a = {x, chan, corner, spill, partial, meta, n,
                               plan.tile, 1, wx, wy, wz, inv_dx, plan};
  return softmac::slab_launch<P2GValues>(a, out,
                                         static_cast<cudaStream_t>(stream));
}
