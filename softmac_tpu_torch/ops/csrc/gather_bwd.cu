// Backward of the gather: cotangents of the positions and of the three
// velocity grids, from the cotangent of the gathered velocity (3, N).
//
// Replaces: softmac_tpu/ops/pallas_chunked.py _gather_c_bwd_pallas /
// _gather_c_bwd_kernel (the custom_vjp backward of pallas_chunked.family().
// gather_c), same function as jax.vjp of mpm.gather_dense composed with
// mpm.axis_weights.
//
// With dv_d the cotangent of out[d] = sum W g_d:
//   grids:     dg_d[c] += W dv_d over each particle's stencil cells inside
//              the window: the splat of dv;
//   positions: a gather through the weights (bspline.cuh stencil_adjoint)
//              with the per-cell weight cotangent s_W = dv . g_c.
// Cells outside the window are skipped, as in the forward kernel.
//
// What bounds it on the H100: by bytes it reads x and dv (6 floats a
// particle) and the three grids, and writes dx and three grid cotangents:
// about 2.6 MB at 1e5 particles and a (32, 32, 16) window, 0.8 us at
// 3.35 TB/s; where dv is zero for most particles, as on the flagship pour,
// a particle at zero needs only its dx written. What held the first design
// (one thread a particle, both parts in one stencil walk each) back was
// the 81 float64 atomics a particle performed in device memory, zero or
// not, on cells that neighbouring sorted particles hit at once (0.281 ms
// at 1e5 particles on an H100).
//
// Design: the grid half is the splat's shared-memory y-slab scatter
// (slab.cuh) with its three channels (GatherBwdValues): each slab cell's
// sums gathered without atomics, in float64 and a fixed order, summed over
// the tiles in tile order by a second launch and rounded to float32 once,
// so repeated rollouts end bit-identical; cells of rows outside a block's
// slab go to the counted spill window. On the pour the cotangent that
// reaches the gather is exactly zero out of both bodies' contact bands
// (the contact passes it through and the splat's -2 (v_tmp - v_tgt) takes
// it back), and such a particle adds nothing to the grids: W >= 0 and
// every sum starts at +0, so skipping it is exact to the bit, as in the
// splat. A skipped particle does not widen its tile's slab, and a tile of
// skipped particles stages, sorts and writes nothing. The position half
// runs in the same launch, in the stage phase, where each thread already
// holds its particle's weights and base cell: the adjoint reads the three
// grids through the read-only cache, in the order of the first design,
// and writes dx without atomics; a skipped particle writes dx = 0.
#include "slab.cuh"

namespace {

// one particle's gather cotangent (slab.cuh's three values); a particle
// whose cotangent is all zero is skipped
struct GatherBwdValues : softmac::SlabThreeValues {
  using SlabThreeValues::SlabThreeValues;

  // the position half: dx of particle p through its weights
  __device__ static void finish(const softmac::SlabArgs& a, int p,
                                const softmac::Axis ax[3], const int rel[3]) {
    const GatherBwdValues val(a.src, a.n, p);
    const float* __restrict__ gv0 = a.grid[0];
    const float* __restrict__ gv1 = a.grid[1];
    const float* __restrict__ gv2 = a.grid[2];
    const int wx = a.wx;
    auto cell = [&](int cy, int cz, int cx, float, float, float, float,
                    float s[4]) {
      const int idx = (cy * a.wz + cz) * wx + cx;
      s[0] = val.v[0] * __ldg(gv0 + idx) + val.v[1] * __ldg(gv1 + idx)
             + val.v[2] * __ldg(gv2 + idx);
      s[1] = s[2] = s[3] = 0.f;
    };
    float gx[3];
    softmac::stencil_adjoint(ax, rel, wx, a.wy, a.wz, a.inv_dx, cell, gx);
    for (int d = 0; d < 3; ++d) a.dx[d * a.n + p] = gx[d];
  }

  // a particle at zero: no grid term, dx = 0
  __device__ static void skip(const softmac::SlabArgs& a, int p) {
    for (int d = 0; d < 3; ++d) a.dx[d * a.n + p] = 0.f;
  }
};

}  // namespace

// x (3, n), dv (3, n) the cotangent of the gather's output, corner (3,)
// int32, gv0..gv2 (wy*wz, wx) the grids the gather read, on the device; dx
// (3, n). spill: 3 * wy*wz*wx + 1 doubles zeroed by the caller (the spill
// window, then the count of spilled particles as an unsigned 64-bit
// integer); partial and meta as softmac_slab_plan (3 channels of 3 inputs)
// gives them; out: the three grid cotangents in float32, one (wy*wz, wx)
// grid after the other. `tile` particles a block, a power of two up to
// kSlabMaxTile. Returns cudaGetLastError() after the launches.
extern "C" int softmac_gather_bwd(const float* x, const float* dv,
                                  const int* corner, const float* gv0,
                                  const float* gv1, const float* gv2,
                                  float* dx, double* spill, double* partial,
                                  int* meta, float* out, int n, int tile,
                                  int wx, int wy, int wz, float inv_dx,
                                  void* stream) {
  if (!softmac::slab_tile_ok(tile)) return cudaErrorInvalidValue;
  const softmac::SlabPlan plan = softmac::slab_plan(
      GatherBwdValues::kChannels, GatherBwdValues::kInputs, n, tile, wx, wy,
      wz);
  const softmac::SlabArgs a = {x, dv, corner, spill, partial, meta, n,
                               plan.tile, 3, wx, wy, wz, inv_dx, plan,
                               {gv0, gv1, gv2}, dx};
  return softmac::slab_launch<GatherBwdValues>(
      a, out, static_cast<cudaStream_t>(stream));
}

