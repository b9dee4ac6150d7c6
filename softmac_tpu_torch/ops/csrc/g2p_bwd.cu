// Backward of G2P: cotangents of the positions and of the three velocity
// grids, from the cotangents of G2P's 12 output rows (v, unscaled C).
//
// Replaces: softmac_tpu/ops/pallas_chunked.py _g2p_c_bwd_pallas /
// _g2p_c_bwd_kernel (the custom_vjp backward of pallas_chunked.family().
// g2p_c), same function as jax.vjp of mpm.g2p_dense composed with
// mpm.axis_weights. Only rows 0-11 of the cotangent exist: the port's G2P
// returns 12 rows, the TPU kernel 16 (4 of them zero padding).
//
// With dv_d = g[d] and dC_dj = g[3 + 3d + j]:
//   grids:     dg_d[c] += W dv_d + WxD dC_d0 + WDy dC_d1 + WDz dC_d2
//              over each particle's stencil cells: P2G's momentum splat
//              with dv in place of the momentum and dC in place of the
//              affine rows;
//   positions: a gather through the weights (bspline.cuh stencil_adjoint)
//              with the per-cell cotangents s_W = dv . g_c,
//              s_WxD = dC_.0 . g_c, s_WDy = dC_.1 . g_c, s_WDz = dC_.2 . g_c.
// Cells outside the window are skipped, as in the forward kernel.
//
// What bounds it on the H100: bytes (x, 12 cotangent rows, 3 grids in;
// dx and 3 grid cotangents out: 18 floats a particle + 6 a cell, 7.7 MB
// at 1e5 particles, 2.3 us at 3.35 TB/s). What held the first design (one
// thread a particle, both parts in one stencil walk each) back was the 81
// float64 atomics a particle performed in device memory, on cells that
// neighbouring sorted particles hit at once (0.265 ms at 1e5 particles on
// an H100).
//
// Design: the grid half is P2G's shared-memory y-slab scatter (slab.cuh)
// with three channels of twelve inputs (G2PBwdValues): each slab cell's
// sums gathered without atomics, in float64 and a fixed order, summed over
// the tiles in tile order by a second launch and rounded to float32 once,
// so repeated rollouts end bit-identical; cells of rows outside a block's
// slab go to the counted spill window. The position half runs in the same
// launch, in the stage phase, where each thread already holds its
// particle's weights and base cell: the adjoint reads the three grids
// through the read-only cache, in the order of the first design, and
// writes dx without atomics. Every particle is active (its cotangent rows
// are dense on the main path).
#include "slab.cuh"

namespace {

// one particle's G2P cotangent: dv (3) and dC (3 x 3, row-major); the
// grids' channel c is the momentum-type splat of (dv_c, dC_c.)
struct G2PBwdValues {
  static constexpr int kChannels = 3, kInputs = 12;
  float dv[3], dC[3][3];

  __device__ static bool active(const float*, int, int) { return true; }

  // the 12 cotangent rows of stride n at column p
  __device__ G2PBwdValues(const float* g, int n, int p) {
    for (int d = 0; d < 3; ++d) {
      dv[d] = g[d * n + p];
      for (int j = 0; j < 3; ++j) dC[d][j] = g[(3 + 3 * d + j) * n + p];
    }
  }

  // the same 12 floats staged in three float4s
  __device__ explicit G2PBwdValues(const float4* v) {
    const float4 f0 = v[0], f1 = v[1], f2 = v[2];
    dv[0] = f0.x, dv[1] = f0.y, dv[2] = f0.z, dC[0][0] = f0.w;
    dC[0][1] = f1.x, dC[0][2] = f1.y, dC[1][0] = f1.z, dC[1][1] = f1.w;
    dC[1][2] = f2.x, dC[2][0] = f2.y, dC[2][1] = f2.z, dC[2][2] = f2.w;
  }

  __device__ float value(int c, float wgt, float dwx, float dwy,
                         float dwz) const {
    return wgt * dv[c] + dwx * dC[c][0] + dwy * dC[c][1] + dwz * dC[c][2];
  }

  // the position half: dx of particle p through its weights
  __device__ static void finish(const softmac::SlabArgs& a, int p,
                                const softmac::Axis ax[3], const int rel[3]) {
    const G2PBwdValues val(a.src, a.n, p);
    const float* __restrict__ gv0 = a.grid[0];
    const float* __restrict__ gv1 = a.grid[1];
    const float* __restrict__ gv2 = a.grid[2];
    const int wx = a.wx;
    auto cell = [&](int cy, int cz, int cx, float, float, float, float,
                    float s[4]) {
      const int idx = (cy * a.wz + cz) * wx + cx;
      const float gc[3] = {__ldg(gv0 + idx), __ldg(gv1 + idx),
                           __ldg(gv2 + idx)};
      s[0] = s[1] = s[2] = s[3] = 0.f;
      for (int d = 0; d < 3; ++d) {
        s[0] += val.dv[d] * gc[d];
        s[1] += val.dC[d][0] * gc[d];
        s[2] += val.dC[d][1] * gc[d];
        s[3] += val.dC[d][2] * gc[d];
      }
    };
    float gx[3];
    softmac::stencil_adjoint(ax, rel, wx, a.wy, a.wz, a.inv_dx, cell, gx);
    for (int d = 0; d < 3; ++d) a.dx[d * a.n + p] = gx[d];
  }

  __device__ static void skip(const softmac::SlabArgs&, int) {}
};

}  // namespace

// x (3, n), g (12, n) the cotangent of G2P's output, corner (3,) int32,
// gv0..gv2 (wy*wz, wx) the grids G2P read, on the device; dx (3, n).
// spill: 3 * wy*wz*wx + 1 doubles zeroed by the caller (the spill window,
// then the count of spilled particles as an unsigned 64-bit integer);
// partial and meta as softmac_slab_plan (3 channels of 12 inputs) gives
// them; out: the three grid cotangents in float32, one (wy*wz, wx) grid
// after the other. `tile` particles a block, a power of two up to
// kSlabMaxTile. Returns cudaGetLastError() after the launches.
extern "C" int softmac_g2p_bwd(const float* x, const float* g,
                               const int* corner, const float* gv0,
                               const float* gv1, const float* gv2, float* dx,
                               double* spill, double* partial, int* meta,
                               float* out, int n, int tile, int wx, int wy,
                               int wz, float inv_dx, void* stream) {
  if (!softmac::slab_tile_ok(tile)) return cudaErrorInvalidValue;
  const softmac::SlabPlan plan = softmac::slab_plan(
      G2PBwdValues::kChannels, G2PBwdValues::kInputs, n, tile, wx, wy, wz);
  const softmac::SlabArgs a = {x, g, corner, spill, partial, meta, n,
                               plan.tile, 3, wx, wy, wz, inv_dx, plan,
                               {gv0, gv1, gv2}, dx};
  return softmac::slab_launch<G2PBwdValues>(
      a, out, static_cast<cudaStream_t>(stream));
}

