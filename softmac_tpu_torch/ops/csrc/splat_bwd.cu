// Backward of the splat: cotangents of the positions and of the splatted
// values, from the cotangent of the window (wy*wz, 3*wx).
//
// Replaces: softmac_tpu/ops/pallas_chunked.py _splat_c_bwd_pallas :821
// (pallas_call :836, kernel _splat_c_bwd_kernel :564; the custom_vjp
// backward of pallas_chunked.family().splat_c), same function as jax.vjp
// of mpm.splat_channels composed with mpm.axis_weights.
//
// With dout_d[c] the window cotangent of component d at cell c:
//   values:    dvals_d = sum W dout_d over the particle's stencil cells
//              inside the window (a gather, as the forward gather);
//   positions: a gather through the weights (bspline.cuh stencil_adjoint)
//              with the per-cell weight cotangent s_W = vals . dout_c.
// Cells outside the window are skipped, as in the forward kernel. A
// particle whose three values are zero (the pour's contact correction
// -2 dv is zero outside the contact band) has s_W = 0 at every cell, so
// its dx is zero and its dvals are the gather's sums over dout.
//
// What bounds it on the H100: bytes. It reads x and the values (6 floats
// a particle) and the window cotangent once (196 KB at (32, 32, 16)), and
// writes dx and dvals (6 floats a particle): 12 floats a particle + 3 a
// cell, 5.0 MB at 1e5 particles, 1.5 us at 3.35 TB/s. The first design,
// one thread a particle with 81 scattered 4-byte __ldg's and the whole
// reverse sweep for every particle, took 11.1 us on the pour's state
// (NVIDIA H100 80GB HBM3, 700 W).
//
// Design (slab_read.cuh, SplatBwdKind): the read-side tiles of the
// gather. A block of 256 threads takes 256 consecutive particles of the
// y-sorted order and stages the box of window cells their stencils reach
// into shared memory, a cell one float4 of dout's three components; each
// particle loads its values, and a warp whose particles are all at zero
// takes GatherKind's sums alone (read_stencil, the first design's order
// and products for dvals) and writes dx = 0, while any other warp runs the
// first design's reverse sweep there for all its particles, the same
// per-cell arithmetic in the same order (the same bits). The vote is a
// warp's, not a particle's: a warp with one particle in the band would
// otherwise take the gather and then the sweep, one after the other, and
// such warps set the pace of a block (on the pour's state a particle's own
// branch took 8.8 us, the warp's vote 6.8-7.0, every particle swept 7.5;
// NVIDIA H100 80GB HBM3, 700 W, scripts/read_ab.py --variants).
// Particles whose rows do not fit the slab read device memory in the same
// loop (counted in off_slab). A gather: no atomics, no scratch. One launch
// a call.
#include "slab_read.cuh"

namespace {

// The sums of one particle: dvals (out) and dx, the reverse sweep over its
// cells' dout float4s, or the gather alone where every particle of the
// warp (those that reach this call together) is at zero. A particle at
// zero in a warp that sweeps gets the same bits: s_W is zero at every
// cell, so dx is +0, and dvals are the sweep's sums with the gather's
// products in the gather's order. That holds for a finite dout: where it
// holds an inf or a NaN, the sweep gives such a particle dx = 0 * inf =
// NaN, as the plain vjp does, and a warp at zero writes dx = 0, as the
// y-slab gather backward's skip of a zero-valued particle does.
struct SplatBwdKind {
  static constexpr int kChannels = 3, kWide = 0b0111;

  struct Inputs {
    float val[3];
  };

  static __device__ __forceinline__ void load(const softmac::ReadArgs& a,
                                              int p, Inputs& in) {
#pragma unroll
    for (int d = 0; d < 3; ++d) in.val[d] = __ldg(a.in + d * a.n + p);
  }

  template <class Thread, class Cells>
  static __device__ __forceinline__ void sums(const softmac::ReadArgs& a,
                                              const Thread& me, Cells cells,
                                              int p) {
    const int n = a.n;
    const float val[3] = {me.in.val[0], me.in.val[1], me.in.val[2]};
    if (!__any_sync(__activemask(),
                    val[0] != 0.f || val[1] != 0.f || val[2] != 0.f)) {
      softmac::read_stencil<false>(a, me.ax, me.rel, cells, p);
#pragma unroll
      for (int d = 0; d < 3; ++d) a.dx[d * n + p] = 0.f;
      return;
    }
    float dval[3] = {0.f, 0.f, 0.f};
    auto cell = [&](int cy, int cz, int cx, float w, float, float, float,
                    float s[4]) {
      const float4 g4 = cells(cy, cz, cx);
      const float g[3] = {g4.x, g4.y, g4.z};
      s[0] = 0.f;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        dval[d] += w * g[d];
        s[0] += val[d] * g[d];
      }
      s[1] = s[2] = s[3] = 0.f;
    };
    float gx[3];
    softmac::stencil_adjoint(me.ax, me.rel, a.wx, a.wy, a.wz, a.inv_dx, cell,
                             gx);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      a.dx[d * n + p] = gx[d];
      a.out[d * n + p] = dval[d];
    }
  }
};

#ifdef __CUDACC__
__global__ void __launch_bounds__(softmac::kReadTile, softmac::kReadBlocks)
    splat_bwd_kernel(softmac::ReadArgs a) {
  softmac::read_block<SplatBwdKind>(a);
}
#endif

}  // namespace

// x (3, n) positions, vals (3, n) and corner (3,) int32 as for
// softmac_splat; dout (wy*wz, 3*wx) the cotangent of its window. Writes dx
// and dvals (3, n) and off_slab (read_tiles(n)) int32: each tile's
// particles that read device memory. One launch (none for n = 0). Returns
// cudaGetLastError() after the launch.
extern "C" int softmac_splat_bwd(const float* x, const float* vals,
                                 const int* corner, const float* dout,
                                 float* dx, float* dvals, int* off_slab,
                                 int n, int wx, int wy, int wz, float inv_dx,
                                 void* stream) {
  const softmac::ReadArgs a = {x, {dout, dout + wx, dout + 2 * wx, nullptr},
                               vals, corner, dvals, dx, off_slab, n, wx, wy,
                               wz, inv_dx, 0};
  static unsigned opted = 0;
  return softmac::read_launch(splat_bwd_kernel, a,
                              static_cast<cudaStream_t>(stream), opted);
}
