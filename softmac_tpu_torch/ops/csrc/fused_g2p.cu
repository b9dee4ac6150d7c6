// Dense-weight G2P: weighted gather of the grid velocity and of the MLS
// affine field C through per-axis weight matrices back to the particles.
//
// Replaces: softmac_tpu/ops/pallas_fused.py _g2p_pallas :660 (pallas_call
// :672, kernel _g2p_kernel :295); the function of _g2p_ref :207 and of
// ops/fused.py g2p_plain, for any dense weights, over the window cells with
// g_d the three velocity grids (wy*wz, wx):
//   out[d]          = sum Wy Wz Wx g_d          (velocity, rows 0-2)
//   out[3 + 3d + 0] = sum Wy Wz WxD g_d         (C[d][0], unscaled)
//   out[3 + 3d + 1] = sum WDy Wz Wx g_d         (C[d][1], unscaled)
//   out[3 + 3d + 2] = sum Wy WDz Wx g_d         (C[d][2], unscaled)
// The caller scales C by 4 * inv_dx (mpm._Transfers.g2p). The JAX kernel
// writes 16 rows, 12-15 zero padding; this one writes the 12 that are read.
//
// What bounds it on the H100: bytes. It reads the six weight matrices
// (2 (wx + wy + wz) floats a particle) and the three grids (196 KB at
// (32, 16, 32), L2-resident), and writes 12 floats a particle: 69 MB at
// 1e5 particles, 21 us at 3.35 TB/s. At the door's 5400 particles the
// latency of finding each particle's box: one thread a particle scanned
// its 160 weight entries alone, a long dependent chain on a card a sixth
// occupied.
//
// Design (fused_rows.cuh, without weight rows): 32 particles a tile, one a
// lane, on a block of 8 warps; the warps split the window's rows to find
// the boxes (coalesced) and keep their entries; the pair products Wy Wz,
// WDy Wz, Wy WDz over each (y, z) box staged once in double; then one
// thread a (particle, velocity component d), which sums its four rows
// over the box (box_sums of grid d): 3 tasks a particle, so each tile on
// one block (a second would repeat the box scan for warps with no task).
// One task an output row (12 a particle) repeats each cell's reads 4
// times and was slower at both sizes (PERF.md). Each output is one
// thread's, rounded once, written once: no atomics, repeated runs are
// bit-identical. One launch a call, no scratch.
#include "fused_rows.cuh"

namespace {

using softmac::RowsArgs;
using softmac::RowsShared;

// G2P's work is the extra tasks alone: task d, the four rows of component
// d (v_d, C[d][0], C[d][1], C[d][2]) over the particle's box.
struct G2P {
  static constexpr int kGrids = 3;
  static constexpr bool kDeriv = true, kRows = false;
  static constexpr int kScatter = 0;  // sums, no window

  __device__ static int extra_tasks(const RowsArgs&, bool) { return 3; }

  __device__ static void extra(const RowsArgs& a, RowsShared* sh,
                               bool narrow, int d, int lane, int p) {
    double s[4];
    softmac::box_sums<true>(a, *sh, narrow, d, lane, p, s);
    const size_t n = a.n;
    const int rows[4] = {d, 3 + 3 * d, 4 + 3 * d, 5 + 3 * d};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      a.out[rows[k] * n + p] = static_cast<float>(s[k]);
    }
  }
};

#ifdef __CUDACC__
__global__ void __launch_bounds__(softmac::kRowThreads, softmac::kRowBlocks)
    fused_g2p_kernel(const RowsArgs a) {
  __shared__ RowsShared sh;
  softmac::rows_block<G2P>(a, &sh);
}
#endif

}  // namespace

// Wx, WxD (wx, n), Wy, WDy (wy, n), Wz, WDz (wz, n) weight matrices,
// gv0..gv2 (wy*wz, wx) grid velocity, out (12, n). One launch (none for
// n = 0). Returns cudaGetLastError() after the launch.
extern "C" int softmac_fused_g2p(const float* Wx, const float* WxD,
                                 const float* Wy, const float* WDy,
                                 const float* Wz, const float* WDz,
                                 const float* gv0, const float* gv1,
                                 const float* gv2, float* out, int n, int wx,
                                 int wy, int wz, void* stream) {
  if (n > 0) {
    const RowsArgs a = {{Wx, WxD, Wy, WDy, Wz, WDz},
                        {gv0, gv1, gv2, nullptr},
                        {wx, wx, wx, 0},
                        nullptr, out, nullptr, nullptr, nullptr,
                        n, {wx, wy, wz}};
    fused_g2p_kernel<<<softmac::rows_blocks(n), softmac::kRowThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
