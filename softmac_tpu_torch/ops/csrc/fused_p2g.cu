// Dense-weight P2G: splat of mass and momentum (with the MLS affine term)
// through per-axis weight matrices onto the active grid window.
//
// Replaces: softmac_tpu/ops/pallas_fused.py _p2g_pallas :627 (pallas_call
// :641, kernel _p2g_kernel :256); the function of _p2g_ref :181 and of
// ops/fused.py p2g_plain, for any dense weights:
//   gm[(y,z), x]          += Wy Wz Wx mass
//   gmom[(y,z), d wx + x] += Wy Wz (Wx mom_d + WxD a_d0) + WDy Wz Wx a_d1
//                            + Wy WDz Wx a_d2
// with every weight taken at the particle's column and a = dx * affine.
// The TPU kernel builds a (wy*wz, T) slab in VMEM and feeds the MXU with a
// bf16x3 split; here there is no matrix unit in the way and no bf16: the
// products and sums are in double, rounded to float once.
//
// What bounds it on the H100: by bytes it reads the six weight matrices
// (2 (wx + wy + wz) floats a particle) and 13 channels, and writes the
// window once: 69 MB at 1e5 particles and window (32, 16, 32), 21 us at
// 3.35 TB/s. In practice the float64 atomics, 4 per visited cell (108 a
// particle for B-spline weights), contended where many particles share
// cells (the door tiled to 1e5), and at the door's 5400 particles the
// latency of finding each particle's box.
//
// Design (fused_rows.cuh, without weight rows): 32 particles a tile, one
// a lane, on a block of 8 warps (or a few blocks that share its tasks
// where the tiles are too few to fill the card); the warps split the
// window's rows to find the boxes (coalesced) and keep their entries; the
// pair products Wy Wz, WDy Wz, Wy WDz over each (y, z) box staged once in
// double; then one thread a (particle, (y, z) cell of its box), which adds
// the four channels of the cell's x rows with atomicAdd(double) into the
// zeroed window (rows_scatter). One more launch rounds the window to
// float32 once: as in p2g.cu, the float64 sums make repeated runs agree,
// where float32 atomics would add in another order each time.
#include "fused_rows.cuh"

namespace {

using softmac::RowsArgs;
using softmac::RowsShared;

// P2G's work is the extra tasks alone: one a (y, z) cell of the
// particle's box.
struct P2G : softmac::RowsKind {
  static constexpr int kGrids = 0;     // no weight rows, no grids to read
  static constexpr bool kDeriv = true, kRows = false;
  static constexpr int kScatter = 4;  // channels of the window
  static constexpr bool kLines = true;  // gm, then gmom (wy*wz, 3*wx)

  __device__ static int extra_tasks(const RowsArgs& a, bool narrow) {
    return softmac::scatter_tasks(a, narrow);
  }

  __device__ static void extra(const RowsArgs& a, RowsShared* sh,
                               bool narrow, int task, int lane, int p) {
    softmac::rows_scatter<P2G>(a, sh, narrow, task, lane, p);
  }
};

#ifdef __CUDACC__
__global__ void __launch_bounds__(softmac::kRowThreads, softmac::kRowBlocks)
    fused_p2g_kernel(const RowsArgs a) {
  __shared__ RowsShared sh;
  softmac::rows_block<P2G>(a, &sh);
}
#endif

}  // namespace

// Wx, WxD (wx, n), Wy, WDy (wy, n), Wz, WDz (wz, n) weight matrices, chan
// (13, n) [mass, mom(3), dx*affine(9) row-major]. acc: 4 * wy*wz*wx doubles
// zeroed by the caller (the mass window, then the momentum window); out:
// the same layout in float32, gm (wy*wz, wx) followed by gmom
// (wy*wz, 3*wx). Two launches: the kernel (none for n = 0), the round.
// Returns cudaGetLastError() after the launches.
extern "C" int softmac_fused_p2g(const float* Wx, const float* WxD,
                                 const float* Wy, const float* WDy,
                                 const float* Wz, const float* WDz,
                                 const float* chan, double* acc, float* out,
                                 int n, int wx, int wy, int wz, void* stream) {
  const int cells = wx * wy * wz;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RowsArgs a = {{Wx, WxD, Wy, WDy, Wz, WDz},
                      {nullptr, nullptr, nullptr, nullptr},
                      {0, 0, 0, 0},
                      chan, nullptr, acc, nullptr, nullptr,
                      n, {wx, wy, wz}};
  if (n > 0) {
    fused_p2g_kernel<<<dim3(softmac::rows_blocks(n), softmac::rows_parts(n)),
                       softmac::kRowThreads, 0, s>>>(a);
  }
  softmac::round_to_float<<<softmac::blocks_for(4 * cells), softmac::kThreads,
                            0, s>>>(acc, out, 4 * cells);
  return static_cast<int>(cudaGetLastError());
}
