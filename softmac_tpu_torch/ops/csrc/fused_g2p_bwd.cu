// Backward of the dense-weight G2P: the cotangents of the six weight
// matrices and of the three velocity grids from the cotangent of G2P's 12
// particle rows (v, then the unscaled C[d][j] in row 3 + 3d + j).
//
// Replaces: softmac_tpu/ops/pallas_fused.py _g2p_bwd_pallas :774
// (pallas_call :794, kernel _g2p_bwd_kernel :423), the custom_vjp backward
// of pallas_fused.g2p; the function of jax.vjp of _g2p_ref :207 (its rows
// 12-15 given zero cotangent) and of ops/fused.py g2p_vjp_plain, for any
// dense weights. With the particle's row cotangents cv_d = g[d] and
// cj_d = g[3 + 3d + j], the cell coefficients of fused_rows.cuh are
//   s.h = sum_d cv_d gv_d[c],  s.dj = sum_d cj_d gv_d[c],
// and each grid cotangent gathers every particle's terms at the cell:
//   dgv_d[c] += Wy Wz Wx cv_d + Wy Wz WxD c0_d + WDy Wz Wx c1_d
//               + Wy WDz Wx c2_d.
//
// What bounds it on the H100: by bytes it reads the six weight matrices and
// the 12 row cotangents and writes the six weight cotangents (2 (wx + wy +
// wz) floats a particle each way), the grids in and out once: 7.4 MB at the
// door's 5400 particles and window (32, 16, 32), 2.2 us at 3.35 TB/s. In
// practice the cell reads of the weight rows and the float64 atomics of
// the grid cotangents, 3 per box cell.
//
// Design (fused_rows.cuh): 32 particles a tile, one a lane, on a block
// of 8 warps (or a few blocks that share its tasks where the tiles are too
// few to fill the card); their boxes and pair products staged once; one
// thread a (particle, y or z weight row), one warp a particle's x rows,
// and one thread a (particle, (y, z) cell of its box) for the grid terms,
// which it adds along the box's x rows with atomicAdd(double) into the
// window the first launch zeroed; a last launch rounds the window to
// float32 once, so repeated runs agree bit for bit. Three launches a
// call: the grids' y- and z-fastest layouts with the zero fill, the
// kernel, the round.
#include "fused_rows.cuh"

namespace {

using softmac::RowsArgs;
using softmac::RowsShared;

// The grid terms: one task a (y, z) cell of the particle's box, each adding
// the cell's x rows (fused_rows.cuh rows_scatter).
struct G2PBwd {
  static constexpr int kGrids = 3;
  static constexpr bool kDeriv = true, kRows = true;
  static constexpr int kScatter = 3;  // channels of the window

  __device__ static int extra_tasks(const RowsArgs& a, bool narrow) {
    return softmac::scatter_tasks(a, narrow);
  }

  __device__ static void extra(const RowsArgs& a, RowsShared* sh,
                               bool narrow, int task, int lane, int p) {
    softmac::rows_scatter<3, true>(a, sh, narrow, task, lane, p);
  }
};

#ifdef __CUDACC__
__global__ void __launch_bounds__(softmac::kRowThreads, softmac::kRowBlocks)
    fused_g2p_bwd_kernel(const RowsArgs a) {
  __shared__ RowsShared sh;
  softmac::rows_block<G2PBwd>(a, &sh);
}
#endif

}  // namespace

// Wx, WxD (wx, n), Wy, WDy (wy, n), Wz, WDz (wz, n) weight matrices and
// gv0..gv2 (wy*wz, wx) as for softmac_fused_g2p; g (12, n) the cotangent of
// its output. out: (2 (wx + wy + wz), n) float32, the rows dWx, dWxD, dWy,
// dWDy, dWz, dWDz one after the other, every row written. acc: 3 *
// wy*wz*wx doubles (zeroed by the first launch); gout: the three grid
// cotangents in float32, one (wy*wz, wx) grid after the other; scratch:
// 6 * wy*wz*wx floats (the grids' two other layouts). Three launches: the
// layouts and the zero fill, the kernel, the round. Returns
// cudaGetLastError() after the launches.
extern "C" int softmac_fused_g2p_bwd(const float* Wx, const float* WxD,
                                     const float* Wy, const float* WDy,
                                     const float* Wz, const float* WDz,
                                     const float* gv0, const float* gv1,
                                     const float* gv2, const float* g,
                                     float* out, double* acc, float* gout,
                                     float* scratch, int n, int wx, int wy,
                                     int wz, void* stream) {
  const int count = 3 * wx * wy * wz;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RowsArgs a = {{Wx, WxD, Wy, WDy, Wz, WDz},
                      {gv0, gv1, gv2, nullptr},
                      {wx, wx, wx, 0},
                      g, out, acc, scratch, scratch + count,
                      n, {wx, wy, wz}};
  softmac::rows_prep<3><<<softmac::blocks_for(count), softmac::kThreads, 0,
                          s>>>(a);
  if (n > 0) {
    fused_g2p_bwd_kernel<<<dim3(softmac::rows_blocks(n),
                                softmac::rows_parts(n)),
                           softmac::kRowThreads, 0,
                           s>>>(a);
  }
  softmac::round_to_float<<<softmac::blocks_for(count), softmac::kThreads, 0,
                            s>>>(acc, gout, count);
  return static_cast<int>(cudaGetLastError());
}
