// Backward of the dense-weight gather: the cotangents of the three weight
// matrices and of the three velocity grids from the cotangent of the
// gathered velocity (3, N).
//
// Replaces: softmac_tpu/ops/pallas_fused.py _gather_bwd_pallas :840
// (pallas_call :858, kernel _gather_bwd_kernel :570), the custom_vjp
// backward of pallas_fused.gather; the function of jax.vjp of _gather_ref
// :241 and of ops/fused.py gather_vjp_plain, for any dense weights. With
// dv_d the particle's cotangent, the cell coefficient of fused_rows.cuh (no
// derivative weights) is s.h = sum_d dv_d gv_d[c], and each grid
// cotangent gathers every particle's terms at the cell:
//   dgv_d[c] += Wy Wz Wx dv_d.
//
// What bounds it on the H100: by bytes it reads the three weight matrices
// and writes their cotangents ((wx + wy + wz) floats a particle each way),
// dv, and the grids in and out once: 3.9 MB at the door's 5400 particles
// and window (32, 16, 32), 1.2 us at 3.35 TB/s. In practice the cell reads
// of the weight rows and the float64 atomics, 3 per box cell.
//
// Design (fused_rows.cuh, without derivative weights): the G2P backward's
// with fewer terms. 32 particles a tile, one a lane, on a block of 8 warps
// (or a few blocks that share its tasks where the tiles are too few to
// fill the card); their boxes (W alone) and pair products Wy Wz staged
// once; one thread a (particle, y or z weight row), one warp a particle's
// x rows, each row dW_A = sum_d dv_d B_d with B_d the row's sum of the
// pair products times grid d; and one thread a (particle, (y, z) cell of
// its box) for the grid terms, which it adds along the box's x rows with
// atomicAdd(double) into the window the first launch zeroed (none for a
// particle whose dv is zero; its weight rows, zeros, are still written); a
// last launch rounds the window to float32 once, so repeated runs agree
// bit for bit. Three launches a call: the grids' y- and z-fastest layouts
// with the zero fill, the kernel, the round.
#include "fused_rows.cuh"

namespace {

using softmac::RowsArgs;
using softmac::RowsShared;

// The grid terms: one task a (y, z) cell of the particle's box, each adding
// the cell's x rows (fused_rows.cuh rows_scatter).
struct GatherBwd : softmac::RowsKind {
  static constexpr int kGrids = 3;
  static constexpr bool kDeriv = false, kRows = true;
  static constexpr int kScatter = 3;  // channels of the window

  __device__ static int extra_tasks(const RowsArgs& a, bool narrow) {
    return softmac::scatter_tasks(a, narrow);
  }

  __device__ static void extra(const RowsArgs& a, RowsShared* sh,
                               bool narrow, int task, int lane, int p) {
    softmac::rows_scatter<GatherBwd>(a, sh, narrow, task, lane, p);
  }
};

#ifdef __CUDACC__
__global__ void __launch_bounds__(softmac::kRowThreads, softmac::kRowBlocks)
    fused_gather_bwd_kernel(const RowsArgs a) {
  __shared__ RowsShared sh;
  softmac::rows_block<GatherBwd>(a, &sh);
}
#endif

}  // namespace

// Wx (wx, n), Wy (wy, n), Wz (wz, n) weight matrices and gv0..gv2
// (wy*wz, wx) as for softmac_fused_gather; dv (3, n) the cotangent of its
// output. out: (wx + wy + wz, n) float32, the rows dWx, dWy, dWz one after
// the other, every row written. acc: 3 * wy*wz*wx doubles (zeroed by the
// first launch); gout: the three grid cotangents in float32, one (wy*wz,
// wx) grid after the other; scratch: 6 * wy*wz*wx floats (the grids' two
// other layouts). Three launches: the layouts and the zero fill, the
// kernel (none for n = 0), the round. Returns cudaGetLastError() after the
// launches.
extern "C" int softmac_fused_gather_bwd(const float* Wx, const float* Wy,
                                        const float* Wz, const float* gv0,
                                        const float* gv1, const float* gv2,
                                        const float* dv, float* out,
                                        double* acc, float* gout,
                                        float* scratch, int n, int wx, int wy,
                                        int wz, void* stream) {
  const int count = 3 * wx * wy * wz;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RowsArgs a = {{Wx, nullptr, Wy, nullptr, Wz, nullptr},
                      {gv0, gv1, gv2, nullptr},
                      {wx, wx, wx, 0},
                      dv, out, acc, scratch, scratch + count,
                      n, {wx, wy, wz}};
  softmac::rows_prep<3><<<softmac::blocks_for(count), softmac::kThreads, 0,
                          s>>>(a);
  if (n > 0) {
    fused_gather_bwd_kernel<<<dim3(softmac::rows_blocks(n),
                                   softmac::rows_parts(n)),
                              softmac::kRowThreads, 0, s>>>(a);
  }
  softmac::round_to_float<<<softmac::blocks_for(count), softmac::kThreads, 0,
                            s>>>(acc, gout, count);
  return static_cast<int>(cudaGetLastError());
}
