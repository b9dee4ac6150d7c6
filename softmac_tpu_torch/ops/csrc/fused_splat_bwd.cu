// Backward of the dense-weight splat: the cotangents of the three weight
// matrices and of the splatted values from the cotangent of the window.
//
// Replaces: softmac_tpu/ops/pallas_fused.py _splat_bwd_pallas :811
// (pallas_call :828, kernel _splat_bwd_kernel :534), the custom_vjp
// backward of pallas_fused.splat; the function of jax.vjp of _splat_ref
// :232 and of ops/fused.py splat_vjp_plain, for any dense weights. With
// G_d = dout[row, d wx + x] at cell c, the cell coefficient of
// fused_rows.cuh (no derivative weights) is s.h = sum_d vals_d G_d, and
//   dvals_d = sum over the box of Wy Wz Wx G_d.
//
// What bounds it on the H100: by bytes it reads the three weight matrices
// and writes their cotangents ((wx + wy + wz) floats a particle each way),
// the values in and out, and the window once: 3.8 MB at the door's 5400
// particles and window (32, 16, 32), 1.1 us at 3.35 TB/s. In practice the
// cell reads of the weight rows, 3 floats a box cell of a row.
//
// Design (fused_rows.cuh, without derivative weights): the gather
// backward's rows with the values in place of dv. 32 particles a tile,
// one a lane, on a block of 8 warps (or a few blocks that share its tasks
// where the tiles are too few to fill the card); their boxes (W alone)
// and pair products Wy Wz staged once; one thread a (particle, y or z
// weight row), one warp a particle's x rows, each row dW_A = sum_d vals_d
// B_d with B_d the row's sum of the pair products times component d of
// the cotangent; and three threads a particle for the value sums, each
// over the particle's box (box_sums). Each output is written by one
// thread in a fixed order: no atomics, repeated runs are bit-identical.
// Two launches a call: the cotangent's y- and z-fastest layouts, then the
// kernel.
#include "fused_rows.cuh"

namespace {

using softmac::RowsArgs;
using softmac::RowsShared;

// The value sums: three tasks a particle, task d the sum over the
// particle's box of Wx Wy Wz times component d of the cotangent.
struct SplatBwd : softmac::RowsKind {
  static constexpr int kGrids = 3;
  static constexpr bool kDeriv = false, kRows = true;
  static constexpr int kScatter = 0;  // value sums, no window

  __device__ static int extra_tasks(const RowsArgs&, bool) { return 3; }

  __device__ static void extra(const RowsArgs& a, RowsShared* sh,
                               bool narrow, int task, int lane, int p) {
    double s[4];
    softmac::box_sums<false>(a, *sh, narrow, task, lane, p, s);
    const size_t row = a.size[0] + a.size[1] + a.size[2] + task;
    a.out[row * a.n + p] = static_cast<float>(s[0]);
  }
};

#ifdef __CUDACC__
__global__ void __launch_bounds__(softmac::kRowThreads, softmac::kRowBlocks)
    fused_splat_bwd_kernel(const RowsArgs a) {
  __shared__ RowsShared sh;
  softmac::rows_block<SplatBwd>(a, &sh);
}
#endif

}  // namespace

// Wx (wx, n), Wy (wy, n), Wz (wz, n) weight matrices and vals (3, n) as for
// softmac_fused_splat; dout (wy*wz, 3*wx) the cotangent of its window.
// out: (wx + wy + wz + 3, n) float32, the rows dWx, dWy, dWz, dvals one
// after the other, every row written; scratch: 6 * wy*wz*wx floats (the
// cotangent's two other layouts). Two launches: the layouts, the kernel
// (none for n = 0). Returns cudaGetLastError() after the launches.
extern "C" int softmac_fused_splat_bwd(const float* Wx, const float* Wy,
                                       const float* Wz, const float* vals,
                                       const float* dout, float* out,
                                       float* scratch, int n, int wx, int wy,
                                       int wz, void* stream) {
  if (n > 0) {
    const int count = 3 * wx * wy * wz;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const RowsArgs a = {{Wx, nullptr, Wy, nullptr, Wz, nullptr},
                        {dout, dout + wx, dout + 2 * wx, nullptr},
                        {3 * wx, 3 * wx, 3 * wx, 0},
                        vals, out, nullptr, scratch, scratch + count,
                        n, {wx, wy, wz}};
    softmac::rows_prep<3><<<softmac::blocks_for(count), softmac::kThreads, 0,
                            s>>>(a);
    fused_splat_bwd_kernel<<<dim3(softmac::rows_blocks(n),
                                  softmac::rows_parts(n)),
                             softmac::kRowThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
