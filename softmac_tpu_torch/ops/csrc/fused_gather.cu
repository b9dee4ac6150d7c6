// Dense-weight gather: the grid velocity interpolated at the particles
// through per-axis weight matrices (grid_op_mixed2's v_tmp).
//
// Replaces: softmac_tpu/ops/pallas_fused.py _gather_pallas :714
// (pallas_call :725, kernel _gather_kernel :520); the function of
// _gather_ref :241 and of ops/fused.py gather_plain, for any dense weights:
//   out[d] = sum over the window of Wy Wz Wx g_d
//
// What bounds it on the H100: bytes. It reads the three weight matrices
// (wx + wy + wz floats a particle) and the three grids (196 KB at (32, 16,
// 32), L2-resident), and writes 3 floats a particle: 1.99 MB at the door's
// 5400 particles, 0.59 us at 3.35 TB/s (33 MB, 10 us at 1e5). At 5400 the
// latency of finding each particle's box: one thread a particle scanned
// its 80 weight entries alone, a long dependent chain on a card a sixth
// occupied.
//
// Design (fused_rows.cuh, without derivative weights or weight rows): G2P's
// with one sum a task. 32 particles a tile, one a lane, on a block of 8
// warps; the warps split the window's rows to find the boxes (coalesced)
// and keep their entries; the pair products Wy Wz over each (y, z) box
// staged once in double; then one thread a (particle, component d), which
// sums Wx Wy Wz g_d over the box (box_sums of grid d): 3 tasks a particle,
// so each tile on one block (a second would repeat the box scan for warps
// with no task). Each output is one thread's, rounded once, written once:
// no atomics, repeated runs are bit-identical. One launch a call, no
// scratch.
#include "fused_rows.cuh"

namespace {

using softmac::RowsArgs;
using softmac::RowsShared;

// The gather's work is the extra tasks alone: task d, component d of the
// particle's velocity over its box.
struct Gather : softmac::RowsKind {
  static constexpr int kGrids = 3;
  static constexpr bool kDeriv = false, kRows = false;
  static constexpr int kScatter = 0;  // sums, no window

  __device__ static int extra_tasks(const RowsArgs&, bool) { return 3; }

  __device__ static void extra(const RowsArgs& a, RowsShared* sh,
                               bool narrow, int d, int lane, int p) {
    double s[4];
    softmac::box_sums<false, true>(a, *sh, narrow, d, lane, p, s);
    a.out[static_cast<size_t>(d) * a.n + p] = static_cast<float>(s[0]);
  }
};

#ifdef __CUDACC__
__global__ void __launch_bounds__(softmac::kRowThreads, softmac::kRowBlocks)
    fused_gather_kernel(const RowsArgs a) {
  __shared__ RowsShared sh;
  softmac::rows_block<Gather>(a, &sh);
}
#endif

}  // namespace

// Wx (wx, n), Wy (wy, n), Wz (wz, n) weight matrices, gv0..gv2 (wy*wz, wx)
// grids, out (3, n). One launch (none for n = 0). Returns
// cudaGetLastError() after the launch.
extern "C" int softmac_fused_gather(const float* Wx, const float* Wy,
                                    const float* Wz, const float* gv0,
                                    const float* gv1, const float* gv2,
                                    float* out, int n, int wx, int wy, int wz,
                                    void* stream) {
  if (n > 0) {
    const RowsArgs a = {{Wx, nullptr, Wy, nullptr, Wz, nullptr},
                        {gv0, gv1, gv2, nullptr},
                        {wx, wx, wx, 0},
                        nullptr, out, nullptr, nullptr, nullptr,
                        n, {wx, wy, wz}};
    fused_gather_kernel<<<softmac::rows_blocks(n), softmac::kRowThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
