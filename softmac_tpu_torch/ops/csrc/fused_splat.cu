// Dense-weight splat: three plain per-particle channels through per-axis
// weight matrices onto the active grid window (the forecast mixed
// contact's -2 dv correction, grid_op_mixed4).
//
// Replaces: softmac_tpu/ops/pallas_fused.py _splat_pallas :689
// (pallas_call :700, kernel _splat_kernel :505); the function of
// _splat_ref :232 and of ops/fused.py splat_plain, for any dense weights:
//   out[(y,z), d wx + x] += Wy Wz Wx vals_d
//
// What bounds it on the H100: bytes. It reads the 3 values of every
// particle and the three weight matrices (wx + wy + wz floats a particle)
// of the particles whose values are not all zero (the band: in the door,
// only the particles in the contact band have a nonzero -2 dv), and writes
// the window once: (3 n + band (wx + wy + wz)) 4 + 3 wx wy wz 4 bytes,
// 0.26 MB with no band at the door's 5400 particles and window (32, 16,
// 32), 0.08 us at 3.35 TB/s.
//
// Design (fused_rows.cuh, without derivative weights or weight rows): P2G's
// scatter with three channels, band only. 32 particles a tile, one a lane,
// on a block of 8 warps; the block's vote ends it after reading its
// particles' values if none is nonzero (Splat::live); else the warps
// split the window's rows to find the boxes of the live particles
// (coalesced; a zero-valued particle's weights are never read), the pair
// products Wy Wz over each (y, z) box are staged once in double, and one
// thread a (particle, (y, z) cell of its box) adds the three values along
// the cell's x rows (rows_scatter) with atomicAdd(double) into the float64
// window in device memory. No tile window in shared memory (Splat::kWindow):
// a tile of the contact band holds one to three live particles, whose
// cells rarely meet. Each tile on one block: 9 tasks a particle on 8
// warps, where a second block would repeat the box scan for one task. The
// float64 window is kept by the caller between calls: the last launch
// rounds it to float32 once and leaves it zeroed (round_and_clear), so a
// call needs no fill. Float64 sums, rounded once, agree from run to run
// where float32 atomics would add in another order each time. Two
// launches a call.
#include "fused_rows.cuh"

namespace {

using softmac::RowsArgs;
using softmac::RowsShared;

// The splat's work is the extra tasks alone: one a (y, z) cell of the
// particle's box, for the particles with a nonzero value.
struct Splat : softmac::RowsKind {
  static constexpr int kGrids = 0;     // no weight rows, no grids to read
  static constexpr bool kDeriv = false, kRows = false;
  static constexpr int kScatter = 3;  // channels of the window
  static constexpr bool kLines = true;  // the window as out (wy*wz, 3*wx)
  // device atomics alone: the tile window's shared double atomics and
  // flush cost more than they save for a band tile's few particles (5.1 of
  // 11.3 us at the door's band state)
  static constexpr bool kWindow = false;

  __device__ static bool live(const RowsArgs& a, int p) {
    const size_t n = a.n;
    const float v0 = __ldg(a.rows + p), v1 = __ldg(a.rows + n + p),
                v2 = __ldg(a.rows + 2 * n + p);
    return v0 != 0.0f || v1 != 0.0f || v2 != 0.0f;
  }

  __device__ static int extra_tasks(const RowsArgs& a, bool narrow) {
    return softmac::scatter_tasks(a, narrow);
  }

  __device__ static void extra(const RowsArgs& a, RowsShared* sh,
                               bool narrow, int task, int lane, int p) {
    softmac::rows_scatter<Splat>(a, sh, narrow, task, lane, p);
  }
};

#ifdef __CUDACC__
__global__ void __launch_bounds__(softmac::kRowThreads, softmac::kRowBlocks)
    fused_splat_kernel(const RowsArgs a) {
  __shared__ RowsShared sh;
  softmac::rows_block<Splat>(a, &sh);
}
#endif

}  // namespace

// Wx (wx, n), Wy (wy, n), Wz (wz, n) weight matrices, vals (3, n). acc:
// at least 3 * wy*wz*wx doubles laid out as out, zero on entry and left
// zero (the caller keeps it between calls; a new one is zeroed once); out
// (wy*wz, 3*wx) float32, component d in columns d*wx .. (d+1)*wx. Two
// launches: the kernel (none for n = 0), the round. Returns
// cudaGetLastError() after the launches.
extern "C" int softmac_fused_splat(const float* Wx, const float* Wy,
                                   const float* Wz, const float* vals,
                                   double* acc, float* out, int n, int wx,
                                   int wy, int wz, void* stream) {
  const int count = 3 * wx * wy * wz;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    const RowsArgs a = {{Wx, nullptr, Wy, nullptr, Wz, nullptr},
                        {nullptr, nullptr, nullptr, nullptr},
                        {0, 0, 0, 0},
                        vals, nullptr, acc, nullptr, nullptr,
                        n, {wx, wy, wz}};
    fused_splat_kernel<<<softmac::rows_blocks(n), softmac::kRowThreads, 0,
                         s>>>(a);
  }
  softmac::round_and_clear<<<softmac::blocks_for(count), softmac::kThreads, 0,
                             s>>>(acc, out, count);
  return static_cast<int>(cudaGetLastError());
}
