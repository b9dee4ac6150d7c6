// Backward of the dense-weight P2G: the cotangents of the six weight
// matrices and of the 13 channels from the cotangents of the mass and
// momentum windows.
//
// Replaces: softmac_tpu/ops/pallas_fused.py _p2g_bwd_pallas :740
// (pallas_call :758, kernel _p2g_bwd_kernel :330), the custom_vjp backward
// of pallas_fused.p2g; the function of jax.vjp of _p2g_ref :181 and of
// ops/fused.py p2g_vjp_plain, for any dense weights. With G_m = dgm[c] and
// G_d = dgmom[row, d wx + x] at cell c, the cell coefficients of
// fused_rows.cuh are
//   s.h = G_m mass + sum_d G_d mom_d,  s.dj = sum_d G_d a_dj  (a = dx*affine)
// and the channel cotangents sum over the particle's box:
//   dchan[0] = sum Wy Wz Wx G_m,  dchan[1 + d] = sum Wy Wz Wx G_d,
//   dchan[4 + 3d] = sum Wy Wz WxD G_d,  dchan[5 + 3d] = sum WDy Wz Wx G_d,
//   dchan[6 + 3d] = sum Wy WDz Wx G_d.
// The TPU kernel contracts VMEM H-slabs with bf16x3 split dots; here each
// particle reads its own cells' cotangents, in double, rounded once.
//
// What bounds it on the H100: by bytes it reads the six weight matrices and
// writes their cotangents (2 (wx + wy + wz) floats a particle each way), the
// 13 channels in and out, and the windows once: 7.7 MB at the door's 5400
// particles and window (32, 16, 32), 2.3 us at 3.35 TB/s. By operations,
// for B-spline weights, (wx + wy + wz) rows of 9 box cells a particle at
// ~35 flops each: about the same. In practice the cell reads, 4 floats a
// visited cell, from L1 and L2.
//
// Design (fused_rows.cuh): 32 particles a tile, one a lane, on a block
// of 8 warps (or a few blocks that share its tasks where the tiles are too
// few to fill the card); their boxes and pair products staged once; one
// thread a (particle, y or z weight row), one warp a particle's x rows,
// and four threads a particle for the channel sums (the mass, and the
// four sums of each momentum component over the box), each output
// written by one thread in a fixed order: no atomics, repeated runs are
// bit-identical. Two launches a call: the grids' y- and z-fastest
// layouts, then the kernel.
#include "fused_rows.cuh"

namespace {

using softmac::RowsArgs;
using softmac::RowsShared;

// The channel sums: four tasks a particle, task 0 the mass row, task 1 + d
// the four rows of momentum component d, each over the particle's box
// (fused_rows.cuh box_sums of grid `task`).
struct P2GBwd {
  static constexpr int kGrids = 4;
  static constexpr bool kDeriv = true, kRows = true;
  static constexpr int kScatter = 0;  // channel sums, no window

  __device__ static int extra_tasks(const RowsArgs&, bool) { return 4; }

  __device__ static void extra(const RowsArgs& a, RowsShared* sh,
                               bool narrow, int task, int lane, int p) {
    double s[4];
    softmac::box_sums<true>(a, *sh, narrow, task, lane, p, s);
    const size_t n = a.n;
    float* dchan = a.out + 2 * (a.size[0] + a.size[1] + a.size[2]) * n + p;
    if (task == 0) {
      dchan[0] = static_cast<float>(s[0]);
      return;
    }
    const int d = task - 1;
    dchan[(1 + d) * n] = static_cast<float>(s[0]);
    dchan[(4 + 3 * d) * n] = static_cast<float>(s[1]);
    dchan[(5 + 3 * d) * n] = static_cast<float>(s[2]);
    dchan[(6 + 3 * d) * n] = static_cast<float>(s[3]);
  }
};

#ifdef __CUDACC__
__global__ void __launch_bounds__(softmac::kRowThreads, softmac::kRowBlocks)
    fused_p2g_bwd_kernel(const RowsArgs a) {
  __shared__ RowsShared sh;
  softmac::rows_block<P2GBwd>(a, &sh);
}
#endif

}  // namespace

// Wx, WxD (wx, n), Wy, WDy (wy, n), Wz, WDz (wz, n) weight matrices, chan
// (13, n) as for softmac_fused_p2g; dgm (wy*wz, wx) and dgmom
// (wy*wz, 3*wx) the cotangents of its outputs. out: (2 (wx + wy + wz) + 13,
// n) float32, the rows dWx, dWxD, dWy, dWDy, dWz, dWDz, dchan one after
// the other, every row written; scratch: 8 * wy*wz*wx floats (the four
// grids' two other layouts). Two launches: the layouts, the kernel.
// Returns cudaGetLastError() after the launches.
extern "C" int softmac_fused_p2g_bwd(const float* Wx, const float* WxD,
                                     const float* Wy, const float* WDy,
                                     const float* Wz, const float* WDz,
                                     const float* chan, const float* dgm,
                                     const float* dgmom, float* out,
                                     float* scratch, int n, int wx, int wy,
                                     int wz, void* stream) {
  if (n > 0) {
    const int count = 4 * wx * wy * wz;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const RowsArgs a = {{Wx, WxD, Wy, WDy, Wz, WDz},
                        {dgm, dgmom, dgmom + wx, dgmom + 2 * wx},
                        {wx, 3 * wx, 3 * wx, 3 * wx},
                        chan, out, nullptr, scratch, scratch + count,
                        n, {wx, wy, wz}};
    softmac::rows_prep<4><<<softmac::blocks_for(count), softmac::kThreads, 0,
                            s>>>(a);
    fused_p2g_bwd_kernel<<<dim3(softmac::rows_blocks(n),
                                softmac::rows_parts(n)),
                           softmac::kRowThreads, 0,
                           s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
