// Khatri-Rao (y, z) pair build of the dense transfer route: from the
// per-axis weight matrices Wy, WDy (wy, n) and Wz, WDz (wz, n) it writes
//   H  [(y wz + z), p] = Wy[y, p]  Wz[z, p]
//   HDy[(y wz + z), p] = WDy[y, p] Wz[z, p]
//   HDz[(y wz + z), p] = Wy[y, p]  WDz[z, p]
// each (wy*wz, n) row-major. P2G, G2P, gather and splat of that route are
// then plain matrix products over these three matrices (engine/mpm.py).
//
// Replaces: softmac_tpu/ops/pallas_kr.py _kr3_fwd_pallas :56 (pallas_call
// :73, kernel _kernel :40); the function of ops/kr.py kr3_plain. Forward
// only: the backward is four reductions in plain PyTorch
// (kr3_vjp_plain), as the JAX package leaves _kr3_bwd to XLA.
//
// What bounds it on the H100: bytes. It reads 2 (wy + wz) floats a
// particle and writes 3 wy wz: on the full 64^3 grid at 1e5 particles 4.92
// GB of stores, 1.47 ms at 3.35 TB/s; one multiply a stored float.
//
// Simple design: one thread per particle column p and y row. It loads
// Wy[y, p] and WDy[y, p] once and loops over z, storing the three products
// at (y wz + z) n + p, so a warp's stores are 128 contiguous bytes. The
// blocks of one particle tile over all y rows are numbered next to each
// other, so the Wz, WDz columns they all read stay in L2. Each product is
// one float32 multiply rounded once (__fmul_rn): bit for bit the float32
// plain version. Offsets are 64-bit: one output of the full grid holds
// 4096 n floats, past 2^31 beyond ~5.2e5 particles.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void kr3_kernel(const float* __restrict__ Wy,
                           const float* __restrict__ Wz,
                           const float* __restrict__ WDy,
                           const float* __restrict__ WDz,
                           float* __restrict__ H, float* __restrict__ HDy,
                           float* __restrict__ HDz, int n, int wy, int wz) {
  // block b covers particle tile b / wy and y row b % wy
  const int64_t b = blockIdx.x;
  const int y = static_cast<int>(b % wy);
  const int64_t p = (b / wy) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int64_t nn = n;
  const float wy_ = __ldg(Wy + y * nn + p);
  const float wdy = __ldg(WDy + y * nn + p);
  int64_t o = static_cast<int64_t>(y) * wz * nn + p;
  for (int z = 0; z < wz; ++z, o += nn) {
    const float wz_ = __ldg(Wz + z * nn + p);
    const float wdz = __ldg(WDz + z * nn + p);
    H[o] = __fmul_rn(wy_, wz_);
    HDy[o] = __fmul_rn(wdy, wz_);
    HDz[o] = __fmul_rn(wy_, wdz);
  }
}

}  // namespace

// Wy, WDy (wy, n), Wz, WDz (wz, n) float32 row-major; H, HDy, HDz
// (wy*wz, n) float32, written in full. Returns cudaGetLastError() after the
// launch.
extern "C" int softmac_kr3(const float* Wy, const float* Wz, const float* WDy,
                           const float* WDz, float* H, float* HDy, float* HDz,
                           int n, int wy, int wz, void* stream) {
  const int64_t tiles = (static_cast<int64_t>(n) + kThreads - 1) / kThreads;
  if (tiles > 0 && wy > 0 && wz > 0) {
    kr3_kernel<<<static_cast<unsigned>(tiles * wy), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(Wy, Wz, WDy, WDz, H,
                                                      HDy, HDz, n, wy, wz);
  }
  return static_cast<int>(cudaGetLastError());
}
