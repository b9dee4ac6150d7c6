// The function of the dense-weight transfers' backward kernels, and the
// one-thread-a-particle code of the splat backward (fused_splat_bwd.cu);
// the P2G, G2P and gather backwards compute the same function many
// threads a particle (fused_rows.cuh).
//
// For one particle, each of the four forwards, dotted with its output
// cotangent, is a sum over the window cells c = (x, y, z) (row y * wz + z,
// column x) of a form that is linear in each axis's weights:
//   f = sum_c  Wx[x]  Wy[y]  Wz[z]  s.h(c)  + WxD[x] Wy[y]  Wz[z]  s.d0(c)
//            + Wx[x]  WDy[y] Wz[z]  s.d1(c) + Wx[x]  Wy[y]  WDz[z] s.d2(c)
// where the cell coefficients s(c) pair the output cotangent at c with the
// particle's own channels (P2G, splat), or the grids at c with the
// particle's output cotangent (G2P, gather). The splat and the gather have
// no derivative weights (s.d0 = s.d1 = s.d2 = 0).
//
// The cotangent of a weight entry is the partial derivative of f. It is
// dense in the row: dWx[r] sums over the particle's box on y and z for
// every r < wx, whether Wx[r] is zero or not, and it is zero for every r
// when the box on y or on z is empty (a stencil that left the window
// there). The box on each axis is the union of the nonzero rows of W and
// WD (fused.cuh nonzero_rows), so it covers every weight a term reads.
// Every row of every output is written, zeros included: no memset.
#pragma once

#include "fused.cuh"

namespace softmac {

struct Box {
  int x0, x1, y0, y1, z0, z1;
  __device__ __forceinline__ bool empty() const {
    return x0 > x1 || y0 > y1 || z0 > z1;
  }
};

// The particle's box without derivative weights: its nonzero row range on
// each axis.
__device__ __forceinline__ Box particle_box(const float* Wx, const float* Wy,
                                            const float* Wz, int n, int p,
                                            int wx, int wy, int wz) {
  Box b;
  nonzero_rows(Wx, nullptr, wx, n, p, &b.x0, &b.x1);
  nonzero_rows(Wy, nullptr, wy, n, p, &b.y0, &b.y1);
  nonzero_rows(Wz, nullptr, wz, n, p, &b.z0, &b.z1);
  return b;
}

// Writes the weight cotangents of f without derivative weights, dWx (wx,
// n), dWy (wy, n), dWz (wz, n) at column p, from cell(row, x) -> s.h(c).
// Sums in double, rounded once.
template <class Cell>
__device__ __forceinline__ void weight_adjoint(
    const float* __restrict__ Wx, const float* __restrict__ Wy,
    const float* __restrict__ Wz, int n, int p, int wx, int wy, int wz,
    const Box& b, Cell cell, float* __restrict__ dWx,
    float* __restrict__ dWy, float* __restrict__ dWz) {
  // x rows: over the (y, z) box
  for (int x = 0; x < wx; ++x) {
    double g = 0.0;
    for (int y = b.y0; y <= b.y1; ++y) {
      const double wy_ = at(Wy, y, n, p);
      for (int z = b.z0; z <= b.z1; ++z) {
        g += wy_ * at(Wz, z, n, p) * cell(y * wz + z, x);
      }
    }
    dWx[static_cast<size_t>(x) * n + p] = static_cast<float>(g);
  }
  // y rows: over the (z, x) box
  for (int y = 0; y < wy; ++y) {
    double g = 0.0;
    for (int z = b.z0; z <= b.z1; ++z) {
      const double wz_ = at(Wz, z, n, p);
      for (int x = b.x0; x <= b.x1; ++x) {
        g += wz_ * at(Wx, x, n, p) * cell(y * wz + z, x);
      }
    }
    dWy[static_cast<size_t>(y) * n + p] = static_cast<float>(g);
  }
  // z rows: over the (y, x) box
  for (int z = 0; z < wz; ++z) {
    double g = 0.0;
    for (int y = b.y0; y <= b.y1; ++y) {
      const double wy_ = at(Wy, y, n, p);
      for (int x = b.x0; x <= b.x1; ++x) {
        g += wy_ * at(Wx, x, n, p) * cell(y * wz + z, x);
      }
    }
    dWz[static_cast<size_t>(z) * n + p] = static_cast<float>(g);
  }
}

}  // namespace softmac
