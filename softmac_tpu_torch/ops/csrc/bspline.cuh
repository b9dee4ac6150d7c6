// Quadratic B-spline stencil code shared by the P2G and G2P kernels and
// their backward kernels. Same math as mpm.axis_weights and the Pallas
// weight construction in pallas_chunked._waxis of the JAX package:
//   p = x * inv_dx, base = floor(p - 0.5), fx = p - base,
//   w  = (0.5 (1.5 - fx)^2, 0.75 - (fx - 1)^2, 0.5 (fx - 0.5)^2),
//   wd[o] = w[o] * (o - fx)   (the dpos factor, unscaled).
// p and base use explicitly rounded operations so that nvcc cannot fuse
// them into one FMA: the base cell then is bit-for-bit the one the plain
// PyTorch version picks, in the forward and the backward kernels alike.
//
// The backward kernels differentiate through the weights (base is
// discrete, so d fx / dx = inv_dx):
//   w0' = -(1.5 - fx), w1' = -2 (fx - 1), w2' = fx - 0.5,
//   wd_o' = w_o' (o - fx) - w_o.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace softmac {

struct Axis {
  float w[3];
  float wd[3];
  float fx;
  int base;
};

__device__ __forceinline__ Axis axis_weights(float x, float inv_dx) {
  Axis a;
  const float p = __fmul_rn(x, inv_dx);
  const float b = floorf(__fsub_rn(p, 0.5f));
  const float fx = __fsub_rn(p, b);
  const float t0 = 1.5f - fx;
  const float t1 = fx - 1.0f;
  const float t2 = fx - 0.5f;
  a.w[0] = 0.5f * (t0 * t0);
  a.w[1] = 0.75f - t1 * t1;
  a.w[2] = 0.5f * (t2 * t2);
  a.wd[0] = a.w[0] * (0.0f - fx);
  a.wd[1] = a.w[1] * (1.0f - fx);
  a.wd[2] = a.w[2] * (2.0f - fx);
  a.fx = fx;
  a.base = static_cast<int>(b);
  return a;
}

// d w[o] / d fx and d wd[o] / d fx of one axis
struct AxisGrad {
  float dw[3];
  float dwd[3];
};

__device__ __forceinline__ AxisGrad axis_weight_grads(const Axis& a) {
  AxisGrad g;
  const float fx = a.fx;
  g.dw[0] = fx - 1.5f;
  g.dw[1] = -2.0f * (fx - 1.0f);
  g.dw[2] = fx - 0.5f;
  for (int o = 0; o < 3; ++o) {
    g.dwd[o] = g.dw[o] * (static_cast<float>(o) - fx) - a.w[o];
  }
  return g;
}

// The base cell, weights and window-relative base of one particle.
__device__ __forceinline__ void particle_stencil(const float* __restrict__ x,
                                                 int n, int p,
                                                 const int* __restrict__ corner,
                                                 float inv_dx, Axis ax[3],
                                                 int rel[3]) {
  for (int d = 0; d < 3; ++d) {
    ax[d] = axis_weights(x[d * n + p], inv_dx);
    rel[d] = ax[d].base - corner[d];
  }
}

// Momentum-type splat of one particle into float64 window accumulators:
// for every stencil cell inside the window
//   gm[row * wx + cx]                          += W * mass   (gm != nullptr)
//   gmom[row * row_stride + d * comp_stride + cx] += W mom_d + WxD a_d0
//                                                  + WDy a_d1 + WDz a_d2
// with row = cy * wz + cz. P2G splats (mass, momentum, dx * affine) into
// the (wy*wz, 3*wx) momentum layout; G2P's backward splats the velocity
// and C cotangents into three (wy*wz, wx) grids.
__device__ __forceinline__ void splat_stencil(const Axis ax[3], const int rel[3],
                                              int wx, int wy, int wz,
                                              double* gm, float mass,
                                              double* gmom, int row_stride,
                                              int comp_stride,
                                              const float mom[3],
                                              const float a[3][3]) {
  for (int j = 0; j < 3; ++j) {
    const int cy = rel[1] + j;
    if (cy < 0 || cy >= wy) continue;
    for (int k = 0; k < 3; ++k) {
      const int cz = rel[2] + k;
      if (cz < 0 || cz >= wz) continue;
      const int row = cy * wz + cz;
      const float wyz = ax[1].w[j] * ax[2].w[k];
      const float dyz = ax[1].wd[j] * ax[2].w[k];
      const float ydz = ax[1].w[j] * ax[2].wd[k];
      for (int i = 0; i < 3; ++i) {
        const int cx = rel[0] + i;
        if (cx < 0 || cx >= wx) continue;
        const float wgt = ax[0].w[i] * wyz;
        const float dwx = ax[0].wd[i] * wyz;
        const float dwy = ax[0].w[i] * dyz;
        const float dwz = ax[0].w[i] * ydz;
        if (gm != nullptr) {
          atomicAdd(gm + row * wx + cx, static_cast<double>(wgt * mass));
        }
        double* g = gmom + row * row_stride + cx;
        for (int d = 0; d < 3; ++d) {
          atomicAdd(g + d * comp_stride, static_cast<double>(
              wgt * mom[d] + dwx * a[d][0] + dwy * a[d][1] + dwz * a[d][2]));
        }
      }
    }
  }
}

// Reverse sweep over one particle's stencil. For every cell inside the
// window, cell(row, cx, W, WxD, WDy, WDz, s) sees the cell's four weights
// and sets s[0..3] to the cotangents of W, WxD, WDy and WDz at that cell
// (accumulating whatever else it needs on the way). Returns in dx the
// position cotangent those weight cotangents give through the weights:
//   dx_a = inv_dx * sum_cells s . d(W, WxD, WDy, WDz) / d fx_a.
template <class Cell>
__device__ __forceinline__ void stencil_adjoint(const Axis ax[3],
                                                const int rel[3], int wx,
                                                int wy, int wz, float inv_dx,
                                                Cell cell, float dx[3]) {
  const AxisGrad g0 = axis_weight_grads(ax[0]);
  const AxisGrad g1 = axis_weight_grads(ax[1]);
  const AxisGrad g2 = axis_weight_grads(ax[2]);
  float gfx = 0.f, gfy = 0.f, gfz = 0.f;
  for (int j = 0; j < 3; ++j) {
    const int cy = rel[1] + j;
    if (cy < 0 || cy >= wy) continue;
    for (int k = 0; k < 3; ++k) {
      const int cz = rel[2] + k;
      if (cz < 0 || cz >= wz) continue;
      const int row = cy * wz + cz;
      const float wyz = ax[1].w[j] * ax[2].w[k];
      const float dyz = ax[1].wd[j] * ax[2].w[k];
      const float ydz = ax[1].w[j] * ax[2].wd[k];
      // y and z derivatives of (wyz, dyz, ydz)
      const float wyz_y = g1.dw[j] * ax[2].w[k];
      const float dyz_y = g1.dwd[j] * ax[2].w[k];
      const float ydz_y = g1.dw[j] * ax[2].wd[k];
      const float wyz_z = ax[1].w[j] * g2.dw[k];
      const float dyz_z = ax[1].wd[j] * g2.dw[k];
      const float ydz_z = ax[1].w[j] * g2.dwd[k];
      for (int i = 0; i < 3; ++i) {
        const int cx = rel[0] + i;
        if (cx < 0 || cx >= wx) continue;
        const float w0 = ax[0].w[i], wd0 = ax[0].wd[i];
        float s[4];
        cell(row, cx, w0 * wyz, wd0 * wyz, w0 * dyz, w0 * ydz, s);
        gfx += g0.dw[i] * (s[0] * wyz + s[2] * dyz + s[3] * ydz)
               + g0.dwd[i] * (s[1] * wyz);
        gfy += w0 * (s[0] * wyz_y + s[2] * dyz_y + s[3] * ydz_y)
               + wd0 * (s[1] * wyz_y);
        gfz += w0 * (s[0] * wyz_z + s[2] * dyz_z + s[3] * ydz_z)
               + wd0 * (s[1] * wyz_z);
      }
    }
  }
  dx[0] = gfx * inv_dx;
  dx[1] = gfy * inv_dx;
  dx[2] = gfz * inv_dx;
}

constexpr int kThreads = 256;

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

#ifdef __CUDACC__
// rounds a float64 accumulator window to float32, once (one copy in each
// translation unit that includes this header)
static __global__ void round_to_float(const double* __restrict__ src,
                                      float* __restrict__ dst, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) dst[i] = static_cast<float>(src[i]);
}
#endif

}  // namespace softmac
