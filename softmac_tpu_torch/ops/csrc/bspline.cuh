// Quadratic B-spline stencil code shared by the x-based transfer kernels
// (P2G, G2P, gather, splat, their backwards and the y-slab scatter of
// slab.cuh). Same math as mpm.axis_weights and the Pallas
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

// The weights of one axis at fx (base left 0)
__device__ __forceinline__ Axis axis_at(float fx) {
  Axis a;
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
  a.base = 0;
  return a;
}

__device__ __forceinline__ Axis axis_weights(float x, float inv_dx) {
  const float p = __fmul_rn(x, inv_dx);
  const float b = floorf(__fsub_rn(p, 0.5f));
  Axis a = axis_at(__fsub_rn(p, b));
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

// Reverse sweep over one particle's stencil. For every window cell (cy,
// cz, cx) inside the window, in the order j (y), k (z), i (x),
// cell(cy, cz, cx, W, WxD, WDy, WDz, s) sees the cell's four weights
// and sets s[0..3] to the cotangents of W, WxD, WDy and WDz at that cell
// (accumulating whatever else it needs on the way). Returns in dx the
// position cotangent those weight cotangents give through the weights:
//   dx_a = inv_dx * sum_cells s . d(W, WxD, WDy, WDz) / d fx_a.
// With kRemake each axis's weights are made again from its fx where they
// are used (axis_at: the operations of axis_weights, so the same bits): y
// for each j, z and x for each (j, k). The compiler then keeps fewer of
// them live (the P2G backward's sweep fits the 80 registers of three
// blocks an SM without a spill) but does more work (the y-slab G2P
// backward's dx gather ~10 % slower on its real inputs;
// scripts/read_ab.py --variants, scripts/slab_checks.py).
template <bool kRemake = false, class Cell>
__device__ __forceinline__ void stencil_adjoint(const Axis ax[3],
                                                const int rel[3], int wx,
                                                int wy, int wz, float inv_dx,
                                                Cell cell, float dx[3]) {
  auto axis = [&](int d) { return kRemake ? axis_at(ax[d].fx) : ax[d]; };
  float gfx = 0.f, gfy = 0.f, gfz = 0.f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int cy = rel[1] + j;
    if (cy < 0 || cy >= wy) continue;
    const Axis ay = axis(1);
    const AxisGrad g1 = axis_weight_grads(ay);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int cz = rel[2] + k;
      if (cz < 0 || cz >= wz) continue;
      const Axis az = axis(2);
      const AxisGrad g2 = axis_weight_grads(az);
      const float wyz = ay.w[j] * az.w[k];
      const float dyz = ay.wd[j] * az.w[k];
      const float ydz = ay.w[j] * az.wd[k];
      // y and z derivatives of (wyz, dyz, ydz)
      const float wyz_y = g1.dw[j] * az.w[k];
      const float dyz_y = g1.dwd[j] * az.w[k];
      const float ydz_y = g1.dw[j] * az.wd[k];
      const float wyz_z = ay.w[j] * g2.dw[k];
      const float dyz_z = ay.wd[j] * g2.dw[k];
      const float ydz_z = ay.w[j] * g2.dwd[k];
      const Axis ax0 = axis(0);
      const AxisGrad g0 = axis_weight_grads(ax0);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int cx = rel[0] + i;
        if (cx < 0 || cx >= wx) continue;
        const float w0 = ax0.w[i], wd0 = ax0.wd[i];
        float s[4];
        cell(cy, cz, cx, w0 * wyz, wd0 * wyz, w0 * dyz, w0 * ydz, s);
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

// element i of round_and_clear: the float64 sum rounded to float32 once,
// and its place zeroed for the next call that adds into it
__device__ __forceinline__ void round_clear_at(double* __restrict__ src,
                                               float* __restrict__ dst,
                                               int i) {
  dst[i] = static_cast<float>(src[i]);
  src[i] = 0.0;
}

#ifdef __CUDACC__
// rounds a float64 accumulator window to float32, once (one copy in each
// translation unit that includes this header)
static __global__ void round_to_float(const double* __restrict__ src,
                                      float* __restrict__ dst, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) dst[i] = static_cast<float>(src[i]);
}

// round_to_float for a window kept between calls: it leaves the window
// zeroed, so the next call needs no fill launch
static __global__ void round_and_clear(double* __restrict__ src,
                                       float* __restrict__ dst, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) round_clear_at(src, dst, i);
}
#endif

}  // namespace softmac
