// Quadratic B-spline weights of one particle along one axis, shared by the
// P2G and G2P kernels. Same math as mpm.axis_weights and the Pallas weight
// construction in pallas_chunked._waxis of the JAX package:
//   p = x * inv_dx, base = floor(p - 0.5), fx = p - base,
//   w  = (0.5 (1.5 - fx)^2, 0.75 - (fx - 1)^2, 0.5 (fx - 0.5)^2),
//   wd[o] = w[o] * (o - fx)   (the dpos factor, unscaled).
// p and base use explicitly rounded operations so that nvcc cannot fuse
// them into one FMA: the base cell then is bit-for-bit the one the plain
// PyTorch version picks.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace softmac {

struct Axis {
  float w[3];
  float wd[3];
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
  a.base = static_cast<int>(b);
  return a;
}

constexpr int kThreads = 256;

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace softmac
