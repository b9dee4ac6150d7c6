// Backward of the penalty particle contact: cotangents of the positions,
// the velocities and the 14 body floats, from the impulse's cotangent.
//
// Replaces: softmac_tpu/ops/pallas_contact.py _make_particle_bwd_kernel
// (jax.vjp of _particle_math traced inside the kernel, launched from
// _particle_factory's _bwd, which then sums the per-particle body rows).
// The SDF table gets no cotangent, as the JAX _bwd returns zeros for it.
//
// CUDA has no vjp transform, so contact.cuh contact_backward is a reverse
// sweep written by hand over the same forward (contact_forward, recomputed
// here from the stencil row, as the TPU kernel recomputes it): quaternion
// normalisations and rotations, trilinear sdf and normal, the masked
// penetration, the collider velocity, the min() friction clamp and the
// final where(mask, ., 0). A particle out of contact gets zero cotangent.
// Inputs and outputs are float; the per-particle math runs in double
// (contact.cuh says why), a few hundred flops a particle that the card's
// float64 units take in well under the kernel's memory time.
//
// The 14 body floats are summed over particles in a fixed order: each
// block reduces its threads' rows in shared memory to one (14,) partial,
// written to (14, n_blocks); the wrapper sums those with torch.sum. No
// atomics, so the action gradient is reproducible run to run.
//
// What bounds it on the H100: bytes (x, v and the impulse cotangent in, dx
// and dv out, and the table rows the particles touch: ~15 floats a
// particle, ~6 MB a body at 1e5 particles, 1.8 us at 3.35 TB/s); the
// ~500 flops a particle in contact stay far from the compute limit.
//
// Simple design: one thread per particle, as the forward; the stencil row
// is read again rather than saved by the forward.
#include "contact.cuh"

namespace {

__global__ void collide_particle_bwd_kernel(const float* __restrict__ x,
                                            const float* __restrict__ v,
                                            const float4* __restrict__ table,
                                            const float* __restrict__ body,
                                            const float* __restrict__ gimp,
                                            float* __restrict__ dx,
                                            float* __restrict__ dv,
                                            float* __restrict__ dbody_part,
                                            int n, softmac::Geom g, float dt,
                                            float p_mass) {
  __shared__ float red[14][softmac::kThreads];
  const int t = threadIdx.x;
  const int p = blockIdx.x * blockDim.x + t;
  double gb[14];
  for (int i = 0; i < 14; ++i) gb[i] = 0.0;
  if (p < n) {
    using V3 = softmac::V3<double>;
    const softmac::Body<double> b = softmac::load_body<double>(body);
    const V3 xp = {x[p], x[n + p], x[2 * n + p]};
    const V3 vp = {v[p], v[n + p], v[2 * n + p]};
    const softmac::Contact<double> k = softmac::contact_forward(
        b, xp, vp, table, g, double(dt), double(p_mass));
    const V3 gi = {gimp[p], gimp[n + p], gimp[2 * n + p]};
    V3 gx, gv;
    softmac::contact_backward(b, k, gi, g, double(dt), double(p_mass), gx,
                              gv, gb);
    dx[p] = static_cast<float>(gx.x);
    dx[n + p] = static_cast<float>(gx.y);
    dx[2 * n + p] = static_cast<float>(gx.z);
    dv[p] = static_cast<float>(gv.x);
    dv[n + p] = static_cast<float>(gv.y);
    dv[2 * n + p] = static_cast<float>(gv.z);
  }
  // fixed-order tree reduction of the block's body rows
  for (int i = 0; i < 14; ++i) red[i][t] = static_cast<float>(gb[i]);
  __syncthreads();
  for (int stride = softmac::kThreads / 2; stride > 0; stride >>= 1) {
    if (t < stride) {
      for (int i = 0; i < 14; ++i) red[i][t] += red[i][t + stride];
    }
    __syncthreads();
  }
  if (t < 14) dbody_part[t * gridDim.x + blockIdx.x] = red[t][0];
}

}  // namespace

// x, v (3, n), table, body and the geometry as for
// softmac_collide_particle; gimp (3, n) the impulse cotangent. Writes dx,
// dv (3, n) and dbody_part (14, blocks) with blocks = ceil(n / 256), the
// per-block sums of the body cotangent. Returns cudaGetLastError() after
// the launch.
extern "C" int softmac_collide_particle_bwd(
    const float* x, const float* v, const float* table, const float* body,
    const float* gimp, float* dx, float* dv, float* dbody_part, int n,
    int res0, int res1, int res2, float lower0, float lower1, float lower2,
    float upper0, float upper1, float upper2, float inv_dx, float dt,
    float p_mass, void* stream) {
  if (n > 0) {
    softmac::Geom g = {{lower0, lower1, lower2}, {upper0, upper1, upper2},
                       inv_dx, {res0, res1, res2}};
    collide_particle_bwd_kernel<<<softmac::blocks_for(n), softmac::kThreads,
                                  0, static_cast<cudaStream_t>(stream)>>>(
        x, v, reinterpret_cast<const float4*>(table), body, gimp, dx, dv,
        dbody_part, n, g, dt, p_mass);
  }
  return static_cast<int>(cudaGetLastError());
}
