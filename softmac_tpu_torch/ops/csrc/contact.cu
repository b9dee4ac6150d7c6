// Penalty particle contact against one SDF primitive.
//
// Replaces: softmac_tpu/ops/pallas_contact.py _make_particle_kernel (the
// kernel of _particle_factory, launched through _run_kernel) together with
// the XLA row gather in front of it (pallas_contact.py:712-723). The math,
// shared with the backward kernel, is contact.cuh contact_forward, here in
// float.
// The wrench sum over particles stays a PyTorch reduction in the caller,
// as it is plain XLA in the JAX package.
//
// What bounds it on the H100: bytes and latency of the table gather. A
// particle reads 6 floats (x, v), one 128-byte stencil row at a
// data-dependent address, and writes 3 floats + 1 byte. At 1e5 particles
// that is at most 15.6 MB (12.8 MB of rows, fewer distinct rows because
// neighbouring particles share cells), about 5 us at 3.35 TB/s; the ~150
// flops a particle are far from the compute limit.
//
// Simple design: one thread per particle. The row is read with eight
// 16-byte vector loads through the read-only path; the y-sorted particle
// order lets neighbouring threads share rows in L1/L2. Body state arrives
// as 14 floats in device memory so that the rollout never waits on the host.
#include "contact.cuh"

namespace {

__global__ void collide_particle_kernel(const float* __restrict__ x,
                                        const float* __restrict__ v,
                                        const float4* __restrict__ table,
                                        const float* __restrict__ body,
                                        float* __restrict__ imp,
                                        uint8_t* __restrict__ mask_out,
                                        int n, softmac::Geom g, float dt,
                                        float p_mass) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const softmac::Body<float> b = softmac::load_body<float>(body);
  const softmac::V3<float> xp = {x[p], x[n + p], x[2 * n + p]};
  const softmac::V3<float> vp = {v[p], v[n + p], v[2 * n + p]};
  const softmac::Contact<float> k =
      softmac::contact_forward(b, xp, vp, table, g, dt, p_mass);
  imp[p] = k.imp.x;
  imp[n + p] = k.imp.y;
  imp[2 * n + p] = k.imp.z;
  mask_out[p] = k.mask ? 1 : 0;
}

}  // namespace

// x, v (3, n); table (cells, 32) f32, 16-byte aligned; body (14,) f32 on
// the device; imp (3, n) and mask (n,) bool outputs. lower/upper/inv_dx/res
// describe the table. Returns cudaGetLastError() after the launch.
extern "C" int softmac_collide_particle(
    const float* x, const float* v, const float* table, const float* body,
    float* imp, uint8_t* mask, int n, int res0, int res1, int res2,
    float lower0, float lower1, float lower2, float upper0, float upper1,
    float upper2, float inv_dx, float dt, float p_mass, void* stream) {
  if (n > 0) {
    softmac::Geom g = {{lower0, lower1, lower2}, {upper0, upper1, upper2},
                       inv_dx, {res0, res1, res2}};
    collide_particle_kernel<<<softmac::blocks_for(n), softmac::kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        x, v, reinterpret_cast<const float4*>(table), body, imp, mask, n, g,
        dt, p_mass);
  }
  return static_cast<int>(cudaGetLastError());
}
