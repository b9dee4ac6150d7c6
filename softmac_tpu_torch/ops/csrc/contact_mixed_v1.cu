// Forecast mixed contact, merged forward and backward: the first design,
// kept so that chip_smoke.py can time it against the tiled kernels of
// contact_mixed.cu / contact_mixed_bwd.cu on the same states (the main path
// does not call it). It goes with the PR that next redesigns this pair.
//
// Replaces: softmac_tpu/ops/pallas_contact.py _make_mixed12_kernel and
// _make_mixed12_bwd_kernel (_fused12_factory), as the tiled kernels do.
//
// One thread per particle, 256 a block, the whole double-precision contact
// for every particle (contact.cuh mixed_stage1 / mixed_stage2 and their
// reverse sweeps). The forward writes p_v_out, the unmasked reaction force
// (v - p_v_out) p_mass / dt and the mask dist(x) <= 5e-3 (1 byte); the
// wrench is left to the caller's PyTorch reduction. The backward takes the
// cotangents of p_v_out and of that force and writes dx, dv and the
// (16, blocks) float64 block sums of the body cotangents (reduce_body),
// which the caller sums. The body is the 16 packed floats [bp, bq wxyz,
// bv, bw, friction, softness, life].
//
// What bounds it on the H100: the double math of every particle (152
// registers forward, 246 backward: one block of eight warps an SM), not
// the bytes (15.6 MB forward, 7.7 MB backward a body at 1e5 particles).
#include "contact_mixed.cuh"

namespace {

using softmac::V3;

__global__ void collide_mixed_kernel(
    const float* __restrict__ x, const float* __restrict__ v,
    const float4* __restrict__ table, const float* __restrict__ body,
    float* __restrict__ pv_out, float* __restrict__ force,
    uint8_t* __restrict__ mask_out, int n, softmac::Geom g, float dt,
    float p_mass, float push_cap) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const V3<double> xp = softmac::load3(x, n, p), vp = softmac::load3(v, n, p);
  const softmac::MixedParticle q =
      softmac::load_mixed_particle(body, xp, table, g);
  const softmac::Mixed1<double> m =
      softmac::mixed_stage1(q.b, q.softness, xp, vp, q.cell, q.e, double(dt));
  V3<double> out, f;
  bool mask;
  softmac::mixed_stage2(q.b, q.life, vp, m, q.cell, q.e, g, double(dt),
                        double(p_mass), double(push_cap), out, f, mask);
  softmac::store3(pv_out, n, p, out);
  softmac::store3(force, n, p, f);
  mask_out[p] = mask ? 1 : 0;
}

// One particle's merged reverse: dx, dv and its 16 body cotangents.
__device__ __forceinline__ void mixed_bwd_particle(
    const float* __restrict__ x, const float* __restrict__ v,
    const float4* __restrict__ table, const float* __restrict__ body,
    const float* __restrict__ gout, const float* __restrict__ gforce, int n,
    int p, const softmac::Geom& g, float dt, float p_mass, float push_cap,
    V3<double>& gx, V3<double>& gv, double gb[16]) {
  const V3<double> xp = softmac::load3(x, n, p), vp = softmac::load3(v, n, p);
  const softmac::MixedParticle q =
      softmac::load_mixed_particle(body, xp, table, g);
  const softmac::Mixed1<double> m =
      softmac::mixed_stage1(q.b, q.softness, xp, vp, q.cell, q.e, double(dt));
  softmac::BodyGrad<double> gbody = softmac::zero_body_grad<double>();
  softmac::mixed_reverse(q, xp, vp, m, softmac::load3(gout, n, p),
                         softmac::load3(gforce, n, p), g, double(dt),
                         double(p_mass), double(push_cap), gx, gv, gbody);
  softmac::finish_body_grad(q.b, gbody, gb);
}

__global__ void collide_mixed_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ v,
    const float4* __restrict__ table, const float* __restrict__ body,
    const float* __restrict__ gout, const float* __restrict__ gforce,
    float* __restrict__ dx, float* __restrict__ dv,
    double* __restrict__ dbody_part, int n, softmac::Geom g, float dt,
    float p_mass, float push_cap) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  double gb[16];
  for (int i = 0; i < 16; ++i) gb[i] = 0.0;
  if (p < n) {
    V3<double> gx, gv;
    mixed_bwd_particle(x, v, table, body, gout, gforce, n, p, g, dt, p_mass,
                       push_cap, gx, gv, gb);
    softmac::store3(dx, n, p, gx);
    softmac::store3(dv, n, p, gv);
  }
  softmac::reduce_body(gb, dbody_part);
}

softmac::Geom geom(int res0, int res1, int res2, float lower0, float lower1,
                   float lower2, float upper0, float upper1, float upper2,
                   float inv_dx) {
  return {{lower0, lower1, lower2}, {upper0, upper1, upper2}, inv_dx,
          {res0, res1, res2}};
}

}  // namespace

// x, v (3, n); table (cells, 32) f32, 16-byte aligned; body (16,) f32 on
// the device; outputs p_v_out and force (3, n), mask (n,) bool.
// lower/upper/inv_dx/res describe the table; push_cap inf = uncapped.
// Returns cudaGetLastError() after the launch.
extern "C" int softmac_collide_mixed_v1(
    const float* x, const float* v, const float* table, const float* body,
    float* pv_out, float* force, uint8_t* mask, int n, int res0, int res1,
    int res2, float lower0, float lower1, float lower2, float upper0,
    float upper1, float upper2, float inv_dx, float dt, float p_mass,
    float push_cap, void* stream) {
  if (n > 0) {
    collide_mixed_kernel<<<softmac::blocks_for(n), softmac::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        x, v, reinterpret_cast<const float4*>(table), body, pv_out, force,
        mask, n,
        geom(res0, res1, res2, lower0, lower1, lower2, upper0, upper1, upper2,
             inv_dx),
        dt, p_mass, push_cap);
  }
  return static_cast<int>(cudaGetLastError());
}

// gout, gforce (3, n) the cotangents of p_v_out and of the reaction force.
// Writes dx, dv (3, n) and dbody_part (16, blocks) float64 with blocks =
// ceil(n / 256), the per-block sums of the body cotangent.
extern "C" int softmac_collide_mixed_bwd_v1(
    const float* x, const float* v, const float* table, const float* body,
    const float* gout, const float* gforce, float* dx, float* dv,
    double* dbody_part, int n, int res0, int res1, int res2, float lower0,
    float lower1, float lower2, float upper0, float upper1, float upper2,
    float inv_dx, float dt, float p_mass, float push_cap, void* stream) {
  if (n > 0) {
    collide_mixed_bwd_kernel<<<softmac::blocks_for(n), softmac::kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        x, v, reinterpret_cast<const float4*>(table), body, gout, gforce, dx,
        dv, dbody_part, n,
        geom(res0, res1, res2, lower0, lower1, lower2, upper0, upper1, upper2,
             inv_dx),
        dt, p_mass, push_cap);
  }
  return static_cast<int>(cudaGetLastError());
}
