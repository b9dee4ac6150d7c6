// Forecast mixed contact against one SDF primitive: the tiled forward with
// the wrench folded in, and the two-launch split.
//
// Replaces: softmac_tpu/ops/pallas_contact.py _make_mixed12_kernel (the
// kernel of _fused12_factory, stages 1+2 in one launch) together with the
// XLA row gather in front of it (pallas_contact.py:628-634) and the wrench
// tail _tail12 behind it, which XLA fuses inside the custom_vjp; and the
// split pair _make_mixed1_kernel / _make_mixed2_kernel of _fused_factory,
// which the JAX package selects with SOFTMAC_TPU_CONTACT_SPLIT (its
// wrench stays a PyTorch reduction in ops/contact.py, as _tail is XLA).
// The math is contact.cuh mixed_stage1 / mixed_stage2.
//
// The per-particle math runs in double on the float inputs, and the
// outputs are rounded once. In float the forecast point x + dt p_v1,
// rounded to float at world coordinates near 0.7, moves by up to 6e-8;
// the push-out (sdf / dt) * life turns that into up to 3e-5 m/s, 2.3e-5 of
// the largest velocity against the float64 plain version on particles over
// the glass's SDF box (a host build of this file in float; the plain
// version in float32 is off by the same). In double the result is the one
// of the float inputs. The split's stage-1 block is kept in double for the
// same reason, and dt, p_mass and the push cap come in as double, as the
// plain versions take them: dt rounded to float (1e-3 by 4.7e-8) moved
// dx, dv and the body cotangents by up to 1.3e-5 of their largest |value|
// on particles over the glass's box at life 1/3 (an H100 against the
// float64 plain vjp).
//
// The tiled kernel (contact_mixed.cuh describes its phases) reads x, v,
// the SDF lane of each particle's stencil row and the 16 body floats, and
// writes p_v_out and the wrench (6,): force and torque about the body's
// position, summed over the particles in contact (dist(x) <= 5e-3) in
// double in a fixed order and rounded once. Only the particles in the
// contact band run the double-precision contact (11541 of 1e5 against the
// glass and none against the bowl on the flagship pour's state after 10
// env steps: scripts/mixed_variants.py on an H100); the rest copy v.
//
// What bounds it on the H100. The least time is the bytes': a particle
// reads 6 floats and its row's SDF lane (one 128-byte line) and writes 3
// floats, the band's particles read the whole row, 3.8 MB a body at 1e5
// particles, ~1.1 us at 3.35 TB/s; the band's ~430 double operations a
// particle are far from the compute limit. Measured (an H100,
// scripts/mixed_variants.py), it is the chain of dependent device round
// trips a launch takes, ~1 us each: the inputs, the rows, the band's own
// loads, the fence and counter, the partials. The forward keeps two
// blocks an SM (128 registers, a few spills), so that the band's double
// chains have twice the threads.
//
// The split's stage 1 writes p_v1, x + dt p_v1 and dist (7 doubles a
// particle); its stage 2 reads them back with x and v, gathers the stencil
// row at base(x) again and writes p_v_out, the unmasked reaction force
// (v - p_v_out) p_mass / dt and the mask (1 byte). One thread a particle.
#include "contact_mixed.cuh"

namespace {

using softmac::V3;

#ifdef __CUDACC__
__global__ void __launch_bounds__(softmac::kMixedThreads, 2)
    collide_mixed_kernel(softmac::MixedArgs a) {
  softmac::mixed_tiled<softmac::MixedFwdOp, softmac::kMixedPer>(a);
}
#endif

__global__ void collide_mixed1_kernel(
    const float* __restrict__ x, const float* __restrict__ v,
    const float4* __restrict__ table, const float* __restrict__ body,
    double* __restrict__ st1, int n, softmac::Geom g, double dt) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const V3<double> xp = softmac::load3(x, n, p), vp = softmac::load3(v, n, p);
  const softmac::MixedParticle q =
      softmac::load_mixed_particle(body, xp, table, g);
  const softmac::Mixed1<double> m =
      softmac::mixed_stage1(q.b, q.softness, xp, vp, q.cell, q.e, double(dt));
  softmac::store3(st1, n, p, m.pv1);
  softmac::store3(st1 + 3 * n, n, p, m.xnew);
  st1[6 * n + p] = m.dist;
}

__global__ void collide_mixed2_kernel(
    const float* __restrict__ x, const float* __restrict__ v,
    const float4* __restrict__ table, const float* __restrict__ body,
    const double* __restrict__ st1, float* __restrict__ pv_out,
    float* __restrict__ force, uint8_t* __restrict__ mask_out, int n,
    softmac::Geom g, double dt, double p_mass, double push_cap) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const V3<double> xp = softmac::load3(x, n, p), vp = softmac::load3(v, n, p);
  const softmac::MixedParticle q =
      softmac::load_mixed_particle(body, xp, table, g);
  softmac::Mixed1<double> m;
  m.pv1 = softmac::load3(st1, n, p);
  m.xnew = softmac::load3(st1 + 3 * n, n, p);
  m.dist = st1[6 * n + p];
  V3<double> out, f;
  bool mask;
  softmac::mixed_stage2(q.b, q.life, vp, m, q.cell, q.e, g, double(dt),
                        double(p_mass), double(push_cap), out, f, mask);
  softmac::store3(pv_out, n, p, out);
  softmac::store3(force, n, p, f);
  mask_out[p] = mask ? 1 : 0;
}

softmac::Geom geom(int res0, int res1, int res2, float lower0, float lower1,
                   float lower2, float upper0, float upper1, float upper2,
                   float inv_dx) {
  return {{lower0, lower1, lower2}, {upper0, upper1, upper2}, inv_dx,
          {res0, res1, res2}};
}

}  // namespace

// The tiled forward. x, v (3, n); table (cells, 32) f32, 16-byte aligned;
// the body tensors bp (3), bq (4, wxyz), bv (3), bw (3), friction,
// softness, life (one float each) on the device. Writes p_v_out (3, n),
// wrench (6,) f32 and partial (6, blocks) f64 scratch, blocks =
// ceil(n / 512) (kMixedPer * kMixedThreads); done is the launch's
// finished-block counter, zero on entry and on return (contact_mixed.cuh).
// lower/upper/inv_dx/res describe the table; push_cap inf = uncapped.
// Returns cudaGetLastError() after the launch.
extern "C" int softmac_collide_mixed(
    const float* x, const float* v, const float* table, const float* bp,
    const float* bq, const float* bv, const float* bw, const float* friction,
    const float* softness, const float* life, float* pv_out, float* wrench,
    double* partial, unsigned* done, int n, int res0, int res1, int res2,
    float lower0, float lower1, float lower2, float upper0, float upper1,
    float upper2, float inv_dx, double dt, double p_mass, double push_cap,
    void* stream) {
  const softmac::MixedArgs a = {
      x, v, reinterpret_cast<const float4*>(table),
      {bp, bq, bv, bw, friction, softness, life}, nullptr, nullptr, pv_out,
      nullptr, wrench, partial, done, n,
      geom(res0, res1, res2, lower0, lower1, lower2, upper0, upper1, upper2,
           inv_dx),
      dt, p_mass, push_cap};
  if (n > 0) {
    const int threads = softmac::kMixedThreads;
    const int blocks = softmac::mixed_blocks(n, softmac::kMixedPer * threads);
    collide_mixed_kernel<<<blocks, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Stage 1 of the split: st1 (7, n) float64 = [p_v1 (3), x + dt p_v1 (3),
// dist]; body (16,) f32 packed [bp, bq wxyz, bv, bw, friction, softness,
// life].
extern "C" int softmac_collide_mixed1(
    const float* x, const float* v, const float* table, const float* body,
    double* st1, int n, int res0, int res1, int res2, float lower0,
    float lower1, float lower2, float upper0, float upper1, float upper2,
    float inv_dx, double dt, void* stream) {
  if (n > 0) {
    collide_mixed1_kernel<<<softmac::blocks_for(n), softmac::kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        x, v, reinterpret_cast<const float4*>(table), body, st1, n,
        geom(res0, res1, res2, lower0, lower1, lower2, upper0, upper1, upper2,
             inv_dx),
        dt);
  }
  return static_cast<int>(cudaGetLastError());
}

// Stage 2 of the split, from st1: p_v_out and the unmasked reaction force
// (3, n), the mask (n,) bool.
extern "C" int softmac_collide_mixed2(
    const float* x, const float* v, const float* table, const float* body,
    const double* st1, float* pv_out, float* force, uint8_t* mask, int n,
    int res0, int res1, int res2, float lower0, float lower1, float lower2,
    float upper0, float upper1, float upper2, float inv_dx, double dt,
    double p_mass, double push_cap, void* stream) {
  if (n > 0) {
    collide_mixed2_kernel<<<softmac::blocks_for(n), softmac::kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        x, v, reinterpret_cast<const float4*>(table), body, st1, pv_out,
        force, mask, n,
        geom(res0, res1, res2, lower0, lower1, lower2, upper0, upper1, upper2,
             inv_dx),
        dt, p_mass, push_cap);
  }
  return static_cast<int>(cudaGetLastError());
}
