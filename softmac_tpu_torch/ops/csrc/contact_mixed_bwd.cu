// Backward of the forecast mixed contact against one SDF primitive: the
// tiled kernel with the wrench's reverse folded in, and the two-launch
// split.
//
// Replaces: softmac_tpu/ops/pallas_contact.py _make_mixed12_bwd_kernel
// (jax.vjp of _mixed12_math traced inside the kernel, launched from
// _fused12_factory's _bwd) together with jax.vjp of the wrench tail
// _tail12 in front of it (g_out, g_x_t, g_bp_t), and the split pair
// _make_mixed2_bwd_kernel / _make_mixed1_bwd_kernel of _fused_factory's
// _bwd, chained k2b -> k1b through the stage-1 block's cotangent gst1
// (SOFTMAC_TPU_CONTACT_SPLIT). The SDF table gets no cotangent, as the JAX
// _bwd returns zeros for it.
//
// CUDA has no vjp transform, so contact.cuh mixed_stage2_backward and
// mixed_stage1_backward are reverse sweeps written by hand over the same
// forward (mixed_stage1 / mixed_stage2, recomputed here from x, v and the
// stencil row at base(x), as the TPU kernel recomputes it): the reaction
// force, the masked push-out along the forecast normal (unclamped
// fractions relative to base(x), the push cap, in_box of the forecast
// point), the forecast x_new = x + dt p_v1, the soft band's influence, the
// friction cone, the collider velocity, the trilinear sdf and normal and
// the quaternion rotations (the raw quaternion for D and n2, the
// normalised one for the local frame and the collider velocity).
// The per-particle math runs in double on the float inputs, as the forward
// kernels (contact_mixed.cu says why); the outputs are rounded once. The
// split keeps the stage-1 block and its cotangent in double, so split and
// merged agree to float rounding of dv.
//
// The tiled kernel (contact_mixed.cuh) takes the cotangents of p_v_out
// (3, n) and of the wrench (6,) on the device. A particle out of the
// contact band gets dx = 0 and dv = gout, exactly the reverse sweep's
// result there; the band's particles run the forward again, the wrench's
// reverse and the two reverse sweeps. The 16 body cotangents (the wrench's
// share of bp included) are summed in double in a fixed order, each block
// to its partial and the last block over the partials, and rounded once:
// the action gradient is the same on every run, in one launch.
//
// What bounds it on the H100: the least time is the bytes' (x, v, gout
// in, dx, dv out, 15 floats a particle, and the rows: ~6.2 MB a body at
// 1e5 particles, ~1.9 us at 3.35 TB/s); the ~900 double operations a
// particle in the band (the forward again and its reverse) stay under
// the compute limit. Measured, as the forward: the chain of dependent
// round trips, and the band's long double chains at one block an SM (the
// reverse sweep takes 255 registers; at two blocks it spills 1.2 KB).
//
// The split's kernels are one thread a particle; each block reduces its
// threads' body cotangents in shared memory (reduce_body) to one float64
// partial, which the wrapper sums.
#include "contact_mixed.cuh"

namespace {

using softmac::V3;

#ifdef __CUDACC__
__global__ void __launch_bounds__(softmac::kMixedThreads)
    collide_mixed_bwd_kernel(softmac::MixedArgs a) {
  softmac::mixed_tiled<softmac::MixedBwdOp, softmac::kMixedBwdPer>(a);
}
#endif

// One particle's split stage-2 reverse (k2b): the stage-1 block's
// cotangent [d p_v1 (3), d x_new (3), d dist = 0] into gst1, stage 2's
// share of dv and of the body cotangents.
__device__ __forceinline__ void mixed2_bwd_particle(
    const float* __restrict__ x, const float* __restrict__ v,
    const float4* __restrict__ table, const float* __restrict__ body,
    const double* __restrict__ st1, const float* __restrict__ gout,
    const float* __restrict__ gforce, double* __restrict__ gst1, int n, int p,
    const softmac::Geom& g, double dt, double p_mass, double push_cap,
    V3<double>& gv, double gb[16]) {
  const V3<double> xp = softmac::load3(x, n, p), vp = softmac::load3(v, n, p);
  const softmac::MixedParticle q =
      softmac::load_mixed_particle(body, xp, table, g);
  softmac::Mixed1<double> m;
  m.pv1 = softmac::load3(st1, n, p);
  m.xnew = softmac::load3(st1 + 3 * n, n, p);
  m.dist = st1[6 * n + p];
  const V3<double> zero = {0.0, 0.0, 0.0};
  softmac::BodyGrad<double> gbody = softmac::zero_body_grad<double>();
  V3<double> gpv1 = zero, gxnew = zero;
  gv = zero;
  softmac::mixed_stage2_backward(
      q.b, q.life, vp, m, q.cell, q.e, g, double(dt), double(p_mass),
      double(push_cap), softmac::load3(gout, n, p),
      softmac::load3(gforce, n, p), gv, gpv1, gxnew, gbody);
  softmac::finish_body_grad(q.b, gbody, gb);
  softmac::store3(gst1, n, p, gpv1);
  softmac::store3(gst1 + 3 * n, n, p, gxnew);
  gst1[6 * n + p] = 0.0;
}

// One particle's split stage-1 reverse (k1b) from gst1: dx, stage 1's
// share of dv (added to gv) and of the body cotangents.
__device__ __forceinline__ void mixed1_bwd_particle(
    const float* __restrict__ x, const float* __restrict__ v,
    const float4* __restrict__ table, const float* __restrict__ body,
    const double* __restrict__ gst1, int n, int p, const softmac::Geom& g,
    double dt, V3<double>& gx, V3<double>& gv, double gb[16]) {
  const V3<double> xp = softmac::load3(x, n, p), vp = softmac::load3(v, n, p);
  const softmac::MixedParticle q =
      softmac::load_mixed_particle(body, xp, table, g);
  // st1 = [p_v1, x + dt p_v1, dist]
  const V3<double> gxnew = softmac::load3(gst1 + 3 * n, n, p);
  gx = gxnew;
  const V3<double> gpv1 = softmac::load3(gst1, n, p) + gxnew * double(dt);
  softmac::BodyGrad<double> gbody = softmac::zero_body_grad<double>();
  softmac::mixed_stage1_backward(q.b, q.softness, xp, vp, q.cell, q.e, g,
                                 gpv1, gx, gv, gbody);
  softmac::finish_body_grad(q.b, gbody, gb);
}

__global__ void collide_mixed2_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ v,
    const float4* __restrict__ table, const float* __restrict__ body,
    const double* __restrict__ st1, const float* __restrict__ gout,
    const float* __restrict__ gforce, double* __restrict__ gst1,
    float* __restrict__ dv, double* __restrict__ dbody_part, int n,
    softmac::Geom g, double dt, double p_mass, double push_cap) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  double gb[16];
  for (int i = 0; i < 16; ++i) gb[i] = 0.0;
  if (p < n) {
    V3<double> gv;
    mixed2_bwd_particle(x, v, table, body, st1, gout, gforce, gst1, n, p, g,
                        dt, p_mass, push_cap, gv, gb);
    softmac::store3(dv, n, p, gv);
  }
  softmac::reduce_body(gb, dbody_part);
}

// dv holds stage 2's share on entry and the whole cotangent on return.
__global__ void collide_mixed1_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ v,
    const float4* __restrict__ table, const float* __restrict__ body,
    const double* __restrict__ gst1, float* __restrict__ dx,
    float* __restrict__ dv, double* __restrict__ dbody_part, int n,
    softmac::Geom g, double dt) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  double gb[16];
  for (int i = 0; i < 16; ++i) gb[i] = 0.0;
  if (p < n) {
    V3<double> gx, gv = softmac::load3(dv, n, p);
    mixed1_bwd_particle(x, v, table, body, gst1, n, p, g, dt, gx, gv, gb);
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

// The tiled backward. x, v, table, the body tensors and the geometry as
// for softmac_collide_mixed; gout (3, n) and gwrench (6,) f32 the
// cotangents of p_v_out and of the wrench. Writes dx, dv (3, n), dbody
// (16,) f32 [bp, bq wxyz, bv, bw, friction, softness, life] and partial
// (16, blocks) f64 scratch, blocks = ceil(n / 1024) (kMixedBwdPer *
// kMixedThreads); done as for softmac_collide_mixed. Returns
// cudaGetLastError() after the launch.
extern "C" int softmac_collide_mixed_bwd(
    const float* x, const float* v, const float* table, const float* bp,
    const float* bq, const float* bv, const float* bw, const float* friction,
    const float* softness, const float* life, const float* gout,
    const float* gwrench, float* dx, float* dv, float* dbody, double* partial,
    unsigned* done, int n, int res0, int res1, int res2, float lower0,
    float lower1, float lower2, float upper0, float upper1, float upper2,
    float inv_dx, double dt, double p_mass, double push_cap, void* stream) {
  const softmac::MixedArgs a = {
      x, v, reinterpret_cast<const float4*>(table),
      {bp, bq, bv, bw, friction, softness, life}, gout, gwrench, dx, dv,
      dbody, partial, done, n,
      geom(res0, res1, res2, lower0, lower1, lower2, upper0, upper1, upper2,
           inv_dx),
      dt, p_mass, push_cap};
  if (n > 0) {
    const int threads = softmac::kMixedThreads;
    const int blocks =
        softmac::mixed_blocks(n, softmac::kMixedBwdPer * threads);
    collide_mixed_bwd_kernel<<<blocks, threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Split stage 2's reverse: st1 (7, n) float64 from softmac_collide_mixed1,
// body (16,) packed, gout, gforce (3, n) the cotangents of p_v_out and of
// the reaction force. Writes gst1 (7, n) float64, stage 2's share of dv
// (3, n) and of the body cotangent, dbody_part (16, blocks) float64 with
// blocks = ceil(n / 256).
extern "C" int softmac_collide_mixed2_bwd(
    const float* x, const float* v, const float* table, const float* body,
    const double* st1, const float* gout, const float* gforce, double* gst1,
    float* dv, double* dbody_part, int n, int res0, int res1, int res2,
    float lower0, float lower1, float lower2, float upper0, float upper1,
    float upper2, float inv_dx, double dt, double p_mass, double push_cap,
    void* stream) {
  if (n > 0) {
    collide_mixed2_bwd_kernel<<<softmac::blocks_for(n), softmac::kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        x, v, reinterpret_cast<const float4*>(table), body, st1, gout, gforce,
        gst1, dv, dbody_part, n,
        geom(res0, res1, res2, lower0, lower1, lower2, upper0, upper1, upper2,
             inv_dx),
        dt, p_mass, push_cap);
  }
  return static_cast<int>(cudaGetLastError());
}

// Split stage 1's reverse: gst1 from softmac_collide_mixed2_bwd; dv holds
// stage 2's share on entry and the whole cotangent on return. Writes dx
// (3, n) and stage 1's share of the body cotangent, dbody_part (16, blocks)
// float64.
extern "C" int softmac_collide_mixed1_bwd(
    const float* x, const float* v, const float* table, const float* body,
    const double* gst1, float* dx, float* dv, double* dbody_part, int n,
    int res0, int res1, int res2, float lower0, float lower1, float lower2,
    float upper0, float upper1, float upper2, float inv_dx, double dt,
    void* stream) {
  if (n > 0) {
    collide_mixed1_bwd_kernel<<<softmac::blocks_for(n), softmac::kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        x, v, reinterpret_cast<const float4*>(table), body, gst1, dx, dv,
        dbody_part, n,
        geom(res0, res1, res2, lower0, lower1, lower2, upper0, upper1, upper2,
             inv_dx),
        dt);
  }
  return static_cast<int>(cudaGetLastError());
}
