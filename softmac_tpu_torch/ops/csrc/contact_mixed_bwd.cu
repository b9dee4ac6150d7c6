// Backward of the forecast mixed contact against one SDF primitive: the
// merged kernel and its two-launch split.
//
// Replaces: softmac_tpu/ops/pallas_contact.py _make_mixed12_bwd_kernel
// (jax.vjp of _mixed12_math traced inside the kernel, launched from
// _fused12_factory's _bwd), and the split pair _make_mixed2_bwd_kernel /
// _make_mixed1_bwd_kernel of _fused_factory's _bwd, chained k2b -> k1b
// through the stage-1 block's cotangent gst1 (SOFTMAC_TPU_CONTACT_SPLIT).
// The SDF table gets no cotangent, as the JAX _bwd returns zeros for it.
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
// The 16 body floats [bp, bq wxyz, bv, bw, friction, softness, life] are
// summed over particles in a fixed order: each block reduces its threads'
// rows in shared memory (double) to one partial, written to (16, n_blocks)
// doubles; the wrapper sums those with torch.sum. No atomics, so the action
// gradient is the same on every run.
//
// What bounds it on the H100: bytes (x, v and the two cotangents in, dx and
// dv out, 18 floats a particle, and the stencil rows the particles touch:
// ~7.7 MB a body at 1e5 particles, 2.3 us at 3.35 TB/s); the ~900 double
// operations a particle in contact (the forward again and its reverse)
// stay under the compute limit.
//
// Simple design: one thread per particle, as the forward; the stencil row
// is read again rather than saved by the forward.
#include "contact.cuh"

namespace {

using Real = double;   // the per-particle math (see above)
using softmac::V3;

template <class S>
__device__ __forceinline__ V3<Real> load3(const S* __restrict__ a, int n,
                                          int p) {
  return {Real(a[p]), Real(a[n + p]), Real(a[2 * n + p])};
}

template <class S>
__device__ __forceinline__ void store3(S* __restrict__ a, int n, int p,
                                       V3<Real> v) {
  a[p] = static_cast<S>(v.x);
  a[n + p] = static_cast<S>(v.y);
  a[2 * n + p] = static_cast<S>(v.z);
}

// the body, the particle's cell at base(x) and its stencil row
struct Particle {
  softmac::Body<Real> b;
  Real softness, life;
  softmac::Cell<Real> cell;
  float4 e[8];
};

__device__ __forceinline__ Particle load_particle(
    const float* __restrict__ body, V3<Real> xp,
    const float4* __restrict__ table, const softmac::Geom& g) {
  Particle q;
  q.b = softmac::load_body<Real>(body);
  q.softness = body[14];
  q.life = body[15];
  const V3<Real> nv_conj = {-q.b.nv.x, -q.b.nv.y, -q.b.nv.z};
  q.cell = softmac::locate(softmac::qrot(q.b.nw, nv_conj, xp - q.b.bp), table,
                           g);
  for (int c = 0; c < 8; ++c) q.e[c] = __ldg(q.cell.row + c);
  return q;
}

// Fixed-order tree reduction of the block's 16 body cotangents into
// part[i * gridDim.x + blockIdx.x]. Every thread of the block calls it.
__device__ __forceinline__ void reduce_body(const Real gb[16],
                                            double* __restrict__ part) {
  __shared__ double red[16][softmac::kThreads];
  const int t = threadIdx.x;
  for (int i = 0; i < 16; ++i) red[i][t] = gb[i];
  __syncthreads();
  for (int stride = softmac::kThreads / 2; stride > 0; stride >>= 1) {
    if (t < stride) {
      for (int i = 0; i < 16; ++i) red[i][t] += red[i][t + stride];
    }
    __syncthreads();
  }
  if (t < 16) part[t * gridDim.x + blockIdx.x] = red[t][0];
}

// One particle's merged reverse: dx, dv and its 16 body cotangents.
__device__ __forceinline__ void mixed_bwd_particle(
    const float* __restrict__ x, const float* __restrict__ v,
    const float4* __restrict__ table, const float* __restrict__ body,
    const float* __restrict__ gout, const float* __restrict__ gforce, int n,
    int p, const softmac::Geom& g, float dt, float p_mass, float push_cap,
    V3<Real>& gx, V3<Real>& gv, Real gb[16]) {
  const V3<Real> xp = load3(x, n, p), vp = load3(v, n, p);
  const Particle q = load_particle(body, xp, table, g);
  const softmac::Mixed1<Real> m =
      softmac::mixed_stage1(q.b, q.softness, xp, vp, q.cell, q.e, Real(dt));
  const V3<Real> zero = {Real(0), Real(0), Real(0)};
  softmac::BodyGrad<Real> gbody = softmac::zero_body_grad<Real>();
  V3<Real> gpv1 = zero, gxnew = zero;
  gv = zero;
  softmac::mixed_stage2_backward(q.b, q.life, vp, m, q.cell, q.e, g, Real(dt),
                                 Real(p_mass), Real(push_cap),
                                 load3(gout, n, p), load3(gforce, n, p), gv,
                                 gpv1, gxnew, gbody);
  // x_new = x + dt p_v1
  gx = gxnew;
  gpv1 = gpv1 + gxnew * Real(dt);
  softmac::mixed_stage1_backward(q.b, q.softness, xp, vp, q.cell, q.e, g,
                                 gpv1, gx, gv, gbody);
  softmac::finish_body_grad(q.b, gbody, gb);
}

// One particle's split stage-2 reverse (k2b): the stage-1 block's
// cotangent [d p_v1 (3), d x_new (3), d dist = 0] into gst1, stage 2's
// share of dv and of the body cotangents.
__device__ __forceinline__ void mixed2_bwd_particle(
    const float* __restrict__ x, const float* __restrict__ v,
    const float4* __restrict__ table, const float* __restrict__ body,
    const double* __restrict__ st1, const float* __restrict__ gout,
    const float* __restrict__ gforce, double* __restrict__ gst1, int n, int p,
    const softmac::Geom& g, float dt, float p_mass, float push_cap,
    V3<Real>& gv, Real gb[16]) {
  const V3<Real> xp = load3(x, n, p), vp = load3(v, n, p);
  const Particle q = load_particle(body, xp, table, g);
  softmac::Mixed1<Real> m;
  m.pv1 = load3(st1, n, p);
  m.xnew = load3(st1 + 3 * n, n, p);
  m.dist = st1[6 * n + p];
  const V3<Real> zero = {Real(0), Real(0), Real(0)};
  softmac::BodyGrad<Real> gbody = softmac::zero_body_grad<Real>();
  V3<Real> gpv1 = zero, gxnew = zero;
  gv = zero;
  softmac::mixed_stage2_backward(q.b, q.life, vp, m, q.cell, q.e, g, Real(dt),
                                 Real(p_mass), Real(push_cap),
                                 load3(gout, n, p), load3(gforce, n, p), gv,
                                 gpv1, gxnew, gbody);
  softmac::finish_body_grad(q.b, gbody, gb);
  store3(gst1, n, p, gpv1);
  store3(gst1 + 3 * n, n, p, gxnew);
  gst1[6 * n + p] = 0.0;
}

// One particle's split stage-1 reverse (k1b) from gst1: dx, stage 1's
// share of dv (added to gv) and of the body cotangents.
__device__ __forceinline__ void mixed1_bwd_particle(
    const float* __restrict__ x, const float* __restrict__ v,
    const float4* __restrict__ table, const float* __restrict__ body,
    const double* __restrict__ gst1, int n, int p, const softmac::Geom& g,
    float dt, V3<Real>& gx, V3<Real>& gv, Real gb[16]) {
  const V3<Real> xp = load3(x, n, p), vp = load3(v, n, p);
  const Particle q = load_particle(body, xp, table, g);
  // st1 = [p_v1, x + dt p_v1, dist]
  const V3<Real> gxnew = load3(gst1 + 3 * n, n, p);
  gx = gxnew;
  const V3<Real> gpv1 = load3(gst1, n, p) + gxnew * Real(dt);
  softmac::BodyGrad<Real> gbody = softmac::zero_body_grad<Real>();
  softmac::mixed_stage1_backward(q.b, q.softness, xp, vp, q.cell, q.e, g,
                                 gpv1, gx, gv, gbody);
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
  Real gb[16];
  for (int i = 0; i < 16; ++i) gb[i] = Real(0);
  if (p < n) {
    V3<Real> gx, gv;
    mixed_bwd_particle(x, v, table, body, gout, gforce, n, p, g, dt, p_mass,
                       push_cap, gx, gv, gb);
    store3(dx, n, p, gx);
    store3(dv, n, p, gv);
  }
  reduce_body(gb, dbody_part);
}

__global__ void collide_mixed2_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ v,
    const float4* __restrict__ table, const float* __restrict__ body,
    const double* __restrict__ st1, const float* __restrict__ gout,
    const float* __restrict__ gforce, double* __restrict__ gst1,
    float* __restrict__ dv, double* __restrict__ dbody_part, int n,
    softmac::Geom g, float dt, float p_mass, float push_cap) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  Real gb[16];
  for (int i = 0; i < 16; ++i) gb[i] = Real(0);
  if (p < n) {
    V3<Real> gv;
    mixed2_bwd_particle(x, v, table, body, st1, gout, gforce, gst1, n, p, g,
                        dt, p_mass, push_cap, gv, gb);
    store3(dv, n, p, gv);
  }
  reduce_body(gb, dbody_part);
}

// dv holds stage 2's share on entry and the whole cotangent on return.
__global__ void collide_mixed1_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ v,
    const float4* __restrict__ table, const float* __restrict__ body,
    const double* __restrict__ gst1, float* __restrict__ dx,
    float* __restrict__ dv, double* __restrict__ dbody_part, int n,
    softmac::Geom g, float dt) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  Real gb[16];
  for (int i = 0; i < 16; ++i) gb[i] = Real(0);
  if (p < n) {
    V3<Real> gx, gv = load3(dv, n, p);
    mixed1_bwd_particle(x, v, table, body, gst1, n, p, g, dt, gx, gv, gb);
    store3(dx, n, p, gx);
    store3(dv, n, p, gv);
  }
  reduce_body(gb, dbody_part);
}

softmac::Geom geom(int res0, int res1, int res2, float lower0, float lower1,
                   float lower2, float upper0, float upper1, float upper2,
                   float inv_dx) {
  return {{lower0, lower1, lower2}, {upper0, upper1, upper2}, inv_dx,
          {res0, res1, res2}};
}

}  // namespace

// x, v (3, n), table, body (16,) and the geometry as for
// softmac_collide_mixed; gout, gforce (3, n) the cotangents of p_v_out and
// of the reaction force. Writes dx, dv (3, n) and dbody_part (16, blocks)
// float64 with blocks = ceil(n / 256), the per-block sums of the body
// cotangent. Returns cudaGetLastError() after the launch.
extern "C" int softmac_collide_mixed_bwd(
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

// Split stage 2's reverse: st1 (7, n) float64 from softmac_collide_mixed1,
// gout, gforce as above. Writes gst1 (7, n) float64, stage 2's share of dv
// (3, n) and of the body cotangent, dbody_part (16, blocks) float64.
extern "C" int softmac_collide_mixed2_bwd(
    const float* x, const float* v, const float* table, const float* body,
    const double* st1, const float* gout, const float* gforce, double* gst1,
    float* dv, double* dbody_part, int n, int res0, int res1, int res2,
    float lower0, float lower1, float lower2, float upper0, float upper1,
    float upper2, float inv_dx, float dt, float p_mass, float push_cap,
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
    float upper0, float upper1, float upper2, float inv_dx, float dt,
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
