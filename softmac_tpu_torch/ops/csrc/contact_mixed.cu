// Forecast mixed contact against one SDF primitive: the merged kernel and
// its two-launch split.
//
// Replaces: softmac_tpu/ops/pallas_contact.py _make_mixed12_kernel (the
// kernel of _fused12_factory, stages 1+2 in one launch) together with the
// XLA row gather in front of it (pallas_contact.py:628-634), and the split
// pair _make_mixed1_kernel / _make_mixed2_kernel of _fused_factory, which
// the JAX package selects with SOFTMAC_TPU_CONTACT_SPLIT. The math is
// contact.cuh mixed_stage1 / mixed_stage2. The wrench sum over particles
// stays a PyTorch reduction in the caller, as pallas_contact._tail12 is
// plain XLA.
//
// The per-particle math runs in double on the float inputs, and the
// outputs are rounded once. In float the forecast point x + dt p_v1,
// rounded to float at world coordinates near 0.7, moves by up to 6e-8;
// the push-out (sdf / dt) * life turns that into up to 3e-5 m/s, 2.3e-5 of
// the largest velocity against the float64 plain version on particles over
// the glass's SDF box (a host build of this file in float; the plain
// version in float32 is off by the same). In double the result is the one
// of the float inputs. The split's stage-1 block is kept in double for the
// same reason.
//
// Outputs a particle: p_v_out (3), the unmasked reaction force
// (v - p_v_out) p_mass / dt (3) and the contact mask dist(x) <= 5e-3 (1
// byte). The split's stage 1 writes p_v1, x + dt p_v1 and dist (7 doubles
// a particle); its stage 2 reads them back with x and v, and gathers the
// stencil row at base(x) again.
//
// What bounds it on the H100: bytes and latency of the table gather. A
// particle reads 6 floats (x, v) and one 128-byte stencil row at a
// data-dependent address, and writes 6 floats + 1 byte: at most 15.6 MB at
// 1e5 particles (12.8 MB of rows, fewer distinct rows because neighbouring
// particles share cells), about 5 us at 3.35 TB/s; ~400 double operations
// a particle are far from the compute limit.
//
// Simple design: one thread per particle, as contact.cu. ONE stencil row
// is read (eight 16-byte loads through the read-only path) and reused by
// the forecast sample. The 16 body floats sit in device memory, so the
// rollout never waits on the host; push_cap, the table's box and
// resolution, dt and p_mass are arguments.
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

__global__ void collide_mixed_kernel(
    const float* __restrict__ x, const float* __restrict__ v,
    const float4* __restrict__ table, const float* __restrict__ body,
    float* __restrict__ pv_out, float* __restrict__ force,
    uint8_t* __restrict__ mask_out, int n, softmac::Geom g, float dt,
    float p_mass, float push_cap) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const V3<Real> xp = load3(x, n, p), vp = load3(v, n, p);
  const Particle q = load_particle(body, xp, table, g);
  const softmac::Mixed1<Real> m =
      softmac::mixed_stage1(q.b, q.softness, xp, vp, q.cell, q.e, Real(dt));
  V3<Real> out, f;
  bool mask;
  softmac::mixed_stage2(q.b, q.life, vp, m, q.cell, q.e, g, Real(dt),
                        Real(p_mass), Real(push_cap), out, f, mask);
  store3(pv_out, n, p, out);
  store3(force, n, p, f);
  mask_out[p] = mask ? 1 : 0;
}

__global__ void collide_mixed1_kernel(
    const float* __restrict__ x, const float* __restrict__ v,
    const float4* __restrict__ table, const float* __restrict__ body,
    double* __restrict__ st1, int n, softmac::Geom g, float dt) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const V3<Real> xp = load3(x, n, p), vp = load3(v, n, p);
  const Particle q = load_particle(body, xp, table, g);
  const softmac::Mixed1<Real> m =
      softmac::mixed_stage1(q.b, q.softness, xp, vp, q.cell, q.e, Real(dt));
  store3(st1, n, p, m.pv1);
  store3(st1 + 3 * n, n, p, m.xnew);
  st1[6 * n + p] = m.dist;
}

__global__ void collide_mixed2_kernel(
    const float* __restrict__ x, const float* __restrict__ v,
    const float4* __restrict__ table, const float* __restrict__ body,
    const double* __restrict__ st1, float* __restrict__ pv_out,
    float* __restrict__ force, uint8_t* __restrict__ mask_out, int n,
    softmac::Geom g, float dt, float p_mass, float push_cap) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const V3<Real> xp = load3(x, n, p), vp = load3(v, n, p);
  const Particle q = load_particle(body, xp, table, g);
  softmac::Mixed1<Real> m;
  m.pv1 = load3(st1, n, p);
  m.xnew = load3(st1 + 3 * n, n, p);
  m.dist = st1[6 * n + p];
  V3<Real> out, f;
  bool mask;
  softmac::mixed_stage2(q.b, q.life, vp, m, q.cell, q.e, g, Real(dt),
                        Real(p_mass), Real(push_cap), out, f, mask);
  store3(pv_out, n, p, out);
  store3(force, n, p, f);
  mask_out[p] = mask ? 1 : 0;
}

}  // namespace

// x, v (3, n); table (cells, 32) f32, 16-byte aligned; body (16,) f32 on
// the device [bp, bq wxyz, bv, bw, friction, softness, life]; outputs
// p_v_out and force (3, n), mask (n,) bool. lower/upper/inv_dx/res describe
// the table; push_cap inf = uncapped. Returns cudaGetLastError() after the
// launch.
extern "C" int softmac_collide_mixed(
    const float* x, const float* v, const float* table, const float* body,
    float* pv_out, float* force, uint8_t* mask, int n, int res0, int res1,
    int res2, float lower0, float lower1, float lower2, float upper0,
    float upper1, float upper2, float inv_dx, float dt, float p_mass,
    float push_cap, void* stream) {
  if (n > 0) {
    softmac::Geom g = {{lower0, lower1, lower2}, {upper0, upper1, upper2},
                       inv_dx, {res0, res1, res2}};
    collide_mixed_kernel<<<softmac::blocks_for(n), softmac::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        x, v, reinterpret_cast<const float4*>(table), body, pv_out, force,
        mask, n, g, dt, p_mass, push_cap);
  }
  return static_cast<int>(cudaGetLastError());
}

// Stage 1 of the split: st1 (7, n) float64 = [p_v1 (3), x + dt p_v1 (3),
// dist].
extern "C" int softmac_collide_mixed1(
    const float* x, const float* v, const float* table, const float* body,
    double* st1, int n, int res0, int res1, int res2, float lower0,
    float lower1, float lower2, float upper0, float upper1, float upper2,
    float inv_dx, float dt, void* stream) {
  if (n > 0) {
    softmac::Geom g = {{lower0, lower1, lower2}, {upper0, upper1, upper2},
                       inv_dx, {res0, res1, res2}};
    collide_mixed1_kernel<<<softmac::blocks_for(n), softmac::kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        x, v, reinterpret_cast<const float4*>(table), body, st1, n, g, dt);
  }
  return static_cast<int>(cudaGetLastError());
}

// Stage 2 of the split, from st1; outputs as softmac_collide_mixed.
extern "C" int softmac_collide_mixed2(
    const float* x, const float* v, const float* table, const float* body,
    const double* st1, float* pv_out, float* force, uint8_t* mask, int n,
    int res0, int res1, int res2, float lower0, float lower1, float lower2,
    float upper0, float upper1, float upper2, float inv_dx, float dt,
    float p_mass, float push_cap, void* stream) {
  if (n > 0) {
    softmac::Geom g = {{lower0, lower1, lower2}, {upper0, upper1, upper2},
                       inv_dx, {res0, res1, res2}};
    collide_mixed2_kernel<<<softmac::blocks_for(n), softmac::kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        x, v, reinterpret_cast<const float4*>(table), body, st1, pv_out,
        force, mask, n, g, dt, p_mass, push_cap);
  }
  return static_cast<int>(cudaGetLastError());
}
