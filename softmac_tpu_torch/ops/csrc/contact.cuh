// Per-particle contact against one SDF primitive: the penalty contact,
// forward and reverse, which contact_mixed.cuh's penalty ops run for the
// tiled kernels of contact.cu and contact_bwd.cu, and the forecast mixed
// contact of contact_mixed.cu (at the end of this file).
// The penalty contact has the same math as pallas_contact._particle_math
// and engine.contact._collide_particle_xla of the JAX package:
//   p_loc  = rot(conj(q)/|q|, x - bp)
//   base   = clamp(floor((p_loc - lower) * inv_dx), 0, res - 2)   per axis
//   fx     = clamp((p_loc - lower) * inv_dx - base, 0, 1)
//   (sdf, n_loc) = trilinear over the cell's 32-float neighborhood row;
//                  BIG and (0, 1, 0) outside [lower, upper)
//   D      = rot(q, n_loc)          (q as given, not normalized)
//   c      = sdf - 5e-3, mask = c < 0
//   cv     = rot(q/|q|, bv + bw x rot(conj(q)/|q|, x - bp))
//   imp    = -D c k1 dt  -  p_v_t / |p_v_t| * min(|nc| friction dt,
//                                                  p_mass |p_v_t|)
//   (k1 = 50, nc = (v - cv).D, p_v_t the tangential part, |.| with the
//   1e-8 inside the root), zero where mask is false.
//
// The math is a template on the scalar type T; both kernels run it in
// double on the float inputs. The backward needs it: the normal's
// derivative divides by |u|^2, |u| the trilinear normal before
// normalisation, which is short near the SDF's medial surface, so float
// rounding of u alone moved the position cotangent by up to 4e-5 of its
// largest value (measured on the H100 against the float64 plain vjp); in
// double the cotangent is the one of the float inputs, rounded once. The
// forward runs it in double too, so that both take one mask.
#pragma once

#include "bspline.cuh"

namespace softmac {

constexpr double kBigContact = 1e10;
constexpr double kThreshold = 5e-3;
constexpr double kStiffness = 50.0;

__device__ __forceinline__ float r_sqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ double r_sqrt(double a) { return sqrt(a); }
__device__ __forceinline__ float r_floor(float a) { return floorf(a); }
__device__ __forceinline__ double r_floor(double a) { return floor(a); }
__device__ __forceinline__ float r_min(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double r_min(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float r_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double r_max(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float r_abs(float a) { return fabsf(a); }
__device__ __forceinline__ double r_abs(double a) { return fabs(a); }
__device__ __forceinline__ float r_exp(float a) { return expf(a); }
__device__ __forceinline__ double r_exp(double a) { return exp(a); }

template <class T>
struct V3 {
  T x, y, z;
};

template <class T>
__device__ __forceinline__ V3<T> operator+(V3<T> a, V3<T> b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
template <class T>
__device__ __forceinline__ V3<T> operator-(V3<T> a, V3<T> b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
template <class T>
__device__ __forceinline__ V3<T> operator*(V3<T> a, T s) {
  return {a.x * s, a.y * s, a.z * s};
}

template <class T>
__device__ __forceinline__ V3<T> cross(V3<T> a, V3<T> b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

template <class T>
__device__ __forceinline__ T dot(V3<T> a, V3<T> b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// rotate v by the (not necessarily unit) quaternion (w, qv), as m33.qrot
template <class T>
__device__ __forceinline__ V3<T> qrot(T w, V3<T> qv, V3<T> v) {
  const V3<T> uv = cross(qv, v);
  const V3<T> uuv = cross(qv, uv);
  return {v.x + T(2) * (w * uv.x + uuv.x), v.y + T(2) * (w * uv.y + uuv.y),
          v.z + T(2) * (w * uv.z + uuv.z)};
}

// Reverse of qrot: adds the cotangents of w, qv and v for the output
// cotangent g (for a = b x c with cotangent h: b gets c x h, c gets h x b).
template <class T>
__device__ __forceinline__ void qrot_adjoint(T w, V3<T> qv, V3<T> v, V3<T> g,
                                             T& gw, V3<T>& gqv, V3<T>& gv) {
  const V3<T> uv = cross(qv, v);
  gw += T(2) * dot(g, uv);
  const V3<T> guuv = g * T(2);
  V3<T> guv = g * (T(2) * w);
  gqv = gqv + cross(uv, guuv);          // uuv = qv x uv
  guv = guv + cross(guuv, qv);
  gqv = gqv + cross(v, guv);            // uv = qv x v
  gv = gv + g + cross(guv, qv);
}

struct Geom {
  float lower[3], upper[3], inv_dx;
  int res[3];
};

// Body state as the kernels read it: body = [bp(3), bq(4) wxyz, bv(3),
// bw(3), friction], the lane order of pallas_contact _BP, _BQ, _BV, _BW
// followed by _FRICTION.
template <class T>
struct Body {
  V3<T> bp;
  T qw;
  V3<T> qv;
  V3<T> bv, bw;
  T friction;
  T qn_inv;  // 1 / sqrt(|q|^2 + 1e-12)
  T nw;      // qnorm(q) = (nw, nv)
  V3<T> nv;
};

template <class T>
__device__ __forceinline__ Body<T> load_body(const float* __restrict__ body) {
  Body<T> b;
  b.bp = {T(body[0]), T(body[1]), T(body[2])};
  b.qw = T(body[3]);
  b.qv = {T(body[4]), T(body[5]), T(body[6])};
  b.bv = {T(body[7]), T(body[8]), T(body[9])};
  b.bw = {T(body[10]), T(body[11]), T(body[12])};
  b.friction = T(body[13]);
  b.qn_inv = T(1) / r_sqrt(b.qw * b.qw + dot(b.qv, b.qv) + T(1e-12));
  b.nw = b.qw * b.qn_inv;
  b.nv = b.qv * b.qn_inv;
  return b;
}

// Everything the forward computes for one particle that its reverse sweep
// reads again.
template <class T>
struct Contact {
  V3<T> r, pl;           // x - bp, and it in the body frame (= r_loc)
  T fx[3];
  bool fx_free[3];       // fx not clamped: d fx / d p_loc = inv_dx
  float4 e[8];           // the 2x2x2 stencil row, [sdf, nx, ny, nz] each
  V3<T> u;               // the trilinear normal before normalization
  T nrm;
  bool in_box, mask;
  V3<T> n_loc, D, vl, in_v, pvt;
  T c, nc, spring, vt_norm, fric_a, fric_b, fric, s;
  V3<T> imp;             // zero where mask is false
};

// Base cell of the local point pl (clamped to the table), the fractions
// relative to it (clamped) and whether pl lies in the table's box
// [lower, upper), as pallas_contact._cell_index / _local_and_fx.
template <class T>
struct Cell {
  const float4* row;     // the cell's 2x2x2 stencil row: 32 floats = 8 float4
  T basef[3];
  T fx[3];
  bool fx_free[3];       // fx not clamped: d fx / d p_loc = inv_dx
  bool in_box;
};

template <class T>
__device__ __forceinline__ Cell<T> locate(V3<T> pl, const float4* __restrict__ table,
                                          const Geom& g) {
  Cell<T> c;
  const T lp[3] = {pl.x, pl.y, pl.z};
  int base[3];
  c.in_box = true;
  for (int d = 0; d < 3; ++d) {
    const T lower = T(g.lower[d]);
    c.in_box = c.in_box && (lp[d] >= lower) && (lp[d] < T(g.upper[d]));
    const T pos = (lp[d] - lower) * T(g.inv_dx);
    const T bf = r_min(r_max(r_floor(pos), T(0)), T(g.res[d] - 2));
    base[d] = static_cast<int>(bf);
    c.basef[d] = bf;
    const T f = pos - bf;
    c.fx_free[d] = f >= T(0) && f <= T(1);
    c.fx[d] = r_min(r_max(f, T(0)), T(1));
  }
  const long long cell =
      (static_cast<long long>(base[0]) * g.res[1] + base[1]) * g.res[2] + base[2];
  c.row = table + cell * 8;
  return c;
}

// Trilinear sdf (returned) and normal before normalisation (u) over the
// corners c = 4i + 2j + k of a stencil row, each [sdf, nx, ny, nz]; fx
// may lie outside [0, 1] (a forecast point against another point's row).
template <class T>
__device__ __forceinline__ T trilinear(const float4 e[8], const T fx[3], V3<T>& u) {
  T sdf = T(0);
  u = {T(0), T(0), T(0)};
  for (int c = 0; c < 8; ++c) {
    const int i = c >> 2, j = (c >> 1) & 1, l = c & 1;
    const T wi = i ? fx[0] : T(1) - fx[0];
    const T wj = j ? fx[1] : T(1) - fx[1];
    const T wl = l ? fx[2] : T(1) - fx[2];
    const T w = wi * wj * wl;
    sdf += w * T(e[c].x);
    u.x += w * T(e[c].y);
    u.y += w * T(e[c].z);
    u.z += w * T(e[c].w);
  }
  return sdf;
}

// (sdf, unit normal) from trilinear's result: BIG and (0, 1, 0) outside
// the box; nrm is |u| with the 1e-14 inside the root.
template <class T>
__device__ __forceinline__ T finish_sample(T sdf, V3<T> u, bool in_box,
                                           V3<T>& n, T& nrm) {
  nrm = r_sqrt(u.x * u.x + u.y * u.y + u.z * u.z + T(1e-14));
  n = in_box ? V3<T>{u.x / nrm, u.y / nrm, u.z / nrm}
             : V3<T>{T(0), T(1), T(0)};
  return in_box ? sdf : T(kBigContact);
}

template <class T>
__device__ __forceinline__ Contact<T> contact_forward(
    const Body<T>& b, V3<T> xp, V3<T> vp, const float4* __restrict__ table,
    const Geom& g, T dt, T p_mass) {
  Contact<T> k;
  const V3<T> nv_conj = {-b.nv.x, -b.nv.y, -b.nv.z};   // qnorm(conj(q))
  k.r = xp - b.bp;
  k.pl = qrot(b.nw, nv_conj, k.r);

  const Cell<T> cell = locate(k.pl, table, g);
  k.in_box = cell.in_box;
  for (int d = 0; d < 3; ++d) {
    k.fx[d] = cell.fx[d];
    k.fx_free[d] = cell.fx_free[d];
  }
  for (int c = 0; c < 8; ++c) k.e[c] = __ldg(cell.row + c);
  const T sdf = trilinear(k.e, k.fx, k.u);
  const T dist = finish_sample(sdf, k.u, k.in_box, k.n_loc, k.nrm);
  k.D = qrot(b.qw, b.qv, k.n_loc);

  k.c = dist - T(kThreshold);
  k.mask = k.c < T(0);
  k.c = k.mask ? k.c : T(0);

  // collider velocity: rot(q, bv + bw x rot(conj(q), r)), q normalized;
  // rot(conj(q)/|q|, r) is p_loc again
  k.vl = b.bv + cross(b.bw, k.pl);
  const V3<T> cv = qrot(b.nw, b.nv, k.vl);

  k.in_v = vp - cv;
  k.nc = dot(k.in_v, k.D);
  k.pvt = k.in_v - k.D * k.nc;
  k.spring = -(k.c * T(kStiffness) * dt);
  k.vt_norm = r_sqrt(dot(k.pvt, k.pvt) + T(1e-8));
  k.fric_a = r_abs(k.nc) * b.friction * dt;
  k.fric_b = p_mass * k.vt_norm;
  k.fric = r_min(k.fric_a, k.fric_b);
  k.s = -k.fric / k.vt_norm;
  const V3<T> out = k.D * k.spring + k.pvt * k.s;
  k.imp = k.mask ? out : V3<T>{T(0), T(0), T(0)};
  return k;
}

// Reverse sweep of contact_forward for the impulse cotangent gi: the
// cotangents of x and v, and of the 14 body floats in load_body's order.
// A particle out of contact (mask false, every particle outside the SDF
// box among them) gets zero everywhere: the forward's where(mask, ., 0)
// on c and on the impulse cuts every path.
template <class T>
__device__ __forceinline__ void contact_backward(const Body<T>& b,
                                                 const Contact<T>& k,
                                                 V3<T> gi, const Geom& g,
                                                 T dt, T p_mass, V3<T>& gx,
                                                 V3<T>& gv, T gbody[14]) {
  for (int i = 0; i < 14; ++i) gbody[i] = T(0);
  gx = gv = V3<T>{T(0), T(0), T(0)};
  if (!k.mask) return;

  // imp = D spring + pvt s
  V3<T> gD = gi * k.spring;
  const T gspring = dot(gi, k.D);
  V3<T> gpvt = gi * k.s;
  const T gs = dot(gi, k.pvt);
  // s = -fric / vt_norm
  const T gfric = -gs / k.vt_norm;
  T gvt = gs * k.fric / (k.vt_norm * k.vt_norm);
  // fric = min(a, b): the smaller one takes the cotangent, half each on a tie
  const T ga = k.fric_a < k.fric_b ? gfric
               : (k.fric_a > k.fric_b ? T(0) : T(0.5) * gfric);
  const T gb = gfric - ga;
  // a = |nc| friction dt, b = p_mass vt_norm
  const T sign_nc = k.nc > T(0) ? T(1) : (k.nc < T(0) ? T(-1) : T(0));
  T gnc = ga * sign_nc * b.friction * dt;
  gbody[13] = ga * r_abs(k.nc) * dt;
  gvt += gb * p_mass;
  // vt_norm = sqrt(pvt . pvt + 1e-8)
  gpvt = gpvt + k.pvt * (gvt / k.vt_norm);
  // pvt = in_v - D nc
  V3<T> gin_v = gpvt;
  gD = gD - gpvt * k.nc;
  gnc -= dot(gpvt, k.D);
  // nc = in_v . D
  gin_v = gin_v + k.D * gnc;
  gD = gD + k.in_v * gnc;
  // in_v = v - cv
  gv = gin_v;
  const V3<T> gcv = V3<T>{T(0), T(0), T(0)} - gin_v;
  // spring = -(c k1 dt), c = sdf - threshold (mask true: in the box)
  const T gsdf = -gspring * T(kStiffness) * dt;

  // cv = rot(nw, nv; vl), vl = bv + bw x pl
  T gnw = T(0);
  V3<T> gnv = {T(0), T(0), T(0)};
  V3<T> gvl = {T(0), T(0), T(0)};
  qrot_adjoint(b.nw, b.nv, k.vl, gcv, gnw, gnv, gvl);
  const V3<T> gbw = cross(k.pl, gvl);
  V3<T> gpl = cross(gvl, b.bw);

  // D = rot(qw, qv; n_loc), q as given
  T gqw = T(0);
  V3<T> gqv = {T(0), T(0), T(0)};
  V3<T> gn = {T(0), T(0), T(0)};
  qrot_adjoint(b.qw, b.qv, k.n_loc, gD, gqw, gqv, gn);
  // n_loc = u / sqrt(|u|^2 + 1e-14)
  const T inv = T(1) / k.nrm;
  const V3<T> gu = gn * inv - k.u * (dot(k.u, gn) * inv * inv * inv);

  // trilinear weights -> fractions -> p_loc
  T gf[3] = {T(0), T(0), T(0)};
  for (int c = 0; c < 8; ++c) {
    const int i = c >> 2, j = (c >> 1) & 1, l = c & 1;
    const T wi = i ? k.fx[0] : T(1) - k.fx[0];
    const T wj = j ? k.fx[1] : T(1) - k.fx[1];
    const T wl = l ? k.fx[2] : T(1) - k.fx[2];
    const T gw = gsdf * T(k.e[c].x) + gu.x * T(k.e[c].y)
                 + gu.y * T(k.e[c].z) + gu.z * T(k.e[c].w);
    gf[0] += gw * (i ? T(1) : T(-1)) * wj * wl;
    gf[1] += gw * wi * (j ? T(1) : T(-1)) * wl;
    gf[2] += gw * wi * wj * (l ? T(1) : T(-1));
  }
  const T inv_dx = T(g.inv_dx);
  gpl.x += k.fx_free[0] ? gf[0] * inv_dx : T(0);
  gpl.y += k.fx_free[1] ? gf[1] * inv_dx : T(0);
  gpl.z += k.fx_free[2] ? gf[2] * inv_dx : T(0);

  // pl = rot(nw, -nv; r)
  T gnw2 = T(0);
  V3<T> gnvc = {T(0), T(0), T(0)};
  V3<T> gr = {T(0), T(0), T(0)};
  const V3<T> nv_conj = {-b.nv.x, -b.nv.y, -b.nv.z};
  qrot_adjoint(b.nw, nv_conj, k.r, gpl, gnw2, gnvc, gr);
  gnw += gnw2;
  gnv = gnv - gnvc;
  // r = x - bp
  gx = gr;
  // (nw, nv) = q qn_inv
  const T qg = b.qw * gnw + dot(b.qv, gnv);
  const T inv3 = b.qn_inv * b.qn_inv * b.qn_inv;
  gqw += gnw * b.qn_inv - b.qw * qg * inv3;
  gqv = gqv + gnv * b.qn_inv - b.qv * (qg * inv3);

  gbody[0] = -gr.x;
  gbody[1] = -gr.y;
  gbody[2] = -gr.z;
  gbody[3] = gqw;
  gbody[4] = gqv.x;
  gbody[5] = gqv.y;
  gbody[6] = gqv.z;
  gbody[7] = gvl.x;
  gbody[8] = gvl.y;
  gbody[9] = gvl.z;
  gbody[10] = gbw.x;
  gbody[11] = gbw.y;
  gbody[12] = gbw.z;
}

// ---------------------------------------------------------------------------
// Forecast mixed contact, shared by the merged kernel and the two split
// kernels of contact_mixed.cu. Same math as pallas_contact._mixed1_math /
// _mixed2_math and contact._collide_mixed_xla of the JAX package:
// stage 1 samples the SDF at x, applies the friction-cone response to
// particles approaching the body within the contact threshold and
// forecasts x_new = x + dt p_v1; stage 2 samples at x_new against the SAME
// stencil row (fractions relative to base(x), unclamped; in_box of x_new)
// and pushes penetrating particles out along that normal over the rest of
// the window. The body floats are load_body's 14 followed by softness and
// life.
// ---------------------------------------------------------------------------

template <class T>
struct Mixed1 {
  V3<T> pv1, xnew;
  T dist;
};

// Stage 1 on the stencil row e of the cell c at base(x).
template <class T>
__device__ __forceinline__ Mixed1<T> mixed_stage1(const Body<T>& b, T softness,
                                                  V3<T> xp, V3<T> vp,
                                                  const Cell<T>& cell,
                                                  const float4 e[8], T dt) {
  Mixed1<T> m;
  V3<T> u, n_loc;
  T nrm;
  const T sdf = trilinear(e, cell.fx, u);
  m.dist = finish_sample(sdf, u, cell.in_box, n_loc, nrm);
  const V3<T> D = qrot(b.qw, b.qv, n_loc);     // the raw quaternion
  const bool mask = m.dist <= T(kThreshold);
  const T dist_s = mask ? m.dist : T(0);

  const V3<T> nv_conj = {-b.nv.x, -b.nv.y, -b.nv.z};
  const V3<T> pl = qrot(b.nw, nv_conj, xp - b.bp);
  const V3<T> cv = qrot(b.nw, b.nv, b.bv + cross(b.bw, pl));
  const V3<T> in_v = vp - cv;
  const T nc = dot(in_v, D);
  m.pv1 = vp;
  if (mask && nc < T(0)) {
    V3<T> pvt = in_v - D * nc;
    const T pvt2 = dot(pvt, pvt);
    const T vt_norm = r_sqrt(pvt2 + T(1e-8));
    if (pvt2 > T(1e-60)) {
      pvt = pvt * (r_max(T(0), vt_norm + nc * b.friction) / vt_norm);
    }
    if (dist_s > T(0)) {
      const T influence = r_exp(-r_max(dist_s, T(0)) * softness);
      m.pv1 = cv + (in_v * (T(1) - influence) + pvt * influence);
    } else {
      m.pv1 = cv + pvt;
    }
  }
  m.xnew = xp + m.pv1 * dt;
  return m;
}

// Stage 2 from stage 1's outputs on the same stencil row. Writes p_v_out,
// the unmasked reaction force (v - p_v_out) p_mass / dt and the mask.
template <class T>
__device__ __forceinline__ void mixed_stage2(const Body<T>& b, T life,
                                             V3<T> vp, const Mixed1<T>& m,
                                             const Cell<T>& cell,
                                             const float4 e[8], const Geom& g,
                                             T dt, T p_mass, T push_cap,
                                             V3<T>& pv_out, V3<T>& force,
                                             bool& mask) {
  mask = m.dist <= T(kThreshold);
  pv_out = vp;
  if (mask) {
    const V3<T> nv_conj = {-b.nv.x, -b.nv.y, -b.nv.z};
    const V3<T> pl2 = qrot(b.nw, nv_conj, m.xnew - b.bp);
    const T lp[3] = {pl2.x, pl2.y, pl2.z};
    T fx[3];
    bool in_box = true;
    for (int d = 0; d < 3; ++d) {
      const T lower = T(g.lower[d]);
      in_box = in_box && (lp[d] >= lower) && (lp[d] < T(g.upper[d]));
      fx[d] = (lp[d] - lower) * T(g.inv_dx) - cell.basef[d];   // unclamped
    }
    V3<T> u, n_loc;
    T nrm;
    const T sdf2 = finish_sample(trilinear(e, fx, u), u, in_box, n_loc, nrm);
    const V3<T> n2 = qrot(b.qw, b.qv, n_loc);
    const T sdf2_s = sdf2 < T(0) ? sdf2 : T(0);
    T push = -(sdf2_s / dt) * life;           // >= 0: outward along n2
    if (isfinite(push_cap)) push = r_min(push, push_cap);
    pv_out = m.pv1 + n2 * push;
  }
  force = (vp - pv_out) * (p_mass / dt);
}

// ---------------------------------------------------------------------------
// Reverse sweeps of mixed_stage1 / mixed_stage2, written by hand (the JAX
// package traces jax.vjp of _mixed12_math inside its backward kernel). Each
// recomputes its stage's forward from the stencil row and walks it back.
// The tie rules are the plain version's under torch autograd:
// max(vt_norm + nc friction, 0) splits its cotangent in half at 0, the
// clamped stage-1 fractions pass it where unclamped (bounds included), the
// push cap passes it where push <= cap, and an untaken where() branch gets
// none. Body cotangents accumulate in BodyGrad: the raw quaternion (D and
// n2 rotate by it) and the normalised one (p_loc and the collider velocity)
// apart, folded into the 16 body floats by finish_body_grad.
// ---------------------------------------------------------------------------

template <class T>
struct BodyGrad {
  V3<T> bp;
  T qw;          // raw quaternion
  V3<T> qv;
  T nw;          // normalised quaternion
  V3<T> nv;
  V3<T> bv, bw;
  T friction, softness, life;
};

template <class T>
__device__ __forceinline__ BodyGrad<T> zero_body_grad() {
  const V3<T> z = {T(0), T(0), T(0)};
  return {z, T(0), z, T(0), z, z, z, T(0), T(0), T(0)};
}

// The 16 body cotangents [bp, bq wxyz, bv, bw, friction, softness, life]:
// the normalised quaternion's cotangent taken back through
// (nw, nv) = q / sqrt(|q|^2 + 1e-12) and added to the raw one's.
template <class T>
__device__ __forceinline__ void finish_body_grad(const Body<T>& b,
                                                 const BodyGrad<T>& gb,
                                                 T out[16]) {
  const T qg = b.qw * gb.nw + dot(b.qv, gb.nv);
  const T inv3 = b.qn_inv * b.qn_inv * b.qn_inv;
  const V3<T> gqv = gb.qv + gb.nv * b.qn_inv - b.qv * (qg * inv3);
  const T v[16] = {gb.bp.x, gb.bp.y, gb.bp.z,
                   gb.qw + gb.nw * b.qn_inv - b.qw * qg * inv3,
                   gqv.x, gqv.y, gqv.z,
                   gb.bv.x, gb.bv.y, gb.bv.z, gb.bw.x, gb.bw.y, gb.bw.z,
                   gb.friction, gb.softness, gb.life};
  for (int i = 0; i < 16; ++i) out[i] = v[i];
}

// Cotangents of the fractions fx (gf) from those of trilinear's sdf (gsdf)
// and unnormalised normal (gu).
template <class T>
__device__ __forceinline__ void trilinear_adjoint(const float4 e[8],
                                                  const T fx[3], T gsdf,
                                                  V3<T> gu, T gf[3]) {
  gf[0] = gf[1] = gf[2] = T(0);
  for (int c = 0; c < 8; ++c) {
    const int i = c >> 2, j = (c >> 1) & 1, l = c & 1;
    const T wi = i ? fx[0] : T(1) - fx[0];
    const T wj = j ? fx[1] : T(1) - fx[1];
    const T wl = l ? fx[2] : T(1) - fx[2];
    const T gw = gsdf * T(e[c].x) + gu.x * T(e[c].y) + gu.y * T(e[c].z)
                 + gu.z * T(e[c].w);
    gf[0] += gw * (i ? T(1) : T(-1)) * wj * wl;
    gf[1] += gw * wi * (j ? T(1) : T(-1)) * wl;
    gf[2] += gw * wi * wj * (l ? T(1) : T(-1));
  }
}

// n = u / sqrt(|u|^2 + 1e-14): the cotangent of u from that of n.
template <class T>
__device__ __forceinline__ V3<T> normalize_adjoint(V3<T> u, T nrm, V3<T> gn) {
  const T inv = T(1) / nrm;
  return gn * inv - u * (dot(u, gn) * inv * inv * inv);
}

// p_loc = rot(qnorm(conj(q)), r), r = xp - bp: adds the cotangents of xp
// (returned) and of bp and the normalised quaternion to gb.
template <class T>
__device__ __forceinline__ V3<T> to_local_adjoint(const Body<T>& b, V3<T> r,
                                                  V3<T> gpl, BodyGrad<T>& gb) {
  T gnw = T(0);
  V3<T> gnvc = {T(0), T(0), T(0)};
  V3<T> gr = {T(0), T(0), T(0)};
  const V3<T> nv_conj = {-b.nv.x, -b.nv.y, -b.nv.z};
  qrot_adjoint(b.nw, nv_conj, r, gpl, gnw, gnvc, gr);
  gb.nw += gnw;
  gb.nv = gb.nv - gnvc;
  gb.bp = gb.bp - gr;
  return gr;
}

// Reverse of mixed_stage2 for the cotangents of p_v_out (gout) and of the
// unmasked force (gforce): adds the cotangents of v, p_v1 and x_new (the
// forecast point) and of the body floats.
template <class T>
__device__ __forceinline__ void mixed_stage2_backward(
    const Body<T>& b, T life, V3<T> vp, const Mixed1<T>& m,
    const Cell<T>& cell, const float4 e[8], const Geom& g, T dt, T p_mass,
    T push_cap, V3<T> gout, V3<T> gforce, V3<T>& gv, V3<T>& gpv1,
    V3<T>& gxnew, BodyGrad<T>& gb) {
  // force = (v - p_v_out) p_mass / dt
  const T k = p_mass / dt;
  gv = gv + gforce * k;
  const V3<T> gpo = gout - gforce * k;
  if (!(m.dist <= T(kThreshold))) {     // p_v_out = v
    gv = gv + gpo;
    return;
  }
  const V3<T> nv_conj = {-b.nv.x, -b.nv.y, -b.nv.z};
  const V3<T> r2 = m.xnew - b.bp;
  const V3<T> pl2 = qrot(b.nw, nv_conj, r2);
  const T lp[3] = {pl2.x, pl2.y, pl2.z};
  T fx[3];
  bool in_box = true;
  for (int d = 0; d < 3; ++d) {
    const T lower = T(g.lower[d]);
    in_box = in_box && (lp[d] >= lower) && (lp[d] < T(g.upper[d]));
    fx[d] = (lp[d] - lower) * T(g.inv_dx) - cell.basef[d];   // unclamped
  }
  V3<T> u, n_loc;
  T nrm;
  const T sdf2 = finish_sample(trilinear(e, fx, u), u, in_box, n_loc, nrm);
  const V3<T> n2 = qrot(b.qw, b.qv, n_loc);
  const bool pen = sdf2 < T(0);
  const T sdf2_s = pen ? sdf2 : T(0);
  const T push_raw = -(sdf2_s / dt) * life;
  const bool capped = isfinite(push_cap) && push_raw > push_cap;
  const T push = capped ? push_cap : push_raw;

  // p_v_out = p_v1 + n2 push
  gpv1 = gpv1 + gpo;
  const V3<T> gn2 = gpo * push;
  const T gpush = capped ? T(0) : dot(gpo, n2);
  gb.life += -gpush * sdf2_s / dt;
  const T gsdf = pen ? -gpush * life / dt : T(0);
  // n2 = rot(q, n_loc), the raw quaternion
  V3<T> gn = {T(0), T(0), T(0)};
  qrot_adjoint(b.qw, b.qv, n_loc, gn2, gb.qw, gb.qv, gn);
  if (!in_box) return;                  // BIG and (0, 1, 0): constants
  T gf[3];
  trilinear_adjoint(e, fx, gsdf, normalize_adjoint(u, nrm, gn), gf);
  const T inv_dx = T(g.inv_dx);
  const V3<T> gpl = {gf[0] * inv_dx, gf[1] * inv_dx, gf[2] * inv_dx};
  gxnew = gxnew + to_local_adjoint(b, r2, gpl, gb);
}

// Reverse of mixed_stage1 for the cotangent of p_v1 (gpv1): adds the
// cotangents of x, v and the body floats. x_new's cotangent is the
// caller's (x_new = x + dt p_v1).
template <class T>
__device__ __forceinline__ void mixed_stage1_backward(
    const Body<T>& b, T softness, V3<T> xp, V3<T> vp, const Cell<T>& cell,
    const float4 e[8], const Geom& g, V3<T> gpv1, V3<T>& gx, V3<T>& gv,
    BodyGrad<T>& gb) {
  V3<T> u, n_loc;
  T nrm;
  const T sdf = trilinear(e, cell.fx, u);
  const T dist = finish_sample(sdf, u, cell.in_box, n_loc, nrm);
  const V3<T> D = qrot(b.qw, b.qv, n_loc);
  const V3<T> nv_conj = {-b.nv.x, -b.nv.y, -b.nv.z};
  const V3<T> r = xp - b.bp;
  const V3<T> pl = qrot(b.nw, nv_conj, r);
  const V3<T> vl = b.bv + cross(b.bw, pl);
  const V3<T> cv = qrot(b.nw, b.nv, vl);
  const V3<T> in_v = vp - cv;
  const T nc = dot(in_v, D);
  if (!(dist <= T(kThreshold) && nc < T(0))) {     // p_v1 = v
    gv = gv + gpv1;
    return;
  }
  const V3<T> pvt = in_v - D * nc;
  const T pvt2 = dot(pvt, pvt);
  const T vt_norm = r_sqrt(pvt2 + T(1e-8));
  const bool flag = pvt2 > T(1e-60);
  const T a = vt_norm + nc * b.friction;
  const T ra = r_max(a, T(0));
  const T sc = ra / vt_norm;
  const V3<T> pvtf = flag ? pvt * sc : pvt;

  // p_v1 = cv + in_v (1 - infl) + pvtf infl  (soft band, dist > 0), or
  //        cv + pvtf
  V3<T> gcv = gpv1;
  V3<T> gin_v = {T(0), T(0), T(0)};
  V3<T> gpvtf = gpv1;
  T gdist = T(0);
  if (dist > T(0)) {
    // infl = exp(-max(dist, 0) softness): max passes all of it at dist > 0
    const T infl = r_exp(-dist * softness);
    gin_v = gpv1 * (T(1) - infl);
    gpvtf = gpv1 * infl;
    const T garg = dot(gpv1, pvtf - in_v) * infl;
    gdist = -garg * softness;
    gb.softness += -garg * dist;
  }
  // pvtf = pvt max(a, 0) / vt_norm where flag, a = vt_norm + nc friction
  V3<T> gpvt = gpvtf;
  T gnc = T(0);
  if (flag) {
    gpvt = gpvtf * sc;
    const T gsc = dot(gpvtf, pvt);
    const T gra = gsc / vt_norm;
    T gvt = -gsc * ra / (vt_norm * vt_norm);
    const T ga = a > T(0) ? gra : (a < T(0) ? T(0) : T(0.5) * gra);
    gvt += ga;
    gnc += ga * b.friction;
    gb.friction += ga * nc;
    gpvt = gpvt + pvt * (gvt / vt_norm);          // vt_norm = |pvt|_1e-8
  }
  // pvt = in_v - D nc, nc = in_v . D
  gin_v = gin_v + gpvt;
  V3<T> gD = V3<T>{T(0), T(0), T(0)} - gpvt * nc;
  gnc -= dot(gpvt, D);
  gin_v = gin_v + D * gnc;
  gD = gD + in_v * gnc;
  // in_v = v - cv
  gv = gv + gin_v;
  gcv = gcv - gin_v;
  // cv = rot(qnorm(q), vl), vl = bv + bw x pl
  V3<T> gvl = {T(0), T(0), T(0)};
  qrot_adjoint(b.nw, b.nv, vl, gcv, gb.nw, gb.nv, gvl);
  gb.bv = gb.bv + gvl;
  gb.bw = gb.bw + cross(pl, gvl);
  V3<T> gpl = cross(gvl, b.bw);
  // D = rot(q, n_loc), the raw quaternion; n_loc = u / |u| (in the box:
  // the mask holds)
  V3<T> gn = {T(0), T(0), T(0)};
  qrot_adjoint(b.qw, b.qv, n_loc, gD, gb.qw, gb.qv, gn);
  T gf[3];
  trilinear_adjoint(e, cell.fx, gdist, normalize_adjoint(u, nrm, gn), gf);
  const T inv_dx = T(g.inv_dx);
  gpl.x += cell.fx_free[0] ? gf[0] * inv_dx : T(0);
  gpl.y += cell.fx_free[1] ? gf[1] * inv_dx : T(0);
  gpl.z += cell.fx_free[2] ? gf[2] * inv_dx : T(0);
  gx = gx + to_local_adjoint(b, r, gpl, gb);
}

}  // namespace softmac
