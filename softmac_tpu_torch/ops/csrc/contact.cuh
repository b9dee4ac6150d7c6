// Per-particle penalty contact against one SDF primitive, forward and
// reverse, shared by contact.cu and contact_bwd.cu. Same math as
// pallas_contact._particle_math and engine.contact._collide_particle_xla
// of the JAX package:
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
// The math is a template on the scalar type T. The forward kernel runs it
// in float. The backward kernel runs it in double on the float inputs:
// the normal's derivative divides by |u|^2, |u| the trilinear normal
// before normalisation, which is short near the SDF's medial surface, so
// float rounding of u alone moved the position cotangent by up to 4e-5 of
// its largest value (measured on the H100 against the float64 plain vjp);
// in double the cotangent is the one of the float inputs, rounded once.
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

template <class T>
__device__ __forceinline__ Contact<T> contact_forward(
    const Body<T>& b, V3<T> xp, V3<T> vp, const float4* __restrict__ table,
    const Geom& g, T dt, T p_mass) {
  Contact<T> k;
  const V3<T> nv_conj = {-b.nv.x, -b.nv.y, -b.nv.z};   // qnorm(conj(q))
  k.r = xp - b.bp;
  k.pl = qrot(b.nw, nv_conj, k.r);

  // cell index and fractions, as pallas_contact._cell_index / _local_and_fx
  const T lp[3] = {k.pl.x, k.pl.y, k.pl.z};
  int base[3];
  k.in_box = true;
  for (int d = 0; d < 3; ++d) {
    const T lower = T(g.lower[d]);
    k.in_box = k.in_box && (lp[d] >= lower) && (lp[d] < T(g.upper[d]));
    const T pos = (lp[d] - lower) * T(g.inv_dx);
    const T bf = r_min(r_max(r_floor(pos), T(0)), T(g.res[d] - 2));
    base[d] = static_cast<int>(bf);
    const T f = pos - bf;
    k.fx_free[d] = f >= T(0) && f <= T(1);
    k.fx[d] = r_min(r_max(f, T(0)), T(1));
  }
  const long long cell =
      (static_cast<long long>(base[0]) * g.res[1] + base[1]) * g.res[2] + base[2];
  const float4* row = table + cell * 8;  // 32 floats = 8 float4

  // trilinear over corners c = 4i + 2j + k, each [sdf, nx, ny, nz]
  T sdf = T(0);
  k.u = {T(0), T(0), T(0)};
  for (int c = 0; c < 8; ++c) {
    const int i = c >> 2, j = (c >> 1) & 1, l = c & 1;
    const T wi = i ? k.fx[0] : T(1) - k.fx[0];
    const T wj = j ? k.fx[1] : T(1) - k.fx[1];
    const T wl = l ? k.fx[2] : T(1) - k.fx[2];
    const T w = wi * wj * wl;
    k.e[c] = __ldg(row + c);
    sdf += w * T(k.e[c].x);
    k.u.x += w * T(k.e[c].y);
    k.u.y += w * T(k.e[c].z);
    k.u.z += w * T(k.e[c].w);
  }
  k.nrm = r_sqrt(k.u.x * k.u.x + k.u.y * k.u.y + k.u.z * k.u.z + T(1e-14));
  k.n_loc = k.in_box ? V3<T>{k.u.x / k.nrm, k.u.y / k.nrm, k.u.z / k.nrm}
                     : V3<T>{T(0), T(1), T(0)};
  const T dist = k.in_box ? sdf : T(kBigContact);
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

}  // namespace softmac
