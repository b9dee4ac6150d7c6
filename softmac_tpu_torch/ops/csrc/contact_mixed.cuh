// The tiled contact kernels' skeleton and its per-particle ops: the
// forecast mixed contact (contact_mixed.cu, contact_mixed_bwd.cu, and the
// split pair's shared pieces) and the penalty particle contact
// (contact.cu, contact_bwd.cu). The math is contact.cuh's (mixed_stage1 /
// mixed_stage2 and contact_forward, and their reverse sweeps), in double
// on the float inputs (contact_mixed.cu and contact.cu say why).
//
// The tiled design. A block of kMixedThreads threads takes a tile of
// consecutive particles (PER a thread: the forwards kMixedPer, 2, whose
// kernels keep two blocks an SM, the backwards kMixedBwdPer, 4, whose
// reverse sweeps need one block's registers; measured for the mixed pair
// by scripts/mixed_variants.py and for the penalty pair by scripts/
// contact_phases.py, which found the same tiles) and runs
// mixed_tiled<Op, PER>, where Op is
// the per-particle op (MixedFwdOp, MixedBwdOp, PenaltyFwdOp,
// PenaltyBwdOp), with a barrier between each phase (the host tests in
// tests/test_torch_kernel_source.py run each phase over all threads of a
// block before the next, as the barriers order them):
//   classify         each particle's body-frame point, cell and the SDF
//                    lane of its stencil row only (mixed_classify), a
//                    thread's particles staged so that their loads are in
//                    flight together, the body floats (16 mixed, 14
//                    penalty) read where the rollout keeps them (no
//                    packing). A particle out of the contact band then
//                    writes its exact result (Op::out_of_band; mixed
//                    forward: p_v_out = v, backward: dx = 0, dv = gout;
//                    penalty forward: imp = 0, backward: dx = dv = 0,
//                    reading neither v nor a cotangent) and nothing else;
//   compact          each warp's ballot of the band particles of a 32-
//                    particle chunk (mask[chunk]), one thread's exclusive
//                    scan over the chunks in tile order (mixed_scan), and
//                    each band particle's slot in the list (mixed_place):
//                    the list holds the band in tile order, with no
//                    atomics, so the order is fixed;
//   full math        the block's threads take the list's entries in turn
//                    (entry i goes to thread i mod the block) and run the
//                    whole contact, its wrench share (forward) or its
//                    reverse with the wrench's reverse folded in
//                    (backward), Op::particle, summing K doubles each in a
//                    column of shared memory (registers are the reverse
//                    sweep's);
//   reduce           a shuffle tree in each warp, then the warps' sums in
//                    warp order (mixed_block_sum) to the block's column of
//                    the (K, blocks) float64 partials;
//   last block       the block that finishes last (a __threadfence and
//                    the launch's counter, which it resets) sums the
//                    partials the same way:
//                    thread t those of blocks t, t + 256, ... in order, then
//                    the trees and the warps (mixed_gather_partials), and
//                    rounds each value to float32 once (mixed_total).
// Every sum is taken in a fixed order, so repeated calls are bit-identical.
//
// The finished-block counter (MixedArgs::done, one unsigned, zero before a
// launch) is the caller's: the last block sets it back to zero. Two
// launches may share a counter only when one ends before the other starts,
// as launches on one stream do; the wrappers in ops/contact.py keep one
// counter for each stream (a CUDA graph keeps its capturing stream's, so
// it must not replay beside that stream's own launches). A launch that
// faults leaves it non-zero, but a fault also ends the CUDA context, so no
// later launch reads it.
//
// The band test is conservative, and one rule serves both contacts.
// mixed_stage1's mask is dist(x) <= 5e-3, contact_forward's dist(x) - 5e-3
// < 0, both on the trilinear sample of the cell at base(x), BIG outside
// the table's box.
// mixed_classify computes the same body-frame point and cell with the same
// expressions, the SDF lane with trilinear's sdf sum, and calls a particle
// out only when that sum exceeds 5e-3 + kBandMargin or the point lies
// kBandMargin or more outside the box. kBandMargin is 1e-6 m: the two
// computations differ by FMA contraction and the order nvcc gives them,
// which moves the point and the sum by about 1e-16 m (double rounding at
// coordinates below 1 m and SDF values below 1 m; the trilinear sample is
// continuous across cell faces, so a base cell that flips at a face moves
// it no further), ten orders of magnitude below the margin. A particle the
// test keeps runs the full math, whose own mask decides: the margin costs
// only the particles within 1 um of the band's edge.
#pragma once

#include "contact.cuh"

namespace softmac {

template <class S>
__device__ __forceinline__ V3<double> load3(const S* __restrict__ a, int n,
                                            int p) {
  return {double(a[p]), double(a[n + p]), double(a[2 * n + p])};
}

template <class S>
__device__ __forceinline__ void store3(S* __restrict__ a, int n, int p,
                                       V3<double> v) {
  a[p] = static_cast<S>(v.x);
  a[n + p] = static_cast<S>(v.y);
  a[2 * n + p] = static_cast<S>(v.z);
}

// the body, the particle's cell at base(x) and its stencil row; body holds
// the 16 floats [bp, bq wxyz, bv, bw, friction, softness, life]
struct MixedParticle {
  Body<double> b;
  double softness, life;
  Cell<double> cell;
  float4 e[8];
};

__device__ __forceinline__ MixedParticle load_mixed_particle(
    const float* __restrict__ body, V3<double> xp,
    const float4* __restrict__ table, const Geom& g) {
  MixedParticle q;
  q.b = load_body<double>(body);
  q.softness = body[14];
  q.life = body[15];
  const V3<double> nv_conj = {-q.b.nv.x, -q.b.nv.y, -q.b.nv.z};
  q.cell = locate(qrot(q.b.nw, nv_conj, xp - q.b.bp), table, g);
  for (int c = 0; c < 8; ++c) q.e[c] = __ldg(q.cell.row + c);
  return q;
}

// One particle's merged reverse (stage 2's, then stage 1's through x_new =
// x + dt p_v1) for the cotangents of p_v_out (gout) and of the unmasked
// force (gforce): the cotangents of x and v and the body's in gbody.
__device__ __forceinline__ void mixed_reverse(
    const MixedParticle& q, V3<double> xp, V3<double> vp,
    const Mixed1<double>& m, V3<double> gout, V3<double> gforce,
    const Geom& g, double dt, double p_mass, double push_cap,
    V3<double>& gx, V3<double>& gv, BodyGrad<double>& gbody) {
  const V3<double> zero = {0.0, 0.0, 0.0};
  V3<double> gpv1 = zero, gxnew = zero;
  gv = zero;
  mixed_stage2_backward(q.b, q.life, vp, m, q.cell, q.e, g, dt, p_mass,
                        push_cap, gout, gforce, gv, gpv1, gxnew, gbody);
  gx = gxnew;
  gpv1 = gpv1 + gxnew * dt;
  mixed_stage1_backward(q.b, q.softness, xp, vp, q.cell, q.e, g, gpv1, gx,
                        gv, gbody);
}

// ---------------------------------------------------------------------------
// The tiled kernels
// ---------------------------------------------------------------------------

constexpr int kMixedThreads = 256;
constexpr int kMixedWarps = kMixedThreads / 32;
constexpr int kMixedPer = 2;      // particles a thread, both forwards
constexpr int kMixedBwdPer = 4;   // and both backwards
constexpr int kMixedMaxTile =
    (kMixedPer > kMixedBwdPer ? kMixedPer : kMixedBwdPer) * kMixedThreads;
constexpr int kMixedMaxChunks = kMixedMaxTile / 32;
constexpr double kBandMargin = 1e-6;

// The tiled kernels' output type: float on the card. The host tests build
// them with double outputs (SOFTMAC_MIXED_OUT=double), to hold the math
// before its one rounding to the float64 plain version.
#ifndef SOFTMAC_MIXED_OUT
#define SOFTMAC_MIXED_OUT float
#endif
using MixedOut = SOFTMAC_MIXED_OUT;

// The rollout's body tensors, read where they lie (the penalty contact
// has no softness and life: null)
struct MixedBody {
  const float* bp;
  const float* bq;
  const float* bv;
  const float* bw;
  const float* friction;
  const float* softness;
  const float* life;
};

// Everything a tiled launch reads and writes. Forward: out0 = p_v_out
// (mixed) or the impulse (penalty), total = wrench (6,), K = 6. Backward:
// gout (the cotangent of out0), gwrench (6,) in, out0 = dx, out1 = dv,
// total = the body cotangents (K: 16 mixed, 14 penalty; the penalty
// backward reads a null gout or gwrench as zero). done: the launch's
// finished-block counter (see the header).
struct MixedArgs {
  const float* x;
  const float* v;
  const float4* table;
  MixedBody body;
  const float* gout;
  const float* gwrench;
  MixedOut* out0;
  MixedOut* out1;
  MixedOut* total;
  double* partial;    // (K, blocks)
  unsigned* done;
  int n;
  Geom g;
  double dt, p_mass, push_cap;
};

struct MixedShared {
  float body[16];
  unsigned mask[kMixedMaxChunks];   // the band particles of each chunk
  int first[kMixedMaxChunks];       // each chunk's first slot in list
  int count;                        // band particles of the tile
  int list[kMixedMaxTile];          // their tile indices, in tile order
  double red[kMixedWarps][16];      // each warp's sums
  int last;                         // this block finished last
};

// The B body floats [bp, bq wxyz, bv, bw, friction] and, where B is 16,
// [softness, life], read where the rollout keeps them (no packing)
template <int B>
__device__ __forceinline__ void mixed_body_floats(const MixedArgs& a,
                                                  float body[16]) {
  for (int i = 0; i < 3; ++i) {
    body[i] = a.body.bp[i];
    body[7 + i] = a.body.bv[i];
    body[10 + i] = a.body.bw[i];
  }
  for (int i = 0; i < 4; ++i) body[3 + i] = a.body.bq[i];
  body[13] = *a.body.friction;
  if constexpr (B == 16) {
    body[14] = *a.body.softness;
    body[15] = *a.body.life;
  }
}

// phase 1: may the particles p + j * stride (j < PER) lie in the contact
// band? (See the header: false only where the contact's mask cannot
// hold.) Staged so that the loads are in flight together, a
// round trip each stage: the body, every x and what an out-of-band
// particle copies (keep, where Op::kKeep: v for the mixed forward, gout
// for its backward) first, then every cell
// and its stencil row's SDF lane, then the sums. Loads only and no branch
// (a particle past n reads the last one's inputs and is out), so no output
// is written before all are classified. The point, the cell and the sum
// are mixed_stage1's and contact_forward's expressions (locate,
// trilinear's sdf lane). Thread t < Op::kBody also puts body float t in
// shared memory for the full math.
template <class Op, int PER>
__device__ __forceinline__ void mixed_classify(const MixedArgs& a,
                                               MixedShared* sh, int p,
                                               int stride, bool band[PER],
                                               float keep[PER][3]) {
  float body[16];
  mixed_body_floats<Op::kBody>(a, body);
  V3<double> xp[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int q = p + j * stride < a.n ? p + j * stride : a.n - 1;
    xp[j] = load3(a.x, a.n, q);
    if constexpr (Op::kKeep) {
      const float* src = Op::keep_src(a);
      for (int d = 0; d < 3; ++d) keep[j][d] = src[d * a.n + q];
    }
  }
  if (threadIdx.x < Op::kBody) sh->body[threadIdx.x] = body[threadIdx.x];
  const Body<double> b = load_body<double>(body);
  const V3<double> nv_conj = {-b.nv.x, -b.nv.y, -b.nv.z};
  const float4* row[PER];
  double fx[PER][3];
  bool near[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const V3<double> pl = qrot(b.nw, nv_conj, xp[j] - b.bp);
    const Cell<double> cell = locate(pl, a.table, a.g);
    const double lp[3] = {pl.x, pl.y, pl.z};
    near[j] = p + j * stride < a.n;
    for (int d = 0; d < 3; ++d) {
      fx[j][d] = cell.fx[d];
      near[j] = near[j] && lp[d] >= double(a.g.lower[d]) - kBandMargin
                && lp[d] < double(a.g.upper[d]) + kBandMargin;
    }
    row[j] = cell.row;
  }
  float e[PER][8];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    for (int c = 0; c < 8; ++c) e[j][c] = __ldg(&row[j][c].x);
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    double sdf = 0.0;
    for (int c = 0; c < 8; ++c) {
      const int i = c >> 2, k = (c >> 1) & 1, l = c & 1;
      const double wi = i ? fx[j][0] : 1.0 - fx[j][0];
      const double wk = k ? fx[j][1] : 1.0 - fx[j][1];
      const double wl = l ? fx[j][2] : 1.0 - fx[j][2];
      sdf += wi * wk * wl * double(e[j][c]);
    }
    band[j] = near[j] && sdf <= kThreshold + kBandMargin;
  }
}

// phase 2 (one thread): each chunk's first slot, in tile order
__device__ __forceinline__ void mixed_scan(MixedShared* sh, int chunks) {
  int s = 0;
  for (int c = 0; c < chunks; ++c) {
    sh->first[c] = s;
    s += __popc(sh->mask[c]);
  }
  sh->count = s;
}

// phase 3: the slot of tile particle q = 32 chunk + lane
__device__ __forceinline__ void mixed_place(MixedShared* sh, int chunk,
                                            int lane) {
  const unsigned m = sh->mask[chunk];
  if (m >> lane & 1u) {
    sh->list[sh->first[chunk] + __popc(m & ((1u << lane) - 1u))] =
        32 * chunk + lane;
  }
}

// phase 4, forward: particle p's p_v_out, and its masked force and the
// torque about bp added to the thread's sums acc[k * stride]
// (pallas_contact._tail12)
__device__ __forceinline__ void mixed_particle_fwd(const MixedArgs& a,
                                                   const float* body, int p,
                                                   double* acc, int stride) {
  const V3<double> xp = load3(a.x, a.n, p), vp = load3(a.v, a.n, p);
  const MixedParticle q = load_mixed_particle(body, xp, a.table, a.g);
  const Mixed1<double> m = mixed_stage1(q.b, q.softness, xp, vp, q.cell, q.e,
                                        double(a.dt));
  V3<double> out, f;
  bool mask;
  mixed_stage2(q.b, q.life, vp, m, q.cell, q.e, a.g, double(a.dt),
               double(a.p_mass), double(a.push_cap), out, f, mask);
  store3(a.out0, a.n, p, out);
  if (mask) {
    const V3<double> t = cross(xp - q.b.bp, f);
    const double w[6] = {f.x, f.y, f.z, t.x, t.y, t.z};
    for (int k = 0; k < 6; ++k) acc[k * stride] += w[k];
  }
}

// phase 4, backward: particle p's dx, dv and its 16 body cotangents added
// to acc[k * stride]. The wrench's reverse is folded in: with r = x - bp
// and the masked force f, the force's cotangent is gF + gT x r and r's is
// f x gT, which goes to x and, negated, to bp (pallas_contact.
// _fused12_factory's g_x_t, g_bp_t).
__device__ __forceinline__ void mixed_particle_bwd(const MixedArgs& a,
                                                   const float* body, int p,
                                                   double* acc, int stride) {
  const V3<double> xp = load3(a.x, a.n, p), vp = load3(a.v, a.n, p);
  const MixedParticle q = load_mixed_particle(body, xp, a.table, a.g);
  const double dt = a.dt, p_mass = a.p_mass, cap = a.push_cap;
  const Mixed1<double> m = mixed_stage1(q.b, q.softness, xp, vp, q.cell, q.e,
                                        dt);
  V3<double> out, f;
  bool mask;
  mixed_stage2(q.b, q.life, vp, m, q.cell, q.e, a.g, dt, p_mass, cap, out,
               f, mask);
  const V3<double> zero = {0.0, 0.0, 0.0};
  V3<double> gforce = zero, gr = zero;
  if (mask) {
    const V3<double> gF = {double(a.gwrench[0]), double(a.gwrench[1]),
                           double(a.gwrench[2])};
    const V3<double> gT = {double(a.gwrench[3]), double(a.gwrench[4]),
                           double(a.gwrench[5])};
    gforce = gF + cross(gT, xp - q.b.bp);
    gr = cross(f, gT);
  }
  BodyGrad<double> gbody = zero_body_grad<double>();
  V3<double> gx, gv;
  mixed_reverse(q, xp, vp, m, load3(a.gout, a.n, p), gforce, a.g, dt, p_mass,
                cap, gx, gv, gbody);
  gx = gx + gr;
  gbody.bp = gbody.bp - gr;
  double gb[16];
  finish_body_grad(q.b, gbody, gb);
  store3(a.out0, a.n, p, gx);
  store3(a.out1, a.n, p, gv);
  for (int k = 0; k < 16; ++k) acc[k * stride] += gb[k];
}

// phase 4, penalty forward: particle p's impulse (contact_forward in
// double), and where its mask holds its reaction force b_f = -imp / dt
// and the torque about bp added to the thread's sums acc[k * stride]
// (pallas_contact._tail_particle)
__device__ __forceinline__ void penalty_particle_fwd(const MixedArgs& a,
                                                     const float* body, int p,
                                                     double* acc,
                                                     int stride) {
  const V3<double> xp = load3(a.x, a.n, p), vp = load3(a.v, a.n, p);
  const Body<double> b = load_body<double>(body);
  const double dt = a.dt;
  const Contact<double> k =
      contact_forward(b, xp, vp, a.table, a.g, dt, double(a.p_mass));
  store3(a.out0, a.n, p, k.imp);
  if (k.mask) {
    const V3<double> f = k.imp * (-1.0 / dt);
    const V3<double> t = cross(k.r, f);
    const double w[6] = {f.x, f.y, f.z, t.x, t.y, t.z};
    for (int i = 0; i < 6; ++i) acc[i * stride] += w[i];
  }
}

// phase 4, penalty backward: particle p's dx, dv and its 14 body
// cotangents added to acc[k * stride], the wrench's reverse folded in.
// With r = x - bp and b_f = -imp / dt, the impulse's cotangent is
// gimp - (gF + gT x r) / dt on the mask, and r's is b_f x gT, which goes
// to x and, negated, to bp (the vjp of _tail_particle in
// pallas_contact._particle_factory's _bwd). Out of contact (mask false)
// every cotangent is zero, as contact_backward's.
__device__ __forceinline__ void penalty_particle_bwd(const MixedArgs& a,
                                                     const float* body, int p,
                                                     double* acc,
                                                     int stride) {
  const V3<double> xp = load3(a.x, a.n, p), vp = load3(a.v, a.n, p);
  const Body<double> b = load_body<double>(body);
  const double dt = a.dt, p_mass = a.p_mass;
  const Contact<double> k = contact_forward(b, xp, vp, a.table, a.g, dt,
                                            p_mass);
  const V3<double> zero = {0.0, 0.0, 0.0};
  if (!k.mask) {
    store3(a.out0, a.n, p, zero);
    store3(a.out1, a.n, p, zero);
    return;
  }
  V3<double> gi = a.gout ? load3(a.gout, a.n, p) : zero;
  V3<double> gr = zero;
  if (a.gwrench) {
    const V3<double> gF = {double(a.gwrench[0]), double(a.gwrench[1]),
                           double(a.gwrench[2])};
    const V3<double> gT = {double(a.gwrench[3]), double(a.gwrench[4]),
                           double(a.gwrench[5])};
    const double inv = -1.0 / dt;
    gi = gi + (gF + cross(gT, k.r)) * inv;
    gr = cross(k.imp * inv, gT);
  }
  V3<double> gx, gv;
  double gb[14];
  contact_backward(b, k, gi, a.g, dt, p_mass, gx, gv, gb);
  store3(a.out0, a.n, p, gx + gr);
  store3(a.out1, a.n, p, gv);
  gb[0] -= gr.x;
  gb[1] -= gr.y;
  gb[2] -= gr.z;
  for (int i = 0; i < 14; ++i) acc[i * stride] += gb[i];
}

// The per-particle ops of mixed_tiled: K sums a block, kBody body floats,
// whether an out-of-band particle's result copies 3 floats of each
// particle (kKeep, from keep_src, which only such an op has), that result
// (out_of_band, for particle p < n or nothing) and the band's full math
// (particle).
struct MixedFwdOp {
  static constexpr int K = 6, kBody = 16;
  static constexpr bool kKeep = true;
  __device__ static const float* keep_src(const MixedArgs& a) { return a.v; }
  __device__ static void out_of_band(const MixedArgs& a, int p,
                                     const float keep[3]) {
    if (p >= a.n) return;
    for (int d = 0; d < 3; ++d) a.out0[d * a.n + p] = keep[d];
  }
  __device__ static void particle(const MixedArgs& a, const float* body,
                                  int p, double* acc, int stride) {
    mixed_particle_fwd(a, body, p, acc, stride);
  }
};

struct MixedBwdOp {
  static constexpr int K = 16, kBody = 16;
  static constexpr bool kKeep = true;
  __device__ static const float* keep_src(const MixedArgs& a) {
    return a.gout;
  }
  __device__ static void out_of_band(const MixedArgs& a, int p,
                                     const float keep[3]) {
    if (p >= a.n) return;
    for (int d = 0; d < 3; ++d) {
      a.out0[d * a.n + p] = MixedOut(0);
      a.out1[d * a.n + p] = keep[d];
    }
  }
  __device__ static void particle(const MixedArgs& a, const float* body,
                                  int p, double* acc, int stride) {
    mixed_particle_bwd(a, body, p, acc, stride);
  }
};

struct PenaltyFwdOp {
  static constexpr int K = 6, kBody = 14;
  static constexpr bool kKeep = false;
  __device__ static void out_of_band(const MixedArgs& a, int p,
                                     const float*) {
    if (p >= a.n) return;
    for (int d = 0; d < 3; ++d) a.out0[d * a.n + p] = MixedOut(0);
  }
  __device__ static void particle(const MixedArgs& a, const float* body,
                                  int p, double* acc, int stride) {
    penalty_particle_fwd(a, body, p, acc, stride);
  }
};

struct PenaltyBwdOp {
  static constexpr int K = 14, kBody = 14;
  static constexpr bool kKeep = false;
  __device__ static void out_of_band(const MixedArgs& a, int p,
                                     const float*) {
    if (p >= a.n) return;
    for (int d = 0; d < 3; ++d) {
      a.out0[d * a.n + p] = MixedOut(0);
      a.out1[d * a.n + p] = MixedOut(0);
    }
  }
  __device__ static void particle(const MixedArgs& a, const float* body,
                                  int p, double* acc, int stride) {
    penalty_particle_bwd(a, body, p, acc, stride);
  }
};

// Value k's sum over the block once each warp's is in red[warp][k]: the
// warps in order
__device__ __forceinline__ double mixed_warps_sum(const MixedShared* sh,
                                                  int k) {
  double s = 0.0;
  for (int w = 0; w < kMixedWarps; ++w) s += sh->red[w][k];
  return s;
}

// phase 5 (after the warps' trees): thread k < K writes the block's
// partial of value k
template <int K>
__device__ __forceinline__ void mixed_block_sum(const MixedArgs& a,
                                                const MixedShared* sh,
                                                int block, int blocks) {
  const int k = threadIdx.x;
  if (k < K) a.partial[k * blocks + block] = mixed_warps_sum(sh, k);
}

// phase 6, the last block: thread t's share of each value, the partials of
// blocks t, t + 256, ... in order, into acc[k * stride]; the block then
// sums the shares as phase 5 sums the particles'. A block's K partials are
// loaded together (no store between them), so that their round trips
// overlap.
template <int K>
__device__ __forceinline__ void mixed_gather_partials(const MixedArgs& a,
                                                      int blocks, double* acc,
                                                      int stride) {
  double s[K];
#pragma unroll
  for (int k = 0; k < K; ++k) s[k] = 0.0;
  for (int b = threadIdx.x; b < blocks; b += kMixedThreads) {
#pragma unroll
    for (int k = 0; k < K; ++k) s[k] += __ldcg(a.partial + k * blocks + b);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k * stride] = s[k];
}

// phase 6, the end: thread k < K rounds value k's total once
template <int K>
__device__ __forceinline__ void mixed_total(const MixedArgs& a,
                                            const MixedShared* sh) {
  const int k = threadIdx.x;
  if (k < K) a.total[k] = static_cast<MixedOut>(mixed_warps_sum(sh, k));
}

#ifdef __CUDACC__
// Each warp's sums of the K values (acc[k * kMixedThreads + thread]) by a
// shuffle tree (lane l adds lane l + off, off = 16, 8, .., 1) into
// red[warp][k]; the K trees step together, so that their shuffles overlap
template <int K>
__device__ __forceinline__ void mixed_warp_trees(const double* acc,
                                                 MixedShared* sh) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  double v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = acc[k * kMixedThreads + t];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) sh->red[warp][k] = v[k];
  }
}

// The tiled kernel of the per-particle op Op, PER particles a thread. The
// thread's sums live in shared memory (a column of acc), which keeps the
// reverse sweep's registers free. a.done counts the finished blocks; the
// last one resets it.
template <class Op, int PER>
__device__ __forceinline__ void mixed_tiled(const MixedArgs& a) {
  constexpr int K = Op::K, tile = PER * kMixedThreads, chunks = tile / 32;
  static_assert(tile <= kMixedMaxTile, "tile larger than MixedShared");
  __shared__ MixedShared sh;
  __shared__ double acc[K * kMixedThreads];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int p0 = blockIdx.x * tile;
  for (int k = 0; k < K; ++k) acc[k * kMixedThreads + t] = 0.0;
  {
    bool band[PER];
    float keep[PER][3];
    mixed_classify<Op, PER>(a, &sh, p0 + t, kMixedThreads, band, keep);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int q = j * kMixedThreads + t;
      const unsigned m = __ballot_sync(0xffffffffu, band[j]);
      if (lane == 0) sh.mask[q >> 5] = m;
      if (!band[j]) Op::out_of_band(a, p0 + q, keep[j]);
    }
  }
  __syncthreads();
  if (t == 0) mixed_scan(&sh, chunks);
  __syncthreads();
  for (int c = warp; c < chunks; c += kMixedWarps) mixed_place(&sh, c, lane);
  __syncthreads();
  for (int i = t; i < sh.count; i += kMixedThreads) {
    Op::particle(a, sh.body, p0 + sh.list[i], acc + t, kMixedThreads);
  }
  mixed_warp_trees<K>(acc, &sh);
  __syncthreads();
  mixed_block_sum<K>(a, &sh, blockIdx.x, gridDim.x);
  __threadfence();
  __syncthreads();
  if (t == 0) sh.last = atomicAdd(a.done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!sh.last) return;
  __threadfence();
  mixed_gather_partials<K>(a, gridDim.x, acc + t, kMixedThreads);
  mixed_warp_trees<K>(acc, &sh);
  __syncthreads();
  mixed_total<K>(a, &sh);
  if (t == 0) *a.done = 0u;
}
#endif

// the blocks of a tiled launch
inline int mixed_blocks(int n, int tile) { return (n + tile - 1) / tile; }

// Fixed-order tree reduction of the block's 16 body cotangents into
// part[i * gridDim.x + blockIdx.x] (the split's backward kernels, one
// thread a particle). Every thread of the block
// calls it.
__device__ __forceinline__ void reduce_body(const double gb[16],
                                            double* __restrict__ part) {
  __shared__ double red[16][kThreads];
  const int t = threadIdx.x;
  for (int i = 0; i < 16; ++i) red[i][t] = gb[i];
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (t < stride) {
      for (int i = 0; i < 16; ++i) red[i][t] += red[i][t + stride];
    }
    __syncthreads();
  }
  if (t < 16) part[t * gridDim.x + blockIdx.x] = red[t][0];
}

}  // namespace softmac
