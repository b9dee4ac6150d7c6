// Penalty particle contact against one SDF primitive, with its reaction
// wrench: the tiled kernel of contact_mixed.cuh with PenaltyFwdOp.
//
// Replaces: softmac_tpu/ops/pallas_contact.py _make_particle_kernel (the
// kernel of _particle_factory, launched through _run_kernel) together with
// the XLA row gather in front of it (pallas_contact.py:712-723) and the
// wrench tail _tail_particle behind it (:693), which XLA fuses inside the
// custom_vjp. The math is contact.cuh contact_forward, in double on the
// float inputs: the backward kernel needs double (contact.cuh says why),
// and one precision gives the forward and the backward one contact mask.
//
// The kernel reads x, the SDF lane of each particle's stencil row and the
// 14 body floats (bp, bq, bv, bw, friction, where the rollout keeps them),
// and writes the impulse (3, n) and the wrench (6,): the force b_f =
// -imp / dt and its torque about the body's position, summed over the
// particles in contact (dist(x) - 5e-3 < 0) in double in a fixed order and
// rounded once. Only the particles in the contact band read v and the
// whole row and run the contact (60 of 1e5 against the glass and none
// against the bowl on pour_vel's state after 10 env steps: chip_smoke.py
// on an H100); the rest write a zero impulse.
//
// What bounds it on the H100. The least time is the bytes': every
// particle reads x and writes its impulse (6 floats), a band particle
// also reads v, and each stencil row the particles touch is read once
// (128 bytes; out of the band only its SDF lane is used, in the same
// lines): 2.4-2.8 MB a body at 1e5 particles on pour_vel's state
// (chip_smoke.py), 0.7-0.8 us at 3.35 TB/s; the band's ~240 double
// operations a particle are far from the compute limit. The first design
// (one thread a particle, every particle's whole row and contact in
// float, and ~20 PyTorch launches of the wrench tail behind it) spent its
// time on the full contact of particles whose impulse is zero and on the
// tail's elementwise passes. Here a launch is the tile skeleton's chain of
// dependent round trips (the inputs, the rows, the band's own loads, the
// fence and counter, the partials), with PER particles a thread staged so
// that their loads are in flight together (contact_mixed.cuh,
// kMixedPer: scripts/contact_phases.py measured 256 to 2048 particles a
// block on an H100).
#include "contact_mixed.cuh"

namespace {

#ifdef __CUDACC__
__global__ void __launch_bounds__(softmac::kMixedThreads, 2)
    collide_particle_kernel(softmac::MixedArgs a) {
  softmac::mixed_tiled<softmac::PenaltyFwdOp, softmac::kMixedPer>(a);
}
#endif

softmac::Geom geom(int res0, int res1, int res2, float lower0, float lower1,
                   float lower2, float upper0, float upper1, float upper2,
                   float inv_dx) {
  return {{lower0, lower1, lower2}, {upper0, upper1, upper2}, inv_dx,
          {res0, res1, res2}};
}

}  // namespace

// x, v (3, n); table (cells, 32) f32, 16-byte aligned; the body tensors bp
// (3), bq (4, wxyz), bv (3), bw (3) and friction (one float) on the
// device. Writes imp (3, n), wrench (6,) f32 and partial (6, blocks) f64
// scratch, blocks = ceil(n / (kMixedPer * kMixedThreads)); done is the
// launch's finished-block counter, zero on entry and on return
// (contact_mixed.cuh). lower/upper/inv_dx/res describe the table. Returns
// cudaGetLastError() after the launch.
extern "C" int softmac_collide_particle(
    const float* x, const float* v, const float* table, const float* bp,
    const float* bq, const float* bv, const float* bw, const float* friction,
    float* imp, float* wrench, double* partial, unsigned* done, int n,
    int res0, int res1, int res2, float lower0, float lower1, float lower2,
    float upper0, float upper1, float upper2, float inv_dx, double dt,
    double p_mass, void* stream) {
  const softmac::MixedArgs a = {
      x, v, reinterpret_cast<const float4*>(table),
      {bp, bq, bv, bw, friction, nullptr, nullptr}, nullptr, nullptr, imp,
      nullptr, wrench, partial, done, n,
      geom(res0, res1, res2, lower0, lower1, lower2, upper0, upper1, upper2,
           inv_dx),
      dt, p_mass, 0.0};
  if (n > 0) {
    const int threads = softmac::kMixedThreads;
    const int blocks = softmac::mixed_blocks(n, softmac::kMixedPer * threads);
    collide_particle_kernel<<<blocks, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
