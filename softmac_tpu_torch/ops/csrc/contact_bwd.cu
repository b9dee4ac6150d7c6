// Backward of the penalty particle contact with its wrench: cotangents of
// the positions, the velocities and the 14 body floats, from those of the
// impulse and the wrench. The tiled kernel of contact_mixed.cuh with
// PenaltyBwdOp.
//
// Replaces: softmac_tpu/ops/pallas_contact.py _make_particle_bwd_kernel
// (jax.vjp of _particle_math traced inside the kernel, launched from
// _particle_factory's _bwd, which then sums the per-particle body rows)
// together with jax.vjp of the wrench tail _tail_particle in front of it
// (g_out, g_x_t, g_bp_t). The SDF table gets no cotangent, as the JAX _bwd
// returns zeros for it.
//
// CUDA has no vjp transform, so contact.cuh contact_backward is a reverse
// sweep written by hand over the same forward (contact_forward, recomputed
// here from x, v and the stencil row, as the TPU kernel recomputes it):
// quaternion normalisations and rotations, trilinear sdf and normal, the
// masked penetration, the collider velocity, the min() friction clamp and
// the final where(mask, ., 0). contact_mixed.cuh penalty_particle_bwd
// folds the wrench's reverse in front of it. The math runs in double on
// the float inputs (contact.cuh says why); the outputs are rounded once.
//
// A particle out of the contact band gets dx = dv = 0, exactly the reverse
// sweep's result there, and its impulse cotangent is not read; the band's
// particles run the forward again, the wrench's reverse and the sweep.
// The 14 body cotangents (the wrench's share of bp included) are summed
// in double in a fixed order, each block to its partial and the last
// block over the partials, and rounded once: the action gradient is the
// same on every run, in one launch.
//
// What bounds it on the H100: the least time is the bytes' (every
// particle's x in and dx, dv out, 9 floats; a band particle's v and
// impulse cotangent in; each stencil row the particles touch once:
// 3.6-4.0 MB a body at 1e5 particles on pour_vel's state (chip_smoke.py),
// 1.1-1.2 us at 3.35 TB/s); the ~550 double operations a particle in the
// band stay far below the compute limit. The first design
// (one thread a particle, the forward and the sweep in double for every
// particle, 14 double accumulators a thread, a shared-memory reduction in
// float and two more launches to sum the partials) spent its time on the
// double math of particles whose cotangents are zero.
#include "contact_mixed.cuh"

namespace {

#ifdef __CUDACC__
__global__ void __launch_bounds__(softmac::kMixedThreads)
    collide_particle_bwd_kernel(softmac::MixedArgs a) {
  softmac::mixed_tiled<softmac::PenaltyBwdOp, softmac::kMixedBwdPer>(a);
}
#endif

softmac::Geom geom(int res0, int res1, int res2, float lower0, float lower1,
                   float lower2, float upper0, float upper1, float upper2,
                   float inv_dx) {
  return {{lower0, lower1, lower2}, {upper0, upper1, upper2}, inv_dx,
          {res0, res1, res2}};
}

}  // namespace

// x, v, table, the body tensors and the geometry as for
// softmac_collide_particle; gimp (3, n) and gwrench (6,) f32 the
// cotangents of the impulse and of the wrench (either may be null: zero).
// Writes dx, dv (3, n), dbody (14,) f32 [bp, bq wxyz, bv, bw, friction]
// and partial (14, blocks) f64 scratch, blocks = ceil(n / (kMixedBwdPer
// * kMixedThreads)); done as for softmac_collide_particle. Returns
// cudaGetLastError() after the launch.
extern "C" int softmac_collide_particle_bwd(
    const float* x, const float* v, const float* table, const float* bp,
    const float* bq, const float* bv, const float* bw, const float* friction,
    const float* gimp, const float* gwrench, float* dx, float* dv,
    float* dbody, double* partial, unsigned* done, int n, int res0, int res1,
    int res2, float lower0, float lower1, float lower2, float upper0,
    float upper1, float upper2, float inv_dx, double dt, double p_mass,
    void* stream) {
  const softmac::MixedArgs a = {
      x, v, reinterpret_cast<const float4*>(table),
      {bp, bq, bv, bw, friction, nullptr, nullptr}, gimp, gwrench, dx, dv,
      dbody, partial, done, n,
      geom(res0, res1, res2, lower0, lower1, lower2, upper0, upper1, upper2,
           inv_dx),
      dt, p_mass, 0.0};
  if (n > 0) {
    const int threads = softmac::kMixedThreads;
    const int blocks =
        softmac::mixed_blocks(n, softmac::kMixedBwdPer * threads);
    collide_particle_bwd_kernel<<<blocks, threads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
