// Penalty particle contact against one SDF primitive.
//
// Replaces: softmac_tpu/ops/pallas_contact.py _make_particle_kernel (the
// kernel of _particle_factory, launched through _run_kernel) together with
// the XLA row gather in front of it (pallas_contact.py:712-723). Same math
// as pallas_contact._particle_math and engine.contact._collide_particle_xla:
//   p_loc  = rot(conj(q)/|q|, x - bp)
//   base   = clamp(floor((p_loc - lower) * inv_dx), 0, res - 2)   per axis
//   fx     = clamp((p_loc - lower) * inv_dx - base, 0, 1)
//   (sdf, n_loc) = trilinear over the cell's 32-float neighborhood row;
//                  BIG and (0, 1, 0) outside [lower, upper)
//   D      = rot(q, n_loc)
//   c      = sdf - 5e-3, mask = c < 0
//   cv     = collider velocity of the body point at x
//   imp    = -D c k1 dt  -  p_v_t / |p_v_t| * min(|nc| friction dt,
//                                                  p_mass |p_v_t|)
//   (k1 = 50, nc = (v - cv).D, p_v_t the tangential part), zero where
//   mask is false.
// The wrench sum over particles stays a PyTorch reduction in the caller,
// as it is plain XLA in the JAX package.
//
// What bounds it on the H100: bytes and latency of the table gather. A
// particle reads 6 floats (x, v), one 128-byte stencil row at a
// data-dependent address, and writes 3 floats + 1 byte. At 1e5 particles
// that is at most 15.6 MB (12.8 MB of rows, fewer distinct rows because
// neighbouring particles share cells), about 5 us at 3.35 TB/s; the ~150
// flops a particle are far from the compute limit.
//
// Simple design: one thread per particle. The row is read with eight
// 16-byte vector loads through the read-only path; the y-sorted particle
// order lets neighbouring threads share rows in L1/L2. Body state arrives
// as 14 floats in device memory so that the rollout never waits on the host.
#include "bspline.cuh"

namespace {

constexpr float kBig = 1e10f;
constexpr float kThreshold = 5e-3f;
constexpr float kStiffness = 50.0f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// rotate v by the (not necessarily unit) quaternion (w, qv), as m33.qrot
__device__ __forceinline__ V3 qrot(float w, V3 qv, V3 v) {
  const V3 uv = cross(qv, v);
  const V3 uuv = cross(qv, uv);
  return {v.x + 2.0f * (w * uv.x + uuv.x), v.y + 2.0f * (w * uv.y + uuv.y),
          v.z + 2.0f * (w * uv.z + uuv.z)};
}

struct Geom {
  float lower[3], upper[3], inv_dx;
  int res[3];
};

__global__ void collide_particle_kernel(const float* __restrict__ x,
                                        const float* __restrict__ v,
                                        const float4* __restrict__ table,
                                        const float* __restrict__ body,
                                        float* __restrict__ imp,
                                        uint8_t* __restrict__ mask_out,
                                        int n, Geom g, float dt, float p_mass) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;

  // body = [bp(3), bq(4) wxyz, bv(3), bw(3), friction]
  const V3 bp = {body[0], body[1], body[2]};
  const float qw = body[3];
  const V3 qv = {body[4], body[5], body[6]};
  const V3 bv = {body[7], body[8], body[9]};
  const V3 bw = {body[10], body[11], body[12]};
  const float friction = body[13];
  const float qn_inv =
      1.0f / sqrtf(qw * qw + dot(qv, qv) + 1e-12f);
  const float nw = qw * qn_inv;                      // qnorm(q)
  const V3 nv = {qv.x * qn_inv, qv.y * qn_inv, qv.z * qn_inv};
  const V3 nv_conj = {-nv.x, -nv.y, -nv.z};          // qnorm(conj(q))

  const V3 xp = {x[p], x[n + p], x[2 * n + p]};
  const V3 vp = {v[p], v[n + p], v[2 * n + p]};
  const V3 r = {xp.x - bp.x, xp.y - bp.y, xp.z - bp.z};
  const V3 pl = qrot(nw, nv_conj, r);

  // cell index and fractions, as pallas_contact._cell_index / _local_and_fx
  const float lp[3] = {pl.x, pl.y, pl.z};
  float fx[3];
  int base[3];
  bool in_box = true;
  for (int d = 0; d < 3; ++d) {
    in_box = in_box && (lp[d] >= g.lower[d]) && (lp[d] < g.upper[d]);
    const float pos = (lp[d] - g.lower[d]) * g.inv_dx;
    const float b = fminf(fmaxf(floorf(pos), 0.0f),
                          static_cast<float>(g.res[d] - 2));
    base[d] = static_cast<int>(b);
    fx[d] = fminf(fmaxf(pos - b, 0.0f), 1.0f);
  }
  const long long cell =
      (static_cast<long long>(base[0]) * g.res[1] + base[1]) * g.res[2] + base[2];
  const float4* row = table + cell * 8;  // 32 floats = 8 float4

  // trilinear over corners c = 4i + 2j + k, each [sdf, nx, ny, nz]
  float sdf = 0.f, nx = 0.f, ny = 0.f, nz = 0.f;
  for (int c = 0; c < 8; ++c) {
    const int i = c >> 2, j = (c >> 1) & 1, k = c & 1;
    const float wi = i ? fx[0] : 1.0f - fx[0];
    const float wj = j ? fx[1] : 1.0f - fx[1];
    const float wk = k ? fx[2] : 1.0f - fx[2];
    const float w = wi * wj * wk;
    const float4 e = __ldg(row + c);
    sdf += w * e.x;
    nx += w * e.y;
    ny += w * e.z;
    nz += w * e.w;
  }
  const float nrm = sqrtf(nx * nx + ny * ny + nz * nz + 1e-14f);
  V3 n_loc = in_box ? V3{nx / nrm, ny / nrm, nz / nrm} : V3{0.f, 1.f, 0.f};
  const float dist = in_box ? sdf : kBig;
  const V3 D = qrot(qw, qv, n_loc);

  float c = dist - kThreshold;
  const bool mask = c < 0.0f;
  c = mask ? c : 0.0f;

  // collider velocity: rot(q, bv + bw x rot(conj(q), r)), q normalized
  const V3 r_loc = qrot(nw, nv_conj, r);
  const V3 wxr = cross(bw, r_loc);
  const V3 cv = qrot(nw, nv, V3{bv.x + wxr.x, bv.y + wxr.y, bv.z + wxr.z});

  const V3 in_v = {vp.x - cv.x, vp.y - cv.y, vp.z - cv.z};
  const float nc = dot(in_v, D);
  const V3 pvt = {in_v.x - D.x * nc, in_v.y - D.y * nc, in_v.z - D.z * nc};
  const float spring = -(c * kStiffness * dt);
  const float vt_norm = sqrtf(dot(pvt, pvt) + 1e-8f);
  const float fric = fminf(fabsf(nc) * friction * dt, p_mass * vt_norm);
  const float s = -fric / vt_norm;
  const V3 out = {D.x * spring + pvt.x * s, D.y * spring + pvt.y * s,
                  D.z * spring + pvt.z * s};

  imp[p] = mask ? out.x : 0.0f;
  imp[n + p] = mask ? out.y : 0.0f;
  imp[2 * n + p] = mask ? out.z : 0.0f;
  mask_out[p] = mask ? 1 : 0;
}

}  // namespace

// x, v (3, n); table (cells, 32) f32, 16-byte aligned; body (14,) f32 on
// the device; imp (3, n) and mask (n,) bool outputs. lower/upper/inv_dx/res
// describe the table. Returns cudaGetLastError() after the launch.
extern "C" int softmac_collide_particle(
    const float* x, const float* v, const float* table, const float* body,
    float* imp, uint8_t* mask, int n, int res0, int res1, int res2,
    float lower0, float lower1, float lower2, float upper0, float upper1,
    float upper2, float inv_dx, float dt, float p_mass, void* stream) {
  if (n > 0) {
    Geom g = {{lower0, lower1, lower2}, {upper0, upper1, upper2}, inv_dx,
              {res0, res1, res2}};
    collide_particle_kernel<<<softmac::blocks_for(n), softmac::kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        x, v, reinterpret_cast<const float4*>(table), body, imp, mask, n, g,
        dt, p_mass);
  }
  return static_cast<int>(cudaGetLastError());
}
