// Read-side tiles: G2P and the gather (g2p.cu, gather.cu) and the
// backwards of P2G and of the splat (p2g_bwd.cu, splat_bwd.cu), each from
// a tile's box of window cells staged once in shared memory.
//
// The TPU kernels these replace (pallas_chunked._g2p_c_kernel,
// _gather_c_kernel, _p2g_c_bwd_kernel and _splat_c_bwd_kernel) keep a
// sorted particle tile's 16-row y-window of the grids (or of their
// cotangents) in VMEM and read every stencil cell from there. Here a block
// takes kReadTile consecutive particles of the rollout's y-sorted order
// (one a thread, a warp's lanes on consecutive particles), computes each
// one's weights and window-relative base once, and reduces the box of
// window cells their stencils reach: its y rows, and in x and z the tile's
// footprint (at 1e5 particles of pour_vel and the pour a tile's box is
// ~15-19 % of its full window rows). It stages the box's rows, as many as
// the budget (kReadSmem bytes) holds, from the Kind's three or four
// channels into shared memory, channel-interleaved: a cell is one float4
// (G2P and the gather: the three velocity grids and a zero; the P2G
// backward: dgm and the three components of dgmom; the splat backward: the
// three components of its window cotangent and a zero), so a particle
// makes 27 shared loads where it would make 81 or 108 scattered global
// ones. Channel c of window cell (row, cx), row = cy * wz + cz, lies at
// src[c][row * stride_c + cx], the stride wx for a grid of its own and 3 wx
// for a component of an interleaved (wy*wz, 3*wx) window (the Kind's kWide
// bit c; known when the kernel is compiled, so that channels of one stride
// share their offset); a box row's x cells are contiguous in each channel,
// so a warp's loads are coalesced within each row. After a barrier each
// particle takes its Kind's sums over its stencil, in the order j (y), k
// (z), i (x): from shared memory when all its window rows lie in the slab,
// else from device memory (__ldg of the channels), the same arithmetic in
// the same order, so the two paths give the same bits. Such particles (a
// tile that spans more rows than the budget holds: an unsorted order, a
// sparse stream of particles, a wide footprint) are counted, a tile's
// count written to off_slab[tile]; the result is exact for any order. One
// launch, no atomics but the block's shared bounds and count, no scratch.
//
// A block (read_block) runs its phases in order with a barrier after each
// (read_phases; the host tests run them the same way, one phase over all
// threads at a time): read_begin; read_bounds; read_tile, read_stage and
// read_locate; read_sums.
// A Kind gives kChannels (3 or 4: the staged channels of a cell), kWide
// (bit c set: channel c has the stride 3 wx), Inputs and load(a, p, in)
// (particle p's own input rows, loaded in the bounds phase) and
// sums(a, me, cells, p):
// particle p's outputs, each stencil cell's float4 from cells(cy, cz, cx)
// (SlabCells or GridCells). G2PKind (velocity and the nine unscaled C
// rows, 12 rows out) and GatherKind (the velocity alone, 3 rows) are
// below, read_stencil's gathers; P2GBwdKind (p2g_bwd.cu) and SplatBwdKind
// (splat_bwd.cu) take a reverse sweep (bspline.cuh stencil_adjoint) and
// write dx as well.
#pragma once

#include "slab.cuh"

namespace softmac {

// Sized on an H100 (scripts/read_ab.py --variants): 1e5 particles make
// 391 blocks, three an SM at once
constexpr int kReadTile = 256;           // particles (threads) a block
constexpr int kReadSmem = 48 * 1024;     // a slab's budget
constexpr int kReadBlocks = 3;           // blocks an SM the launch bounds ask

// One call: x (3, n); the staged channels src[c] (window cell (row, cx) at
// src[c][row * stride_c + cx]; src[3] unused by a Kind of three); in
// (kInputs, n) the Kind's particle rows (the P2G backward's 13 channels,
// the splat backward's 3 values) or null; corner (3,) int32; out (kRows,
// n); dx (3, n) the backwards' position cotangent, or null; off_slab
// (tiles) the particles a tile read from device memory; cells, the float4
// cells a block's slab holds (read_cells).
struct ReadArgs {
  const float* x;
  const float* src[4];
  const float* in;
  const int* corner;
  float* out;
  float* dx;
  int* off_slab;
  int n, wx, wy, wz;
  float inv_dx;
  int cells;
};

// The slab's row stride for a box nx cells wide: odd, so that the same
// column of neighbouring box rows lies in other bank groups
__host__ __device__ __forceinline__ int read_stride(int nx) { return nx | 1; }

// The cells a block's slab holds: the budget, or the whole window where
// that is less
__host__ __device__ inline int read_cells(int wx, int wy, int wz) {
  return static_cast<int>(imin(kReadSmem / 16,
                               static_cast<long long>(wy) * wz
                               * read_stride(wx)));
}

inline int read_tiles(int n) { return (n + kReadTile - 1) / kReadTile; }

// Dynamic shared bytes of a block: the slab
inline int read_smem(const ReadArgs& a) { return imax(16, 16 * a.cells); }

// A block's shared bookkeeping: the box [lo, hi) on each axis that its
// particles' stencils reach inside the window, and the particles that read
// from device memory
struct ReadShared {
  int lo[3], hi[3];
  int off;
};

// A thread's particle between the phases: its weights, window-relative
// base, whether all its window cells lie in the slab, and its own input
// rows (Kind::Inputs: the backwards' channels or values), loaded in the
// bounds phase so that their loads overlap the box and the staging
template <class Kind>
struct ReadThread {
  Axis ax[3];
  int rel[3];
  bool in_slab;
  typename Kind::Inputs in;
};

// The block's slab: the box's x [x0, x0 + nx) and z [z0, z0 + nz) and its
// window rows [y0, y0 + rows); cell (cy, cz, cx) at cells[((cy - y0) * nz
// + cz - z0) * stride + cx - x0]
struct ReadTile {
  int x0, nx, y0, rows, z0, nz, stride;
  float4* cells;
};

// A cell's staged float4, by window cell (cy, cz, cx): from the slab
struct SlabCells {
  const float4* cells;
  int x0, y0, z0, nz, stride;
  __device__ __forceinline__ float4 operator()(int cy, int cz, int cx) const {
    return cells[((cy - y0) * nz + cz - z0) * stride + cx - x0];
  }
};

// window cell (row, cx)'s channels of a Kind from device memory, a zero
// past them
template <class Kind>
__device__ __forceinline__ float4 read_cell(const ReadArgs& a, int row,
                                            int cx) {
  const int narrow = row * a.wx + cx, wide = row * (3 * a.wx) + cx;
  auto at = [&](int c) {
    return __ldg(a.src[c] + ((Kind::kWide >> c & 1) ? wide : narrow));
  };
  return make_float4(at(0), at(1), at(2),
                     Kind::kChannels > 3 ? at(3) : 0.f);
}

// ... or from device memory
template <class Kind>
struct GridCells {
  const ReadArgs& a;
  __device__ __forceinline__ float4 operator()(int cy, int cz, int cx) const {
    return read_cell<Kind>(a, cy * a.wz + cz, cx);
  }
};

// phase 0: an empty box, no particle off the slab
__device__ __forceinline__ void read_begin(const ReadArgs& a,
                                           ReadShared* sh) {
  if (threadIdx.x == 0) {
    const int w[3] = {a.wx, a.wy, a.wz};
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      sh->lo[d] = w[d];
      sh->hi[d] = 0;
    }
    sh->off = 0;
  }
}

// this thread's particle in tile `tile`, or -1 past the last particle
__device__ __forceinline__ int read_particle(const ReadArgs& a, int tile) {
  const int p = tile * kReadTile + static_cast<int>(threadIdx.x);
  return p < a.n ? p : -1;
}

// the window cells [read_r0, read_r1) on an axis of width w of a stencil
// at window-relative base rel (empty where it lies outside)
__device__ __forceinline__ int read_r0(int rel) { return imax(rel, 0); }
__device__ __forceinline__ int read_r1(int rel, int w) {
  return imin(rel + 3, w);
}

// whether a stencil reaches the window: a cell inside on every axis
__device__ __forceinline__ bool read_reaches(const ReadArgs& a,
                                             const int rel[3]) {
  return read_r0(rel[0]) < read_r1(rel[0], a.wx)
         && read_r0(rel[1]) < read_r1(rel[1], a.wy)
         && read_r0(rel[2]) < read_r1(rel[2], a.wz);
}

// phase 1: the particle's weights, window-relative base and input rows,
// and the box the tile's stencils reach
template <class Kind>
__device__ __forceinline__ void read_bounds(const ReadArgs& a, int tile,
                                            ReadThread<Kind>& me,
                                            ReadShared* sh) {
  const int p = read_particle(a, tile);
  if (p < 0) return;
  particle_stencil(a.x, a.n, p, a.corner, a.inv_dx, me.ax, me.rel);
  Kind::load(a, p, me.in);
  if (!read_reaches(a, me.rel)) return;
  const int w[3] = {a.wx, a.wy, a.wz};
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    atomicMin(&sh->lo[d], read_r0(me.rel[d]));
    atomicMax(&sh->hi[d], read_r1(me.rel[d], w[d]));
  }
}

// after phase 1: the block's slab over its shared memory, as many of the
// box's rows from its lowest as the slab holds
__device__ __forceinline__ ReadTile read_tile(const ReadArgs& a,
                                             const ReadShared* sh,
                                             void* smem) {
  ReadTile t;
  const bool any = sh->lo[1] < sh->hi[1];
  t.x0 = any ? sh->lo[0] : 0;
  t.nx = any ? sh->hi[0] - sh->lo[0] : 0;
  t.y0 = any ? sh->lo[1] : 0;
  t.z0 = any ? sh->lo[2] : 0;
  t.nz = any ? sh->hi[2] - sh->lo[2] : 0;
  t.stride = read_stride(t.nx);
  t.rows = any ? imin(sh->hi[1] - sh->lo[1], a.cells / (t.nz * t.stride))
               : 0;
  t.cells = static_cast<float4*>(smem);
  return t;
}

// phase 2: the slab's cells of the Kind's channels, interleaved
// (consecutive threads on consecutive cells of a box row)
template <class Kind>
__device__ __forceinline__ void read_stage(const ReadArgs& a,
                                           const ReadTile& t) {
  const int count = t.rows * t.nz * t.nx;
  for (int e = threadIdx.x; e < count; e += kReadTile) {
    const int row = e / t.nx, cx = e - row * t.nx;   // row = r * nz + z
    const int r = row / t.nz, cz = row - r * t.nz;
    t.cells[row * t.stride + cx] =
        read_cell<Kind>(a, (t.y0 + r) * a.wz + t.z0 + cz, t.x0 + cx);
  }
}

// phase 2, after the staging: whether the particle's window cells all lie
// in the slab (else it is counted); the box holds every stencil's x and z
// cells, so only its rows can leave one out
template <class Kind>
__device__ __forceinline__ void read_locate(const ReadArgs& a, int tile,
                                            const ReadTile& t,
                                            ReadThread<Kind>& me,
                                            ReadShared* sh) {
  me.in_slab = read_particle(a, tile) < 0 || !read_reaches(a, me.rel)
               || (read_r0(me.rel[1]) >= t.y0
                   && read_r1(me.rel[1], a.wy) <= t.y0 + t.rows);
  if (!me.in_slab) atomicAdd(&sh->off, 1);
}

// One particle's sums over its stencil cells inside the window, each
// cell's three values from `cells`: out rows v[d] and, with kDeriv (G2P),
// the unscaled C[d][0..2] in rows 3 + 3d + 0..2.
template <bool kDeriv, class Cells>
__device__ __forceinline__ void read_stencil(const ReadArgs& a,
                                             const Axis ax[3],
                                             const int rel[3], Cells cells,
                                             int p) {
  const int wx = a.wx, wy = a.wy, wz = a.wz;
  float v[3] = {0.f, 0.f, 0.f};
  float c[3][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int cy = rel[1] + j;
    if (cy < 0 || cy >= wy) continue;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int cz = rel[2] + k;
      if (cz < 0 || cz >= wz) continue;
      const float wyz = ax[1].w[j] * ax[2].w[k];
      const float dyz = ax[1].wd[j] * ax[2].w[k];
      const float ydz = ax[1].w[j] * ax[2].wd[k];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int cx = rel[0] + i;
        if (cx < 0 || cx >= wx) continue;
        const float4 g4 = cells(cy, cz, cx);
        const float g[3] = {g4.x, g4.y, g4.z};
        const float wgt = ax[0].w[i] * wyz;
#pragma unroll
        for (int d = 0; d < 3; ++d) v[d] += wgt * g[d];
        if (kDeriv) {
          const float dwx = ax[0].wd[i] * wyz;
          const float dwy = ax[0].w[i] * dyz;
          const float dwz = ax[0].w[i] * ydz;
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            c[d][0] += dwx * g[d];
            c[d][1] += dwy * g[d];
            c[d][2] += dwz * g[d];
          }
        }
      }
    }
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    a.out[d * a.n + p] = v[d];
    if (kDeriv) {
#pragma unroll
      for (int k = 0; k < 3; ++k) a.out[(3 + 3 * d + k) * a.n + p] = c[d][k];
    }
  }
}

// A Kind whose particles bring no input rows of their own
struct ReadNoInputs {
  struct Inputs {};
  static __device__ __forceinline__ void load(const ReadArgs&, int,
                                              Inputs&) {}
};

struct G2PKind : ReadNoInputs {
  static constexpr int kChannels = 3, kWide = 0;
  template <class Thread, class Cells>
  static __device__ __forceinline__ void sums(const ReadArgs& a,
                                              const Thread& me, Cells cells,
                                              int p) {
    read_stencil<true>(a, me.ax, me.rel, cells, p);
  }
};

struct GatherKind : ReadNoInputs {
  static constexpr int kChannels = 3, kWide = 0;
  template <class Thread, class Cells>
  static __device__ __forceinline__ void sums(const ReadArgs& a,
                                              const Thread& me, Cells cells,
                                              int p) {
    read_stencil<false>(a, me.ax, me.rel, cells, p);
  }
};

// phase 3: the tile's count (thread 0), and the particle's sums from the
// slab or from device memory
template <class Kind>
__device__ __forceinline__ void read_sums(const ReadArgs& a, int tile,
                                          const ReadTile& t,
                                          const ReadThread<Kind>& me,
                                          const ReadShared* sh) {
  if (threadIdx.x == 0) a.off_slab[tile] = sh->off;
  const SlabCells slab = {t.cells, t.x0, t.y0, t.z0, t.nz, t.stride};
  const GridCells<Kind> grid = {a};
  const int p = read_particle(a, tile);
  if (p < 0) return;
  if (me.in_slab) {
    Kind::sums(a, me, slab, p);
  } else {
    Kind::sums(a, me, grid, p);
  }
}

// A block's phases in order. phase(f) runs f(me) for every thread of the
// block, me that thread's particle, and then waits for all of them: a
// barrier on the card (read_block), one thread after another on the host.
template <class Kind, class Phase>
__device__ __forceinline__ void read_phases(const ReadArgs& a, int tile,
                                            ReadShared* sh, void* smem,
                                            Phase phase) {
  using Thread = ReadThread<Kind>;
  ReadTile t;
  phase([&](Thread&) { read_begin(a, sh); });
  phase([&](Thread& me) { read_bounds(a, tile, me, sh); });
  phase([&](Thread& me) {
    t = read_tile(a, sh, smem);
    read_stage<Kind>(a, t);
    read_locate(a, tile, t, me, sh);
  });
  phase([&](Thread& me) { read_sums<Kind>(a, tile, t, me, sh); });
}

#ifdef __CUDACC__
// The body of a block (g2p_kernel, gather_kernel, p2g_bwd_kernel,
// splat_bwd_kernel: __launch_bounds__(kReadTile, kReadBlocks), one block
// a tile)
template <class Kind>
__device__ __forceinline__ void read_block(const ReadArgs& a) {
  extern __shared__ float4 read_slab[];
  __shared__ ReadShared sh;
  ReadThread<Kind> me;
  read_phases<Kind>(a, blockIdx.x, &sh, read_slab, [&](auto f) {
    f(me);
    __syncthreads();
  });
}

// One call's launch of `kernel`; returns cudaGetLastError().
template <class Kernel>
inline int read_launch(Kernel kernel, ReadArgs a, cudaStream_t s,
                       unsigned& opted) {
  a.cells = read_cells(a.wx, a.wy, a.wz);
  if (a.n > 0) {
    // opted in at once (a slab of exactly 48 KB and the static bytes
    // would not launch without)
    slab_allow(kernel, kSlabSmemMax, opted);
    kernel<<<read_tiles(a.n), kReadTile, read_smem(a), s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif

}  // namespace softmac
