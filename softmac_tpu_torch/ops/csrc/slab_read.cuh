// Read-side tiles: G2P and the gather (g2p.cu, gather.cu) from a tile's
// box of grid cells staged once in shared memory.
//
// The TPU kernels these replace (pallas_chunked._g2p_c_kernel and
// _gather_c_kernel) keep a sorted particle tile's 16-row y-window of the
// three velocity grids in VMEM and read every stencil cell from there.
// Here a block takes kReadTile consecutive particles of the rollout's
// y-sorted order (one a thread, a warp's lanes on consecutive particles),
// computes each one's weights and window-relative base once, and reduces
// the box of window cells their stencils reach: its y rows, and in x and z
// the tile's footprint (at 1e5 particles of pour_vel and the pour a tile's
// box is ~15-19 % of its full window rows). It stages the box's rows, as
// many as the budget (kReadSmem bytes) holds, from the three (wy*wz, wx)
// grids into shared memory, channel-interleaved: a cell is one float4
// (v0, v1, v2, pad), so a particle makes 27 shared loads where it would
// make 81 scattered global ones; a box row's x cells are contiguous in
// each grid, so a warp's loads are coalesced within each row. After a
// barrier each particle sums its stencil, in the order j (y), k (z), i (x)
// with the products of mpm.g2p_dense: from shared memory when all its
// window rows lie in the slab, else from device memory (__ldg of the three
// grids), the same arithmetic in the same order, so the two paths give the
// same bits. Such particles (a tile that spans more rows than the budget
// holds: an unsorted order, a sparse stream of particles, a wide
// footprint) are counted, a tile's count written to off_slab[tile]; the
// result is exact for any order. One launch, no atomics but the block's
// shared bounds and count, no scratch.
//
// A block (read_block) runs its phases in order with a barrier after each
// (read_phases; the host tests run them the same way, one phase over all
// threads at a time): read_begin; read_bounds; read_tile, read_stage and
// read_locate; read_sums.
// Kind: G2PKind (velocity and the nine unscaled C rows, 12 rows out) or
// GatherKind (the velocity alone, 3 rows).
#pragma once

#include "slab.cuh"

namespace softmac {

// Sized on an H100 (scripts/read_ab.py --variants): 1e5 particles make
// 391 blocks, three an SM at once
constexpr int kReadTile = 256;           // particles (threads) a block
constexpr int kReadSmem = 48 * 1024;     // a slab's budget
constexpr int kReadBlocks = 3;           // blocks an SM the launch bounds ask

struct G2PKind {
  static constexpr bool kDeriv = true;
  static constexpr int kRows = 12;
};

struct GatherKind {
  static constexpr bool kDeriv = false;
  static constexpr int kRows = 3;
};

// One call: x (3, n), the three (wy*wz, wx) grids, corner (3,) int32, out
// (Kind::kRows, n), off_slab (tiles) the particles a tile read from device
// memory; cells, the float4 cells a block's slab holds (read_cells).
struct ReadArgs {
  const float* x;
  const float* grid[3];
  const int* corner;
  float* out;
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
// base, and whether all its window cells lie in the slab
struct ReadThread {
  Axis ax[3];
  int rel[3];
  bool in_slab;
};

// The block's slab: the box's x [x0, x0 + nx) and z [z0, z0 + nz) and its
// window rows [y0, y0 + rows); cell (cy, cz, cx) at cells[((cy - y0) * nz
// + cz - z0) * stride + cx - x0]
struct ReadTile {
  int x0, nx, y0, rows, z0, nz, stride;
  float4* cells;
};

// A cell's three grid values, by window cell (cy, cz, cx): from the slab
struct SlabCells {
  const float4* cells;
  int x0, y0, z0, nz, stride;
  __device__ __forceinline__ float4 operator()(int cy, int cz, int cx) const {
    return cells[((cy - y0) * nz + cz - z0) * stride + cx - x0];
  }
};

// ... or from device memory
struct GridCells {
  const float* g0;
  const float* g1;
  const float* g2;
  int wx, wz;
  __device__ __forceinline__ float4 operator()(int cy, int cz, int cx) const {
    const int e = (cy * wz + cz) * wx + cx;
    return make_float4(__ldg(g0 + e), __ldg(g1 + e), __ldg(g2 + e), 0.f);
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

// phase 1: the particle's weights and window-relative base, and the box
// the tile's stencils reach
__device__ __forceinline__ void read_bounds(const ReadArgs& a, int tile,
                                            ReadThread& me, ReadShared* sh) {
  const int p = read_particle(a, tile);
  if (p < 0) return;
  particle_stencil(a.x, a.n, p, a.corner, a.inv_dx, me.ax, me.rel);
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

// phase 2: the slab's cells of the three grids, interleaved (consecutive
// threads on consecutive cells of a box row)
__device__ __forceinline__ void read_stage(const ReadArgs& a,
                                           const ReadTile& t) {
  const int count = t.rows * t.nz * t.nx;
  for (int e = threadIdx.x; e < count; e += kReadTile) {
    const int row = e / t.nx, cx = e - row * t.nx;   // row = r * nz + z
    const int r = row / t.nz, cz = row - r * t.nz;
    const int g = ((t.y0 + r) * a.wz + t.z0 + cz) * a.wx + t.x0 + cx;
    t.cells[row * t.stride + cx] = make_float4(
        __ldg(a.grid[0] + g), __ldg(a.grid[1] + g), __ldg(a.grid[2] + g),
        0.f);
  }
}

// phase 2, after the staging: whether the particle's window cells all lie
// in the slab (else it is counted); the box holds every stencil's x and z
// cells, so only its rows can leave one out
__device__ __forceinline__ void read_locate(const ReadArgs& a, int tile,
                                            const ReadTile& t, ReadThread& me,
                                            ReadShared* sh) {
  me.in_slab = read_particle(a, tile) < 0 || !read_reaches(a, me.rel)
               || (read_r0(me.rel[1]) >= t.y0
                   && read_r1(me.rel[1], a.wy) <= t.y0 + t.rows);
  if (!me.in_slab) atomicAdd(&sh->off, 1);
}

// One particle's sums over its stencil cells inside the window, each
// cell's three values from `cells`: out rows v[d] and, for G2P, the
// unscaled C[d][0..2] in rows 3 + 3d + 0..2.
template <class Kind, class Cells>
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
        if (Kind::kDeriv) {
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
    if (Kind::kDeriv) {
#pragma unroll
      for (int k = 0; k < 3; ++k) a.out[(3 + 3 * d + k) * a.n + p] = c[d][k];
    }
  }
}

// phase 3: the tile's count (thread 0), and the particle's sums from the
// slab or from device memory
template <class Kind>
__device__ __forceinline__ void read_sums(const ReadArgs& a, int tile,
                                          const ReadTile& t,
                                          const ReadThread& me,
                                          const ReadShared* sh) {
  if (threadIdx.x == 0) a.off_slab[tile] = sh->off;
  const SlabCells slab = {t.cells, t.x0, t.y0, t.z0, t.nz, t.stride};
  const GridCells grid = {a.grid[0], a.grid[1], a.grid[2], a.wx, a.wz};
  const int p = read_particle(a, tile);
  if (p < 0) return;
  if (me.in_slab) {
    read_stencil<Kind>(a, me.ax, me.rel, slab, p);
  } else {
    read_stencil<Kind>(a, me.ax, me.rel, grid, p);
  }
}

// A block's phases in order. phase(f) runs f(me) for every thread of the
// block, me that thread's particle, and then waits for all of them: a
// barrier on the card (read_block), one thread after another on the host.
template <class Kind, class Phase>
__device__ __forceinline__ void read_phases(const ReadArgs& a, int tile,
                                            ReadShared* sh, void* smem,
                                            Phase phase) {
  ReadTile t;
  phase([&](ReadThread&) { read_begin(a, sh); });
  phase([&](ReadThread& me) { read_bounds(a, tile, me, sh); });
  phase([&](ReadThread& me) {
    t = read_tile(a, sh, smem);
    read_stage(a, t);
    read_locate(a, tile, t, me, sh);
  });
  phase([&](ReadThread& me) { read_sums<Kind>(a, tile, t, me, sh); });
}

#ifdef __CUDACC__
// The body of a block (g2p_kernel, gather_kernel: __launch_bounds__
// (kReadTile, kReadBlocks), one block a tile)
template <class Kind>
__device__ __forceinline__ void read_block(const ReadArgs& a) {
  extern __shared__ float4 read_slab[];
  __shared__ ReadShared sh;
  ReadThread me;
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
