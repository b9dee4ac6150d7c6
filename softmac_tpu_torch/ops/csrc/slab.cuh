// Shared-memory y-slab tiles: the scatter of P2G, the splat and the grid
// halves of G2P's and the gather's backwards, without atomics inside a
// block.
//
// The TPU kernels these replace (pallas_chunked._p2g_c_kernel,
// _splat_c_kernel, _g2p_c_bwd_kernel and _gather_c_bwd_kernel) keep a
// sorted particle tile's 16-row y-window of the grid (or of the grid
// cotangent) in VMEM and add it to the grid once. Here a block takes `tile`
// consecutive particles of the rollout's y-sorted order and finds the
// window rows their stencils reach; up to `rows` of them form its slab.
// It stages the particles' values in shared
// memory with each particle's nine (w, wd) weight pairs, sorts them by
// their stencil's base cell (a bitonic sort of key * tile + index; the
// tile is a power of two), and finds each base cell's range in the sorted
// list. Then one thread a slab cell gathers the contributions of the
// particles in the 27 base cells around it, in a fixed order, and writes
// the cell's float64 sums once to the tile's own partial buffer. Cells of
// a row outside the slab (an unsorted order, a tile that spans many rows)
// go by global float64 atomics to a spill window, and the block counts
// those particles, so the result is exact over the whole window for any
// order. A second launch sums, for each window cell and channel, the
// partials of the tiles whose slab covers the cell's row in tile order,
// adds the spill window and rounds to float32 once. Without spills every
// sum is taken in a fixed order: repeated calls are bit-identical.
//
// Why not shared atomics: sm_90 has no native 64-bit float add on shared
// memory; atomicAdd(double*) there compiles to a compare-and-swap loop
// (ATOMS.CAST.SPIN.64), and a first version that added each particle's
// 108 P2G terms that way was slower on an H100 than the float64 atomics
// in device memory it was to replace. Those are bound by the L2's atomic
// rate, whatever the particles' order.
//
// What bounds this design on the H100: the gather's chains of dependent
// shared loads a (cell, particle) pair, about 27 a particle. The particles
// crowd into few cells of a slab (a glass's footprint), so the threads
// take the slab's cells one after another from a shared counter rather
// than a fixed share each. scripts/slab_phases.py times the phases.
//
// Layouts. A window cell (cy, cz, cx) of channel c has the accumulation
// index e = ((cy * wz + cz) * C + c) * wx + cx (the spill window's
// layout); tile t keeps the same layout over its rows, starting at its
// first row ylo_t: partial[t * tile_doubles + e - ylo_t * wz * C * wx].
// A particle's base cell (bx, by, bz) relative to the window has the key
// ((by - ylo + 2) * (wz + 2) + bz + 2) * (wx + 2) + bx + 2. The output
// holds the first `lead` channels each in a (wy*wz, wx) grid of its own,
// one after the other, and the others interleaved in one (wy*wz,
// (C-lead)*wx) array after them: P2G's gm and gmom (lead 1), the splat's
// one window (lead 0), the backwards' three grid cotangents (lead 3).
//
// A block runs its phases in order with a barrier between each (the host
// tests run them the same way, one phase over all threads at a time):
//   slab_begin, slab_bounds, slab_stage, slab_sort_step for each (k, j)
//   of the bitonic network, slab_offsets, slab_cell + slab_put for each
//   slab cell, and slab_count;
// then, in the second launch, slab_reduce_clear, slab_reduce_mark,
// slab_reduce_list and slab_reduce once per output element. `Values`
// gives a particle's channel values (P2GValues in p2g.cu, G2PBwdValues in
// g2p_bwd.cu, and SplatValues in splat.cu and GatherBwdValues in
// gather_bwd.cu, both on SlabThreeValues below):
// kChannels, kInputs (rows of src), active(src, n, p), constructors from
// (rows, stride, index) and from the staged float4s, and
// value(c, W, WxD, WDy, WDz); and two hooks of slab_stage for an output a
// particle (SlabNoParticleOutput where there is none): finish(a, p, ax,
// rel) for an active particle, whose weights and window-relative base it
// gets, and skip(a, p) for an inactive one. The backwards write the
// position cotangent dx there, a gather through the weights (bspline.cuh
// stencil_adjoint) from the grids a.grid: no atomics either.
#pragma once

#include "bspline.cuh"

namespace softmac {

constexpr int kSlabThreads = 512;       // threads a block
constexpr int kSlabMaxTile = 1024;      // particles a block: a power of two
constexpr int kSlabMinRows = 4;         // a tile spanning two base rows
constexpr int kSlabSmem = 112 * 1024;   // preferred: two blocks an SM
constexpr int kSlabSmemMax = 226 * 1024;  // below the 227 KB a block may use

__host__ __device__ __forceinline__ int imin(int a, int b) {
  return a < b ? a : b;
}
__host__ __device__ __forceinline__ int imax(int a, int b) {
  return a > b ? a : b;
}

__host__ __device__ __forceinline__ int log2_of(int tile) {
  int s = 0;
  while ((1 << s) < tile) ++s;
  return s;
}

inline bool slab_tile_ok(int tile) {
  return tile >= 32 && tile <= kSlabMaxTile && (tile & (tile - 1)) == 0;
}

// Staged inputs of a particle, in float4s (P2G's 13 floats take 4)
__host__ __device__ constexpr int packed(int inputs) {
  return (inputs + 3) / 4;
}

// Dynamic shared bytes of a block: each particle's inputs (float4s) and
// its nine (w, wd) weight pairs, the sort list and its decoded entries,
// and the base cells' ranges over rows + 2 base rows.
inline long long slab_smem(int inputs, int tile, int rows, int wx, int wz) {
  return tile * (16LL * packed(inputs) + 72LL) + 8LL * tile
         + 4LL * ((rows + 2LL) * (wz + 2) * (wx + 2) + 1);
}

// How one call is cut: `tiles` blocks of `tile` particles, `rows` slab
// rows, `smem` dynamic shared bytes a block; `tile_doubles` is one tile's
// partial slab. Rows come first: where the preferred budget holds fewer
// than kSlabMinRows, the whole budget, and then halved tiles.
struct SlabPlan {
  int channels, inputs, tiles, tile, rows, smem;
  long long tile_doubles;
};

inline SlabPlan slab_plan(int channels, int inputs, int n, int tile, int wx,
                          int wy, int wz) {
  const int want = imin(kSlabMinRows, wy);
  int rows;
  for (;; tile >>= 1) {
    rows = wy;
    while (rows > 0 && slab_smem(inputs, tile, rows, wx, wz) > kSlabSmem)
      --rows;
    if (rows < want) {
      rows = wy;
      while (rows > 0 && slab_smem(inputs, tile, rows, wx, wz) > kSlabSmemMax)
        --rows;
    }
    if (rows >= want || tile <= 32) break;
  }
  SlabPlan p;
  p.channels = channels;
  p.inputs = inputs;
  p.tiles = n > 0 ? (n + tile - 1) / tile : 0;
  p.tile = tile;
  p.rows = rows;
  p.smem = static_cast<int>(slab_smem(inputs, tile, rows, wx, wz));
  p.tile_doubles = static_cast<long long>(rows) * wz * wx * channels;
  return p;
}

// Everything a scatter launch reads; src holds the particles' values
// (P2G's 13 channel rows, the splat's 3, the backwards' cotangent rows: 12
// of G2P, 3 of the gather). grid and dx only for the backwards' position
// half: the three (wy*wz, wx) velocity grids it reads and dx (3, n).
struct SlabArgs {
  const float* x;
  const float* src;
  const int* corner;
  double* spill;      // C * cells, then the spilled-particle count (u64)
  double* partial;    // tiles * tile_doubles
  int* meta;          // (ylo, rows) a tile
  int n, tile, lead, wx, wy, wz;     // tile: the plan's
  float inv_dx;
  SlabPlan plan;
  const float* grid[3];
  float* dx;
};

// The stage hooks of a Values type with no output a particle (P2G, splat)
struct SlabNoParticleOutput {
  __device__ static void finish(const SlabArgs&, int, const Axis*,
                                const int*) {}
  __device__ static void skip(const SlabArgs&, int) {}
};

// Three values a particle, channel c W times value c: the splat's values,
// the gather backward's cotangent. A particle whose values are all zero is
// skipped: it would add W x 0 to sums that start at +0.
struct SlabThreeValues : SlabNoParticleOutput {
  static constexpr int kChannels = 3, kInputs = 3;
  float v[3];

  __device__ static bool active(const float* vals, int n, int p) {
    return vals[p] != 0.f || vals[n + p] != 0.f || vals[2 * n + p] != 0.f;
  }

  // the 3 value rows of stride n at column p
  __device__ SlabThreeValues(const float* vals, int n, int p) {
    for (int d = 0; d < 3; ++d) v[d] = vals[d * n + p];
  }

  // the same values staged in a float4
  __device__ explicit SlabThreeValues(const float4* f) {
    const float4 f0 = f[0];
    v[0] = f0.x, v[1] = f0.y, v[2] = f0.z;
  }

  __device__ float value(int c, float wgt, float, float, float) const {
    return wgt * v[c];
  }
};

// A block's shared bookkeeping: the rows [lo, hi) its particles reach, the
// particles that spilled, and the next slab cell to gather.
struct SlabShared {
  int lo, hi;
  unsigned spilled;
  int next;
};

// The block's tile once its bounds are known: particles [p0, p0 + count),
// slab rows [ylo, ylo + rows), `keys` base cells, and its shared arrays.
struct SlabTile {
  int p0, count, ylo, rows, keys, shift;
  float4* vals;       // tile x packed(inputs): the particles' inputs
  float2* wts;        // tile x 9: (w, wd) of axis a at offset o, 3 a + o
  unsigned* sorted;   // tile entries: key << shift | index, ascending
  unsigned* ent;      // the sorted entries decoded: index | base x << 16
  int* start;         // keys + 1: the first sorted entry of each key
};

// phase 0: no rows, no spilled particle
__device__ __forceinline__ void slab_begin(const SlabArgs& a, SlabShared* sh) {
  if (threadIdx.x == 0) {
    sh->lo = a.wy;
    sh->hi = 0;
    sh->spilled = 0;
    sh->next = 0;
  }
}

// phase 1: the window rows the tile's active particles' stencils reach
template <class Values>
__device__ __forceinline__ void slab_bounds(const SlabArgs& a, int tile,
                                            SlabShared* sh) {
  const int p0 = tile * a.tile, p1 = imin(p0 + a.tile, a.n);
  int lo = a.wy, hi = 0;
  for (int p = p0 + threadIdx.x; p < p1; p += blockDim.x) {
    if (!Values::active(a.src, a.n, p)) continue;
    const int rel = axis_weights(a.x[a.n + p], a.inv_dx).base - a.corner[1];
    const int r0 = imax(rel, 0), r1 = imin(rel + 3, a.wy);
    if (r0 < r1) {
      lo = imin(lo, r0);
      hi = imax(hi, r1);
    }
  }
  if (lo < hi) {
    atomicMin(&sh->lo, lo);
    atomicMax(&sh->hi, hi);
  }
}

// after phase 1: the block's tile over its shared memory
__device__ __forceinline__ SlabTile slab_tile(const SlabArgs& a, int tile,
                                              const SlabShared* sh,
                                              void* smem) {
  SlabTile t;
  const bool any = sh->lo < sh->hi;
  t.p0 = tile * a.tile;
  t.count = imin(a.tile, a.n - t.p0);
  t.ylo = any ? sh->lo : 0;
  t.rows = any ? imin(sh->hi - sh->lo, a.plan.rows) : 0;
  t.keys = (t.rows + 2) * (a.wz + 2) * (a.wx + 2);
  t.shift = log2_of(a.tile);
  t.vals = static_cast<float4*>(smem);
  t.wts = reinterpret_cast<float2*>(t.vals + a.tile * packed(a.plan.inputs));
  t.sorted = reinterpret_cast<unsigned*>(t.wts + 9 * a.tile);
  t.ent = t.sorted + a.tile;
  t.start = reinterpret_cast<int*>(t.ent + a.tile);
  return t;
}

// phase 2: stage each particle (inputs, weights) and its sort entry; add
// the cells of its rows outside the slab to the spill window; run the
// Values' hook of the particle (finish, or skip where it is inactive).
// Thread 0 writes the tile's rows.
template <class Values>
__device__ __forceinline__ void slab_stage(const SlabArgs& a, int tile,
                                           const SlabTile& t,
                                           SlabShared* sh) {
  constexpr int C = Values::kChannels, I = Values::kInputs;
  constexpr int P = packed(I);
  const int wx = a.wx, wy = a.wy, wz = a.wz;
  const unsigned none = static_cast<unsigned>(t.keys) << t.shift;
  if (threadIdx.x == 0) {
    a.meta[2 * tile] = t.ylo;
    a.meta[2 * tile + 1] = t.rows;
  }
  for (int q = threadIdx.x; q < a.tile; q += blockDim.x) {
    t.sorted[q] = 0xffffffffu;
    if (q >= t.count) continue;
    const int p = t.p0 + q;
    if (!Values::active(a.src, a.n, p)) {
      Values::skip(a, p);
      continue;
    }
    Axis ax[3];
    int rel[3];
    particle_stencil(a.x, a.n, p, a.corner, a.inv_dx, ax, rel);
    Values::finish(a, p, ax, rel);
    float* v = reinterpret_cast<float*>(t.vals + q * P);
    for (int c = 0; c < 4 * P; ++c) v[c] = c < I ? a.src[c * a.n + p] : 0.f;
    for (int d = 0; d < 3; ++d) {
      for (int o = 0; o < 3; ++o) {
        t.wts[9 * q + 3 * d + o] = make_float2(ax[d].w[o], ax[d].wd[o]);
      }
    }
    const int by = rel[1] - t.ylo + 2;
    const bool binned = rel[0] >= -2 && rel[0] < wx && rel[2] >= -2
                        && rel[2] < wz && by >= 0 && by < t.rows + 2;
    t.sorted[q] = binned
        ? static_cast<unsigned>(((by * (wz + 2)) + rel[2] + 2) * (wx + 2)
                                + rel[0] + 2) << t.shift | q
        : none | q;
    // the rows outside the slab
    const int r0 = imax(rel[1], 0), r1 = imin(rel[1] + 3, wy);
    if (r0 >= r1 || (r0 >= t.ylo && r1 <= t.ylo + t.rows)) continue;
    const Values val(a.src + p, a.n, 0);
    for (int j = 0; j < 3; ++j) {
      const int cy = rel[1] + j;
      if (cy < 0 || cy >= wy || (cy >= t.ylo && cy < t.ylo + t.rows)) continue;
      for (int k = 0; k < 3; ++k) {
        const int cz = rel[2] + k;
        if (cz < 0 || cz >= wz) continue;
        const float wyz = ax[1].w[j] * ax[2].w[k];
        const float dyz = ax[1].wd[j] * ax[2].w[k];
        const float ydz = ax[1].w[j] * ax[2].wd[k];
        for (int i = 0; i < 3; ++i) {
          const int cx = rel[0] + i;
          if (cx < 0 || cx >= wx) continue;
          const float wgt = ax[0].w[i] * wyz;
          const float dwx = ax[0].wd[i] * wyz;
          const float dwy = ax[0].w[i] * dyz;
          const float dwz = ax[0].w[i] * ydz;
          double* cell = a.spill + (cy * wz + cz) * C * wx + cx;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            atomicAdd(cell + c * wx, static_cast<double>(
                val.value(c, wgt, dwx, dwy, dwz)));
          }
        }
      }
    }
    atomicAdd(&sh->spilled, 1u);
  }
}

// phase 3: one step (k, j) of the bitonic network over the tile's entries
__device__ __forceinline__ void slab_sort_step(const SlabArgs& a,
                                               const SlabTile& t, int k,
                                               int j) {
  for (int i = threadIdx.x; i < a.tile; i += blockDim.x) {
    const int l = i ^ j;
    if (l <= i) continue;
    const unsigned u = t.sorted[i], v = t.sorted[l];
    if (((i & k) == 0) == (u > v)) {
      t.sorted[i] = v;
      t.sorted[l] = u;
    }
  }
}

// phase 4: the first sorted entry of each key (start[keys]: the binned
// particles' count), and each binned entry decoded to its particle and
// base x
__device__ __forceinline__ void slab_offsets(const SlabArgs& a,
                                             const SlabTile& t) {
  for (int key = threadIdx.x; key <= t.keys; key += blockDim.x) {
    const unsigned bound = static_cast<unsigned>(key) << t.shift;
    int lo = 0, hi = a.tile;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (t.sorted[mid] < bound) lo = mid + 1; else hi = mid;
    }
    t.start[key] = lo;
  }
  const unsigned none = static_cast<unsigned>(t.keys) << t.shift;
  for (int s = threadIdx.x; s < a.tile; s += blockDim.x) {
    const unsigned v = t.sorted[s];
    if (v >= none) continue;
    const unsigned bx = (v >> t.shift) % static_cast<unsigned>(a.wx + 2);
    t.ent[s] = (v & ((1u << t.shift) - 1)) | bx << 16;
  }
}

// one pair of phase 5: sorted entry s (base x cx + 2 - i at offsets j, k
// from the cell) added to acc
template <class Values>
__device__ __forceinline__ void slab_pair(const SlabTile& t, int s, int cx,
                                          int j, int k, double* acc) {
  constexpr int C = Values::kChannels, P = packed(Values::kInputs);
  const unsigned e = t.ent[s];
  const int q = static_cast<int>(e & 0xffffu);
  const int i = cx + 2 - static_cast<int>(e >> 16);
  const float2 w0 = t.wts[9 * q + i];
  const float2 w1 = t.wts[9 * q + 3 + j];
  const float2 w2 = t.wts[9 * q + 6 + k];
  const float wyz = w1.x * w2.x, dyz = w1.y * w2.x, ydz = w1.x * w2.y;
  const Values val(t.vals + q * P);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    acc[c] += static_cast<double>(val.value(
        c, w0.x * wyz, w0.y * wyz, w0.x * dyz, w0.x * ydz));
  }
}

// phase 5, one part: the sums of slab cell `cell` (r * wz * wx + cz * wx +
// cx) over the particles of its 27 base cells. For each (j, k) the base
// cells x - 2 .. x are one range of the sorted list, taken two entries at
// a time into two sums (the even and the odd entries of each range, added
// at the end: a fixed order), so that two pairs' loads are in flight.
template <class Values>
__device__ __forceinline__ void slab_cell(const SlabArgs& a,
                                          const SlabTile& t, int cell,
                                          double* acc) {
  constexpr int C = Values::kChannels;
  const int wx = a.wx, wz = a.wz, plane = wz * wx;
  const int r = cell / plane, cz = (cell - r * plane) / wx;
  const int cx = cell - r * plane - cz * wx;
  double odd[C];
#pragma unroll
  for (int c = 0; c < C; ++c) odd[c] = 0.0;
#pragma unroll 1
  for (int jk = 0; jk < 9; ++jk) {
    const int j = jk / 3, k = jk - 3 * j;
    const int key = (((r + 2 - j) * (wz + 2)) + cz + 2 - k) * (wx + 2) + cx;
    const int end = t.start[key + 3];
    int s = t.start[key];
    for (; s + 1 < end; s += 2) {
      slab_pair<Values>(t, s, cx, j, k, acc);
      slab_pair<Values>(t, s + 1, cx, j, k, odd);
    }
    if (s < end) slab_pair<Values>(t, s, cx, j, k, acc);
  }
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] += odd[c];
}

// phase 5, the other part: a cell's sums, written once to the tile's
// partial buffer
template <class Values>
__device__ __forceinline__ void slab_put(const SlabArgs& a, int tile,
                                         int cell, const double* acc) {
  constexpr int C = Values::kChannels;
  const int plane = a.wz * a.wx, r = cell / plane;
  double* out = a.partial + tile * a.plan.tile_doubles
                + r * plane * C + (cell - r * plane) / a.wx * C * a.wx
                + cell % a.wx;
#pragma unroll
  for (int c = 0; c < C; ++c) out[c * a.wx] = acc[c];
}

// after phase 5 (thread 0): the tile's spilled particles to the count
template <class Values>
__device__ __forceinline__ void slab_count(const SlabArgs& a,
                                           const SlabShared* sh) {
  if (sh->spilled > 0) {
    const long long cells = static_cast<long long>(a.wx) * a.wy * a.wz;
    atomicAdd(reinterpret_cast<unsigned long long*>(
                  a.spill + Values::kChannels * cells),
              static_cast<unsigned long long>(sh->spilled));
  }
}

// The second launch. A block of it takes consecutive accumulation indices,
// which lie in at most two y rows (first, last). Phase 0 clears a bit for
// each tile and row, phase 1 sets those of the tiles whose slab covers the
// row, phase 2 lists for each of the two rows the offsets of those tiles'
// partials in tile order, and phase 3 sums each index's partials over its
// row's list, adds the spill window and rounds to float32 once. The sum
// takes kReduceWays partials at a time into as many sums (entry i into sum
// i mod kReduceWays), added at the end in a fixed tree: a fixed order, with
// that many loads in flight where one sum would wait for each load in turn
// (a tile covers a few rows, a row is covered by tens of tiles).
constexpr int kReduceWays = 8;

__host__ __device__ __forceinline__ int slab_words(const SlabArgs& a) {
  return (a.plan.tiles + 31) / 32;
}

// Dynamic shared bytes of a reduce block: the two rows' lists (tiles each),
// then the two rows' bits
__host__ __device__ __forceinline__ int slab_reduce_smem(const SlabArgs& a) {
  return 16 * a.plan.tiles + 8 * slab_words(a);
}

__device__ __forceinline__ void slab_reduce_clear(const SlabArgs& a,
                                                  unsigned* bits) {
  for (int w = threadIdx.x; w < 2 * slab_words(a); w += blockDim.x) {
    bits[w] = 0u;
  }
}

__device__ __forceinline__ void slab_reduce_mark(const SlabArgs& a, int first,
                                                 int last, unsigned* bits) {
  const int plane = a.wz * a.plan.channels * a.wx;
  const int cy0 = first / plane, cy1 = last / plane, words = slab_words(a);
  const int2* meta = reinterpret_cast<const int2*>(a.meta);
  for (int t = threadIdx.x; t < a.plan.tiles; t += blockDim.x) {
    const int2 m = __ldg(meta + t);         // (ylo, rows)
    const unsigned bit = 1u << (t & 31);
    if (cy0 >= m.x && cy0 < m.x + m.y) atomicOr(bits + (t >> 5), bit);
    if (cy1 >= m.x && cy1 < m.x + m.y) atomicOr(bits + words + (t >> 5), bit);
  }
}

// a tile's partial of index e lies at partial[e + offset], offset =
// t * tile_doubles - ylo_t * plane; one thread a word of bits writes its
// tiles' offsets where the words before it in its row end
__device__ __forceinline__ void slab_reduce_list(const SlabArgs& a,
                                                 const unsigned* bits,
                                                 long long* list) {
  const int words = slab_words(a);
  const int plane = a.wz * a.plan.channels * a.wx;
  const int2* meta = reinterpret_cast<const int2*>(a.meta);
  for (int w = threadIdx.x; w < 2 * words; w += blockDim.x) {
    const int r = w / words, j = w - r * words;
    int k = 0;
    for (int i = 0; i < j; ++i) k += __popc(bits[r * words + i]);
    long long* mine = list + static_cast<long long>(r) * a.plan.tiles;
    for (unsigned b = bits[w]; b != 0u; b &= b - 1u) {
      const int t = 32 * j + __ffs(static_cast<int>(b)) - 1;
      mine[k++] = t * a.plan.tile_doubles
                  - static_cast<long long>(__ldg(meta + t).x) * plane;
    }
  }
}

__device__ __forceinline__ void slab_reduce(const SlabArgs& a, int first,
                                            int e, const unsigned* bits,
                                            const long long* list,
                                            float* out) {
  const int C = a.plan.channels, wx = a.wx, words = slab_words(a);
  const int rowd = C * wx, plane = a.wz * rowd;
  const int row = e / rowd, cy = row / a.wz;
  const int r = cy == first / plane ? 0 : 1;
  int count = 0;
  for (int w = 0; w < words; ++w) count += __popc(bits[r * words + w]);
  const long long* offs = list + static_cast<long long>(r) * a.plan.tiles;
  const double* src = a.partial + e;
  double sum[kReduceWays];
#pragma unroll
  for (int k = 0; k < kReduceWays; ++k) sum[k] = 0.0;
  for (int i = 0; i < count; i += kReduceWays) {
    double v[kReduceWays];
#pragma unroll
    for (int k = 0; k < kReduceWays; ++k) {
      v[k] = i + k < count ? __ldg(src + offs[i + k]) : 0.0;
    }
#pragma unroll
    for (int k = 0; k < kReduceWays; ++k) sum[k] += v[k];
  }
#pragma unroll
  for (int h = kReduceWays / 2; h > 0; h >>= 1) {
#pragma unroll
    for (int k = 0; k < h; ++k) sum[k] += sum[k + h];
  }
  const double acc = sum[0] + a.spill[e];
  const int c = (e - row * rowd) / wx, cx = e - row * rowd - c * wx;
  const int cells = wx * a.wy * a.wz;
  const int lead = a.lead;
  const int idx = c < lead
      ? c * cells + row * wx + cx
      : lead * cells + (row * (C - lead) + c - lead) * wx + cx;
  out[idx] = static_cast<float>(acc);
}

#ifdef __CUDACC__
template <class Values>
__global__ void __launch_bounds__(kSlabThreads) slab_scatter(SlabArgs a) {
  extern __shared__ float4 slab_smem[];
  __shared__ SlabShared sh;
  const int tile = blockIdx.x;
  slab_begin(a, &sh);
  __syncthreads();
  slab_bounds<Values>(a, tile, &sh);
  __syncthreads();
  const SlabTile t = slab_tile(a, tile, &sh, slab_smem);
  slab_stage<Values>(a, tile, t, &sh);
  if (t.rows == 0) return;      // no particle reaches the window
  for (int k = 2; k <= a.tile; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      __syncthreads();
      slab_sort_step(a, t, k, j);
    }
  }
  __syncthreads();
  slab_offsets(a, t);
  __syncthreads();
  // phase 5: one thread a slab cell, each thread taking the next cell as it
  // finishes one (the particles crowd into few cells of a slab: a glass's
  // footprint)
  for (;;) {
    const int cell = atomicAdd(&sh.next, 1);
    if (cell >= t.rows * a.wz * a.wx) break;
    double acc[Values::kChannels];
#pragma unroll
    for (int c = 0; c < Values::kChannels; ++c) acc[c] = 0.0;
    slab_cell<Values>(a, t, cell, acc);
    slab_put<Values>(a, tile, cell, acc);
  }
  if (threadIdx.x == 0) slab_count<Values>(a, &sh);
}

template <class Values>
__global__ void slab_reduce_kernel(SlabArgs a, float* __restrict__ out) {
  extern __shared__ long long slab_list[];
  unsigned* bits = reinterpret_cast<unsigned*>(slab_list + 2 * a.plan.tiles);
  const int count = a.plan.channels * a.wx * a.wy * a.wz;
  const int first = blockIdx.x * blockDim.x;
  const int last = imin(first + static_cast<int>(blockDim.x), count) - 1;
  slab_reduce_clear(a, bits);
  __syncthreads();
  slab_reduce_mark(a, first, last, bits);
  __syncthreads();
  slab_reduce_list(a, bits, slab_list);
  __syncthreads();
  const int e = first + threadIdx.x;
  if (e <= last) slab_reduce(a, first, e, bits, slab_list, out);
}

// Dynamic shared memory above 48 KB only after opting in, once for each
// device and kernel
template <class Kernel>
inline void slab_allow(Kernel kernel, int bytes, unsigned& opted) {
  if (bytes <= 48 * 1024) return;
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(opted >> dev & 1u)) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSlabSmemMax);
    opted |= 1u << dev;
  }
}

// The two launches of one call; returns cudaGetLastError().
template <class Values>
inline int slab_launch(const SlabArgs& a, float* out, cudaStream_t s) {
  static unsigned scatter_opted = 0, reduce_opted = 0;
  if (a.plan.tiles > 0) {
    slab_allow(slab_scatter<Values>, a.plan.smem, scatter_opted);
    slab_scatter<Values><<<a.plan.tiles, kSlabThreads, a.plan.smem, s>>>(a);
  }
  const int count = a.plan.channels * a.wx * a.wy * a.wz;
  const int smem = slab_reduce_smem(a);
  slab_allow(slab_reduce_kernel<Values>, smem, reduce_opted);
  slab_reduce_kernel<Values><<<blocks_for(count), kThreads, smem, s>>>(a,
                                                                       out);
  return static_cast<int>(cudaGetLastError());
}
#endif

}  // namespace softmac
