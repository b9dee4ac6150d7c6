// The row-thread design of the door's eight dense-weight kernels: P2G,
// G2P, the splat and the gather (fused_p2g.cu, fused_g2p.cu,
// fused_splat.cu, fused_gather.cu), and the P2G, G2P, splat and gather
// backwards (fused_p2g_bwd.cu, fused_g2p_bwd.cu, fused_splat_bwd.cu,
// fused_gather_bwd.cu): many threads a particle instead of one.
//
// The backwards' function. For one particle, each of the four forwards,
// dotted with its output cotangent, is a sum over the window cells c =
// (x, y, z) (row y * wz + z, column x) of a form linear in each axis's
// weights:
//   f = sum_c  Wx[x]  Wy[y]  Wz[z]  s.h(c)  + WxD[x] Wy[y]  Wz[z]  s.d0(c)
//            + Wx[x]  WDy[y] Wz[z]  s.d1(c) + Wx[x]  Wy[y]  WDz[z] s.d2(c)
// where the cell coefficients s(c) pair the output cotangent at c with the
// particle's own channels (P2G, splat), or the grids at c with the
// particle's output cotangent (G2P, gather); the splat and the gather have
// no derivative weights (s.d0 = s.d1 = s.d2 = 0). The cotangent of a
// weight entry on row r of axis A is the partial derivative of f: it sums
// the cell coefficients over the particle's box in the plane of the two
// other axes (a, b), for every row r of the window, zeros included (zero
// for every r where the box on a or b is empty: a stencil that left the
// window there). The box on each axis is the range of the rows where W or
// WD is nonzero, so it covers every weight a term reads. Every row of
// every output is written: no memset.
//
// A kernel's Kind (derived from RowsKind, whose hooks it may replace)
// says what it has: kDeriv, derivative weights WD (the splat, the gather
// and their backwards have none: WD is null, never read, and their rows
// dWD are not written); kRows, weight rows to write (P2G, G2P, the splat
// and the gather have none: their work is the extra tasks alone);
// kScatter, the channels its extra tasks add into a float64 window
// (rows_scatter: P2G 4, the splat and the G2P and gather backwards 3; 0
// for G2P, the gather and the P2G and splat backwards, whose extra tasks
// are sums over the box, box_sums: G2P's 12 output rows, the gather's 3,
// the P2G backward's 13 channel and the splat backward's 3 value
// cotangents); kLines, the window's layout (acc_at); kWindow, whether a
// narrow tile's scatter goes through a window in shared memory (not the
// splat's); live(a, p), whether particle p has work at all (the splat: a
// nonzero value): a particle that has none keeps an empty box and its
// weights are never read, and a block with no live particle ends after
// the vote.
//
// A tile of kRowLanes consecutive particles, one a lane, goes to a block
// of kRowWarps warps, or, where the tiles are too few to fill the card, to
// up to kRowParts blocks that share its tasks (rows_parts). A first launch
// writes the grids' other layouts (rows_prep; none without weight rows).
// A block's phases, a barrier between each:
//   1. begin: empty boxes and a window of zeros in shared memory; the
//      block's vote (rows_live): without a live particle it ends here;
//   2. box: the warps split the window's rows; each thread reads its live
//      particle's W (and WD) on its rows, kBoxBatch rows before it tests
//      them (coalesced: lanes are consecutive particles), widens the
//      particle's box by shared atomicMin / Max and keeps the nonzero
//      entries in shared memory at row % kBoxCap (exact for a box at most
//      kBoxCap rows wide, a B-spline stencil's 3);
//   3. pairs: where every box of the block is that narrow on every axis,
//      each particle's pair products over its box in each plane (only the
//      (y, z) plane without weight rows), P0 = W_a W_b, Pa = WD_a W_b,
//      Pb = W_a WD_b (P0 alone without WD), formed once in double from the
//      kept entries and kept in shared memory, and the tile's scatter
//      window, the union of its boxes; wider boxes (dense weights) read
//      the products from device memory as they go, and scatter to device
//      memory;
//   4. x rows (with weight rows), shared out among a tile's blocks: one
//      warp a particle for its x rows, one lane a row, kept in shared
//      memory (up to kXTile of them);
//   5. store: the kept x rows written a row of 32 consecutive particles at
//      a time;
//   6. tasks, shared out among a tile's blocks: one thread a (particle,
//      extra task) of the kernel's own (G2P, the gather, the P2G and splat
//      backwards: the sums of box_sums; P2G, the splat, the G2P and gather
//      backwards: the scatter of rows_scatter, into the tile's window where
//      it fits, in the x rows' space); then one thread a (particle, y or z
//      weight row);
//   7. flush: the window added to device memory.
// A row's thread visits its box cells in the plane once, reads the
// cotangent grids there and keeps, in double, the sums
//   m0 = sum P0 G_mass (P2G),  B_d = sum P0 G_d,
//   Ca_d = sum Pa G_d,  Cb_d = sum Pb G_d
// of the three component grids G_d, then
//   dW_A  = mass m0 + sum_d ch_d B_d + m[d][a] Ca_d + m[d][b] Cb_d,
//   dWD_A = sum_d m[d][A] B_d,
// with (ch, m) the particle's own rows: P2G (mom, dx*affine), G2P the
// cotangents of (v, C), the splat its values, the gather its cotangent dv
// (no m, no Ca, Cb or dWD without WD). The x rows read the grids as they
// are, (y, z) rows of x: a warp of one particle's x rows reads each box
// cell's line once, whole. The y and z rows (lanes: particles, y-sorted in
// the rollout) read the first launch's copies with y, or z, fastest.
// Each weight or channel output is one thread's, written once, rounded
// once, in a fixed order; a float64 window takes atomicAdds and is
// rounded once by a last launch (the splat's, kept between calls, is left
// zeroed by it: round_and_clear).
#pragma once

#include "fused.cuh"

namespace softmac {

constexpr int kRowLanes = 32;      // particles a tile, one a lane
constexpr int kRowWarps = 8;       // warps a block (a tile, or a part of one)
constexpr int kRowThreads = kRowLanes * kRowWarps;
constexpr int kRowBlocks = 3;      // blocks an SM (launch bounds: 80 registers)
constexpr int kRowParts = 4;       // blocks a tile's tasks go to, at most
constexpr int kBoxCap = 3;         // box rows a staged axis holds
constexpr int kBoxBatch = 4;       // rows a box-phase thread loads at once
constexpr int kBoxCells = kBoxCap * kBoxCap;
constexpr int kXTile = 64;         // x rows a block keeps for its stores
// doubles of a tile's scatter window (rows_scatter), in the x rows' space
constexpr int kWinDoubles = kXTile * (kRowLanes + 1);

inline int rows_blocks(int n) { return (n + kRowLanes - 1) / kRowLanes; }

struct RowsArgs {
  const float* w[6];      // Wx, WxD, Wy, WDy, Wz, WDz, (size[axis], n) each
                          // (the WD null without derivative weights)
  const float* grid[4];   // the grids the weight rows read (the P2G
                          // backward: mass, then momentum cotangents)
  int row_stride[4];      // floats from a grid's (y, z) row to the next
  const float* rows;      // the particle rows: P2G chan (13, n) (and its
                          // backward's), G2P's g (12, n), the splat's vals
                          // and the gather's dv (3, n); null for G2P
  float* out;             // the weight rows (2 (wx + wy + wz) [+ 13], n),
                          // without WD (wx + wy + wz [+ 3], n), then the
                          // sums of box_sums; G2P's (12, n); null for P2G
  double* acc;            // the float64 window of rows_scatter
  float* yt;              // the grids as (z, x, y), one after the other
  float* zt;              // the grids as (y, x, z)
  int n;
  int size[3];            // wx, wy, wz
};

struct RowsShared {
  double pair[3][kBoxCells][3][kRowLanes];   // [plane][cell][P0, Pa, Pb]
  union {
    float xout[2 * kXTile][kRowLanes + 1];    // dWx, dWxD rows (padded)
    double win[kWinDoubles];                  // the tile's scatter window
  };
  float ent[3][kBoxCap][2][kRowLanes];        // [axis][row % kBoxCap][W, WD]
  int lo[3][kRowLanes], hi[3][kRowLanes];
  int wlo[3], whi[3];     // the scatter window's rows on each axis
};

// The hooks a Kind may replace (a Kind derives from RowsKind).
struct RowsKind {
  // the float64 window's layout: the last three channels interleaved a
  // row, (wy*wz, 3*wx) (kLines), or each its own (wy*wz, wx) grid
  static constexpr bool kLines = false;
  // whether a narrow tile's scatter goes through the tile's window in
  // shared memory (rows_window), where it fits; else to device memory
  static constexpr bool kWindow = true;

  // whether particle p (< a.n) has work: every particle, unless the Kind
  // says otherwise
  __device__ static bool live(const RowsArgs&, int) { return true; }
};

// the two other axes of axis A, in index order
__host__ __device__ constexpr int plane_a(int A) { return A == 0 ? 1 : 0; }
__host__ __device__ constexpr int plane_b(int A) { return A == 2 ? 1 : 2; }

__device__ __forceinline__ int rows_lane() { return threadIdx.x % kRowLanes; }
__device__ __forceinline__ int rows_warp() { return threadIdx.x / kRowLanes; }
__device__ __forceinline__ int rows_particle() {
  return blockIdx.x * kRowLanes + rows_lane();
}

__device__ __forceinline__ int box_len(const RowsShared& sh, int ax,
                                       int lane) {
  const int l = sh.hi[ax][lane] - sh.lo[ax][lane] + 1;
  return l > 0 ? l : 0;
}

// Phase 1: empty boxes, no kept entries; with a scatter (kScatter
// channels), an empty window of zeros.
template <int kScatter>
__device__ __forceinline__ void rows_begin(RowsShared* sh) {
  const int t = threadIdx.x;
  if (t < 3 * kRowLanes) {
    sh->lo[t / kRowLanes][t % kRowLanes] = 1 << 30;
    sh->hi[t / kRowLanes][t % kRowLanes] = -1;
  }
  float* ent = &sh->ent[0][0][0][0];
  for (int i = t; i < 3 * kBoxCap * 2 * kRowLanes; i += kRowThreads) {
    ent[i] = 0.0f;
  }
  if (kScatter > 0) {
    for (int i = t; i < kWinDoubles; i += kRowThreads) sh->win[i] = 0.0;
  }
}

// This thread's vote for running the block: its particle is live.
template <class Kind>
__device__ __forceinline__ bool rows_live(const RowsArgs& a) {
  const int p = rows_particle();
  return p < a.n && Kind::live(a, p);
}

// A batch of the box phase: W (and WD) of axis ax on the rows r0 + k
// kRowWarps of particle p (zero past the axis's rows).
template <bool kDeriv>
__device__ __forceinline__ void box_load(const RowsArgs& a, int ax, int r0,
                                         int p, float w[kBoxBatch],
                                         float d[kBoxBatch]) {
  const int size = a.size[ax];
#pragma unroll
  for (int k = 0; k < kBoxBatch; ++k) {
    const int r = r0 + k * kRowWarps;
    const size_t i = static_cast<size_t>(r) * a.n + p;
    w[k] = r < size ? __ldg(a.w[2 * ax] + i) : 0.0f;
    d[k] = kDeriv && r < size ? __ldg(a.w[2 * ax + 1] + i) : 0.0f;
  }
}

// A loaded batch tested: each nonzero entry widens the particle's box on
// axis ax and is kept.
__device__ __forceinline__ void box_keep(RowsShared* sh, int ax, int r0,
                                         int lane, const float w[kBoxBatch],
                                         const float d[kBoxBatch]) {
#pragma unroll
  for (int k = 0; k < kBoxBatch; ++k) {
    const int r = r0 + k * kRowWarps;
    if (w[k] != 0.0f || d[k] != 0.0f) {
      atomicMin(&sh->lo[ax][lane], r);
      atomicMax(&sh->hi[ax][lane], r);
      sh->ent[ax][r % kBoxCap][0][lane] = w[k];
      sh->ent[ax][r % kBoxCap][1][lane] = d[k];
    }
  }
}

// Phase 2: the boxes of the live particles (a particle that is not live
// keeps its empty box; its weights are not read). The first batch of
// every axis is loaded before any is tested: one round trip to memory
// where no axis has more than kBoxBatch * kRowWarps rows (the door's).
template <class Kind>
__device__ __forceinline__ void rows_box(const RowsArgs& a, RowsShared* sh) {
  constexpr bool kDeriv = Kind::kDeriv;
  constexpr int kStep = kBoxBatch * kRowWarps;
  const int lane = rows_lane(), p = rows_particle(), r0 = rows_warp();
  if (!rows_live<Kind>(a)) return;
  float w[3][kBoxBatch], d[3][kBoxBatch];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) box_load<kDeriv>(a, ax, r0, p, w[ax], d[ax]);
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    box_keep(sh, ax, r0, lane, w[ax], d[ax]);
    for (int r = r0 + kStep; r < a.size[ax]; r += kStep) {
      box_load<kDeriv>(a, ax, r, p, w[ax], d[ax]);
      box_keep(sh, ax, r, lane, w[ax], d[ax]);
    }
  }
}

__device__ __forceinline__ const float* grid_of(const RowsArgs& a, int q) {
  return q == 0 ? a.grid[0] : q == 1 ? a.grid[1] : q == 2 ? a.grid[2]
                                                          : a.grid[3];
}

__device__ __forceinline__ int stride_of(const RowsArgs& a, int q) {
  return q == 0 ? a.row_stride[0] : q == 1 ? a.row_stride[1]
         : q == 2 ? a.row_stride[2] : a.row_stride[3];
}

// The first launch, one thread an element i: the kGrids grids again with y
// fastest (yt) and with z fastest (zt), so that the y and z rows read
// their box cells' runs of rows whole; and the three-grid float64 window
// of the G2P and gather backwards zeroed.
template <int kGrids>
__device__ __forceinline__ void rows_prep_at(const RowsArgs& a, int i) {
  const int wx = a.size[0], wy = a.size[1], wz = a.size[2];
  const int cells = wx * wy * wz;
  if (a.acc != nullptr && i < 3 * cells) a.acc[i] = 0.0;
  if (i >= kGrids * cells) return;
  const int q = i / cells, c = i - q * cells;
  const int row = c / wx, x = c - row * wx;
  const int y = row / wz, z = row - y * wz;
  const float v = __ldg(grid_of(a, q) + row * stride_of(a, q) + x);
  a.yt[q * cells + (z * wx + x) * wy + y] = v;
  a.zt[q * cells + (y * wx + x) * wz + z] = v;
}

// This thread's vote for staging the pair products: its particle's box
// (one thread an axis and particle) fits kBoxCap rows.
__device__ __forceinline__ bool rows_fit(const RowsShared& sh) {
  const int t = threadIdx.x;
  if (t >= 3 * kRowLanes) return true;
  return sh.hi[t / kRowLanes][t % kRowLanes]
             - sh.lo[t / kRowLanes][t % kRowLanes] < kBoxCap;
}

// The pair products of plane A at box cell (ia, ib), from device memory
// (Pa, Pb zero without derivative weights).
template <int A, bool kDeriv>
__device__ __forceinline__ void pair_at(const RowsArgs& a,
                                        const RowsShared& sh, int lane, int p,
                                        int ia, int ib, double* p0,
                                        double* pa, double* pb) {
  constexpr int ax = plane_a(A), bx = plane_b(A);
  const int ra = sh.lo[ax][lane] + ia, rb = sh.lo[bx][lane] + ib;
  const double wa = at(a.w[2 * ax], ra, a.n, p);
  const double wb = at(a.w[2 * bx], rb, a.n, p);
  *p0 = wa * wb;
  *pa = *pb = 0.0;
  if constexpr (kDeriv) {
    *pa = at(a.w[2 * ax + 1], ra, a.n, p) * wb;
    *pb = wa * at(a.w[2 * bx + 1], rb, a.n, p);
  }
}

// W (k 0) or WD (k 1) of axis ax on row `row` of the block's particle in
// lane `lane` (particle p), a row of its box: kept (narrow) or from device
// memory.
template <int ax>
__device__ __forceinline__ double box_weight(const RowsArgs& a,
                                             const RowsShared& sh,
                                             bool narrow, int k, int row,
                                             int lane, int p) {
  return narrow ? static_cast<double>(sh.ent[ax][row % kBoxCap][k][lane])
                : at(a.w[2 * ax + k], row, a.n, p);
}

// The pair products of plane A at box cell (ia, ib): staged (narrow) or
// from device memory.
template <int A, bool kDeriv>
__device__ __forceinline__ void plane_pair(const RowsArgs& a,
                                           const RowsShared& sh, bool narrow,
                                           int lane, int p, int ia, int ib,
                                           double* p0, double* pa,
                                           double* pb) {
  if (narrow) {
    const int c = ia * kBoxCap + ib;
    *p0 = sh.pair[A][c][0][lane];
    *pa = kDeriv ? sh.pair[A][c][1][lane] : 0.0;
    *pb = kDeriv ? sh.pair[A][c][2][lane] : 0.0;
  } else {
    pair_at<A, kDeriv>(a, sh, lane, p, ia, ib, p0, pa, pb);
  }
}

// The pair products of plane A at box cell c of a narrow box, from the
// entries the box phase kept.
template <int A, bool kDeriv>
__device__ __forceinline__ void stage_pairs(RowsShared* sh, int lane,
                                            int c) {
  constexpr int ax = plane_a(A), bx = plane_b(A);
  const int ia = c / kBoxCap, ib = c - ia * kBoxCap;
  double p0 = 0.0, pa = 0.0, pb = 0.0;
  if (ia < box_len(*sh, ax, lane) && ib < box_len(*sh, bx, lane)) {
    const int sa = (sh->lo[ax][lane] + ia) % kBoxCap;
    const int sb = (sh->lo[bx][lane] + ib) % kBoxCap;
    const double wa = sh->ent[ax][sa][0][lane], da = sh->ent[ax][sa][1][lane];
    const double wb = sh->ent[bx][sb][0][lane], db = sh->ent[bx][sb][1][lane];
    p0 = wa * wb;
    pa = da * wb;
    pb = wa * db;
  }
  sh->pair[A][c][0][lane] = p0;
  if constexpr (kDeriv) {
    sh->pair[A][c][1][lane] = pa;
    sh->pair[A][c][2][lane] = pb;
  }
}

// The tile's scatter window (phase 3, threads 0-2, one an axis): the
// rows of the union of its particles' boxes.
template <int kScatter>
__device__ __forceinline__ void rows_window(RowsShared* sh) {
  const int ax = threadIdx.x;
  if (kScatter == 0 || ax >= 3) return;
  int lo = 1 << 30, hi = -1;
  for (int q = 0; q < kRowLanes; ++q) {
    lo = sh->lo[ax][q] < lo ? sh->lo[ax][q] : lo;
    hi = sh->hi[ax][q] > hi ? sh->hi[ax][q] : hi;
  }
  sh->wlo[ax] = lo;
  sh->whi[ax] = hi;
}

// The cells of the tile's window, its rows an axis in n; 0 where its kChan
// channels do not fit kWinDoubles (the scatter then adds to device
// memory).
template <int kChan>
__device__ __forceinline__ int window_cells(const RowsShared& sh, int n[3]) {
  int cells = 1;
  for (int b = 0; b < 3; ++b) {
    n[b] = sh.whi[b] >= sh.wlo[b] ? sh.whi[b] - sh.wlo[b] + 1 : 0;
    cells *= n[b];
  }
  return kChan * cells <= kWinDoubles ? cells : 0;
}

// The channels of a kernel's window in shared memory: its scatter's,
// unless it scatters to device memory alone (Kind::kWindow false).
template <class Kind>
__host__ __device__ constexpr int window_channels() {
  return Kind::kWindow ? Kind::kScatter : 0;
}

// Whether the block's scatter goes through its window: a narrow tile
// whose window fits.
template <class Kind>
__device__ __forceinline__ bool rows_local(const RowsShared& sh,
                                           bool narrow) {
  int n[3];
  return window_channels<Kind>() > 0 && narrow
         && window_cells<Kind::kScatter>(sh, n) > 0;
}

// The planes whose pair products a kernel reads: the three of the weight
// rows, or the (y, z) plane alone (the extra tasks' plane 0).
template <class Kind>
__host__ __device__ constexpr int row_planes() { return Kind::kRows ? 3 : 1; }

template <bool kDeriv, int kPlanes>
__device__ __forceinline__ void rows_pairs(const RowsArgs& a,
                                           RowsShared* sh) {
  const int lane = rows_lane(), p = rows_particle();
  if (p >= a.n) return;
  for (int t = rows_warp(); t < kPlanes * kBoxCells; t += kRowWarps) {
    const int c = t % kBoxCells;
    if (t < kBoxCells) {
      stage_pairs<0, kDeriv>(sh, lane, c);
    } else if (t < 2 * kBoxCells) {
      stage_pairs<1, kDeriv>(sh, lane, c);
    } else {
      stage_pairs<2, kDeriv>(sh, lane, c);
    }
  }
}

// Grid q at cell (x, y, z), from the layout whose fastest axis is A: the
// grid itself (x), yt or zt.
template <int A>
__device__ __forceinline__ double cell_at(const RowsArgs& a, int q, int x,
                                          int y, int z) {
  const int wx = a.size[0], wy = a.size[1], wz = a.size[2];
  const int cells = wx * wy * wz;
  if constexpr (A == 0) {
    return __ldg(a.grid[q] + (y * wz + z) * a.row_stride[q] + x);
  } else if constexpr (A == 1) {
    return __ldg(a.yt + q * cells + (z * wx + x) * wy + y);
  } else {
    return __ldg(a.zt + q * cells + (y * wx + x) * wz + z);
  }
}

struct RowSums {
  double w, wd;     // the row of dW_A and of dWD_A
};

// Row `row` of axis A of the weight cotangents of the block's particle in
// lane `lane` (particle p): the sums of the header comment. Kind::kGrids
// 4: the mass grid first (the P2G backward), else the three component
// grids only (the G2P and gather backwards); the particle rows hold
// (ch_d, m[d][j]) from row kGrids - 3 on (no m without derivative
// weights, Kind::kDeriv false: then only the B_d, and no dWD row).
template <class Kind, int A>
__device__ __forceinline__ RowSums weight_row(const RowsArgs& a,
                                              const RowsShared& sh,
                                              bool narrow, int row, int lane,
                                              int p) {
  constexpr int ax = plane_a(A), bx = plane_b(A);
  constexpr int kGrids = Kind::kGrids, q0 = kGrids - 3;
  constexpr bool kDeriv = Kind::kDeriv;
  const int la = box_len(sh, ax, lane), lb = box_len(sh, bx, lane);
  const int a0 = sh.lo[ax][lane], b0 = sh.lo[bx][lane];
  double m0 = 0.0, B[3] = {0.0, 0.0, 0.0}, Ca[3] = {0.0, 0.0, 0.0},
         Cb[3] = {0.0, 0.0, 0.0};
  for (int ia = 0; ia < la; ++ia) {
    for (int ib = 0; ib < lb; ++ib) {
      double p0, pa, pb;
      plane_pair<A, kDeriv>(a, sh, narrow, lane, p, ia, ib, &p0, &pa, &pb);
      const int x = A == 0 ? row : a0 + ia;
      const int y = A == 1 ? row : (A == 0 ? a0 + ia : b0 + ib);
      const int z = A == 2 ? row : b0 + ib;
      if constexpr (kGrids == 4) m0 += p0 * cell_at<A>(a, 0, x, y, z);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const double g = cell_at<A>(a, q0 + d, x, y, z);
        B[d] += p0 * g;
        if constexpr (kDeriv) {
          Ca[d] += pa * g;
          Cb[d] += pb * g;
        }
      }
    }
  }
  const size_t n = a.n;
  const float* ch = a.rows + p;
  RowSums r = {0.0, 0.0};
  if constexpr (kGrids == 4) r.w = m0 * static_cast<double>(__ldg(ch));
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    if constexpr (kDeriv) {
      const float* m = ch + (q0 + 3 + 3 * d) * n;
      r.w += B[d] * static_cast<double>(__ldg(ch + (q0 + d) * n))
             + Ca[d] * static_cast<double>(__ldg(m + ax * n))
             + Cb[d] * static_cast<double>(__ldg(m + bx * n));
      r.wd += B[d] * static_cast<double>(__ldg(m + A * n));
    } else {
      r.w += B[d] * static_cast<double>(__ldg(ch + (q0 + d) * n));
    }
  }
  return r;
}

// Rows a weight axis has in the output: W's, and WD's with derivative
// weights.
template <class Kind>
__host__ __device__ constexpr int row_sets() { return Kind::kDeriv ? 2 : 1; }

// A y or z row (A 1 or 2) of this thread's particle, stored.
template <class Kind, int A>
__device__ __forceinline__ void yz_row(const RowsArgs& a,
                                       const RowsShared& sh, bool narrow,
                                       int row, int lane, int p) {
  constexpr int k = row_sets<Kind>();
  const RowSums r = weight_row<Kind, A>(a, sh, narrow, row, lane, p);
  const size_t n = a.n;
  const int off = k * a.size[0] + (A == 2 ? k * a.size[1] : 0);
  a.out[(off + row) * n + p] = static_cast<float>(r.w);
  if constexpr (Kind::kDeriv) {
    a.out[(off + a.size[A] + row) * n + p] = static_cast<float>(r.wd);
  }
}

// box_sums over a narrow box (every axis at most kBoxCap rows, its
// entries and pair products staged) for the kernels without weight rows
// (G2P, the gather): the cells of kPre x rows loaded before they are
// summed, one round trip to memory a kPre rows instead of one a cell
// (G2P's four sums leave registers for one row's 9, the gather takes the
// box's 27 at once); summed in box_sums' order, so the same bits. (The
// P2G and splat backwards keep the loop: these registers on top of their
// weight rows' cost them a block an SM, 7-10 % at 1e5.)
template <bool kDeriv>
__device__ __forceinline__ void box_sums_narrow(const RowsArgs& a,
                                                const RowsShared& sh, int q,
                                                int lane, double s[4]) {
  constexpr int kPre = kDeriv ? 1 : kBoxCap;
  const int lx = box_len(sh, 0, lane);
  const int ly = box_len(sh, 1, lane);
  const int lz = box_len(sh, 2, lane);
  if (lx == 0 || ly == 0 || lz == 0) return;
  const int x0 = sh.lo[0][lane], y0 = sh.lo[1][lane], z0 = sh.lo[2][lane];
  const int wz = a.size[2];
  const float* grid = grid_of(a, q) + (y0 * wz + z0) * stride_of(a, q) + x0;
  const int stride = stride_of(a, q);
#pragma unroll
  for (int i0 = 0; i0 < kBoxCap; i0 += kPre) {
    float g[kPre][kBoxCells];
#pragma unroll
    for (int i = 0; i < kPre; ++i) {
#pragma unroll
      for (int c = 0; c < kBoxCells; ++c) {
        const int ia = c / kBoxCap, ib = c % kBoxCap;
        g[i][c] = i0 + i < lx && ia < ly && ib < lz
                      ? __ldg(grid + (ia * wz + ib) * stride + i0 + i)
                      : 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < kPre; ++i) {
      if (i0 + i >= lx) break;
      const int xs = (x0 + i0 + i) % kBoxCap;
      const double w0 = sh.ent[0][xs][0][lane];
      const double d0 = kDeriv ? sh.ent[0][xs][1][lane] : 0.0;
#pragma unroll
      for (int c = 0; c < kBoxCells; ++c) {
        if (c / kBoxCap >= ly || c % kBoxCap >= lz) continue;
        const double p0 = sh.pair[0][c][0][lane];
        const double cell = g[i][c];
        s[0] += w0 * p0 * cell;
        if constexpr (kDeriv) {
          const double pa = sh.pair[0][c][1][lane];
          const double pb = sh.pair[0][c][2][lane];
          s[1] += d0 * p0 * cell;
          s[2] += w0 * pa * cell;
          s[3] += w0 * pb * cell;
        }
      }
    }
  }
}

// The extra tasks' sums over the particle's box (G2P, the gather, the P2G
// and splat backwards): grid q, in its own x-fastest layout, times the
// weight products, s[0] = sum Wx Wy Wz g and, with derivative weights,
// s[1] = sum WxD Wy Wz g, s[2] = sum Wx WDy Wz g, s[3] = sum Wx Wy WDz g;
// in double, x outermost, then the (y, z) cells in order; with
// kPrefetch, a narrow box's by box_sums_narrow.
template <bool kDeriv, bool kPrefetch = false>
__device__ __forceinline__ void box_sums(const RowsArgs& a,
                                         const RowsShared& sh, bool narrow,
                                         int q, int lane, int p,
                                         double s[4]) {
  s[0] = s[1] = s[2] = s[3] = 0.0;
  if (kPrefetch && narrow) {
    box_sums_narrow<kDeriv>(a, sh, q, lane, s);
    return;
  }
  const int lx = box_len(sh, 0, lane);
  const int ly = box_len(sh, 1, lane);
  const int lz = box_len(sh, 2, lane);
  const int x0 = sh.lo[0][lane], y0 = sh.lo[1][lane], z0 = sh.lo[2][lane];
  const int wz = a.size[2];
  const float* grid = grid_of(a, q);
  const int stride = stride_of(a, q);
  for (int ix = 0; ix < lx; ++ix) {
    const int x = x0 + ix;
    const double w0 = box_weight<0>(a, sh, narrow, 0, x, lane, p);
    double d0 = 0.0;
    if constexpr (kDeriv) d0 = box_weight<0>(a, sh, narrow, 1, x, lane, p);
    for (int ia = 0; ia < ly; ++ia) {
      for (int ib = 0; ib < lz; ++ib) {
        double p0, pa, pb;
        plane_pair<0, kDeriv>(a, sh, narrow, lane, p, ia, ib, &p0, &pa, &pb);
        const double g = __ldg(grid + ((y0 + ia) * wz + z0 + ib) * stride
                               + x);
        s[0] += w0 * p0 * g;
        if constexpr (kDeriv) {
          s[1] += d0 * p0 * g;
          s[2] += w0 * pa * g;
          s[3] += w0 * pb * g;
        }
      }
    }
  }
}

// The x rows of the block's particle in lane q, one a lane of this warp:
// each box cell's cotangent lines read whole. Kept in shared memory for
// rows_store_x, or stored at once where the window has over kXTile rows.
template <class Kind>
__device__ __forceinline__ void x_rows(const RowsArgs& a, RowsShared* sh,
                                       bool narrow, int q) {
  const int p = blockIdx.x * kRowLanes + q;
  if (p >= a.n) return;
  const int wx = a.size[0];
  const size_t n = a.n;
  for (int row = rows_lane(); row < wx; row += kRowLanes) {
    const RowSums r = weight_row<Kind, 0>(a, *sh, narrow, row, q, p);
    if (wx <= kXTile) {
      sh->xout[row][q] = static_cast<float>(r.w);
      if (Kind::kDeriv) sh->xout[wx + row][q] = static_cast<float>(r.wd);
    } else {
      a.out[row * n + p] = static_cast<float>(r.w);
      if (Kind::kDeriv) a.out[(wx + row) * n + p] = static_cast<float>(r.wd);
    }
  }
}

// The extra tasks of the kernels whose extra is rows_scatter: one a (y, z)
// cell of a particle's box (a narrow box's kBoxCells, else the plane).
__device__ __forceinline__ int scatter_tasks(const RowsArgs& a, bool narrow) {
  return narrow ? kBoxCells : a.size[1] * a.size[2];
}

// The destination of component c (of Kind::kScatter) at window cell (row,
// x) in the float64 window a.acc: with kLines, the channels before the
// last three each a grid (wy*wz, wx), then the last three in one grid
// (wy*wz, 3*wx), component q0 + d in columns d*wx .. (d+1)*wx (P2G: the
// mass grid, then the momentum grid; the splat: its window); else every
// channel a grid (wy*wz, wx), one after the other (the G2P and gather
// backwards' three grid cotangents).
template <class Kind>
__device__ __forceinline__ double* acc_at(const RowsArgs& a, int c, int row,
                                          int x) {
  constexpr int q0 = Kind::kScatter - 3;
  const int wx = a.size[0], rows = a.size[1] * a.size[2];
  if (Kind::kLines && c >= q0) {
    return a.acc + q0 * rows * wx + (row * 3 + c - q0) * wx + x;
  }
  return a.acc + (c * rows + row) * wx + x;
}

// An extra task of the kernels that sum into a.acc (zero before the
// kernel, rounded to float32 once after it): (y, z) cell `task` of the
// particle's box (task ia * lz + ib), whose x rows' terms it adds. With
// wgt = Wx Wy Wz at the cell and, with derivative weights, dwx = WxD Wy
// Wz, dwy = Wx WDy Wz, dwz = Wx Wy WDz, component d adds wgt ch_d + dwx
// m[d][0] + dwy m[d][1] + dwz m[d][2] (kChan = Kind::kScatter channels):
// kChan 4 (P2G) with the particle rows (mass, ch_d = mom_d, m[d][j] =
// (dx*affine)[d][j] in row 4 + 3d + j), and the mass component wgt mass;
// kChan 3 with the rows ch_d (the splat's values) and, with derivative
// weights, m[d][j] in row 3 + 3d + j (the G2P backward's cotangents of v
// and C; the gather backward's dv has none). A particle whose rows are all
// zero adds nothing. The terms go by shared atomicAdd(double) into the
// tile's window (rows_window) where it has one, flushed to a.acc by
// rows_flush; else by atomicAdd(double) to a.acc.
template <class Kind>
__device__ __forceinline__ void rows_scatter(const RowsArgs& a,
                                             RowsShared* sh, bool narrow,
                                             int task, int lane, int p) {
  constexpr int kChan = Kind::kScatter;
  constexpr bool kDeriv = Kind::kDeriv;
  const int lx = box_len(*sh, 0, lane);
  const int ly = box_len(*sh, 1, lane);
  const int lz = box_len(*sh, 2, lane);
  if (task >= ly * lz || lx == 0) return;
  const int ia = task / lz, ib = task - ia * lz;
  double p0, pa, pb;     // Wy Wz, WDy Wz, Wy WDz
  plane_pair<0, kDeriv>(a, *sh, narrow, lane, p, ia, ib, &p0, &pa, &pb);
  if (p0 == 0.0 && pa == 0.0 && pb == 0.0) return;
  constexpr int q0 = kChan - 3;      // the row of ch_0
  const size_t n = a.n;
  float ch[kChan], m[3][3] = {};
  bool any = false;
#pragma unroll
  for (int c = 0; c < kChan; ++c) {
    ch[c] = __ldg(a.rows + c * n + p);
    any |= ch[c] != 0.0f;
  }
  if constexpr (kDeriv) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        m[d][j] = __ldg(a.rows + (kChan + 3 * d + j) * n + p);
        any |= m[d][j] != 0.0f;
      }
    }
  }
  if (!any) return;
  const int y = sh->lo[1][lane] + ia, z = sh->lo[2][lane] + ib;
  const int row = y * a.size[2] + z;
  // the tile's window: component c of cell (y, z, x) at
  // win[c * size + ((y - y0) * nz + z - z0) * nx + x - x0]
  int wn[3] = {0, 0, 0};
  const int size = narrow && Kind::kWindow ? window_cells<kChan>(*sh, wn)
                                            : 0;
  const bool local = size > 0;
  const int wrow = ((y - sh->wlo[1]) * wn[2] + z - sh->wlo[2]) * wn[0]
                   - sh->wlo[0];
  for (int ix = 0; ix < lx; ++ix) {
    const int x = sh->lo[0][lane] + ix;
    const double w0 = box_weight<0>(a, *sh, narrow, 0, x, lane, p);
    const double wgt = w0 * p0;
    double dwx = 0.0, dwy = 0.0, dwz = 0.0;
    if constexpr (kDeriv) {
      dwx = box_weight<0>(a, *sh, narrow, 1, x, lane, p) * p0;
      dwy = w0 * pa;
      dwz = w0 * pb;
    }
    if (wgt == 0.0 && dwx == 0.0 && dwy == 0.0 && dwz == 0.0) continue;
    double v[kChan];
    if constexpr (kChan == 4) v[0] = wgt * static_cast<double>(ch[0]);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      if constexpr (kDeriv) {
        v[q0 + d] = wgt * static_cast<double>(ch[q0 + d])
                    + dwx * static_cast<double>(m[d][0])
                    + dwy * static_cast<double>(m[d][1])
                    + dwz * static_cast<double>(m[d][2]);
      } else {
        v[q0 + d] = wgt * static_cast<double>(ch[q0 + d]);
      }
    }
#pragma unroll
    for (int c = 0; c < kChan; ++c) {
      atomicAdd(local ? sh->win + c * size + wrow + x
                      : acc_at<Kind>(a, c, row, x), v[c]);
    }
  }
}

// After the scatter tasks and a barrier: the tile's window added to a.acc
// by atomicAdd(double), one thread an element, its zeros left out.
template <class Kind>
__device__ __forceinline__ void rows_flush(const RowsArgs& a,
                                           const RowsShared& sh) {
  constexpr int kChan = Kind::kScatter;
  int wn[3];
  const int size = window_cells<kChan>(sh, wn);
  const int nx = wn[0], nz = wn[2];
  for (int i = threadIdx.x; i < kChan * size; i += kRowThreads) {
    const double v = sh.win[i];
    if (v == 0.0) continue;
    const int c = i / size, cell = i - c * size;
    const int line = cell / nx, x = cell - line * nx;
    const int y = line / nz, z = line - y * nz;
    atomicAdd(acc_at<Kind>(a, c, (sh.wlo[1] + y) * a.size[2] + sh.wlo[2] + z,
                           sh.wlo[0] + x), v);
  }
}

// Phase 4, with weight rows (Kind::kRows): one task a particle's x rows
// (task q: the block's particle in lane q), warps taking them in turn. The
// gridDim.y blocks of a tile (blockIdx.y its part) share out the tasks of
// each phase: part k takes the tasks t with t / kRowWarps = k mod
// gridDim.y (rows_parts).
template <class Kind>
__device__ __forceinline__ void rows_x(const RowsArgs& a, RowsShared* sh,
                                       bool narrow) {
  const int step = gridDim.y * kRowWarps;
  for (int q = blockIdx.y * kRowWarps + rows_warp(); q < kRowLanes;
       q += step) {
    x_rows<Kind>(a, sh, narrow, q);
  }
}

// Phase 5: the kept x rows of the particles whose x task was this part's,
// a row of the block's particles a store; each kept value zeroed as it is
// read (their space is the scatter window's, zero before phase 6).
template <class Kind>
__device__ __forceinline__ void rows_store_x(const RowsArgs& a,
                                             RowsShared* sh) {
  const int lane = rows_lane(), p = rows_particle();
  const int wx = a.size[0];
  if (p >= a.n || wx > kXTile
      || (lane / kRowWarps) % gridDim.y != blockIdx.y) {
    return;
  }
  for (int r = rows_warp(); r < row_sets<Kind>() * wx; r += kRowWarps) {
    a.out[static_cast<size_t>(r) * a.n + p] = sh->xout[r][lane];
    sh->xout[r][lane] = 0.0f;
  }
}

// Phase 6: the kernel's Kind::extra_tasks (heavier) and then, with weight
// rows, one task every y and z row, warps taking them in turn.
template <class Kind>
__device__ __forceinline__ void rows_tasks(const RowsArgs& a, RowsShared* sh,
                                           bool narrow) {
  const int lane = rows_lane(), p = rows_particle();
  const int extra = Kind::extra_tasks(a, narrow);
  const int tasks = extra + (Kind::kRows ? a.size[1] + a.size[2] : 0);
  const int step = gridDim.y * kRowWarps;
  for (int t = blockIdx.y * kRowWarps + rows_warp(); t < tasks; t += step) {
    if (p >= a.n) continue;
    if (t < extra) {
      Kind::extra(a, sh, narrow, t, lane, p);
    } else if constexpr (Kind::kRows) {
      const int row = t - extra;
      if (row < a.size[1]) {
        yz_row<Kind, 1>(a, *sh, narrow, row, lane, p);
      } else {
        yz_row<Kind, 2>(a, *sh, narrow, row - a.size[1], lane, p);
      }
    }
  }
}

#ifdef __CUDACC__
template <int kGrids>
__global__ void rows_prep(const RowsArgs a) {
  rows_prep_at<kGrids>(a, blockIdx.x * blockDim.x + threadIdx.x);
}

// The phases of one block, barriers between them. The vote's barrier
// ends the block where no particle of its tile is live (the splat's
// tiles away from the contact band). The scatter window shares its space
// with the kept x rows: they are stored first.
template <class Kind>
__device__ __forceinline__ void rows_block(const RowsArgs& a,
                                           RowsShared* sh) {
  rows_begin<window_channels<Kind>()>(sh);
  if (!__syncthreads_or(rows_live<Kind>(a))) return;
  rows_box<Kind>(a, sh);
  __syncthreads();
  const bool narrow = __syncthreads_and(rows_fit(*sh));
  if (narrow) {
    rows_pairs<Kind::kDeriv, row_planes<Kind>()>(a, sh);
    rows_window<window_channels<Kind>()>(sh);
    __syncthreads();
  }
  const bool local = rows_local<Kind>(*sh, narrow);
  if constexpr (Kind::kRows) {
    rows_x<Kind>(a, sh, narrow);
    __syncthreads();
    rows_store_x<Kind>(a, sh);
    if (local) __syncthreads();
  }
  rows_tasks<Kind>(a, sh, narrow);
  if (local) {
    __syncthreads();
    rows_flush<Kind>(a, *sh);
  }
}

// Blocks a tile's tasks are split over (gridDim.y): where the tiles alone
// are fewer than kRowBlocks a multiprocessor (the door's 5400 particles
// are 169 tiles on 132), enough to fill them, at most kRowParts. Each part
// repeats the tile's box and pair phases.
inline int rows_parts(int n) {
  static int sms[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && sms[dev] == 0) {
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  const int slots = (dev < 64 ? sms[dev] : 132) * kRowBlocks;
  const int parts = slots / rows_blocks(n);
  return parts < 1 ? 1 : parts > kRowParts ? kRowParts : parts;
}
#endif

}  // namespace softmac
