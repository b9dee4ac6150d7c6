// The row-thread design of the dense-weight P2G and G2P backwards
// (fused_p2g_bwd.cu, fused_g2p_bwd.cu): many threads a particle instead of
// one. fused_bwd.cuh states the function: for one particle, the cotangent
// of its weight entry on row r of axis A sums the cell coefficients s(c)
// over the particle's box in the plane of the two other axes (a, b), every
// row r of the window, zeros included; the box on each axis is the range
// of the rows where W or WD is nonzero.
//
// A tile of kRowLanes consecutive particles, one a lane, goes to a block
// of kRowWarps warps, or, where the tiles are too few to fill the card, to
// up to kRowParts blocks that share its tasks (rows_parts). A first launch
// writes the grids' other layouts (rows_prep). A block's phases, a
// barrier between each:
//   1. begin: empty boxes in shared memory;
//   2. box: the warps split the window's rows; each thread reads its
//      particle's W and WD on its rows (coalesced: lanes are consecutive
//      particles), widens the particle's box by shared atomicMin / Max and
//      keeps the nonzero entries in shared memory at row % kBoxCap (exact
//      for a box at most kBoxCap rows wide, a B-spline stencil's 3);
//   3. pairs: where every box of the block is that narrow on every axis,
//      each particle's pair products over its box in each plane,
//      P0 = W_a W_b, Pa = WD_a W_b, Pb = W_a WD_b, formed once in double
//      from the kept entries and kept in shared memory; wider boxes (dense
//      weights) read them from device memory as they go;
//   4. tasks, shared out among a tile's blocks: one thread a (particle,
//      y or z weight row); one warp a particle for its x rows, one lane a
//      row; and one thread a (particle, extra task) of the kernel's own
//      (P2G: the channel sums; G2P: the grid scatter). A row's thread
//      visits its box cells in the plane once, reads the cotangent grids
//      there and keeps, in double, the sums
//        m0 = sum P0 G_mass (P2G),  B_d = sum P0 G_d,
//        Ca_d = sum Pa G_d,  Cb_d = sum Pb G_d
//      of the three component grids G_d, then
//        dW_A  = mass m0 + sum_d ch_d B_d + m[d][a] Ca_d + m[d][b] Cb_d,
//        dWD_A = sum_d m[d][A] B_d,
//      with (ch, m) the particle's own rows: P2G (mom, dx*affine), G2P the
//      cotangents of (v, C). The x rows read the grids as they are, (y, z)
//      rows of x: a warp of one particle's x rows reads each box cell's
//      line once, whole. The y and z rows (lanes: particles, y-sorted in
//      the rollout) read the first launch's copies with y, or z, fastest;
//   5. store: the x rows, kept in shared memory (up to kXTile of them),
//      written a row of 32 consecutive particles at a time.
// Each output is one thread's, written once, rounded once, in a fixed
// order.
#pragma once

#include "fused.cuh"

namespace softmac {

constexpr int kRowLanes = 32;      // particles a tile, one a lane
constexpr int kRowWarps = 8;       // warps a block (a tile, or a part of one)
constexpr int kRowThreads = kRowLanes * kRowWarps;
constexpr int kRowBlocks = 3;      // blocks an SM (launch bounds: 80 registers)
constexpr int kRowParts = 4;       // blocks a tile's tasks go to, at most
constexpr int kBoxCap = 3;         // box rows a staged axis holds
constexpr int kBoxCells = kBoxCap * kBoxCap;
constexpr int kXTile = 64;         // x rows a block keeps for its stores

inline int rows_blocks(int n) { return (n + kRowLanes - 1) / kRowLanes; }

struct RowsArgs {
  const float* w[6];      // Wx, WxD, Wy, WDy, Wz, WDz, (size[axis], n) each
  const float* grid[4];   // the cotangent grids (P2G: mass, then momentum)
  int row_stride[4];      // floats from a grid's (y, z) row to the next
  const float* rows;      // the particle rows: P2G chan (13, n), G2P g (12, n)
  float* out;             // (2 (wx + wy + wz) [+ 13], n)
  double* acc;            // G2P: the float64 grid-cotangent window
  float* yt;              // the grids as (z, x, y), one after the other
  float* zt;              // the grids as (y, x, z)
  int n;
  int size[3];            // wx, wy, wz
};

struct RowsShared {
  double pair[3][kBoxCells][3][kRowLanes];   // [plane][cell][P0, Pa, Pb]
  float xout[2 * kXTile][kRowLanes + 1];      // dWx, dWxD rows (padded)
  float ent[3][kBoxCap][2][kRowLanes];        // [axis][row % kBoxCap][W, WD]
  int lo[3][kRowLanes], hi[3][kRowLanes];
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
}

__device__ __forceinline__ void rows_box(const RowsArgs& a, RowsShared* sh) {
  const int lane = rows_lane(), p = rows_particle();
  if (p >= a.n) return;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    for (int r = rows_warp(); r < a.size[ax]; r += kRowWarps) {
      const size_t i = static_cast<size_t>(r) * a.n + p;
      const float w = __ldg(a.w[2 * ax] + i), d = __ldg(a.w[2 * ax + 1] + i);
      if (w != 0.0f || d != 0.0f) {
        atomicMin(&sh->lo[ax][lane], r);
        atomicMax(&sh->hi[ax][lane], r);
        sh->ent[ax][r % kBoxCap][0][lane] = w;
        sh->ent[ax][r % kBoxCap][1][lane] = d;
      }
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
// their box cells' runs of rows whole; and G2P's float64 window zeroed.
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

// The pair products of plane A at box cell (ia, ib), from device memory.
template <int A>
__device__ __forceinline__ void pair_at(const RowsArgs& a,
                                        const RowsShared& sh, int lane, int p,
                                        int ia, int ib, double* p0,
                                        double* pa, double* pb) {
  constexpr int ax = plane_a(A), bx = plane_b(A);
  const int ra = sh.lo[ax][lane] + ia, rb = sh.lo[bx][lane] + ib;
  const double wa = at(a.w[2 * ax], ra, a.n, p);
  const double da = at(a.w[2 * ax + 1], ra, a.n, p);
  const double wb = at(a.w[2 * bx], rb, a.n, p);
  const double db = at(a.w[2 * bx + 1], rb, a.n, p);
  *p0 = wa * wb;
  *pa = da * wb;
  *pb = wa * db;
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
template <int A>
__device__ __forceinline__ void plane_pair(const RowsArgs& a,
                                           const RowsShared& sh, bool narrow,
                                           int lane, int p, int ia, int ib,
                                           double* p0, double* pa,
                                           double* pb) {
  if (narrow) {
    const int c = ia * kBoxCap + ib;
    *p0 = sh.pair[A][c][0][lane];
    *pa = sh.pair[A][c][1][lane];
    *pb = sh.pair[A][c][2][lane];
  } else {
    pair_at<A>(a, sh, lane, p, ia, ib, p0, pa, pb);
  }
}

// The pair products of plane A at box cell c of a narrow box, from the
// entries the box phase kept.
template <int A>
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
  sh->pair[A][c][1][lane] = pa;
  sh->pair[A][c][2][lane] = pb;
}

__device__ __forceinline__ void rows_pairs(const RowsArgs& a,
                                           RowsShared* sh) {
  const int lane = rows_lane(), p = rows_particle();
  if (p >= a.n) return;
  for (int t = rows_warp(); t < 3 * kBoxCells; t += kRowWarps) {
    const int c = t % kBoxCells;
    if (t < kBoxCells) {
      stage_pairs<0>(sh, lane, c);
    } else if (t < 2 * kBoxCells) {
      stage_pairs<1>(sh, lane, c);
    } else {
      stage_pairs<2>(sh, lane, c);
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
// lane `lane` (particle p): the sums of the header comment. kGrids 4: the
// mass grid first (P2G), else the three component grids only (G2P); the
// particle rows hold (ch_d, m[d][j]) from row kGrids - 3 on.
template <int kGrids, int A>
__device__ __forceinline__ RowSums weight_row(const RowsArgs& a,
                                              const RowsShared& sh,
                                              bool narrow, int row, int lane,
                                              int p) {
  constexpr int ax = plane_a(A), bx = plane_b(A);
  constexpr int q0 = kGrids - 3;
  const int la = box_len(sh, ax, lane), lb = box_len(sh, bx, lane);
  const int a0 = sh.lo[ax][lane], b0 = sh.lo[bx][lane];
  double m0 = 0.0, B[3] = {0.0, 0.0, 0.0}, Ca[3] = {0.0, 0.0, 0.0},
         Cb[3] = {0.0, 0.0, 0.0};
  for (int ia = 0; ia < la; ++ia) {
    for (int ib = 0; ib < lb; ++ib) {
      double p0, pa, pb;
      plane_pair<A>(a, sh, narrow, lane, p, ia, ib, &p0, &pa, &pb);
      const int x = A == 0 ? row : a0 + ia;
      const int y = A == 1 ? row : (A == 0 ? a0 + ia : b0 + ib);
      const int z = A == 2 ? row : b0 + ib;
      if constexpr (kGrids == 4) m0 += p0 * cell_at<A>(a, 0, x, y, z);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const double g = cell_at<A>(a, q0 + d, x, y, z);
        B[d] += p0 * g;
        Ca[d] += pa * g;
        Cb[d] += pb * g;
      }
    }
  }
  const size_t n = a.n;
  const float* ch = a.rows + p;
  RowSums r = {0.0, 0.0};
  if constexpr (kGrids == 4) r.w = m0 * static_cast<double>(__ldg(ch));
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float* m = ch + (q0 + 3 + 3 * d) * n;
    r.w += B[d] * static_cast<double>(__ldg(ch + (q0 + d) * n))
           + Ca[d] * static_cast<double>(__ldg(m + ax * n))
           + Cb[d] * static_cast<double>(__ldg(m + bx * n));
    r.wd += B[d] * static_cast<double>(__ldg(m + A * n));
  }
  return r;
}

// A y or z row (A 1 or 2) of this thread's particle, stored.
template <int kGrids, int A>
__device__ __forceinline__ void yz_row(const RowsArgs& a,
                                       const RowsShared& sh, bool narrow,
                                       int row, int lane, int p) {
  const RowSums r = weight_row<kGrids, A>(a, sh, narrow, row, lane, p);
  const size_t n = a.n;
  const int off = 2 * a.size[0] + (A == 2 ? 2 * a.size[1] : 0);
  a.out[(off + row) * n + p] = static_cast<float>(r.w);
  a.out[(off + a.size[A] + row) * n + p] = static_cast<float>(r.wd);
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
    const RowSums r = weight_row<Kind::kGrids, 0>(a, *sh, narrow, row, q, p);
    if (wx <= kXTile) {
      sh->xout[row][q] = static_cast<float>(r.w);
      sh->xout[wx + row][q] = static_cast<float>(r.wd);
    } else {
      a.out[row * n + p] = static_cast<float>(r.w);
      a.out[(wx + row) * n + p] = static_cast<float>(r.wd);
    }
  }
}

// Phase 4: the tile's tasks, warps taking them in turn: first the
// kernel's Kind::extra_tasks (heavier), then one a particle's x rows, then
// every y and z row. The gridDim.y blocks of a tile (blockIdx.y its part)
// share them out: part k takes the tasks t with t / kRowWarps = k mod
// gridDim.y (rows_parts).
template <class Kind>
__device__ __forceinline__ void rows_tasks(const RowsArgs& a, RowsShared* sh,
                                           bool narrow) {
  const int lane = rows_lane(), p = rows_particle();
  const int extra = Kind::extra_tasks(a, narrow);
  const int tasks = extra + kRowLanes + a.size[1] + a.size[2];
  const int step = gridDim.y * kRowWarps;
  int t = blockIdx.y * kRowWarps + rows_warp();
  for (; t < extra; t += step) {
    if (p < a.n) Kind::extra(a, *sh, narrow, t, lane, p);
  }
  for (; t < tasks; t += step) {
    const int row = t - extra - kRowLanes;
    if (row < 0) {
      x_rows<Kind>(a, sh, narrow, t - extra);
    } else if (p >= a.n) {
      continue;
    } else if (row < a.size[1]) {
      yz_row<Kind::kGrids, 1>(a, *sh, narrow, row, lane, p);
    } else {
      yz_row<Kind::kGrids, 2>(a, *sh, narrow, row - a.size[1], lane, p);
    }
  }
}

// Phase 5: the kept x rows of the particles whose x task was this part's,
// a row of the block's particles a store.
template <class Kind>
__device__ __forceinline__ void rows_store_x(const RowsArgs& a,
                                             const RowsShared& sh,
                                             bool narrow) {
  const int lane = rows_lane(), p = rows_particle();
  const int wx = a.size[0];
  const int t = Kind::extra_tasks(a, narrow) + lane;
  if (p >= a.n || wx > kXTile || (t / kRowWarps) % gridDim.y != blockIdx.y) {
    return;
  }
  for (int r = rows_warp(); r < 2 * wx; r += kRowWarps) {
    a.out[static_cast<size_t>(r) * a.n + p] = sh.xout[r][lane];
  }
}

#ifdef __CUDACC__
template <int kGrids>
__global__ void rows_prep(const RowsArgs a) {
  rows_prep_at<kGrids>(a, blockIdx.x * blockDim.x + threadIdx.x);
}

// The phases of one block, barriers between them.
template <class Kind>
__device__ __forceinline__ void rows_block(const RowsArgs& a,
                                           RowsShared* sh) {
  rows_begin(sh);
  __syncthreads();
  rows_box(a, sh);
  __syncthreads();
  const bool narrow = __syncthreads_and(rows_fit(*sh));
  if (narrow) {
    rows_pairs(a, sh);
    __syncthreads();
  }
  rows_tasks<Kind>(a, sh, narrow);
  __syncthreads();
  rows_store_x<Kind>(a, *sh, narrow);
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
