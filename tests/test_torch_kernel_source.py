"""PyTorch port: the arithmetic of the CUDA kernel sources, built for the
host. There is no card and no nvcc here, so the kernel bodies of
softmac_tpu_torch/ops/csrc (each .cu file above its C entry point, and the
headers) are compiled with the host C++ compiler over a small stand-in for
the CUDA runtime header; each kernel runs one thread at a time. The block
reductions of the split mixed backward (shared memory and barriers) are
left to chip_smoke.py; here its per-particle reverse sweeps are summed on
the host. The y-slab kernels (slab.cuh: P2G, the splat and the G2P and
gather backwards), the read-side tiles (slab_read.cuh: G2P, the gather and
the P2G and splat backwards; a warp's vote taken one thread at a time, or
as true for every thread), the door's eight row-thread kernels (fused_rows.cuh:
P2G, G2P, the splat and the gather and their backwards; their first
launch, then each block's vote, box, pair and window, x row, store, task
and flush phases, and the splat's last launch, which rounds its kept
window and leaves it zero) and the tiled contact pairs
(contact_mixed.cuh), block kernels with barriers, run phase by phase: each
phase over all threads of a block before the next, as the barriers order
them on the card.

Held against the plain versions in float64 on the same float32 inputs:
P2G, gather, splat and the P2G / G2P / gather / splat backward kernels
(the G2P and gather backwards the y-slab ones, the P2G and splat
backwards read-side tiles, each output row), which compute in float32,
within 2e-6 of the largest |value| of each output; the dense-weight transfers
(fused_p2g, fused_g2p, fused_splat, fused_gather) and their backward
kernels (fused_p2g_bwd, fused_g2p_bwd, fused_splat_bwd, fused_gather_bwd,
against the float64 plain vjps), which compute in double on float inputs,
on B-spline weights of a scene (some particles' stencils leaving the
window) and on fully dense random weights: their float64 windows and grid
cotangents within 1e-12, their float32 particle rows (outputs, weight
cotangents, channel and value cotangents) within 1e-6 of each row's
largest |value| (one rounding); the row-thread kernels also at the edges
of their blocks of 32 particles (a ragged last block, boxes empty on one
axis, a block whose boxes are too wide to stage, a window of more x rows
than a block keeps, a zero cotangent, no particle, tiles whose scatter
goes through a shared window and tiles whose does not), the splat on a
band of nonzero values (tiles without one end at the vote, and the
zero-valued particles' weights are not read) and two splats on one kept
window bit for bit the same; the Khatri-Rao pair build (kr3) bit for
bit against its float32 plain version on the same weights; the split
mixed contact and its backward pair, double math, within 1e-6 and 1e-12
given the float dt and p_mass they see. The tiled contact kernels of
contact_mixed.cuh (the mixed pair and the penalty pair, the wrench
folded in) run phase by phase, as the y-slab kernels do, with double
outputs: the classification against its rule in float64 (and every
particle in contact kept, also particles placed within the band
margin), the compacted lists, p_v_out or the impulse, dx, dv, each
block's partial wrench and body cotangents and the last block's sum,
within 1e-12 of the float64 plain version and its vjp, on the glass's
box particles, with every particle in the band and with none (the
penalty pair also at a ragged last tile, with no particle and with no
wrench cotangent). The contact checks run on the real glass table, with
particles spread over its SDF box (contact, soft band, penetration and
face-crossing forecasts counted)."""
import ctypes
import math
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from softmac_tpu_torch.engine import mpm as tmpm
from softmac_tpu_torch.engine import sdf as tsdf
from softmac_tpu_torch.engine.meshio import load_obj
from softmac_tpu_torch.engine.types import MPMConfig
from softmac_tpu_torch.ops import build, contact, fused, kr, m33, transfer

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WINDOW = (24, 32, 16)
N = 400
INV_DX = 128.0

CUDA_STANDIN = r"""
#pragma once
#include <math.h>
#include <stdint.h>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct int2 { int x, y; };
inline float2 make_float2(float x, float y) { return {x, y}; }
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
struct dim3s { unsigned x, y, z; };
extern dim3s blockIdx, threadIdx, blockDim, gridDim;
int g_vote_all = 0;
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> inline T __ldcg(const T* p) { return *p; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline double atomicAdd(double* p, double v) { double o = *p; *p = o + v; return o; }
inline unsigned atomicAdd(unsigned* p, unsigned v) { unsigned o = *p; *p = o + v; return o; }
inline int atomicAdd(int* p, int v) { int o = *p; *p = o + v; return o; }
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  unsigned long long o = *p; *p = o + v; return o;
}
inline int atomicMin(int* p, int v) { int o = *p; if (v < o) *p = v; return o; }
inline int atomicMax(int* p, int v) { int o = *p; if (v > o) *p = v; return o; }
inline unsigned atomicOr(unsigned* p, unsigned v) { unsigned o = *p; *p = o | v; return o; }
inline int __ffs(int v) { return __builtin_ffs(v); }
// a warp's vote, one thread at a time: the thread's own predicate (a warp
// of one), or true for every thread while g_vote_all is set (a warp with
// another thread whose predicate holds)
extern int g_vote_all;
inline unsigned __activemask() { return ~0u; }
inline int __any_sync(unsigned, int pred) { return pred || g_vote_all; }
#define __shared__ static
inline void __syncthreads() {}
"""

DRIVER = r"""
#include <algorithm>
#include <cstring>
#include <limits>
#include <vector>
#include "slab_read.cuh"
dim3s blockIdx, threadIdx, blockDim, gridDim;
// The y-slab scatter of slab.cuh: each block's phases, each over all the
// block's threads before the next (the barriers' order on the card, the
// bitonic sort one step a phase), with the shared memory and the partials
// poisoned (NaN, all ones); then the reduce over every output element.
// plan: tiles, rows, and the slab rows the tiles used (summed). The
// backwards also read the three grids and write dx.
template <class Values>
static void slab(const float* x, const float* src, const int* corner,
                 double* spill, float* out, int n, int tile, int lead, int wx,
                 int wy, int wz, float inv_dx, long long* plan,
                 const float* g0 = nullptr, const float* g1 = nullptr,
                 const float* g2 = nullptr, float* dx = nullptr) {
  const softmac::SlabPlan pl = softmac::slab_plan(
      Values::kChannels, Values::kInputs, n, tile, wx, wy, wz);
  std::vector<double> partial(pl.tiles * pl.tile_doubles,
                              std::numeric_limits<double>::quiet_NaN());
  std::vector<int> meta(2 * pl.tiles, -1);
  const softmac::SlabArgs a = {x, src, corner, spill, partial.data(),
                               meta.data(), n, pl.tile, lead, wx, wy, wz,
                               inv_dx, pl, {g0, g1, g2}, dx};
  blockDim.x = softmac::kSlabThreads;
  auto phase = [&](auto f) {
    for (unsigned t = 0; t < blockDim.x; ++t) { threadIdx.x = t; f(); }
  };
  for (int tl = 0; tl < pl.tiles; ++tl) {
    std::vector<unsigned> smem(pl.smem / 4 + 4, 0xffffffffu);
    softmac::SlabShared sh;
    softmac::SlabTile t;
    phase([&] { softmac::slab_begin(a, &sh); });
    phase([&] { softmac::slab_bounds<Values>(a, tl, &sh); });
    phase([&] {
      t = softmac::slab_tile(a, tl, &sh, smem.data());
      softmac::slab_stage<Values>(a, tl, t, &sh);
    });
    if (t.rows == 0) continue;
    for (int k = 2; k <= pl.tile; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1)
        phase([&] { softmac::slab_sort_step(a, t, k, j); });
    phase([&] { softmac::slab_offsets(a, t); });
    phase([&] {
      for (;;) {
        const int cell = atomicAdd(&sh.next, 1);
        if (cell >= t.rows * wz * wx) break;
        double acc[Values::kChannels] = {};
        softmac::slab_cell<Values>(a, t, cell, acc);
        softmac::slab_put<Values>(a, tl, cell, acc);
      }
    });
    softmac::slab_count<Values>(a, &sh);
  }
  // the second launch: blocks of 256 indices, four phases each, over its
  // shared memory poisoned (all ones): the two rows' lists, then the bits
  const int count = pl.channels * wx * wy * wz;
  std::vector<long long> smem(softmac::slab_reduce_smem(a) / 8 + 1, -1);
  long long* list = smem.data();
  unsigned* bits = reinterpret_cast<unsigned*>(list + 2 * pl.tiles);
  blockDim.x = 256;
  for (int first = 0; first < count; first += 256) {
    const int last = std::min(first + 256, count) - 1;
    phase([&] { softmac::slab_reduce_clear(a, bits); });
    phase([&] { softmac::slab_reduce_mark(a, first, last, bits); });
    phase([&] { softmac::slab_reduce_list(a, bits, list); });
    phase([&] {
      const int e = first + threadIdx.x;
      if (e <= last) softmac::slab_reduce(a, first, e, bits, list, out);
    });
  }
  plan[0] = pl.tiles;
  plan[1] = pl.rows;
  plan[2] = 0;
  for (int tl = 0; tl < pl.tiles; ++tl) plan[2] += meta[2 * tl + 1];
}
// The tiled contact kernels of contact_mixed.cuh, of the per-particle op
// Op (the mixed pair: K = 6 forward, 16 backward; the penalty pair: 6 and
// 14; outputs in double, SOFTMAC_MIXED_OUT): each block's phases in
// order, each over all the block's threads, with the shared memory
// poisoned (all ones); the warp ballots and shuffle trees taken as the card
// takes them (a chunk's mask from its 32 lanes' flags; lane l < off adds
// lane l + off). band gets each particle's classification, lists each
// tile's list (-1 past its count); then the last block's sum.
template <int K>
static void warp_trees(const std::vector<double>& acc, softmac::MixedShared* sh) {
  const int threads = softmac::kMixedThreads;
  for (int w = 0; w < softmac::kMixedWarps; ++w) {
    for (int k = 0; k < K; ++k) {
      double v[32];
      for (int l = 0; l < 32; ++l) v[l] = acc[k * threads + 32 * w + l];
      for (int off = 16; off > 0; off >>= 1)
        for (int l = 0; l < off; ++l) v[l] += v[l + off];
      sh->red[w][k] = v[0];
    }
  }
}
template <class Op>
static void mixed_tiled(const softmac::MixedArgs& a, int tile,
                        unsigned char* band, int* lists) {
  constexpr int K = Op::K;
  const int threads = softmac::kMixedThreads, chunks = tile / 32;
  const int per = tile / threads;
  const int blocks = softmac::mixed_blocks(a.n, tile);
  blockDim.x = threads;
  gridDim.x = blocks;
  auto phase = [&](auto f) {
    for (int t = 0; t < threads; ++t) { threadIdx.x = t; f(t); }
  };
  softmac::MixedShared sh;
  std::vector<double> acc(K * threads);
  for (int blk = 0; blk < blocks; ++blk) {
    blockIdx.x = blk;
    memset(&sh, 0xff, sizeof sh);
    std::fill(acc.begin(), acc.end(), 0.0);
    const int p0 = blk * tile;
    std::vector<unsigned char> flag(tile, 0);
    phase([&](int t) {
      bool band[4];
      float keep[4][3];
      switch (per) {
        case 1:
          softmac::mixed_classify<Op, 1>(a, &sh, p0 + t, threads, band,
                                         (float(*)[3])keep);
          break;
        case 2:
          softmac::mixed_classify<Op, 2>(a, &sh, p0 + t, threads, band,
                                         (float(*)[3])keep);
          break;
        default:
          softmac::mixed_classify<Op, 4>(a, &sh, p0 + t, threads, band,
                                         (float(*)[3])keep);
      }
      for (int j = 0; j < per; ++j) {
        flag[j * threads + t] = band[j];
        if (!band[j]) Op::out_of_band(a, p0 + j * threads + t, keep[j]);
      }
    });
    for (int c = 0; c < chunks; ++c) {
      unsigned m = 0;
      for (int l = 0; l < 32; ++l) m |= unsigned(flag[32 * c + l]) << l;
      sh.mask[c] = m;
    }
    threadIdx.x = 0;
    softmac::mixed_scan(&sh, chunks);
    phase([&](int t) {
      for (int c = t >> 5; c < chunks; c += softmac::kMixedWarps)
        softmac::mixed_place(&sh, c, t & 31);
    });
    phase([&](int t) {
      for (int i = t; i < sh.count; i += threads)
        Op::particle(a, sh.body, p0 + sh.list[i], &acc[t], threads);
    });
    warp_trees<K>(acc, &sh);
    phase([&](int) { softmac::mixed_block_sum<K>(a, &sh, blk, blocks); });
    for (int q = 0; q < tile; ++q) {
      if (p0 + q < a.n) band[p0 + q] = flag[q];
      lists[p0 + q] = q < sh.count ? sh.list[q] : -1;
    }
  }
  // the last block
  memset(&sh, 0xff, sizeof sh);
  phase([&](int t) {
    softmac::mixed_gather_partials<K>(a, blocks, &acc[t], threads);
  });
  warp_trees<K>(acc, &sh);
  phase([&](int) { softmac::mixed_total<K>(a, &sh); });
}
// The read-side tiles of slab_read.cuh (G2P, the gather, the P2G and
// splat backwards): each block's phases, each over all the block's threads
// (the barriers' order on the card), with the slab, the shared
// bookkeeping and each thread's particles poisoned (NaN, all ones);
// a.cells the slab's size (read_cells, or fewer to send particles to
// device memory).
template <class Kind>
static void read_tiled(const softmac::ReadArgs& a) {
  blockDim.x = softmac::kReadTile;
  std::vector<softmac::ReadThread<Kind>> me(softmac::kReadTile);
  auto phase = [&](auto f) {
    for (unsigned t = 0; t < blockDim.x; ++t) { threadIdx.x = t; f(me[t]); }
  };
  const float nan = std::numeric_limits<float>::quiet_NaN();
  for (int tl = 0; tl < softmac::read_tiles(a.n); ++tl) {
    blockIdx.x = tl;
    std::vector<float4> smem(softmac::read_smem(a) / 16,
                             float4{nan, nan, nan, nan});
    softmac::ReadShared sh;
    memset(&sh, 0xff, sizeof sh);
    memset(me.data(), 0xff, me.size() * sizeof(softmac::ReadThread<Kind>));
    softmac::read_phases<Kind>(a, tl, &sh, smem.data(), phase);
  }
}
template <class F> static void launch(int n, F f) {
  blockDim.x = 256; gridDim.x = (n + 255) / 256;
  for (unsigned b = 0; b < gridDim.x; ++b)
    for (unsigned t = 0; t < 256; ++t) { blockIdx.x = b; threadIdx.x = t; f(); }
}
// The row-thread kernels of fused_rows.cuh: the first launch (the grids'
// layouts, the backwards' zero fill) over its `count` elements (none for
// P2G, G2P, the splat and the gather), then each block of the (tiles,
// parts) grid, its phases in order, each over all the block's threads,
// with the shared memory poisoned (all ones); the votes of
// __syncthreads_or (a live particle, else the block ends) and
// __syncthreads_and taken over every thread. Returns the tiles that
// staged their pair products (narrow); `windows` counts those whose
// scatter went through the tile's window, and `ran` (where given) those
// that passed the vote.
template <class Kind>
static int rows(const softmac::RowsArgs& a, int count, int parts,
                int& windows, int* ran = nullptr) {
  for (int i = 0; i < count; ++i)
    softmac::rows_prep_at<Kind::kGrids>(a, i);
  blockDim.x = softmac::kRowThreads;
  gridDim.x = softmac::rows_blocks(a.n);
  gridDim.y = parts;
  auto phase = [&](auto f) {
    for (unsigned t = 0; t < blockDim.x; ++t) { threadIdx.x = t; f(); }
  };
  int narrow_tiles = 0;
  windows = 0;
  if (ran) *ran = 0;
  for (unsigned b = 0; b < gridDim.x; ++b) {
    for (unsigned part = 0; part < gridDim.y; ++part) {
      blockIdx.x = b;
      blockIdx.y = part;
      softmac::RowsShared sh;
      memset(&sh, 0xff, sizeof sh);
      phase([&] {
        softmac::rows_begin<softmac::window_channels<Kind>()>(&sh);
      });
      bool live = false;
      phase([&] { live = softmac::rows_live<Kind>(a) || live; });
      if (!live) continue;
      if (ran) *ran += part == 0;
      phase([&] { softmac::rows_box<Kind>(a, &sh); });
      bool narrow = true;
      phase([&] { narrow = softmac::rows_fit(sh) && narrow; });
      if (narrow) {
        phase([&] {
          softmac::rows_pairs<Kind::kDeriv, softmac::row_planes<Kind>()>(
              a, &sh);
          softmac::rows_window<softmac::window_channels<Kind>()>(&sh);
        });
      }
      const bool local = softmac::rows_local<Kind>(sh, narrow);
      if constexpr (Kind::kRows) {
        phase([&] { softmac::rows_x<Kind>(a, &sh, narrow); });
        phase([&] { softmac::rows_store_x<Kind>(a, &sh); });
      }
      phase([&] { softmac::rows_tasks<Kind>(a, &sh, narrow); });
      if (local) {
        phase([&] { softmac::rows_flush<Kind>(a, sh); });
        windows += part == 0;
      }
      if (part == 0) narrow_tiles += narrow;
    }
  }
  gridDim.y = 1;
  blockIdx.y = 0;
  return narrow_tiles;
}
extern "C" {
void h_p2g_slab(const float* x, const float* chan, const int* corner,
                double* spill, float* out, int n, int tile, int wx, int wy,
                int wz, float inv_dx, long long* plan) {
  slab<k_p2g::P2GValues>(x, chan, corner, spill, out, n, tile, 1, wx, wy, wz,
                         inv_dx, plan);
}
void h_splat_slab(const float* x, const float* vals, const int* corner,
                  double* spill, float* out, int n, int tile, int wx, int wy,
                  int wz, float inv_dx, long long* plan) {
  slab<k_splat::SplatValues>(x, vals, corner, spill, out, n, tile, 0, wx, wy,
                             wz, inv_dx, plan);
}
void h_g2p_bwd_slab(const float* x, const float* g, const int* corner,
                    double* spill, float* out, int n, int tile, int wx,
                    int wy, int wz, float inv_dx, long long* plan,
                    const float* g0, const float* g1, const float* g2,
                    float* dx) {
  slab<k_g2p_bwd::G2PBwdValues>(x, g, corner, spill, out, n, tile, 3, wx, wy,
                                wz, inv_dx, plan, g0, g1, g2, dx);
}
void h_gather_bwd_slab(const float* x, const float* dv, const int* corner,
                       double* spill, float* out, int n, int tile, int wx,
                       int wy, int wz, float inv_dx, long long* plan,
                       const float* g0, const float* g1, const float* g2,
                       float* dx) {
  slab<k_gather_bwd::GatherBwdValues>(x, dv, corner, spill, out, n, tile, 3,
                                      wx, wy, wz, inv_dx, plan, g0, g1, g2,
                                      dx);
}
void h_set_vote_all(int on) { g_vote_all = on; }
int h_read_cells(int wx, int wy, int wz) {
  return softmac::read_cells(wx, wy, wz);
}
void h_g2p_read(const float* x, const float* g0, const float* g1,
                const float* g2, const int* corner, float* out, int* off,
                int n, int wx, int wy, int wz, float inv_dx, int cells) {
  read_tiled<softmac::G2PKind>({x, {g0, g1, g2, nullptr}, nullptr, corner,
                                out, nullptr, off, n, wx, wy, wz, inv_dx,
                                cells});
}
void h_gather_read(const float* x, const float* g0, const float* g1,
                   const float* g2, const int* corner, float* out, int* off,
                   int n, int wx, int wy, int wz, float inv_dx, int cells) {
  read_tiled<softmac::GatherKind>({x, {g0, g1, g2, nullptr}, nullptr,
                                   corner, out, nullptr, off, n, wx, wy, wz,
                                   inv_dx, cells});
}
void h_p2g_bwd_read(const float* x, const float* chan, const int* corner,
                    const float* dgm, const float* dgmom, float* dx,
                    float* dchan, int* off, int n, int wx, int wy, int wz,
                    float inv_dx, int cells) {
  read_tiled<k_p2g_bwd::P2GBwdKind>(
      {x, {dgm, dgmom, dgmom + wx, dgmom + 2 * wx}, chan, corner, dchan, dx,
       off, n, wx, wy, wz, inv_dx, cells});
}
void h_splat_bwd_read(const float* x, const float* vals, const int* corner,
                      const float* dout, float* dx, float* dvals, int* off,
                      int n, int wx, int wy, int wz, float inv_dx,
                      int cells) {
  read_tiled<k_splat_bwd::SplatBwdKind>(
      {x, {dout, dout + wx, dout + 2 * wx, nullptr}, vals, corner, dvals,
       dx, off, n, wx, wy, wz, inv_dx, cells});
}
// The split mixed contact: stage 1 over all particles, then stage 2
void h_mixed(const float* x, const float* v, const float* table,
             const float* body, double* st1, float* pv, float* force,
             uint8_t* mask, int n, int r0, int r1, int r2, float l0, float l1,
             float l2, float u0, float u1, float u2, float inv_dx, float dt,
             float p_mass, float cap) {
  softmac::Geom g = {{l0, l1, l2}, {u0, u1, u2}, inv_dx, {r0, r1, r2}};
  const float4* t = (const float4*)table;
  launch(n, [&] { k_contact_mixed::collide_mixed1_kernel(x, v, t, body, st1,
                                                         n, g, dt); });
  launch(n, [&] { k_contact_mixed::collide_mixed2_kernel(
      x, v, t, body, st1, pv, force, mask, n, g, dt, p_mass, cap); });
}
// The split mixed backward one particle at a time: k2b over all particles,
// then k1b, dv passed between them in float as the kernels pass it; dx, dv
// and the body cotangents (summed here) in double.
void h_mixed_bwd(const float* x, const float* v, const float* table,
                 const float* body, double* st1, const float* gout,
                 const float* gforce, double* gst1, float* dv2, double* dx,
                 double* dv, double* dbody, int n, int r0, int r1, int r2,
                 float l0, float l1, float l2, float u0, float u1, float u2,
                 float inv_dx, float dt, float p_mass, float cap) {
  using softmac::V3;
  softmac::Geom g = {{l0, l1, l2}, {u0, u1, u2}, inv_dx, {r0, r1, r2}};
  const float4* t = (const float4*)table;
  for (int i = 0; i < 16; ++i) dbody[i] = 0.0;
  double gb[16];
  V3<double> gx, gv;
  launch(n, [&] { k_contact_mixed::collide_mixed1_kernel(x, v, t, body, st1,
                                                         n, g, dt); });
  for (int p = 0; p < n; ++p) {
    k_contact_mixed_bwd::mixed2_bwd_particle(x, v, t, body, st1, gout,
                                             gforce, gst1, n, p, g, dt,
                                             p_mass, cap, gv, gb);
    dv2[p] = float(gv.x); dv2[n + p] = float(gv.y); dv2[2 * n + p] = float(gv.z);
    for (int i = 0; i < 16; ++i) dbody[i] += gb[i];
  }
  for (int p = 0; p < n; ++p) {
    gv = {dv2[p], dv2[n + p], dv2[2 * n + p]};
    k_contact_mixed_bwd::mixed1_bwd_particle(x, v, t, body, gst1, n, p, g, dt,
                                             gx, gv, gb);
    dx[p] = gx.x; dx[n + p] = gx.y; dx[2 * n + p] = gx.z;
    dv[p] = gv.x; dv[n + p] = gv.y; dv[2 * n + p] = gv.z;
    for (int i = 0; i < 16; ++i) dbody[i] += gb[i];
  }
}
void h_mixed_tiled(int backward, int tile, const float* x, const float* v,
                   const float* table, const float* body, const float* gout,
                   const float* gwrench, double* out0, double* out1,
                   double* total, double* partial, unsigned char* band,
                   int* lists, int n, int r0, int r1, int r2, float l0,
                   float l1, float l2, float u0, float u1, float u2,
                   float inv_dx, float dt, float p_mass, float cap) {
  softmac::MixedArgs a = {
      x, v, (const float4*)table,
      {body, body + 3, body + 7, body + 10, body + 13, body + 14, body + 15},
      gout, gwrench, out0, out1, total, partial, nullptr, n,
      {{l0, l1, l2}, {u0, u1, u2}, inv_dx, {r0, r1, r2}}, dt, p_mass, cap};
  if (backward) mixed_tiled<softmac::MixedBwdOp>(a, tile, band, lists);
  else mixed_tiled<softmac::MixedFwdOp>(a, tile, band, lists);
}
// The tiled penalty contact: body the 14 floats [bp, bq, bv, bw,
// friction]; gout and gwrench may be null (zero)
void h_penalty_tiled(int backward, int tile, const float* x, const float* v,
                     const float* table, const float* body, const float* gout,
                     const float* gwrench, double* out0, double* out1,
                     double* total, double* partial, unsigned char* band,
                     int* lists, int n, int r0, int r1, int r2, float l0,
                     float l1, float l2, float u0, float u1, float u2,
                     float inv_dx, float dt, float p_mass) {
  softmac::MixedArgs a = {
      x, v, (const float4*)table,
      {body, body + 3, body + 7, body + 10, body + 13, nullptr, nullptr},
      gout, gwrench, out0, out1, total, partial, nullptr, n,
      {{l0, l1, l2}, {u0, u1, u2}, inv_dx, {r0, r1, r2}}, dt, p_mass, 0.0f};
  if (backward) mixed_tiled<softmac::PenaltyBwdOp>(a, tile, band, lists);
  else mixed_tiled<softmac::PenaltyFwdOp>(a, tile, band, lists);
}
// The row-thread kernels: narrow[0] the tiles that staged their pair
// products, narrow[1] those whose scatter went through the tile's window.
void h_fused_p2g(const float* Wx, const float* WxD, const float* Wy,
                 const float* WDy, const float* Wz, const float* WDz,
                 const float* chan, double* acc, int n, int wx, int wy,
                 int wz, int parts, int* narrow) {
  const softmac::RowsArgs a = {{Wx, WxD, Wy, WDy, Wz, WDz},
                               {nullptr, nullptr, nullptr, nullptr},
                               {0, 0, 0, 0}, chan, nullptr, acc, nullptr,
                               nullptr, n, {wx, wy, wz}};
  narrow[0] = rows<k_fused_p2g::P2G>(a, 0, parts, narrow[1]);
}
void h_fused_g2p(const float* Wx, const float* WxD, const float* Wy,
                 const float* WDy, const float* Wz, const float* WDz,
                 const float* g0, const float* g1, const float* g2,
                 float* out, int n, int wx, int wy, int wz, int parts,
                 int* narrow) {
  const softmac::RowsArgs a = {{Wx, WxD, Wy, WDy, Wz, WDz},
                               {g0, g1, g2, nullptr}, {wx, wx, wx, 0},
                               nullptr, out, nullptr, nullptr, nullptr, n,
                               {wx, wy, wz}};
  narrow[0] = rows<k_fused_g2p::G2P>(a, 0, parts, narrow[1]);
}
// The splat's kernel alone: its sums added into the float64 window acc
// (zero on entry, as the wrapper keeps it); h_round_and_clear is its last
// launch. narrow[2]: the tiles that passed the vote (a live particle).
void h_fused_splat(const float* Wx, const float* Wy, const float* Wz,
                   const float* vals, double* acc, int n, int wx, int wy,
                   int wz, int parts, int* narrow) {
  const softmac::RowsArgs a = {{Wx, nullptr, Wy, nullptr, Wz, nullptr},
                               {nullptr, nullptr, nullptr, nullptr},
                               {0, 0, 0, 0}, vals, nullptr, acc, nullptr,
                               nullptr, n, {wx, wy, wz}};
  narrow[0] = rows<k_fused_splat::Splat>(a, 0, parts, narrow[1],
                                         &narrow[2]);
}
void h_round_and_clear(double* acc, float* out, int count) {
  for (int i = 0; i < count; ++i) softmac::round_clear_at(acc, out, i);
}
void h_fused_gather(const float* Wx, const float* Wy, const float* Wz,
                    const float* g0, const float* g1, const float* g2,
                    float* out, int n, int wx, int wy, int wz, int parts,
                    int* narrow) {
  const softmac::RowsArgs a = {{Wx, nullptr, Wy, nullptr, Wz, nullptr},
                               {g0, g1, g2, nullptr}, {wx, wx, wx, 0},
                               nullptr, out, nullptr, nullptr, nullptr, n,
                               {wx, wy, wz}};
  narrow[0] = rows<k_fused_gather::Gather>(a, 0, parts, narrow[1]);
}
void h_fused_p2g_bwd(const float* Wx, const float* WxD, const float* Wy,
                     const float* WDy, const float* Wz, const float* WDz,
                     const float* chan, const float* dgm, const float* dgmom,
                     float* out, int n, int wx, int wy, int wz, int parts,
                     int* narrow) {
  const int count = 4 * wx * wy * wz;
  std::vector<float> scratch(2 * count,
                             std::numeric_limits<float>::quiet_NaN());
  const softmac::RowsArgs a = {{Wx, WxD, Wy, WDy, Wz, WDz},
                               {dgm, dgmom, dgmom + wx, dgmom + 2 * wx},
                               {wx, 3 * wx, 3 * wx, 3 * wx},
                               chan, out, nullptr, scratch.data(),
                               scratch.data() + count, n, {wx, wy, wz}};
  narrow[0] = rows<k_fused_p2g_bwd::P2GBwd>(a, count, parts, narrow[1]);
}
void h_fused_g2p_bwd(const float* Wx, const float* WxD, const float* Wy,
                     const float* WDy, const float* Wz, const float* WDz,
                     const float* g0, const float* g1, const float* g2,
                     const float* g, float* out, double* acc, int n, int wx,
                     int wy, int wz, int parts, int* narrow) {
  const int count = 3 * wx * wy * wz;
  std::vector<float> scratch(2 * count,
                             std::numeric_limits<float>::quiet_NaN());
  const softmac::RowsArgs a = {{Wx, WxD, Wy, WDy, Wz, WDz},
                               {g0, g1, g2, nullptr}, {wx, wx, wx, 0},
                               g, out, acc, scratch.data(),
                               scratch.data() + count, n, {wx, wy, wz}};
  narrow[0] = rows<k_fused_g2p_bwd::G2PBwd>(a, count, parts, narrow[1]);
}
void h_fused_splat_bwd(const float* Wx, const float* Wy, const float* Wz,
                       const float* vals, const float* dout, float* out,
                       int n, int wx, int wy, int wz, int parts, int* narrow) {
  const int count = 3 * wx * wy * wz;
  std::vector<float> scratch(2 * count,
                             std::numeric_limits<float>::quiet_NaN());
  const softmac::RowsArgs a = {{Wx, nullptr, Wy, nullptr, Wz, nullptr},
                               {dout, dout + wx, dout + 2 * wx, nullptr},
                               {3 * wx, 3 * wx, 3 * wx, 0},
                               vals, out, nullptr, scratch.data(),
                               scratch.data() + count, n, {wx, wy, wz}};
  narrow[0] = rows<k_fused_splat_bwd::SplatBwd>(a, count, parts, narrow[1]);
}
void h_fused_gather_bwd(const float* Wx, const float* Wy, const float* Wz,
                        const float* g0, const float* g1, const float* g2,
                        const float* dv, float* out, double* acc, int n,
                        int wx, int wy, int wz, int parts, int* narrow) {
  const int count = 3 * wx * wy * wz;
  std::vector<float> scratch(2 * count,
                             std::numeric_limits<float>::quiet_NaN());
  const softmac::RowsArgs a = {{Wx, nullptr, Wy, nullptr, Wz, nullptr},
                               {g0, g1, g2, nullptr}, {wx, wx, wx, 0},
                               dv, out, acc, scratch.data(),
                               scratch.data() + count, n, {wx, wy, wz}};
  narrow[0] = rows<k_fused_gather_bwd::GatherBwd>(a, count, parts, narrow[1]);
}
// The pair build's grid: one block per particle tile and y row.
void h_kr3(const float* Wy, const float* Wz, const float* WDy,
           const float* WDz, float* H, float* HDy, float* HDz, int n, int wy,
           int wz) {
  blockDim.x = 256;
  gridDim.x = (n + 255) / 256 * wy;
  for (unsigned b = 0; b < gridDim.x; ++b)
    for (unsigned t = 0; t < 256; ++t) {
      blockIdx.x = b; threadIdx.x = t;
      k_kr3::kr3_kernel(Wy, Wz, WDy, WDz, H, HDy, HDz, n, wy, wz);
    }
}
}
"""


def _kernel_bodies(name):
    """The kernel source above its C entry point, its anonymous namespace
    named after the file (several files define kernels there)."""
    src = (build.CSRC / f"{name}.cu").read_text()
    end = "}  // namespace\n"
    body = src[:src.index(end) + len(end)]
    return body.replace("namespace {", f"namespace k_{name} {{", 1)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel sources with")
    d = tmp_path_factory.mktemp("kernel_source")
    (d / "cuda_runtime.h").write_text(CUDA_STANDIN)
    src = "".join(_kernel_bodies(n) for n in (
        "p2g", "p2g_bwd", "g2p_bwd", "splat", "contact",
        "contact_bwd", "contact_mixed", "gather_bwd", "splat_bwd", "contact_mixed_bwd",
        "fused_p2g", "fused_g2p", "fused_splat", "fused_gather",
        "fused_p2g_bwd", "fused_g2p_bwd", "fused_splat_bwd",
        "fused_gather_bwd", "kr3")) \
        + DRIVER
    (d / "driver.cpp").write_text(src)
    so = d / "libkernels_host.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
                    "-fPIC", "-DSOFTMAC_MIXED_OUT=double", "-I", str(d),
                    "-I", str(build.CSRC), "-o",
                    str(so), str(d / "driver.cpp")], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(so))


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


def _rel(got, want):
    return ((got.double() - want).abs().max()
            / want.abs().max().clamp(min=1e-300)).item()


def _scene(shift, seed=0):
    rng = np.random.RandomState(seed)
    x = np.stack([0.45 + 0.09 * rng.rand(N), 0.30 + 0.06 * rng.rand(N),
                  0.50 + 0.05 * rng.rand(N)])
    return (torch.tensor(x, dtype=torch.float32), _corner(x, WINDOW, shift),
            rng)


def _corner(x, window, shift):
    """The window centred on the particles, moved by ``shift`` cells on
    every axis (some stencils then leave it)."""
    corner = [int(np.round((np.asarray(x[d]) * INV_DX - 0.5).mean()))
              - w // 2 + shift for d, w in enumerate(window)]
    return torch.tensor(corner, dtype=torch.int32)


def _f32(rng, *shape):
    return torch.tensor(rng.randn(*shape), dtype=torch.float32)


@pytest.mark.parametrize("shift", [0, 2])
def test_p2g_and_backward_sources(lib, shift):
    x, corner, rng = _scene(shift)
    wx, wy, wz = WINDOW
    chan, dgm, dgmom = _f32(rng, 13, N), _f32(rng, wy * wz, wx), \
        _f32(rng, wy * wz, 3 * wx)
    out, _, _, _ = _slab_call(lib, "p2g", x, chan, corner, WINDOW, SLAB_TILE)
    gm, gmom = transfer.p2g_plain(x.double(), chan.double(), corner, WINDOW,
                                  INV_DX)
    assert _rel(out, torch.cat([gm.reshape(-1), gmom.reshape(-1)])) < 2e-6

    (dx, dchan), _ = _read_call(lib, "p2g_bwd", x, [chan, dgm, dgmom],
                                corner, WINDOW)
    ref = transfer.p2g_vjp_plain(x.double(), chan.double(), corner, WINDOW,
                                 INV_DX, dgm.double(), dgmom.double())
    assert _rel(dx, ref[0]) < 2e-6 and _rel(dchan, ref[1]) < 2e-6


def _glass():
    """The glass's SDF table in float32 and float64."""
    verts, faces = load_obj(str(ROOT / "assets/glass/glass.obj"))
    bake = tsdf.preprocess_sdf(verts, faces, ROOT / "assets/glass")
    prim = tsdf.sdf_params_from_bake(bake, torch.float32, "cpu")
    prim64 = prim.replace(neighborhood=prim.neighborhood.double(),
                          lower=prim.lower.double(), upper=prim.upper.double(),
                          inv_dx=prim.inv_dx.double())
    return prim, prim64


def _box_particles(prim64, b64, n, rng):
    """n float32 world points spread over the SDF box posed by b64."""
    lo, up = prim64.lower, prim64.upper
    p_loc = lo[:, None] + (up - lo)[:, None] * torch.as_tensor(rng.rand(3, n))
    x = torch.stack(m33.vadd(m33.qrot(m33.qnorm(tuple(b64[3:7])),
                                      tuple(p_loc)), tuple(b64[0:3])))
    return x.float().contiguous()


def _geom(prim):
    f = ctypes.c_float
    return [ctypes.c_int(r) for r in prim.res] + [f(g) for g in prim.geom]


@pytest.mark.parametrize("shift", [0, 2])
def test_gather_and_splat_sources(lib, shift):
    x, corner, rng = _scene(shift, seed=2)
    wx, wy, wz = WINDOW
    gv = [_f32(rng, wy * wz, wx) for _ in range(3)]
    (out,), _ = _read_call(lib, "gather", x, gv, corner, WINDOW)
    ref = transfer.gather_plain(x.double(), *(g.double() for g in gv), corner,
                                WINDOW, INV_DX)
    for d in range(3):
        assert _rel(out[d], ref[d]) < 2e-6

    vals = _f32(rng, 3, N)
    out, _, _, _ = _slab_call(lib, "splat", x, vals, corner, WINDOW,
                              SLAB_TILE)
    ref = transfer.splat_plain(x.double(), vals.double(), corner, WINDOW,
                               INV_DX)
    assert _rel(out, ref.reshape(-1)) < 2e-6


# the outputs of each read-side kernel, by rows: G2P's 12, the gather's 3,
# the backwards' dx and dchan or dvals
READ_OUT_ROWS = {"g2p": (12,), "gather": (3,), "p2g_bwd": (3, 13),
                 "splat_bwd": (3, 3)}


def _read_call(lib, name, x, ins, corner, window, cells=None):
    """One call of the read-side tiles (slab_read.cuh) on the host: G2P or
    the gather (``ins`` the three grids), the P2G backward (the 13
    channels, dgm, dgmom) or the splat backward (the values, dout), with a
    slab of ``cells`` float4 cells (default the kernel's, read_cells).
    Returns (the outputs: G2P's 12 rows or the gather's 3, or dx and dchan
    or dvals; each tile's count of particles that read device memory)."""
    n = x.shape[1]
    if cells is None:
        cells = lib.h_read_cells(*window)
    outs = tuple(torch.full((r, n), float("nan"))
                 for r in READ_OUT_ROWS[name])
    off = torch.full((-(-n // transfer.READ_TILE),), -1, dtype=torch.int32)
    # the entry points' order: the grids before the corner, the backwards'
    # particle rows before it and their window cotangents after
    ptrs = ((x, *ins, corner) if name in ("g2p", "gather")
            else (x, ins[0], corner, *ins[1:]))
    getattr(lib, f"h_{name}_read")(
        *map(_p, ptrs + outs), _p(off), ctypes.c_int(n),
        *[ctypes.c_int(w) for w in window], ctypes.c_float(INV_DX),
        ctypes.c_int(cells))
    return outs, off


def _read_plain(name, x, ins, corner, window):
    """The float64 plain version (G2P, the gather) or plain vjp (the P2G
    and splat backwards) of a read-side kernel, its outputs as
    _read_call's."""
    x64, ins64 = x.double(), [t.double() for t in ins]
    if name == "p2g_bwd":
        return transfer.p2g_vjp_plain(x64, ins64[0], corner, window, INV_DX,
                                      *ins64[1:])
    if name == "splat_bwd":
        return transfer.splat_vjp_plain(x64, ins64[0], corner, window,
                                        INV_DX, ins64[1])
    plain = transfer.g2p_plain if name == "g2p" else transfer.gather_plain
    return (plain(x64, *ins64, corner, window, INV_DX),)


def _read_inputs(name, rng, n, window, grids):
    """What the read-side kernel ``name`` takes besides x and the corner:
    the three grids (G2P, the gather); the 13 channels and the cotangents
    of the mass and momentum windows (the P2G backward); the values and
    the window cotangent (the splat backward); seeded normal."""
    wx, wy, wz = window
    if name == "p2g_bwd":
        return [_f32(rng, 13, n), _f32(rng, wy * wz, wx),
                _f32(rng, wy * wz, 3 * wx)]
    if name == "splat_bwd":
        return [_f32(rng, 3, n), _f32(rng, wy * wz, 3 * wx)]
    return list(grids)


def _read_err(outs, want):
    """The worst output row of a read-side call against the float64 plain
    version or vjp, each row relative to its largest |value|."""
    return max(_row_rel_max(o, w) for o, w in zip(outs, want))


def _row_rel_max(got, want):
    """The worst row of got against want, each row relative to its largest
    |value|."""
    return max(_rel(got[r], want[r]) for r in range(want.shape[0]))


def _read_scene(n, window, shift, seed, spread=(0.09, 0.18, 0.05)):
    """n particles over ``spread`` on each axis (0.18 in y: 23 cells at
    INV_DX), the window centred on them and moved by ``shift`` cells,
    seeded normal grids."""
    rng = np.random.RandomState(seed)
    x = np.stack([lo + sp * rng.rand(n)
                  for lo, sp in zip((0.45, 0.25, 0.5), spread)])
    wx, wy, wz = window
    grids = [_f32(rng, wy * wz, wx) for _ in range(3)]
    return torch.tensor(x, dtype=torch.float32), \
        _corner(x, window, shift), grids, rng


def _read_off_slab(x, corner, window, cells):
    """Each tile's particles that read device memory: those whose stencil
    reaches the window (a cell inside on every axis) with a window row past
    the tile's slab. The slab holds the tile's box (the x and z cells its
    reaching stencils cover, rows from the lowest they cover) as far as
    ``cells`` float4 cells go, its rows (cells / (nz * (nx | 1))) cut at
    the end."""
    base = torch.floor(x * INV_DX - 0.5).long() - corner.long()[:, None]
    w = torch.tensor(window)[:, None]
    r0, r1 = base.clamp(min=0), torch.minimum(base + 3, w)
    reach = (r0 < r1).all(dim=0)
    out = []
    for t0 in range(0, x.shape[1], transfer.READ_TILE):
        m = reach[t0:t0 + transfer.READ_TILE]
        if not m.any():
            out.append(0)
            continue
        lo = r0[:, t0:t0 + transfer.READ_TILE][:, m].min(dim=1).values
        hi = r1[:, t0:t0 + transfer.READ_TILE][:, m].max(dim=1).values
        nx, nz = int(hi[0] - lo[0]), int(hi[2] - lo[2])
        rows = min(int(hi[1] - lo[1]), cells // (nz * (nx | 1)))
        last = r1[1, t0:t0 + transfer.READ_TILE]
        out.append(int((m & (last > int(lo[1]) + rows)).sum()))
    return out


READ_N = 1300            # six tiles of 256, the last one ragged
# the windows of the read-side tile tests, with the spread of their scenes:
# (24, 32, 16); a window wide in x (64) with the scene across it, whose box
# rows leave the slab room for 3 rows (of 15 z rows of 65 cells); a window
# the slab holds whole (6 rows of 8 x 9 cells)
READ_WINDOWS = {"window": (WINDOW, (0.09, 0.18, 0.05)),
                "wide": ((64, 8, 48), (0.5, 0.18, 0.1)),
                "small": ((8, 6, 8), (0.09, 0.18, 0.05))}


def test_read_tile_matches_kernels():
    """The wrappers size each call's off-slab counts by READ_TILE: the tile
    slab_read.cuh's blocks take (a particle a thread)."""
    src = (build.CSRC / "slab_read.cuh").read_text()
    tile = re.search(r"constexpr int kReadTile = (\d+);", src).group(1)
    assert transfer.READ_TILE == int(tile)


# the read-side tile kernels (slab_read.cuh)
READ_NAMES = ["g2p", "gather", "p2g_bwd", "splat_bwd"]


@pytest.mark.parametrize("name", READ_NAMES)
@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("shift", [0, 2])
@pytest.mark.parametrize("case", sorted(READ_WINDOWS))
def test_read_tiles_source(lib, case, shift, order, name):
    """G2P, the gather and the P2G and splat backwards of slab_read.cuh,
    phase by phase, against their float64 plain versions or plain vjps:
    each output row within 2e-6 of its largest |value|, over six tiles
    (the last one ragged), with stencils leaving the window (shift 2). The
    off-slab count of each tile is the number of its particles with a
    window row past the tile's slab (its box's rows from the lowest, as
    far as the slab goes, _read_off_slab): none in the rollout's y-sorted
    order on the window (a tile's box, ~7 rows of ~9 x 15 cells, fits its
    3072 cells), some in a shuffled order (a tile spans the scene's ~25
    rows), some in every order on the wide window, whose box rows leave
    room for 3, and none in any order on the small window, which the slab
    holds whole. The call with no slab (every particle from device memory)
    gives the same bits."""
    window, spread = READ_WINDOWS[case]
    x, corner, grids, rng = _read_scene(READ_N, window, shift, 21, spread)
    if order == "sorted":
        (x,) = _y_sorted(x)
    else:
        x = x[:, torch.as_tensor(rng.permutation(READ_N))].contiguous()
    ins = _read_inputs(name, rng, READ_N, window, grids)
    out, off = _read_call(lib, name, x, ins, corner, window)
    assert _read_err(out, _read_plain(name, x, ins, corner, window)) < 2e-6
    cells = lib.h_read_cells(*window)
    assert cells == (432 if case == "small" else 3072)
    want = _read_off_slab(x, corner, window, cells)
    assert off.tolist() == want
    assert (sum(want) > 0) == (case == "wide" or (
        case == "window" and order == "shuffled"))
    device, off0 = _read_call(lib, name, x, ins, corner, window, cells=0)
    assert all(torch.equal(d, o) for d, o in zip(device, out))
    assert off0.tolist() == _read_off_slab(x, corner, window, 0)


@pytest.mark.parametrize("name", READ_NAMES)
@pytest.mark.parametrize("case", ["none", "one", "outside"])
def test_read_tiles_edges_source(lib, case, name):
    """The read-side tile kernels at the edges of their tiles: no particle
    (no block runs, nothing is written), one particle, and a tile whose
    particles all lie beyond the window in y (an empty box: nothing
    staged; every output, the backwards' dx too, +0.0, no particle
    counted)."""
    n = {"none": 0, "one": 1, "outside": 300}[case]
    x, corner, grids, rng = _read_scene(max(n, 1), WINDOW, 0, seed=22)
    x = x[:, :n].contiguous()
    ins = _read_inputs(name, rng, n, WINDOW, grids)
    if case == "outside":
        corner = corner + torch.tensor([0, 40, 0], dtype=torch.int32)
    out, off = _read_call(lib, name, x, ins, corner, WINDOW)
    assert off.shape == (-(-n // transfer.READ_TILE),)
    assert off.tolist() == [0] * off.shape[0]
    want = _read_plain(name, x, ins, corner, WINDOW)
    if case == "outside":
        for o in out:
            assert torch.equal(o, torch.zeros_like(o))
            assert not bool(torch.signbit(o).any())
    elif n:
        assert _read_err(out, want) < 2e-6


@pytest.mark.parametrize("shift", [0, 2])
def test_read_splat_bwd_band_source(lib, shift):
    """The splat backward of slab_read.cuh in the rollout's order with nine
    values in ten zero (the pour's contact correction, zero outside the
    contact band) and the second tile's all zero: within 2e-6 of the
    float64 plain vjp per output row; a zero-valued particle's dx is
    exactly 0; every particle's dvals are the gather's sums over dout's
    three components to the bit (GatherKind's sums, which a particle at
    zero takes, and the sweep's, in the same order with the same
    products); the off-slab counts as the tiles' rows give them, and the
    call with no slab the same bits. Each thread votes alone here (a warp
    of one); with every vote true, as in a warp on the card that holds a
    particle of the band, the zero-valued particles sweep too, and every
    output keeps its bits (dx +0.0)."""
    x, corner, grids, rng = _read_scene(READ_N, WINDOW, shift, 23)
    (x,) = _y_sorted(x)
    vals, dout = _read_inputs("splat_bwd", rng, READ_N, WINDOW, grids)
    vals[:, torch.as_tensor(rng.rand(READ_N) < 0.9)] = 0.0
    vals[:, 256:512] = 0.0
    zero = (vals == 0).all(dim=0)
    assert 60 < int((~zero).sum()) < 200
    (dx, dvals), off = _read_call(lib, "splat_bwd", x, [vals, dout], corner,
                                  WINDOW)
    assert _read_err((dx, dvals), _read_plain(
        "splat_bwd", x, [vals, dout], corner, WINDOW)) < 2e-6
    assert torch.equal(dx[:, zero], torch.zeros_like(dx[:, zero]))
    assert bool((dx[:, ~zero] != 0).any())
    wx = WINDOW[0]
    comps = [dout[:, d * wx:(d + 1) * wx].contiguous() for d in range(3)]
    (gathered,), _ = _read_call(lib, "gather", x, comps, corner, WINDOW)
    assert torch.equal(dvals, gathered)
    assert off.tolist() == _read_off_slab(x, corner, WINDOW,
                                          lib.h_read_cells(*WINDOW))
    device, _ = _read_call(lib, "splat_bwd", x, [vals, dout], corner, WINDOW,
                           cells=0)
    assert torch.equal(device[0], dx) and torch.equal(device[1], dvals)
    lib.h_set_vote_all(1)
    try:
        swept, _ = _read_call(lib, "splat_bwd", x, [vals, dout], corner,
                              WINDOW)
    finally:
        lib.h_set_vote_all(0)
    assert torch.equal(swept[0], dx) and torch.equal(swept[1], dvals)
    assert not bool(torch.signbit(swept[0][:, zero]).any())


SLAB_TILE = 64           # 400 particles: 7 tiles, the last one ragged
WIDE = (64, 8, 48)       # wide rows: fewer slab rows fit a block


def _y_sorted(x, *rows):
    """The particles in the rollout's order (stable by base y-cell, as
    mpm.sort_perm), and per-particle rows with them."""
    perm = torch.argsort(torch.floor(x[1] * INV_DX - 0.5), stable=True)
    return [t[:, perm].contiguous() for t in (x,) + rows]


SLAB_CHANNELS = {"p2g": 4, "splat": 3, "g2p_bwd": 3, "gather_bwd": 3}
SLAB_PAIRS = {"forward": ("p2g", "splat"), "backward": ("g2p_bwd", "gather_bwd")}


def _slab_call(lib, name, x, src, corner, window, tile, grids=()):
    """One y-slab call on the host: P2G, the splat, or (with the three
    grids) the G2P or gather backward. Returns (float32 window, dx (3, N)
    or None, spilled particles, plan (tiles, slab rows, slab rows
    used))."""
    channels = SLAB_CHANNELS[name]
    cells = math.prod(window)
    out = torch.full((channels * cells,), float("nan"))
    spill = torch.zeros(channels * cells + 1, dtype=torch.float64)
    plan = (ctypes.c_longlong * 3)()
    dx = torch.full((3, x.shape[1]), float("nan")) if grids else None
    extra = [_p(g) for g in grids] + ([_p(dx)] if grids else [])
    getattr(lib, f"h_{name}_slab")(
        _p(x), _p(src), _p(corner), _p(spill), _p(out),
        ctypes.c_int(x.shape[1]), ctypes.c_int(tile),
        *[ctypes.c_int(w) for w in window], ctypes.c_float(INV_DX), plan,
        *extra)
    return out, dx, int(spill[-1:].view(torch.int64)), tuple(plan)


def _slab_err(name, x, src, corner, window, out, dx, grids=()):
    """The worst error of a y-slab call against the float64 plain version
    (the plain vjp for the backwards: dx and each grid cotangent), each
    output relative to its largest |value|."""
    if not grids:
        return _rel(out, _plain_window(name, x, src, corner, window))
    vjp = (transfer.g2p_vjp_plain if name == "g2p_bwd"
           else transfer.gather_vjp_plain)
    ref = vjp(x.double(), *(g.double() for g in grids), corner, window,
              INV_DX, src.double())
    return max([_rel(dx, ref[0])] + [
        _rel(out.reshape(3, -1)[d], ref[1 + d].reshape(-1))
        for d in range(3)])


def _plain_window(name, x, src, corner, window):
    if name == "p2g":
        gm, gmom = transfer.p2g_plain(x.double(), src.double(), corner,
                                      window, INV_DX)
        return torch.cat([gm.reshape(-1), gmom.reshape(-1)])
    return transfer.splat_plain(x.double(), src.double(), corner, window,
                                INV_DX).reshape(-1)


def _expected_tiles(x, active, corner, window, tile, rows):
    """(particles with a stencil row inside the window but outside their
    tile's slab, slab rows the tiles use): a tile's slab holds the rows
    [lo, lo + min(hi - lo, rows)) from the lowest and highest rows its
    active particles reach."""
    base = torch.floor(x[1] * INV_DX - 0.5).long() - int(corner[1])
    r0, r1 = base.clamp(min=0), (base + 3).clamp(max=window[1])
    reach = active & (r0 < r1)
    spills = used = 0
    for t0 in range(0, x.shape[1], tile):
        m, lo, hi = reach[t0:t0 + tile], r0[t0:t0 + tile], r1[t0:t0 + tile]
        if m.any():
            lo_t, hi_t = int(lo[m].min()), int(hi[m].max())
            used += min(hi_t - lo_t, rows)
            spills += int((m & (hi > lo_t + min(hi_t - lo_t, rows))).sum())
    return spills, used


@pytest.mark.parametrize("kernels", sorted(SLAB_PAIRS))
@pytest.mark.parametrize("order", ["sorted", "unsorted"])
@pytest.mark.parametrize("shift", [0, 2])
@pytest.mark.parametrize("window", [WINDOW, WIDE], ids=["window", "wide"])
def test_slab_sources(lib, window, shift, order, kernels):
    """The y-slab kernels (slab.cuh: P2G and the splat, or the G2P and
    gather backwards, whose grid cotangents it scatters and whose dx it
    gathers) against the float64 plain versions and vjps. In the rollout's
    y-sorted order every stencil row lies in its tile's slab: no particle
    spills. On the wide window a slab holds fewer rows than the scene
    spans, so in the scene's random order particles spill, and the spilled
    cells' global atomics keep the window exact; the spill count and the
    slab rows used are those the tiles' rows give."""
    x, _, rng = _scene(shift, seed=10)
    corner = _corner(x, window, shift)
    chan, vals, g = _f32(rng, 13, N), _f32(rng, 3, N), _f32(rng, 12, N)
    wx, wy, wz = window
    grids = [_f32(rng, wy * wz, wx) for _ in range(3)]
    if order == "sorted":
        x, chan, vals, g = _y_sorted(x, chan, vals, g)
    srcs = {"p2g": chan, "splat": vals, "g2p_bwd": g, "gather_bwd": vals}
    for name in SLAB_PAIRS[kernels]:
        gr = grids if kernels == "backward" else ()
        out, dx, spilled, plan = _slab_call(lib, name, x, srcs[name], corner,
                                            window, SLAB_TILE, gr)
        assert _slab_err(name, x, srcs[name], corner, window, out, dx,
                         gr) < 2e-6
        assert plan[0] == 7 and (plan[1] < 8) == (window == WIDE), plan
        want = _expected_tiles(x, torch.ones(N, dtype=torch.bool), corner,
                               window, SLAB_TILE, plan[1])
        assert (spilled, plan[2]) == want, (name, spilled, plan, want)
        assert (spilled > 0) == (order == "unsorted" and window == WIDE)


@pytest.mark.parametrize("name", sorted(SLAB_CHANNELS))
def test_slab_reduce_long_lists_source(lib, name):
    """The reduce launch's sum over more tiles a row than it keeps loads in
    flight (kReduceWays): 400 particles in the scene's random order at the
    smallest tile, 32, so that the 13 tiles' slabs cover the rows the
    scene reaches (all but the ragged last one every row); each kernel
    within 2e-6 of its float64 plain version or vjp."""
    ways = int(re.search(r"constexpr int kReduceWays = (\d+);",
                         (build.CSRC / "slab.cuh").read_text()).group(1))
    x, corner, rng = _scene(0, seed=13)
    wx, wy, wz = WINDOW
    src = _f32(rng, {"p2g": 13, "g2p_bwd": 12}.get(name, 3), N)
    grids = ([_f32(rng, wy * wz, wx) for _ in range(3)]
             if name.endswith("_bwd") else ())
    out, dx, spilled, plan = _slab_call(lib, name, x, src, corner, WINDOW,
                                        32, grids)
    base = torch.floor(x[1] * INV_DX - 0.5)
    rows = int(base.max() - base.min()) + 3
    assert plan[0] == 13 and spilled == 0
    assert (spilled, plan[2]) == _expected_tiles(
        x, torch.ones(N, dtype=torch.bool), corner, WINDOW, 32, plan[1])
    assert plan[2] > ways * rows      # more tiles a row than ways
    assert _slab_err(name, x, src, corner, WINDOW, out, dx, grids) < 2e-6


@pytest.mark.parametrize("name", ["splat", "gather_bwd"])
@pytest.mark.parametrize("tile", [SLAB_TILE, 1024])
@pytest.mark.parametrize("shift", [0, 2])
def test_slab_splat_mostly_zero_source(lib, shift, tile, name):
    """The splat, or the gather's backward, in the rollout's order with
    nine particles in ten at zero (out of contact), over 800 particles (at
    a tile of 1024 a thread takes two): the zero particles are skipped and
    do not widen their tile's slab (the window, and the backward's dx and
    grids, within 2e-6 of the plain version or vjp; the spill count and
    the slab rows used are those the active particles' rows give; a
    skipped particle's dx is zero), and with every value -0.0 no tile uses
    a row, the window is +0.0 to the bit and dx is zero."""
    parts = [_scene(shift, seed=s) for s in (11, 12)]
    x = torch.cat([p[0] for p in parts], dim=1)
    corner, rng = parts[0][1], parts[0][2]
    vals = _f32(rng, 3, x.shape[1])
    vals[:, torch.as_tensor(rng.rand(x.shape[1]) < 0.9)] = 0.0
    x, vals = _y_sorted(x, vals)
    wx, wy, wz = WINDOW
    grids = ([_f32(rng, wy * wz, wx) for _ in range(3)]
             if name == "gather_bwd" else ())
    out, dx, spilled, plan = _slab_call(lib, name, x, vals, corner, WINDOW,
                                        tile, grids)
    assert _slab_err(name, x, vals, corner, WINDOW, out, dx, grids) < 2e-6
    active = (vals != 0).any(dim=0)
    assert 40 < int(active.sum()) < 120
    assert (spilled, plan[2]) == _expected_tiles(x, active, corner, WINDOW,
                                                 tile, plan[1])
    if grids:
        assert torch.equal(dx[:, ~active], torch.zeros_like(dx[:, ~active]))
    out, dx, spilled, plan = _slab_call(lib, name, x,
                                        torch.full_like(vals, -0.0), corner,
                                        WINDOW, tile, grids)
    assert spilled == plan[2] == 0
    assert torch.equal(out, torch.zeros_like(out))
    assert not bool(torch.signbit(out).any())
    if grids:
        assert torch.equal(dx, torch.zeros_like(dx))


@pytest.mark.parametrize("shift", [0, 2])
def test_gather_and_splat_backward_sources(lib, shift):
    """The splat backward (the read-side tiles of slab_read.cuh, a gather:
    no atomics) against the float64 plain vjp; the gather backward's
    kernel is the y-slab one of test_slab_sources."""
    x, corner, rng = _scene(shift, seed=3)
    wx, wy, wz = WINDOW
    for shape in [(wy * wz, wx)] * 3 + [(3, N)]:
        _f32(rng, *shape)   # the draws of the removed gather half: same vals
    vals, dout = _f32(rng, 3, N), _f32(rng, wy * wz, 3 * wx)
    (dx, dvals), _ = _read_call(lib, "splat_bwd", x, [vals, dout], corner,
                                WINDOW)
    ref = transfer.splat_vjp_plain(x.double(), vals.double(), corner, WINDOW,
                                   INV_DX, dout.double())
    assert _rel(dx, ref[0]) < 2e-6 and _rel(dvals, ref[1]) < 2e-6


def _mixed_scene(seed):
    """The glass, a pose slightly off unit quaternion, 4000 particles over
    its SDF box with velocities of up to a few m/s (every branch of the
    mixed contact occurs: test_mixed_contact_source counts them)."""
    prim, prim64 = _glass()
    rng = np.random.RandomState(seed)
    n = 4000
    q = np.array([0.9, 0.1, -0.2, 0.15])
    q *= 1.001 / np.linalg.norm(q)        # slightly off unit, as |q| may be
    body = torch.tensor(np.concatenate(
        [[0.72, 0.28, 0.51], q, [0.1, -0.2, 0.05], [0.3, 0.1, -0.2],
         [0.4, 666.0, 0.5]]), dtype=torch.float32)
    b64 = body.double()
    x = _box_particles(prim64, b64, n, rng)
    v = _f32(rng, 3, n) * 1.5
    return prim, prim64, body, b64, x, v, rng


@pytest.mark.parametrize("cap", [float("inf"), 2.0])
def test_mixed_contact_source(lib, cap):
    """The split pair (stage 1 over all particles, then stage 2) on
    particles over the glass's SDF box with velocities of up to a few m/s,
    against the float64 plain version: the contact, soft, penetrating and
    face-crossing cases all occur (counted)."""
    prim, prim64, body, b64, x, v, _ = _mixed_scene(4)
    n = x.shape[1]
    dt, p_mass = 1e-3, 1.5e-5
    st1 = torch.zeros(7, n, dtype=torch.float64)
    pv, force = torch.zeros(3, n), torch.zeros(3, n)
    mask = torch.zeros(n, dtype=torch.bool)
    lib.h_mixed(_p(x), _p(v), _p(prim.neighborhood), _p(body), _p(st1),
                _p(pv), _p(force), _p(mask), ctypes.c_int(n), *_geom(prim),
                ctypes.c_float(dt), ctypes.c_float(p_mass),
                ctypes.c_float(cap))

    parts = (b64[0:3], b64[3:7], b64[7:10], b64[10:13], b64[13], b64[14],
             b64[15])
    pv_p, f_p, mask_p = contact.collide_mixed_plain(
        prim64, *parts, x.double(), v.double(), dt, p_mass,
        None if cap == float("inf") else cap)
    xs = tuple(x.double())
    dist, _ = contact.sample_sdf_normal_world(prim64, tuple(b64[0:3]),
                                              tuple(b64[3:7]), xs)
    edge = (dist - contact.CONTACT_THRESHOLD).abs() < 1e-6
    assert not bool(((mask != mask_p) & ~edge).any())
    same = mask == mask_p
    assert _rel(pv * same, pv_p * same) < 1e-6
    assert _rel(force * same, f_p * same) < 1e-6
    counts = _mixed_cases(prim64, b64, x, v, dt)
    assert min(counts.values()) > 20, counts


def _mixed_cases(prim64, b64, x, v, dt):
    """Counts of the mixed contact's cases among the particles (float64
    plain version): in contact, in the soft band, penetrating at the
    forecast point, forecast across a table cell's face."""
    parts = (b64[0:3], b64[3:7], b64[7:10], b64[10:13], b64[13], b64[14],
             b64[15])
    xs = tuple(x.double())
    st1 = contact.collide_mixed1_plain(prim64, *parts, x.double(), v.double(),
                                       dt)
    mask = st1[6] <= contact.CONTACT_THRESHOLD
    qinv = m33.qnorm(m33.qconj(tuple(b64[3:7])))
    base1 = contact.cell_index(prim64, m33.qrot(qinv, m33.vsub(
        xs, tuple(b64[0:3]))))[0]
    base2 = contact.cell_index(prim64, m33.qrot(qinv, m33.vsub(
        tuple(st1[3:6]), tuple(b64[0:3]))))[0]
    sdf2, _ = contact.sample_sdf_normal_world(prim64, tuple(b64[0:3]),
                                              tuple(b64[3:7]), tuple(st1[3:6]))
    return {"contact": int(mask.sum()),
            "soft": int((mask & (st1[6] > 0)).sum()),
            "penetrating": int((mask & (sdf2 < 0)).sum()),
            "face-crossing": int((mask & (base1 != base2)).sum())}


def _penalty_scene(seed, n=4000):
    """The glass, a pose slightly off unit quaternion, the penalty
    contact's 14 body floats (friction 10) and n particles over its SDF
    box with velocities of up to ~1.5 m/s."""
    prim, prim64 = _glass()
    rng = np.random.RandomState(seed)
    q = np.array([0.9, 0.1, -0.2, 0.15])
    q *= 1.001 / np.linalg.norm(q)        # slightly off unit, as |q| may be
    body = torch.tensor(np.concatenate(
        [[0.72, 0.28, 0.51], q, [0.1, -0.2, 0.05], [0.3, 0.1, -0.2], [10.0]]),
        dtype=torch.float32)
    b64 = body.double()
    x = _box_particles(prim64, b64, n, rng)
    v = _f32(rng, 3, n) * 0.5
    return prim, prim64, body, b64, x, v, rng


def test_contact_backward_source(lib):
    """The tiled penalty backward (contact_bwd.cu, at the wrappers' tile)
    for the impulse's cotangent alone (no wrench cotangent: a null
    pointer) on the glass's SDF box particles against the float64 plain
    vjp of the impulse, given the dt and p_mass the kernel sees (float32
    values): dx, dv and each body group within 1e-12 of its largest
    |value| (the kernel's double math is the plain vjp's, summed in
    another order)."""
    prim, prim64, body, b64, x, v, rng = _penalty_scene(0)
    n = x.shape[1]
    gimp = _f32(rng, 3, n)
    dt, p_mass = float(np.float32(1e-3)), float(np.float32(1.5e-5))
    out = _tiled_call(lib, 1, contact.MIXED_BWD_TILE, prim, body, x, v,
                      gimp, None, dt, p_mass, None, "penalty")
    _, mask = contact.collide_particle_plain(prim64, *_parts14(b64),
                                             x.double(), v.double(), dt,
                                             p_mass)
    assert int(mask.sum()) > 400, "too few contacts"
    ref = contact.collide_particle_wrench_vjp_plain(
        prim64, *_parts14(b64), x.double(), v.double(), dt, p_mass,
        gimp.double(), None)
    assert _rel(out["out0"], ref[5]) < 1e-12
    assert _rel(out["out1"], ref[6]) < 1e-12
    for (a, b), r in zip(((0, 3), (3, 7), (7, 10), (10, 13), (13, 14)),
                         ref[:5]):
        assert _rel(out["total"][a:b], r.reshape(-1)) < 1e-12


@pytest.mark.parametrize("cap", [float("inf"), 0.5])
def test_mixed_contact_backward_source(lib, cap):
    """The split backward pair (k2b -> k1b) on the glass's SDF box
    particles against the float64 plain vjp, given the dt and p_mass the
    kernels see (float32 values): dx and each body group within 1e-12 of
    its largest |value| (the kernels' double math is the plain vjp's,
    summed in another order); dv within 1e-6 (k2b hands its share to k1b
    in float)."""
    prim, prim64, body, b64, x, v, rng = _mixed_scene(5)
    n = x.shape[1]
    gout, gforce = _f32(rng, 3, n), _f32(rng, 3, n)
    dt, p_mass = float(np.float32(1e-3)), float(np.float32(1.5e-5))
    f = ctypes.c_float
    st1 = torch.zeros(7, n, dtype=torch.float64)
    gst1 = torch.zeros(7, n, dtype=torch.float64)
    dv2 = torch.zeros(3, n)
    dx = torch.zeros(3, n, dtype=torch.float64)
    dv = torch.zeros(3, n, dtype=torch.float64)
    db = torch.zeros(16, dtype=torch.float64)
    lib.h_mixed_bwd(_p(x), _p(v), _p(prim.neighborhood), _p(body), _p(st1),
                    _p(gout), _p(gforce), _p(gst1), _p(dv2), _p(dx), _p(dv),
                    _p(db), ctypes.c_int(n), *_geom(prim), f(dt), f(p_mass),
                    f(cap))
    parts = (b64[0:3], b64[3:7], b64[7:10], b64[10:13], b64[13], b64[14],
             b64[15])
    ref = contact.collide_mixed_vjp_plain(
        prim64, *parts, x.double(), v.double(), dt, p_mass,
        None if cap == float("inf") else cap, gout.double(), gforce.double())
    groups = ((0, 3), (3, 7), (7, 10), (10, 13), (13, 14), (14, 15),
              (15, 16))
    assert _rel(dx, ref[7]) < 1e-12
    assert _rel(dv, ref[8]) < 1e-6
    for (a, b), r in zip(groups, ref[:7]):
        assert _rel(db[a:b], r.reshape(-1)) < 1e-12, (a, b)
    counts = _mixed_cases(prim64, b64, x, v, dt)
    assert min(counts.values()) > 20, counts


BAND_MARGIN = float(re.search(
    r"kBandMargin = ([0-9.e+-]+);",
    (build.CSRC / "contact_mixed.cuh").read_text()).group(1))


def test_penalty_tiles_match_kernels():
    """The penalty pair's wrappers size its block partials by MIXED_TILE and
    MIXED_BWD_TILE: contact.cu and contact_bwd.cu run and launch the tiles
    of the mixed pair (test_mixed_tiles_match_kernels holds those)."""
    for source, per in (("contact.cu", "kMixedPer"),
                        ("contact_bwd.cu", "kMixedBwdPer")):
        src = (build.CSRC / source).read_text()
        kernel = re.findall(r"mixed_tiled<softmac::\w+, softmac::(\w+)>", src)
        blocks = re.findall(
            r"mixed_blocks\(\s*n, softmac::(\w+) \* threads\)", src)
        assert kernel == [per] and blocks == [per], (source, kernel, blocks)


def test_mixed_tiles_match_kernels():
    """The wrappers size the block partials by MIXED_TILE and
    MIXED_BWD_TILE: they are the tiles the kernels launch with
    (contact_mixed.cuh's particles a thread times the block)."""
    src = (build.CSRC / "contact_mixed.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    threads = const("kMixedThreads")
    assert contact.MIXED_TILE == const("kMixedPer") * threads
    assert contact.MIXED_BWD_TILE == const("kMixedBwdPer") * threads


def _parts(b64):
    return (b64[0:3], b64[3:7], b64[7:10], b64[10:13], b64[13], b64[14],
            b64[15])


def _parts14(b64):
    """The penalty contact's five body tensors from its 14 floats."""
    return (b64[0:3], b64[3:7], b64[7:10], b64[10:13], b64[13])


def _ptr(t):
    return None if t is None else _p(t)


def _tiled_call(lib, backward, tile, prim, body, x, v, gout, gwrench, dt,
                p_mass, cap, kind="mixed"):
    """One tiled contact launch run on the host (double outputs): the mixed
    pair, or (kind "penalty", body the 14 floats, no cap) the penalty
    pair, whose gout and gwrench may be None (zero)."""
    n = x.shape[1]
    blocks = -(-n // tile)
    k = (16 if kind == "mixed" else 14) if backward else 6
    nan = float("nan")
    out = {"out0": torch.full((3, n), nan, dtype=torch.float64),
           "out1": torch.full((3, n), nan, dtype=torch.float64),
           "total": torch.full((k,), nan, dtype=torch.float64),
           "partial": torch.full((k, blocks), nan, dtype=torch.float64),
           "band": torch.zeros(n, dtype=torch.uint8),
           "lists": torch.zeros(blocks * tile, dtype=torch.int32)}
    f = ctypes.c_float
    args = [ctypes.c_int(backward), ctypes.c_int(tile), _p(x), _p(v),
            _p(prim.neighborhood), _p(body), _ptr(gout), _ptr(gwrench)] + [
        _p(out[k]) for k in ("out0", "out1", "total", "partial", "band",
                             "lists")] + [ctypes.c_int(n), *_geom(prim),
                                          f(dt), f(p_mass)]
    if kind == "mixed":
        lib.h_mixed_tiled(*args, f(cap))
    else:
        lib.h_penalty_tiled(*args)
    out["band"] = out["band"].bool()
    out["lists"] = out["lists"].reshape(blocks, tile)
    return out


def _band_rule(prim64, b64, x):
    """The classification the kernels make, in float64: the point lies
    less than the margin outside the SDF box and the trilinear sdf of its
    (clamped) cell is at most the threshold plus the margin; and how far
    the sdf lies from that bound."""
    qinv = m33.qnorm(m33.qconj(tuple(b64[3:7])))
    p_loc = m33.qrot(qinv, m33.vsub(tuple(x.double()), tuple(b64[0:3])))
    rows, _, fx = contact.gather_rows(prim64, p_loc)
    sdf, _ = contact.interp_rows(rows, fx, torch.ones_like(p_loc[0],
                                                          dtype=torch.bool))
    near = torch.ones_like(sdf, dtype=torch.bool)
    for d in range(3):
        near &= ((p_loc[d] >= prim64.lower[d] - BAND_MARGIN)
                 & (p_loc[d] < prim64.upper[d] + BAND_MARGIN))
    bound = contact.CONTACT_THRESHOLD + BAND_MARGIN
    return near & (sdf <= bound), (sdf - bound).abs()


def _close_rows(got, want, tol=1e-12):
    """|got - want| within tol of want's largest |value| (NaN fails)."""
    scale = want.abs().max().clamp(min=1e-300) if want.numel() else 1.0
    return bool(((got - want).abs() <= tol * scale).all())


def _block_order_sum(values, threads=256):
    """The tiled kernels' sum of per-block values in the last block: thread
    t adds the values t, t + 256, ... in order; each warp's 32 sums by the
    shuffle tree (lane l adds lane l + off, off = 16, 8, .., 1); the
    warps' results in order."""
    share = [0.0] * threads
    for i, val in enumerate(values):
        share[i % threads] += val
    total = 0.0
    for w in range(threads // 32):
        lanes = share[32 * w:32 * w + 32]
        off = 16
        while off:
            for lane in range(off):
                lanes[lane] += lanes[lane + off]
            off //= 2
        total += lanes[0]
    return total


# each pair's plain version and vjp (float64), its contact set (the
# particles the full math must see) from the float64 distance, the body
# groups of its backward's total and the out-of-band results (forward
# out0; backward out0, out1: "v", "gout" or zero)
KINDS = {
    "mixed": dict(
        plain=lambda prim64, b64, x, v, dt, p_mass, cap: (
            contact.collide_mixed_wrench_plain(prim64, *_parts(b64), x, v,
                                               dt, p_mass, cap)),
        vjp=lambda prim64, b64, x, v, dt, p_mass, cap, gout, gwrench: (
            contact.collide_mixed_wrench_vjp_plain(
                prim64, *_parts(b64), x, v, dt, p_mass, cap, gout, gwrench)),
        contact=lambda prim64, b64, x, v, dt: contact.collide_mixed1_plain(
            prim64, *_parts(b64), x, v, dt)[6] <= contact.CONTACT_THRESHOLD,
        groups=((0, 3), (3, 7), (7, 10), (10, 13), (13, 14), (14, 15),
                (15, 16)),
        out_of_band=("v", (None, "gout"))),
    "penalty": dict(
        plain=lambda prim64, b64, x, v, dt, p_mass, cap: (
            contact.collide_particle_wrench_plain(prim64, *_parts14(b64), x,
                                                  v, dt, p_mass)),
        vjp=lambda prim64, b64, x, v, dt, p_mass, cap, gout, gwrench: (
            contact.collide_particle_wrench_vjp_plain(
                prim64, *_parts14(b64), x, v, dt, p_mass, gout, gwrench)),
        contact=lambda prim64, b64, x, v, dt: contact.sample_sdf_normal_world(
            prim64, tuple(b64[0:3]), tuple(b64[3:7]), tuple(x))[0]
        < contact.CONTACT_THRESHOLD,
        groups=((0, 3), (3, 7), (7, 10), (10, 13), (13, 14)),
        out_of_band=(None, (None, None))),
}


def _check_tiled(lib, prim, prim64, body, b64, x, v, rng, tile, cap,
                 kind="mixed", wrench_cotangent=True):
    """The tiled forward and backward of the pair ``kind`` on (x, v), each
    phase against the float64 plain version and its vjp (dt and p_mass as
    the kernels see them): classification (the rule in float64; every
    particle in contact kept), the tiles' lists, the out-of-band results
    (exact), out0 (p_v_out or the impulse), dx, dv, the block partials
    (each tile's wrench and body cotangents) and the last block's sum.
    Without ``wrench_cotangent`` the backward gets none (a null pointer:
    zero). Returns the contact set and the classification."""
    kd = KINDS[kind]
    n = x.shape[1]
    dt, p_mass = float(np.float32(1e-3)), float(np.float32(1.5e-5))
    cap_p = None if cap == float("inf") else cap
    x64, v64 = x.double(), v.double()
    gout, gwrench = _f32(rng, 3, n), _f32(rng, 6)
    gw = gwrench if wrench_cotangent else None
    in_contact = kd["contact"](prim64, b64, x64, v64, dt)
    band, gap = _band_rule(prim64, b64, x)
    fwd = _tiled_call(lib, 0, tile, prim, body, x, v, gout, gw, dt, p_mass,
                      cap, kind)
    bwd = _tiled_call(lib, 1, tile, prim, body, x, v, gout, gw, dt, p_mass,
                      cap, kind)
    out0, wrench = kd["plain"](prim64, b64, x64, v64, dt, p_mass, cap_p)
    grads = kd["vjp"](prim64, b64, x64, v64, dt, p_mass, cap_p,
                      gout.double(), None if gw is None else gw.double())
    nb = len(kd["groups"])
    for out in (fwd, bwd):
        # classification: the rule, and conservative
        sure = gap > 1e-12
        assert torch.equal(out["band"][sure], band[sure])
        assert bool(out["band"][in_contact].all())
        # compaction: each tile's band particles in tile order
        for b in range(out["lists"].shape[0]):
            flags = out["band"][b * tile:(b + 1) * tile]
            want = torch.nonzero(flags).flatten().to(torch.int32)
            got = out["lists"][b]
            assert torch.equal(got[:want.numel()], want)
            assert bool((got[want.numel():] == -1).all())
    # full math and the particles out of the band
    out_band = ~fwd["band"]
    keep = {"v": v64, "gout": gout.double(), None: torch.zeros_like(x64)}
    fwd_ob, bwd_ob = kd["out_of_band"]
    assert torch.equal(fwd["out0"][:, out_band], keep[fwd_ob][:, out_band])
    for k, src in zip(("out0", "out1"), bwd_ob):
        assert torch.equal(bwd[k][:, out_band], keep[src][:, out_band])
    assert _close_rows(fwd["out0"], out0)
    assert _close_rows(bwd["out0"], grads[nb])
    assert _close_rows(bwd["out1"], grads[nb + 1])
    # block partials: each tile's own wrench and body cotangents
    groups = kd["groups"]
    body_grad = torch.cat([t.reshape(-1) for t in grads[:nb]])
    blocks = fwd["partial"].shape[1]
    if blocks:
        parts_f, parts_b = [], []
        for b in range(blocks):
            sl = slice(b * tile, min((b + 1) * tile, n))
            xs, vs = x64[:, sl].contiguous(), v64[:, sl].contiguous()
            parts_f.append(kd["plain"](prim64, b64, xs, vs, dt, p_mass,
                                       cap_p)[1])
            g = kd["vjp"](prim64, b64, xs, vs, dt, p_mass, cap_p,
                          gout.double()[:, sl].contiguous(),
                          None if gw is None else gw.double())
            parts_b.append(torch.cat([t.reshape(-1) for t in g[:nb]]))
        parts_f, parts_b = torch.stack(parts_f, 1), torch.stack(parts_b, 1)
        for got, want, rows in (
                (fwd["partial"], parts_f, ((0, 3), (3, 6))),
                (bwd["partial"], parts_b, groups)):
            for a, c in rows:
                assert _close_rows(got[a:c], want[a:c]), (a, c)
    # the last block: the partials summed in the block's fixed order, then
    # the total against the plain version's
    for out, want, rows in ((fwd, wrench, ((0, 3), (3, 6))),
                            (bwd, body_grad, groups)):
        for k in range(out["total"].numel()):
            assert float(out["total"][k]) == _block_order_sum(
                out["partial"][k].tolist())
        for a, c in rows:
            assert _close_rows(out["total"][a:c], want[a:c]), (a, c)
    return in_contact, fwd["band"]


@pytest.mark.parametrize("tile,cap", [(1024, float("inf")), (256, 2.0),
                                      (512, float("inf"))])
def test_mixed_tiled_source(lib, tile, cap):
    """The tiled kernels (contact_mixed.cuh) on particles over the glass's
    SDF box (contact, soft band, penetration and face-crossing all
    occur): every phase within 1e-12 of the float64 plain version and its
    vjp; the band is a few particles in ten, so most take the short way."""
    prim, prim64, body, b64, x, v, rng = _mixed_scene(6)
    _, band = _check_tiled(lib, prim, prim64, body, b64, x, v, rng, tile,
                           cap)
    counts = _mixed_cases(prim64, b64, x, v, 1e-3)
    assert min(counts.values()) > 20, counts
    assert 0 < int(band.sum()) < x.shape[1] // 2


@pytest.mark.parametrize("case", ["all", "none"])
def test_mixed_tiled_all_or_none_source(lib, case):
    """Every particle in the contact band (500 drawn from the glass's SDF
    box, tile 256: two tiles, the last one ragged), or none (1000 more
    than 1 cm from the glass, tile 512: two tiles, the last one ragged)."""
    prim, prim64, body, b64, x, v, rng = _mixed_scene(7)
    dist = contact.collide_mixed1_plain(prim64, *_parts(b64), x.double(),
                                        v.double(), 1e-3)[6]
    pick = (dist <= contact.CONTACT_THRESHOLD if case == "all"
            else dist > 0.01)
    count, tile = (500, 256) if case == "all" else (1000, 512)
    idx = torch.nonzero(pick).flatten()[:count]
    assert idx.numel() == count
    x, v = x[:, idx].contiguous(), v[:, idx].contiguous()
    _, band = _check_tiled(lib, prim, prim64, body, b64, x, v, rng, tile,
                           float("inf"))
    assert int(band.sum()) == (count if case == "all" else 0)


def test_mixed_tiled_margin_source(lib):
    """Particles moved along the SDF normal to dist = 5e-3 + (-0.5, 0.5,
    1.5, 3) x the band margin: those in contact and those within the
    margin above it are kept (the full math then finds the latter out of
    contact: p_v_out = v), those past it are not."""
    prim, prim64, body, b64, x, v, rng = _mixed_scene(8)
    bp, bq = tuple(b64[0:3]), tuple(b64[3:7])
    dist, _ = contact.sample_sdf_normal_world(prim64, bp, bq,
                                              tuple(x.double()))
    idx = torch.nonzero((dist > 0.001) & (dist < 0.01)).flatten()[:400]
    offsets = torch.tensor([-0.5, 0.5, 1.5, 3.0], dtype=torch.float64)
    target = contact.CONTACT_THRESHOLD + BAND_MARGIN * offsets.repeat(100)
    xs = x[:, idx].double()
    for _ in range(4):
        d, normal = contact.sample_sdf_normal_world(prim64, bp, bq,
                                                    tuple(xs))
        xs = (xs - (d - target) * torch.stack(normal)).float().double()
    d, _ = contact.sample_sdf_normal_world(prim64, bp, bq, tuple(xs))
    keep = ((d - target).abs() < 0.2 * BAND_MARGIN).nonzero().flatten()
    x, v = xs[:, keep].float().contiguous(), v[:, idx[keep]].contiguous()
    d, target = d[keep], target[keep]
    in_contact, band = _check_tiled(lib, prim, prim64, body, b64, x, v, rng,
                                    256, float("inf"))
    off = ((target - contact.CONTACT_THRESHOLD) / BAND_MARGIN).round(
        decimals=1)
    for o, kept in ((-0.5, True), (0.5, True), (1.5, False), (3.0, False)):
        sel = off == o
        assert int(sel.sum()) >= 5, (o, int(sel.sum()))
        assert bool((band[sel] == kept).all()), o
    assert not bool(in_contact[off == 0.5].any())


def _fused_weights(case):
    """Six float32 weight matrices (wx, wx, wy, wy, wz, wz rows by N) and
    the window: the B-spline weights of mpm.axis_weights on a scene whose
    window is shifted so that some stencils leave it, or fully dense
    seeded normal weights on a small window."""
    if case == "dense":
        rng = np.random.RandomState(6)
        window = (8, 4, 8)
        ws = [_f32(rng, w, N) for w in (8, 8, 4, 4, 8, 8)]
        return ws, window, rng
    x, corner, rng = _scene(8, seed=7)
    cfg = MPMConfig(n_particles=N, n_grid=int(INV_DX))
    W, WD = tmpm.axis_weights(cfg, x, WINDOW, corner)
    outside = int(sum((w == 0).all(dim=0) for w in W).bool().sum())
    cut = int(sum(w.sum(dim=0) < 1 - 1e-6 for w in W).bool().sum())
    assert 0 < outside < cut < N, "want stencils inside, cut and outside"
    return [W[0], WD[0], W[1], WD[1], W[2], WD[2]], WINDOW, rng


def _fdims(window):
    return [ctypes.c_int(N)] + [ctypes.c_int(w) for w in window]


@pytest.mark.parametrize("case", ["bspline", "dense"])
def test_fused_transfer_sources(lib, case):
    ws, window, rng = _fused_weights(case)
    wx, wy, wz = window
    cells = wx * wy * wz
    w64 = [w.double() for w in ws]
    chan = _f32(rng, 13, N)
    gm, gmom = fused.p2g_plain(*w64, chan.double())
    for parts in (1, 2):
        acc, _ = _p2g_rows(lib, ws, window, N, chan, parts)
        assert _rel(acc, torch.cat([gm.reshape(-1), gmom.reshape(-1)])) \
            < 1e-12

    gv = [_f32(rng, wy * wz, wx) for _ in range(3)]
    ref = fused.g2p_plain(*w64, *(g.double() for g in gv))
    for parts in (1, 2):
        out = torch.zeros(12, N)
        lib.h_fused_g2p(*map(_p, ws), *map(_p, gv), _p(out), *_fdims(window),
                        ctypes.c_int(parts), (ctypes.c_int * 2)())
        for r in range(12):
            assert _rel(out[r], ref[r]) < 1e-6

    W, W64 = ws[0::2], w64[0::2]
    vals = _f32(rng, 3, N)
    ref = fused.splat_plain(*W64, vals.double()).reshape(-1)
    acc = torch.zeros(3 * cells, dtype=torch.float64)
    for parts in (1, 2):
        # two calls on one kept window: the round leaves it zero for the next
        runs = [_splat_rows(lib, W, window, N, vals, parts, acc)
                for _ in range(2)]
        assert _rel(runs[0][0], ref) < 1e-12
        assert torch.equal(runs[0][1], runs[1][1])

    ref = fused.gather_plain(*W64, *(g.double() for g in gv))
    for parts in (1, 2):
        out = torch.full((3, N), float("nan"))
        lib.h_fused_gather(*map(_p, W), *map(_p, gv), _p(out),
                           *_fdims(window), ctypes.c_int(parts),
                           (ctypes.c_int * 2)())
        for d in range(3):
            assert _rel(out[d], ref[d]) < 1e-6


def _splat_rows(lib, W, window, n, vals, parts, acc=None):
    """The row-thread splat on n particles, a tile's tasks split over
    ``parts`` blocks, into the kept float64 window ``acc`` (zero; a new one
    where None): its sums (the window before the last launch), its float32
    window after ``round_and_clear`` (the sums rounded, and the kept window
    left zero), and its counts of tiles that staged their pair products,
    of those whose scatter went through the tile's window and of those
    that passed the vote."""
    wx, wy, wz = window
    count = 3 * wx * wy * wz
    if acc is None:
        acc = torch.zeros(count, dtype=torch.float64)
    narrow = (ctypes.c_int * 3)()
    lib.h_fused_splat(*map(_p, W), _p(vals), _p(acc), ctypes.c_int(n),
                      *map(ctypes.c_int, window), ctypes.c_int(parts), narrow)
    sums = acc.clone()
    out = torch.full((wy * wz, 3 * wx), float("nan"))
    lib.h_round_and_clear(_p(acc), _p(out), ctypes.c_int(count))
    assert bool((acc == 0).all())
    assert torch.equal(out.reshape(-1), sums.float())
    return sums, out, tuple(narrow)


@pytest.mark.parametrize("case", ["bspline", "dense"])
def test_fused_splat_band_source(lib, case):
    """The splat band only, at N = 400 (a last tile of 16): about one
    particle in eight with nonzero values, none in particles 64-95 (a whole
    tile) and one alone in 128-159; the zero-valued particles' weight
    columns made dense (seeded normal on every row), which would make
    their tile too wide to stage had the kernel read them. Only the tiles
    with a live particle pass the vote; with B-spline weights every one of
    them stages its pair products (and scatters to device memory: the
    splat has no tile window). The
    float64 window within 1e-12 of splat_plain, with a tile's tasks on 1
    and 2 blocks; two calls on one kept window bit-identical, the window
    left zero."""
    ws, window, rng = _fused_weights(case)
    W = [w.clone() for w in ws[0::2]]
    live = torch.tensor(rng.rand(N) < 0.125)
    live[64:96] = live[128:160] = False
    live[130] = live[N - 1] = True
    vals = _f32(rng, 3, N) * live
    for w in W:
        w[:, ~live] = _f32(rng, w.shape[0], int((~live).sum()))
    ref = fused.splat_plain(*(w.double() for w in W), vals.double())
    tiles = int(torch.nn.functional.pad(live, (0, (-N) % 32)).reshape(
        -1, 32).any(dim=1).sum())
    acc = torch.zeros(ref.numel(), dtype=torch.float64)
    for parts in (1, 2):
        runs = [_splat_rows(lib, W, window, N, vals, parts, acc)
                for _ in range(2)]
        assert _rel(runs[0][0], ref.reshape(-1)) < 1e-12
        assert torch.equal(runs[0][1], runs[1][1])
        narrow, windows, ran = runs[0][2]
        assert ran == tiles < (N + 31) // 32
        assert (narrow, windows) == (tiles if case == "bspline" else 0, 0)


def _rows_rel(got, want):
    """The largest |got - want| of each row over that row's largest
    |want|, the worst row."""
    diff = (got.double() - want).abs().amax(dim=1)
    return (diff / want.abs().amax(dim=1).clamp(min=1e-300)).max().item()


def _p2g_rows(lib, ws, window, n, chan, parts):
    """The row-thread P2G on n particles, a tile's tasks split over
    ``parts`` blocks: its float64 window (mass, then momentum; zeroed by
    the caller, as the wrapper zeroes it) and its counts of tiles that
    staged their pair products and of those whose scatter went through
    the tile's window."""
    wx, wy, wz = window
    acc = torch.zeros(4 * wx * wy * wz, dtype=torch.float64)
    narrow = (ctypes.c_int * 2)()
    lib.h_fused_p2g(*map(_p, ws), _p(chan), _p(acc), ctypes.c_int(n),
                    *map(ctypes.c_int, window), ctypes.c_int(parts), narrow)
    return acc, tuple(narrow)


def _grid_check(acc, refs):
    """A float64 window, one grid after the other, within 1e-12 of each
    grid of the plain version or vjp (exactly zero where that is)."""
    for got, want in zip(torch.split(acc, [r.numel() for r in refs]), refs):
        want = want.reshape(-1)
        if bool((want == 0).all()):
            assert bool((got == 0).all())
        else:
            assert _rel(got, want) < 1e-12


def _rows_check(lib, ws, window, n, chan, gv, dgm, dgmom, g12, dv, vals,
                dout):
    """The row-thread kernels (fused_rows.cuh) on n particles: P2G, G2P,
    the splat and the gather against the float64 plain versions, the P2G
    and splat float64 windows within 1e-12 and the G2P and gather rows
    within 1e-6 of each row's largest |value|; the P2G, G2P, splat and
    gather backwards against the float64 plain vjps, every row of every
    weight cotangent and the channel and value cotangents within 1e-6 of
    each row's largest |value| (written where a particle's dv or vals is
    zero: zeros), the float64 grid cotangents within 1e-12; every particle
    row poisoned with NaN before the call; with a tile's tasks on one block
    and split over three (rows_parts), the particle rows bit for bit the
    same. The splat runs only the tiles with a nonzero value (its vote)
    and has no tile window.
    Returns the particle rows of each kernel ("g2p", "gather", "p2g_bwd",
    "g2p_bwd", "splat_bwd", "gather_bwd"), the count of tiles that staged
    their pair products (every kernel's the same but the splat's, which
    counts the tiles that ran) and the scatter kernels' (P2G, the splat,
    the G2P and gather backwards) counts of tiles whose scatter went
    through the tile's window (none of the splat's)."""
    wx, wy, wz = window
    w64 = [w.double() for w in ws]
    gv64 = [g.double() for g in gv]
    rows6 = (wx, wx, wy, wy, wz, wz)
    rows3 = (wx, wy, wz)
    dims = [ctypes.c_int(n)] + [ctypes.c_int(w) for w in window]
    gm, gmom = fused.p2g_plain(*w64, chan.double())
    g2p_fwd = fused.g2p_plain(*w64, *gv64)
    gather_fwd = fused.gather_plain(*w64[0::2], *gv64)
    splat_fwd = fused.splat_plain(*w64[0::2], vals.double())
    live = (vals != 0).any(dim=0)
    live_tiles = int(torch.nn.functional.pad(live, (0, (-n) % 32)).reshape(
        -1, 32).any(dim=1).sum())
    p2g_ref = fused.p2g_vjp_plain(*w64, chan.double(), dgm.double(),
                                  dgmom.double())
    g2p_ref = fused.g2p_vjp_plain(*w64, *gv64, g12.double())
    splat_ref = fused.splat_vjp_plain(*w64[0::2], vals.double(),
                                      dout.double())
    gather_ref = fused.gather_vjp_plain(*w64[0::2], *gv64, dv.double())

    def rows_ok(out, sizes, refs):
        for got, want in zip(torch.split(out, sizes), refs):
            assert not bool(got.isnan().any())
            if n:
                assert _rows_rel(got, want) < 1e-6

    def nans(rows):
        return torch.full((rows, n), float("nan"))
    runs, narrow = [], (ctypes.c_int * 12)()
    for parts in (1, 3):
        part = ctypes.c_int(parts)
        acc, p2g_narrow = _p2g_rows(lib, ws, window, n, chan, parts)
        _grid_check(acc, [gm, gmom])
        out = {"g2p": nans(12)}
        lib.h_fused_g2p(*map(_p, ws), *map(_p, gv), _p(out["g2p"]), *dims,
                        part, ctypes.byref(narrow, 24))
        rows_ok(out["g2p"], (12,), (g2p_fwd,))
        out["gather"] = nans(3)
        lib.h_fused_gather(*map(_p, ws[0::2]), *map(_p, gv),
                           _p(out["gather"]), *dims, part,
                           ctypes.byref(narrow, 40))
        rows_ok(out["gather"], (3,), (gather_fwd,))
        splat_sums, _, splat_narrow = _splat_rows(lib, ws[0::2], window, n,
                                                  vals, parts)
        _grid_check(splat_sums, [splat_fwd])
        assert splat_narrow[2] == live_tiles
        assert splat_narrow[0] <= live_tiles
        out["p2g_bwd"] = nans(sum(rows6) + 13)
        lib.h_fused_p2g_bwd(*map(_p, ws), _p(chan), _p(dgm), _p(dgmom),
                            _p(out["p2g_bwd"]), *dims, part,
                            ctypes.byref(narrow, 0))
        rows_ok(out["p2g_bwd"], rows6 + (13,), p2g_ref)
        out["g2p_bwd"] = nans(sum(rows6))
        # the backwards' first launch zeroes the float64 window
        acc = torch.full((3 * wx * wy * wz,), float("nan"),
                         dtype=torch.float64)
        lib.h_fused_g2p_bwd(*map(_p, ws), *map(_p, gv), _p(g12),
                            _p(out["g2p_bwd"]), _p(acc), *dims, part,
                            ctypes.byref(narrow, 8))
        rows_ok(out["g2p_bwd"], rows6, g2p_ref[:6])
        _grid_check(acc, g2p_ref[6:])
        out["splat_bwd"] = nans(sum(rows3) + 3)
        lib.h_fused_splat_bwd(*map(_p, ws[0::2]), _p(vals), _p(dout),
                              _p(out["splat_bwd"]), *dims, part,
                              ctypes.byref(narrow, 32))
        rows_ok(out["splat_bwd"], rows3 + (3,), splat_ref)
        out["gather_bwd"] = nans(sum(rows3))
        acc.fill_(float("nan"))
        lib.h_fused_gather_bwd(*map(_p, ws[0::2]), *map(_p, gv), _p(dv),
                               _p(out["gather_bwd"]), _p(acc), *dims, part,
                               ctypes.byref(narrow, 16))
        rows_ok(out["gather_bwd"], rows3, gather_ref[:3])
        _grid_check(acc, gather_ref[3:])
        assert p2g_narrow[0] == narrow[0] == narrow[2] == narrow[4] \
            == narrow[6] == narrow[8] == narrow[10]
        # G2P, the gather and the P2G and splat backwards have no scatter
        assert narrow[1] == narrow[7] == narrow[9] == narrow[11] == 0
        runs.append(out)
    assert all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
    return runs[0], narrow[0], {"p2g": p2g_narrow[1], "g2p_bwd": narrow[3],
                                "gather_bwd": narrow[5],
                                "splat": splat_narrow[1]}


@pytest.mark.parametrize("case", ["bspline", "dense"])
def test_fused_backward_sources(lib, case):
    """The four backward kernels against the float64 plain vjps on the
    same float32 inputs and seeded cotangents: every row of every weight
    cotangent (dense in the row: rows outside a particle's box too), the
    channel and value cotangents, and the float64 grid cotangents (the
    row-thread ones with P2G, ``_rows_check``)."""
    ws, window, rng = _fused_weights(case)
    wx, wy, wz = window
    W, W64 = ws[0::2], [w.double() for w in ws[0::2]]
    chan, vals, gv = _f32(rng, 13, N), _f32(rng, 3, N), \
        [_f32(rng, wy * wz, wx) for _ in range(3)]
    dgm, dgmom = _f32(rng, wy * wz, wx), _f32(rng, wy * wz, 3 * wx)
    g12, dout, dv = _f32(rng, 12, N), _f32(rng, wy * wz, 3 * wx), \
        _f32(rng, 3, N)
    outs, narrow, windows = _rows_check(lib, ws, window, N, chan, gv, dgm,
                                        dgmom, g12, dv, vals, dout)
    out = outs["p2g_bwd"]
    # the B-spline boxes (at most 3 rows an axis) stage their pair products
    # in every block; the dense ones (the whole window) read them as they go
    assert narrow == ((N + 31) // 32 if case == "bspline" else 0)
    # the scatter of a narrow tile goes through its window where that fits:
    # every tile of the G2P and gather backwards (3 channels), none of
    # P2G's (4 channels: the boxes of a tile of the scene's random order
    # span too much; test_fused_rows_edges_source sorts them)
    assert windows["g2p_bwd"] == windows["gather_bwd"] == narrow
    assert windows["p2g"] == windows["splat"] == 0
    # a weight cotangent is dense in the row: rows off the stencil too
    off = (out[:wx] != 0) & (ws[0] == 0) & (ws[1] == 0)
    assert case == "dense" or bool(off.any())

    out = torch.zeros(wx + wy + wz + 3, N)
    lib.h_fused_splat_bwd(*map(_p, W), _p(vals), _p(dout), _p(out),
                          *_fdims(window), ctypes.c_int(1),
                          (ctypes.c_int * 2)())
    ref = fused.splat_vjp_plain(*W64, vals.double(), dout.double())
    for got, want in zip(torch.split(out, [wx, wy, wz, 3]), ref):
        assert _rows_rel(got, want) < 1e-6


@pytest.mark.parametrize("case", ["ragged", "empty_axis", "wide_box",
                                  "wide_x", "long_x", "zero_dv", "none",
                                  "sorted"])
def test_fused_rows_edges_source(lib, case):
    """The row-thread kernels (P2G, G2P, the splat and the gather, and the
    P2G, G2P, splat and gather backwards) at the edges of their blocks of
    32 particles, on the
    scene's B-spline weights: n = 37 (a last block of 5); particles whose
    box is empty on one axis (their weight rows of that axis still sum
    over the other two, the other axes' rows are zero, and so are their
    G2P rows and value cotangents); one particle whose six columns are
    dense (its box the whole window: its block reads the pair products
    from memory, the others stage them); one particle dense on x only;
    dense random weights on a window of 70 x rows, more than a block keeps
    in shared memory (kXTile), 37 particles; the gather's cotangent dv and
    the splat's values zero for every particle (no grid terms; their
    weight rows written, zeros; no tile of the splat passes its vote); and
    n = 0 (no block: the backwards' first
    launch alone, windows of zeros); the particles sorted by their
    stencil's base cell (y, z, x), so that every tile's boxes span few
    cells and even P2G's scatter goes through the tile's window (the
    scene's random order leaves it too wide). In every case a few
    particles' dv and values are zero."""
    ws, window, rng = _fused_weights("bspline")
    if case == "long_x":
        window = (70, 3, 4)
        ws = [_f32(rng, w, 37) for w in (70, 70, 3, 3, 4, 4)]
    ws = [w.clone() for w in ws]
    if case == "sorted":
        rows = [torch.arange(w.shape[0])[:, None] for w in ws[0::2]]
        base = [torch.where(w != 0, r, 1 << 20).amin(dim=0)
                for w, r in zip(ws[0::2], rows)]
        order = torch.argsort((base[1] * 64 + base[2]) * 64 + base[0],
                              stable=True)
        ws = [w[:, order] for w in ws]
    wx, wy, wz = window
    n = {"ragged": 37, "long_x": 37, "none": 0}.get(case, N)
    ws = [w[:, :n].contiguous() for w in ws]
    empty = {3: 1, 33: 1, 40: 0, 100: 2}       # particle: the empty axis
    if case == "empty_axis":
        for q, ax in empty.items():
            ws[2 * ax][:, q] = ws[2 * ax + 1][:, q] = 0.0
    elif case == "wide_box":
        for w in ws:
            w[:, 70] = _f32(rng, w.shape[0])
    elif case == "wide_x":
        ws[0][:, 70] = _f32(rng, wx)
    chan, gv = _f32(rng, 13, n), [_f32(rng, wy * wz, wx) for _ in range(3)]
    dgm, dgmom = _f32(rng, wy * wz, wx), _f32(rng, wy * wz, 3 * wx)
    dv, vals = _f32(rng, 3, n), _f32(rng, 3, n)
    few = [q for q in (5, 33, 36) if q < n]
    dv[:, few] = vals[:, few] = 0.0
    if case == "zero_dv":
        dv.zero_()
        vals.zero_()
    outs, narrow, windows = _rows_check(lib, ws, window, n, chan, gv, dgm,
                                        dgmom, _f32(rng, 12, n), dv, vals,
                                        _f32(rng, wy * wz, 3 * wx))
    blocks = (n + 31) // 32
    # the windows fit where the tiles' boxes span few cells, P2G's (4
    # channels) no more often than the backwards' (3); sorted, both ways
    # occur among the narrow tiles
    assert windows["p2g"] <= windows["g2p_bwd"] == windows["gather_bwd"] \
        <= narrow
    # the splat scatters to device memory alone
    assert windows["splat"] == 0
    assert case != "sorted" or 0 < windows["p2g"] < narrow
    assert narrow == {"wide_box": blocks - 1, "wide_x": blocks - 1,
                      "long_x": 0}.get(case, blocks)
    rows3 = wx + wy + wz
    if case == "zero_dv":
        for k in ("splat_bwd", "gather_bwd"):
            assert bool((outs[k][:rows3] == 0).all()), k
    if case == "empty_axis":
        starts = (0, 2 * wx, 2 * (wx + wy))
        for q, ax in empty.items():
            for b, size in enumerate(window):
                rows = outs["p2g_bwd"][starts[b]:starts[b] + 2 * size, q]
                assert bool((rows != 0).any()) == (b == ax), (q, ax, b)
                start = (0, wx, wx + wy)[b]
                rows = outs["splat_bwd"][start:start + size, q]
                assert bool((rows != 0).any()) == (b == ax and q not in few)
            assert bool((outs["g2p"][:, q] == 0).all()), q
            assert bool((outs["splat_bwd"][rows3:, q] == 0).all()), q


@pytest.mark.parametrize("case", ["bspline", "dense"])
def test_kr3_source(lib, case):
    """The pair build bit for bit against the float32 plain version, with N
    (400) not a multiple of the 256-thread block: every output element
    written, the ragged last tile masked."""
    ws, window, _ = _fused_weights(case)
    Wy, WDy, Wz, WDz = ws[2], ws[3], ws[4], ws[5]
    rows = window[1] * window[2]
    outs = [torch.full((rows, N), float("nan")) for _ in range(3)]
    lib.h_kr3(*map(_p, (Wy, Wz, WDy, WDz)), *map(_p, outs), ctypes.c_int(N),
              ctypes.c_int(window[1]), ctypes.c_int(window[2]))
    for got, want in zip(outs, kr.kr3_plain(Wy, Wz, WDy, WDz)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("tile", [1024, 512, 256])
def test_penalty_tiled_source(lib, tile):
    """The tiled penalty pair (contact.cu, contact_bwd.cu on
    contact_mixed.cuh's skeleton, the wrench folded in) on 4000 particles
    over the glass's SDF box: every phase within 1e-12 of
    collide_particle_wrench_plain and its vjp in float64 (classification
    and lists, imp, dx, dv, each block's partial wrench and body
    cotangents, the last block's sum); the band is a few particles in
    ten, so most take the short way."""
    prim, prim64, body, b64, x, v, rng = _penalty_scene(20)
    in_contact, band = _check_tiled(lib, prim, prim64, body, b64, x, v, rng,
                                    tile, None, "penalty")
    assert int(in_contact.sum()) > 400
    assert int(in_contact.sum()) <= int(band.sum()) < x.shape[1] // 2


@pytest.mark.parametrize("case", ["all", "none", "ragged", "empty",
                                  "no_wrench_cotangent", "margin"])
def test_penalty_tiled_cases_source(lib, case):
    """The tiled penalty pair at the edges: every particle in contact (500,
    tile 256: two tiles, the last ragged), none in the band (1000 more than
    1 cm from the glass, tile 512), a ragged last tile at the wrappers'
    tile (1300 box particles), no particle (n = 0: empty outputs, zero
    totals), no wrench cotangent (a null pointer, the Function's None:
    the plain vjp of the impulse alone), and particles moved along the SDF
    normal to dist = 5e-3 + (-0.5, 0.5, 1.5, 3) x the band margin (those
    in contact and within the margin above it kept, the latter out of
    contact in the full math; those past it not kept)."""
    prim, prim64, body, b64, x, v, rng = _penalty_scene(21)
    bp, bq = tuple(b64[0:3]), tuple(b64[3:7])
    dist, normal = contact.sample_sdf_normal_world(prim64, bp, bq,
                                                   tuple(x.double()))
    tile, kw = contact.MIXED_TILE, {}
    if case in ("all", "none"):
        pick = (dist < contact.CONTACT_THRESHOLD if case == "all"
                else dist > 0.01)
        count, tile = (500, 256) if case == "all" else (1000, 512)
        idx = torch.nonzero(pick).flatten()[:count]
        assert idx.numel() == count
        x, v = x[:, idx].contiguous(), v[:, idx].contiguous()
    elif case == "ragged":
        x, v = x[:, :1300].contiguous(), v[:, :1300].contiguous()
    elif case == "empty":
        x, v = x[:, :0].contiguous(), v[:, :0].contiguous()
    elif case == "no_wrench_cotangent":
        kw = {"wrench_cotangent": False}
    else:
        idx = torch.nonzero((dist > 0.001) & (dist < 0.01)).flatten()[:400]
        offsets = torch.tensor([-0.5, 0.5, 1.5, 3.0], dtype=torch.float64)
        target = contact.CONTACT_THRESHOLD + BAND_MARGIN * offsets.repeat(100)
        xs = x[:, idx].double()
        for _ in range(4):
            d, nrm = contact.sample_sdf_normal_world(prim64, bp, bq,
                                                     tuple(xs))
            xs = (xs - (d - target) * torch.stack(nrm)).float().double()
        d, _ = contact.sample_sdf_normal_world(prim64, bp, bq, tuple(xs))
        keep = ((d - target).abs() < 0.2 * BAND_MARGIN).nonzero().flatten()
        x, v = xs[:, keep].float().contiguous(), v[:, idx[keep]].contiguous()
        target, tile = target[keep], 256
    in_contact, band = _check_tiled(lib, prim, prim64, body, b64, x, v, rng,
                                    tile, None, "penalty", **kw)
    n = x.shape[1]
    if case == "all":
        assert int(in_contact.sum()) == int(band.sum()) == n
    elif case == "none":
        assert int(band.sum()) == 0
    elif case == "ragged":
        assert n % tile and -(-n // tile) >= 2
    elif case == "margin":
        off = ((target - contact.CONTACT_THRESHOLD) / BAND_MARGIN).round(
            decimals=1)
        for o, kept in ((-0.5, True), (0.5, True), (1.5, False),
                        (3.0, False)):
            sel = off == o
            assert int(sel.sum()) >= 5, (o, int(sel.sum()))
            assert bool((band[sel] == kept).all()), o
        assert not bool(in_contact[off == 0.5].any())
    if case != "none":
        assert n == 0 or int(in_contact.sum()) > 0
