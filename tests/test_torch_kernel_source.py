"""PyTorch port: the arithmetic of the CUDA kernel sources, built for the
host. There is no card and no nvcc here, so the kernel bodies of
softmac_tpu_torch/ops/csrc (each .cu file above its C entry point, and the
headers) are compiled with the host C++ compiler over a small stand-in for
the CUDA runtime header; each kernel runs one thread at a time. The block
reduction of the contact backward (shared memory and barriers) is left to
chip_smoke.py; here the per-particle reverse sweep is summed on the host.

Held against the plain versions in float64 on the same float32 inputs:
P2G (its splat is shared with G2P's backward) and the P2G / G2P backward
kernels, which compute in float32, within 2e-6 of the largest |value| of
each output; the contact backward, which computes in double on its float
inputs, within 1e-6 (float literals and the float dt / p_mass set that
floor). The contact check runs on the real glass table, with particles
spread over its SDF box."""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from softmac_tpu_torch.engine import sdf as tsdf
from softmac_tpu_torch.engine.meshio import load_obj
from softmac_tpu_torch.ops import build, contact, m33, transfer

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
struct dim3s { unsigned x, y, z; };
extern dim3s blockIdx, threadIdx, blockDim, gridDim;
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline double atomicAdd(double* p, double v) { double o = *p; *p = o + v; return o; }
"""

DRIVER = r"""
dim3s blockIdx, threadIdx, blockDim, gridDim;
template <class F> static void launch(int n, F f) {
  blockDim.x = 256; gridDim.x = (n + 255) / 256;
  for (unsigned b = 0; b < gridDim.x; ++b)
    for (unsigned t = 0; t < 256; ++t) { blockIdx.x = b; threadIdx.x = t; f(); }
}
extern "C" {
void h_p2g(const float* x, const float* chan, const int* corner, double* acc,
           int n, int wx, int wy, int wz, float inv_dx) {
  int cells = wx * wy * wz;
  launch(n, [&] { k_p2g::p2g_kernel(x, chan, corner, acc, acc + cells, n, wx,
                                    wy, wz, inv_dx); });
}
void h_p2g_bwd(const float* x, const float* chan, const int* corner,
               const float* dgm, const float* dgmom, float* dx, float* dchan,
               int n, int wx, int wy, int wz, float inv_dx) {
  launch(n, [&] { k_p2g_bwd::p2g_bwd_kernel(x, chan, corner, dgm, dgmom, dx,
                                            dchan, n, wx, wy, wz, inv_dx); });
}
void h_g2p_bwd(const float* x, const float* g0, const float* g1,
               const float* g2, const int* corner, const float* g, float* dx,
               double* acc, int n, int wx, int wy, int wz, float inv_dx) {
  launch(n, [&] { k_g2p_bwd::g2p_bwd_kernel(x, g0, g1, g2, corner, g, dx, acc,
                                            n, wx, wy, wz, inv_dx); });
}
void h_contact_bwd(const float* x, const float* v, const float* table,
                   const float* body, const float* gimp, double* dx,
                   double* dv, double* dbody, int n, int r0, int r1, int r2,
                   float l0, float l1, float l2, float u0, float u1, float u2,
                   float inv_dx, float dt, float p_mass) {
  softmac::Geom g = {{l0, l1, l2}, {u0, u1, u2}, inv_dx, {r0, r1, r2}};
  const softmac::Body<double> b = softmac::load_body<double>(body);
  for (int i = 0; i < 14; ++i) dbody[i] = 0.0;
  for (int p = 0; p < n; ++p) {
    softmac::V3<double> xp = {x[p], x[n + p], x[2 * n + p]};
    softmac::V3<double> vp = {v[p], v[n + p], v[2 * n + p]};
    softmac::Contact<double> k = softmac::contact_forward(
        b, xp, vp, (const float4*)table, g, double(dt), double(p_mass));
    softmac::V3<double> gi = {gimp[p], gimp[n + p], gimp[2 * n + p]}, gx, gv;
    double gb[14];
    softmac::contact_backward(b, k, gi, g, double(dt), double(p_mass), gx,
                              gv, gb);
    dx[p] = gx.x; dx[n + p] = gx.y; dx[2 * n + p] = gx.z;
    dv[p] = gv.x; dv[n + p] = gv.y; dv[2 * n + p] = gv.z;
    for (int i = 0; i < 14; ++i) dbody[i] += gb[i];
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
    src = "".join(_kernel_bodies(n) for n in ("p2g", "p2g_bwd", "g2p_bwd",
                                                "contact")) + DRIVER
    (d / "driver.cpp").write_text(src)
    so = d / "libkernels_host.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(d), "-I", str(build.CSRC), "-o",
                    str(so), str(d / "driver.cpp")], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(so))


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


def _dims(window):
    return [ctypes.c_int(N)] + [ctypes.c_int(w) for w in window] + [
        ctypes.c_float(INV_DX)]


def _rel(got, want):
    return ((got.double() - want).abs().max()
            / want.abs().max().clamp(min=1e-300)).item()


def _scene(shift, seed=0):
    rng = np.random.RandomState(seed)
    x = np.stack([0.45 + 0.09 * rng.rand(N), 0.30 + 0.06 * rng.rand(N),
                  0.50 + 0.05 * rng.rand(N)])
    corner = [int(np.round((x[d] * INV_DX - 0.5).mean())) - w // 2 + shift
              for d, w in enumerate(WINDOW)]
    return (torch.tensor(x, dtype=torch.float32),
            torch.tensor(corner, dtype=torch.int32), rng)


def _f32(rng, *shape):
    return torch.tensor(rng.randn(*shape), dtype=torch.float32)


@pytest.mark.parametrize("shift", [0, 2])
def test_p2g_and_backward_sources(lib, shift):
    x, corner, rng = _scene(shift)
    wx, wy, wz = WINDOW
    chan, dgm, dgmom = _f32(rng, 13, N), _f32(rng, wy * wz, wx), \
        _f32(rng, wy * wz, 3 * wx)
    acc = torch.zeros(4 * wx * wy * wz, dtype=torch.float64)
    lib.h_p2g(_p(x), _p(chan), _p(corner), _p(acc), *_dims(WINDOW))
    gm, gmom = transfer.p2g_plain(x.double(), chan.double(), corner, WINDOW,
                                  INV_DX)
    assert _rel(acc, torch.cat([gm.reshape(-1), gmom.reshape(-1)])) < 2e-6

    dx, dchan = torch.zeros(3, N), torch.zeros(13, N)
    lib.h_p2g_bwd(_p(x), _p(chan), _p(corner), _p(dgm), _p(dgmom), _p(dx),
                  _p(dchan), *_dims(WINDOW))
    ref = transfer.p2g_vjp_plain(x.double(), chan.double(), corner, WINDOW,
                                 INV_DX, dgm.double(), dgmom.double())
    assert _rel(dx, ref[0]) < 2e-6 and _rel(dchan, ref[1]) < 2e-6


@pytest.mark.parametrize("shift", [0, 2])
def test_g2p_backward_source(lib, shift):
    x, corner, rng = _scene(shift, seed=1)
    wx, wy, wz = WINDOW
    gv = [_f32(rng, wy * wz, wx) for _ in range(3)]
    g = _f32(rng, 12, N)
    dx = torch.zeros(3, N)
    acc = torch.zeros(3 * wx * wy * wz, dtype=torch.float64)
    lib.h_g2p_bwd(_p(x), *map(_p, gv), _p(corner), _p(g), _p(dx), _p(acc),
                  *_dims(WINDOW))
    ref = transfer.g2p_vjp_plain(x.double(), *(t.double() for t in gv),
                                 corner, WINDOW, INV_DX, g.double())
    assert _rel(dx, ref[0]) < 2e-6
    for d in range(3):
        assert _rel(acc.reshape(3, -1)[d], ref[1 + d].reshape(-1)) < 2e-6


def test_contact_backward_source(lib):
    verts, faces = load_obj(str(ROOT / "assets/glass/glass.obj"))
    bake = tsdf.preprocess_sdf(verts, faces, ROOT / "assets/glass")
    prim = tsdf.sdf_params_from_bake(bake, torch.float32, "cpu")
    prim64 = prim.replace(neighborhood=prim.neighborhood.double(),
                          lower=prim.lower.double(), upper=prim.upper.double(),
                          inv_dx=prim.inv_dx.double())
    rng = np.random.RandomState(0)
    n = 4000
    q = np.array([0.9, 0.1, -0.2, 0.15])
    q *= 1.001 / np.linalg.norm(q)        # slightly off unit, as |q| may be
    body = torch.tensor(np.concatenate(
        [[0.72, 0.28, 0.51], q, [0.1, -0.2, 0.05], [0.3, 0.1, -0.2], [10.0]]),
        dtype=torch.float32)
    b64 = body.double()
    lo, up = prim64.lower, prim64.upper
    p_loc = lo[:, None] + (up - lo)[:, None] * torch.as_tensor(rng.rand(3, n))
    x = torch.stack(m33.vadd(m33.qrot(m33.qnorm(tuple(b64[3:7])),
                                      tuple(p_loc)), tuple(b64[0:3])))
    x = x.float().contiguous()
    v, gimp = _f32(rng, 3, n) * 0.5, _f32(rng, 3, n)
    dt, p_mass = 1e-3, 1.5e-5

    dx = torch.zeros(3, n, dtype=torch.float64)
    dv = torch.zeros(3, n, dtype=torch.float64)
    db = torch.zeros(14, dtype=torch.float64)
    f = ctypes.c_float
    lib.h_contact_bwd(_p(x), _p(v), _p(prim.neighborhood), _p(body),
                      _p(gimp), _p(dx), _p(dv), _p(db), ctypes.c_int(n),
                      *(ctypes.c_int(r) for r in prim.res),
                      *(f(g) for g in prim.geom), f(dt), f(p_mass))
    parts = (b64[0:3], b64[3:7], b64[7:10], b64[10:13], b64[13])
    _, mask = contact.collide_particle_plain(prim64, *parts, x.double(),
                                             v.double(), dt, p_mass)
    assert int(mask.sum()) > 400, "too few contacts"
    ref = contact.collide_particle_vjp_plain(prim64, *parts, x.double(),
                                             v.double(), dt, p_mass,
                                             gimp.double())
    assert _rel(dx, ref[5]) < 1e-6 and _rel(dv, ref[6]) < 1e-6
    for (a, b), r in zip(((0, 3), (3, 7), (7, 10), (10, 13), (13, 14)),
                         ref[:5]):
        assert _rel(db[a:b], r.reshape(-1)) < 1e-6
