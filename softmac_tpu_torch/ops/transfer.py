"""B-spline particle/grid transfers: the P2G, G2P, gather and splat CUDA
kernels and their plain PyTorch versions.

Counterpart of ``softmac_tpu/ops/pallas_chunked.py`` (p2g, g2p, gather,
splat). Layouts are the JAX package's: particles ``(3, N)``; the window
grid ``(wy*wz, wx)`` with row ``(y - cy) * wz + (z - cz)`` and column
``x - cx``; momentum and splat ``(wy*wz, 3*wx)`` with component d in
columns ``d*wx .. (d+1)*wx``.

``p2g``, ``g2p``, ``gather`` and ``splat`` dispatch on the device of their
tensors: on the CPU they run the plain version, on CUDA they launch the
kernel (and count the launch), anything else raises. There is no fallback
from CUDA to the plain version: the plain version runs on a CUDA tensor
only when called by name (``chip_smoke.py`` does, to hold the kernel
against it). The P2G and splat kernels, and the grid halves of the G2P
and gather backwards, keep a sorted particle tile's y rows in shared
memory (``ops/csrc/slab.cuh``); particles whose cells fall outside their
tile's rows go by global atomics instead and are counted in
``p2g.spilled``, ``splat.spilled``, ``g2p_bwd.spilled`` and
``gather_bwd.spilled`` (0 when the particles are sorted by y, as the
rollout keeps them). The G2P and gather kernels and the P2G and splat
backwards stage a tile's box of window cells in shared memory and read
every stencil cell there (``ops/csrc/slab_read.cuh``); a particle whose
rows do not fit its tile's slab reads device memory instead, and
``g2p.off_slab``, ``gather.off_slab``, ``p2g_bwd.off_slab`` and
``splat_bwd.off_slab`` hold each tile's count of those (their sum is the
call's).

Under autograd (grad enabled and an input that requires grad) each goes
through its autograd Function (``P2G``, ``G2P``, ``Gather``, ``Splat``: the
custom_vjps of ``pallas_chunked.family``), whose backward calls
``p2g_bwd`` / ``g2p_bwd`` / ``gather_bwd`` / ``splat_bwd``: these dispatch
as the forwards do, launching the kernel on CUDA and running the plain vjp
(``p2g_vjp_plain`` and its kin: autograd of the plain version,
recomputed) on the CPU. The window corner is an int tensor and
gets no gradient.

Window semantics differ from the TPU kernels on purpose: those truncate each
particle tile to a 16-row y-window and report ``window_overflow`` when a tile
spans more (``pallas_chunked.chunk_meta``). Both versions here are exact over
the whole active window, so the only overflow is the window's own
(``mpm.window_geometry``).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from softmac_tpu_torch.ops import build

# particles a block of the y-slab kernels (ops/csrc/slab.cuh), a power of
# two up to 1024; scripts/slab_phases.py times 256, 512 and 1024 on the
# main paths' states
SLAB_TILE = 512
# particles a block of the read-side tiles (ops/csrc/slab_read.cuh: G2P, the
# gather and the P2G and splat backwards), kReadTile there
READ_TILE = 256


def stencil(x: torch.Tensor, corner: torch.Tensor, window, inv_dx: float):
    """Per-particle 27-cell stencil over the window.

    Returns (flat (27, N) int64 cell index ``row * wx + col``, W, WxD,
    WDy, WDz (27, N) weights). Offsets are ordered
    (i, j, k) -> 9 i + 3 j + k over the x, y, z axes; cells outside the
    window have weight 0 and index 0."""
    wx, wy, wz = window
    pos = x * inv_dx
    base = torch.floor(pos - 0.5)
    fx = pos - base
    w = (0.5 * (1.5 - fx) ** 2, 0.75 - (fx - 1.0) ** 2, 0.5 * (fx - 0.5) ** 2)
    wd = tuple(w[o] * (o - fx) for o in range(3))
    rel = base.to(torch.int64) - corner.to(torch.int64)[:, None]
    flat, inside, W, WxD, WDy, WDz = [], [], [], [], [], []
    for i in range(3):
        for j in range(3):
            for k in range(3):
                cx, cy, cz = rel[0] + i, rel[1] + j, rel[2] + k
                ok = ((cx >= 0) & (cx < wx) & (cy >= 0) & (cy < wy)
                      & (cz >= 0) & (cz < wz))
                inside.append(ok)
                flat.append(torch.where(ok, (cy * wz + cz) * wx + cx, 0))
                wyz = w[j][1] * w[k][2]
                W.append(w[i][0] * wyz)
                WxD.append(wd[i][0] * wyz)
                WDy.append(w[i][0] * (wd[j][1] * w[k][2]))
                WDz.append(w[i][0] * (w[j][1] * wd[k][2]))
    inside = torch.stack(inside)

    def masked(ws):
        return torch.where(inside, torch.stack(ws), 0.0)
    return (torch.stack(flat), masked(W), masked(WxD), masked(WDy),
            masked(WDz))


def p2g_plain(x, chan, corner, window, inv_dx):
    """Plain PyTorch P2G (``index_add_`` over the 27-cell stencil).

    x (3, N) positions; chan (13, N): mass, momentum (3), dx*affine (9,
    row-major); corner (3,) int tensor. Returns gm (wy*wz, wx), gmom
    (wy*wz, 3*wx)."""
    wx, wy, wz = window
    flat, W, WxD, WDy, WDz = stencil(x, corner, window, inv_dx)
    gm = torch.zeros(wy * wz * wx, dtype=x.dtype, device=x.device)
    gm.index_add_(0, flat.reshape(-1), (W * chan[0]).reshape(-1))
    row, col = flat // wx, flat % wx
    gmom = torch.zeros(wy * wz * 3 * wx, dtype=x.dtype, device=x.device)
    for d in range(3):
        val = (W * chan[1 + d] + WxD * chan[4 + 3 * d] + WDy * chan[5 + 3 * d]
               + WDz * chan[6 + 3 * d])
        gmom.index_add_(0, (row * (3 * wx) + d * wx + col).reshape(-1),
                        val.reshape(-1))
    return gm.reshape(wy * wz, wx), gmom.reshape(wy * wz, 3 * wx)


def g2p_plain(x, gv0, gv1, gv2, corner, window, inv_dx):
    """Plain PyTorch G2P (advanced-indexing gather over the stencil).

    gv0..gv2 (wy*wz, wx). Returns (12, N): v in rows 0-2, the unscaled
    C[d][j] in row 3 + 3d + j (the rows of the JAX kernel's (16, N) output
    that are not zero padding)."""
    flat, W, WxD, WDy, WDz = stencil(x, corner, window, inv_dx)
    rows = [None] * 12
    for d, g in enumerate((gv0, gv1, gv2)):
        gg = g.reshape(-1)[flat]
        rows[d] = torch.sum(W * gg, dim=0)
        rows[3 + 3 * d] = torch.sum(WxD * gg, dim=0)
        rows[4 + 3 * d] = torch.sum(WDy * gg, dim=0)
        rows[5 + 3 * d] = torch.sum(WDz * gg, dim=0)
    return torch.stack(rows)


def gather_plain(x, gv0, gv1, gv2, corner, window, inv_dx):
    """Plain PyTorch gather: sum W gv_d over the stencil, (3, N)
    (``mpm.gather_dense``)."""
    flat, W, _, _, _ = stencil(x, corner, window, inv_dx)
    return torch.stack([torch.sum(W * g.reshape(-1)[flat], dim=0)
                        for g in (gv0, gv1, gv2)])


def splat_plain(x, vals, corner, window, inv_dx):
    """Plain PyTorch splat of vals (3, N): sum W vals_d onto the window,
    (wy*wz, 3*wx) with component d in columns d*wx .. (d+1)*wx
    (``mpm.splat_channels``)."""
    wx, wy, wz = window
    flat, W, _, _, _ = stencil(x, corner, window, inv_dx)
    row, col = flat // wx, flat % wx
    out = torch.zeros(wy * wz * 3 * wx, dtype=x.dtype, device=x.device)
    for d in range(3):
        out.index_add_(0, (row * (3 * wx) + d * wx + col).reshape(-1),
                       (W * vals[d]).reshape(-1))
    return out.reshape(wy * wz, 3 * wx)


def p2g_vjp_plain(x, chan, corner, window, inv_dx, dgm, dgmom):
    """Cotangents (dx (3, N), dchan (13, N)) of ``p2g_plain`` for the
    window cotangents dgm (wy*wz, wx), dgmom (wy*wz, 3*wx): autograd of the
    plain version, recomputed."""
    with torch.enable_grad():
        x = x.detach().requires_grad_()
        chan = chan.detach().requires_grad_()
        gm, gmom = p2g_plain(x, chan, corner, window, inv_dx)
        return torch.autograd.grad((gm, gmom), (x, chan), (dgm, dgmom))


def g2p_vjp_plain(x, gv0, gv1, gv2, corner, window, inv_dx, g):
    """Cotangents (dx (3, N), dgv0, dgv1, dgv2 (wy*wz, wx)) of
    ``g2p_plain`` for the output cotangent g (12, N): autograd of the plain
    version, recomputed."""
    with torch.enable_grad():
        ins = tuple(t.detach().requires_grad_() for t in (x, gv0, gv1, gv2))
        out = g2p_plain(*ins, corner, window, inv_dx)
        return torch.autograd.grad(out, ins, g)


def gather_vjp_plain(x, gv0, gv1, gv2, corner, window, inv_dx, dv):
    """Cotangents (dx (3, N), dgv0, dgv1, dgv2 (wy*wz, wx)) of
    ``gather_plain`` for the output cotangent dv (3, N): autograd of the
    plain version, recomputed."""
    with torch.enable_grad():
        ins = tuple(t.detach().requires_grad_() for t in (x, gv0, gv1, gv2))
        out = gather_plain(*ins, corner, window, inv_dx)
        return torch.autograd.grad(out, ins, dv)


def splat_vjp_plain(x, vals, corner, window, inv_dx, dout):
    """Cotangents (dx (3, N), dvals (3, N)) of ``splat_plain`` for the
    window cotangent dout (wy*wz, 3*wx): autograd of the plain version,
    recomputed."""
    with torch.enable_grad():
        ins = tuple(t.detach().requires_grad_() for t in (x, vals))
        out = splat_plain(*ins, corner, window, inv_dx)
        return torch.autograd.grad(out, ins, dout)


def _check_cuda(name, tensors, corner):
    for t in tensors:
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise TypeError(f"{name}: CUDA kernel takes float32 CUDA tensors, "
                            f"got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if (corner.device != tensors[0].device or corner.dtype != torch.int32
            or corner.shape != (3,) or not corner.is_contiguous()):
        raise TypeError(f"{name}: corner must be a contiguous (3,) int32 "
                        "tensor on the particles' device")


def _p2g(x, chan, corner, window, inv_dx):
    """P2G splat; see ``p2g_plain``. CUDA tensors launch the kernel;
    ``p2g.spilled`` then holds the call's count of spilled particles."""
    if build.on_cpu(x, "p2g"):
        return p2g_plain(x, chan, corner, window, inv_dx)
    wx, wy, wz = (int(w) for w in window)
    n = x.shape[1]
    _check_cuda("p2g", (x, chan), corner)
    if x.shape != (3, n) or chan.shape != (13, n):
        raise ValueError(f"p2g: x {tuple(x.shape)}, chan {tuple(chan.shape)}")
    out, _, p2g.spilled = _slab("p2g", 4, 13, x, chan, corner, (wx, wy, wz),
                                inv_dx)
    p2g.launches += 1
    cells = wx * wy * wz
    return out[:cells].view(wy * wz, wx), out[cells:].view(wy * wz, 3 * wx)


def _slab(name, channels, inputs, x, src, corner, window, inv_dx, grids=()):
    """One call of a y-slab kernel: P2G (4 channels of 13 input rows), the
    splat (3 of 3), or the G2P or gather backward (3 of 12 or 3 of 3),
    which also take the three ``grids`` and gather dx (3, N) in the same
    launch. Returns the float32 window (channels * cells: P2G's gm then
    gmom, the splat's one window, the backwards' three grids one after the
    other), dx (None without grids) and the call's spilled-particle count
    (a one-element int64 tensor on the card, read after a synchronize)."""
    n = x.shape[1]
    tiles, _, _, _, tile_doubles = slab_plan(channels, inputs, n, SLAB_TILE,
                                             window)
    cells = math.prod(window)
    dev = x.device
    spill = torch.zeros(channels * cells + 1, dtype=torch.float64, device=dev)
    partial = torch.empty(tiles * tile_doubles, dtype=torch.float64,
                          device=dev)
    meta = torch.empty(2 * tiles, dtype=torch.int32, device=dev)
    out = torch.empty(channels * cells, dtype=x.dtype, device=dev)
    dx = torch.empty((3, n), dtype=x.dtype, device=dev) if grids else None
    ptrs = (x, src, corner, *grids) + ((dx,) if grids else ()) + (
        spill, partial, meta, out)
    rc = getattr(build.library(), "softmac_" + name)(
        *(t.data_ptr() for t in ptrs), n, SLAB_TILE, *window, float(inv_dx),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, name)
    return out, dx, spill[-1:].view(torch.int64)


@functools.lru_cache(maxsize=None)
def slab_plan(channels, inputs, n, tile, window):
    """How the y-slab kernel cuts one call (``softmac_slab_plan``): (tiles,
    particles a tile, slab rows, dynamic shared bytes a block, doubles of
    one tile's partial slab)."""
    out = (ctypes.c_longlong * 5)()
    build.library().softmac_slab_plan(channels, inputs, n, tile, *window,
                                      ctypes.addressof(out))
    return tuple(out)


def _grid_views(out, window):
    """The three (wy*wz, wx) grids of a backward's window, as views."""
    wx, wy, wz = window
    cells = wx * wy * wz
    return tuple(out[d * cells:(d + 1) * cells].view(wy * wz, wx)
                 for d in range(3))


def _g2p(x, gv0, gv1, gv2, corner, window, inv_dx):
    """G2P gather; see ``g2p_plain``. CUDA tensors launch the kernel;
    ``g2p.off_slab`` then holds each tile's count of particles that read
    device memory."""
    if build.on_cpu(x, "g2p"):
        return g2p_plain(x, gv0, gv1, gv2, corner, window, inv_dx)
    _check_cuda("g2p", (x, gv0, gv1, gv2), corner)
    _check_grids("g2p", x, (gv0, gv1, gv2), window)
    out = torch.empty((12, x.shape[1]), dtype=x.dtype, device=x.device)
    g2p.off_slab = _read("g2p", (x, gv0, gv1, gv2, corner, out), window,
                         inv_dx)
    g2p.launches += 1
    return out


# each read-side kernel's per-tile counts, by (kernel, device, particles):
# one buffer that every such call overwrites (a new tensor a call cost the
# host ~4 us of each call, on a path whose calls wait on the host)
_OFF_SLAB = {}


def _read(name, tensors, window, inv_dx):
    """One call of a read-side tile kernel (G2P, the gather, the P2G or the
    splat backward): its entry point takes the data pointers of
    ``tensors`` (x first, then the rest in its order, outputs last) and
    each tile's count of particles that read device memory, which is
    returned (an int32 tensor on the card, which the next call of this
    kernel on as many particles overwrites)."""
    x = tensors[0]
    n = x.shape[1]
    off_slab = _OFF_SLAB.get((name, x.device, n))
    if off_slab is None:
        off_slab = _OFF_SLAB[name, x.device, n] = torch.empty(
            -(-n // READ_TILE), dtype=torch.int32, device=x.device)
    rc = getattr(build.library(), "softmac_" + name)(
        *(t.data_ptr() for t in tensors), off_slab.data_ptr(), n,
        *(int(w) for w in window), float(inv_dx),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, name)
    return off_slab


def _check_grids(name, x, grids, window):
    wx, wy, wz = (int(w) for w in window)
    if x.shape != (3, x.shape[1]) or any(g.shape != (wy * wz, wx)
                                         for g in grids):
        raise ValueError(f"{name}: x {tuple(x.shape)}, grids "
                         f"{[tuple(g.shape) for g in grids]}")


def p2g_bwd(x, chan, corner, window, inv_dx, dgm, dgmom):
    """The P2G backward: (dx, dchan) as ``p2g_vjp_plain`` computes them.
    CUDA float32 tensors launch the kernel (a gather: no atomics);
    ``p2g_bwd.off_slab`` then holds each tile's count of particles that
    read device memory."""
    if build.on_cpu(x, "p2g_bwd"):
        return p2g_vjp_plain(x, chan, corner, window, inv_dx, dgm, dgmom)
    wx, wy, wz = (int(w) for w in window)
    n = x.shape[1]
    _check_cuda("p2g_bwd", (x, chan, dgm, dgmom), corner)
    if (x.shape != (3, n) or chan.shape != (13, n)
            or dgm.shape != (wy * wz, wx) or dgmom.shape != (wy * wz, 3 * wx)):
        raise ValueError("p2g_bwd: bad shapes")
    dx = torch.empty((3, n), dtype=x.dtype, device=x.device)
    dchan = torch.empty((13, n), dtype=x.dtype, device=x.device)
    p2g_bwd.off_slab = _read("p2g_bwd", (x, chan, corner, dgm, dgmom, dx,
                                         dchan), window, inv_dx)
    p2g_bwd.launches += 1
    return dx, dchan


def g2p_bwd(x, gv0, gv1, gv2, corner, window, inv_dx, g):
    """The G2P backward: (dx, dgv0, dgv1, dgv2) as ``g2p_vjp_plain``
    computes them. CUDA float32 tensors launch one y-slab call: the grid
    cotangents are summed per cell in float64, in a fixed order, and
    rounded once, as P2G's window; dx is gathered in the same launch.
    ``g2p_bwd.spilled`` then holds the call's count of spilled particles."""
    if build.on_cpu(x, "g2p_bwd"):
        return g2p_vjp_plain(x, gv0, gv1, gv2, corner, window, inv_dx, g)
    wx, wy, wz = (int(w) for w in window)
    _check_cuda("g2p_bwd", (x, gv0, gv1, gv2, g), corner)
    _check_grids("g2p_bwd", x, (gv0, gv1, gv2), window)
    if g.shape != (12, x.shape[1]):
        raise ValueError(f"g2p_bwd: cotangent {tuple(g.shape)}")
    out, dx, g2p_bwd.spilled = _slab("g2p_bwd", 3, 12, x, g, corner,
                                     (wx, wy, wz), inv_dx, (gv0, gv1, gv2))
    g2p_bwd.launches += 1
    return (dx,) + _grid_views(out, (wx, wy, wz))


class P2G(torch.autograd.Function):
    """P2G with its backward kernel (``pallas_chunked.family().p2g_c``)."""

    @staticmethod
    def forward(ctx, x, chan, corner, window, inv_dx):
        ctx.save_for_backward(x, chan, corner)
        ctx.window, ctx.inv_dx = window, inv_dx
        return _p2g(x, chan, corner, window, inv_dx)

    @staticmethod
    def backward(ctx, dgm, dgmom):
        x, chan, corner = ctx.saved_tensors
        dx, dchan = p2g_bwd(x, chan, corner, ctx.window, ctx.inv_dx,
                            dgm.contiguous(), dgmom.contiguous())
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dchan if need[1] else None,
                None, None, None)


class G2P(torch.autograd.Function):
    """G2P with its backward kernel (``pallas_chunked.family().g2p_c``)."""

    @staticmethod
    def forward(ctx, x, gv0, gv1, gv2, corner, window, inv_dx):
        ctx.save_for_backward(x, gv0, gv1, gv2, corner)
        ctx.window, ctx.inv_dx = window, inv_dx
        return _g2p(x, gv0, gv1, gv2, corner, window, inv_dx)

    @staticmethod
    def backward(ctx, g):
        x, gv0, gv1, gv2, corner = ctx.saved_tensors
        grads = g2p_bwd(x, gv0, gv1, gv2, corner, ctx.window, ctx.inv_dx,
                        g.contiguous())
        return tuple(gr if need else None
                     for gr, need in zip(grads, ctx.needs_input_grad)) \
            + (None, None, None)


def gather_bwd(x, gv0, gv1, gv2, corner, window, inv_dx, dv):
    """The gather backward: (dx, dgv0, dgv1, dgv2) as ``gather_vjp_plain``
    computes them. CUDA float32 tensors launch one y-slab call, as
    ``g2p_bwd``: a particle whose cotangent is all zero adds nothing to the
    grids and gets dx = 0 (exact to the bit: the splat's skip).
    ``gather_bwd.spilled`` then holds the call's count of spilled
    particles."""
    if build.on_cpu(x, "gather_bwd"):
        return gather_vjp_plain(x, gv0, gv1, gv2, corner, window, inv_dx, dv)
    wx, wy, wz = (int(w) for w in window)
    _check_cuda("gather_bwd", (x, gv0, gv1, gv2, dv), corner)
    _check_grids("gather_bwd", x, (gv0, gv1, gv2), window)
    if dv.shape != (3, x.shape[1]):
        raise ValueError(f"gather_bwd: cotangent {tuple(dv.shape)}")
    out, dx, gather_bwd.spilled = _slab("gather_bwd", 3, 3, x, dv, corner,
                                        (wx, wy, wz), inv_dx,
                                        (gv0, gv1, gv2))
    gather_bwd.launches += 1
    return (dx,) + _grid_views(out, (wx, wy, wz))


def splat_bwd(x, vals, corner, window, inv_dx, dout):
    """The splat backward: (dx, dvals) as ``splat_vjp_plain`` computes
    them. CUDA float32 tensors launch the kernel (a gather: no atomics; a
    particle whose values are all zero gets dx = 0 and the gather's
    dvals); ``splat_bwd.off_slab`` then holds each tile's count of
    particles that read device memory."""
    if build.on_cpu(x, "splat_bwd"):
        return splat_vjp_plain(x, vals, corner, window, inv_dx, dout)
    wx, wy, wz = (int(w) for w in window)
    n = x.shape[1]
    _check_cuda("splat_bwd", (x, vals, dout), corner)
    if (x.shape != (3, n) or vals.shape != (3, n)
            or dout.shape != (wy * wz, 3 * wx)):
        raise ValueError("splat_bwd: bad shapes")
    dx = torch.empty((3, n), dtype=x.dtype, device=x.device)
    dvals = torch.empty((3, n), dtype=x.dtype, device=x.device)
    splat_bwd.off_slab = _read("splat_bwd", (x, vals, corner, dout, dx,
                                             dvals), window, inv_dx)
    splat_bwd.launches += 1
    return dx, dvals


class Gather(torch.autograd.Function):
    """Gather with its backward kernel
    (``pallas_chunked.family().gather_c``)."""

    @staticmethod
    def forward(ctx, x, gv0, gv1, gv2, corner, window, inv_dx):
        ctx.save_for_backward(x, gv0, gv1, gv2, corner)
        ctx.window, ctx.inv_dx = window, inv_dx
        return _gather(x, gv0, gv1, gv2, corner, window, inv_dx)

    @staticmethod
    def backward(ctx, dv):
        x, gv0, gv1, gv2, corner = ctx.saved_tensors
        grads = gather_bwd(x, gv0, gv1, gv2, corner, ctx.window, ctx.inv_dx,
                           dv.contiguous())
        return tuple(gr if need else None
                     for gr, need in zip(grads, ctx.needs_input_grad)) \
            + (None, None, None)


class Splat(torch.autograd.Function):
    """Splat with its backward kernel
    (``pallas_chunked.family().splat_c``)."""

    @staticmethod
    def forward(ctx, x, vals, corner, window, inv_dx):
        ctx.save_for_backward(x, vals, corner)
        ctx.window, ctx.inv_dx = window, inv_dx
        return _splat(x, vals, corner, window, inv_dx)

    @staticmethod
    def backward(ctx, dout):
        x, vals, corner = ctx.saved_tensors
        dx, dvals = splat_bwd(x, vals, corner, ctx.window, ctx.inv_dx,
                              dout.contiguous())
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dvals if need[1] else None,
                None, None, None)


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _gather(x, gv0, gv1, gv2, corner, window, inv_dx):
    """Gather of the grid velocity at the particles; see ``gather_plain``.
    CUDA tensors launch the kernel; ``gather.off_slab`` then holds each
    tile's count of particles that read device memory."""
    if build.on_cpu(x, "gather"):
        return gather_plain(x, gv0, gv1, gv2, corner, window, inv_dx)
    _check_cuda("gather", (x, gv0, gv1, gv2), corner)
    _check_grids("gather", x, (gv0, gv1, gv2), window)
    out = torch.empty((3, x.shape[1]), dtype=x.dtype, device=x.device)
    gather.off_slab = _read("gather", (x, gv0, gv1, gv2, corner, out), window,
                            inv_dx)
    gather.launches += 1
    return out


def _splat(x, vals, corner, window, inv_dx):
    """Splat of vals onto the window; see ``splat_plain``. CUDA tensors
    launch the kernel (float64 sums, rounded once); ``splat.spilled`` then
    holds the call's count of spilled particles."""
    if build.on_cpu(x, "splat"):
        return splat_plain(x, vals, corner, window, inv_dx)
    wx, wy, wz = (int(w) for w in window)
    n = x.shape[1]
    _check_cuda("splat", (x, vals), corner)
    if x.shape != (3, n) or vals.shape != (3, n):
        raise ValueError(f"splat: x {tuple(x.shape)}, vals "
                         f"{tuple(vals.shape)}")
    out, _, splat.spilled = _slab("splat", 3, 3, x, vals, corner,
                                  (wx, wy, wz), inv_dx)
    splat.launches += 1
    return out.view(wy * wz, 3 * wx)


def gather(x, gv0, gv1, gv2, corner, window, inv_dx):
    """Gather of the grid velocity at the particles, (3, N); see
    ``gather_plain``. CUDA tensors launch the kernel; under autograd the
    backward launches ``gather_bwd``."""
    if _needs_grad(x, gv0, gv1, gv2):
        return Gather.apply(x, gv0, gv1, gv2, corner, window, inv_dx)
    return _gather(x, gv0, gv1, gv2, corner, window, inv_dx)


def splat(x, vals, corner, window, inv_dx):
    """Splat of vals (3, N) onto the window, (wy*wz, 3*wx); see
    ``splat_plain``. CUDA tensors launch the kernel; under autograd the
    backward launches ``splat_bwd``."""
    if _needs_grad(x, vals):
        return Splat.apply(x, vals, corner, window, inv_dx)
    return _splat(x, vals, corner, window, inv_dx)


def p2g(x, chan, corner, window, inv_dx):
    """P2G splat; see ``p2g_plain``. CUDA tensors launch the kernel; under
    autograd the backward launches ``p2g_bwd``."""
    if _needs_grad(x, chan):
        return P2G.apply(x, chan, corner, window, inv_dx)
    return _p2g(x, chan, corner, window, inv_dx)


def g2p(x, gv0, gv1, gv2, corner, window, inv_dx):
    """G2P gather; see ``g2p_plain``. CUDA tensors launch the kernel; under
    autograd the backward launches ``g2p_bwd``."""
    if _needs_grad(x, gv0, gv1, gv2):
        return G2P.apply(x, gv0, gv1, gv2, corner, window, inv_dx)
    return _g2p(x, gv0, gv1, gv2, corner, window, inv_dx)


p2g.launches = 0
g2p.launches = 0
gather.launches = 0
splat.launches = 0
p2g_bwd.launches = 0
g2p_bwd.launches = 0
gather_bwd.launches = 0
splat_bwd.launches = 0
p2g.spilled = None
g2p.off_slab = None
gather.off_slab = None
p2g_bwd.off_slab = None
splat_bwd.off_slab = None
splat.spilled = None
g2p_bwd.spilled = None
gather_bwd.spilled = None
