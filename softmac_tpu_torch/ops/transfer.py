"""B-spline particle/grid transfers: the P2G and G2P CUDA kernels and their
plain PyTorch versions.

Counterpart of ``softmac_tpu/ops/pallas_chunked.py`` (p2g, g2p). Layouts are
the JAX package's: particles ``(3, N)``; the window grid ``(wy*wz, wx)``
with row ``(y - cy) * wz + (z - cz)`` and column ``x - cx``; momentum
``(wy*wz, 3*wx)`` with component d in columns ``d*wx .. (d+1)*wx``.

``p2g`` and ``g2p`` dispatch on the device of their tensors: on the CPU they
run the plain version, on CUDA they launch the kernel (and count the
launch), anything else raises. There is no fallback from CUDA to the plain
version: the plain version runs on a CUDA tensor only when called by name
(``chip_smoke.py`` does, to hold the kernel against it).

Under autograd (grad enabled and an input that requires grad) both go
through the ``P2G`` / ``G2P`` autograd Functions (the custom_vjp of
``pallas_chunked.family``): the backward launches ``p2g_bwd`` / ``g2p_bwd``
on CUDA and runs ``p2g_vjp_plain`` / ``g2p_vjp_plain`` on the CPU. The
window corner is an int tensor and gets no gradient.

Window semantics differ from the TPU kernels on purpose: those truncate each
particle tile to a 16-row y-window and report ``window_overflow`` when a tile
spans more (``pallas_chunked.chunk_meta``). Both versions here are exact over
the whole active window, so the only overflow is the window's own
(``mpm.window_geometry``).
"""
from __future__ import annotations

import torch

from softmac_tpu_torch.ops import build


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


def _device_kind(x, name):
    kind = x.device.type
    if kind not in ("cpu", "cuda"):
        raise TypeError(f"{name}: no implementation for device {x.device}")
    return kind


def _p2g(x, chan, corner, window, inv_dx):
    """P2G splat; see ``p2g_plain``. CUDA tensors launch the kernel."""
    if _device_kind(x, "p2g") == "cpu":
        return p2g_plain(x, chan, corner, window, inv_dx)
    wx, wy, wz = (int(w) for w in window)
    n = x.shape[1]
    _check_cuda("p2g", (x, chan), corner)
    if x.shape != (3, n) or chan.shape != (13, n):
        raise ValueError(f"p2g: x {tuple(x.shape)}, chan {tuple(chan.shape)}")
    cells = wx * wy * wz
    # float64 accumulators, rounded into `out` by the same entry point
    acc = torch.zeros(4 * cells, dtype=torch.float64, device=x.device)
    out = torch.empty(4 * cells, dtype=x.dtype, device=x.device)
    rc = build.library().softmac_p2g(
        x.data_ptr(), chan.data_ptr(), corner.data_ptr(), acc.data_ptr(),
        out.data_ptr(), n, wx, wy, wz, float(inv_dx),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "p2g")
    p2g.launches += 1
    return out[:cells].view(wy * wz, wx), out[cells:].view(wy * wz, 3 * wx)


def _g2p(x, gv0, gv1, gv2, corner, window, inv_dx):
    """G2P gather; see ``g2p_plain``. CUDA tensors launch the kernel."""
    if _device_kind(x, "g2p") == "cpu":
        return g2p_plain(x, gv0, gv1, gv2, corner, window, inv_dx)
    wx, wy, wz = (int(w) for w in window)
    n = x.shape[1]
    _check_cuda("g2p", (x, gv0, gv1, gv2), corner)
    _check_grids("g2p", x, (gv0, gv1, gv2), window)
    out = torch.empty((12, n), dtype=x.dtype, device=x.device)
    rc = build.library().softmac_g2p(
        x.data_ptr(), gv0.data_ptr(), gv1.data_ptr(), gv2.data_ptr(),
        corner.data_ptr(), out.data_ptr(), n, wx, wy, wz, float(inv_dx),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "g2p")
    g2p.launches += 1
    return out


def _check_grids(name, x, grids, window):
    wx, wy, wz = (int(w) for w in window)
    if x.shape != (3, x.shape[1]) or any(g.shape != (wy * wz, wx)
                                         for g in grids):
        raise ValueError(f"{name}: x {tuple(x.shape)}, grids "
                         f"{[tuple(g.shape) for g in grids]}")


def p2g_bwd(x, chan, corner, window, inv_dx, dgm, dgmom):
    """The P2G backward kernel: (dx, dchan) as ``p2g_vjp_plain`` computes
    them, on CUDA float32 tensors."""
    wx, wy, wz = (int(w) for w in window)
    n = x.shape[1]
    _check_cuda("p2g_bwd", (x, chan, dgm, dgmom), corner)
    if (x.shape != (3, n) or chan.shape != (13, n)
            or dgm.shape != (wy * wz, wx) or dgmom.shape != (wy * wz, 3 * wx)):
        raise ValueError("p2g_bwd: bad shapes")
    dx = torch.empty((3, n), dtype=x.dtype, device=x.device)
    dchan = torch.empty((13, n), dtype=x.dtype, device=x.device)
    rc = build.library().softmac_p2g_bwd(
        x.data_ptr(), chan.data_ptr(), corner.data_ptr(), dgm.data_ptr(),
        dgmom.data_ptr(), dx.data_ptr(), dchan.data_ptr(), n, wx, wy, wz,
        float(inv_dx), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "p2g_bwd")
    p2g_bwd.launches += 1
    return dx, dchan


def g2p_bwd(x, gv0, gv1, gv2, corner, window, inv_dx, g):
    """The G2P backward kernel: (dx, dgv0, dgv1, dgv2) as ``g2p_vjp_plain``
    computes them, on CUDA float32 tensors. The grid cotangents are summed
    in float64 and rounded once, as P2G's window."""
    wx, wy, wz = (int(w) for w in window)
    n = x.shape[1]
    _check_cuda("g2p_bwd", (x, gv0, gv1, gv2, g), corner)
    _check_grids("g2p_bwd", x, (gv0, gv1, gv2), window)
    if g.shape != (12, n):
        raise ValueError(f"g2p_bwd: cotangent {tuple(g.shape)}")
    cells = wx * wy * wz
    dx = torch.empty((3, n), dtype=x.dtype, device=x.device)
    acc = torch.zeros(3 * cells, dtype=torch.float64, device=x.device)
    out = torch.empty(3 * cells, dtype=x.dtype, device=x.device)
    rc = build.library().softmac_g2p_bwd(
        x.data_ptr(), gv0.data_ptr(), gv1.data_ptr(), gv2.data_ptr(),
        corner.data_ptr(), g.data_ptr(), dx.data_ptr(), acc.data_ptr(),
        out.data_ptr(), n, wx, wy, wz, float(inv_dx),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "g2p_bwd")
    g2p_bwd.launches += 1
    return (dx,) + tuple(out[d * cells:(d + 1) * cells].view(wy * wz, wx)
                         for d in range(3))


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
        vjp = p2g_vjp_plain if _device_kind(x, "p2g") == "cpu" else p2g_bwd
        dx, dchan = vjp(x, chan, corner, ctx.window, ctx.inv_dx,
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
        vjp = g2p_vjp_plain if _device_kind(x, "g2p") == "cpu" else g2p_bwd
        grads = vjp(x, gv0, gv1, gv2, corner, ctx.window, ctx.inv_dx,
                    g.contiguous())
        return tuple(gr if need else None
                     for gr, need in zip(grads, ctx.needs_input_grad)) \
            + (None, None, None)


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


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
p2g_bwd.launches = 0
g2p_bwd.launches = 0
