"""The dense-weight transfer family: P2G, G2P, gather and splat over
per-axis weight matrices, as CUDA kernels and plain PyTorch versions.

Counterpart of ``softmac_tpu/ops/pallas_fused.py`` (``p2g``, ``g2p``,
``splat``, ``gather``, :878-945), the transfers of windows the y-chunked
family does not take (``engine/mpm.py``'s route: the door's window (32, 16,
32)). Their inputs are the dense per-axis matrices of ``mpm.axis_weights``:
``Wx``, ``WxD`` (wx, N), ``Wy``, ``WDy`` (wy, N), ``Wz``, ``WDz`` (wz, N), row
r of W_d the weight of each particle on window row r along axis d and WD_d
the same times (r - base - fx). With H = Wy * Wz (the Khatri-Rao pair over
(y, z), row y * wz + z) and HDy, HDz its derivative variants:

    p2g     chan (13, N) [mass, mom(3), dx*affine(9)] ->
            gm (wy*wz, wx), gmom (wy*wz, 3*wx):
            gm = H (Wx mass)^T, gmom_d = H (Wx mom_d + WxD a_d0)^T
                 + HDy (Wx a_d1)^T + HDz (Wx a_d2)^T
    g2p     grids gv_d (wy*wz, wx) -> (12, N): v_d = sum H * (gv_d Wx),
            C[d][0] = sum H * (gv_d WxD), C[d][1] = sum HDy * (gv_d Wx),
            C[d][2] = sum HDz * (gv_d Wx) (C unscaled: times 4 inv_dx
            outside, as ``mpm._Transfers.g2p``)
    splat   vals (3, N) -> (wy*wz, 3*wx): H (Wx vals_d)^T per component
    gather  grids gv_d -> (3, N): sum H * (gv_d Wx)

for any dense weights, not only B-spline-sparse ones. The plain versions
(``p2g_plain`` ...) are those definitions (``pallas_fused._p2g_ref`` :181,
``_g2p_ref`` :207, ``_splat_ref`` :232, ``_gather_ref`` :241), in the dtype
of their inputs; their products run in full precision (TF32 is off on the
card, as ``SoftMacEnv`` sets it).

``p2g``, ``g2p``, ``splat`` and ``gather`` dispatch through
``build.on_cpu``: on the CPU they run the plain version, on CUDA they
launch the kernel and count the launch, anything else raises. There is no
fallback from CUDA to the plain version.

Under autograd (grad enabled and an input that requires grad) each goes
through its autograd Function (``FusedP2G``, ``FusedG2P``, ``FusedSplat``,
``FusedGather``: the custom_vjps of ``pallas_fused`` :878-945), whose
backward returns the cotangents of every weight matrix and of the
channels, grids or values through ``p2g_bwd`` / ``g2p_bwd`` /
``splat_bwd`` / ``gather_bwd``, which dispatch the same way: on CUDA they
launch the backward kernel (dense in every weight row), on the CPU they
run the plain vjp (``p2g_vjp_plain`` and its kin: autograd of the plain
version, recomputed, in the dtype of its inputs). The weight cotangents flow on through ``mpm.axis_weights`` to x.
"""
from __future__ import annotations

import torch

from softmac_tpu_torch.ops import build, kr


def p2g_plain(Wx, WxD, Wy, WDy, Wz, WDz, chan):
    """Plain PyTorch P2G over dense weights: (gm (wy*wz, wx),
    gmom (wy*wz, 3*wx))."""
    wx = Wx.shape[0]
    H, HDy, HDz = kr.kr3_plain(Wy, Wz, WDy, WDz)
    r_h = torch.cat([Wx * chan[0]] + [Wx * chan[1 + d] + WxD * chan[4 + 3 * d]
                                      for d in range(3)])
    r_dy = torch.cat([Wx * chan[5 + 3 * d] for d in range(3)])
    r_dz = torch.cat([Wx * chan[6 + 3 * d] for d in range(3)])
    o1 = H @ r_h.T
    return o1[:, :wx], o1[:, wx:] + HDy @ r_dy.T + HDz @ r_dz.T


def g2p_plain(Wx, WxD, Wy, WDy, Wz, WDz, gv0, gv1, gv2):
    """Plain PyTorch G2P over dense weights: (12, N), v in rows 0-2, the
    unscaled C[d][j] in row 3 + 3d + j."""
    H, HDy, HDz = kr.kr3_plain(Wy, Wz, WDy, WDz)
    rows, m_rows = [], []
    for g in (gv0, gv1, gv2):
        A, B = g @ Wx, g @ WxD
        rows.append(torch.sum(H * A, dim=0))
        m_rows += [torch.sum(H * B, dim=0), torch.sum(HDy * A, dim=0),
                   torch.sum(HDz * A, dim=0)]
    return torch.stack(rows + m_rows)


def splat_plain(Wx, Wy, Wz, vals):
    """Plain PyTorch splat of vals (3, N): (wy*wz, 3*wx)."""
    r = torch.cat([Wx * vals[d] for d in range(3)])
    return kr.pair(Wy, Wz) @ r.T


def gather_plain(Wx, Wy, Wz, gv0, gv1, gv2):
    """Plain PyTorch gather of the grids at the particles: (3, N)."""
    H = kr.pair(Wy, Wz)
    return torch.stack([torch.sum(H * (g @ Wx), dim=0)
                        for g in (gv0, gv1, gv2)])


def _vjp(fn, ins, cts):
    """Cotangents of ``fn(*ins)`` for the output cotangents ``cts``:
    autograd of the plain version, recomputed."""
    with torch.enable_grad():
        ins = tuple(t.detach().requires_grad_() for t in ins)
        return torch.autograd.grad(fn(*ins), ins, cts)


def p2g_vjp_plain(Wx, WxD, Wy, WDy, Wz, WDz, chan, dgm, dgmom):
    """Cotangents (dWx, dWxD, dWy, dWDy, dWz, dWDz, dchan) of ``p2g_plain``
    for the window cotangents dgm (wy*wz, wx), dgmom (wy*wz, 3*wx)
    (``jax.vjp`` of ``pallas_fused._p2g_ref``)."""
    return _vjp(p2g_plain, (Wx, WxD, Wy, WDy, Wz, WDz, chan), (dgm, dgmom))


def g2p_vjp_plain(Wx, WxD, Wy, WDy, Wz, WDz, gv0, gv1, gv2, g):
    """Cotangents of the six weights and of gv0, gv1, gv2 of ``g2p_plain``
    for the cotangent g (12, N) of its rows (``jax.vjp`` of
    ``pallas_fused._g2p_ref``, its pad rows given zero cotangent)."""
    return _vjp(g2p_plain, (Wx, WxD, Wy, WDy, Wz, WDz, gv0, gv1, gv2), g)


def splat_vjp_plain(Wx, Wy, Wz, vals, dout):
    """Cotangents (dWx, dWy, dWz, dvals) of ``splat_plain`` for the window
    cotangent dout (wy*wz, 3*wx) (``jax.vjp`` of
    ``pallas_fused._splat_ref``)."""
    return _vjp(splat_plain, (Wx, Wy, Wz, vals), dout)


def gather_vjp_plain(Wx, Wy, Wz, gv0, gv1, gv2, dv):
    """Cotangents (dWx, dWy, dWz, dgv0, dgv1, dgv2) of ``gather_plain`` for
    the cotangent dv (3, N) (``jax.vjp`` of ``pallas_fused._gather_ref``)."""
    return _vjp(gather_plain, (Wx, Wy, Wz, gv0, gv1, gv2), dv)


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _check(name, weights, others, window):
    """Float32 contiguous CUDA tensors; the weights (w_d, N) for the window
    (wx, wy, wz), one N for all."""
    for t in weights + others:
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise TypeError(f"{name}: CUDA kernel takes float32 CUDA tensors, "
                            f"got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    n = weights[0].shape[1]
    if any(w.dim() != 2 or w.shape[1] != n for w in weights) or \
            [w.shape[0] for w in weights] != list(window):
        raise ValueError(f"{name}: weights "
                         f"{[tuple(w.shape) for w in weights]}, window "
                         f"{tuple(window)}")
    return n


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _p2g(Wx, WxD, Wy, WDy, Wz, WDz, chan):
    """P2G over dense weights; see ``p2g_plain``. CUDA tensors launch the
    kernel (float64 accumulation into a zeroed window, rounded once by a
    second launch)."""
    if build.on_cpu(Wx, "fused p2g"):
        return p2g_plain(Wx, WxD, Wy, WDy, Wz, WDz, chan)
    wx, wy, wz = Wx.shape[0], Wy.shape[0], Wz.shape[0]
    n = _check("fused p2g", (Wx, Wy, Wz), (WxD, WDy, WDz, chan), (wx, wy, wz))
    if (WxD.shape, WDy.shape, WDz.shape, chan.shape) != (
            Wx.shape, Wy.shape, Wz.shape, (13, n)):
        raise ValueError("fused p2g: derivative weights or chan mis-shaped")
    cells = wx * wy * wz
    acc = torch.zeros(4 * cells, dtype=torch.float64, device=Wx.device)
    out = torch.empty(4 * cells, dtype=Wx.dtype, device=Wx.device)
    rc = build.library().softmac_fused_p2g(
        Wx.data_ptr(), WxD.data_ptr(), Wy.data_ptr(), WDy.data_ptr(),
        Wz.data_ptr(), WDz.data_ptr(), chan.data_ptr(), acc.data_ptr(),
        out.data_ptr(), n, wx, wy, wz, _stream(Wx))
    build.check(rc, "fused p2g")
    p2g.launches += 1
    return out[:cells].view(wy * wz, wx), out[cells:].view(wy * wz, 3 * wx)


def _check_grids(name, grids, wx, wy, wz):
    if any(g.shape != (wy * wz, wx) for g in grids):
        raise ValueError(f"{name}: grids {[tuple(g.shape) for g in grids]}")


def _g2p(Wx, WxD, Wy, WDy, Wz, WDz, gv0, gv1, gv2):
    """G2P over dense weights; see ``g2p_plain``. CUDA tensors launch the
    kernel."""
    if build.on_cpu(Wx, "fused g2p"):
        return g2p_plain(Wx, WxD, Wy, WDy, Wz, WDz, gv0, gv1, gv2)
    wx, wy, wz = Wx.shape[0], Wy.shape[0], Wz.shape[0]
    n = _check("fused g2p", (Wx, Wy, Wz), (WxD, WDy, WDz, gv0, gv1, gv2),
               (wx, wy, wz))
    if (WxD.shape, WDy.shape, WDz.shape) != (Wx.shape, Wy.shape, Wz.shape):
        raise ValueError("fused g2p: derivative weights mis-shaped")
    _check_grids("fused g2p", (gv0, gv1, gv2), wx, wy, wz)
    out = torch.empty((12, n), dtype=Wx.dtype, device=Wx.device)
    rc = build.library().softmac_fused_g2p(
        Wx.data_ptr(), WxD.data_ptr(), Wy.data_ptr(), WDy.data_ptr(),
        Wz.data_ptr(), WDz.data_ptr(), gv0.data_ptr(), gv1.data_ptr(),
        gv2.data_ptr(), out.data_ptr(), n, wx, wy, wz, _stream(Wx))
    build.check(rc, "fused g2p")
    g2p.launches += 1
    return out


def _splat(Wx, Wy, Wz, vals):
    """Splat of vals (3, N) over dense weights; see ``splat_plain``. CUDA
    tensors launch the kernel (float64 accumulation, rounded once)."""
    if build.on_cpu(Wx, "fused splat"):
        return splat_plain(Wx, Wy, Wz, vals)
    wx, wy, wz = Wx.shape[0], Wy.shape[0], Wz.shape[0]
    n = _check("fused splat", (Wx, Wy, Wz), (vals,), (wx, wy, wz))
    if vals.shape != (3, n):
        raise ValueError(f"fused splat: vals {tuple(vals.shape)}")
    cells = wx * wy * wz
    acc = torch.zeros(3 * cells, dtype=torch.float64, device=Wx.device)
    out = torch.empty((wy * wz, 3 * wx), dtype=Wx.dtype, device=Wx.device)
    rc = build.library().softmac_fused_splat(
        Wx.data_ptr(), Wy.data_ptr(), Wz.data_ptr(), vals.data_ptr(),
        acc.data_ptr(), out.data_ptr(), n, wx, wy, wz, _stream(Wx))
    build.check(rc, "fused splat")
    splat.launches += 1
    return out


def _gather(Wx, Wy, Wz, gv0, gv1, gv2):
    """Gather of the grids at the particles over dense weights; see
    ``gather_plain``. CUDA tensors launch the kernel."""
    if build.on_cpu(Wx, "fused gather"):
        return gather_plain(Wx, Wy, Wz, gv0, gv1, gv2)
    wx, wy, wz = Wx.shape[0], Wy.shape[0], Wz.shape[0]
    n = _check("fused gather", (Wx, Wy, Wz), (gv0, gv1, gv2), (wx, wy, wz))
    _check_grids("fused gather", (gv0, gv1, gv2), wx, wy, wz)
    out = torch.empty((3, n), dtype=Wx.dtype, device=Wx.device)
    rc = build.library().softmac_fused_gather(
        Wx.data_ptr(), Wy.data_ptr(), Wz.data_ptr(), gv0.data_ptr(),
        gv1.data_ptr(), gv2.data_ptr(), out.data_ptr(), n, wx, wy, wz,
        _stream(Wx))
    build.check(rc, "fused gather")
    gather.launches += 1
    return out


def p2g_bwd(Wx, WxD, Wy, WDy, Wz, WDz, chan, dgm, dgmom):
    """The P2G backward: (dWx, dWxD, dWy, dWDy, dWz, dWDz, dchan) as
    ``p2g_vjp_plain`` computes them. CUDA tensors launch the kernel (a
    gather over the window cotangents: no atomics; two launches, the first
    writing the cotangents' other layouts into a scratch buffer)."""
    if build.on_cpu(Wx, "fused p2g_bwd"):
        return p2g_vjp_plain(Wx, WxD, Wy, WDy, Wz, WDz, chan, dgm, dgmom)
    wx, wy, wz = Wx.shape[0], Wy.shape[0], Wz.shape[0]
    n = _check("fused p2g_bwd", (Wx, Wy, Wz),
               (WxD, WDy, WDz, chan, dgm, dgmom), (wx, wy, wz))
    if (WxD.shape, WDy.shape, WDz.shape, chan.shape, dgm.shape,
            dgmom.shape) != (Wx.shape, Wy.shape, Wz.shape, (13, n),
                             (wy * wz, wx), (wy * wz, 3 * wx)):
        raise ValueError("fused p2g_bwd: derivative weights, chan or "
                         "cotangents mis-shaped")
    rows = (wx, wx, wy, wy, wz, wz, 13)
    out = torch.empty((sum(rows), n), dtype=Wx.dtype, device=Wx.device)
    scratch = torch.empty(8 * wx * wy * wz, dtype=Wx.dtype, device=Wx.device)
    rc = build.library().softmac_fused_p2g_bwd(
        Wx.data_ptr(), WxD.data_ptr(), Wy.data_ptr(), WDy.data_ptr(),
        Wz.data_ptr(), WDz.data_ptr(), chan.data_ptr(), dgm.data_ptr(),
        dgmom.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, wx, wy, wz,
        _stream(Wx))
    build.check(rc, "fused p2g_bwd")
    p2g_bwd.launches += 1
    return torch.split(out, rows)


def g2p_bwd(Wx, WxD, Wy, WDy, Wz, WDz, gv0, gv1, gv2, g):
    """The G2P backward: the six weight cotangents and dgv0, dgv1, dgv2 as
    ``g2p_vjp_plain`` computes them. CUDA tensors launch the kernel (the
    grid cotangents summed in float64 and rounded once; three launches,
    the first zeroing the float64 window and writing the grids' other
    layouts into a scratch buffer)."""
    if build.on_cpu(Wx, "fused g2p_bwd"):
        return g2p_vjp_plain(Wx, WxD, Wy, WDy, Wz, WDz, gv0, gv1, gv2, g)
    wx, wy, wz = Wx.shape[0], Wy.shape[0], Wz.shape[0]
    n = _check("fused g2p_bwd", (Wx, Wy, Wz),
               (WxD, WDy, WDz, gv0, gv1, gv2, g), (wx, wy, wz))
    if (WxD.shape, WDy.shape, WDz.shape, g.shape) != (
            Wx.shape, Wy.shape, Wz.shape, (12, n)):
        raise ValueError("fused g2p_bwd: derivative weights or cotangent "
                         "mis-shaped")
    _check_grids("fused g2p_bwd", (gv0, gv1, gv2), wx, wy, wz)
    rows = (wx, wx, wy, wy, wz, wz)
    cells = wx * wy * wz
    out = torch.empty((sum(rows), n), dtype=Wx.dtype, device=Wx.device)
    acc = torch.empty(3 * cells, dtype=torch.float64, device=Wx.device)
    gout = torch.empty((3, wy * wz, wx), dtype=Wx.dtype, device=Wx.device)
    scratch = torch.empty(6 * cells, dtype=Wx.dtype, device=Wx.device)
    rc = build.library().softmac_fused_g2p_bwd(
        Wx.data_ptr(), WxD.data_ptr(), Wy.data_ptr(), WDy.data_ptr(),
        Wz.data_ptr(), WDz.data_ptr(), gv0.data_ptr(), gv1.data_ptr(),
        gv2.data_ptr(), g.data_ptr(), out.data_ptr(), acc.data_ptr(),
        gout.data_ptr(), scratch.data_ptr(), n, wx, wy, wz, _stream(Wx))
    build.check(rc, "fused g2p_bwd")
    g2p_bwd.launches += 1
    return torch.split(out, rows) + tuple(gout)


def splat_bwd(Wx, Wy, Wz, vals, dout):
    """The splat backward: (dWx, dWy, dWz, dvals) as ``splat_vjp_plain``
    computes them. CUDA tensors launch the kernel (a gather over the window
    cotangent: no atomics; two launches, the first writing the
    cotangent's other layouts into a scratch buffer)."""
    if build.on_cpu(Wx, "fused splat_bwd"):
        return splat_vjp_plain(Wx, Wy, Wz, vals, dout)
    wx, wy, wz = Wx.shape[0], Wy.shape[0], Wz.shape[0]
    n = _check("fused splat_bwd", (Wx, Wy, Wz), (vals, dout), (wx, wy, wz))
    if vals.shape != (3, n) or dout.shape != (wy * wz, 3 * wx):
        raise ValueError(f"fused splat_bwd: vals {tuple(vals.shape)}, "
                         f"cotangent {tuple(dout.shape)}")
    rows = (wx, wy, wz, 3)
    out = torch.empty((sum(rows), n), dtype=Wx.dtype, device=Wx.device)
    scratch = torch.empty(6 * wx * wy * wz, dtype=Wx.dtype, device=Wx.device)
    rc = build.library().softmac_fused_splat_bwd(
        Wx.data_ptr(), Wy.data_ptr(), Wz.data_ptr(), vals.data_ptr(),
        dout.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, wx, wy, wz,
        _stream(Wx))
    build.check(rc, "fused splat_bwd")
    splat_bwd.launches += 1
    return torch.split(out, rows)


def gather_bwd(Wx, Wy, Wz, gv0, gv1, gv2, dv):
    """The gather backward: (dWx, dWy, dWz, dgv0, dgv1, dgv2) as
    ``gather_vjp_plain`` computes them. CUDA tensors launch the kernel (the
    grid cotangents summed in float64 and rounded once; three launches,
    the first zeroing the float64 window and writing the grids' other
    layouts into a scratch buffer)."""
    if build.on_cpu(Wx, "fused gather_bwd"):
        return gather_vjp_plain(Wx, Wy, Wz, gv0, gv1, gv2, dv)
    wx, wy, wz = Wx.shape[0], Wy.shape[0], Wz.shape[0]
    n = _check("fused gather_bwd", (Wx, Wy, Wz), (gv0, gv1, gv2, dv),
               (wx, wy, wz))
    if dv.shape != (3, n):
        raise ValueError(f"fused gather_bwd: cotangent {tuple(dv.shape)}")
    _check_grids("fused gather_bwd", (gv0, gv1, gv2), wx, wy, wz)
    rows = (wx, wy, wz)
    cells = wx * wy * wz
    out = torch.empty((sum(rows), n), dtype=Wx.dtype, device=Wx.device)
    acc = torch.empty(3 * cells, dtype=torch.float64, device=Wx.device)
    gout = torch.empty((3, wy * wz, wx), dtype=Wx.dtype, device=Wx.device)
    scratch = torch.empty(6 * cells, dtype=Wx.dtype, device=Wx.device)
    rc = build.library().softmac_fused_gather_bwd(
        Wx.data_ptr(), Wy.data_ptr(), Wz.data_ptr(), gv0.data_ptr(),
        gv1.data_ptr(), gv2.data_ptr(), dv.data_ptr(), out.data_ptr(),
        acc.data_ptr(), gout.data_ptr(), scratch.data_ptr(), n, wx, wy, wz,
        _stream(Wx))
    build.check(rc, "fused gather_bwd")
    gather_bwd.launches += 1
    return torch.split(out, rows) + tuple(gout)


def _backward(ctx, bwd, *cts):
    """The cotangents of a Function's saved inputs through its backward
    wrapper; None where no input needs one."""
    grads = bwd(*ctx.saved_tensors, *(c.contiguous() for c in cts))
    return tuple(g if need else None
                 for g, need in zip(grads, ctx.needs_input_grad))


class FusedP2G(torch.autograd.Function):
    """P2G with its backward kernel (``pallas_fused.p2g``'s custom_vjp)."""

    @staticmethod
    def forward(ctx, *ins):
        ctx.save_for_backward(*ins)
        return _p2g(*ins)

    @staticmethod
    def backward(ctx, dgm, dgmom):
        return _backward(ctx, p2g_bwd, dgm, dgmom)


class FusedG2P(torch.autograd.Function):
    """G2P with its backward kernel (``pallas_fused.g2p``'s custom_vjp)."""

    @staticmethod
    def forward(ctx, *ins):
        ctx.save_for_backward(*ins)
        return _g2p(*ins)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, g2p_bwd, g)


class FusedSplat(torch.autograd.Function):
    """Splat with its backward kernel (``pallas_fused.splat``'s
    custom_vjp)."""

    @staticmethod
    def forward(ctx, *ins):
        ctx.save_for_backward(*ins)
        return _splat(*ins)

    @staticmethod
    def backward(ctx, dout):
        return _backward(ctx, splat_bwd, dout)


class FusedGather(torch.autograd.Function):
    """Gather with its backward kernel (``pallas_fused.gather``'s
    custom_vjp)."""

    @staticmethod
    def forward(ctx, *ins):
        ctx.save_for_backward(*ins)
        return _gather(*ins)

    @staticmethod
    def backward(ctx, dv):
        return _backward(ctx, gather_bwd, dv)


def p2g(Wx, WxD, Wy, WDy, Wz, WDz, chan):
    """P2G over dense weights, (gm (wy*wz, wx), gmom (wy*wz, 3*wx)); see
    ``p2g_plain``. CUDA tensors launch the kernel; under autograd the
    backward launches ``p2g_bwd``."""
    ins = (Wx, WxD, Wy, WDy, Wz, WDz, chan)
    return FusedP2G.apply(*ins) if _needs_grad(*ins) else _p2g(*ins)


def g2p(Wx, WxD, Wy, WDy, Wz, WDz, gv0, gv1, gv2):
    """G2P over dense weights, (12, N); see ``g2p_plain``. CUDA tensors
    launch the kernel; under autograd the backward launches ``g2p_bwd``."""
    ins = (Wx, WxD, Wy, WDy, Wz, WDz, gv0, gv1, gv2)
    return FusedG2P.apply(*ins) if _needs_grad(*ins) else _g2p(*ins)


def splat(Wx, Wy, Wz, vals):
    """Splat of vals (3, N) over dense weights, (wy*wz, 3*wx); see
    ``splat_plain``. CUDA tensors launch the kernel; under autograd the
    backward launches ``splat_bwd``."""
    ins = (Wx, Wy, Wz, vals)
    return FusedSplat.apply(*ins) if _needs_grad(*ins) else _splat(*ins)


def gather(Wx, Wy, Wz, gv0, gv1, gv2):
    """Gather of the grids at the particles over dense weights, (3, N); see
    ``gather_plain``. CUDA tensors launch the kernel; under autograd the
    backward launches ``gather_bwd``."""
    ins = (Wx, Wy, Wz, gv0, gv1, gv2)
    return FusedGather.apply(*ins) if _needs_grad(*ins) else _gather(*ins)


p2g.launches = 0
g2p.launches = 0
splat.launches = 0
gather.launches = 0
p2g_bwd.launches = 0
g2p_bwd.launches = 0
splat_bwd.launches = 0
gather_bwd.launches = 0
