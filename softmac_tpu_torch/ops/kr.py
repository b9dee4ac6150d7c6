"""The Khatri-Rao (y, z) pair build of the dense transfer route: a CUDA
kernel and its plain PyTorch version.

Counterpart of ``softmac_tpu/ops/pallas_kr.py`` (``kr3``): from the
per-axis weight matrices of ``mpm.axis_weights``, Wy, WDy (wy, N) and Wz,
WDz (wz, N), the three pair matrices (wy*wz, N) with row y * wz + z

    H = Wy * Wz,   HDy = WDy * Wz,   HDz = Wy * WDz

over which ``engine/mpm.py``'s dense P2G, G2P, gather and splat are
matrix products (the JAX package's ``mpm.hyz_family``).

``kr3`` dispatches through ``build.on_cpu``: on the CPU it runs
``kr3_plain``, on CUDA it launches the kernel (``csrc/kr3.cu``) and counts
the launch, anything else raises. There is no fallback from CUDA to the
plain version. Under autograd (grad enabled and an input that requires
grad) it goes through ``KR3``, the custom_vjp of ``pallas_kr.kr3``: its
forward is the wrapper, its backward ``kr3_vjp_plain`` on both devices,
the four reductions of ``pallas_kr._kr3_bwd``, which the JAX package too
leaves to plain array code (it has no backward kernel).
"""
from __future__ import annotations

import torch

from softmac_tpu_torch.ops import build


def pair(a, b):
    """(wy*wz, N): row y * wz + z = a[y] * b[z]."""
    return (a[:, None, :] * b[None, :, :]).reshape(a.shape[0] * b.shape[0], -1)


def kr3_plain(Wy, Wz, WDy, WDz):
    """Plain PyTorch pair build (``mpm.hyz_family``'s XLA build): (H, HDy,
    HDz), each (wy*wz, N), in the dtype of the inputs."""
    return pair(Wy, Wz), pair(WDy, Wz), pair(Wy, WDz)


def kr3_vjp_plain(Wy, Wz, WDy, WDz, dH, dHDy, dHDz):
    """Cotangents (dWy, dWz, dWDy, dWDz) of ``kr3_plain`` for the pair
    cotangents dH, dHDy, dHDz (wy*wz, N) (``pallas_kr._kr3_bwd``)."""
    wy, n = Wy.shape
    wz = Wz.shape[0]
    dH, dHDy, dHDz = (t.reshape(wy, wz, n) for t in (dH, dHDy, dHDz))
    dWy = (dH * Wz).sum(dim=1) + (dHDz * WDz).sum(dim=1)
    dWz = (dH * Wy[:, None]).sum(dim=0) + (dHDy * WDy[:, None]).sum(dim=0)
    dWDy = (dHDy * Wz).sum(dim=1)
    dWDz = (dHDz * Wy[:, None]).sum(dim=0)
    return dWy, dWz, dWDy, dWDz


def _kr3(Wy, Wz, WDy, WDz):
    """The pair build; see ``kr3_plain``. CUDA tensors launch the kernel."""
    if build.on_cpu(Wy, "kr3"):
        return kr3_plain(Wy, Wz, WDy, WDz)
    for t in (Wy, Wz, WDy, WDz):
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise TypeError("kr3: CUDA kernel takes float32 CUDA tensors, "
                            f"got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError("kr3: tensors must be contiguous")
    wy, n = Wy.shape
    wz = Wz.shape[0]
    if Wz.dim() != 2 or WDy.shape != Wy.shape or WDz.shape != (wz, n):
        raise ValueError(f"kr3: weights {tuple(Wy.shape)}, {tuple(Wz.shape)}"
                         f", {tuple(WDy.shape)}, {tuple(WDz.shape)}")
    H, HDy, HDz = (torch.empty((wy * wz, n), dtype=Wy.dtype,
                               device=Wy.device) for _ in range(3))
    rc = build.library().softmac_kr3(
        Wy.data_ptr(), Wz.data_ptr(), WDy.data_ptr(), WDz.data_ptr(),
        H.data_ptr(), HDy.data_ptr(), HDz.data_ptr(), n, wy, wz,
        torch.cuda.current_stream(Wy.device).cuda_stream)
    build.check(rc, "kr3")
    kr3.launches += 1
    return H, HDy, HDz


class KR3(torch.autograd.Function):
    """The pair build with the plain vjp as its backward (``pallas_kr.kr3``'s
    custom_vjp)."""

    @staticmethod
    def forward(ctx, Wy, Wz, WDy, WDz):
        ctx.save_for_backward(Wy, Wz, WDy, WDz)
        return _kr3(Wy, Wz, WDy, WDz)

    @staticmethod
    def backward(ctx, dH, dHDy, dHDz):
        grads = kr3_vjp_plain(*ctx.saved_tensors, dH, dHDy, dHDz)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def kr3(Wy, Wz, WDy, WDz):
    """(H, HDy, HDz), each (wy*wz, N); see ``kr3_plain``. CUDA tensors
    launch the kernel; under autograd the backward is ``kr3_vjp_plain``."""
    ins = (Wy, Wz, WDy, WDz)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        return KR3.apply(*ins)
    return _kr3(*ins)


kr3.launches = 0
