"""Batched differentiable 3x3 SVD in struct-of-arrays form.

Counterpart of ``softmac_tpu/engine/svd3.py``, in plain PyTorch as the JAX
package computes it outside any kernel. Forward: cyclic Jacobi on F^T F
with a fixed 5 sweeps, elementwise on (N,) component tensors (mat and vec
tuples, see ``ops/m33.py``), eigenvalues sorted descending, V turned into
SO(3), U rebuilt from F V by Gram-Schmidt and a cross product, so U, V are
in SO(3) and sigma_2 carries the sign of det(F): the ``ti.svd`` convention
the reference's corotated model relies on
(``softmac/engine/mpm_simulator.py:131-134``). The arithmetic follows the
JAX package's operation for operation (V's columns update as (3, N)
tensors, shared products formed once: the same roundings in fewer
launches).

Backward: the clamped-denominator rule of the reference's ``backward_svd``
(``mpm_simulator.py:140-157``) as a ``torch.autograd.Function``: 1/(s_j^2 -
s_i^2) with the denominator clamped away from zero, so repeated singular
values give a finite gradient. ``torch.linalg.svd`` is no substitute: its U
and V lie in O(3) with non-negative sigma, and its gradient is NaN at
repeated singular values.

- ``svd3_soa(F)``: F a mat tuple of (N,) tensors -> (U mat, sig vec, V mat).
- ``svd3(F)``: F (..., 3, 3) -> (U, sig (..., 3), V) tensors.
"""
from __future__ import annotations

import torch

from softmac_tpu_torch.ops import m33

_JACOBI_SWEEPS = 5


def _jacobi_rotate(S, V, p, q):
    """One batched Jacobi rotation zeroing S[p][q] (S a symmetric mat
    tuple, V a (3, 3, N) tensor). The products c*c, s*s, s*c and 2*s*c are
    formed once and shared by the entries, and V's two columns update as
    (3, N) tensors: the same arithmetic in fewer launches."""
    app, aqq, apq = S[p][p], S[q][q], S[p][q]
    small = torch.abs(apq) < 1e-30
    apq_safe = torch.where(small, 1.0, apq)
    theta = torch.clamp(0.5 * (aqq - app) / apq_safe, -1e15, 1e15)
    t = torch.sign(theta) / (torch.abs(theta) + torch.sqrt(1.0 + theta * theta))
    t = torch.where(theta == 0.0, 1.0, t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c
    c = torch.where(small, 1.0, c)
    s = torch.where(small, 0.0, s)

    # S' = J^T S J and V' = V J, J = I with J[p][p] = J[q][q] = c,
    # J[p][q] = s, J[q][p] = -s
    cc, ss, sc = c * c, s * s, s * c
    tsc_apq = (2.0 * sc) * apq          # 2 s c apq, as ((2 s) c) apq
    S_ = [list(row) for row in S]
    r = 3 - p - q
    Spr, Sqr = S[p][r], S[q][r]
    S_[p][p] = cc * app - tsc_apq + ss * aqq
    S_[q][q] = ss * app + tsc_apq + cc * aqq
    S_[p][q] = S_[q][p] = (cc - ss) * apq + sc * (app - aqq)
    S_[p][r] = S_[r][p] = c * Spr - s * Sqr
    S_[q][r] = S_[r][q] = s * Spr + c * Sqr

    vp, vq = V[:, p], V[:, q]
    cols = [None] * 3
    cols[p], cols[q], cols[r] = c * vp - s * vq, s * vp + c * vq, V[:, r]
    return tuple(tuple(row) for row in S_), torch.stack(cols, dim=1)


def _sort_desc(w, V):
    """Eigenvalues sorted descending, V's columns (of the (3, 3, N) V)
    permuted with them."""
    w = list(w)
    cols = [tuple(V[:, j]) for j in range(3)]

    def cswap(i, j):
        swap = w[i] < w[j]
        w[i], w[j] = (torch.where(swap, w[j], w[i]),
                      torch.where(swap, w[i], w[j]))
        ci, cj = cols[i], cols[j]
        cols[i] = m33.vwhere(swap, cj, ci)
        cols[j] = m33.vwhere(swap, ci, cj)

    cswap(0, 1)
    cswap(0, 2)
    cswap(1, 2)
    return tuple(w), m33.from_cols(*cols)


def _svd3_forward(F):
    S = m33.mmul(m33.mt(F), F)
    f00 = F[0][0]
    V = torch.eye(3, dtype=f00.dtype, device=f00.device).reshape(
        (3, 3) + (1,) * f00.dim()).expand((3, 3) + tuple(f00.shape))
    for _ in range(_JACOBI_SWEEPS):
        for (p, q) in ((0, 1), (0, 2), (1, 2)):
            S, V = _jacobi_rotate(S, V, p, q)
    w, V = _sort_desc((S[0][0], S[1][1], S[2][2]), V)

    # V in SO(3)
    sgn = torch.sign(m33.det(V))
    V = m33.from_cols(m33.col(V, 0), m33.col(V, 1),
                      m33.vscale(m33.col(V, 2), sgn))

    B = m33.mmul(F, V)  # columns: sigma_i * u_i
    eps = 1e-10
    b0 = m33.col(B, 0)
    n0 = m33.norm(b0)
    e0 = (torch.ones_like(n0), torch.zeros_like(n0), torch.zeros_like(n0))
    u0 = m33.vwhere(n0 > eps, m33.vscale(b0, 1.0 / torch.clamp(n0, min=eps)),
                    e0)

    b1 = m33.col(B, 1)
    u1 = m33.vsub(b1, m33.vscale(u0, m33.dot(b1, u0)))
    n1 = m33.norm(u1)
    # fallback: a unit vector orthogonal to u0
    ez = (torch.zeros_like(n1), torch.zeros_like(n1), torch.ones_like(n1))
    ey = (torch.zeros_like(n1), torch.ones_like(n1), torch.zeros_like(n1))
    alt = m33.cross(u0, ez)
    alt = m33.vwhere(m33.norm(alt) > 0.1, alt, m33.cross(u0, ey))
    alt = m33.vscale(alt, 1.0 / m33.norm(alt, 1e-30))
    u1 = m33.vwhere(n1 > eps, m33.vscale(u1, 1.0 / torch.clamp(n1, min=eps)),
                    alt)

    u2 = m33.cross(u0, u1)  # right-handed: det(U) = +1
    U = m33.from_cols(u0, u1, u2)
    sig = (m33.dot(u0, b0), m33.dot(u1, b1), m33.dot(u2, m33.col(B, 2)))
    return U, sig, V


def _clamp_away_from_zero(a, eps=1e-6):
    return torch.where(a >= 0, torch.clamp(a, min=eps), torch.clamp(a, max=-eps))


def _svd3_backward(U, sig, V, gu, gsig, gv):
    """dF for the cotangents (gu, gsig, gv) of (U, sig, V)
    (``svd3._svd3_soa_bwd``)."""
    Ut, Vt = m33.mt(U), m33.mt(V)
    sig_mat = m33.diag_mat(sig)
    sigma_term = m33.mmul(U, m33.mmul(m33.diag_mat(gsig), Vt))

    s2 = tuple(s * s for s in sig)
    K = [[0.0 if i == j else 1.0 / _clamp_away_from_zero(s2[j] - s2[i])
          for j in range(3)] for i in range(3)]

    def hadamard(Km, M):
        return tuple(tuple(Km[i][j] * M[i][j] for j in range(3))
                     for i in range(3))

    UtgU = m33.msub(m33.mmul(Ut, gu), m33.mmul(m33.mt(gu), U))
    u_term = m33.mmul(U, m33.mmul(m33.mmul(hadamard(K, UtgU), sig_mat), Vt))
    VtgV = m33.msub(m33.mmul(Vt, gv), m33.mmul(m33.mt(gv), V))
    v_term = m33.mmul(U, m33.mmul(sig_mat, m33.mmul(hadamard(K, VtgV), Vt)))
    return m33.madd(m33.madd(u_term, v_term), sigma_term)


def _mat(flat):
    return tuple(tuple(flat[3 * i + j] for j in range(3)) for i in range(3))


class SVD3(torch.autograd.Function):
    """``svd3_soa`` with the clamped-denominator backward (the JAX package's
    custom_vjp). Inputs: the 9 entries of F, row-major; outputs: the 9 of
    U, the 3 singular values, the 9 of V."""

    @staticmethod
    def forward(ctx, *f):
        U, sig, V = _svd3_forward(_mat(f))
        out = tuple(torch.broadcast_tensors(
            *[e for row in U for e in row], *sig,
            *[e for row in V for e in row]))
        ctx.save_for_backward(*out)
        return out

    @staticmethod
    def backward(ctx, *g):
        o = ctx.saved_tensors
        dF = _svd3_backward(_mat(o[0:9]), o[9:12], _mat(o[12:21]),
                            _mat(g[0:9]), g[9:12], _mat(g[12:21]))
        return tuple(dF[i][j] for i in range(3) for j in range(3))


def svd3_soa(F):
    """Struct-of-arrays 3x3 SVD: mat tuple -> (U mat, sig vec, V mat)."""
    o = SVD3.apply(*[F[i][j] for i in range(3) for j in range(3)])
    return _mat(o[0:9]), tuple(o[9:12]), _mat(o[12:21])


def svd3(F: torch.Tensor):
    """F (..., 3, 3) -> (U (..., 3, 3), sig (..., 3), V (..., 3, 3))."""
    U, sig, V = svd3_soa(tuple(tuple(F[..., i, j] for j in range(3))
                               for i in range(3)))

    def pack(M):
        return torch.stack([torch.stack(row, dim=-1) for row in M], dim=-2)
    return pack(U), torch.stack(sig, dim=-1), pack(V)
