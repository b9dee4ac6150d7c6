"""Struct-of-arrays 3-vector / 3x3-matrix / quaternion math on tensors.

Counterpart of ``softmac_tpu/ops/m33.py``: a "vec" is a tuple ``(a0, a1, a2)``
and a "mat" a tuple of row tuples, each entry an (N,) tensor (or anything
that broadcasts with one, python scalars included). Every op is elementwise,
so the plain PyTorch code of contact and materials reads like the per-particle
math of the CUDA kernels.
"""
from __future__ import annotations

import torch


def from_mat_array(m):
    """(3, 3, N) tensor -> mat tuple."""
    return tuple(tuple(m[i, j] for j in range(3)) for i in range(3))


def to_mat_array(m):
    flat = torch.broadcast_tensors(*[m[i][j] for i in range(3) for j in range(3)])
    return torch.stack(flat).reshape((3, 3) + tuple(flat[0].shape))


# ---------------------------------------------------------------- vector ops
def vadd(a, b):
    return tuple(x + y for x, y in zip(a, b))


def vsub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def vscale(a, s):
    return tuple(x * s for x in a)


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def norm(a, eps=0.0):
    return torch.sqrt(dot(a, a) + eps)


def vwhere(c, a, b):
    return tuple(torch.where(c, x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------- matrix ops
def mmul(A, B):
    return tuple(
        tuple(
            A[i][0] * B[0][j] + A[i][1] * B[1][j] + A[i][2] * B[2][j]
            for j in range(3)
        )
        for i in range(3)
    )


def mt(A):
    return tuple(tuple(A[j][i] for j in range(3)) for i in range(3))


def madd(A, B):
    return tuple(tuple(A[i][j] + B[i][j] for j in range(3)) for i in range(3))


def msub(A, B):
    return tuple(tuple(A[i][j] - B[i][j] for j in range(3)) for i in range(3))


def mscale(A, s):
    return tuple(tuple(A[i][j] * s for j in range(3)) for i in range(3))


def mwhere(c, A, B):
    return tuple(tuple(torch.where(c, A[i][j], B[i][j]) for j in range(3))
                 for i in range(3))


def col(A, j):
    return (A[0][j], A[1][j], A[2][j])


def from_cols(c0, c1, c2):
    return tuple((c0[i], c1[i], c2[i]) for i in range(3))


def diag_mat(d):
    return ((d[0], 0.0, 0.0), (0.0, d[1], 0.0), (0.0, 0.0, d[2]))


def madd_diag(A, s):
    """A + s * I."""
    return tuple(
        tuple(A[i][j] + (s if i == j else 0.0) for j in range(3)) for i in range(3)
    )


def det(A):
    return (
        A[0][0] * (A[1][1] * A[2][2] - A[1][2] * A[2][1])
        - A[0][1] * (A[1][0] * A[2][2] - A[1][2] * A[2][0])
        + A[0][2] * (A[1][0] * A[2][1] - A[1][1] * A[2][0])
    )


# ---------------------------------------------------------------- quaternion
def qrot(q, v):
    """Rotate vec v by quaternion tuple q=(w,x,y,z) of tensors/scalars."""
    qv = (q[1], q[2], q[3])
    uv = cross(qv, v)
    uuv = cross(qv, uv)
    return tuple(v[i] + 2.0 * (q[0] * uv[i] + uuv[i]) for i in range(3))


def qconj(q):
    return (q[0], -q[1], -q[2], -q[3])


def qnorm(q, eps=1e-12):
    n = torch.sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3] + eps)
    return tuple(x / n for x in q)
