"""Quaternion helpers on batched tensors, ``(w, x, y, z)`` order.

What the velocity-controlled, floating and revolute rigid bodies need
(``mat2quat`` for a joint frame), with the semantics of
``softmac_tpu/engine/quat.py`` (reference
``primitive_utils.py:8-47`` and the rotation conversions of
``rigid_simulator.py:274-353``). All functions broadcast over leading batch
dimensions; ``rpy2mat`` is host-side NumPy for the URDF joint frames.
"""
from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-12


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion(s) q. q: (..., 4), v: (..., 3);
    the batch dimensions broadcast."""
    qvec, v = torch.broadcast_tensors(q[..., 1:], v)
    uv = torch.cross(qvec, v, dim=-1)
    uuv = torch.cross(qvec, uv, dim=-1)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def qmul(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Hamilton product q*r, renormalized (the reference normalizes to avoid
    drift, ``primitive_utils.py:27``)."""
    w1, x1, y1, z1 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    w2, x2, y2, z2 = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    out = torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )
    return out / torch.sqrt(torch.sum(out * out, dim=-1, keepdim=True))


def qconj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def qnormalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + _EPS)


def w2quat(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle (rotation vector) to quaternion, safe at zero angle."""
    theta = torch.sqrt(torch.sum(axis_angle * axis_angle, dim=-1, keepdim=True)
                       + _EPS)
    v = (axis_angle / theta) * torch.sin(theta / 2.0)
    w = torch.cos(theta / 2.0)
    return torch.cat([w, v], dim=-1)


def quat2w(q: torch.Tensor) -> torch.Tensor:
    """Quaternion to rotation vector (log map). The 1e-24 inside the sqrt
    keeps the value and the gradient finite at the identity, where a
    where-based guard would leak NaN through the untaken branch."""
    q = qnormalize(q)
    sin_half = torch.sqrt(
        torch.sum(q[..., 1:] * q[..., 1:], dim=-1, keepdim=True) + 1e-24)
    half = torch.atan2(sin_half, q[..., :1])
    return q[..., 1:] * (2.0 * half / sin_half)


def quat2mat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion to rotation matrix, (..., 3, 3)."""
    q = qnormalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def mat2quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) to quaternion (Shepperd's method): the
    four candidate solutions, the numerically best picked by ``torch.where``.
    Each candidate's root is clamped away from zero, so an untaken branch
    stays finite and sends no NaN into the gradient."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def root(a):
        return torch.sqrt(torch.clamp(a, min=_EPS))

    qw0 = root(1.0 + tr) / 2.0
    c0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], dim=-1)
    s1 = root(1.0 + m00 - m11 - m22) * 2.0
    c1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                      (m02 + m20) / s1], dim=-1)
    s2 = root(1.0 + m11 - m00 - m22) * 2.0
    c2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                      (m12 + m21) / s2], dim=-1)
    s3 = root(1.0 + m22 - m00 - m11) * 2.0
    c3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                      0.25 * s3], dim=-1)
    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where(cond0, c0, torch.where(cond1, c1,
                                           torch.where(cond2, c2, c3)))
    return qnormalize(q)


def rpy2mat(rpy) -> np.ndarray:
    """URDF roll-pitch-yaw (fixed XYZ) to a rotation matrix (host, float64)."""
    r, p, y = (float(a) for a in rpy)
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
    ry = np.array([[cp, 0, sp], [0, 1.0, 0], [-sp, 0, cp]])
    rx = np.array([[1.0, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return rz @ ry @ rx
