"""Quaternion helpers on batched tensors, ``(w, x, y, z)`` order.

The two functions the velocity-controlled bodies need, with the semantics of
``softmac_tpu/engine/quat.py`` (reference ``primitive_utils.py:8-47``).
"""
from __future__ import annotations

import torch

_EPS = 1e-12


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


def w2quat(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle (rotation vector) to quaternion, safe at zero angle."""
    theta = torch.sqrt(torch.sum(axis_angle * axis_angle, dim=-1, keepdim=True)
                       + _EPS)
    v = (axis_angle / theta) * torch.sin(theta / 2.0)
    w = torch.cos(theta / 2.0)
    return torch.cat([w, v], dim=-1)
