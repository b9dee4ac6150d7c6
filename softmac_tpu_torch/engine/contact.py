"""Rigid-primitive contact models (``softmac_tpu/engine/contact.py``).

The penalty particle model (``collide_particle``, reference
``primitive_base.py:105-137``) is ported: the impulse comes from
``ops.contact`` (CUDA kernel on the card, plain PyTorch on the CPU) and the
6-DoF wrench on the body (force, torque about the body origin) is a masked
sum here. ``collider_velocity`` and the contact threshold live beside the
kernel in ``ops.contact``. The grid and mixed (forecast) models come with
later slices.
"""
from __future__ import annotations

import torch

from softmac_tpu_torch.ops import contact as contact_ops
from softmac_tpu_torch.ops import m33


def _wrench(b_f, r, mask):
    """(6,) force and torque sums of per-particle forces b_f at offsets r."""
    b_f = tuple(torch.where(mask, f, 0.0) for f in b_f)
    b_t = m33.cross(r, b_f)
    return torch.stack(b_f + b_t).sum(dim=1)


def collide_particle(prim, body_pos, body_quat, body_v, body_w, friction,
                     x, p_v, dt, p_mass):
    """Penalty particle contact (CONTACT_PARTICLE). x, p_v (3, N). Returns
    (impulse (3, N), wrench (6,)).

    The friction impulse is Coulomb-clamped so it can stop relative sliding
    but never reverse it (see the JAX package's docstring)."""
    imp, mask = contact_ops.collide_particle(
        prim, body_pos, body_quat, body_v, body_w, friction, x, p_v, dt,
        p_mass)
    b_f = (imp[0] * (-1.0 / dt), imp[1] * (-1.0 / dt), imp[2] * (-1.0 / dt))
    r = m33.vsub((x[0], x[1], x[2]), (body_pos[0], body_pos[1], body_pos[2]))
    return imp, _wrench(b_f, r, mask)


def collide_grid(*args, **kwargs):
    raise NotImplementedError(
        "grid contact (CONTACT_GRID) is not ported yet; it comes with the "
        "slice that ports the scenes using it")


def collide_mixed(*args, **kwargs):
    raise NotImplementedError(
        "mixed contact (CONTACT_MIXED) is not ported yet; it comes with the "
        "flagship-pour slice (gather, splat and mixed12 kernels)")
