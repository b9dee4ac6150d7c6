"""Rigid-primitive contact models (``softmac_tpu/engine/contact.py``).

The penalty particle model (``collide_particle``, reference
``primitive_base.py:105-137``) and the forecast mixed model
(``collide_mixed``, ``primitive_base.py:139-181``) are ported: the
per-particle part comes from ``ops.contact`` (CUDA kernels on the card,
plain PyTorch on the CPU) and the 6-DoF wrench on the body (force, torque
about the body origin) is a masked sum here. ``collider_velocity`` and the
contact threshold live beside the kernels in ``ops.contact``. The grid
model comes with a later slice.
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


def collide_mixed(prim, body_pos, body_quat, body_v, body_w, friction,
                  softness, x, p_v, p_mass, dt, life, push_cap=None):
    """Forecast-based mixed contact (CONTACT_MIXED). x, p_v (3, N); life
    the remaining-window factor 1 / (substeps - k); ``push_cap`` bounds the
    penetration push-out speed (None / inf: the reference's uncapped
    (sdf / dt) * life). Returns (p_v' (3, N), wrench (6,))."""
    p_v_out, force, mask = contact_ops.collide_mixed(
        prim, body_pos, body_quat, body_v, body_w, friction, softness, life,
        x, p_v, dt, p_mass, push_cap)
    r = m33.vsub((x[0], x[1], x[2]), (body_pos[0], body_pos[1], body_pos[2]))
    return p_v_out, _wrench((force[0], force[1], force[2]), r, mask)
