"""Rigid-primitive contact models (``softmac_tpu/engine/contact.py``).

The three models of the reference: grid contact (``collide_grid``,
``primitive_base.py:72-103``), the penalty particle model
(``collide_particle``, :105-137) and the forecast mixed model
(``collide_mixed``, :139-181). The per-particle part of the last two comes
from ``ops.contact`` (CUDA kernels on the card, plain PyTorch on the CPU);
grid contact is plain PyTorch on both devices, as the JAX package leaves it
to XLA. The 6-DoF wrench on the body (force, torque about the body
origin) is, for grid contact, a masked sum here
(``ops.contact.wrench_plain``). For particle and mixed contact
``ops.contact``'s ``collide_particle`` and ``collide_mixed`` return it:
summed on the card by the tiled kernels, by
``collide_particle_wrench_plain`` and ``collide_mixed_wrench_plain`` on
the CPU, and for mixed contact by ``wrench_plain`` over the split kernels'
forces under ``SOFTMAC_TPU_CONTACT_SPLIT``. The SDF sample,
``collider_velocity`` and the contact threshold live beside the kernels in
``ops.contact``.
"""
from __future__ import annotations

import torch

from softmac_tpu_torch.ops import contact as contact_ops
from softmac_tpu_torch.ops import m33


def collide_particle(prim, body_pos, body_quat, body_v, body_w, friction,
                     x, p_v, dt, p_mass):
    """Penalty particle contact (CONTACT_PARTICLE). x, p_v (3, N). Returns
    (impulse (3, N), wrench (6,)).

    The friction impulse is Coulomb-clamped so it can stop relative sliding
    but never reverse it (see the JAX package's docstring)."""
    return contact_ops.collide_particle(
        prim, body_pos, body_quat, body_v, body_w, friction, x, p_v, dt,
        p_mass)


def _length(v, eps=1e-8):
    return torch.sqrt(m33.dot(v, v) + eps)


def collide_grid(prim, body_pos, body_quat, body_v, body_w, friction,
                 softness, grid_pos, v_out, dt, grid_m):
    """Grid-level contact (CONTACT_GRID). grid_pos, v_out: 3-tuples of node
    tensors of one shape, grid_m the nodes' mass. Returns (v_out' 3-tuple,
    wrench (6,)). The AD-safe forms of the JAX package: exp(-max(d, 0) s)
    (exp of a negative distance would overflow and its vjp give NaN), the
    eps'd tangent length and the friction branch under ``where``."""
    bp = tuple(body_pos[d] for d in range(3))
    bq = tuple(body_quat[d] for d in range(4))
    bv = tuple(body_v[d] for d in range(3))
    bw = tuple(body_w[d] for d in range(3))
    dist, D = contact_ops.sample_sdf_normal_world(prim, bp, bq, grid_pos)
    influence = torch.exp(-torch.clamp(dist, min=0.0) * softness)
    mask = ((softness > 0) & (influence > 0.1)) | (dist <= 0.0)

    v_in = v_out
    r = m33.vsub(grid_pos, bp)
    cv = contact_ops.collider_velocity(bq, bv, bw, r)
    input_v = m33.vsub(v_out, cv)
    nc = m33.dot(input_v, D)

    v_t = m33.vsub(input_v, m33.vscale(D, torch.clamp(nc, max=0.0)))
    vt_norm = _length(v_t)
    v_t_fric = m33.vscale(
        v_t, torch.clamp(vt_norm + nc * friction, min=0.0) / vt_norm)
    flag = (nc < 0) & (m33.dot(v_t, v_t) > 1e-60)
    v_t = m33.vwhere(flag, v_t_fric, v_t)

    v_new = m33.vadd(cv, m33.vadd(m33.vscale(input_v, 1.0 - influence),
                                  m33.vscale(v_t, influence)))
    v_out = m33.vwhere(mask, v_new, v_in)
    b_f = m33.vscale(m33.vsub(v_in, v_out), grid_m / dt)
    return v_out, contact_ops.wrench_plain(b_f, r, mask)


def collide_mixed(prim, body_pos, body_quat, body_v, body_w, friction,
                  softness, x, p_v, p_mass, dt, life, push_cap=None):
    """Forecast-based mixed contact (CONTACT_MIXED). x, p_v (3, N); life
    the remaining-window factor 1 / (substeps - k); ``push_cap`` bounds the
    penetration push-out speed (None / inf: the reference's uncapped
    (sdf / dt) * life). Returns (p_v' (3, N), wrench (6,))."""
    return contact_ops.collide_mixed(
        prim, body_pos, body_quat, body_v, body_w, friction, softness, life,
        x, p_v, dt, p_mass, push_cap)
