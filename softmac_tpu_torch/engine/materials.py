"""Constitutive models in struct-of-arrays form (mat/vec tuples of (N,)
tensors, see ``ops/m33.py``).

Counterpart of ``softmac_tpu/engine/materials.py`` (reference
``mpm_simulator.py:219-248``) for the models that need no SVD, the pour
scene's corotated liquid among them.
"""
from __future__ import annotations

import torch

from softmac_tpu_torch.engine.types import (
    MAT_ELASTIC,
    MAT_LIQUID,
    MODEL_COROTATED,
    MODEL_NEOHOOKEAN,
    MPMConfig,
)
from softmac_tpu_torch.ops import m33


def needs_svd(cfg: MPMConfig) -> bool:
    # corotated liquid has mu = 0, killing the only R-dependent stress term
    return cfg.material_model == MODEL_COROTATED and cfg.ptype != MAT_LIQUID


def compute_stress_and_F(cfg: MPMConfig, F_tmp, mu, lam):
    """Returns (stress mat-tuple before the -dt*p_vol*4*inv_dx^2 scale, new_F)
    for the models that need no SVD: corotated liquid and neo-Hookean
    elastic / liquid. The corotated plastic and elastic models need the 3x3
    SVD, which comes with a later slice of the port."""
    if needs_svd(cfg):
        raise NotImplementedError(
            f"material_model {cfg.material_model} with ptype {cfg.ptype} "
            "needs the 3x3 SVD, which is not ported yet (corotated liquid "
            "and neo-Hookean run)")
    J = m33.det(F_tmp)
    if cfg.material_model == MODEL_COROTATED:
        # liquid has mu = 0 (lame_parameters, mpm_simulator.py:45), so the
        # corotated 2*mu*(F-R)F^T term vanishes identically and no SVD/R is
        # needed
        cb = torch.sign(J) * torch.abs(J) ** (1.0 / 3.0)  # sign-safe cbrt
        zero = torch.zeros_like(cb)
        new_F = ((cb, zero, zero), (zero, cb, zero), (zero, zero, cb))
        return m33.madd_diag(m33.mscale(new_F, 0.0),
                             lam * J * (J - 1.0)), new_F
    if cfg.material_model == MODEL_NEOHOOKEAN:
        if cfg.ptype == MAT_ELASTIC:
            new_F = F_tmp
        elif cfg.ptype == MAT_LIQUID:
            sq = torch.sqrt(J)
            zero = torch.zeros_like(sq)
            one = torch.ones_like(sq)
            new_F = ((sq, zero, zero), (zero, sq, zero), (zero, zero, one))
        else:
            raise ValueError(
                f"neo-hookean supports elastic/liquid, got ptype={cfg.ptype}")
        stress = m33.madd_diag(
            m33.mscale(m33.mmul(new_F, m33.mt(new_F)), mu),
            lam * torch.log(J) - mu)
        return stress, new_F
    raise ValueError(cfg.material_model)


def lame_parameters(E: float, nu: float, ptype: int):
    """Lame parameters with the reference's per-type softening
    (mpm_simulator.py:41-45)."""
    mu = E / (2.0 * (1.0 + nu))
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    if ptype == MAT_ELASTIC:
        mu, lam = 0.3 * mu, 0.3 * lam
    elif ptype == MAT_LIQUID:
        mu = 0.0
    return mu, lam
