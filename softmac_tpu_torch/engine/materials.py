"""Constitutive models in struct-of-arrays form (mat/vec tuples of (N,)
tensors, see ``ops/m33.py``).

Counterpart of ``softmac_tpu/engine/materials.py`` (reference
``mpm_simulator.py:219-248``): fixed-corotated and neo-Hookean models
crossed with plastic / elastic / liquid particle types. The corotated
plastic and elastic models take the 3x3 SVD of ``engine/svd3.py``.
"""
from __future__ import annotations

import torch

from softmac_tpu_torch.engine.svd3 import svd3_soa
from softmac_tpu_torch.engine.types import (
    MAT_ELASTIC,
    MAT_LIQUID,
    MAT_PLASTIC,
    MODEL_COROTATED,
    MODEL_NEOHOOKEAN,
    MPMConfig,
)
from softmac_tpu_torch.ops import m33


def needs_svd(cfg: MPMConfig) -> bool:
    # corotated liquid has mu = 0, killing the only R-dependent stress term
    return cfg.material_model == MODEL_COROTATED and cfg.ptype != MAT_LIQUID


def von_mises_return_map(F, U, sig, V, yield_stress, mu):
    """Von Mises plastic return mapping (reference compute_von_mises,
    ``mpm_simulator.py:167-182``). sig: vec tuple of (N,) singular values."""
    sig_c = tuple(torch.clamp(s, min=0.05) for s in sig)  # NaN guard (:169)
    eps_v = tuple(torch.log(s) for s in sig_c)
    mean = (eps_v[0] + eps_v[1] + eps_v[2]) / 3.0
    eps_hat = tuple(e - mean for e in eps_v)
    ehn = torch.sqrt(m33.dot(eps_hat, eps_hat) + 1e-8)
    delta_gamma = ehn - yield_stress / (2.0 * mu)

    yields = delta_gamma > 0
    scale = delta_gamma / ehn
    eps_proj = tuple(e - scale * h for e, h in zip(eps_v, eps_hat))
    sig_new = tuple(torch.exp(e) for e in eps_proj)
    F_proj = m33.mmul(U, m33.mmul(m33.diag_mat(sig_new), m33.mt(V)))
    return m33.mwhere(yields, F_proj, F)


def compute_stress_and_F(cfg: MPMConfig, F_tmp, mu, lam, yield_stress=None):
    """Returns (stress mat-tuple before the -dt*p_vol*4*inv_dx^2 scale, new_F).

    The corotated plastic and elastic models take the SVD of F_tmp
    (``svd3_soa``); the plastic one either clamps the singular values into
    [1-2e-3, 1+3e-3] (``plastic_mode`` "clip", the reference's runtime path)
    or projects them with the von Mises return map."""
    J = m33.det(F_tmp)
    if cfg.material_model == MODEL_COROTATED:
        if cfg.ptype == MAT_LIQUID:
            # liquid has mu = 0 (lame_parameters, mpm_simulator.py:45), so
            # the corotated 2*mu*(F-R)F^T term vanishes identically and no
            # SVD/R is needed
            cb = torch.sign(J) * torch.abs(J) ** (1.0 / 3.0)  # sign-safe cbrt
            zero = torch.zeros_like(cb)
            new_F = ((cb, zero, zero), (zero, cb, zero), (zero, zero, cb))
            return m33.madd_diag(m33.mscale(new_F, 0.0),
                                 lam * J * (J - 1.0)), new_F
        U, sig, V = svd3_soa(F_tmp)
        if cfg.ptype == MAT_PLASTIC:
            if cfg.plastic_mode == "von_mises":
                new_F = von_mises_return_map(F_tmp, U, sig, V, yield_stress,
                                             mu)
            else:
                sig_new = tuple(torch.clamp(s, 1.0 - 2e-3, 1.0 + 3e-3)
                                for s in sig)
                new_F = m33.mmul(U, m33.mmul(m33.diag_mat(sig_new),
                                             m33.mt(V)))
        elif cfg.ptype == MAT_ELASTIC:
            new_F = F_tmp
        else:
            raise ValueError(cfg.ptype)
        R = m33.mmul(U, m33.mt(V))
        elastic = m33.mscale(
            m33.mmul(m33.msub(new_F, R), m33.mt(new_F)), 2.0 * mu)
        return m33.madd_diag(elastic, lam * J * (J - 1.0)), new_F
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
