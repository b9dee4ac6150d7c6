"""MLS-MPM core: one substep of the particle-contact scenes.

Counterpart of ``softmac_tpu/engine/mpm.py`` (reference
``softmac/engine/mpm_simulator.py``: compute_F_tmp :126, p2g :199,
grid_op :284, boundary_condition :269, g2p :300). Particles are ``(3, N)``
struct-of-arrays; the grid is the active window in the ``(wy*wz, wx)`` form
of ``grid_coords``. The transfers are the P2G and G2P of ``ops.transfer``
(CUDA kernels on the card, plain PyTorch on the CPU).

The window corner stays a device tensor, so a substep never waits on the
host; ``window_overflow`` comes back as a 0-d bool tensor. A substep is
differentiable end to end under autograd (the transfers and the contact
through their autograd Functions); the corner and the sort permutation are
integer and carry no gradient.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from softmac_tpu_torch.engine import contact as contact_mod
from softmac_tpu_torch.engine.materials import compute_stress_and_F
from softmac_tpu_torch.engine.types import (
    CONTACT_GRID,
    CONTACT_MIXED,
    CONTACT_PARTICLE,
    BodyState,
    MPMConfig,
    MPMParams,
    MPMState,
    SDFParams,
)
from softmac_tpu_torch.ops import m33, transfer


def window_geometry(cfg: MPMConfig, x: torch.Tensor):
    """Active-window sizes and corner for this substep.

    Returns (sizes (3 ints), corner (3,) int32 tensor, overflow 0-d bool
    tensor). With no window configured: full grid, corner 0, no overflow.
    The corner is anchored at the particle centroid, so an ejected outlier
    freezes only itself (and raises the overflow flag) instead of dragging
    the window off the blob."""
    ng = cfg.n_grid
    if not cfg.active_window:
        return ((ng, ng, ng), torch.zeros(3, dtype=torch.int32, device=x.device),
                torch.zeros((), dtype=torch.bool, device=x.device))
    sizes = tuple(int(w) for w in cfg.active_window)
    size_t = torch.tensor(sizes, dtype=torch.int32, device=x.device)
    # integer outputs only: no autograd graph through the corner
    pos = x.detach() * cfg.inv_dx - 0.5
    center = pos.mean(dim=1)
    corner = torch.round(center).to(torch.int32) - size_t // 2
    corner = torch.minimum(torch.clamp(corner, min=0), ng - size_t)
    # stencil rows base..base+2 must lie inside [c, c+size-1] on every axis
    base = torch.floor(pos).to(torch.int32)
    out = ((base < corner[:, None])
           | (base + 2 > (corner + size_t - 1)[:, None]))
    return sizes, corner, out.any()


def sort_perm(cfg: MPMConfig, x: torch.Tensor):
    """(perm, inv): the stable permutation sorting particles by base y-cell
    (the order ``jnp.argsort`` gives), and its inverse. The key is
    discrete; gradients flow through the gathers that apply the
    permutation."""
    key = torch.floor(x[1].detach() * cfg.inv_dx - 0.5).to(torch.int32)
    perm = torch.argsort(key, stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return perm, inv


def permute_state(state: MPMState, perm) -> MPMState:
    return MPMState(x=state.x[:, perm], v=state.v[:, perm],
                    C=state.C[:, :, perm], F=state.F[:, :, perm])


def permute_params(params: MPMParams, perm) -> MPMParams:
    return params.replace(
        mu=params.mu[perm], lam=params.lam[perm],
        yield_stress=params.yield_stress[perm],
        control_idx=params.control_idx[perm])


def _p2g_channels(cfg: MPMConfig, v_vec, C, stress, impulse) -> torch.Tensor:
    """The 13 per-particle P2G scalars as one (13, N) block: mass, momentum
    (3) and the dx-scaled affine matrix (9, row-major)."""
    stress_coef = -cfg.dt * cfg.p_vol * 4.0 * cfg.inv_dx * cfg.inv_dx
    affine = m33.madd(m33.mscale(stress, stress_coef), m33.mscale(C, cfg.p_mass))
    affine_dx = m33.mscale(affine, cfg.dx)
    mom = [cfg.p_mass * v_vec[d] + impulse[d] for d in range(3)]
    mass = torch.full_like(v_vec[0], cfg.p_mass)
    return torch.stack([mass] + mom
                       + [affine_dx[i][j] for i in range(3) for j in range(3)])


def grid_coords(cfg: MPMConfig, sizes, corner):
    """Global cell coordinates (x (1, wx), y and z (wy*wz, 1)) of the window
    grid form."""
    wx, wy, wz = sizes
    row = torch.arange(wy * wz, dtype=torch.int32, device=corner.device)[:, None]
    y = corner[1] + row // wz
    z = corner[2] + row % wz
    x = corner[0] + torch.arange(wx, dtype=torch.int32,
                                 device=corner.device)[None, :]
    return x, y, z


def boundary_condition(cfg: MPMConfig, coords, gv):
    """Box boundary + sticky ground (mpm_simulator.py:269-281)."""
    bound = 3
    ng = cfg.n_grid
    out = []
    for d in range(3):
        v = gv[d]
        v = torch.where((coords[d] < bound) & (v < 0), 0.0, v)
        v = torch.where((coords[d] > ng - bound) & (v > 0), 0.0, v)
        out.append(v)
    if cfg.ground_friction >= 10.0:
        ground = coords[1] < bound
        out = [torch.where(ground, 0.0, v) for v in out]
    return tuple(out)


def cfl_clamp(cfg: MPMConfig, gv):
    """Optional per-component grid-velocity clamp at
    ``cfl_velocity_clamp * dx / dt`` (off when the factor is inf)."""
    if not np.isfinite(cfg.cfl_velocity_clamp):
        return gv
    cap = float(cfg.cfl_velocity_clamp) * cfg.dx / cfg.dt
    return tuple(torch.clamp(v, -cap, cap) for v in gv)


def grid_normalize(cfg: MPMConfig, grid, gravity):
    """Momentum -> velocity + gravity on non-empty cells."""
    m = grid[0]
    mask = m > 1e-10
    m_safe = torch.where(mask, m, 1.0)
    gv = tuple(
        torch.where(mask, grid[d + 1] / m_safe + cfg.dt * gravity[d], 0.0)
        for d in range(3))
    return gv, mask, m


def stress_and_F(cfg: MPMConfig, params: MPMParams, state: MPMState):
    """Deformation update F <- (I + dt C) F and the stress (mat tuples)."""
    C = m33.from_mat_array(state.C)
    F = m33.from_mat_array(state.F)
    F_tmp = m33.mmul(m33.madd_diag(m33.mscale(C, cfg.dt), 1.0), F)
    return compute_stress_and_F(cfg, F_tmp, params.mu, params.lam)


def contact_impulse(cfg: MPMConfig, params: MPMParams,
                    prims: Tuple[SDFParams, ...], state: MPMState,
                    bodies: BodyState):
    """Particle-contact impulse (3-tuple of (N,)) and per-primitive wrenches
    (list of (6,))."""
    if cfg.collision_type in (CONTACT_MIXED, CONTACT_GRID) and prims:
        raise NotImplementedError(
            f"collision_type {cfg.collision_type} is not ported yet; the "
            "PyTorch port runs particle contact (collision_type 1)")
    zero = torch.zeros_like(state.x[0])
    impulse = (zero, zero, zero)
    wrenches = [torch.zeros((6,), dtype=state.x.dtype, device=state.x.device)
                for _ in range(max(len(prims), 1))]
    if cfg.collision_type == CONTACT_PARTICLE:
        for i, prim in enumerate(prims):
            if not cfg.primitives_contact[i]:
                continue
            imp, wr = contact_mod.collide_particle(
                prim, bodies.pos[i], bodies.quat[i], bodies.v[i],
                bodies.w[i], params.friction[i], state.x, state.v, cfg.dt,
                cfg.p_mass)
            impulse = m33.vadd(impulse, (imp[0], imp[1], imp[2]))
            wrenches[i] = wrenches[i] + wr
    return impulse, wrenches


def grid_velocity(cfg: MPMConfig, params: MPMParams, gm, gmom, sizes, corner):
    """P2G grids -> the three grid velocity channels G2P reads: normalize,
    add gravity, apply the boundary and the optional CFL clamp."""
    wx = sizes[0]
    grid = (gm, gmom[:, :wx], gmom[:, wx:2 * wx], gmom[:, 2 * wx:])
    g_v, _, _ = grid_normalize(cfg, grid, params.gravity)
    gv = cfl_clamp(cfg, boundary_condition(cfg, grid_coords(cfg, sizes, corner),
                                           g_v))
    return tuple(g.contiguous() for g in gv)


def substep(cfg: MPMConfig, params: MPMParams,
            prims: Tuple[SDFParams, ...], state: MPMState, bodies: BodyState,
            k: int):
    """One MLS-MPM substep with particle contact (or none). Returns
    (new_state, ext_f (B, 6), {"window_overflow": 0-d bool tensor})."""
    stress, F_new = stress_and_F(cfg, params, state)
    impulse, wrenches = contact_impulse(cfg, params, prims, state, bodies)

    # --- P2G into the active window, grid ops, G2P + advection ------------
    sizes, corner, overflow = window_geometry(cfg, state.x)
    chan = _p2g_channels(cfg, tuple(state.v), m33.from_mat_array(state.C),
                         stress, impulse)
    gm, gmom = transfer.p2g(state.x, chan, corner, sizes, cfg.inv_dx)
    gv = grid_velocity(cfg, params, gm, gmom, sizes, corner)
    vc = transfer.g2p(state.x, *gv, corner, sizes, cfg.inv_dx)
    v_new = vc[0:3]
    new_state = MPMState(
        x=state.x + cfg.dt * v_new,
        v=v_new,
        C=(4.0 * cfg.inv_dx) * vc[3:12].reshape(3, 3, -1),
        F=m33.to_mat_array(F_new),
    )
    return new_state, torch.stack(wrenches), {"window_overflow": overflow}
