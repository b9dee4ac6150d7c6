"""MLS-MPM core: one substep with particle contact or forecast mixed
contact, and particle controllers.

Counterpart of ``softmac_tpu/engine/mpm.py`` (reference
``softmac/engine/mpm_simulator.py``: compute_F_tmp :126, p2g :199,
grid_op :284, boundary_condition :269, grid_op_mixed1-4, g2p :300).
Particles are ``(3, N)`` struct-of-arrays; the grid is the active window in
the ``(wy*wz, wx)`` form of ``grid_coords``.

The P2G, G2P, gather and splat of a substep take one of two routes, chosen
by ``transfer_route`` from the window alone (not the dtype, so the CPU's
float64 runs take the route the card's float32 runs take):
- "fused": ``ops/fused.py`` over the dense per-axis weights of
  ``axis_weights`` when the window passes ``pallas_fused.kernel_wanted``
  and not ``pallas_chunked.kernel_wanted`` (the door's (32, 16, 32):
  wy < 24), as the JAX package's ``_Transfers`` (mpm.py:416-533) picks it;
- "transfer": ``ops/transfer.py``'s x-based kernels (the y-chunked
  family's counterpart) for every other window: the pour scenes, which the
  JAX package runs on the chunked family, and no window or a window
  neither rule takes, where it runs XLA matmuls over the Khatri-Rao pairs
  (the ``pallas_kr`` kernel on the TPU). Until that kernel is ported the
  x-based kernels, which compute the same function, stand for it: a
  static rule, not a runtime fallback.
The x-based kernels read each particle's own position, so unlike the JAX
chunked family they need no y-sorted order. Each route runs its CUDA
kernels on the card and their plain PyTorch versions on the CPU, forward
and backward: on the fused route the backward kernels return the
cotangents of the dense weights, which flow on through ``axis_weights``
to x.

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
from softmac_tpu_torch.ops import fused, m33, transfer


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


def axis_weights(cfg: MPMConfig, x: torch.Tensor, sizes, corner):
    """Dense per-axis B-spline weight matrices over the active window
    (``mpm.axis_weights`` of the JAX package). Returns (W, WD): lists of 3
    contiguous tensors (w_d, N); W[d][r, p] is the weight of particle p on
    window row r along axis d (zero off its 3 stencil rows), WD[d] the same
    times the unscaled (offset - fx) factor. The weights of all three axes
    are computed at once; each row picks its offset's weight."""
    pos = x * cfg.inv_dx
    b = torch.floor(pos - 0.5).to(torch.int32)
    fx = pos - b.to(pos.dtype)
    w = torch.stack((0.5 * (1.5 - fx) ** 2, 0.75 - (fx - 1.0) ** 2,
                     0.5 * (fx - 0.5) ** 2))                    # (3, 3, N)
    offs = torch.arange(3, dtype=pos.dtype, device=x.device)[:, None, None]
    wd = w * (offs - fx)
    W, WD = [], []
    for d in range(3):
        rel = (corner[d] + torch.arange(sizes[d], dtype=torch.int32,
                                        device=x.device))[:, None] - b[d]
        hit = (rel >= 0) & (rel < 3)
        idx = rel.clamp(0, 2).to(torch.int64)
        W.append(torch.where(hit, torch.gather(w[:, d], 0, idx), 0.0))
        WD.append(torch.where(hit, torch.gather(wd[:, d], 0, idx), 0.0))
    return W, WD


def _chunked_wanted(window) -> bool:
    """``pallas_chunked.kernel_wanted``: wy >= 24, wy and wz multiples of
    8."""
    wx, wy, wz = window
    return wy >= 24 and wy % 8 == 0 and wz % 8 == 0


def _fused_wanted(window) -> bool:
    """``pallas_fused.kernel_wanted``: wz and wx multiples of 8, wy * wz <=
    1280."""
    wx, wy, wz = (int(w) for w in window)
    return wz % 8 == 0 and wy * wz <= 1280 and wx % 8 == 0


def transfer_route(cfg: MPMConfig) -> str:
    """"fused" or "transfer" for this config's window (see the module
    docstring)."""
    window = cfg.active_window
    if window and _fused_wanted(window) and not _chunked_wanted(window):
        return "fused"
    return "transfer"


class Transfers:
    """One substep's transfers on its route: the window (sizes, corner,
    overflow) from the particles x and, on the fused route, the dense
    per-axis weights, built once and shared by the four transfers."""

    def __init__(self, cfg: MPMConfig, x: torch.Tensor):
        self.cfg, self.x = cfg, x
        self.sizes, self.corner, self.overflow = window_geometry(cfg, x)
        self.route = transfer_route(cfg)
        if self.route == "fused":
            W, WD = axis_weights(cfg, x, self.sizes, self.corner)
            self.W = W
            self.ws6 = (W[0], WD[0], W[1], WD[1], W[2], WD[2])

    def p2g(self, chan):
        """(gm (wy*wz, wx), gmom (wy*wz, 3*wx))."""
        if self.route == "fused":
            return fused.p2g(*self.ws6, chan)
        return transfer.p2g(self.x, chan, self.corner, self.sizes,
                            self.cfg.inv_dx)

    def gather(self, gv):
        """The grid velocity at the particles, (3, N)."""
        if self.route == "fused":
            return fused.gather(*self.W, *gv)
        return transfer.gather(self.x, *gv, self.corner, self.sizes,
                               self.cfg.inv_dx)

    def splat(self, vals):
        """vals (3, N) onto the window, (wy*wz, 3*wx)."""
        if self.route == "fused":
            return fused.splat(*self.W, vals)
        return transfer.splat(self.x, vals, self.corner, self.sizes,
                              self.cfg.inv_dx)

    def g2p(self, gv):
        """(12, N): v, then the unscaled C[d][j] in row 3 + 3d + j."""
        if self.route == "fused":
            return fused.g2p(*self.ws6, *gv)
        return transfer.g2p(self.x, *gv, self.corner, self.sizes,
                            self.cfg.inv_dx)


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
    return compute_stress_and_F(cfg, F_tmp, params.mu, params.lam,
                                params.yield_stress)


def contact_impulse(cfg: MPMConfig, params: MPMParams,
                    prims: Tuple[SDFParams, ...], state: MPMState,
                    bodies: BodyState):
    """Particle-contact impulse (3-tuple of (N,)) and per-primitive wrenches
    (list of (6,)); zero impulse and wrenches under mixed contact, whose
    wrenches come from ``grid_velocity_mixed``."""
    if cfg.collision_type == CONTACT_GRID and prims:
        raise NotImplementedError(
            "grid contact (collision_type 0) is not ported yet; the PyTorch "
            "port runs particle and mixed contact (collision_types 1, 2)")
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


def _bounded_velocity(cfg: MPMConfig, params: MPMParams, gm, gmom, sizes,
                      corner):
    """P2G grids -> velocity with gravity on the non-empty cells (the mask)
    and the boundary applied: (3 grids, mask)."""
    wx = sizes[0]
    grid = (gm, gmom[:, :wx], gmom[:, wx:2 * wx], gmom[:, 2 * wx:])
    g_v, mask, _ = grid_normalize(cfg, grid, params.gravity)
    return (boundary_condition(cfg, grid_coords(cfg, sizes, corner), g_v),
            mask)


def grid_velocity(cfg: MPMConfig, params: MPMParams, gm, gmom, sizes, corner):
    """P2G grids -> the three grid velocity channels G2P reads: normalize,
    add gravity, apply the boundary and the optional CFL clamp."""
    gv, _ = _bounded_velocity(cfg, params, gm, gmom, sizes, corner)
    return tuple(g.contiguous() for g in cfl_clamp(cfg, gv))


def control_impulse(cfg: MPMConfig, params: MPMParams, impulse, mpm_action):
    """The particle controllers' impulse added to ``impulse``: a particle
    with control_idx c >= 0 takes 6e-4 * mpm_action[c] * dt."""
    if cfg.n_controllers == 0 or mpm_action is None:
        return impulse
    cidx = params.control_idx
    act = mpm_action[cidx.clamp(0, cfg.n_controllers - 1).to(torch.int64)]
    on = cidx >= 0
    return tuple(impulse[d] + torch.where(on, 6e-4 * act[:, d] * cfg.dt, 0.0)
                 for d in range(3))


def grid_velocity_mixed(cfg: MPMConfig, params: MPMParams,
                        prims: Tuple[SDFParams, ...], state: MPMState,
                        bodies: BodyState, gm, gmom, tr: Transfers, k: int,
                        wrenches):
    """P2G grids -> grid velocity under forecast mixed contact
    (grid_op_mixed1-4): normalize, add gravity, apply the boundary, gather
    the grid velocity at the particles (v_tmp), run each contacting
    primitive's mixed contact in order (each from the previous one's
    target velocity), splat the correction -2 (v_tmp - v_tgt) back onto
    the non-empty cells and apply the optional CFL clamp (the boundary is
    not applied again). Adds each primitive's wrench to ``wrenches[i]``."""
    wx = tr.sizes[0]
    gvm, mask = _bounded_velocity(cfg, params, gm, gmom, tr.sizes, tr.corner)
    x = state.x
    v_tmp = tr.gather(tuple(g.contiguous() for g in gvm))
    v_tgt = v_tmp
    # the remaining-window factor, a device scalar: no host round trip
    life = torch.full((), 1.0 / (cfg.substeps - k), dtype=x.dtype,
                      device=x.device)
    for i, prim in enumerate(prims):
        if not cfg.primitives_contact[i]:
            continue
        v_tgt, wr = contact_mod.collide_mixed(
            prim, bodies.pos[i], bodies.quat[i], bodies.v[i], bodies.w[i],
            params.friction[i], params.softness[i], x, v_tgt, cfg.p_mass,
            cfg.dt, life, push_cap=cfg.contact_push_velocity_cap)
        wrenches[i] = wrenches[i] + wr
    corr = tr.splat(-2.0 * (v_tmp - v_tgt))
    gv = tuple(torch.where(mask, gvm[d] + corr[:, d * wx:(d + 1) * wx], 0.0)
               for d in range(3))
    return tuple(g.contiguous() for g in cfl_clamp(cfg, gv))


def substep(cfg: MPMConfig, params: MPMParams,
            prims: Tuple[SDFParams, ...], state: MPMState, bodies: BodyState,
            k: int, mpm_action=None):
    """One MLS-MPM substep (k-th of the env step) with particle contact,
    mixed contact or none, and the particle controllers' ``mpm_action``
    (n_controllers, 3). Returns (new_state, ext_f (B, 6),
    {"window_overflow": 0-d bool tensor})."""
    stress, F_new = stress_and_F(cfg, params, state)
    impulse, wrenches = contact_impulse(cfg, params, prims, state, bodies)
    impulse = control_impulse(cfg, params, impulse, mpm_action)

    # --- P2G into the active window, grid ops, G2P + advection ------------
    tr = Transfers(cfg, state.x)
    chan = _p2g_channels(cfg, tuple(state.v), m33.from_mat_array(state.C),
                         stress, impulse)
    gm, gmom = tr.p2g(chan)
    if cfg.collision_type == CONTACT_MIXED:
        gv = grid_velocity_mixed(cfg, params, prims, state, bodies, gm, gmom,
                                 tr, k, wrenches)
    else:
        gv = grid_velocity(cfg, params, gm, gmom, tr.sizes, tr.corner)
    vc = tr.g2p(gv)
    v_new = vc[0:3]
    new_state = MPMState(
        x=state.x + cfg.dt * v_new,
        v=v_new,
        C=(4.0 * cfg.inv_dx) * vc[3:12].reshape(3, 3, -1),
        F=m33.to_mat_array(F_new),
    )
    return new_state, torch.stack(wrenches), {"window_overflow": tr.overflow}
