"""MLS-MPM core: one substep with grid, particle or forecast mixed contact,
and particle controllers.

Counterpart of ``softmac_tpu/engine/mpm.py`` (reference
``softmac/engine/mpm_simulator.py``: compute_F_tmp :126, p2g :199,
grid_op :284, boundary_condition :269, grid_op_mixed1-4, g2p :300).
Particles are ``(3, N)`` struct-of-arrays; the grid is the active window in
the ``(wy*wz, wx)`` form of ``grid_coords`` (the full ``n_grid`` cube when
no window is configured).

The P2G, G2P, gather and splat of a substep take one of three routes,
chosen by ``transfer_route`` from the window alone (not the dtype, so the
CPU's float64 runs take the route the card's float32 runs take), where the
JAX package's ``_Transfers`` (mpm.py:416-533) takes its three branches:
- "transfer": ``ops/transfer.py``'s x-based kernels (the y-chunked
  family's counterpart) when the window passes both
  ``pallas_fused.kernel_wanted`` and ``pallas_chunked.kernel_wanted``: the
  pour scenes. They read each particle's own position, so unlike the JAX
  chunked family they need no y-sorted order;
- "fused": ``ops/fused.py`` over the dense per-axis weights of
  ``axis_weights`` when the window passes the fused rule and not the
  chunked one (the door's (32, 16, 32): wy < 24);
- "dense": no window (the full grid, the reference's own semantics), or a
  window the fused rule refuses: matrix products over the Khatri-Rao pair
  matrices of ``hyz_family`` (``ops/kr.py``'s kernel builds them;
  ``p2g_dense``, ``g2p_dense``, ``gather_dense``, ``splat_channels``).
Each route runs its CUDA kernels on the card and their plain PyTorch
versions on the CPU, forward and backward; the dense route's products are
``torch.matmul`` on both, in full precision (TF32 stays off, as
``SoftMacEnv`` sets it), as the JAX package leaves them to XLA. On the
fused and dense routes the cotangents of the dense weights flow on through
``axis_weights`` to x.

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
from softmac_tpu_torch.ops import fused, kr, m33, transfer


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
    """"transfer", "fused" or "dense" for this config's window (see the
    module docstring)."""
    window = cfg.active_window
    if not window or not _fused_wanted(window):
        return "dense"
    return "transfer" if _chunked_wanted(window) else "fused"


def hyz_family(W, WD):
    """The three Khatri-Rao (y, z) pair matrices (H, HDy, HDz), each
    (wy*wz, N), from ``axis_weights``' W, WD (``mpm.hyz_family``): the
    ``ops/kr.py`` kernel on the card, its plain version on the CPU."""
    return kr.kr3(W[1], W[2], WD[1], WD[2])


def p2g_dense(W, WD, H, HDy, HDz, chan):
    """Dense P2G of the (13, N) channel block of ``_p2g_channels`` (the
    function of ``mpm.p2g_dense``): (gm (wy*wz, wx), gmom (wy*wz, 3*wx)).
    The momentum's x-derivative terms ride the H product (4 wx columns),
    its y and z terms the HDy and HDz products."""
    wx = W[0].shape[0]
    Wx, WxD = W[0], WD[0]
    r_h = torch.cat([Wx * chan[0]] + [Wx * chan[1 + d] + WxD * chan[4 + 3 * d]
                                      for d in range(3)])
    r_dy = torch.cat([Wx * chan[5 + 3 * d] for d in range(3)])
    r_dz = torch.cat([Wx * chan[6 + 3 * d] for d in range(3)])
    o1 = H @ r_h.T
    return o1[:, :wx], o1[:, wx:] + HDy @ r_dy.T + HDz @ r_dz.T


def splat_channels(W, H, vals):
    """Dense splat of vals (3, N) (``mpm.splat_channels``): (wy*wz, 3*wx),
    component d in columns d*wx .. (d+1)*wx."""
    return H @ torch.cat([W[0] * vals[d] for d in range(3)]).T


def _rows(M, Wt, wx):
    """The three per-component row sums sum_x M[p, d wx + x] Wt[p, x]."""
    return [(M[:, d * wx:(d + 1) * wx] * Wt).sum(dim=1) for d in range(3)]


def g2p_dense(W, WD, H, HDy, HDz, gv):
    """Dense G2P of the three grids gv (wy*wz, wx) (``mpm.g2p_dense``):
    (12, N), v in rows 0-2, the unscaled C[d][j] in row 3 + 3d + j."""
    wx = W[0].shape[0]
    G = torch.cat(gv, dim=1)                  # (wy*wz, 3*wx)
    WxT, WxDT = W[0].T, WD[0].T               # (N, wx) views
    M = H.T @ G
    c0 = _rows(M, WxDT, wx)
    c1 = _rows(HDy.T @ G, WxT, wx)
    c2 = _rows(HDz.T @ G, WxT, wx)
    return torch.stack(_rows(M, WxT, wx)
                       + [c[d] for d in range(3) for c in (c0, c1, c2)])


def gather_dense(W, H, gv):
    """Dense gather of the three grids gv at the particles
    (``mpm.gather_dense``): (3, N)."""
    return torch.stack(_rows(H.T @ torch.cat(gv, dim=1), W[0].T,
                             W[0].shape[0]))


class Transfers:
    """One substep's transfers on its route: the window (sizes, corner,
    overflow) from the particles x and, on the fused and dense routes, the
    dense per-axis weights (and on the dense route their pair matrices),
    built once and shared by the four transfers."""

    def __init__(self, cfg: MPMConfig, x: torch.Tensor):
        self.cfg, self.x = cfg, x
        self.sizes, self.corner, self.overflow = window_geometry(cfg, x)
        self.route = transfer_route(cfg)
        if self.route != "transfer":
            W, WD = axis_weights(cfg, x, self.sizes, self.corner)
            self.W, self.WD = W, WD
            self.ws6 = (W[0], WD[0], W[1], WD[1], W[2], WD[2])
        if self.route == "dense":
            self.H = hyz_family(W, WD)

    def p2g(self, chan):
        """(gm (wy*wz, wx), gmom (wy*wz, 3*wx))."""
        if self.route == "dense":
            return p2g_dense(self.W, self.WD, *self.H, chan)
        if self.route == "fused":
            return fused.p2g(*self.ws6, chan)
        return transfer.p2g(self.x, chan, self.corner, self.sizes,
                            self.cfg.inv_dx)

    def gather(self, gv):
        """The grid velocity at the particles, (3, N)."""
        if self.route == "dense":
            return gather_dense(self.W, self.H[0], gv)
        if self.route == "fused":
            return fused.gather(*self.W, *gv)
        return transfer.gather(self.x, *gv, self.corner, self.sizes,
                               self.cfg.inv_dx)

    def splat(self, vals):
        """vals (3, N) onto the window, (wy*wz, 3*wx)."""
        if self.route == "dense":
            return splat_channels(self.W, self.H[0], vals)
        if self.route == "fused":
            return fused.splat(*self.W, vals)
        return transfer.splat(self.x, vals, self.corner, self.sizes,
                              self.cfg.inv_dx)

    def g2p(self, gv):
        """(12, N): v, then the unscaled C[d][j] in row 3 + 3d + j."""
        if self.route == "dense":
            return g2p_dense(self.W, self.WD, *self.H, gv)
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
    (list of (6,)); zero impulse and wrenches under grid and mixed contact,
    whose wrenches come from ``grid_velocity_grid`` and
    ``grid_velocity_mixed``."""
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


def grid_velocity_grid(cfg: MPMConfig, params: MPMParams,
                       prims: Tuple[SDFParams, ...], bodies: BodyState, gm,
                       gmom, sizes, corner, wrenches):
    """P2G grids -> grid velocity under grid contact (grid_op :284-296):
    normalize and add gravity, run each contacting primitive's contact on
    the non-empty nodes in turn, then the boundary, zero the empty nodes
    and apply the optional CFL clamp. Adds each primitive's wrench to
    ``wrenches[i]``."""
    wx = sizes[0]
    grid = (gm, gmom[:, :wx], gmom[:, wx:2 * wx], gmom[:, 2 * wx:])
    g_v, mask, grid_m = grid_normalize(cfg, grid, params.gravity)
    coords = grid_coords(cfg, sizes, corner)
    grid_pos = tuple((c.to(gm.dtype) * cfg.dx).expand(gm.shape)
                     for c in coords)
    v_out = g_v      # contact first, the boundary after (grid_op :290-296)
    for i, prim in enumerate(prims):
        if not cfg.primitives_contact[i]:
            continue
        v_new, wr = contact_mod.collide_grid(
            prim, bodies.pos[i], bodies.quat[i], bodies.v[i], bodies.w[i],
            params.friction[i], params.softness[i], grid_pos, v_out, cfg.dt,
            grid_m)
        v_out = tuple(torch.where(mask, v_new[d], v_out[d]) for d in range(3))
        wrenches[i] = wrenches[i] + wr
    gv = boundary_condition(cfg, coords, v_out)
    gv = tuple(torch.where(mask, g, 0.0) for g in gv)
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


def grid_velocity_mixed(cfg: MPMConfig, params: MPMParams, gm, gmom,
                        tr: Transfers, collide):
    """P2G grids -> grid velocity under forecast mixed contact
    (grid_op_mixed1-4): normalize, add gravity, apply the boundary, gather
    the grid velocity at the particles (v_tmp), take the contact's target
    velocity ``collide(v_tmp)`` (3, N), splat the correction
    -2 (v_tmp - v_tgt) back onto the non-empty cells and apply the optional
    CFL clamp (the boundary is not applied again)."""
    wx = tr.sizes[0]
    gvm, mask = _bounded_velocity(cfg, params, gm, gmom, tr.sizes, tr.corner)
    v_tmp = tr.gather(tuple(g.contiguous() for g in gvm))
    corr = tr.splat(-2.0 * (v_tmp - collide(v_tmp)))
    gv = tuple(torch.where(mask, gvm[d] + corr[:, d * wx:(d + 1) * wx], 0.0)
               for d in range(3))
    return tuple(g.contiguous() for g in cfl_clamp(cfg, gv))


def _life(cfg: MPMConfig, k: int) -> float:
    """The remaining-window factor of the k-th substep of an env step."""
    return 1.0 / (cfg.substeps - k)


def _collide_prims(cfg: MPMConfig, params: MPMParams,
                   prims: Tuple[SDFParams, ...], x, bodies: BodyState, k: int,
                   wrenches):
    """v_tmp -> v_tgt through each contacting primitive's mixed contact in
    order (each from the previous one's target velocity); adds each
    primitive's wrench to ``wrenches[i]``."""
    # the remaining-window factor, a device scalar: no host round trip
    life = torch.full((), _life(cfg, k), dtype=x.dtype, device=x.device)

    def collide(v_tgt):
        for i, prim in enumerate(prims):
            if not cfg.primitives_contact[i]:
                continue
            v_tgt, wr = contact_mod.collide_mixed(
                prim, bodies.pos[i], bodies.quat[i], bodies.v[i],
                bodies.w[i], params.friction[i], params.softness[i], x, v_tgt,
                cfg.p_mass, cfg.dt, life,
                push_cap=cfg.contact_push_velocity_cap)
            wrenches[i] = wrenches[i] + wr
        return v_tgt
    return collide


def substep(cfg: MPMConfig, params: MPMParams,
            prims: Tuple[SDFParams, ...], state: MPMState, bodies: BodyState,
            k: int, mpm_action=None):
    """One MLS-MPM substep (k-th of the env step) with grid, particle or
    mixed contact (or no primitive), and the particle controllers'
    ``mpm_action`` (n_controllers, 3). Returns (new_state, ext_f (B, 6),
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
        gv = grid_velocity_mixed(
            cfg, params, gm, gmom, tr,
            _collide_prims(cfg, params, prims, state.x, bodies, k, wrenches))
    elif cfg.collision_type == CONTACT_GRID:
        gv = grid_velocity_grid(cfg, params, prims, bodies, gm, gmom,
                                tr.sizes, tr.corner, wrenches)
    else:
        gv = grid_velocity(cfg, params, gm, gmom, tr.sizes, tr.corner)
    new_state = _advect(cfg, state, tr.g2p(gv), F_new)
    return new_state, torch.stack(wrenches), {"window_overflow": tr.overflow}


def _advect(cfg: MPMConfig, state: MPMState, vc, F_new) -> MPMState:
    """The G2P output vc (12, N) -> the new particle state."""
    v_new = vc[0:3]
    return MPMState(x=state.x + cfg.dt * v_new, v=v_new,
                    C=(4.0 * cfg.inv_dx) * vc[3:12].reshape(3, 3, -1),
                    F=m33.to_mat_array(F_new))


def substep_cloth(cfg: MPMConfig, params: MPMParams, cloth_params,
                  state: MPMState, cloth_x, cloth_v, pen, k: int,
                  mpm_action=None):
    """One MLS-MPM substep coupled to a triangle-mesh cloth (the soft_cloth
    substep, ``soft_cloth/engine/mpm_simulator.py:418-428``; the JAX
    package's ``mpm.substep_cloth``), against the window's forecast cloth
    ``cloth_x``, ``cloth_v`` (V, 3) and the side-state ``pen``
    (``cloth_contact.PenetrationState``).

    Stress, the cloth's penalty impulse (collision_type particle), the
    controllers' impulse, P2G, normalize, boundary, gather, the cloth's
    forecast contact (mixed), the alpha = 2 correction splat, G2P: the
    transfers on the route of ``Transfers``, as ``substep``. Returns
    (new_state, vertex forces (V, 3), {"window_overflow"})."""
    from softmac_tpu_torch.engine import cloth_contact as cc
    n_vertices = cloth_x.shape[0]
    stress, F_new = stress_and_F(cfg, params, state)
    zero = torch.zeros_like(state.x[0])
    impulse = (zero, zero, zero)
    ext_vertex_f = torch.zeros((n_vertices, 3), dtype=state.x.dtype,
                               device=state.x.device)
    if cfg.collision_type == CONTACT_PARTICLE:
        impulse, ext = cc.collide_cloth(
            cloth_params, cloth_x, cloth_v, tuple(state.x), tuple(state.v),
            cfg.p_mass, cfg.dt, 1.0, pen, n_vertices, mode="particle")
        ext_vertex_f = ext_vertex_f + ext
    impulse = control_impulse(cfg, params, impulse, mpm_action)

    tr = Transfers(cfg, state.x)
    chan = _p2g_channels(cfg, tuple(state.v), m33.from_mat_array(state.C),
                         stress, impulse)
    gm, gmom = tr.p2g(chan)
    if cfg.collision_type == CONTACT_MIXED:
        forces = []

        def collide(v_tmp):
            v_tgt, ext = cc.collide_cloth(
                cloth_params, cloth_x, cloth_v, tuple(state.x), tuple(v_tmp),
                cfg.p_mass, cfg.dt, _life(cfg, k), pen, n_vertices,
                mode="mixed")
            forces.append(ext)
            return torch.stack(v_tgt)
        gv = grid_velocity_mixed(cfg, params, gm, gmom, tr, collide)
        ext_vertex_f = ext_vertex_f + forces[0]
    else:
        gv = grid_velocity(cfg, params, gm, gmom, tr.sizes, tr.corner)
    new_state = _advect(cfg, state, tr.g2p(gv), F_new)
    return new_state, ext_vertex_f, {"window_overflow": tr.overflow}
