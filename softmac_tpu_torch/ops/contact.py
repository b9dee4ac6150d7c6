"""Particle contact against SDF primitives: the CUDA kernels and their plain
PyTorch versions.

Penalty contact (``collide_particle``): counterpart of the
particle-contact kernel of ``softmac_tpu/ops/pallas_contact.py``
(``_particle_math`` behind ``_particle_factory``), including the
stencil-row gather the JAX package leaves to XLA, with the wrench tail
``_tail_particle`` of its custom_vjp: it returns the masked impulse (3, N)
and the reaction wrench (6,). Its plain version is
``collide_particle_wrench_plain`` (``collide_particle_plain``, which
returns the impulse and the contact mask, then the wrench's reduction).

Forecast mixed contact (``collide_mixed``, further below): counterpart of
the merged kernel ``_make_mixed12_kernel`` (``_mixed12_math``) with the
wrench tail ``_tail12`` of its custom_vjp, and of its two-launch split
``_make_mixed1_kernel`` / ``_make_mixed2_kernel``, with the semantics of
``contact._collide_mixed_xla``.

The plain version's SDF sample (clamped base cell, one 32-float stencil row,
trilinear sdf and normal; BIG and normal (0, 1, 0) outside the table's box)
lives here, beside the kernel it stands for, as ``_cell_index`` and
``_particle_math`` live in ``pallas_contact``. ``prim`` is an
``engine.types.SDFParams``; this module reads its fields and imports nothing
of the engine.

``collide_particle`` dispatches on the device of the particles: the CPU runs
the plain version, CUDA launches the tiled kernel (one launch: the
contact, the wrench and its reduction; the launch counted), anything else
raises. Under autograd it goes through ``CollideParticle`` (the
custom_vjp of ``pallas_contact._particle_factory``): cotangents of the
impulse and the wrench reach x, v and the 14 body floats (position,
quaternion, velocity, angular velocity, friction); the backward launches
``collide_particle_bwd`` on CUDA and runs
``collide_particle_wrench_vjp_plain`` on the CPU. ``collide_mixed``
returns (p_v_out, wrench) and does the same through ``CollideMixed`` (the
tiled kernels with the wrench folded in, ``collide_mixed_bwd`` /
``collide_mixed_wrench_vjp_plain``) or, under the split switch,
``CollideMixedSplit`` (``collide_mixed2_bwd`` -> ``collide_mixed1_bwd`` /
``collide_mixed_vjp_plain``) and the wrench's PyTorch reduction, with
cotangents for the 16 body floats (adding softness and life). The SDF
table gets no gradient, as in the JAX package.
"""
from __future__ import annotations

import math
import os

import torch

from softmac_tpu_torch.ops import build, m33

BIG = 1e10
CONTACT_THRESHOLD = 5e-3
K1 = 50.0
MIXED_TILE = 512        # particles a block of the tiled forwards (mixed
MIXED_BWD_TILE = 1024   # and penalty) and backwards: contact_mixed.cuh's
_DONE = {}              # the tiled kernels' block counter of each stream
# the numels of each tiled family's body tensors: bp, bq, bv, bw, friction
# and, for the mixed contact, softness and life
_TILED_BODY = {"collide_particle": (3, 4, 3, 3, 1),
               "collide_mixed": (3, 4, 3, 3, 1, 1, 1)}


def _in_box(prim, p):
    return ((p[0] >= prim.lower[0]) & (p[0] < prim.upper[0])
            & (p[1] >= prim.lower[1]) & (p[1] < prim.upper[1])
            & (p[2] >= prim.lower[2]) & (p[2] < prim.upper[2]))


def cell_index(prim, p):
    """(flat base-cell index (N,) int64, base 3 x float, fx 3 x float): the
    clamped base cell of local points p and their clamped fractions."""
    res = prim.res
    base, basef, fx = [], [], []
    for d in range(3):
        pos = (p[d] - prim.lower[d]) * prim.inv_dx
        b = torch.clamp(torch.floor(pos).to(torch.int64), 0, res[d] - 2)
        base.append(b)
        basef.append(b.to(pos.dtype))
        fx.append(torch.clamp(pos - basef[d], 0.0, 1.0))
    idx = (base[0] * res[1] + base[1]) * res[2] + base[2]
    return idx, tuple(basef), tuple(fx)


def gather_rows(prim, p):
    """ONE row gather of the 2x2x2 x 4-channel stencil at base(p). Returns
    (rows (N, 32), base 3 x float, fx)."""
    idx, basef, fx = cell_index(prim, p)
    return prim.neighborhood[idx], basef, fx


def interp_rows(rows, fx, in_box):
    """Trilinear (sdf, unit normal) from the stencil rows."""
    sdf = 0.0
    nx = ny = nz = 0.0
    c = 0
    for i in (0, 1):
        wi = fx[0] if i else (1.0 - fx[0])
        for j in (0, 1):
            wj = fx[1] if j else (1.0 - fx[1])
            for k in (0, 1):
                wk = fx[2] if k else (1.0 - fx[2])
                w = wi * wj * wk
                sdf = sdf + w * rows[..., 4 * c + 0]
                nx = nx + w * rows[..., 4 * c + 1]
                ny = ny + w * rows[..., 4 * c + 2]
                nz = nz + w * rows[..., 4 * c + 3]
                c += 1
    norm = torch.sqrt(nx * nx + ny * ny + nz * nz + 1e-14)
    n = (nx / norm, ny / norm, nz / norm)
    zero = torch.zeros_like(norm)
    n = m33.vwhere(in_box, n, (zero, torch.ones_like(norm), zero))
    return torch.where(in_box, sdf, BIG), n


def sample_sdf_normal_local(prim, p):
    rows, _, fx = gather_rows(prim, p)
    return interp_rows(rows, fx, _in_box(prim, p))


def sample_sdf_normal_world(prim, bp, bq, x):
    """World-frame (sdf, normal) query; bp/bq/x are tuples."""
    qinv = m33.qnorm(m33.qconj(bq))
    sdf, n = sample_sdf_normal_local(prim, m33.qrot(qinv, m33.vsub(x, bp)))
    return sdf, m33.qrot(bq, n)


def collider_velocity(bq, bv, bw, r):
    """Velocity of the body surface point at world offset r from the origin
    (primitive_base.py:63-70: v and w live in the body frame)."""
    qn = m33.qnorm(bq)
    r_local = m33.qrot(m33.qconj(qn), r)
    v_local = m33.vadd(bv, m33.cross(bw, r_local))
    return m33.qrot(qn, v_local)


def collide_particle_plain(prim, body_pos, body_quat, body_v, body_w,
                           friction, x, v, dt, p_mass):
    """Plain PyTorch penalty contact (``contact._collide_particle_xla``
    semantics, Coulomb-clamped friction). x, v (3, N). Returns (impulse
    (3, N), mask (N,) bool)."""
    bp = tuple(body_pos[d] for d in range(3))
    bq = tuple(body_quat[d] for d in range(4))
    bv = tuple(body_v[d] for d in range(3))
    bw = tuple(body_w[d] for d in range(3))
    xs = (x[0], x[1], x[2])
    dist, D = sample_sdf_normal_world(prim, bp, bq, xs)
    c = dist - CONTACT_THRESHOLD
    mask = c < 0.0
    c = torch.where(mask, c, 0.0)

    r = m33.vsub(xs, bp)
    cv = collider_velocity(bq, bv, bw, r)
    input_v = m33.vsub((v[0], v[1], v[2]), cv)
    nc = m33.dot(input_v, D)
    p_v_t = m33.vsub(input_v, m33.vscale(D, nc))

    imp1 = m33.vscale(D, -(c * K1 * dt))
    vt_norm = torch.sqrt(m33.dot(p_v_t, p_v_t) + 1e-8)
    fric_mag = torch.minimum(torch.abs(nc) * friction * dt, p_mass * vt_norm)
    imp2 = m33.vscale(p_v_t, -fric_mag / vt_norm)
    imp = m33.vadd(imp1, imp2)
    return torch.stack([torch.where(mask, i, 0.0) for i in imp]), mask


def collide_particle_wrench_plain(prim, body_pos, body_quat, body_v, body_w,
                                  friction, x, v, dt, p_mass):
    """The plain version of the tiled kernel: ``collide_particle_plain``
    followed by the wrench tail (``pallas_contact._tail_particle``).
    Returns (impulse (3, N), wrench (6,): the force b_f = -imp / dt and its
    torque about body_pos, summed over the particles in contact), the
    outputs of ``contact._collide_particle_xla``."""
    imp, mask = collide_particle_plain(prim, body_pos, body_quat, body_v,
                                       body_w, friction, x, v, dt, p_mass)
    b_f = (imp[0] * (-1.0 / dt), imp[1] * (-1.0 / dt), imp[2] * (-1.0 / dt))
    r = m33.vsub((x[0], x[1], x[2]), (body_pos[0], body_pos[1], body_pos[2]))
    return imp, wrench_plain(b_f, r, mask)


def collide_particle_wrench_vjp_plain(prim, body_pos, body_quat, body_v,
                                      body_w, friction, x, v, dt, p_mass,
                                      dimp, dwrench):
    """Cotangents (d body_pos, d body_quat, d body_v, d body_w, d friction,
    dx, dv) of ``collide_particle_wrench_plain``'s impulse and wrench for
    the cotangents dimp (3, N) and dwrench (6,), either None for zero:
    autograd of the plain version, recomputed."""
    with torch.enable_grad():
        ins = tuple(t.detach().requires_grad_() for t in
                    (body_pos, body_quat, body_v, body_w, friction, x, v))
        out = collide_particle_wrench_plain(prim, *ins, dt, p_mass)
        pairs = [(o, g) for o, g in zip(out, (dimp, dwrench))
                 if g is not None] or [(out[0], torch.zeros_like(out[0]))]
        outs, gs = zip(*pairs)
        return torch.autograd.grad(outs, ins, gs)


def _collide_particle(prim, body_pos, body_quat, body_v, body_w, friction,
                      x, v, dt, p_mass):
    """The penalty contact with its wrench; see
    ``collide_particle_wrench_plain``. CUDA tensors launch the tiled
    kernel."""
    args = (body_pos, body_quat, body_v, body_w, friction)
    if build.on_cpu(x, "collide_particle"):
        return collide_particle_wrench_plain(prim, *args, x, v, dt, p_mass)
    return _tiled_launch(collide_particle,
                         _tiled_call("collide_particle", prim, args, x, v),
                         prim, x, dt, p_mass)


def collide_particle_bwd(prim, body_pos, body_quat, body_v, body_w, friction,
                         x, v, dt, p_mass, dimp, dwrench):
    """The tiled penalty backward kernel: the cotangents
    ``collide_particle_wrench_vjp_plain`` returns for the cotangents dimp
    (3, N) of the impulse and dwrench (6,) of the wrench (either None for
    zero), on CUDA float32 tensors, in one launch. The body cotangents are
    summed in a fixed order on the card (block partials, then the last
    block over them), so they are the same on every run."""
    args = (body_pos, body_quat, body_v, body_w, friction)
    call = _tiled_call("collide_particle_bwd", prim, args, x, v)
    return _tiled_bwd_launch(collide_particle_bwd, call, prim, x, dt, p_mass,
                             (), dimp, dwrench)


class CollideParticle(torch.autograd.Function):
    """Penalty contact with its wrench and its backward kernel
    (``pallas_contact._particle_factory``'s custom_vjp, whose outputs are
    (impulse, wrench)). Outputs the impulse (3, N) and the wrench (6,):
    force and torque about body_pos over the particles in contact.
    Cotangents of either output (a missing one is zero, with no fill
    launch) reach the body tensors, x and v; the SDF table gets none. On
    CUDA the forward and the backward are one launch each, the launch's
    checks made in the forward only; on the CPU they are
    ``collide_particle_wrench_plain`` and its plain vjp."""

    @staticmethod
    def forward(ctx, prim, body_pos, body_quat, body_v, body_w, friction, x,
                v, dt, p_mass):
        out = _collide_particle(prim, body_pos, body_quat, body_v, body_w,
                                friction, x, v, dt, p_mass)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(body_pos, body_quat, body_v, body_w, friction,
                              x, v)
        ctx.prim, ctx.dt, ctx.p_mass = prim, dt, p_mass
        return out

    @staticmethod
    def backward(ctx, dimp, dwrench):
        saved = ctx.saved_tensors
        x, v = saved[5], saved[6]
        rest = (ctx.dt, ctx.p_mass,
                None if dimp is None else dimp.contiguous(),
                None if dwrench is None else dwrench.contiguous())
        if build.on_cpu(x, "collide_particle"):
            grads = collide_particle_wrench_vjp_plain(ctx.prim, *saved, *rest)
        else:
            call = _tiled_call("collide_particle_bwd", ctx.prim, saved[:5], x,
                               v, check=False)
            grads = _tiled_bwd_launch(collide_particle_bwd, call, ctx.prim,
                                      x, ctx.dt, ctx.p_mass, (), *rest[2:])
        return ((None,) + tuple(g if need else None for g, need in
                                zip(grads, ctx.needs_input_grad[1:8]))
                + (None, None))


def collide_particle(prim, body_pos, body_quat, body_v, body_w, friction,
                     x, v, dt, p_mass):
    """Penalty contact impulse and its wrench on the body; see
    ``collide_particle_wrench_plain``. Returns (impulse (3, N), wrench
    (6,)). body_pos/v/w (3,), body_quat (4,) wxyz and friction () are
    tensors on the particles' device. CUDA tensors launch the tiled kernel;
    under autograd the backward launches ``collide_particle_bwd``."""
    args = (body_pos, body_quat, body_v, body_w, friction, x, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return CollideParticle.apply(prim, *args, dt, p_mass)
    return _collide_particle(prim, *args, dt, p_mass)


collide_particle.launches = 0
collide_particle_bwd.launches = 0


# ---------------------------------------------------------------------------
# Forecast mixed contact (reference primitive_base.py:139-181)
#
# Stage 1 samples the SDF at x (one stencil row), applies the friction-cone
# response to particles approaching the body within the contact threshold
# and forecasts x_new = x + dt * p_v1. Stage 2 samples the SDF at x_new
# against the SAME stencil row (``forecast_fx``: fractions relative to
# base(x), unclamped) and pushes penetrating particles out along the
# forecast normal over the remaining window (``life``). The wrench on the
# body (force and torque about its position, summed over the particles in
# contact) comes with p_v_out, as ``pallas_contact._fused12_factory``'s
# custom_vjp returns them: the tiled kernel sums it on the card
# (``collide_mixed``, ``CollideMixed``); its plain version is
# ``collide_mixed_wrench_plain``. ``collide_mixed_plain`` and the split
# stages return p_v_out (3, N), the unmasked reaction force (v - p_v_out) p_mass / dt (3, N) and
# the contact mask dist(x) <= threshold (N,); on the split path the wrench
# is ``_mixed_tail``'s PyTorch reduction of those.
# ---------------------------------------------------------------------------

def forecast_fx(prim, base, p2):
    """Trilinear fractions of points p2 relative to another point's stencil
    base (3 x float), unclamped: ``interp_rows`` then extrapolates that
    cell's patch linearly where p2 crossed a cell face."""
    return tuple((p2[d] - prim.lower[d]) * prim.inv_dx - base[d]
                 for d in range(3))


def _split_mode() -> bool:
    """The two-launch split (``SOFTMAC_TPU_CONTACT_SPLIT`` set to any
    non-empty value), as ``pallas_contact.collide_mixed_fused`` reads it."""
    return bool(os.environ.get("SOFTMAC_TPU_CONTACT_SPLIT"))


def _relu(a):
    # max(a, 0) with the tie rule of jnp.maximum (half the cotangent each
    # way at a == 0), where clamp would pass all of it
    return torch.maximum(a, torch.zeros_like(a))


def _mixed_stage1(prim, body, xs, vs):
    """Stage 1 (``_mixed1_math``): p_v1, dist and the stencil row it read
    (rows, base) for stage 2."""
    bp, bq, bv, bw, friction, softness, _ = body
    qinv = m33.qnorm(m33.qconj(bq))
    p_loc = m33.qrot(qinv, m33.vsub(xs, bp))
    rows, base, fx0 = gather_rows(prim, p_loc)
    dist, D_loc = interp_rows(rows, fx0, _in_box(prim, p_loc))
    D = m33.qrot(bq, D_loc)      # the raw quaternion, as the reference
    mask = dist <= CONTACT_THRESHOLD
    dist_s = torch.where(mask, dist, 0.0)

    cv = collider_velocity(bq, bv, bw, m33.vsub(xs, bp))
    input_v = m33.vsub(vs, cv)
    nc = m33.dot(input_v, D)
    # friction-cone tangential response (only when approaching: nc < 0)
    p_v_t = m33.vsub(input_v, m33.vscale(D, nc))
    vt_norm = torch.sqrt(m33.dot(p_v_t, p_v_t) + 1e-8)
    vt_fric = m33.vscale(p_v_t, _relu(vt_norm + nc * friction) / vt_norm)
    flag = (nc < 0) & (m33.dot(p_v_t, p_v_t) > 1e-60)
    p_v_t = m33.vwhere(flag, vt_fric, p_v_t)
    v_contact = m33.vadd(cv, p_v_t)
    # min(exp(-d s), 1) written AD-safely: exp of a clamped exponent
    influence = torch.exp(-_relu(dist_s) * softness)
    v_soft = m33.vadd(cv, m33.vadd(m33.vscale(input_v, 1.0 - influence),
                                   m33.vscale(p_v_t, influence)))
    v_near = m33.vwhere(dist_s > 0, v_soft, v_contact)
    p_v1 = m33.vwhere(mask & (nc < 0), v_near, vs)
    return p_v1, dist, rows, base


def _mixed_stage2(prim, body, xs, vs, p_v1, x_new, dist, rows, base, dt,
                  p_mass, push_cap):
    """Stage 2 (``_mixed2_math``): the forecast push-out; returns p_v_out,
    the unmasked reaction force and the mask."""
    bp, bq = body[0], body[1]
    life = body[6]
    qinv = m33.qnorm(m33.qconj(bq))
    p_loc2 = m33.qrot(qinv, m33.vsub(x_new, bp))
    sdf2, n2_loc = interp_rows(rows, forecast_fx(prim, base, p_loc2),
                               _in_box(prim, p_loc2))
    n2 = m33.qrot(bq, n2_loc)
    mask = dist <= CONTACT_THRESHOLD
    pen = mask & (sdf2 < 0)
    sdf2_s = torch.where(pen, sdf2, 0.0)
    push = -(sdf2_s / dt) * life          # >= 0: outward along n2
    if push_cap is not None and math.isfinite(push_cap):
        push = torch.clamp(push, max=push_cap)
    p_v2 = m33.vadd(p_v1, m33.vscale(n2, push))
    p_v_out = m33.vwhere(mask, p_v2, vs)
    force = m33.vscale(m33.vsub(vs, p_v_out), p_mass / dt)
    return torch.stack(p_v_out), torch.stack(force), mask


def _mixed_body(body_pos, body_quat, body_v, body_w, friction, softness,
                life):
    return (tuple(body_pos[d] for d in range(3)),
            tuple(body_quat[d] for d in range(4)),
            tuple(body_v[d] for d in range(3)),
            tuple(body_w[d] for d in range(3)), friction, softness, life)


def collide_mixed_plain(prim, body_pos, body_quat, body_v, body_w, friction,
                        softness, life, x, v, dt, p_mass, push_cap=None):
    """Plain PyTorch forecast mixed contact (``contact._collide_mixed_xla``
    semantics). x, v (3, N); body_pos/v/w (3,), body_quat (4,) wxyz,
    friction, softness () and life (the remaining-window factor
    1 / (substeps - k)) tensors or floats. Returns (p_v_out (3, N),
    unmasked reaction force (3, N), mask (N,) bool)."""
    body = _mixed_body(body_pos, body_quat, body_v, body_w, friction,
                       softness, life)
    xs, vs = (x[0], x[1], x[2]), (v[0], v[1], v[2])
    p_v1, dist, rows, base = _mixed_stage1(prim, body, xs, vs)
    x_new = m33.vadd(m33.vscale(p_v1, dt), xs)
    return _mixed_stage2(prim, body, xs, vs, p_v1, x_new, dist, rows, base,
                         dt, p_mass, push_cap)


def collide_mixed1_plain(prim, body_pos, body_quat, body_v, body_w, friction,
                         softness, life, x, v, dt):
    """Stage 1 of the split mode: the (7, N) block p_v1 (rows 0-2),
    x + dt p_v1 (3-5) and dist (6) that ``collide_mixed2_plain`` reads."""
    body = _mixed_body(body_pos, body_quat, body_v, body_w, friction,
                       softness, life)
    xs = (x[0], x[1], x[2])
    p_v1, dist, _, _ = _mixed_stage1(prim, body, xs, (v[0], v[1], v[2]))
    return torch.stack([*p_v1, *(xs[d] + dt * p_v1[d] for d in range(3)),
                        dist])


def collide_mixed2_plain(prim, body_pos, body_quat, body_v, body_w, friction,
                         softness, life, x, v, st1, dt, p_mass,
                         push_cap=None):
    """Stage 2 of the split mode from stage 1's block; the stencil row is
    the one at base(x) again. Returns what ``collide_mixed_plain`` does."""
    body = _mixed_body(body_pos, body_quat, body_v, body_w, friction,
                       softness, life)
    xs = (x[0], x[1], x[2])
    qinv = m33.qnorm(m33.qconj(body[1]))
    rows, base, _ = gather_rows(prim, m33.qrot(qinv, m33.vsub(xs, body[0])))
    return _mixed_stage2(prim, body, xs, (v[0], v[1], v[2]),
                         (st1[0], st1[1], st1[2]), (st1[3], st1[4], st1[5]),
                         st1[6], rows, base, dt, p_mass, push_cap)


def wrench_plain(b_f, r, mask):
    """(6,) force and torque sums of per-point forces b_f at offsets r
    (3-tuples of tensors of one shape), where ``mask`` holds."""
    b_f = tuple(torch.where(mask, f, 0.0) for f in b_f)
    b_t = m33.cross(r, b_f)
    return torch.stack(b_f + b_t).flatten(1).sum(dim=1)


def _mixed_tail(out, x, body_pos):
    """(p_v_out, force, mask) -> (p_v_out, wrench about body_pos): the
    wrench tail (``pallas_contact._tail12`` / ``_tail``) in PyTorch."""
    p_v_out, force, mask = out
    r = m33.vsub((x[0], x[1], x[2]), (body_pos[0], body_pos[1], body_pos[2]))
    return p_v_out, wrench_plain((force[0], force[1], force[2]), r, mask)


def collide_mixed_wrench_plain(prim, body_pos, body_quat, body_v, body_w,
                               friction, softness, life, x, v, dt, p_mass,
                               push_cap=None):
    """The plain version of the tiled kernel: ``collide_mixed_plain``
    followed by the wrench tail. Returns (p_v_out (3, N), wrench (6,):
    force and torque about body_pos of the reaction forces summed over the
    particles in contact), the outputs of ``contact._collide_mixed_xla``."""
    out = collide_mixed_plain(prim, body_pos, body_quat, body_v, body_w,
                              friction, softness, life, x, v, dt, p_mass,
                              push_cap)
    return _mixed_tail(out, x, body_pos)


def _mixed_floats(body_pos, body_quat, body_v, body_w, friction, softness,
                  life):
    """The 16 body floats the mixed kernels read: bp, bq, bv, bw,
    friction, softness, life (``pallas_contact._pack_par``'s differentiable
    lanes)."""
    if not torch.is_tensor(life):
        life = torch.full((), float(life), dtype=body_pos.dtype,
                          device=body_pos.device)
    return torch.cat([body_pos, body_quat, body_v, body_w,
                      friction.reshape(1), softness.reshape(1),
                      life.reshape(1)]).contiguous()


def _check_mixed(name, prim, args, x, v):
    body = _mixed_floats(*args)
    for t in (x, v, body, prim.neighborhood):
        if t.device != x.device or t.dtype != torch.float32:
            raise TypeError(f"{name}: CUDA kernel takes float32 tensors on "
                            f"one device, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    n = x.shape[1]
    res = prim.res
    if (x.shape != (3, n) or v.shape != (3, n)
            or prim.neighborhood.shape != (res[0] * res[1] * res[2], 32)
            or prim.neighborhood.data_ptr() % 16):
        raise ValueError(f"{name}: bad shapes or table alignment")
    return body, n


def _cap(push_cap):
    return math.inf if push_cap is None else float(push_cap)


def collide_mixed1(prim, body_pos, body_quat, body_v, body_w, friction,
                   softness, life, x, v, dt):
    """Stage 1 of the split mode; see ``collide_mixed1_plain``. CUDA
    tensors launch the kernel, which keeps the block in float64 (its math
    is in double)."""
    args = (body_pos, body_quat, body_v, body_w, friction, softness, life)
    if build.on_cpu(x, "collide_mixed1"):
        return collide_mixed1_plain(prim, *args, x, v, dt)
    body, n = _check_mixed("collide_mixed1", prim, args, x, v)
    st1 = torch.empty((7, n), dtype=torch.float64, device=x.device)
    rc = build.library().softmac_collide_mixed1(
        x.data_ptr(), v.data_ptr(), prim.neighborhood.data_ptr(),
        body.data_ptr(), st1.data_ptr(), n, *prim.res, *prim.geom, float(dt),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "collide_mixed1")
    collide_mixed1.launches += 1
    return st1


def collide_mixed2(prim, body_pos, body_quat, body_v, body_w, friction,
                   softness, life, x, v, st1, dt, p_mass, push_cap=None):
    """Stage 2 of the split mode; see ``collide_mixed2_plain``. CUDA
    tensors launch the kernel."""
    args = (body_pos, body_quat, body_v, body_w, friction, softness, life)
    if build.on_cpu(x, "collide_mixed2"):
        return collide_mixed2_plain(prim, *args, x, v, st1, dt, p_mass,
                                    push_cap)
    body, n = _check_mixed("collide_mixed2", prim, args, x, v)
    if (st1.shape != (7, n) or st1.dtype != torch.float64
            or st1.device != x.device or not st1.is_contiguous()):
        raise ValueError("collide_mixed2: st1 must be collide_mixed1's "
                         "contiguous (7, N) float64 block")
    p_v_out, force, mask = _mixed_outputs(x)
    rc = build.library().softmac_collide_mixed2(
        x.data_ptr(), v.data_ptr(), prim.neighborhood.data_ptr(),
        body.data_ptr(), st1.data_ptr(), p_v_out.data_ptr(),
        force.data_ptr(), mask.data_ptr(), n, *prim.res, *prim.geom,
        float(dt), float(p_mass), _cap(push_cap),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "collide_mixed2")
    collide_mixed2.launches += 1
    return p_v_out, force, mask


def _mixed_outputs(x):
    n = x.shape[1]
    return (torch.empty((3, n), dtype=x.dtype, device=x.device),
            torch.empty((3, n), dtype=x.dtype, device=x.device),
            torch.empty((n,), dtype=torch.bool, device=x.device))


def _tiled_call(name, prim, args, x, v, check=True):
    """The pointers of a launch of the tiled kernel ``name`` (its C entry
    point without ``softmac_``): (pointers of x, v, the table and the body
    tensors (seven mixed, five penalty), N, the body tensors made
    contiguous (no copy where they are), which must outlive the launch).
    With ``check`` it checks what the kernel takes: float32 tensors on x's
    device, x and v contiguous (3, N), the body tensors of its family
    (``_TILED_BODY``), the table 16-byte aligned.
    ``CollideMixed`` and ``CollideParticle`` check in their forward only,
    and take the pointers again in their backward from the saved tensors
    (a checkpoint may have recomputed them)."""
    table = prim.neighborhood
    body = tuple(t.contiguous() for t in args)
    n = x.shape[1]
    ptrs = (x.data_ptr(), v.data_ptr(), table.data_ptr()) + tuple(
        t.data_ptr() for t in body)
    if not check:
        return ptrs, n, body
    for t in (x, v, table) + body:
        if t.device != x.device or t.dtype != torch.float32:
            raise TypeError(f"{name}: CUDA kernel takes float32 tensors on "
                            f"one device, got {t.dtype} on {t.device}")
    res = prim.res
    if (x.shape != (3, n) or v.shape != (3, n) or not x.is_contiguous()
            or not v.is_contiguous() or not table.is_contiguous()
            or tuple(t.numel() for t in body)
            != _TILED_BODY[name.removesuffix("_bwd")]
            or table.shape != (res[0] * res[1] * res[2], 32)
            or table.data_ptr() % 16):
        raise ValueError(f"{name}: bad shapes, strides or table alignment")
    return ptrs, n, body


def _done(x):
    """(the finished-block counter of the tiled kernels on x's current
    stream, the stream's handle). A launch's last block sets its counter
    back to zero, so launches that share one must not overlap: each
    stream has its own, and a stream runs its launches in order."""
    stream = torch.cuda.current_stream(x.device).cuda_stream
    key = (x.device, stream)
    if key not in _DONE:
        _DONE[key] = torch.zeros((1,), dtype=torch.int32, device=x.device)
    return _DONE[key].data_ptr(), stream


def _tiled_launch(fn, call, prim, x, dt, p_mass, *extra):
    """One launch of the tiled forward of ``fn`` (``collide_particle`` or
    ``collide_mixed``, whose count it raises) on a checked call: (the
    impulse or p_v_out (3, N), wrench (6,)). ``extra``: the C entry's
    arguments after p_mass (the mixed contact's push cap)."""
    ptrs, n, _ = call
    out = torch.empty((3, n), dtype=x.dtype, device=x.device)
    wrench = (torch.zeros if n == 0 else torch.empty)(
        (6,), dtype=x.dtype, device=x.device)
    partial = torch.empty((6, -(-n // MIXED_TILE)), dtype=torch.float64,
                          device=x.device)
    done, stream = _done(x)
    rc = getattr(build.library(), f"softmac_{fn.__name__}")(
        *ptrs, out.data_ptr(), wrench.data_ptr(), partial.data_ptr(), done,
        n, *prim.res, *prim.geom, float(dt), float(p_mass), *extra, stream)
    build.check(rc, fn.__name__)
    fn.launches += 1
    return out, wrench


def _collide_mixed(prim, body_pos, body_quat, body_v, body_w, friction,
                   softness, life, x, v, dt, p_mass, push_cap=None):
    """The merged forward with its wrench; see
    ``collide_mixed_wrench_plain``. CUDA tensors launch the tiled kernel
    (one launch: the contact, the wrench and its reduction)."""
    args = (body_pos, body_quat, body_v, body_w, friction, softness, life)
    if build.on_cpu(x, "collide_mixed"):
        return collide_mixed_wrench_plain(prim, *args, x, v, dt, p_mass,
                                          push_cap)
    return _tiled_launch(collide_mixed,
                         _tiled_call("collide_mixed", prim, args, x, v), prim,
                         x, dt, p_mass, _cap(push_cap))


def _collide_mixed_split(prim, args, x, v, dt, p_mass, push_cap):
    st1 = collide_mixed1(prim, *args, x, v, dt)
    return collide_mixed2(prim, *args, x, v, st1, dt, p_mass, push_cap), st1


def _as_tensor(life, like):
    if torch.is_tensor(life):
        return life
    return torch.full((), float(life), dtype=like.dtype, device=like.device)


def collide_mixed_vjp_plain(prim, body_pos, body_quat, body_v, body_w,
                            friction, softness, life, x, v, dt, p_mass,
                            push_cap, gout, gforce):
    """Cotangents (d body_pos, d body_quat, d body_v, d body_w, d friction,
    d softness, d life, dx, dv) of ``collide_mixed_plain``'s p_v_out and
    force for the cotangents gout, gforce (3, N): autograd of the plain
    version, recomputed."""
    with torch.enable_grad():
        ins = tuple(t.detach().requires_grad_() for t in (
            body_pos, body_quat, body_v, body_w, friction, softness,
            _as_tensor(life, x), x, v))
        out = collide_mixed_plain(prim, *ins, dt, p_mass, push_cap)
        return torch.autograd.grad(out[:2], ins, (gout, gforce))


def collide_mixed_wrench_vjp_plain(prim, body_pos, body_quat, body_v,
                                   body_w, friction, softness, life, x, v,
                                   dt, p_mass, push_cap, gout, gwrench):
    """Cotangents (d body_pos, d body_quat, d body_v, d body_w, d friction,
    d softness, d life, dx, dv) of ``collide_mixed_wrench_plain``'s p_v_out
    and wrench for the cotangents gout (3, N) and gwrench (6,): autograd of
    the plain version, recomputed."""
    with torch.enable_grad():
        ins = tuple(t.detach().requires_grad_() for t in (
            body_pos, body_quat, body_v, body_w, friction, softness,
            _as_tensor(life, x), x, v))
        out = collide_mixed_wrench_plain(prim, *ins, dt, p_mass, push_cap)
        return torch.autograd.grad(out, ins, (gout, gwrench))


def _body_cotangents(part, dtype):
    """(16, blocks) float64 per-block partials -> the seven body cotangents
    (bp, bq, bv, bw, friction, softness, life), summed in a fixed order."""
    db = part.sum(dim=1).to(dtype)
    return (db[0:3], db[3:7], db[7:10], db[10:13], db[13].reshape(()),
            db[14].reshape(()), db[15].reshape(()))


def _check_cotangents(name, x, *gs):
    for g in gs:
        if (g.shape != x.shape or g.dtype != x.dtype or g.device != x.device
                or not g.is_contiguous()):
            raise ValueError(f"{name}: cotangents must be contiguous (3, N) "
                             "tensors like x")


def _part(x, n):
    blocks = -(-n // 256)     # the kernels' block count (kThreads = 256)
    return torch.empty((16, blocks), dtype=torch.float64, device=x.device)


def _tiled_bwd_launch(fn, call, prim, x, dt, p_mass, extra, gout, gwrench):
    """One launch of the tiled backward ``fn`` (``collide_particle_bwd`` or
    ``collide_mixed_bwd``, whose count it raises) on a checked call, for
    the cotangents gout (3, N) of the forward's first output and gwrench
    (6,) of the wrench, checked here. The penalty kernel reads a None
    cotangent (a null pointer) as zero; the mixed one takes both. Returns
    the body cotangents (views of one float32 tensor, each of its body
    tensor's shape), dx and dv. ``extra`` as for ``_tiled_launch``."""
    ptrs, n, body = call
    name = fn.__name__
    if (gout is None or gwrench is None) and name != "collide_particle_bwd":
        raise ValueError(f"{name}: takes both cotangents")
    if gout is not None:
        _check_cotangents(name, x, gout)
    if gwrench is not None and (
            gwrench.shape != (6,) or gwrench.dtype != x.dtype
            or gwrench.device != x.device or not gwrench.is_contiguous()):
        raise ValueError(f"{name}: the wrench cotangent must be a "
                         "contiguous (6,) tensor like x")
    k = sum(t.numel() for t in body)
    dx = torch.empty_like(x)
    dv = torch.empty_like(x)
    db = (torch.zeros if n == 0 else torch.empty)(
        (k,), dtype=x.dtype, device=x.device)
    partial = torch.empty((k, -(-n // MIXED_BWD_TILE)), dtype=torch.float64,
                          device=x.device)
    done, stream = _done(x)
    rc = getattr(build.library(), f"softmac_{name}")(
        *ptrs, None if gout is None else gout.data_ptr(),
        None if gwrench is None else gwrench.data_ptr(), dx.data_ptr(),
        dv.data_ptr(), db.data_ptr(), partial.data_ptr(), done, n,
        *prim.res, *prim.geom, float(dt), float(p_mass), *extra, stream)
    build.check(rc, name)
    fn.launches += 1
    grads, o = [], 0
    for t in body:      # 0-d and 1-d tensors: one view each
        grads.append(db[o] if t.dim() == 0 else db[o:o + t.numel()])
        o += t.numel()
    return (*grads, dx, dv)


def collide_mixed_bwd(prim, body_pos, body_quat, body_v, body_w, friction,
                      softness, life, x, v, dt, p_mass, push_cap, gout,
                      gwrench):
    """The tiled mixed-contact backward kernel: the cotangents
    ``collide_mixed_wrench_vjp_plain`` returns for the cotangents gout (3,
    N) of p_v_out and gwrench (6,) of the wrench, on CUDA float32 tensors,
    in one launch. The body cotangents are summed in a fixed order on the
    card (block partials, then the last block over them), so they are the
    same on every run."""
    args = (body_pos, body_quat, body_v, body_w, friction, softness, life)
    call = _tiled_call("collide_mixed_bwd", prim, args, x, v)
    return _tiled_bwd_launch(collide_mixed_bwd, call, prim, x, dt, p_mass,
                             (_cap(push_cap),), gout, gwrench)


def collide_mixed2_bwd(prim, body_pos, body_quat, body_v, body_w, friction,
                       softness, life, x, v, st1, dt, p_mass, push_cap, gout,
                       gforce):
    """The split stage 2's backward kernel (k2b): (gst1, the (7, N) float64
    cotangent of stage 1's block; stage 2's share of dv (3, N); its share
    of the body cotangents as (16, blocks) float64 partials)."""
    args = (body_pos, body_quat, body_v, body_w, friction, softness, life)
    body, n = _check_mixed("collide_mixed2_bwd", prim, args, x, v)
    _check_cotangents("collide_mixed2_bwd", x, gout, gforce)
    if (st1.shape != (7, n) or st1.dtype != torch.float64
            or st1.device != x.device or not st1.is_contiguous()):
        raise ValueError("collide_mixed2_bwd: st1 must be collide_mixed1's "
                         "contiguous (7, N) float64 block")
    gst1 = torch.empty_like(st1)
    dv = torch.empty_like(x)
    part = _part(x, n)
    rc = build.library().softmac_collide_mixed2_bwd(
        x.data_ptr(), v.data_ptr(), prim.neighborhood.data_ptr(),
        body.data_ptr(), st1.data_ptr(), gout.data_ptr(), gforce.data_ptr(),
        gst1.data_ptr(), dv.data_ptr(), part.data_ptr(), n, *prim.res,
        *prim.geom, float(dt), float(p_mass), _cap(push_cap),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "collide_mixed2_bwd")
    collide_mixed2_bwd.launches += 1
    return gst1, dv, part


def collide_mixed1_bwd(prim, body_pos, body_quat, body_v, body_w, friction,
                       softness, life, x, v, gst1, dv, dt):
    """The split stage 1's backward kernel (k1b) from ``collide_mixed2_bwd``'s
    gst1 and share of dv: (dx, the whole dv, stage 1's share of the body
    cotangents as (16, blocks) float64 partials)."""
    args = (body_pos, body_quat, body_v, body_w, friction, softness, life)
    body, n = _check_mixed("collide_mixed1_bwd", prim, args, x, v)
    _check_cotangents("collide_mixed1_bwd", x, dv)
    if (gst1.shape != (7, n) or gst1.dtype != torch.float64
            or gst1.device != x.device or not gst1.is_contiguous()):
        raise ValueError("collide_mixed1_bwd: gst1 must be a contiguous "
                         "(7, N) float64 block")
    dx = torch.empty_like(x)
    dv = dv.clone()
    part = _part(x, n)
    rc = build.library().softmac_collide_mixed1_bwd(
        x.data_ptr(), v.data_ptr(), prim.neighborhood.data_ptr(),
        body.data_ptr(), gst1.data_ptr(), dx.data_ptr(), dv.data_ptr(),
        part.data_ptr(), n, *prim.res, *prim.geom, float(dt),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "collide_mixed1_bwd")
    collide_mixed1_bwd.launches += 1
    return dx, dv, part


def collide_mixed_split_bwd(prim, body_pos, body_quat, body_v, body_w,
                            friction, softness, life, x, v, st1, dt, p_mass,
                            push_cap, gout, gforce):
    """The split backward: ``collide_mixed2_bwd`` then ``collide_mixed1_bwd``,
    chained through gst1 as ``pallas_contact._fused_factory``'s _bwd chains
    k2b -> k1b. Returns what ``collide_mixed_bwd`` does."""
    args = (body_pos, body_quat, body_v, body_w, friction, softness, life)
    gst1, dv2, part2 = collide_mixed2_bwd(prim, *args, x, v, st1, dt, p_mass,
                                          push_cap, gout, gforce)
    dx, dv, part1 = collide_mixed1_bwd(prim, *args, x, v, gst1, dv2, dt)
    return _body_cotangents(torch.cat([part2, part1], dim=1), x.dtype) \
        + (dx, dv)


class CollideMixed(torch.autograd.Function):
    """Merged mixed contact with its wrench and its backward kernel
    (``pallas_contact._fused12_factory``'s custom_vjp, whose outputs are
    (p_v_out, wrench)). Outputs p_v_out (3, N) and the wrench (6,): force
    and torque about body_pos over the particles in contact. Cotangents
    reach the body tensors (so autograd routes the rigid carry's), x and
    v; the SDF table gets none. On CUDA the forward and the backward are
    one launch each, the launch's checks made in the forward only; on the
    CPU they are ``collide_mixed_wrench_plain`` and its plain vjp."""

    @staticmethod
    def forward(ctx, prim, body_pos, body_quat, body_v, body_w, friction,
                softness, life, x, v, dt, p_mass, push_cap):
        args = (body_pos, body_quat, body_v, body_w, friction, softness, life)
        out = _collide_mixed(prim, *args, x, v, dt, p_mass, push_cap)
        ctx.save_for_backward(*args, x, v)
        ctx.prim, ctx.dt, ctx.p_mass, ctx.push_cap = prim, dt, p_mass, push_cap
        return out

    @staticmethod
    def backward(ctx, gout, gwrench):
        saved = ctx.saved_tensors
        rest = (ctx.dt, ctx.p_mass, ctx.push_cap, gout.contiguous(),
                gwrench.contiguous())
        x, v = saved[7], saved[8]
        if build.on_cpu(x, "collide_mixed"):
            grads = collide_mixed_wrench_vjp_plain(ctx.prim, *saved, *rest)
        else:
            call = _tiled_call("collide_mixed_bwd", ctx.prim, saved[:7], x, v,
                               check=False)
            grads = _tiled_bwd_launch(collide_mixed_bwd, call, ctx.prim, x,
                                      ctx.dt, ctx.p_mass,
                                      (_cap(ctx.push_cap),), *rest[3:])
        return ((None,) + tuple(g if need else None for g, need in
                                zip(grads, ctx.needs_input_grad[1:10]))
                + (None, None, None))


class CollideMixedSplit(torch.autograd.Function):
    """The two-launch split of ``CollideMixed`` (``pallas_contact.
    _fused_factory``'s custom_vjp): forward ``collide_mixed1`` ->
    ``collide_mixed2``, backward ``collide_mixed2_bwd`` ->
    ``collide_mixed1_bwd`` through the (7, N) float64 block and its
    cotangent. On the CPU the split stages compute the merged function, so
    the backward there is ``collide_mixed_vjp_plain``."""

    @staticmethod
    def forward(ctx, prim, body_pos, body_quat, body_v, body_w, friction,
                softness, life, x, v, dt, p_mass, push_cap):
        args = (body_pos, body_quat, body_v, body_w, friction, softness, life)
        out, st1 = _collide_mixed_split(prim, args, x, v, dt, p_mass,
                                        push_cap)
        ctx.mark_non_differentiable(out[2])
        ctx.save_for_backward(*args, x, v, st1)
        ctx.prim, ctx.dt, ctx.p_mass, ctx.push_cap = prim, dt, p_mass, push_cap
        return out

    @staticmethod
    def backward(ctx, gout, gforce, _gmask):
        *saved, st1 = ctx.saved_tensors
        grads_in = (ctx.prim, *saved)
        rest = (ctx.dt, ctx.p_mass, ctx.push_cap, gout.contiguous(),
                gforce.contiguous())
        if build.on_cpu(saved[7], "collide_mixed"):
            grads = collide_mixed_vjp_plain(*grads_in, *rest)
        else:
            grads = collide_mixed_split_bwd(*grads_in, st1, *rest)
        return ((None,) + tuple(g if need else None for g, need in
                                zip(grads, ctx.needs_input_grad[1:10]))
                + (None, None, None))


def collide_mixed(prim, body_pos, body_quat, body_v, body_w, friction,
                  softness, life, x, v, dt, p_mass, push_cap=None):
    """Forecast mixed contact and its wrench on the body; see
    ``collide_mixed_wrench_plain``. Returns (p_v_out (3, N), wrench (6,)).
    CUDA tensors launch the tiled kernel (stages 1+2 and the wrench in one
    launch), or the two split kernels followed by the wrench's PyTorch
    reduction when ``SOFTMAC_TPU_CONTACT_SPLIT`` is set; CPU tensors run
    the plain version. Under autograd it goes through ``CollideMixed`` (or
    ``CollideMixedSplit`` and the reduction), whose backward launches the
    backward kernels on CUDA and runs the plain vjp on the CPU."""
    life = _as_tensor(life, x)
    args = (body_pos, body_quat, body_v, body_w, friction, softness, life)
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in args + (x, v))
    if _split_mode():
        out = (CollideMixedSplit.apply(prim, *args, x, v, dt, p_mass,
                                       push_cap) if grad
               else _collide_mixed_split(prim, args, x, v, dt, p_mass,
                                         push_cap)[0])
        return _mixed_tail(out, x, body_pos)
    if grad:
        return CollideMixed.apply(prim, *args, x, v, dt, p_mass, push_cap)
    return _collide_mixed(prim, *args, x, v, dt, p_mass, push_cap)


collide_mixed.launches = 0
collide_mixed1.launches = 0
collide_mixed2.launches = 0
collide_mixed_bwd.launches = 0
collide_mixed1_bwd.launches = 0
collide_mixed2_bwd.launches = 0
