"""Penalty particle contact: the CUDA kernel and its plain PyTorch version.

Counterpart of the particle-contact kernel of ``softmac_tpu/ops/pallas_contact.py``
(``_particle_math`` behind ``_particle_factory``), including the stencil-row
gather the JAX package leaves to XLA. Both versions return the masked
impulse (3, N) and the contact mask (N,); the wrench reduction is done by
the caller (``engine.contact.collide_particle``).

The plain version's SDF sample (clamped base cell, one 32-float stencil row,
trilinear sdf and normal; BIG and normal (0, 1, 0) outside the table's box)
lives here, beside the kernel it stands for, as ``_cell_index`` and
``_particle_math`` live in ``pallas_contact``. ``prim`` is an
``engine.types.SDFParams``; this module reads its fields and imports nothing
of the engine.

``collide_particle`` dispatches on the device of the particles: the CPU runs
the plain version, CUDA launches the kernel (and counts the launch),
anything else raises. Under autograd it goes through ``CollideParticle``
(the custom_vjp of ``pallas_contact._particle_factory``): cotangents reach
x, v and the 14 body floats (position, quaternion, velocity, angular
velocity, friction); the backward launches ``collide_particle_bwd`` on
CUDA and runs ``collide_particle_vjp_plain`` on the CPU. The SDF table gets
no gradient, as in the JAX package.
"""
from __future__ import annotations

import torch

from softmac_tpu_torch.ops import build, m33

BIG = 1e10
CONTACT_THRESHOLD = 5e-3
K1 = 50.0


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


def collide_particle_vjp_plain(prim, body_pos, body_quat, body_v, body_w,
                               friction, x, v, dt, p_mass, dimp):
    """Cotangents (d body_pos, d body_quat, d body_v, d body_w, d friction,
    dx, dv) of ``collide_particle_plain``'s impulse for the cotangent dimp
    (3, N): autograd of the plain version, recomputed."""
    with torch.enable_grad():
        ins = tuple(t.detach().requires_grad_() for t in
                    (body_pos, body_quat, body_v, body_w, friction, x, v))
        imp, _ = collide_particle_plain(prim, *ins, dt, p_mass)
        return torch.autograd.grad(imp, ins, dimp)


def _body_floats(body_pos, body_quat, body_v, body_w, friction):
    return torch.cat([body_pos, body_quat, body_v, body_w,
                      friction.reshape(1)]).contiguous()


def _check_cuda(name, prim, tensors, n):
    table = prim.neighborhood
    for t in tensors + (table,):
        if t.device != tensors[0].device or t.dtype != torch.float32:
            raise TypeError(f"{name}: CUDA kernel takes float32 tensors on "
                            f"one device, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if (any(t.shape != (3, n) for t in tensors[:-1])
            or tensors[-1].shape != (14,)
            or table.shape != (prim.res[0] * prim.res[1] * prim.res[2], 32)
            or table.data_ptr() % 16):
        raise ValueError(f"{name}: bad shapes or table alignment")


def _collide_particle(prim, body_pos, body_quat, body_v, body_w, friction,
                      x, v, dt, p_mass):
    kind = x.device.type
    if kind == "cpu":
        return collide_particle_plain(prim, body_pos, body_quat, body_v,
                                      body_w, friction, x, v, dt, p_mass)
    if kind != "cuda":
        raise TypeError(f"collide_particle: no implementation for {x.device}")
    n = x.shape[1]
    body = _body_floats(body_pos, body_quat, body_v, body_w, friction)
    _check_cuda("collide_particle", prim, (x, v, body), n)
    imp = torch.empty((3, n), dtype=x.dtype, device=x.device)
    mask = torch.empty((n,), dtype=torch.bool, device=x.device)
    rc = build.library().softmac_collide_particle(
        x.data_ptr(), v.data_ptr(), prim.neighborhood.data_ptr(),
        body.data_ptr(), imp.data_ptr(), mask.data_ptr(), n, *prim.res,
        *prim.geom, float(dt), float(p_mass),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "collide_particle")
    collide_particle.launches += 1
    return imp, mask


def collide_particle_bwd(prim, body_pos, body_quat, body_v, body_w, friction,
                         x, v, dt, p_mass, dimp):
    """The contact backward kernel: the cotangents
    ``collide_particle_vjp_plain`` returns, on CUDA float32 tensors. The
    body cotangent is summed in a fixed order (per-block partials, then
    ``torch.sum``), so it is the same on every run."""
    n = x.shape[1]
    body = _body_floats(body_pos, body_quat, body_v, body_w, friction)
    _check_cuda("collide_particle_bwd", prim, (x, v, dimp, body), n)
    blocks = -(-n // 256)     # the kernel's block count (kThreads = 256)
    dx = torch.empty((3, n), dtype=x.dtype, device=x.device)
    dv = torch.empty((3, n), dtype=x.dtype, device=x.device)
    part = torch.empty((14, blocks), dtype=x.dtype, device=x.device)
    rc = build.library().softmac_collide_particle_bwd(
        x.data_ptr(), v.data_ptr(), prim.neighborhood.data_ptr(),
        body.data_ptr(), dimp.data_ptr(), dx.data_ptr(), dv.data_ptr(),
        part.data_ptr(), n, *prim.res, *prim.geom, float(dt), float(p_mass),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "collide_particle_bwd")
    collide_particle_bwd.launches += 1
    db = part.sum(dim=1, dtype=torch.float64).to(x.dtype)
    return (db[0:3], db[3:7], db[7:10], db[10:13], db[13].reshape(()),
            dx, dv)


class CollideParticle(torch.autograd.Function):
    """Particle contact with its backward kernel
    (``pallas_contact._particle_factory``'s custom_vjp). Outputs the impulse
    (3, N) and the contact mask (N,), which is not differentiable."""

    @staticmethod
    def forward(ctx, prim, body_pos, body_quat, body_v, body_w, friction, x,
                v, dt, p_mass):
        imp, mask = _collide_particle(prim, body_pos, body_quat, body_v,
                                      body_w, friction, x, v, dt, p_mass)
        ctx.mark_non_differentiable(mask)
        ctx.save_for_backward(body_pos, body_quat, body_v, body_w, friction,
                              x, v)
        ctx.prim, ctx.dt, ctx.p_mass = prim, dt, p_mass
        return imp, mask

    @staticmethod
    def backward(ctx, dimp, _dmask):
        saved = ctx.saved_tensors
        vjp = (collide_particle_vjp_plain if saved[5].device.type == "cpu"
               else collide_particle_bwd)
        grads = vjp(ctx.prim, *saved, ctx.dt, ctx.p_mass, dimp.contiguous())
        return ((None,) + tuple(g if need else None for g, need in
                                zip(grads, ctx.needs_input_grad[1:8]))
                + (None, None))


def collide_particle(prim, body_pos, body_quat, body_v, body_w, friction,
                     x, v, dt, p_mass):
    """Penalty contact impulse and mask; see ``collide_particle_plain``.
    body_pos/v/w (3,), body_quat (4,) wxyz and friction () are tensors on
    the particles' device. CUDA tensors launch the kernel; under autograd
    the backward launches ``collide_particle_bwd``."""
    args = (body_pos, body_quat, body_v, body_w, friction, x, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return CollideParticle.apply(prim, *args, dt, p_mass)
    return _collide_particle(prim, *args, dt, p_mass)


collide_particle.launches = 0
collide_particle_bwd.launches = 0
