"""PyTorch port: penalty particle contact (softmac_tpu_torch.engine.contact.
collide_particle, the plain version on the CPU) against the JAX package's
XLA implementation contact._collide_particle_xla, in float64.

Two tables: a synthetic sphere SDF (the bake tests/test_pallas_contact.py
builds) and the real glass table read from assets/glass. The JAX tables are
carried into the port through softmac_tpu_torch.convert, so both sides read
the same bytes. Impulse and wrench agree to 1e-12 relative (float64 sums in
another order). Their cotangents are held against jax.vjp of the same XLA
function on the glass table, at the same tolerance."""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from softmac_tpu.engine import contact as jcontact
from softmac_tpu.engine import sdf as jsdf
from softmac_tpu.engine.meshio import load_obj
from softmac_tpu.engine.sdf import preprocess_sdf, sdf_params_from_bake

from softmac_tpu_torch import convert
from softmac_tpu_torch.engine import contact as tcontact
from softmac_tpu_torch.ops import contact as tcontact_ops

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-12


def _sphere_prim(res=10):
    lower, upper = np.zeros(3), np.ones(3)
    dx = 1.0 / (res - 1)
    g = np.stack(np.meshgrid(*[np.linspace(0, 1, res)] * 3, indexing="ij"),
                 axis=-1)
    d = np.linalg.norm(g - 0.5, axis=-1) - 0.25
    n = (g - 0.5) / np.maximum(np.linalg.norm(g - 0.5, axis=-1,
                                              keepdims=True), 1e-9)
    bake = {"res": (res, res, res), "sdf": d, "normal": n,
            "position": (lower, upper), "dx": (dx, dx, dx)}
    # table frame [0, 1]^3; particles span it and beyond
    bp = np.array([0.02, -0.03, 0.01])
    return sdf_params_from_bake(bake, jnp.float64), bp, bp + 0.5, 0.8


def _glass_prim():
    verts, faces = load_obj(ROOT / "assets/glass/glass.obj")
    bake = preprocess_sdf(verts, faces, ROOT / "assets/glass")
    # the glass origin sits near (0.7, 0.31, 0.5) in the pour scene
    bp = np.array([0.72, 0.28, 0.51])
    return sdf_params_from_bake(bake, jnp.float64), bp, bp, 0.25


def _scene(prim_fn, n=600, seed=0):
    prim, bp, center, span = prim_fn()
    rng = np.random.RandomState(seed)
    x = center[:, None] + span * (rng.rand(3, n) - 0.5)
    v = 0.5 * rng.randn(3, n)
    q = np.array([0.9, 0.1, -0.2, 0.15])
    q /= np.linalg.norm(q)
    body = dict(bp=bp, bq=q, bv=np.array([0.1, -0.2, 0.05]),
                bw=np.array([0.3, 0.1, -0.2]), friction=np.float64(10.0))
    return prim, x, v, body


@pytest.mark.parametrize("prim_fn", [_sphere_prim, _glass_prim],
                         ids=["sphere", "glass"])
def test_collide_particle_matches_jax(prim_fn):
    prim, x, v, body = _scene(prim_fn)
    kw = dict(p_mass=1.5e-5, dt=1e-3)
    imp_j, wr_j = jcontact._collide_particle_xla(
        prim, *(jnp.asarray(body[k]) for k in ("bp", "bq", "bv", "bw",
                                                 "friction")),
        tuple(jnp.asarray(x[d]) for d in range(3)),
        tuple(jnp.asarray(v[d]) for d in range(3)), **kw)

    tprim = convert.sdf_params(
        {"neighborhood": np.asarray(prim.neighborhood),
         "lower": np.asarray(prim.lower), "upper": np.asarray(prim.upper),
         "inv_dx": np.asarray(prim.inv_dx), "res": prim.res})
    t = {k: torch.as_tensor(a) for k, a in body.items()}
    imp_t, wr_t = tcontact.collide_particle(
        tprim, t["bp"], t["bq"], t["bv"], t["bw"], t["friction"],
        torch.as_tensor(x), torch.as_tensor(v), kw["dt"], kw["p_mass"])

    imp_j = np.stack([np.asarray(i) for i in imp_j])
    assert (np.abs(imp_j).sum(0) > 0).sum() > 20, "too few contacts"
    np.testing.assert_allclose(imp_t.numpy(), imp_j, rtol=RTOL,
                               atol=RTOL * np.abs(imp_j).max())
    wr_j = np.asarray(wr_j)
    np.testing.assert_allclose(wr_t.numpy(), wr_j, rtol=RTOL,
                               atol=RTOL * np.abs(wr_j).max())


def test_plain_mask_is_contact_set():
    """The plain version's second output, the mask, marks exactly the
    particles with a nonzero impulse here (no particle sits at zero impulse
    inside)."""
    prim, x, v, body = _scene(_sphere_prim, seed=3)
    tprim = convert.sdf_params(
        {"neighborhood": np.asarray(prim.neighborhood),
         "lower": np.asarray(prim.lower), "upper": np.asarray(prim.upper),
         "inv_dx": np.asarray(prim.inv_dx), "res": prim.res})
    t = {k: torch.as_tensor(a) for k, a in body.items()}
    imp, mask = tcontact_ops.collide_particle_plain(
        tprim, t["bp"], t["bq"], t["bv"], t["bw"], t["friction"],
        torch.as_tensor(x), torch.as_tensor(v), 1e-3, 1.5e-5)
    assert mask.dtype == torch.bool and mask.any()
    np.testing.assert_array_equal(mask.numpy(),
                                  (imp.abs().sum(0) > 0).numpy())


def _contact_dense_scene(seed=5, n=600):
    """The glass table with particles in a thin shell around its wall
    (|sdf| small), so that most are in contact."""
    prim, bp, center, span = _glass_prim()
    rng = np.random.RandomState(seed)
    x = center[:, None] + span * (rng.rand(3, 20 * n) - 0.5)
    q = np.array([0.9, 0.1, -0.2, 0.15])
    q /= np.linalg.norm(q)
    dist, _ = jsdf.sample_sdf_normal_world(
        prim, tuple(jnp.asarray(bp)), tuple(jnp.asarray(q)),
        tuple(jnp.asarray(x[d]) for d in range(3)))
    dist = np.asarray(dist)
    near = np.flatnonzero(np.abs(dist - 0.002) < 0.006)[:n]
    x = x[:, near]
    v = 0.5 * rng.randn(3, x.shape[1])
    body = dict(bp=bp, bq=q, bv=np.array([0.1, -0.2, 0.05]),
                bw=np.array([0.3, 0.1, -0.2]), friction=np.float64(10.0))
    return prim, x, v, body


def test_collide_particle_vjp_matches_jax():
    """Cotangents of CollideParticle plus the wrench (x, v, the body's
    position, quaternion, velocity, angular velocity and friction) against
    jax.vjp of contact._collide_particle_xla, with random cotangents on the
    impulse and the wrench, on the glass table with >= 30 % of the
    particles in contact. Tolerance 1e-12 relative."""
    prim, x, v, body = _contact_dense_scene()
    n = x.shape[1]
    kw = dict(p_mass=1.5e-5, dt=1e-3)
    keys = ("bp", "bq", "bv", "bw", "friction")
    rng = np.random.RandomState(9)
    g_imp, g_wr = rng.randn(3, n), rng.randn(6)

    def jax_fn(bp, bq, bv, bw, fr, xs, vs):
        imp, wr = jcontact._collide_particle_xla(prim, bp, bq, bv, bw, fr,
                                                 xs, vs, **kw)
        return jnp.stack(imp), wr

    jin = [jnp.asarray(body[k]) for k in keys] + [
        tuple(jnp.asarray(a[d]) for d in range(3)) for a in (x, v)]
    (imp_j, _), vjp = jax.vjp(jax_fn, *jin)
    ref = vjp((jnp.asarray(g_imp), jnp.asarray(g_wr)))
    ref = [np.asarray(r) for r in ref[:5]] + [
        np.stack([np.asarray(c) for c in r]) for r in ref[5:]]
    contacts = int((np.abs(np.asarray(imp_j)).sum(0) > 0).sum())
    assert contacts >= 0.3 * n, f"only {contacts} of {n} in contact"

    tprim = convert.sdf_params(
        {"neighborhood": np.asarray(prim.neighborhood),
         "lower": np.asarray(prim.lower), "upper": np.asarray(prim.upper),
         "inv_dx": np.asarray(prim.inv_dx), "res": prim.res})
    ins = [torch.as_tensor(np.asarray(body[k], np.float64)).requires_grad_()
           for k in keys] + [torch.as_tensor(a).requires_grad_() for a in (x, v)]
    imp_t, wr_t = tcontact.collide_particle(tprim, *ins, kw["dt"],
                                            kw["p_mass"])
    got = torch.autograd.grad((imp_t, wr_t), ins,
                              (torch.as_tensor(g_imp), torch.as_tensor(g_wr)))
    for name, g, r in zip(keys + ("x", "v"), got, ref):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), r, rtol=RTOL,
                                   atol=RTOL * np.abs(r).max(), err_msg=name)
    # the plain vjp of the impulse alone (no wrench cotangent)
    plain = tcontact_ops.collide_particle_wrench_vjp_plain(
        tprim, *(t.detach() for t in ins), kw["dt"], kw["p_mass"],
        torch.as_tensor(g_imp), None)
    _, vjp_imp = jax.vjp(lambda *a: jax_fn(*a)[0], *jin)
    ref_imp = vjp_imp(jnp.asarray(g_imp))
    ref_x = np.stack([np.asarray(c) for c in ref_imp[5]])
    np.testing.assert_allclose(plain[5].numpy(), ref_x, rtol=RTOL,
                               atol=RTOL * np.abs(ref_x).max())


def _tprim(prim):
    return convert.sdf_params(
        {"neighborhood": np.asarray(prim.neighborhood),
         "lower": np.asarray(prim.lower), "upper": np.asarray(prim.upper),
         "inv_dx": np.asarray(prim.inv_dx), "res": prim.res})


@pytest.mark.parametrize("which", ["both", "impulse", "wrench"])
def test_collide_particle_function_matches_jax(which):
    """ops.contact.CollideParticle's outputs (impulse, wrench) and their
    vjp against the JAX package's public contact.collide_particle (its XLA
    path in float64 on the CPU) and jax.vjp of it, on the glass table with
    >= 30 % of the particles in contact, random cotangents on both outputs
    or on one ("impulse", "wrench": autograd hands the Function None for
    the other, which counts as zero). Tolerance 1e-12 relative."""
    prim, x, v, body = _contact_dense_scene(seed=11)
    n = x.shape[1]
    dt, p_mass = 1e-3, 1.5e-5
    keys = ("bp", "bq", "bv", "bw", "friction")
    rng = np.random.RandomState(12)
    g_imp = rng.randn(3, n) * (which != "wrench")
    g_wr = rng.randn(6) * (which != "impulse")

    def jax_fn(bp, bq, bv, bw, fr, xs, vs):
        imp, wr = jcontact.collide_particle(prim, bp, bq, bv, bw, fr, xs, vs,
                                            dt, p_mass)
        return jnp.stack(imp), wr

    jin = [jnp.asarray(body[k]) for k in keys] + [
        tuple(jnp.asarray(a[d]) for d in range(3)) for a in (x, v)]
    (imp_j, wr_j), vjp = jax.vjp(jax_fn, *jin)
    ref = vjp((jnp.asarray(g_imp), jnp.asarray(g_wr)))
    ref = [np.asarray(r) for r in ref[:5]] + [
        np.stack([np.asarray(c) for c in r]) for r in ref[5:]]

    ins = [torch.as_tensor(np.asarray(body[k], np.float64)).requires_grad_()
           for k in keys] + [torch.as_tensor(a).requires_grad_() for a in (x, v)]
    imp_t, wr_t = tcontact_ops.CollideParticle.apply(_tprim(prim), *ins, dt,
                                                     p_mass)
    for got, want in ((imp_t, np.asarray(imp_j)), (wr_t, np.asarray(wr_j))):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())
    outs = {"both": ((imp_t, wr_t), (g_imp, g_wr)),
            "impulse": ((imp_t,), (g_imp,)),
            "wrench": ((wr_t,), (g_wr,))}[which]
    got = torch.autograd.grad(outs[0], ins,
                              tuple(torch.as_tensor(g) for g in outs[1]))
    for name, g, r in zip(keys + ("x", "v"), got, ref):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), r, rtol=RTOL,
                                   atol=RTOL * np.abs(r).max(), err_msg=name)
    # the plain vjp with None for the missing cotangent is the same
    plain = tcontact_ops.collide_particle_wrench_vjp_plain(
        _tprim(prim), *(t.detach() for t in ins), dt, p_mass,
        None if which == "wrench" else torch.as_tensor(g_imp),
        None if which == "impulse" else torch.as_tensor(g_wr))
    for g, p in zip(got, plain):
        assert torch.equal(g, p)


def _parent_collide_particle(prim, body_pos, body_quat, body_v, body_w,
                             friction, x, p_v, dt, p_mass):
    """engine.contact.collide_particle as it was before the wrench moved
    into ops.contact: the plain impulse and mask, then the eager tail."""
    from softmac_tpu_torch.ops import m33
    imp, mask = tcontact_ops.collide_particle_plain(
        prim, body_pos, body_quat, body_v, body_w, friction, x, p_v, dt,
        p_mass)
    b_f = (imp[0] * (-1.0 / dt), imp[1] * (-1.0 / dt), imp[2] * (-1.0 / dt))
    r = m33.vsub((x[0], x[1], x[2]), (body_pos[0], body_pos[1], body_pos[2]))
    return imp, tcontact_ops.wrench_plain(b_f, r, mask)


def test_pour_vel_wrenches_match_parent(monkeypatch):
    """The pour_vel rollout on the CPU (400 particles, float64, 5 env
    steps): every call of the particle contact returns, bit for bit, the
    impulse and wrench of the eager tail it replaced, on the inputs the
    rollout gave it; the glass's wrench is nonzero in some substep."""
    from softmac_tpu_torch import SoftMacEnv
    from softmac_tpu_torch import load
    from softmac_tpu_torch.engine import mpm as tmpm
    cfg = load(str(ROOT / "softmac_tpu_torch/config/demo_pour_vel_config.py"))
    cfg.defrost()
    cfg.TPU.active_window = (48, 32, 16)
    cfg.freeze()
    base = np.load(ROOT / "envs/pour/pour_mpm_init_state_corotated.npy")
    pick = np.random.RandomState(3).choice(base.shape[0], 400, replace=False)
    env = SoftMacEnv(cfg, device="cpu",
                     init_particles=base[pick, :3] + np.array([0, 0.04, 0]))
    calls = []
    inner = tmpm.contact_mod.collide_particle

    def record(*args):
        out = inner(*args)
        calls.append((args, out))
        return out
    monkeypatch.setattr(tmpm.contact_mod, "collide_particle", record)
    env.rollout(np.random.RandomState(7).randn(5, 12) * 0.05)
    assert len(calls) == 5 * env.substeps * env.n_primitives
    for args, (imp, wr) in calls:
        imp_p, wr_p = _parent_collide_particle(*args)
        assert torch.equal(imp, imp_p) and torch.equal(wr, wr_p)
    assert max(out[1].abs().max().item() for _, out in calls[::2]) > 0.0


def test_tiled_wrappers_check_their_family():
    """The tiled kernels' wrappers take the body tensors of their own family
    only (five penalty, seven mixed) and refuse, before any launch, the
    other family's layout and a missing cotangent, which only the penalty
    backward reads as zero."""
    class Prim:
        res = (4, 4, 4)
        neighborhood = torch.zeros((64, 32))
    x, v = torch.zeros((3, 8)), torch.zeros((3, 8))
    five = (torch.zeros(3), torch.zeros(4), torch.zeros(3), torch.zeros(3),
            torch.zeros(()))
    seven = five + (torch.zeros(()), torch.zeros(()))
    for name, own, other in (("collide_particle", five, seven),
                             ("collide_mixed", seven, five)):
        for kernel in (name, name + "_bwd"):
            tcontact_ops._tiled_call(kernel, Prim, own, x, v)
            with pytest.raises(ValueError, match="bad shapes"):
                tcontact_ops._tiled_call(kernel, Prim, other, x, v)
    call = tcontact_ops._tiled_call("collide_mixed_bwd", Prim, seven, x, v)
    for gout, gwrench in ((None, torch.zeros(6)), (torch.zeros_like(x), None)):
        with pytest.raises(ValueError, match="both cotangents"):
            tcontact_ops._tiled_bwd_launch(
                tcontact_ops.collide_mixed_bwd, call, Prim, x, 1e-3, 1e-5,
                (float("inf"),), gout, gwrench)
