"""PyTorch port: the mixed-contact Function with its wrench
(softmac_tpu_torch.ops.contact.CollideMixed, whose outputs are those of the
JAX package's custom_vjp: p_v_out and the wrench on the body) and its plain
version collide_mixed_wrench_plain, against the JAX package's
contact.collide_mixed (its XLA implementation on the CPU) and jax.vjp of
it, in float64.

The glass and the bowl, each posed with a quaternion slightly off unit
length, with 1000 seeded particles spread over its SDF box and velocities
of up to a few m/s (particles in contact, in the soft band and
penetrating); push_cap None (the reference's uncapped push-out) or
finite. Velocity, wrench and every cotangent (the 16 body floats, x and v,
for seeded cotangents of the velocity and the wrench) agree to 1e-12 of
their largest |value| (float64 sums in another order). On the CPU the
Function's backward is the plain version's autograd; gradcheck holds it on
a few particles."""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from softmac_tpu.engine import contact as jcontact
from softmac_tpu.engine.meshio import load_obj
from softmac_tpu.engine.sdf import preprocess_sdf, sdf_params_from_bake

from softmac_tpu_torch import convert
from softmac_tpu_torch.ops import contact as ops
from softmac_tpu_torch.ops import m33

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-12
N = 1000
DT, P_MASS, LIFE = 1e-3, 1.5e-5, 0.25
# (position, quaternion direction, body-frame v, w, friction, softness)
POSES = {
    "glass": ([0.6, 0.3, 0.45], [0.95, -0.1, 0.15, 0.2], [0.2, 0.1, -0.1],
              [-0.2, 0.3, 0.1], 0.3, 500.0),
    "bowl": ([0.4, 0.2, 0.55], [0.9, 0.2, -0.1, -0.15], [-0.1, 0.05, 0.1],
             [0.2, -0.1, 0.3], 0.8, 800.0),
}


@pytest.fixture(scope="module", params=sorted(POSES))
def scene(request):
    name = request.param
    verts, faces = load_obj(str(ROOT / f"assets/{name}/{name}.obj"))
    jprim = sdf_params_from_bake(
        preprocess_sdf(verts, faces, ROOT / f"assets/{name}"), jnp.float64)
    tprim = convert.sdf_params({k: getattr(jprim, k) for k in (
        "neighborhood", "lower", "upper", "inv_dx", "res")})
    pos, qdir, bv, bw, friction, softness = POSES[name]
    q = np.asarray(qdir) * 0.999 / np.linalg.norm(qdir)
    rng = np.random.RandomState(11)
    lo, up = np.asarray(jprim.lower), np.asarray(jprim.upper)
    p_loc = lo[:, None] + (up - lo)[:, None] * rng.rand(3, N)
    qn = q / np.linalg.norm(q)
    x = np.stack([np.asarray(c) for c in m33.qrot(
        tuple(torch.as_tensor(qn)), tuple(torch.as_tensor(p_loc)))])
    x = x + np.asarray(pos)[:, None]
    v = 2.0 * rng.randn(3, N)
    body = [np.asarray(a, np.float64) for a in (pos, q, bv, bw)] + [
        np.float64(friction), np.float64(softness), np.float64(LIFE)]
    return name, jprim, tprim, x, v, body


def _close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=RTOL * max(np.abs(ref).max(), 1e-300))


def _jax_fn(jprim, push_cap):
    def fn(bp, bq, bv, bw, fr, so, life, xs, vs):
        pv, wr = jcontact.collide_mixed(
            jprim, bp, bq, bv, bw, fr, so, tuple(xs), tuple(vs), P_MASS, DT,
            life, push_cap=push_cap)
        return jnp.stack(pv), wr
    return fn


def _jax_ins(body, x, v):
    return tuple(jnp.asarray(b) for b in body) + (jnp.asarray(x),
                                                  jnp.asarray(v))


@pytest.mark.parametrize("push_cap", [None, 1.5])
def test_collide_mixed_matches_jax(scene, push_cap):
    """p_v_out and the wrench: the Function, collide_mixed without
    autograd and the plain version against contact.collide_mixed."""
    name, jprim, tprim, x, v, body = scene
    jpv, jwr = _jax_fn(jprim, push_cap)(*_jax_ins(body, x, v))
    ins = [torch.as_tensor(a) for a in body + [x, v]]
    plain = ops.collide_mixed_wrench_plain(tprim, *ins, DT, P_MASS, push_cap)
    direct = ops.collide_mixed(tprim, *ins, DT, P_MASS, push_cap)
    req = [t.clone().requires_grad_() for t in ins]
    through = ops.CollideMixed.apply(tprim, *req, DT, P_MASS, push_cap)
    for pv, wr in (plain, direct, through):
        assert pv.shape == (3, N) and wr.shape == (6,)
        _close(pv.detach().numpy(), jpv)
        _close(wr.detach().numpy(), jwr)
    # the scene has contacts, and they push the body
    mask = ops.collide_mixed_plain(tprim, *ins, DT, P_MASS, push_cap)[2]
    assert int(mask.sum()) > 100, (name, int(mask.sum()))
    assert float(np.abs(np.asarray(jwr)).min()) > 0


@pytest.mark.parametrize("push_cap", [None, 1.5])
def test_collide_mixed_vjp_matches_jax(scene, push_cap):
    """The cotangents of the 16 body floats, x and v through CollideMixed
    (its backward the plain vjp on the CPU) against jax.vjp of
    contact.collide_mixed, for seeded cotangents of the velocity and the
    wrench."""
    _, jprim, tprim, x, v, body = scene
    rng = np.random.RandomState(12)
    g_v, g_w = rng.randn(3, N), rng.randn(6)
    _, vjp = jax.vjp(_jax_fn(jprim, push_cap), *_jax_ins(body, x, v))
    ref = vjp((jnp.asarray(g_v), jnp.asarray(g_w)))
    ins = [torch.as_tensor(a).requires_grad_() for a in body + [x, v]]
    out = ops.CollideMixed.apply(tprim, *ins, DT, P_MASS, push_cap)
    grads = torch.autograd.grad(out, ins, (torch.as_tensor(g_v),
                                           torch.as_tensor(g_w)))
    plain = ops.collide_mixed_wrench_vjp_plain(
        tprim, *(t.detach() for t in ins), DT, P_MASS, push_cap,
        torch.as_tensor(g_v), torch.as_tensor(g_w))
    for got, alt, want in zip(grads, plain, ref):
        assert np.abs(np.asarray(want)).max() > 0
        _close(got.numpy(), want)
        _close(alt.numpy(), want)


def test_collide_mixed_gradcheck(scene):
    """torch.autograd.gradcheck of CollideMixed (p_v_out and the wrench)
    on 40 of the scene's particles, with respect to the 16 body floats, x
    and v."""
    _, _, tprim, x, v, body = scene
    pick = slice(0, 40)
    ins = tuple(torch.as_tensor(a).requires_grad_() for a in body + [
        x[:, pick].copy(), v[:, pick].copy()])

    def f(*a):
        return ops.CollideMixed.apply(tprim, *a, DT, P_MASS, 1.5)
    assert torch.autograd.gradcheck(f, ins, eps=1e-7, atol=1e-6, rtol=1e-5,
                                    fast_mode=True)
