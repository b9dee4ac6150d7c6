"""PyTorch port: forecast mixed contact (softmac_tpu_torch.ops.contact.
collide_mixed_plain and engine.contact.collide_mixed, the plain version on
the CPU) against the JAX package's XLA implementation
contact._collide_mixed_xla and the NumPy oracle tests/oracle.py
oracle_collide_mixed, in float64.

The glass and bowl tables are read from assets and carried into the port
through softmac_tpu_torch.convert, so both sides read the same bytes. 3000
seeded particles spread over each body's SDF box, posed with a quaternion
slightly off unit length, with velocities of up to a few m/s: particles
approach and recede, lie inside the threshold's soft band, penetrate, and
forecast across a table cell's face (each case counted). push_cap is None
(the reference's uncapped push-out) or finite. Velocity and wrench agree to
1e-12 of their largest |value| (float64 sums in another order); the split
stages (mixed1 -> mixed2) give exactly what the merged function gives.
Cotangents of the plain version (autograd) are held against jax.vjp of the
XLA function at the same tolerance: the yardstick for the backward kernels
that come with the next slice."""
import sys
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
from softmac_tpu_torch.ops import contact as ops
from softmac_tpu_torch.ops import m33

sys.path.insert(0, str(Path(__file__).resolve().parent))
from oracle import oracle_collide_mixed  # noqa: E402
from test_oracle_coupled import oracle_prim_of  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-12
N = 3000
DT, P_MASS, LIFE = 1e-3, 1.5e-5, 0.5
# (position, quaternion direction, body-frame v, w, friction) per body
POSES = {
    "glass": ([0.72, 0.28, 0.51], [0.9, 0.1, -0.2, 0.15], [0.1, -0.2, 0.05],
              [0.3, 0.1, -0.2], 0.1),
    "bowl": ([0.34, 0.13, 0.5], [0.95, -0.05, 0.2, 0.1], [-0.05, 0.1, 0.2],
             [0.1, -0.3, 0.2], 1.0),
}


@pytest.fixture(scope="module", params=sorted(POSES))
def scene(request):
    name = request.param
    verts, faces = load_obj(str(ROOT / f"assets/{name}/{name}.obj"))
    jprim = sdf_params_from_bake(
        preprocess_sdf(verts, faces, ROOT / f"assets/{name}"), jnp.float64)
    tprim = convert.sdf_params({k: getattr(jprim, k) for k in (
        "neighborhood", "lower", "upper", "inv_dx", "res")})
    pos, qdir, bv, bw, friction = POSES[name]
    q = np.asarray(qdir) * 1.001 / np.linalg.norm(qdir)   # |q| slightly off 1
    rng = np.random.RandomState(3)
    lo, up = np.asarray(jprim.lower), np.asarray(jprim.upper)
    p_loc = lo[:, None] + (up - lo)[:, None] * rng.rand(3, N)
    qn = q / np.linalg.norm(q)
    x = np.stack([np.asarray(c) for c in m33.qrot(
        tuple(torch.as_tensor(qn)), tuple(torch.as_tensor(p_loc)))])
    x = x + np.asarray(pos)[:, None]
    v = 1.5 * rng.randn(3, N)
    body = [np.asarray(a, np.float64) for a in (pos, q, bv, bw)] + [
        np.float64(friction), np.float64(666.0)]
    return name, jprim, tprim, x, v, body


def _tbody(body):
    return tuple(torch.as_tensor(b) for b in body)


def _close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=RTOL * max(np.abs(ref).max(), 1e-300))


def _jax_mixed(jprim, body, x, v, push_cap):
    return jcontact._collide_mixed_xla(
        jprim, *(jnp.asarray(b) for b in body), tuple(jnp.asarray(x)),
        tuple(jnp.asarray(v)), jnp.asarray(LIFE), p_mass=P_MASS, dt=DT,
        push_cap=push_cap)


@pytest.mark.parametrize("push_cap", [None, 2.0])
def test_collide_mixed_plain_matches_jax_and_oracle(scene, push_cap):
    name, jprim, tprim, x, v, body = scene
    tb = _tbody(body)
    tx, tv = torch.as_tensor(x), torch.as_tensor(v)
    pv, force, mask = ops.collide_mixed_plain(tprim, *tb, LIFE, tx, tv, DT,
                                              P_MASS, push_cap)
    pv_e, wrench = tcontact.collide_mixed(tprim, *tb, tx, tv, P_MASS, DT,
                                          LIFE, push_cap=push_cap)
    assert torch.equal(pv, pv_e)

    jpv, jwrench = _jax_mixed(jprim, body, x, v, push_cap)
    _close(pv.numpy(), np.stack([np.asarray(c) for c in jpv]))
    _close(wrench.numpy(), np.asarray(jwrench))
    # the unmasked force is (v - p_v_out) p_mass / dt wherever it is nonzero
    _close(force.numpy(), (v - pv.numpy()) * (P_MASS / DT))

    cap = np.inf if push_cap is None else push_cap
    ov, owrench = oracle_collide_mixed(
        oracle_prim_of(jprim), *body, x.T, v.T, P_MASS, DT, LIFE,
        push_cap=cap)
    _close(pv.numpy(), ov.T)
    _close(wrench.numpy(), owrench)

    # every branch of the contact occurs
    st1 = ops.collide_mixed1_plain(tprim, *tb, LIFE, tx, tv, DT)
    qinv = m33.qnorm(m33.qconj(tuple(tb[1])))

    def cell(p):
        return ops.cell_index(tprim, m33.qrot(qinv, m33.vsub(
            tuple(p), tuple(tb[0]))))[0]

    sdf2, _ = ops.sample_sdf_normal_world(tprim, tuple(tb[0]), tuple(tb[1]),
                                          tuple(st1[3:6]))
    moved = (st1[0:3] != tv).any(dim=0)
    counts = {"approaching": int((mask & moved).sum()),
              "receding": int((mask & ~moved).sum()),
              "soft": int((mask & (st1[6] > 0)).sum()),
              "penetrating": int((mask & (sdf2 < 0)).sum()),
              "face-crossing": int((mask & (cell(tx) != cell(st1[3:6]))).sum())}
    assert min(counts.values()) >= 20, (name, counts)
    if push_cap is not None:
        # the cap binds; the push runs along the normal rotated by the raw
        # quaternion, |n2| = |q|^2
        speed = float(((pv - st1[0:3]) * mask).norm(dim=0).max())
        assert push_cap * 0.999 < speed <= push_cap * 1.001 ** 2 * (1 + 1e-12)


def test_forecast_fx_matches_jax(scene):
    _, jprim, tprim, x, _, _ = scene
    p = tuple(torch.as_tensor(x[:, :50]))
    base = (torch.as_tensor(np.arange(50) % 7, dtype=torch.float64),) * 3
    got = ops.forecast_fx(tprim, base, p)
    ref = jsdf.forecast_fx(jprim, tuple(jnp.asarray(b) for b in base),
                           tuple(jnp.asarray(c) for c in p))
    for g, r in zip(got, ref):
        _close(g.numpy(), r)


def test_split_stages_equal_merged(scene, monkeypatch):
    _, _, tprim, x, v, body = scene
    tb = _tbody(body)
    tx, tv = torch.as_tensor(x), torch.as_tensor(v)
    merged = ops.collide_mixed_plain(tprim, *tb, LIFE, tx, tv, DT, P_MASS)
    st1 = ops.collide_mixed1_plain(tprim, *tb, LIFE, tx, tv, DT)
    assert st1.shape == (7, N)
    split = ops.collide_mixed2_plain(tprim, *tb, LIFE, tx, tv, st1, DT,
                                     P_MASS)
    for a, b in zip(merged, split):
        assert torch.equal(a, b)
    # collide_mixed returns (p_v_out, wrench) on both paths: the split
    # stages' wrench is the same reduction of the same forces
    monkeypatch.setenv("SOFTMAC_TPU_CONTACT_SPLIT", "yes")
    through = ops.collide_mixed(tprim, *tb, LIFE, tx, tv, DT, P_MASS)
    want = ops.collide_mixed_wrench_plain(tprim, *tb, LIFE, tx, tv, DT,
                                          P_MASS)
    assert torch.equal(through[0], merged[0])
    assert torch.equal(through[0], want[0]) and torch.equal(through[1],
                                                            want[1])


def test_collide_mixed_vjp_matches_jax(scene):
    """Autograd of the plain version against jax.vjp of the XLA function:
    cotangents of x, v and the body floats for seeded cotangents of the
    velocity and the wrench."""
    _, jprim, tprim, x, v, body = scene
    rng = np.random.RandomState(9)
    g_v, g_w = rng.randn(3, N), rng.randn(6)

    def jfn(bp, bq, bv, bw, fr, so, xs, vs):
        pv, wr = jcontact._collide_mixed_xla(
            jprim, bp, bq, bv, bw, fr, so, xs, vs, jnp.asarray(LIFE),
            p_mass=P_MASS, dt=DT)
        return jnp.stack(pv), wr

    jins = tuple(jnp.asarray(b) for b in body) + (
        tuple(jnp.asarray(x)), tuple(jnp.asarray(v)))
    _, vjp = jax.vjp(jfn, *jins)
    ref = vjp((jnp.asarray(g_v), jnp.asarray(g_w)))
    ref = [np.asarray(r) for r in ref[:6]] + [
        np.stack([np.asarray(c) for c in r]) for r in ref[6:]]

    ins = [torch.as_tensor(a).requires_grad_()
           for a in body + [x, v]]
    pv, wr = tcontact.collide_mixed(tprim, *ins[:6], ins[6], ins[7], P_MASS,
                                    DT, LIFE)
    grads = torch.autograd.grad(
        (pv, wr), ins, (torch.as_tensor(g_v), torch.as_tensor(g_w)))
    assert np.abs(ref[6]).max() > 0 and np.abs(ref[1]).max() > 0
    for got, want in zip(grads, ref):
        _close(got.numpy(), want)


def _mixed_grads(tprim, body, x, v, g_v, g_w, push_cap=None):
    """Cotangents of x, v and the body floats through engine.contact.
    collide_mixed (the CollideMixed / CollideMixedSplit Function under
    autograd) for cotangents of the velocity and the wrench."""
    ins = [torch.as_tensor(a).requires_grad_() for a in body + [x, v]]
    pv, wr = tcontact.collide_mixed(tprim, *ins[:6], ins[6], ins[7], P_MASS,
                                    DT, LIFE, push_cap=push_cap)
    return torch.autograd.grad((pv, wr), ins, (torch.as_tensor(g_v),
                                               torch.as_tensor(g_w)))


@pytest.mark.parametrize("push_cap", [None, 2.0])
def test_split_function_cotangents_equal_merged(scene, monkeypatch,
                                                push_cap):
    """The CollideMixedSplit Function (stage 1 -> stage 2, its backward the
    split plain vjp on the CPU) gives the merged Function's cotangents, and
    both give jax.vjp's of the XLA function (1e-12)."""
    _, jprim, tprim, x, v, body = scene
    rng = np.random.RandomState(10)
    g_v, g_w = rng.randn(3, N), rng.randn(6)
    merged = _mixed_grads(tprim, body, x, v, g_v, g_w, push_cap)
    monkeypatch.setenv("SOFTMAC_TPU_CONTACT_SPLIT", "1")
    split = _mixed_grads(tprim, body, x, v, g_v, g_w, push_cap)
    for a, b in zip(merged, split):
        _close(b.numpy(), a.numpy())

    def jfn(bp, bq, bv, bw, fr, so, xs, vs):
        pv, wr = jcontact._collide_mixed_xla(
            jprim, bp, bq, bv, bw, fr, so, xs, vs, jnp.asarray(LIFE),
            p_mass=P_MASS, dt=DT, push_cap=push_cap)
        return jnp.stack(pv), wr

    _, vjp = jax.vjp(jfn, *(jnp.asarray(b) for b in body),
                     tuple(jnp.asarray(x)), tuple(jnp.asarray(v)))
    ref = vjp((jnp.asarray(g_v), jnp.asarray(g_w)))
    ref = [np.asarray(r) for r in ref[:6]] + [
        np.stack([np.asarray(c) for c in r]) for r in ref[6:]]
    for got, want in zip(split, ref):
        _close(got.numpy(), want)


@pytest.mark.parametrize("split", ["", "1"])
def test_mixed_functions_gradcheck(scene, monkeypatch, split):
    """torch.autograd.gradcheck of CollideMixed and CollideMixedSplit (their
    backward the plain vjp on the CPU) on 50 of the scene's particles, with
    respect to the 16 body floats (life included), x and v."""
    _, _, tprim, x, v, body = scene
    monkeypatch.setenv("SOFTMAC_TPU_CONTACT_SPLIT", split)
    fn = ops.CollideMixedSplit if split else ops.CollideMixed
    pick = slice(0, 50)
    ins = tuple(torch.as_tensor(a).requires_grad_() for a in body + [
        np.float64(LIFE), x[:, pick].copy(), v[:, pick].copy()])

    def f(*a):
        return fn.apply(tprim, *a, DT, P_MASS, None)[:2]
    assert torch.autograd.gradcheck(f, ins, eps=1e-7, atol=1e-6, rtol=1e-5,
                                    fast_mode=True)
