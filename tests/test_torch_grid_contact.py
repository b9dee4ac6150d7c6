"""PyTorch port: grid contact (collision_type 0; softmac_tpu_torch.engine.
contact.collide_grid and the CONTACT_GRID branch of engine.mpm.substep)
against the JAX package in float64 on the CPU.

The glass table is read from assets and carried into the port through
softmac_tpu_torch.convert, so both sides read the same bytes.
- collide_grid on a (40, 100) block of nodes spread over the glass's SDF
  box, posed with a quaternion slightly off unit length and a moving,
  spinning body: nodes inside the glass, in its soft band and outside
  (each kind counted). Velocities and wrench within 1e-12 of their largest
  |value|, and the cotangents of every input (body pose and velocities,
  friction, softness, node velocities and masses) against jax.vjp of
  contact.collide_grid at the same tolerance.
- One CONTACT_GRID substep of the flagship pour's liquid (300 particles
  of its initial state, seeded velocities) against the glass on the full
  64^3 grid (the dense route; the glass needs the pour's own grid spacing
  for its walls to meet nodes) against JAX mpm.substep: the state and the
  wrench within 1e-10, the wrench nonzero.
- The pour scene with SIMULATOR.collision_type 0 and no window runs
  through SoftMacEnv.rollout on the CPU.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from softmac_tpu.engine import contact as jcontact
from softmac_tpu.engine import mpm as jmpm
from softmac_tpu.engine import types as jtypes
from softmac_tpu.engine.materials import lame_parameters
from softmac_tpu.engine.meshio import load_obj
from softmac_tpu.engine.sdf import preprocess_sdf, sdf_params_from_bake

import softmac_tpu_torch
from softmac_tpu_torch import SoftMacEnv, convert
from softmac_tpu_torch.engine import contact as tcontact
from softmac_tpu_torch.engine import mpm as tmpm
from softmac_tpu_torch.engine import types as ttypes
from softmac_tpu_torch.ops import contact as ops
from softmac_tpu_torch.ops import m33

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
POS = [0.7, 0.31, 0.5]
QDIR = [0.9, 0.1, -0.2, 0.15]
BV, BW = [0.1, -0.2, 0.05], [0.3, 0.1, -0.2]
FRICTION, SOFTNESS, DT = 0.1, 666.0, 1e-3


@pytest.fixture(scope="module")
def glass():
    verts, faces = load_obj(str(ROOT / "assets/glass/glass.obj"))
    jprim = sdf_params_from_bake(
        preprocess_sdf(verts, faces, ROOT / "assets/glass"), jnp.float64)
    tprim = convert.sdf_params({k: getattr(jprim, k) for k in (
        "neighborhood", "lower", "upper", "inv_dx", "res")})
    return jprim, tprim


def _close(got, ref, rtol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


def _body():
    q = np.asarray(QDIR) * 1.001 / np.linalg.norm(QDIR)
    return [np.asarray(a, np.float64) for a in (POS, q, BV, BW)] + [
        np.float64(FRICTION), np.float64(SOFTNESS)]


def test_collide_grid_matches_jax(glass):
    jprim, tprim = glass
    rng = np.random.RandomState(3)
    shape = (40, 100)
    lo, up = np.asarray(jprim.lower), np.asarray(jprim.upper)
    p_loc = lo[:, None] + (up - lo)[:, None] * rng.rand(3, np.prod(shape))
    body = _body()
    qn = body[1] / np.linalg.norm(body[1])
    pos = np.stack([np.asarray(c) for c in m33.qrot(
        tuple(torch.as_tensor(qn)), tuple(torch.as_tensor(p_loc)))])
    pos = (pos + body[0][:, None]).reshape((3,) + shape)
    v = 1.5 * rng.randn(3, *shape)
    m = 1e-5 * (0.5 + rng.rand(*shape))

    dist, _ = ops.sample_sdf_normal_world(
        tprim, tuple(torch.as_tensor(body[0])),
        tuple(torch.as_tensor(body[1])), tuple(torch.as_tensor(pos)))
    dist = dist.numpy()
    soft = (dist > 0) & (np.exp(-dist * SOFTNESS) > 0.1)
    counts = {"inside": int((dist <= 0).sum()), "soft": int(soft.sum()),
              "outside": int(((dist > 0) & ~soft).sum())}
    assert min(counts.values()) > 100, counts

    def jfn(bp, bq, bv, bw, fr, so, v0, v1, v2, gm):
        vo, wr = jcontact.collide_grid(
            jprim, bp, bq, bv, bw, fr, so, tuple(jnp.asarray(pos)),
            (v0, v1, v2), DT, gm)
        return jnp.stack(vo), wr

    ins = body + [v[0], v[1], v[2], m]
    cv, cw = rng.randn(3, *shape), rng.randn(6)

    @jax.jit
    def jvjp(*a):
        out, vjp = jax.vjp(jfn, *a)
        return out, vjp((jnp.asarray(cv), jnp.asarray(cw)))
    (jv, jwr), ref = jvjp(*(jnp.asarray(a) for a in ins))
    tins = [torch.tensor(a, requires_grad=True) for a in ins]
    tv, twr = tcontact.collide_grid(
        tprim, *tins[:6], tuple(torch.as_tensor(pos)), tuple(tins[6:9]), DT,
        tins[9])
    tv = torch.stack(tv)
    _close(tv.detach(), jv, 1e-12)
    _close(twr.detach(), jwr, 1e-12)
    assert torch.equal(tv.detach()[:, dist > 0.01], torch.as_tensor(v)[
        :, dist > 0.01]), "far nodes keep their velocity"

    got = torch.autograd.grad((tv, twr), tins,
                              (torch.as_tensor(cv), torch.as_tensor(cw)))
    for g, r in zip(got, ref):
        _close(g, r, 1e-12)


def _pour_particles(n):
    return np.load(ROOT / "envs/pour/pour_mpm_init_state_corotated.npy")[
        :n, :3] + np.array([0.0, 0.04, 0.0])


def test_grid_contact_substep_matches_jax(glass):
    jprim, tprim = glass
    n = 300
    rng = np.random.RandomState(8)
    x = _pour_particles(n).T
    v = 0.5 * rng.randn(3, n)
    C = 2.0 * rng.randn(3, 3, n)
    F = np.eye(3)[:, :, None] + 0.01 * rng.randn(3, 3, n)
    kw = dict(n_particles=n, n_grid=64, dt=DT, substeps=1,
              material_model=ttypes.MODEL_COROTATED, ptype=ttypes.MAT_LIQUID,
              collision_type=ttypes.CONTACT_GRID, ground_friction=0.0,
              n_primitives=1, primitives_contact=(True,))
    jcfg = jtypes.MPMConfig(**kw, dtype=jnp.float64)
    tcfg = ttypes.MPMConfig(**kw, dtype=torch.float64)
    assert tmpm.transfer_route(tcfg) == "dense"
    mu, lam = lame_parameters(22.0, 0.2, ttypes.MAT_LIQUID)
    body = _body()
    pp = dict(mu=np.full(n, mu), lam=np.full(n, lam),
              yield_stress=np.full(n, 50.0), gravity=np.array([0, -9.8, 0.0]),
              friction=np.array([FRICTION]), softness=np.array([SOFTNESS]))
    jparams = jtypes.MPMParams(**{k: jnp.asarray(a) for k, a in pp.items()},
                               control_idx=jnp.full((n,), -1, jnp.int32))
    tparams = ttypes.MPMParams(
        **{k: torch.as_tensor(a) for k, a in pp.items()},
        control_idx=torch.full((n,), -1, dtype=torch.int32))
    bk = dict(pos=body[0][None], quat=body[1][None], v=body[2][None],
              w=body[3][None])
    st = dict(x=x, v=v, C=C, F=F)
    jnew, jext, _ = jax.jit(
        lambda s, b: jmpm.substep(jcfg, jparams, (jprim,), s, b, 0))(
        jtypes.MPMState(**{k: jnp.asarray(a) for k, a in st.items()}),
        jtypes.BodyState(**{k: jnp.asarray(a) for k, a in bk.items()}))
    tnew, text, aux = tmpm.substep(
        tcfg, tparams, (tprim,),
        ttypes.MPMState(**{k: torch.as_tensor(a) for k, a in st.items()}),
        ttypes.BodyState(**{k: torch.as_tensor(a) for k, a in bk.items()}),
        0)
    assert not bool(aux["window_overflow"])
    for k in ("x", "v", "C", "F"):
        _close(getattr(tnew, k), getattr(jnew, k), 1e-10)
    _close(text, jext, 1e-10)
    assert np.abs(np.asarray(jext)).max() > 0, "the contact did not engage"


def test_grid_contact_pour_rolls_out():
    cfg = softmac_tpu_torch.load(
        str(ROOT / "softmac_tpu_torch/config/demo_pour_config.py"))
    cfg.defrost()
    cfg.TPU.active_window = None
    cfg.SIMULATOR.collision_type = ttypes.CONTACT_GRID
    cfg.freeze()
    env = SoftMacEnv(cfg, device="cpu", init_particles=_pour_particles(100))
    assert env.mpm_cfg.collision_type == ttypes.CONTACT_GRID
    out = env.rollout(np.zeros((1, env.action_dim)))
    assert np.isfinite(out["loss"].item())
    assert torch.isfinite(out["carry"][0].x).all()
