"""PyTorch port: the taco's action gradient and its batched rollouts on the
cloth carry (mpm, cloth, pen), in float64 on the CPU, on 200 particles of
the taco's disk in the cloth control mode (test_torch_taco.py's env,
whose rollout is held to JAX there at 1e-8).

- The gradient of the loss at the end of each of 2 env steps of the
  scripted fold with respect to the handle targets: under remat "none"
  and "step" within 1e-12 of each other, nonzero on the first env step's
  handles (the action moves the cloth after the particles' substeps, so
  only a later env step's particles feel it), and within 3e-3 of the
  port's own float64 central differences at a step of 5e-5. Three
  departures from the scene make the gradient the forward's derivative
  and keep it cheap: the contact gradient scales set to 1 (the config's
  0.3 damps the adjoint on purpose; the scales are held to JAX in
  test_torch_cloth.py), the SVD backward's clamp of |s_j^2 - s_i^2| moved
  from 1e-6 to 1e-12 (the disk at rest has F near a rotation, and the
  clamp alone puts the gradient 1.6 % off the differences here; the grip's
  test, test_torch_grip.py, keeps it and allows 1e-3), and two substeps
  an env step (dt 1e-3; the cost is per substep). The differences then
  agree to 8e-4; the sticky contact's kinks keep them from agreeing
  closer (1.2 % at a step of 5e-4). JAX's rollout_and_grad of this env
  costs ~50 s to compile here.
- ``jittered_carry`` on the cloth carry: replica 0 the exact initial
  state, replica 1's particles moved by the seeded draw, the cloth and the
  contact ids the unjittered ones (as JAX's env.py:1159-1175).
- ``batched_rollout`` from it: replica 0 equal to the single rollout from
  the scene's initial state, and each replica to a single rollout from its
  own slice of the carry, within 1e-12 (loss, terms, particles, cloth),
  contact ids and penetration bits exact.
"""
import numpy as np
import pytest
import torch

from softmac_tpu_torch.demos.demo_taco import get_init_actions
from softmac_tpu_torch.engine import svd3
from softmac_tpu_torch.engine.env import map_carry

from test_torch_taco import _close, taco_cfg, taco_env

torch.set_num_threads(1)

T = 2


@pytest.fixture(scope="module")
def env():
    return taco_env()


def _exact_env():
    """The taco at two substeps an env step, its contact gradient scales
    1."""
    cfg = taco_cfg()
    cfg.defrost()
    cfg.SIMULATOR.dt = 1e-3
    cfg.PRIMITIVES.contact_geom_grad_scale = 1.0
    cfg.PRIMITIVES.contact_cv_grad_scale = 1.0
    return taco_env(cfg=cfg.freeze())


def _fold(env):
    """The first T env steps of a 10-step scripted fold: the handles move
    0.13 an env step."""
    return get_init_actions(10, env, choice=1)[:T]


def _kw(env):
    frames = T * env.substeps
    return dict(loss_start_frame=frames // 2, loss_stride=frames // 2)


def test_taco_grad_remats_and_finite_differences(monkeypatch):
    clamp = svd3._clamp_away_from_zero
    monkeypatch.setattr(svd3, "_clamp_away_from_zero",
                        lambda a, eps=1e-12: clamp(a, eps))
    env = _exact_env()
    assert env.substeps == 2
    acts = _fold(env)
    kw = _kw(env)
    outs = {r: env.rollout_and_grad(acts, remat=r, **kw)
            for r in ("none", "step")}
    g = outs["none"]["action_grad"].numpy()
    assert g.shape == (T, 51) and np.abs(g[0]).max() > 0
    _close(float(outs["step"]["loss"]), float(outs["none"]["loss"]), 1e-12)
    _close(outs["step"]["action_grad"].numpy(), g, 1e-12)
    eps = 5e-5
    d = np.random.RandomState(9).randn(*acts.shape)
    lp, lm = (float(env.rollout(acts + s * eps * d, **kw)["loss"])
              for s in (1.0, -1.0))
    np.testing.assert_allclose(float(np.sum(g * d)), (lp - lm) / (2 * eps),
                               rtol=3e-3)


def test_taco_batched_rollout_on_cloth_carry(env):
    acts = _fold(env)
    kw = _kw(env)
    carry0 = env._initial_carry()
    carry2 = env.jittered_carry(2, sigma=2e-4)
    mpm2, cloth2, pen2 = carry2
    assert torch.equal(mpm2.x[0], carry0[0].x)
    noise = np.random.RandomState(0).randn(2, *carry0[0].x.shape) * 2e-4
    np.testing.assert_allclose((mpm2.x[1] - carry0[0].x).numpy(), noise[1],
                               rtol=0, atol=1e-15)
    for b in range(2):
        assert torch.equal(cloth2.x[b], carry0[1].x)
        assert torch.equal(pen2.contact_id[b], carry0[2].contact_id)
        assert torch.equal(pen2.penetration[b], carry0[2].penetration)

    out = env.batched_rollout(np.stack([acts, acts]), carry0=carry2, **kw)
    assert out["loss"].shape == (2,)
    singles = [env.rollout(acts, **kw)] + [
        env.rollout(acts, carry0=map_carry(lambda t: t[1], carry2), **kw)]
    for b, ref in enumerate(singles):
        _close(float(out["loss"][b]), float(ref["loss"]), 1e-12)
        for k, v in ref["terms"].items():
            _close(float(out["terms"][k][b]), float(v), 1e-12)
        got = map_carry(lambda t, b=b: t[b], out["carry"])
        (m, c, p), (rm, rc, rp) = got, ref["carry"]
        _close(m.x.numpy(), rm.x.numpy(), 1e-12)
        _close(m.v.numpy(), rm.v.numpy(), 1e-12)
        _close(c.x.numpy(), rc.x.numpy(), 1e-12)
        _close(c.v.numpy(), rc.v.numpy(), 1e-12)
        assert torch.equal(p.contact_id, rp.contact_id)
        assert torch.equal(p.penetration, rp.penetration)
    assert int((out["carry"][2].contact_id >= 0).sum()) > 0
    # the jittered replica is another trajectory
    assert not np.allclose(out["carry"][0].x[1].numpy(),
                           out["carry"][0].x[0].numpy(), rtol=0, atol=1e-9)
