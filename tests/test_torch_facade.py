"""PyTorch port: the imperative facade of SoftMacEnv (reset, step,
get_observation, get_state / set_state, compute_loss, backward) and the
packed-state writer, against the JAX package's, in float64 on the CPU.

- mpm_state_to_packed against JAX's bit for bit, and through the reader
  back to the state.
- The 400-particle pour_vel scene of test_torch_pour_vel.py: the port's
  facade stepped 4 times equals its own rollout within 1e-12 (JAX's
  test_rollout_matches_stepwise); over 3 seeded steps get_state,
  get_observation and compute_loss equal JAX's facade within 1e-10 at every
  frame; set_state round trips within 1e-12; backward() equals JAX's within
  1e-8 of its largest |value|. The facade holds its carry sorted by y-cell,
  and every reader returns the original particle order.
- The hit at 300 particles in front of the towel (test_torch_hit.py), the
  port alone: the (N, 26) state with contact_id and penetration, set_state
  of 26 and of 24 columns, and check_penetration; the closed-loop policy's
  cloth branch (the towel in the observation and the loss) over 2 env
  steps, its gradient nonzero in every parameter, and the facade's
  deployment of the same weights equal to the closed-loop forward.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import softmac_tpu
from softmac_tpu.engine import types as jtypes

import softmac_tpu_torch
from softmac_tpu_torch import SoftMacEnv as TorchEnv
from softmac_tpu_torch import load as torch_load
from softmac_tpu_torch.demos import demo_policy
from softmac_tpu_torch.engine import types as ttypes
from softmac_tpu_torch.engine.env import TaichiEnv
from softmac_tpu_torch.engine.policy import make_closed_loop_rollout

from test_torch_hit import _particles as hit_particles
from test_torch_pour_vel import _cfg, _particles

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N_STEPS = 3
TOL = 1e-10


def _actions(n_steps=N_STEPS):
    return np.random.RandomState(11).randn(n_steps, 12) * 0.05


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-300))


def _frames(env):
    """(state, observation, loss terms) at reset and after each step."""
    env.reset()
    out = [(env.get_state(), env.get_observation(), env.compute_loss())]
    for a in _actions():
        env.step(a)
        out.append((env.get_state(), env.get_observation(),
                    env.compute_loss()))
    return out


@pytest.fixture(scope="module")
def facades():
    jenv = softmac_tpu.SoftMacEnv(_cfg(softmac_tpu.load, "softmac_tpu"),
                                  init_particles=_particles())
    tenv = TorchEnv(_cfg(torch_load, "softmac_tpu_torch"), device="cpu",
                    init_particles=_particles())
    jframes, tframes = _frames(jenv), _frames(tenv)
    return (tenv, jframes, tframes, jenv.backward(loss_stride=1),
            tenv.backward(loss_stride=1))


def test_packed_writer_matches_jax():
    rng = np.random.RandomState(5)
    n = 37
    fields = {"x": rng.rand(3, n), "v": rng.randn(3, n),
              "C": rng.randn(3, 3, n), "F": rng.randn(3, 3, n)}
    state = ttypes.MPMState(**{k: torch.as_tensor(v)
                               for k, v in fields.items()})
    got = ttypes.mpm_state_to_packed(state)
    want = np.asarray(jtypes.mpm_state_to_packed(jtypes.MPMState(**fields)))
    assert got.shape == (n, 24)
    np.testing.assert_array_equal(got.numpy(), want)
    cfg = ttypes.MPMConfig(n_particles=n, dtype=torch.float64)
    back = ttypes.mpm_state_from_packed(cfg, got)
    for k in "xvCF":
        assert torch.equal(getattr(back, k), getattr(state, k)), k


def test_stepwise_facade_matches_rollout():
    """The facade (re-sorted at every step) and the rollout (re-sorted at
    every loss block) agree."""
    env = TorchEnv(_cfg(torch_load, "softmac_tpu_torch"), device="cpu",
                   init_particles=_particles())
    actions = np.zeros((4, 12))
    actions[:, 2] = 2.0
    out = env.rollout(actions, loss_start_frame=0, loss_stride=4)
    env.reset()
    for a in actions:
        env.step(a)
    _close(env.get_x(), out["carry"][0].x.T.numpy(), 1e-12)
    _close(env._held()[0].v.numpy(), out["carry"][0].v.numpy(), 1e-12)
    _close(env._held()[1].pos.numpy(), out["carry"][1].pos.numpy(), 1e-12)
    assert env.cur == 4 * env.substeps and len(env._history) == 5
    assert not torch.equal(env._perm, torch.arange(env.n_particles))


@pytest.mark.parametrize("frame", range(N_STEPS + 1))
@pytest.mark.parametrize("what", ["state", "observation", "loss"])
def test_facade_matches_jax(facades, frame, what):
    _, jframes, tframes, _, _ = facades
    i = ("state", "observation", "loss").index(what)
    ref, got = jframes[frame][i], tframes[frame][i]
    if what == "loss":
        assert set(got) == set(ref)
        for k in ref:
            assert abs(got[k] - ref[k]) <= TOL * max(abs(ref[k]), 1e-300), k
    else:
        assert got.shape == ref.shape
        _close(got, ref, TOL)
    if what == "state" and frame == N_STEPS:
        assert np.abs(ref[:, 3:6]).max() > 0.1   # the liquid moved


def test_set_state_round_trips(facades):
    env = facades[0]
    env.reset()
    packed = env.get_state()
    env.step(_actions()[0])
    moved = env.get_state()
    assert np.abs(moved - packed).max() > 0
    env.set_state(packed)
    _close(env.get_state(), packed, 1e-12)
    _close(env.get_x(), packed[:, :3], 1e-12)
    assert len(env._history) == 1
    env.set_state(moved)
    _close(env.get_state(), moved, 1e-12)


def test_backward_matches_jax(facades):
    _, _, _, jgrad, tgrad = facades
    assert tgrad.shape == jgrad.shape == (N_STEPS, 12)
    assert np.abs(jgrad).max() > 0
    _close(tgrad, jgrad, 1e-8)


def test_copy_and_history(facades):
    env = facades[0]
    env.reset()
    first = env.compute_loss()
    env.set_copy(True)
    try:
        env.step(_actions()[0])
        env.step(_actions()[1])
        # a copy keeps only the last snapshot and reports frame 0
        assert len(env._history) == 1
        assert env.compute_loss() == env.compute_loss(0)
        assert env.compute_loss() != first
    finally:
        env.set_copy(False)
    assert env.keep_history and TaichiEnv is TorchEnv


def test_step_takes_tensors_and_default_action(facades):
    env = facades[0]
    env.reset()
    env.step(torch.as_tensor(_actions()[0]))
    env.step()
    assert len(env.action_list) == 2
    assert torch.equal(env.action_list[0], torch.as_tensor(_actions()[0]))
    assert torch.equal(env.action_list[1], torch.zeros(12,
                                                       dtype=torch.float64))
    img = env.render()
    assert img.shape == (512, 512, 3) and img.dtype == np.uint8
    np.testing.assert_array_equal(env.render(env.cur), img)
    assert not np.array_equal(env.render(0), img)


@pytest.fixture(scope="module")
def hit():
    """The hit with 300 particles in front of the towel, all on the
    controller."""
    env = TorchEnv(softmac_tpu_torch.load(
        str(ROOT / "softmac_tpu_torch/config/demo_hit_config.py")),
        device="cpu", init_particles=hit_particles())
    env.set_control_idx(np.zeros(env.n_particles, np.int32))
    return env


def test_cloth_state_columns_and_penetration(hit):
    """The hit's (N, 26) state and check_penetration (JAX's
    tests/test_cloth.py:207-227, at 300 particles in contact)."""
    env = hit
    env.reset()
    packed = env.get_state()
    assert packed.shape == (env.n_particles, 26)
    assert env.check_penetration() == int(packed[:, 25].sum()) == 0
    assert (packed[:, 24] >= 0).sum() > 20    # pairs from the start
    assert env.get_observation().shape == (
        6 * env.n_observed + 6 * env.cloth_model.n_vertices,)
    act = np.array([0.0, 0.0, -8.0])
    env.step(act)
    env.step(act)
    moved = env.get_state()
    assert env.check_penetration() == int(moved[:, 25].sum())
    env.set_state(packed)
    _close(env.get_state(), packed, 1e-12)
    env.set_state(moved)
    _close(env.get_state(), moved, 1e-12)
    # 24 columns load the particles and keep the side-state
    flipped = moved.copy()
    flipped[:, 25] = 1 - flipped[:, 25]
    env.set_state(flipped)
    assert env.check_penetration() == int(flipped[:, 25].sum())
    env.set_state(moved[:, :24])
    _close(env.get_state(), flipped, 1e-12)


def test_closed_loop_on_cloth_scene(hit):
    """The policy's cloth branch; its last bias pushes the cylinders at
    the towel (-z), so that contact carries the gradient."""
    env = hit
    policy = demo_policy.make_policy(env, (8,), 8.0, env.n_observed)
    with torch.no_grad():
        policy.layers[-1].bias.copy_(torch.tensor([0.0, 0.0, -2.0]))
    loss_fn, _ = make_closed_loop_rollout(env, policy, 2, env.n_observed)
    loss, aux = loss_fn()
    loss.backward()
    loss = float(loss.detach())
    assert np.isfinite(loss) and not bool(aux["window_overflow"])
    for name, p in policy.named_parameters():
        assert torch.isfinite(p.grad).all() and p.grad.abs().max() > 0, name
    env.reset()
    for _ in range(2):
        with torch.no_grad():
            env.step(policy(torch.as_tensor(env.get_observation())))
    _close(env.get_x(), aux["carry"][0].x.T.numpy(), 1e-12)
    _close(env.get_state_frame(env.cur)[2], aux["carry"][1].x.numpy(), 1e-12)
    assert abs(env.compute_loss()["loss"] - loss) <= 1e-12 * loss
