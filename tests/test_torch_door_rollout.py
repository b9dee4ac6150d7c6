"""PyTorch port, the door scene's rollout and rollout_and_grad against the
JAX package, in float64 on the CPU: 300 of the door's particles (the
fixtures of test_torch_door.py), 3 env steps of seeded actions that push
the boxes into the door. The JAX package's rollout_and_grad runs op by op
under jax.disable_jit with its default remat "step", which here is faster
than compiling it, and each op compiled with XLA's optimisations off
(jax_disable_most_optimizations), a quarter faster again. Loss and terms
1e-8 relative, end state 1e-8 absolute, the action gradient 1e-8 of its
largest |value|.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_door import N_STEPS, _actions, envs  # noqa: E402,F401

RTOL = 1e-8


@pytest.fixture(scope="module")
def runs(envs):
    jenv, tenv = envs
    acts = _actions()
    assert tenv.action_dim == jenv.action_dim == 3
    # op by op, each op compiled without XLA's optimisation passes: the
    # same float64 function, compiled in less time
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        with jax.disable_jit():
            jout = jenv.rollout_and_grad(acts, loss_stride=1)
    finally:
        jax.config.update("jax_disable_most_optimizations", False)
    return (jout, tenv.rollout(acts, loss_stride=1),
            tenv.rollout_and_grad(acts, loss_stride=1))


@pytest.mark.parametrize("term", ["loss", "pose_loss", "final_pose_loss"])
def test_door_rollout_loss_matches_jax(runs, term):
    ref = float(runs[0]["loss"] if term == "loss" else runs[0]["terms"][term])
    assert ref != 0.0
    for tout in runs[1:]:
        got = float(tout["loss"] if term == "loss" else tout["terms"][term])
        assert abs(got - ref) <= RTOL * abs(ref)
        assert not bool(tout["terms"]["window_overflow"])


def test_door_rollout_state_matches_jax(runs):
    jm, _, jr = runs[0]["carry"]
    for tout in runs[1:]:
        tm, _, tr = tout["carry"]
        for got, ref in ((tm.x, jm.x), (tm.v, jm.v), (tr.q, jr.q),
                         (tr.qd, jr.qd)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                       atol=RTOL)
    assert abs(float(jr.q[0])) > 0, "the door did not move"


def test_door_action_grad_matches_jax(runs):
    jg = np.asarray(runs[0]["action_grad"])
    g = runs[2]["action_grad"]
    assert g.shape == jg.shape == (N_STEPS, 3)
    assert np.abs(jg).max() > 0
    assert np.abs(g.numpy() - jg).max() <= RTOL * np.abs(jg).max()
