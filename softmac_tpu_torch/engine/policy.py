"""Closed-loop neural controllers (obs -> action) for the simulator
(``softmac_tpu/engine/policy.py`` of the JAX package).

An MLP maps the observation -- subsampled particles' x and v (the
reference's get_observation layout, ``soft_cloth/engine/
mpm_simulator.py:769-784``), then the rigid bodies' or the cloth's state --
to the action at every env step. The closed-loop rollout is differentiable
end to end, so the policy trains on analytic simulation gradients.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from softmac_tpu_torch.engine.env import _inverse, map_carry

# the standard deviation of the standard normal truncated to (-2, 2)
_TRUNC_STD = 0.87962566103423978


def mpm_observation(mpm_state, n_observed: int = 200, inv=None):
    """Subsampled particle positions and velocities, (n_observed * 6,):
    particle idx_k = min(k * max(N // n_observed, 1), N - 1), its x then
    its v. ``inv`` (original index -> position, for a sorted carry) reads
    the original particles idx_k through a gather, so that gradients reach
    the sorted rows."""
    n = mpm_state.x.shape[-1]
    step = max(n // n_observed, 1)
    idx = torch.clamp(torch.arange(n_observed, device=mpm_state.x.device)
                      * step, 0, n - 1)
    if inv is not None:
        idx = inv[idx]
    x = mpm_state.x[:, idx].T     # (n_observed, 3)
    v = mpm_state.v[:, idx].T
    return torch.cat([x, v], dim=1).reshape(-1)


def body_observation(bodies):
    """Rigid body states flattened field by field, (B * 13,): every body's
    pos, then every quat, then v, then w."""
    return torch.cat([bodies.pos.reshape(-1), bodies.quat.reshape(-1),
                      bodies.v.reshape(-1), bodies.w.reshape(-1)])


def cloth_observation(cloth_state):
    return torch.cat([cloth_state.x.reshape(-1), cloth_state.v.reshape(-1)])


def observation(env, carry, n_observed: int = 200, inv=None):
    """The policy's input for a carry of ``env``: the particles'
    observation, then the cloth's, or the bodies' where there are any.
    ``inv`` as for ``mpm_observation``."""
    mpm, second, _ = carry
    parts = [mpm_observation(mpm, n_observed, inv)]
    if env.has_cloth:
        parts.append(cloth_observation(second))
    elif second.pos.shape[0] > 0:
        parts.append(body_observation(second))
    return torch.cat(parts)


def lecun_normal(shape, fan_in: int, generator=None) -> torch.Tensor:
    """flax's ``lecun_normal``: a standard normal truncated to (-2, 2),
    scaled to variance 1 / fan_in; drawn in float64 on the CPU from
    ``generator`` (the inverse CDF of a uniform draw, as JAX's
    ``truncated_normal``)."""
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    z = (math.sqrt(2) * torch.erfinv(lo + (hi - lo) * u)).clamp(-2.0, 2.0)
    return z * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)


class MLPPolicy(nn.Module):
    """obs -> action MLP: ``nn.Linear`` layers of ``hidden_dims`` with
    ReLU, then ``action_scale * tanh``. Initialised as flax's ``nn.Dense``
    is (``lecun_normal`` weights, zero biases) from ``generator``."""

    def __init__(self, obs_dim: int, hidden_dims: Sequence[int],
                 action_dim: int, action_scale: float = 1.0,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        dims = [int(obs_dim), *(int(d) for d in hidden_dims), int(action_dim)]
        device = "cpu" if device is None else device
        self.layers = nn.ModuleList(
            nn.utils.skip_init(nn.Linear, i, o, dtype=dtype, device=device)
            for i, o in zip(dims[:-1], dims[1:]))
        self.action_scale = float(action_scale)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        for layer in self.layers:
            layer.weight.copy_(lecun_normal(
                (layer.out_features, layer.in_features), layer.in_features,
                generator))
            layer.bias.zero_()

    def forward(self, obs):
        h = obs
        for layer in self.layers[:-1]:
            h = torch.relu(layer(h))
        return self.action_scale * torch.tanh(self.layers[-1](h))


def make_closed_loop_rollout(env, policy: MLPPolicy, n_steps: int,
                             n_observed: int = 200):
    """(loss_fn, init_params) of a closed-loop rollout of ``n_steps`` env
    steps from the scene's initial state: at every env step the policy maps
    the current observation to the action.

    ``loss_fn()`` returns (loss, aux): the loss, the sum of the loss terms
    at the last frame, with the autograd graph to the policy's parameters
    (``loss.backward()`` trains it), and aux {"window_overflow": whether
    the active window missed a particle, "carry": the exit carry in the
    original particle order, detached}. ``init_params(generator)``
    re-draws the policy's parameters and returns its ``state_dict``.

    The particles are sorted by y-cell at entry and re-keyed at every env
    step, as the facade's ``step`` does, so that a deployment through
    ``reset`` / ``get_observation`` / ``step`` visits them in the same
    order; the observation reads the original particles through the
    inverse permutation. Each env step alone is checkpointed (JAX's
    ``jax.checkpoint`` over ``env_step``): the backward replays its
    forward. Nothing leaves the device inside the loop."""
    carry0 = env._initial_carry()
    perm0 = torch.arange(env.n_particles, device=env.device)

    def loss_fn():
        carry, perm = carry0, perm0
        overflow = torch.zeros((), dtype=torch.bool, device=env.device)
        for _ in range(n_steps):
            carry, perm, params = env._rekey(carry, perm)
            action = policy(observation(env, carry, n_observed,
                                        _inverse(perm)))
            carry, (ovf, _) = checkpoint(env._env_step_fn, carry, action,
                                         params, use_reentrant=False)
            overflow = overflow | ovf
        loss = sum(env.loss.terms(env._sample(carry, perm)).values())
        exit_carry = map_carry(torch.Tensor.detach,
                               env._permute(carry, _inverse(perm)))
        return loss, {"window_overflow": overflow, "carry": exit_carry}

    def init_params(generator=None):
        policy.reset_parameters(generator)
        return policy.state_dict()

    return loss_fn, init_params
