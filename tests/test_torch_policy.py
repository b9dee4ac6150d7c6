"""PyTorch port: the closed-loop policy (softmac_tpu_torch.engine.policy)
and its trainer (softmac_tpu_torch.demos.demo_policy) against the JAX
package's, in float64 on the CPU.

- The observation functions against JAX's bit for bit, also read through
  the inverse of a permutation, as the sorted carry reads them.
- MLPPolicy with flax weights carried over (convert.mlp_policy_state_dict)
  against flax's policy.apply within 1e-12; the port's own initialisation
  (zero biases, weights of std fan_in^-1/2 within (-2, 2) of it).
- The closed loop on the 400-particle pour_vel scene of
  test_torch_pour_vel.py, as tests/test_policy.py runs it (3 env steps,
  hidden (32,), action_scale 0.5, n_observed 50), from the same weights:
  the loss within 1e-8 relative and each parameter's gradient within 1e-8
  of its largest |value| against jax.value_and_grad(loss_fn); two trainer
  epochs (demo_policy.train_epoch, torch.optim.Adam) against two
  optax.adam steps, the parameters within 1e-8.
- The trainer's main on the demo's own scene, two env steps on the CPU.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import softmac_tpu
from softmac_tpu.engine import policy as jpolicy
from softmac_tpu.engine.rigid import BodyState as JBodyState
from softmac_tpu.engine.types import MPMState as JMPMState

from softmac_tpu_torch import SoftMacEnv as TorchEnv
from softmac_tpu_torch import convert, images
from softmac_tpu_torch import load as torch_load
from softmac_tpu_torch.demos import demo_policy
from softmac_tpu_torch.engine import policy as tpolicy
from softmac_tpu_torch.engine.cloth import ClothState
from softmac_tpu_torch.engine.types import BodyState, MPMState

from test_torch_pour_vel import _cfg, _particles

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N_STEPS, HIDDEN, SCALE, N_OBSERVED = 3, (32,), 0.5, 50
LR = 3e-3
EPOCHS = 2


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-300))


def _port_params(policy, grad=False):
    """The port's parameters (or their gradients) keyed as the flax tree:
    (Dense_k, kernel (in, out) | bias)."""
    out = {}
    for k, layer in enumerate(policy.layers):
        w, b = ((layer.weight.grad, layer.bias.grad) if grad
                else (layer.weight, layer.bias))
        out[(f"Dense_{k}", "kernel")] = w.detach().T
        out[(f"Dense_{k}", "bias")] = b.detach()
    return out


def _flat(params):
    return {(d, name): np.asarray(v) for d, layer in params["params"].items()
            for name, v in layer.items()}


@pytest.fixture(scope="module")
def jax_run():
    """JAX's closed loop: its weights (float32, flax's init), the loss and
    gradient at them in float64, and the parameters after EPOCHS
    optax.adam steps. One compiled value_and_grad."""
    env = softmac_tpu.SoftMacEnv(_cfg(softmac_tpu.load, "softmac_tpu"),
                                 init_particles=_particles())
    policy = jpolicy.MLPPolicy(hidden_dims=HIDDEN, action_dim=env.action_dim,
                               action_scale=SCALE)
    loss_fn, init_params = jpolicy.make_closed_loop_rollout(
        env, policy, n_steps=N_STEPS, n_observed=N_OBSERVED)
    p32 = init_params(jax.random.PRNGKey(0))
    # float64 parameters of the same values: the gradient in float64
    params = jax.tree.map(lambda a: a.astype(jnp.float64), p32)
    opt = optax.adam(LR)
    state = opt.init(params)
    grad_fn = jax.value_and_grad(loss_fn)
    losses, grads = [], []
    for _ in range(EPOCHS):
        loss, g = grad_fn(params)
        losses.append(float(loss))
        grads.append(g)
        updates, state = opt.update(g, state)
        params = optax.apply_updates(params, updates)
    return {"p32": jax.tree.map(np.asarray, p32), "policy": policy,
            "losses": losses, "grad": _flat(grads[0]),
            "trained": _flat(params)}


def _port(p32):
    env = TorchEnv(_cfg(torch_load, "softmac_tpu_torch"), device="cpu",
                   init_particles=_particles())
    policy = demo_policy.make_policy(env, HIDDEN, SCALE, N_OBSERVED)
    policy.load_state_dict(convert.mlp_policy_state_dict(p32))
    loss_fn, _ = tpolicy.make_closed_loop_rollout(env, policy, N_STEPS,
                                                  N_OBSERVED)
    return env, policy, loss_fn


@pytest.fixture(scope="module")
def port_grad(jax_run):
    _, policy, loss_fn = _port(jax_run["p32"])
    loss, aux = loss_fn()
    loss.backward()
    return loss.detach(), aux, policy


def test_observations_match_jax():
    rng = np.random.RandomState(2)
    n = 103
    f = {"x": rng.rand(3, n), "v": rng.randn(3, n), "C": rng.randn(3, 3, n),
         "F": rng.randn(3, 3, n)}
    b = {"pos": rng.randn(2, 3), "quat": rng.randn(2, 4),
         "v": rng.randn(2, 3), "w": rng.randn(2, 3)}
    state = MPMState(**{k: torch.as_tensor(v) for k, v in f.items()})
    for n_obs in (50, 200):
        want = np.asarray(jpolicy.mpm_observation(JMPMState(**f), n_obs))
        got = tpolicy.mpm_observation(state, n_obs)
        np.testing.assert_array_equal(got.numpy(), want)
        # the same particles read from a permuted state through the inverse
        q = torch.as_tensor(rng.permutation(n))
        inv = torch.empty_like(q)
        inv[q] = torch.arange(n)
        perm_state = MPMState(x=state.x[:, q], v=state.v[:, q],
                              C=state.C[:, :, q], F=state.F[:, :, q])
        np.testing.assert_array_equal(
            tpolicy.mpm_observation(perm_state, n_obs, inv).numpy(), want)
    np.testing.assert_array_equal(
        tpolicy.body_observation(BodyState(**{
            k: torch.as_tensor(v) for k, v in b.items()})).numpy(),
        np.asarray(jpolicy.body_observation(JBodyState(**b))))
    cx, cv = rng.randn(9, 3), rng.randn(9, 3)
    np.testing.assert_array_equal(
        tpolicy.cloth_observation(ClothState(x=torch.as_tensor(cx),
                                             v=torch.as_tensor(cv))).numpy(),
        np.concatenate([cx.reshape(-1), cv.reshape(-1)]))


def test_policy_apply_matches_flax(jax_run):
    obs_dim = jax_run["p32"]["params"]["Dense_0"]["kernel"].shape[0]
    obs = np.random.RandomState(4).randn(obs_dim)
    want = np.asarray(jax_run["policy"].apply(jax_run["p32"],
                                              jnp.asarray(obs)))
    policy = tpolicy.MLPPolicy(obs_dim, HIDDEN, 12, SCALE,
                               dtype=torch.float64)
    policy.load_state_dict(convert.mlp_policy_state_dict(jax_run["p32"]))
    with torch.no_grad():
        got = policy(torch.as_tensor(obs)).numpy()
    assert want.dtype == np.float64 and np.abs(want).max() > 0.01
    _close(got, want, 1e-12)


def test_init_statistics():
    policy = tpolicy.MLPPolicy(1206, (64, 64), 12, dtype=torch.float64,
                               generator=torch.Generator().manual_seed(3))
    for layer in policy.layers:
        w, fan_in = layer.weight.detach(), layer.in_features
        assert layer.bias.abs().max() == 0
        # five standard errors of the sample's std and mean
        n = w.numel()
        assert abs(w.std().item() * fan_in ** 0.5 - 1.0) < 5 / (2 * n) ** 0.5
        assert abs(w.mean().item()) * fan_in ** 0.5 < 5 / n ** 0.5
        assert w.abs().max() <= 2 / 0.87962566103423978 / fan_in ** 0.5
    again = tpolicy.MLPPolicy(1206, (64, 64), 12, dtype=torch.float64,
                              generator=torch.Generator().manual_seed(3))
    for a, b in zip(policy.parameters(), again.parameters()):
        assert torch.equal(a, b)


def test_init_params_redraws(jax_run):
    """make_closed_loop_rollout's init_params re-draws the policy in place
    from a generator, as a new MLPPolicy from the same seed draws it."""
    env, policy, _ = _port(jax_run["p32"])
    _, init_params = tpolicy.make_closed_loop_rollout(env, policy, N_STEPS,
                                                      N_OBSERVED)
    state = init_params(torch.Generator().manual_seed(3))
    fresh = demo_policy.make_policy(env, HIDDEN, SCALE, N_OBSERVED, seed=3)
    for k, v in fresh.state_dict().items():
        assert torch.equal(state[k], v) and torch.equal(
            policy.state_dict()[k], v), k
    assert not torch.equal(state["layers.0.weight"], torch.as_tensor(
        jax_run["p32"]["params"]["Dense_0"]["kernel"].T, dtype=torch.float64))


def test_closed_loop_loss_matches_jax(jax_run, port_grad):
    loss, aux, _ = port_grad
    ref = jax_run["losses"][0]
    assert ref != 0.0
    assert abs(float(loss) - ref) <= 1e-8 * abs(ref)
    assert not bool(aux["window_overflow"])
    assert aux["carry"][0].x.shape == (3, 400)


@pytest.mark.parametrize("layer", ["Dense_0", "Dense_1"])
@pytest.mark.parametrize("name", ["kernel", "bias"])
def test_closed_loop_grad_matches_jax(jax_run, port_grad, layer, name):
    got = _port_params(port_grad[2], grad=True)
    ref = jax_run["grad"][(layer, name)]
    assert np.abs(ref).max() > 0
    _close(got[(layer, name)].numpy(), ref, 1e-8)


def test_trainer_epochs_match_optax(jax_run):
    _, policy, loss_fn = _port(jax_run["p32"])
    opt = torch.optim.Adam(policy.parameters(), lr=LR)
    losses = [float(demo_policy.train_epoch(loss_fn, opt)[0])
              for _ in range(EPOCHS)]
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=1e-8)
    got = _port_params(policy)
    moved = 0.0
    for key, ref in jax_run["trained"].items():
        _close(got[key].numpy(), ref, 1e-8)
        moved = max(moved, np.abs(ref - jax_run["p32"]["params"][key[0]][
            key[1]]).max())
    assert moved > LR / 2


def test_demo_policy_main_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = demo_policy.main(["--device", "cpu", "--steps", "2", "--epochs",
                            "1", "--hidden", "8"])
    log = tmp_path / "logs" / "policy"
    assert np.load(log / "losses.npy").tolist() == out["losses"]
    assert np.isfinite(out["losses"]).all()
    state = torch.load(log / "ckpt" / "policy_0.pt")
    assert [k for k in state] == ["layers.0.weight", "layers.0.bias",
                                  "layers.1.weight", "layers.1.bias"]
    assert state["layers.0.weight"].shape == (6 * 200 + 26, 8)[::-1]
    # the default --render-interval deploys and renders the last epoch
    assert np.load(log / "ckpt" / "actions_0.npy").shape == (2, 12)
    assert images.gif_info(log / "epoch0.gif")["frames"] == 2
    assert (log / "loss_curve.png").exists()
