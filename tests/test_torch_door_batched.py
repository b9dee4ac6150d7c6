"""PyTorch port: the batched rollouts and the door trainer on the CPU, in
float64, on the 300-particle door of test_torch_door.py's fixtures.

- jittered_carry bit for bit as the JAX package's (eager), replica 0 the
  exact initial state.
- batched_rollout and batched_rollout_and_grad against a loop of the
  port's own rollout / rollout_and_grad from each replica's carry0, at
  1e-12 (that loop is held to JAX at 1e-8 by test_torch_door_rollout.py),
  with jittered and with broadcast initial carries.
- The candidate-by-replica tiling of demo_door (tests/test_env.py's
  test_candidate_by_replica_tiling): C candidates x K replicas in one
  batched_rollout against each pair's single run.
- softmac_tpu_torch.demos.demo_door.main on that scene (the config's boxes
  replaced by the 300 particles), 6 env steps, 2 epochs, 2 replicas:
  losses.npy and a checkpoint an epoch written, the logged loss never
  rises, and with --render-interval 1 (48 px frames) a 6-frame GIF an
  epoch and the loss curve. At 6 env steps of one substep the
  only loss frame is 0, so the line search's gradient is zero there; the
  card's demo_door phase (chip_smoke.py) runs a horizon with later frames.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_door import ROOT, _particles, envs  # noqa: E402,F401

from softmac_tpu_torch import images
from softmac_tpu_torch.demos import demo_door
from softmac_tpu_torch.engine.env import map_carry

torch.set_num_threads(1)

T = 3


def _tensors(carry):
    mpm, bodies, rigid = carry
    return (mpm.x, mpm.v, mpm.C, mpm.F, bodies.pos, bodies.quat, bodies.v,
            bodies.w, rigid.q, rigid.qd)


def _pushes(b, seed=7):
    """(b, T, 3) actions that push the boxes into the door."""
    a = 5.0 * np.random.RandomState(seed).randn(b, T, 3)
    a[:, :, 2] -= 40.0
    return a


def test_jittered_carry_matches_jax(envs):
    jenv, tenv = envs
    got = tenv.jittered_carry(3, sigma=1e-4, seed=5)
    ref = jenv.jittered_carry(3, sigma=1e-4, seed=5)
    x0 = tenv._initial_carry()[0].x
    assert got[0].x.shape == (3, 3, tenv.n_particles)
    assert torch.equal(got[0].x[0], x0)
    assert not torch.equal(got[0].x[1], got[0].x[2])
    np.testing.assert_array_equal(got[0].x.numpy(), np.asarray(ref[0].x))
    for g, r in zip(_tensors(got), (ref[0].x, ref[0].v, ref[0].C, ref[0].F,
                                    ref[1].pos, ref[1].quat, ref[1].v,
                                    ref[1].w, ref[2].q, ref[2].qd)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _close(got, ref):
    got, ref = got.numpy(), ref.numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * max(np.abs(ref).max(), 1e-300))


@pytest.mark.parametrize("jitter", [True, False])
def test_batched_matches_single_runs(envs, jitter):
    _, env = envs
    B = 2
    acts = _pushes(B)
    carry0 = env.jittered_carry(B, sigma=1e-4, seed=5) if jitter else None
    fwd = env.batched_rollout(acts, carry0=carry0, loss_stride=1)
    grad = env.batched_rollout_and_grad(acts, carry0=carry0, loss_stride=1,
                                        grad_clip=1.0)
    assert fwd["loss"].shape == grad["loss"].shape == (B,)
    assert grad["action_grad"].shape == (B, T, 3)
    for b in range(B):
        c0 = None if carry0 is None else map_carry(lambda t: t[b], carry0)
        one = env.rollout(acts[b], loss_stride=1, carry0=c0)
        one_g = env.rollout_and_grad(acts[b], loss_stride=1, grad_clip=1.0,
                                     carry0=c0)
        for out, ref in ((fwd, one), (grad, one_g)):
            _close(out["loss"][b], ref["loss"])
            for k, v in ref["terms"].items():
                _close(out["terms"][k][b].double(), torch.as_tensor(v).double())
            for t, r in zip(_tensors(out["carry"]), _tensors(ref["carry"])):
                _close(t[b], r)
        _close(grad["action_grad"][b], one_g["action_grad"])
    assert grad["action_grad"].abs().max() > 0
    assert bool((grad["loss"][1:] != grad["loss"][0]).all())


def test_candidate_by_replica_tiling(envs):
    """C candidates x K replicas in one batched_rollout (the actions
    repeated per candidate, the jittered carry concatenated C times)
    against each pair's own run."""
    _, env = envs
    C, K = 2, 2
    carry_k = env.jittered_carry(K, sigma=1e-4, seed=6)
    cands = _pushes(C, seed=8)
    out = env.batched_rollout(np.repeat(cands, K, axis=0),
                              carry0=map_carry(lambda t: torch.cat([t] * C),
                                               carry_k), loss_stride=1)
    losses = out["loss"].reshape(C, K)
    for c in range(C):
        for k in range(K):
            single = map_carry(lambda t: t[k:k + 1], carry_k)
            ref = env.batched_rollout(cands[c][None], carry0=single,
                                      loss_stride=1)
            _close(losses[c, k], ref["loss"][0])
    assert len(set(losses.reshape(-1).tolist())) == C * K


def test_demo_main_on_cpu(tmp_path):
    np.save(tmp_path / "particles.npy", _particles())
    text = (ROOT / "softmac_tpu_torch/config/demo_door_config.py").read_text()
    a = text.index("_C.SHAPES = [")
    b = text.index("\n]\n", a) + 3
    text = text[:a] + ("_C.SHAPES = [{\"shape\": \"predefined\", \"path\": "
                       f"{str(tmp_path / 'particles.npy')!r}}}]\n") + text[b:]
    (tmp_path / "config.py").write_text(text + "\n_C.RENDERER.image_res = (48, 48)\n_C.RENDERER.ssaa = 1\n")
    out = demo_door.main([
        "--device", "cpu", "--steps", "6", "--epochs", "2", "--replicas",
        "2", "--config", str(tmp_path / "config.py"), "--log-root",
        str(tmp_path / "logs"), "--exp-name", "t", "--render-interval", "1"])
    log = tmp_path / "logs/t"
    losses = out["losses"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert losses[1] <= losses[0]
    np.testing.assert_array_equal(np.load(log / "losses.npy"), losses)
    for e in (0, 1):
        a = np.load(log / f"ckpt/actions_{e}.npy")
        assert a.shape == (6, 3) and np.allclose(a[:, 2], 0.1)
    for e in (0, 1):
        assert images.gif_info(log / f"epoch{e}.gif") == {
            "size": (48, 48), "frames": 6, "loop": 0}
    assert (log / "loss_curve.png").exists()
