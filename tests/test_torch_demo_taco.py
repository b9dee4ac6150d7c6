"""PyTorch port: the taco trainer (softmac_tpu_torch.demos.demo_taco) on the
CPU, in float64 (the scene against JAX: test_torch_taco.py; its gradient
and batched rollouts: test_torch_taco_grad.py).

- ``get_init_actions`` (at rest and the scripted fold) and ``clamp_delta``
  against demos/demo_taco.py's, within 1e-12, with deltas that reach the
  +-0.01 clamp and the reachable arc.
- ``DeltaController`` against demos/demo_taco.py's (optax's Adam, its
  learning rate a callable of the step count) over eight steps: through
  the warmup (five steps) into the decay, a non-finite gradient entry
  zeroed, a ``snapshot`` / ``restore`` with the lr halved in between (the
  ``--safeguard`` path): deltas, actions and the reported lr within 1e-12.
- ``main`` for one epoch of each optimiser, on the scene cut to 100 particles
  and two substeps an env step (dt 1e-3), 5 env steps, so that the loss
  frames 0 and 10 lie inside the horizon: Adam over 2 jittered replicas
  (``jittered_carry`` + ``batched_rollout_and_grad``), the line search
  (one ``batched_rollout`` of four candidates), and ``--eval-scripted``:
  losses finite, losses.npy and the checkpoint written; the GIFs (the
  first epoch's at the default --render-interval, the scripted fold's) at
  48 px, a frame an env step.
"""
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from softmac_tpu_torch import images
from softmac_tpu_torch.demos import demo_taco

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jdemo():
    spec = importlib.util.spec_from_file_location(
        "jax_demo_taco", ROOT / "demos/demo_taco.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def stub():
    """What get_init_actions reads of an env: the port's tortilla."""
    from test_torch_taco import taco_env
    env = taco_env(n=20)
    return types.SimpleNamespace(cloth_model=env.cloth_model,
                                 mpm_scale=env.mpm_scale)


def test_init_actions_and_clamp_delta_match_jax(jdemo, stub):
    steps = 200
    for choice in (0, 1):
        got = demo_taco.get_init_actions(steps, stub, choice)
        want = jdemo.get_init_actions(types.SimpleNamespace(steps=steps),
                                      stub, choice)
        assert got.shape == (steps, 51)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    fold = got
    rng = np.random.RandomState(4)
    delta = rng.uniform(0.005, 0.03, fold.shape)
    delta[:, 3] = rng.uniform(-0.03, -0.005, steps)
    dg, ag = demo_taco.clamp_delta(delta.copy(), fold, 5.0)
    dw, aw = jdemo.clamp_delta(delta.copy(), fold, 5.0)
    np.testing.assert_allclose(dg, dw, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ag, aw, rtol=0, atol=1e-12)
    # every clamp engaged: the arc's radius 0.3 * mpm_scale on y, the arc
    # itself on x, below the +-0.01 steps' sums
    cs, raw = np.cumsum(dg, axis=0), np.cumsum(np.clip(delta, -0.01, 0.01)
                                               [1:], axis=0)
    assert (dg[0] == 0).all()
    assert np.isclose(np.abs(cs[:, 1]).max(), 1.5)
    assert (cs[1:, 0] < raw[:, 0] - 0.1).any()
    assert (cs[1:, 3] > raw[:, 3] + 0.1).any()


@pytest.fixture
def eager_jax_unoptimised():
    """optax runs op by op here: each op compiled with XLA's optimisations
    off, the same float64 function in less time."""
    import jax
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


def test_delta_controller_matches_jax(jdemo, stub, eager_jax_unoptimised):
    steps = 12
    # from rest, at a learning rate whose steps stay inside the clamp
    acts0 = demo_taco.get_init_actions(steps, stub, 0)
    mine = demo_taco.DeltaController(acts0, 5.0, lr=4e-3)
    ref = jdemo.DeltaController(steps=steps, actions_init=acts0,
                                mpm_scale=5.0, lr=4e-3, warmup=5, decay=0.95)
    np.testing.assert_allclose(mine.get_actions(), ref.get_actions(),
                               rtol=0, atol=1e-12)
    rng = np.random.RandomState(5)
    snap = jsnap = None
    for i in range(8):
        g = rng.randn(steps, 51) * 10.0 ** rng.uniform(-3, 1)
        if i == 2:
            g[3, 0] = np.nan
        if i == 4:
            snap, jsnap = mine.snapshot(), ref.snapshot()
        if i == 6:          # the safeguard: roll back, halve the lr
            mine.restore(snap)
            ref.restore(jsnap)
            mine.lr *= 0.5
            ref.lr *= 0.5
        mine.step(g)
        ref.step(g)
        assert mine.latest_lr == pytest.approx(ref.latest_lr, rel=1e-14)
        np.testing.assert_allclose(mine.delta, ref.delta, rtol=0, atol=1e-12)
        np.testing.assert_allclose(mine.get_actions(), ref.get_actions(),
                                   rtol=0, atol=1e-12)
    assert mine.epoch == ref.epoch == 6      # 4 restored, then 2 steps
    # only the first two handles' x and y move
    moved = np.abs(mine.delta - snap[0]).max(axis=0)
    assert (moved[[0, 1, 3, 4]] > 0).all()
    assert (moved[[2, 5]] == 0).all() and (moved[6:] == 0).all()


def _small_config(tmp_path):
    text = (ROOT / "softmac_tpu_torch/config/demo_taco_config.py").read_text()
    for old, new in (('"n_particles": 10000', '"n_particles": 100'),
                     ("_C.SIMULATOR.dt = 2e-4", "_C.SIMULATOR.dt = 1e-3"),
                     ("RENDERER.image_res = (1024, 1024)",
                      "RENDERER.image_res = (48, 48)")):
        assert old in text
        text = text.replace(old, new)
    (tmp_path / "config.py").write_text(text)
    return str(tmp_path / "config.py")


@pytest.mark.parametrize("method", [["--replicas", "2"], ["--line-search"],
                                    ["--eval-scripted"]],
                         ids=["adam_replicas", "line_search",
                              "eval_scripted"])
def test_demo_taco_main_on_cpu(tmp_path, method):
    argv = ["--device", "cpu", "--steps", "5", "--epochs", "1",
            "--remat", "none",
            "--config", _small_config(tmp_path),
            "--log-root", str(tmp_path / "logs"), "--exp-name", "t"]
    out = demo_taco.main(argv + method)
    log = tmp_path / "logs/t"
    if method == ["--eval-scripted"]:
        assert np.isfinite(out["scripted_loss"])
        np.testing.assert_array_equal(np.load(log / "scripted_loss.npy"),
                                      [out["scripted_loss"]])
        assert images.gif_info(log / "scripted.gif") == {
            "size": (48, 48), "frames": 5, "loop": 0}
        return
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"][0])
    np.testing.assert_array_equal(np.load(log / "losses.npy"), out["losses"])
    # the default --render-interval renders the first epoch
    assert images.gif_info(log / "epoch0.gif")["frames"] == 5
    assert (log / "loss_curve.png").exists()
    acts = np.load(log / "ckpt/actions_0.npy")
    assert acts.shape == (5, 51) and np.isfinite(acts).all()
