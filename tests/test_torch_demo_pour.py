"""PyTorch port: the demo_pour trainer (softmac_tpu_torch.utils.Controller,
SoftMacEnv.adjust_action_with_ext_force, softmac_tpu_torch.demos.demo_pour)
against the JAX package, in float64 on the CPU.

- Controller: torch.optim.Adam under the reference's warmup/decay schedule
  against softmac_tpu.utils.Controller (optax adam) over 8 steps of seeded
  gradients, through warmup and decay, with a snapshot / restore and an lr
  halving in between (demo_pour --safeguard): actions within 1e-12.
- adjust_action_with_ext_force on the 400-particle pour scene (the demo's
  window), 3 env steps: the compensated actions within 1e-8 of JAX's.
- The demo's main on the CPU, 2 epochs of 20 steps on that scene: it
  writes losses.npy and a checkpoint a epoch, and the actions move; with
  --render-interval 1 (48 px frames) a GIF of 20 frames an epoch and the
  loss curve.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import softmac_tpu
from softmac_tpu import utils as jutils

from softmac_tpu_torch import SoftMacEnv as TorchEnv
from softmac_tpu_torch import load as torch_load
from softmac_tpu_torch import images
from softmac_tpu_torch import utils as tutils
from softmac_tpu_torch.demos import demo_pour

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WINDOW = (48, 32, 16)


def _particles(n=400):
    base = np.load(ROOT / "envs/pour/pour_mpm_init_state_corotated.npy")
    pick = np.random.RandomState(3).choice(base.shape[0], n, replace=False)
    return base[pick, :3] + np.array([0.0, 0.04, 0.0])


@pytest.mark.parametrize("betas", [(0.0, 0.999), (0.9, 0.999)])
def test_controller_matches_optax(betas):
    rng = np.random.RandomState(0)
    n_act, dim, steps = 4, 3, 40
    init = rng.randn(steps, dim)
    kw = dict(lr=1e-2, warmup=3, decay=0.9, betas=betas,
              action_scale=np.array([1.0, 0.5, 2.0]), actions_init=init)
    ctls = (jutils.Controller(n_act, dim, steps, **kw),
            tutils.Controller(n_act, dim, steps, **kw))
    grads = rng.randn(8, steps, dim)
    snaps = None
    for k, g in enumerate(grads):
        if k == 3:
            snaps = [c.snapshot() for c in ctls]
        if k == 5:       # roll back two steps and halve the lr
            for c, s in zip(ctls, snaps):
                c.restore(s)
                c.lr *= 0.5
        for c in ctls:
            c.step(g)
        np.testing.assert_allclose(ctls[1].action, ctls[0].action, rtol=0,
                                   atol=1e-12)
        assert ctls[1].latest_lr == pytest.approx(ctls[0].latest_lr,
                                                  rel=1e-15)
    np.testing.assert_allclose(ctls[1].get_actions(), ctls[0].get_actions(),
                               rtol=0, atol=1e-12)
    assert np.abs(ctls[1].action - init.reshape(n_act, -1, dim).mean(1)
                  ).max() > 1e-3


def _cfg(load, pkg_dir):
    cfg = load(str(ROOT / pkg_dir / "config/demo_pour_config.py"))
    cfg.defrost()
    cfg.TPU.active_window = WINDOW
    return cfg.freeze()


def test_adjust_action_with_ext_force_matches_jax():
    acts = np.random.RandomState(4).randn(3, 12) * 0.05
    jenv = softmac_tpu.SoftMacEnv(_cfg(softmac_tpu.load, "softmac_tpu"),
                                  init_particles=_particles())
    tenv = TorchEnv(_cfg(torch_load, "softmac_tpu_torch"), device="cpu",
                    init_particles=_particles())
    ref = np.asarray(jenv.adjust_action_with_ext_force(acts))
    got = tenv.adjust_action_with_ext_force(acts)
    assert got.shape == ref.shape == (3, 12)
    # the contact wrench on the glass is in it, beyond gravity
    assert np.abs(ref - acts).max() > 0.1
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-8 * np.abs(ref).max())


def test_demo_main_on_cpu(tmp_path):
    np.save(tmp_path / "particles.npy", _particles())
    text = (ROOT / "softmac_tpu_torch/config/demo_pour_config.py").read_text()
    text = text.replace('"envs/pour/pour_mpm_init_state_corotated.npy"',
                        repr(str(tmp_path / "particles.npy")))
    (tmp_path / "config.py").write_text(text + "\n_C.RENDERER.image_res = (48, 48)\n_C.RENDERER.ssaa = 1\n")
    losses = demo_pour.main([
        "--device", "cpu", "--steps", "20", "--epochs", "2", "--remat",
        "none", "--config", str(tmp_path / "config.py"), "--log-root",
        str(tmp_path / "logs"), "--exp-name", "t", "--safeguard",
        "--render-interval", "1"])["losses"]
    log = tmp_path / "logs/t"
    assert len(losses) == 2 and all(np.isfinite(losses))
    np.testing.assert_array_equal(np.load(log / "losses.npy"), losses)
    a0, a1 = (np.load(log / f"ckpt/actions_{e}.npy") for e in (0, 1))
    assert a0.shape == (20, 12) and np.abs(a1 - a0).max() > 0
    # the initial actions hold the glass against gravity
    assert a0[0, 4] > 0
    for e in (0, 1):
        info = images.gif_info(log / f"epoch{e}.gif")
        assert info == {"size": (48, 48), "frames": 20, "loop": 0}
    assert images.read_png(log / "loss_curve.png").shape == (900, 1200, 3)


def test_demo_main_body_contact_on_cpu(tmp_path):
    """``--body-contact``: one short epoch with the glass-bowl contact on
    (the JAX trainer's flag; the bodies do not touch in the demo's start,
    so the run matches the plain one's shape)."""
    np.save(tmp_path / "particles.npy", _particles())
    text = (ROOT / "softmac_tpu_torch/config/demo_pour_config.py").read_text()
    text = text.replace('"envs/pour/pour_mpm_init_state_corotated.npy"',
                        repr(str(tmp_path / "particles.npy")))
    (tmp_path / "config.py").write_text(text)
    out = demo_pour.main([
        "--device", "cpu", "--steps", "6", "--epochs", "1", "--remat",
        "none", "--config", str(tmp_path / "config.py"), "--log-root",
        str(tmp_path / "logs"), "--exp-name", "t", "--body-contact",
        "--render-interval", "0"])
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"][0])
    assert np.load(tmp_path / "logs/t/ckpt/actions_0.npy").shape == (6, 12)
