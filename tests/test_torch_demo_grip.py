"""PyTorch port: the grip and pour_vel trainers
(softmac_tpu_torch.demos.demo_grip, demo_pour_vel) and
SoftMacEnv.adjust_action_with_ext_force on the grip, in float64 on the CPU.

- adjust_action_with_ext_force on the grip (200 of its particles, the
  fingers started at the block and moving in, the palm's contact off, 3
  env steps): equal to JAX's. Its bodies have no free joint (a fixed palm,
  two prismatic fingers), so neither package compensates them: the
  actions come back as they went in.
- Each trainer's main on the CPU for one epoch of a few steps, on its
  scene cut to a few hundred particles: a finite loss, losses.npy and the
  epoch's checkpoint written; the grip's gradient reaches its actions;
  with --render-interval 1 (48 px frames) a GIF of a frame a step and the
  loss curve.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import softmac_tpu

import softmac_tpu_torch
from softmac_tpu_torch import SoftMacEnv as TorchEnv
from softmac_tpu_torch import images
from softmac_tpu_torch.demos import demo_grip, demo_pour_vel

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
NEAR = (0.02, -0.02, 0.5, -0.5)


def _grip_particles(n=200):
    base = np.load(ROOT / "envs/grip/grip_mpm_init_state.npy")
    return base[np.random.RandomState(5).choice(base.shape[0], n,
                                                replace=False)]


def test_adjust_action_with_ext_force_matches_jax():
    acts = np.random.RandomState(4).randn(3, 2) * 0.3
    envs = []
    for load, pkg in ((softmac_tpu.load, "softmac_tpu"),
                      (softmac_tpu_torch.load, "softmac_tpu_torch")):
        cfg = load(str(ROOT / pkg / "config/demo_grip_config.py"))
        cfg.defrost()
        cfg.RIGID.init_state = NEAR
        cfg.freeze()
        kw = {} if pkg == "softmac_tpu" else {"device": "cpu"}
        env = (softmac_tpu.SoftMacEnv if pkg == "softmac_tpu"
               else TorchEnv)(cfg, init_particles=_grip_particles()[:, :3],
                              **kw)
        env.set_primitives_contact([False, True, True])
        envs.append(env)
    ref = np.asarray(envs[0].adjust_action_with_ext_force(acts))
    got = envs[1].adjust_action_with_ext_force(acts)
    assert got.shape == ref.shape == (3, 2)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, acts)


def _config(tmp_path, name, particles, replace):
    """The port's config ``name`` with its particle file replaced by
    ``particles`` and each (old, new) text of ``replace`` applied."""
    np.save(tmp_path / "particles.npy", particles)
    text = (ROOT / "softmac_tpu_torch/config" / name).read_text()
    for old, new in replace:
        assert old in text
        text = text.replace(old, new)
    (tmp_path / "config.py").write_text(text + "\n_C.RENDERER.image_res = (48, 48)\n_C.RENDERER.ssaa = 1\n")
    return str(tmp_path / "config.py")


def _run(main, tmp_path, config, steps):
    out = main(["--device", "cpu", "--steps", str(steps), "--epochs", "1",
                "--remat", "step", "--config", config, "--log-root",
                str(tmp_path / "logs"), "--exp-name", "t",
                "--render-interval", "1"])
    log = tmp_path / "logs/t"
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"][0])
    np.testing.assert_array_equal(np.load(log / "losses.npy"), out["losses"])
    assert images.gif_info(log / "epoch0.gif") == {
        "size": (48, 48), "frames": steps, "loop": 0}
    return np.load(log / "ckpt/actions_0.npy")


def test_demo_grip_main_on_cpu(tmp_path, monkeypatch):
    config = _config(
        tmp_path, "demo_grip_config.py", _grip_particles(),
        [('"envs/grip/grip_mpm_init_state.npy"',
          repr(str(tmp_path / "particles.npy"))),
         ("    0.0, 0.0,    # finger positions\n"
          "    0.0, 0.0,    # finger velocities",
          "    0.02, -0.02,\n    0.5, -0.5,")])
    grads = []
    inner = TorchEnv.rollout_and_grad

    def keep(self, *args, **kw):
        out = inner(self, *args, **kw)
        grads.append(out["action_grad"])
        return out
    monkeypatch.setattr(TorchEnv, "rollout_and_grad", keep)
    acts = _run(demo_grip.main, tmp_path, config, 4)
    # the demo's choice-2 forces, 0.3 N inward on each finger
    np.testing.assert_array_equal(acts, np.tile([0.3, -0.3], (4, 1)))
    assert float(grads[0].abs().max()) > 0
    curve = images.read_png(tmp_path / "logs/t/loss_curve.png")
    assert curve.shape == (900, 1200, 3)


def test_demo_pour_vel_main_on_cpu(tmp_path):
    base = np.load(ROOT / "envs/pour/pour_mpm_init_state_corotated.npy")
    pick = np.random.RandomState(3).choice(base.shape[0], 400, replace=False)
    config = _config(
        tmp_path, "demo_pour_vel_config.py", base[pick, :3],
        [('"envs/pour/pour_mpm_init_state_corotated.npy"',
          repr(str(tmp_path / "particles.npy")))])
    acts = _run(demo_pour_vel.main, tmp_path, config, 6)
    # two actions (the gcd of 100 and 6 steps) of 12; the columns the
    # action scale zeroes get no gradient and stay at 0
    assert acts.shape == (2, 12) and np.isfinite(acts).all()
    np.testing.assert_array_equal(acts[:, demo_pour_vel.ACTION_SCALE == 0],
                                  0.0)
