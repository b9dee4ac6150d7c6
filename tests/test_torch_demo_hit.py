"""PyTorch port: the hit's gradient and its trainer, in float64 on the CPU
(the scene against JAX's rollout: test_torch_hit.py).

- The hit env of test_torch_hit.py (300 particles in front of the towel's
  middle, all on the controller, pushed at -8 on z), 2 env steps with the
  demo's loss (the final frame only): the action gradient under remat
  "none" and "step" within 1e-12 of each other, nonzero, and within 1e-5
  of the port's own float64 central differences at a step of 5e-4 (at
  0.05 they miss by 1 %: contact pairs switch; JAX's rollout_and_grad of
  this env costs ~50 s to compile here, so the gradient's JAX side is
  test_torch_cloth.py's vjps and the substep's).
- The trainer (softmac_tpu_torch.demos.demo_hit) for one epoch on the CPU
  on the scene cut to 250 particles, with --render-interval 1 (48 px
  frames: a GIF of a frame a step); the hit built in the cloth control
  mode takes its towel's two handles as the action (action_dim 6).
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import softmac_tpu_torch
from softmac_tpu_torch import SoftMacEnv as TorchEnv
from softmac_tpu_torch import images
from softmac_tpu_torch.demos import demo_hit

from test_torch_hit import ACTS, CONFIG, _close, _hit_env

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def test_hit_grad_remats_and_finite_differences():
    env = _hit_env("torch")
    frames = 2 * env.substeps
    kw = dict(loss_start_frame=frames, loss_stride=frames)
    outs = {r: env.rollout_and_grad(ACTS, remat=r, **kw)
            for r in ("none", "step")}
    g = outs["none"]["action_grad"].numpy()
    assert np.abs(g).max() > 0
    _close(float(outs["step"]["loss"]), float(outs["none"]["loss"]), 1e-12)
    _close(outs["step"]["action_grad"].numpy(), g, 1e-12)
    eps = 5e-4
    d = np.random.RandomState(9).randn(*ACTS.shape)
    lp, lm = (float(env.rollout(ACTS + s * eps * d, **kw)["loss"])
              for s in (1.0, -1.0))
    np.testing.assert_allclose(float(np.sum(g * d)), (lp - lm) / (2 * eps),
                               rtol=1e-5)


def test_demo_hit_main_on_cpu(tmp_path):
    text = (ROOT / "softmac_tpu_torch" / CONFIG).read_text()
    for old, new in (('"n_particles": 2000', '"n_particles": 100'),
                     ('"n_particles": 1000', '"n_particles": 50')):
        assert old in text
        text = text.replace(old, new)
    (tmp_path / "config.py").write_text(text + "\n_C.RENDERER.image_res = (48, 48)\n_C.RENDERER.ssaa = 1\n")
    out = demo_hit.main(["--device", "cpu", "--steps", "2", "--epochs", "1",
                         "--config", str(tmp_path / "config.py"),
                         "--log-root", str(tmp_path / "logs"),
                         "--exp-name", "t", "--render-interval", "1"])
    log = tmp_path / "logs/t"
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"][0])
    np.testing.assert_array_equal(np.load(log / "losses.npy"), out["losses"])
    acts = np.load(log / "ckpt/actions_0.npy")
    np.testing.assert_array_equal(acts, np.tile([0.0, 0.0, -8.0], (2, 1)))
    assert images.gif_info(log / "epoch0.gif") == {
        "size": (48, 48), "frames": 2, "loop": 0}
    assert (log / "loss_curve.png").exists()
    cfg = softmac_tpu_torch.load(str(tmp_path / "config.py"))
    cfg.defrost()
    cfg.control_mode = "cloth"
    env = TorchEnv(cfg.freeze(), device="cpu")
    assert (env.control_mode, env.action_dim) == ("cloth", 6)
