"""PyTorch port, the slice as a whole: the grip scene (demo_grip_config.py:
a corotated-plastic block squeezed by two prismatic fingers below a fixed
palm, forecast mixed contact, five substeps an env step, window
(32, 24, 32)) of softmac_tpu_torch against the JAX package, in float64 on
the CPU. Its RigidModel: test_torch_grip_rigid.py.

- The config copy: tests/test_torch_package.py.
- GripLoss on the hand values of tests/test_losses.py and on a seeded
  sample against JAX's; PourLoss on its hand values.
- The grip env, 200 of the scene's particles (RandomState(5), as
  tests/test_env.py), the fingers started 0.02 inward, their inner faces
  at the block's edge, and moving in at 0.5 m/s, the palm's contact off:
  3 env steps with loss stride 7 (the general path: frames inside a
  window) against JAX's rollout, loss, terms, the final x and the rigid
  q and qd within 1e-8; the mixed contact called 2 x 5 times an env
  step. The action gradient (2 env steps, stride 10: one loss block of
  two env steps) under remat "none", "step" and "window:2" within 1e-12
  of each other, nonzero, and within 1e-3 of the port's own float64
  central differences along a seeded direction (not closer: the SVD's
  backward clamps its denominators, as the JAX package's does). JAX's
  rollout_and_grad of this env costs ~50 s to compile, so the gradient's
  JAX side is the rigid step's (test_torch_grip_rigid.py) and the
  substep's (the port's other tests).
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import softmac_tpu
from softmac_tpu.engine.losses import FrameSample as JFrameSample
from softmac_tpu.engine.losses import GripLoss as JGripLoss
from softmac_tpu.engine.types import BodyState as JBodyState

import softmac_tpu_torch
from softmac_tpu_torch import SoftMacEnv as TorchEnv
from softmac_tpu_torch.engine import mpm as tmpm
from softmac_tpu_torch.engine.losses import LOSS_REGISTRY, FrameSample
from softmac_tpu_torch.engine.types import BodyState

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# the fingers 0.02 inward, their inner faces at the block's edge, moving
# in at 0.5 m/s: in contact within the first env step
NEAR = (0.02, -0.02, 0.5, -0.5)


def _close(got, ref, rtol=1e-12):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


def _cfgs(**rigid):
    """The grip config of both packages, RIGID entries replaced."""
    out = []
    for load, pkg in ((softmac_tpu.load, "softmac_tpu"),
                      (softmac_tpu_torch.load, "softmac_tpu_torch")):
        cfg = load(str(ROOT / pkg / "config/demo_grip_config.py"))
        cfg.defrost()
        for k, v in rigid.items():
            cfg.RIGID[k] = v
        out.append(cfg.freeze())
    return out


class _Node(dict):
    """Attribute and get view of a loss cfg node."""
    __getattr__ = dict.__getitem__


def _scene(tmp_path, target):
    import types
    np.save(tmp_path / "target.npy", target)
    return types.SimpleNamespace(search_dirs=[str(tmp_path)],
                                 dtype=torch.float64, device="cpu")


def _bodies(pos, quat=None, v=None, w=None):
    n = len(pos)
    t = dict(dtype=torch.float64)
    return BodyState(
        pos=torch.tensor(pos, **t),
        quat=torch.tensor(quat if quat is not None else [[1.0, 0, 0, 0]] * n,
                          **t),
        v=torch.tensor(v if v is not None else np.zeros((n, 3)), **t),
        w=torch.tensor(w if w is not None else np.zeros((n, 3)), **t))


def test_grip_loss_hand_values(tmp_path):
    """tests/test_losses.py's rotation-band cases."""
    loss = LOSS_REGISTRY["GripLoss"](
        _Node(weight=(0.0, 1.0, 0.0), target_path="target.npy"),
        _scene(tmp_path, np.zeros((4, 3))))
    x = torch.zeros((4, 3), dtype=torch.float64)
    for quat, want, tol in (([[0.3, 0.954, 0, 0]], 0.04, 1e-10),
                            ([[0.95, 0.312, 0, 0]], 0.0025, 1e-9),
                            ([[0.7, 0.714, 0, 0]], 0.0, None)):
        t = loss.terms(FrameSample(x=x, bodies=_bodies([[0.0, 0.4, 0.0]],
                                                       quat=quat)))
        if tol is None:
            np.testing.assert_allclose(float(t["pose_loss"]), 0.0,
                                       atol=1e-14)
        else:
            np.testing.assert_allclose(float(t["pose_loss"]), want,
                                       rtol=tol)
    assert loss.term_names == ("chamfer_loss", "pose_loss", "vel_loss")


def test_grip_loss_matches_jax(tmp_path):
    """Every term weighted, on a seeded sample: values within 1e-12 of
    JAX's."""
    rng = np.random.RandomState(6)
    x, tgt = rng.rand(60, 3), rng.rand(45, 3)
    node = _Node(weight=(1.5, 2.0, 0.7), target_path="target.npy")
    scene = _scene(tmp_path, tgt)
    tloss = LOSS_REGISTRY["GripLoss"](node, scene)
    jscene = type(scene)(search_dirs=scene.search_dirs, dtype=jnp.float64)
    jloss = JGripLoss(node, jscene)
    b = [rng.randn(3, 3), rng.randn(3, 4) * 0.4, rng.randn(3, 3),
         rng.randn(3, 3)]

    jt = jloss.terms(JFrameSample(x=jnp.asarray(x), bodies=JBodyState(
        *map(jnp.asarray, b))))
    tt = tloss.terms(FrameSample(x=torch.as_tensor(x), bodies=BodyState(
        *map(torch.as_tensor, b))))
    for k in tloss.term_names:
        assert abs(float(jt[k])) > 0
        _close(float(tt[k]), float(jt[k]))


def test_pour_loss_hand_values(tmp_path):
    """tests/test_losses.py's PourLoss case."""
    rng = np.random.RandomState(0)
    x = rng.rand(20, 3)
    tgt = rng.rand(15, 3)
    loss = LOSS_REGISTRY["PourLoss"](
        _Node(weight=(2.0, 3.0, 0.5), target_path="target.npy"),
        _scene(tmp_path, tgt))
    t = loss.terms(FrameSample(x=torch.as_tensor(x), bodies=_bodies(
        [[0.2, 0.55, 0.3]], v=[[1.0, -2.0, 0.5]], w=[[0.1, 0.2, -0.3]])))
    d2 = ((x[:, None] - tgt[None]) ** 2).sum(-1)
    exp_ch = 2.0 * (d2.min(1).sum() + d2.min(0).sum())
    np.testing.assert_allclose(float(t["chamfer_loss"]), exp_ch, rtol=1e-12)
    np.testing.assert_allclose(float(t["pose_loss"]),
                               3.0 * 10.0 * (0.55 - 0.4) ** 2, rtol=1e-12)
    np.testing.assert_allclose(
        float(t["vel_loss"]),
        0.5 * ((1 + 4 + 0.25) + 0.1 * (0.01 + 0.04 + 0.09)), rtol=1e-12)


def _particles(n=200):
    base = np.load(ROOT / "envs/grip/grip_mpm_init_state.npy")
    pick = np.random.RandomState(5).choice(base.shape[0], n, replace=False)
    return base[pick, :3]


def _grip_env(pkg):
    jcfg, tcfg = _cfgs(init_state=NEAR)
    if pkg == "jax":
        env = softmac_tpu.SoftMacEnv(jcfg, init_particles=_particles())
    else:
        env = TorchEnv(tcfg, device="cpu", init_particles=_particles())
    env.set_primitives_contact([False, True, True])
    return env


@pytest.fixture(scope="module")
def tenv():
    return _grip_env("torch")


ACTS = np.ones((4, 2)) * np.array([1.0, -1.0]) * 0.3


def test_grip_rollout_matches_jax(tenv, monkeypatch):
    cfg = tenv.mpm_cfg
    assert (cfg.substeps, cfg.ptype, cfg.material_model) == (5, 0, 0)
    assert cfg.primitives_contact == (False, True, True)
    assert tmpm.transfer_route(cfg) == "transfer"
    block, _, _, include_f0, sub_w = tenv._sample_mask(3, 0, 7)
    assert sub_w is not None and block == 1 and include_f0
    ref = _grip_env("jax").rollout(ACTS[:3], loss_start_frame=0,
                                   loss_stride=7)
    calls = []
    inner = tmpm.contact_mod.collide_mixed

    def count(*args, **kw):
        calls.append(args[0])
        return inner(*args, **kw)
    monkeypatch.setattr(tmpm.contact_mod, "collide_mixed", count)
    got = tenv.rollout(ACTS[:3], loss_start_frame=0, loss_stride=7)
    assert len(calls) == 2 * 5 * 3
    assert all(p is tenv.prims[1 + i % 2] for i, p in enumerate(calls))
    _close(float(got["loss"]), float(ref["loss"]), 1e-8)
    for k in ("chamfer_loss", "pose_loss", "vel_loss"):
        _close(float(got["terms"][k]), float(ref["terms"][k]), 1e-8)
    assert not bool(got["terms"]["window_overflow"])
    mpm, _, rigid = got["carry"]
    jmpm, _, jrigid = ref["carry"]
    _close(mpm.x.numpy(), np.asarray(jmpm.x), 1e-8)
    _close(rigid.q.numpy(), np.asarray(jrigid.q), 1e-8)
    _close(rigid.qd.numpy(), np.asarray(jrigid.qd), 1e-8)
    # the fingers felt the block: the contact slowed them
    assert abs(float(rigid.qd[0])) < 0.5 + 3 * 1e-3 * 0.3


def test_grip_grad_remats_and_finite_differences(tenv):
    acts = ACTS[:2]
    kw = dict(loss_start_frame=0, loss_stride=10)
    block, n_blocks, _, _, sub_w = tenv._sample_mask(2, 0, 10)
    assert (block, n_blocks, sub_w) == (2, 1, None)
    outs = {r: tenv.rollout_and_grad(acts, remat=r, **kw)
            for r in ("none", "step", "window:2")}
    g = outs["none"]["action_grad"].numpy()
    assert np.abs(g[0]).max() > 0
    for r in ("step", "window:2"):
        _close(float(outs[r]["loss"]), float(outs["none"]["loss"]))
        _close(outs[r]["action_grad"].numpy(), g)
    # the loss is near linear in the actions: the central differences agree
    # to 2e-8 between steps of 0.1 and 0.03 and lose digits below 1e-3. The
    # gradient is not the forward's exact derivative: the SVD's backward
    # clamps |s_j^2 - s_i^2| to 1e-6 (the JAX package's custom_vjp), and a
    # block at rest has F near a rotation, all s_j^2 near 1
    eps = 0.03
    d = np.random.RandomState(9).randn(*acts.shape)
    lp, lm = (float(tenv.rollout(acts + s * eps * d, **kw)["loss"])
              for s in (1.0, -1.0))
    np.testing.assert_allclose(float(np.sum(g * d)), (lp - lm) / (2 * eps),
                               rtol=1e-3)
