"""PyTorch port, the slice as a whole: the taco scene (demo_taco_config.py:
a 10 000-particle plastic corotated disk on a 217-vertex tortilla,
mpm_scale 5, sticky cloth contact with both gradient scales at 0.3, ten
substeps an env step, window (48, 24, 48)) in the cloth control mode, of
softmac_tpu_torch against the JAX package, in float64 on the CPU.

- ``ClothModel.attachment_rest_positions`` and the attachment springs
  against JAX's, vertex 193 listed twice: its rest target twice in the
  (51,) vector, its stiffness twice on A's diagonal and on the right-hand
  side.
- TacoLoss and HangLoss on hand values and against JAX's classes.
- ``set_control_mode`` and ``action_dim`` against JAX's env: 0 in the
  config's "mpm" mode, 51 in "cloth", "rigid" leaves it as it was.
- 200 particles of the taco's own disk (a seeded subset, init_particles),
  the first 2 env steps of a 10-step scripted fold (the handles move 0.13
  an env step; compressed into 2 steps the fold flings the cloth at 300
  m/s, and a contact pair then flips on rounding), loss frames every
  env step from 0: against JAX's SoftMacEnv.rollout, the loss and its
  terms within 1e-8, the particles' x and v and the tortilla's x and v
  within 1e-8 of their largest |value|, contact ids and penetration bits
  exact, contact from the first env step. One more env step from JAX's
  exit carry (through softmac_tpu_torch.convert) equals one from the
  port's.
- A cloth-mode action never reaches the particle controllers: with a
  controller in the config, every substep gets no particle action and the
  cloth step gets the action; in "mpm" mode the reverse.
The gradient, the batched rollouts and the trainer:
test_torch_demo_taco.py.
"""
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import softmac_tpu
from softmac_tpu.engine.losses import FrameSample as JFrameSample
from softmac_tpu.engine.losses.cloth_losses import HangLoss as JHangLoss
from softmac_tpu.engine.losses.cloth_losses import TacoLoss as JTacoLoss

import softmac_tpu_torch
from softmac_tpu_torch import SoftMacEnv as TorchEnv
from softmac_tpu_torch import convert
from softmac_tpu_torch.demos.demo_taco import get_init_actions
from softmac_tpu_torch.engine import mpm as tmpm
from softmac_tpu_torch.engine.losses import LOSS_REGISTRY, FrameSample
from softmac_tpu_torch.engine.shapes import Shapes

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CONFIG = "config/demo_taco_config.py"
N = 200
T = 2


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-300))


def taco_cfg(pkg="torch"):
    if pkg == "jax":
        return softmac_tpu.load(str(ROOT / "softmac_tpu" / CONFIG))
    return softmac_tpu_torch.load(str(ROOT / "softmac_tpu_torch" / CONFIG))


def taco_particles(n=N, seed=0):
    """n particles of the taco's own 10 000-particle disk, a seeded
    subset in the sampler's order."""
    x, _ = Shapes(taco_cfg().SHAPES).get()
    rng = np.random.RandomState(seed)
    return x[np.sort(rng.choice(len(x), n, replace=False))]


def taco_env(pkg="torch", n=N, cfg=None):
    """The taco at ``n`` of its particles, in the cloth control mode (as
    demos/demo_taco.py sets it)."""
    x = taco_particles(n)
    if pkg == "jax":
        env = softmac_tpu.SoftMacEnv(taco_cfg("jax"), init_particles=x)
    else:
        env = TorchEnv(cfg or taco_cfg(), device="cpu", init_particles=x)
    env.set_control_mode("cloth")
    return env


@pytest.fixture(scope="module")
def envs():
    # JAX's env runs its first pair search op by op: each op compiled with
    # XLA's optimisations off, the same float64 function in less time
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        jenv = taco_env("jax")
    finally:
        jax.config.update("jax_disable_most_optimizations", False)
    return taco_env("torch"), jenv


def test_taco_control_mode_and_action_dim(envs):
    tenv, jenv = envs
    assert tenv.loss.target_x.shape == (10_000, 3)    # taco_mpm_target.npy
    assert tenv.mpm_scale == jenv.mpm_scale == 5.0
    assert (tenv.mpm_cfg.n_grid, tenv.mpm_cfg.inv_dx) == (64, 12.8)
    assert tenv.action_dim == jenv.action_dim == 51
    fresh = TorchEnv(taco_cfg(), device="cpu", init_particles=taco_particles(20))
    assert (fresh.control_mode, fresh.action_dim) == ("mpm", 0)
    for mode, dim in (("rigid", 0), ("cloth", 51), ("rigid", 51),
                      ("mpm", 0), ("cloth", 51)):
        fresh.set_control_mode(mode)
        assert (fresh.control_mode, fresh.action_dim) == (mode, dim)
    with pytest.raises(ValueError, match="control mode"):
        fresh.set_control_mode("hand")
    cfg = taco_cfg()
    cfg.defrost()
    cfg.control_mode = "cloth"
    built = TorchEnv(cfg.freeze(), device="cpu",
                     init_particles=taco_particles(20))
    assert (built.control_mode, built.action_dim) == ("cloth", 51)
    hit = softmac_tpu_torch.load(
        str(ROOT / "softmac_tpu_torch/config/demo_hit_config.py"))
    hit.defrost()
    del hit["CLOTH"]
    hit.control_mode = "cloth"
    with pytest.raises(ValueError, match="CLOTH"):
        TorchEnv(hit.freeze(), device="cpu", init_particles=taco_particles(20))


def test_attachment_rest_positions_match_jax(envs):
    tenv, jenv = envs
    tm, jm = tenv.cloth_model, jenv.cloth_model
    assert tm.n_vertices == 217 and tenv.cloth_params.faces.shape[0] == 384
    idx = list(tm.attachment_idx)
    assert len(idx) == 17 and idx.count(193) == 2
    a = tm.attachment_rest_positions()
    assert a.shape == (51,)
    np.testing.assert_array_equal(a, jm.attachment_rest_positions())
    first, last = 3 * idx.index(193), 3 * (len(idx) - 1)
    np.testing.assert_array_equal(a[first:first + 3], a[last:last + 3])
    np.testing.assert_allclose(tm._Ainv.numpy(), np.asarray(jm._Ainv),
                               rtol=0, atol=1e-12 * float(tm._Ainv.abs().max()))
    # the two springs of vertex 193 pull it to the sum of its two targets
    rng = np.random.RandomState(3)
    target = a + rng.uniform(-0.05, 0.05, a.shape)
    ext = rng.randn(tm.n_vertices, 3)
    state = tm.init_state()
    got, _ = tm._base_rhs_and_pred(state, torch.as_tensor(target),
                                   torch.as_tensor(ext))
    want, _ = jm._base_rhs_and_pred(jm.init_state(), jnp.asarray(target),
                                    jnp.asarray(ext))
    _close(got.numpy(), np.asarray(want), 1e-14)
    alone, _ = tm._base_rhs_and_pred(state, None, torch.as_tensor(ext))
    k = tm.attachment_stiffness
    pull = target[first:first + 3] + target[last:last + 3]
    np.testing.assert_allclose((got - alone)[193].numpy(),
                               k * (pull - 2 * a[first:first + 3]),
                               rtol=1e-9)


class _Node(dict):
    __getattr__ = dict.__getitem__


def _scenes(tmp_path):
    return (types.SimpleNamespace(search_dirs=[str(tmp_path)],
                                  dtype=torch.float64, device="cpu"),
            types.SimpleNamespace(search_dirs=[str(tmp_path)],
                                  dtype=jnp.float64))


def test_taco_loss_hand_values_and_jax(tmp_path):
    rng = np.random.RandomState(2)
    x, tgt = rng.rand(12, 3), rng.rand(9, 3)
    np.save(tmp_path / "target.npy", tgt)
    node = _Node(weight=(1.5,), target_path="target.npy")
    scene, jscene = _scenes(tmp_path)
    loss = LOSS_REGISTRY["TacoLoss"](node, scene)
    assert loss.term_names == ("chamfer_loss",)
    t = loss.terms(FrameSample(x=torch.as_tensor(x), bodies=None))
    d2 = ((x[:, None] - tgt[None]) ** 2).sum(-1)
    np.testing.assert_allclose(float(t["chamfer_loss"]),
                               1.5 * (d2.min(1).sum() + d2.min(0).sum()),
                               rtol=1e-12)
    jt = JTacoLoss(node, jscene).terms(JFrameSample(x=jnp.asarray(x),
                                                    bodies=None))
    np.testing.assert_allclose(float(t["chamfer_loss"]),
                               float(jt["chamfer_loss"]), rtol=1e-14)


def test_hang_loss_hand_values_and_jax(tmp_path):
    rng = np.random.RandomState(2)
    x, cx, tgt = rng.rand(12, 3), rng.rand(9, 3), rng.rand(9, 3)
    cv = rng.rand(9, 3) * 0.1
    node = _Node(weight=(1.0, 0.25))
    scene, jscene = _scenes(tmp_path)
    hang = LOSS_REGISTRY["HangLoss"](node, scene)
    assert hang.term_names == ("pose_loss", "vel_loss")
    assert hang.target_x is None
    hang.set_target(tgt)
    sample = FrameSample(x=torch.as_tensor(x), bodies=None,
                         cloth_x=torch.as_tensor(cx),
                         cloth_v=torch.as_tensor(cv))
    t = hang.terms(sample)
    np.testing.assert_allclose(float(t["pose_loss"]),
                               ((cx - tgt) ** 2).sum(), rtol=1e-12)
    np.testing.assert_allclose(float(t["vel_loss"]),
                               0.25 * (cv ** 2).sum(), rtol=1e-12)
    jt = JHangLoss(node, jscene, target=tgt).terms(JFrameSample(
        x=jnp.asarray(x), bodies=None, cloth_x=jnp.asarray(cx),
        cloth_v=jnp.asarray(cv)))
    for k in ("pose_loss", "vel_loss"):
        np.testing.assert_allclose(float(t[k]), float(jt[k]), rtol=1e-14)
    t2 = LOSS_REGISTRY["HangLoss"](node, scene, target=tgt).terms(sample)
    assert float(t2["pose_loss"]) == float(t["pose_loss"])


def test_taco_rollout_matches_jax(envs):
    tenv, jenv = envs
    cfg = tenv.mpm_cfg
    assert (cfg.substeps, cfg.ptype, cfg.material_model) == (10, 0, 0)
    assert tmpm.transfer_route(cfg) == "transfer"
    # the first T env steps of a 10-step scripted fold
    acts = get_init_actions(10, tenv, choice=1)[:T]
    assert np.abs(acts[-1] - acts[0]).max() > 0.1
    kw = dict(loss_start_frame=0, loss_stride=tenv.substeps)
    ref = jenv.rollout(acts, **kw)
    forces = []
    step = tenv.cloth_model.step

    def keep(state, attach, ext_f):
        forces.append(ext_f)
        return step(state, attach, ext_f)
    tenv.cloth_model.step = keep
    try:
        got = tenv.rollout(acts, **kw)
    finally:
        del tenv.cloth_model.step
    assert len(forces) == T and all(float(f.abs().max()) > 0 for f in forces)
    for k in ("chamfer_loss", "final_chamfer_loss"):
        _close(float(got["terms"][k]), float(ref["terms"][k]), 1e-8)
    _close(float(got["loss"]), float(ref["loss"]), 1e-8)
    assert int(got["terms"]["n_penetration"]) == int(
        ref["terms"]["n_penetration"])
    assert not bool(got["terms"]["window_overflow"])
    mpm, cloth, pen = got["carry"]
    jmpm, jcloth, jpen = ref["carry"]
    _close(mpm.x.numpy(), np.asarray(jmpm.x), 1e-8)
    _close(mpm.v.numpy(), np.asarray(jmpm.v), 1e-8)
    _close(cloth.x.numpy(), np.asarray(jcloth.x), 1e-8)
    _close(cloth.v.numpy(), np.asarray(jcloth.v), 1e-8)
    np.testing.assert_array_equal(pen.contact_id.numpy(),
                                  np.asarray(jpen.contact_id))
    np.testing.assert_array_equal(pen.penetration.numpy(),
                                  np.asarray(jpen.penetration))
    assert int((pen.contact_id >= 0).sum()) > 20
    rest = tenv.cloth_model.init_state().x
    assert float((cloth.x - rest).abs().max()) > 0.1

    # JAX's exit carry through softmac_tpu_torch.convert: one more env
    # step from it equals one from the port's own exit carry
    jc = (convert.mpm_state({k: np.asarray(getattr(jmpm, k))
                             for k in "xvCF"}),
          convert.cloth_state({"x": np.asarray(jcloth.x),
                               "v": np.asarray(jcloth.v)}),
          convert.penetration_state({
              "contact_id": np.asarray(jpen.contact_id),
              "penetration": np.asarray(jpen.penetration)}))
    more = dict(loss_start_frame=tenv.substeps, loss_stride=tenv.substeps)
    a = tenv.rollout(acts[-1:], carry0=jc, **more)
    b = tenv.rollout(acts[-1:], carry0=got["carry"], **more)
    _close(float(a["loss"]), float(b["loss"]), 1e-8)
    _close(a["carry"][1].x.numpy(), b["carry"][1].x.numpy(), 1e-8)
    _close(a["carry"][0].x.numpy(), b["carry"][0].x.numpy(), 1e-8)


def test_cloth_action_never_reaches_particle_controllers(monkeypatch):
    cfg = taco_cfg()
    cfg.defrost()
    cfg.SIMULATOR.n_controllers = 1
    env = taco_env(n=40, cfg=cfg.freeze())
    env.set_control_idx(np.zeros(env.n_particles, np.int32))
    assert env.action_dim == 51
    seen = {"mpm": [], "cloth": []}
    substep = tmpm.substep_cloth

    def spy(*args):
        seen["mpm"].append(args[-1])
        return substep(*args)
    monkeypatch.setattr(tmpm, "substep_cloth", spy)
    step = env.cloth_model.step

    def spy_step(state, attach, ext_f):
        seen["cloth"].append(attach)
        return step(state, attach, ext_f)
    env.cloth_model.step = spy_step
    act = get_init_actions(1, env, choice=0) + 0.01
    env.rollout(act)
    assert len(seen["mpm"]) == env.substeps
    assert all(a is None for a in seen["mpm"])
    np.testing.assert_array_equal(seen["cloth"][0].numpy(), act[0])
    env.set_control_mode("mpm")
    assert env.action_dim == 3
    env.rollout(np.array([[0.0, 0.0, -1.0]]))
    assert all(a.shape == (1, 3) for a in seen["mpm"][env.substeps:])
    assert seen["cloth"][1] is None
