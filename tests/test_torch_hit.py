"""PyTorch port, the slice as a whole: the hit scene (demo_hit_config.py:
two MPM-controlled corotated-elastic cylinders and a box against a towel
hanging from two vertices, forecast mixed cloth contact, ten substeps an
env step, window (32, 24, 32)) of softmac_tpu_torch against the JAX
package, in float64 on the CPU. The cloth modules alone:
test_torch_cloth.py.

- The cylinder and sphere samplers bit for bit against JAX's Shapes, and
  the hit's own 5000 particles.
- HitLoss on hand values and against JAX's.
- The hit env with 300 particles placed in front of the towel's middle
  (init_particles), all on the controller, pushed at -8 on z: 2 env steps
  with loss frames every 7 substeps from 0 (the general path: frames
  inside a window, and frame 0) against JAX's SoftMacEnv.rollout: the
  loss, its terms and the penetration count within 1e-8, the exit
  particles, cloth positions and velocities within 1e-8 of their largest
  |value|, contact ids and penetration bits exact; over 20 particles in
  contact and the vertex forces nonzero. One more env step from JAX's
  exit carry (through softmac_tpu_torch.convert) equals one from the
  port's within 1e-8.
The env's gradient and the trainer: test_torch_demo_hit.py.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import softmac_tpu
from softmac_tpu.engine.losses import FrameSample as JFrameSample
from softmac_tpu.engine.losses.cloth_losses import HitLoss as JHitLoss
from softmac_tpu.engine.shapes import Shapes as JShapes

import softmac_tpu_torch
from softmac_tpu_torch import SoftMacEnv as TorchEnv
from softmac_tpu_torch import convert
from softmac_tpu_torch.engine import mpm as tmpm
from softmac_tpu_torch.engine.losses import LOSS_REGISTRY, FrameSample
from softmac_tpu_torch.engine.shapes import Shapes

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CONFIG = "config/demo_hit_config.py"


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-300))


def test_cylinder_and_sphere_match_jax():
    import math
    rot = [math.cos(math.pi / 4), math.sin(math.pi / 4), 0, 0]
    spec = [
        {"shape": "cylinder", "radius": 0.02, "height": 0.04,
         "init_pos": [0.46, 0.35, 0.47], "n_particles": 300,
         "init_rot": rot},
        {"shape": "sphere", "radius": 0.05, "init_pos": [0.5, 0.4, 0.5],
         "n_particles": 200},
        {"shape": "cylinder", "radius": "0.03", "height": 0.1,
         "init_pos": [0.3, 0.2, 0.4], "n_particles": None},
        {"shape": "sphere", "radius": 0.04, "init_pos": [0.6, 0.3, 0.5],
         "n_particles": None, "init_rot": [0.9, 0.1, 0.3, 0.3]},
        {"shape": "box", "width": (0.12, 0.04, 0.04),
         "init_pos": [0.5, 0.35, 0.51], "n_particles": 100, "color": 7},
    ]
    got, got_colors = Shapes(spec).get()
    want, want_colors = JShapes(spec).get()
    # no n_particles: one particle a small shape, as the reference
    assert got.shape == want.shape == (300 + 200 + 1 + 1 + 100, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_colors, want_colors)
    assert got_colors[-1] == 7
    cfgs = [load(str(ROOT / pkg / CONFIG)) for load, pkg in (
        (softmac_tpu_torch.load, "softmac_tpu_torch"),
        (softmac_tpu.load, "softmac_tpu"))]
    hit, _ = Shapes(cfgs[0].SHAPES).get()
    assert hit.shape == (5000, 3)
    np.testing.assert_array_equal(hit, JShapes(cfgs[1].SHAPES).get()[0])


class _Node(dict):
    __getattr__ = dict.__getitem__


def test_hit_loss_hand_values_and_jax(tmp_path):
    import types
    rng = np.random.RandomState(7)
    tgt, cx = rng.rand(30, 3), rng.rand(30, 3)
    np.save(tmp_path / "target.npy", tgt)
    node = _Node(weight=(1.5,), target_path="target.npy")
    scene = types.SimpleNamespace(search_dirs=[str(tmp_path)],
                                  dtype=torch.float64, device="cpu")
    loss = LOSS_REGISTRY["HitLoss"](node, scene)
    assert loss.term_names == ("pose_loss",)
    t = loss.terms(FrameSample(x=torch.zeros((4, 3)), bodies=None,
                               cloth_x=torch.as_tensor(cx)))
    np.testing.assert_allclose(float(t["pose_loss"]),
                               1.5 * ((cx - tgt) ** 2).sum(), rtol=1e-14)
    t0 = loss.terms(FrameSample(x=torch.zeros((4, 3)), bodies=None,
                                cloth_x=torch.as_tensor(tgt)))
    assert float(t0["pose_loss"]) == 0.0
    jscene = types.SimpleNamespace(search_dirs=[str(tmp_path)],
                                   dtype=jnp.float64)
    jt = JHitLoss(node, jscene).terms(JFrameSample(
        x=jnp.zeros((4, 3)), bodies=None, cloth_x=jnp.asarray(cx)))
    np.testing.assert_allclose(float(t["pose_loss"]), float(jt["pose_loss"]),
                               rtol=1e-14)


def _particles(n=300, seed=8):
    """n points in front (+z) of the towel's middle, 1.5-9 mm off its
    faces: inside the pair search's 1 cm box from the start."""
    from softmac_tpu_torch.engine.cloth import transform_mesh
    from softmac_tpu_torch.engine.meshio import load_obj
    cfg = softmac_tpu_torch.load(str(ROOT / "softmac_tpu_torch" / CONFIG))
    verts, faces = load_obj(ROOT / "envs/assets/towel/towel.obj")
    verts = transform_mesh(verts, dict(cfg.CLOTH.transform[0]))
    tri = verts[faces]
    c = tri.mean(1)
    patch = np.nonzero((np.abs(c[:, 0] - 0.5) < 0.06)
                       & (np.abs(c[:, 1] - 0.45) < 0.05))[0]
    rng = np.random.RandomState(seed)
    f = patch[rng.randint(0, len(patch), n)]
    p = np.einsum("nk,nkd->nd", rng.dirichlet(np.ones(3), n), tri[f])
    nrm = np.cross(tri[f, 1] - tri[f, 0], tri[f, 2] - tri[f, 0])
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm *= np.sign(nrm[:, 2:3])
    return p + nrm * rng.uniform(0.0015, 0.009, (n, 1))


def _hit_env(pkg):
    x = _particles()
    if pkg == "jax":
        env = softmac_tpu.SoftMacEnv(
            softmac_tpu.load(str(ROOT / "softmac_tpu" / CONFIG)),
            init_particles=x)
    else:
        env = TorchEnv(softmac_tpu_torch.load(
            str(ROOT / "softmac_tpu_torch" / CONFIG)), device="cpu",
            init_particles=x)
    env.set_control_idx(np.zeros(len(x), np.int32))
    return env


@pytest.fixture(scope="module")
def tenv():
    return _hit_env("torch")


ACTS = np.array([[0.3, -0.2, -8.0], [-0.1, 0.4, -8.0]])


def test_hit_rollout_matches_jax(tenv):
    cfg = tenv.mpm_cfg
    assert (cfg.substeps, cfg.ptype, cfg.material_model) == (10, 1, 0)
    assert tmpm.transfer_route(cfg) == "transfer" and tenv.action_dim == 3
    block, _, _, include_f0, sub_w = tenv._sample_mask(2, 0, 7)
    assert sub_w is not None and block == 1 and include_f0
    ref = _hit_env("jax").rollout(ACTS, loss_start_frame=0, loss_stride=7)
    forces = []
    step = tenv.cloth_model.step

    def keep(state, attach, ext_f):
        forces.append(ext_f)
        return step(state, attach, ext_f)
    tenv.cloth_model.step = keep
    try:
        got = tenv.rollout(ACTS, loss_start_frame=0, loss_stride=7)
    finally:
        del tenv.cloth_model.step
    assert len(forces) == 2 and float(forces[-1].abs().max()) > 0
    for k in ("pose_loss", "final_pose_loss"):
        _close(float(got["terms"][k]), float(ref["terms"][k]), 1e-8)
    _close(float(got["loss"]), float(ref["loss"]), 1e-8)
    assert int(got["terms"]["n_penetration"]) == int(
        ref["terms"]["n_penetration"])
    assert not bool(got["terms"]["window_overflow"])
    mpm, cloth, pen = got["carry"]
    jmpm, jcloth, jpen = ref["carry"]
    _close(mpm.x.numpy(), np.asarray(jmpm.x), 1e-8)
    _close(cloth.x.numpy(), np.asarray(jcloth.x), 1e-8)
    _close(cloth.v.numpy(), np.asarray(jcloth.v), 1e-8)
    np.testing.assert_array_equal(pen.contact_id.numpy(),
                                  np.asarray(jpen.contact_id))
    np.testing.assert_array_equal(pen.penetration.numpy(),
                                  np.asarray(jpen.penetration))
    assert int((pen.contact_id >= 0).sum()) > 20

    # JAX's exit carry through softmac_tpu_torch.convert: one more env
    # step from it equals one from the port's own exit carry
    jc = (convert.mpm_state({k: np.asarray(getattr(jmpm, k))
                             for k in "xvCF"}),
          convert.cloth_state({"x": np.asarray(jcloth.x),
                               "v": np.asarray(jcloth.v)}),
          convert.penetration_state({
              "contact_id": np.asarray(jpen.contact_id),
              "penetration": np.asarray(jpen.penetration)}))
    assert jc[2].contact_id.dtype == torch.int32
    assert jc[2].penetration.dtype == torch.int8
    kw = dict(loss_start_frame=10, loss_stride=10)
    a = tenv.rollout(ACTS[:1], carry0=jc, **kw)
    b = tenv.rollout(ACTS[:1], carry0=got["carry"], **kw)
    _close(float(a["loss"]), float(b["loss"]), 1e-8)
    _close(a["carry"][1].x.numpy(), b["carry"][1].x.numpy(), 1e-8)
    _close(a["carry"][0].x.numpy(), b["carry"][0].x.numpy(), 1e-8)
