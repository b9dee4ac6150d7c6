"""PyTorch port: body-body penalty contact in the port's RigidModel
(softmac_tpu_torch.engine.rigid, ``RIGID.body_contact``) and TransportLoss,
against the JAX package, in float64 on the CPU.

- The surface samples (``_surface_points``: welded vertices strided down,
  or filled up with seeded area-weighted samples) of every asset mesh and
  of a cube, bit for bit.
- body_contact_wrenches on two overlapping free cubes (tests/
  test_rigid_contact.py's assets, the SDF baked by the JAX package into a
  temporary directory), moving and spinning, with the viscous friction
  (stick 0) and the stick branch (stick 0.9): within 1e-12, and its vjp
  with respect to the body states within 1e-10.
- 20 steps of the pour's glass settling into the fixed bowl
  (assets/bowl/bowl_fixed.urdf) in both friction branches: q and qd within
  1e-10 (the JAX reference one jitted scan).
- The gradient of a 20-step loss (the pushed cube's final position) with
  respect to the push on the other cube, through the contact and its
  stick branch: autograd against jax.grad, within 1e-8.
- The pour scene with body contact at 200 particles parked away (the glass
  started on the bowl's rim, scripts/demo_body_contact.py's set-up): 3 env
  steps, x, v, q and qd within 1e-8 of JAX's rollout, the bowl moved by
  the contact; step() without the SDF tables raises, as JAX's.
- TransportLoss: the terms on seeded frames within 1e-12 of JAX's; the
  registry; a reduced pour_vel rollout_and_grad with it, finite, with a
  nonzero gradient.
"""
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import softmac_tpu
from softmac_tpu.config.node import CN as JCN
from softmac_tpu.engine import rigid as jrigid
from softmac_tpu.engine.losses import TransportLoss as JTransportLoss
from softmac_tpu.engine.losses import FrameSample as JFrameSample
from softmac_tpu.engine.meshio import load_obj as jload_obj
from softmac_tpu.engine.meshio import load_urdf as jload_urdf
from softmac_tpu.engine.sdf import preprocess_sdf as jpreprocess_sdf
from softmac_tpu.engine.sdf import sdf_params_from_bake as jsdf_params
from softmac_tpu.engine.types import BodyState as JBodyState

import softmac_tpu_torch
from softmac_tpu_torch import images
from softmac_tpu_torch.config.node import CN as TCN
from softmac_tpu_torch.engine import rigid as trigid
from softmac_tpu_torch.engine.losses import LOSS_REGISTRY
from softmac_tpu_torch.engine.losses import FrameSample as TFrameSample
from softmac_tpu_torch.engine.meshio import load_obj as tload_obj
from softmac_tpu_torch.engine.meshio import load_urdf as tload_urdf
from softmac_tpu_torch.engine.sdf import preprocess_sdf as tpreprocess_sdf
from softmac_tpu_torch.engine.sdf import sdf_params_from_bake as tsdf_params
from softmac_tpu_torch.engine.types import BodyState as TBodyState

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
H = 0.05        # the cubes' half-extent


def _close(got, ref, rtol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


@pytest.fixture(scope="module")
def cube(tmp_path_factory):
    """tests/test_rigid_contact.py's solid 1 kg cube (free and fixed at
    (0.5, 0.5, 0.5)), its SDF baked by the JAX package; (directory, the
    JAX and the port's float64 tables)."""
    d = tmp_path_factory.mktemp("cube")
    vs = [(-H, -H, -H), (H, -H, -H), (H, H, -H), (-H, H, -H),
          (-H, -H, H), (H, -H, H), (H, H, H), (-H, H, H)]
    fs = [(0, 3, 2), (0, 2, 1), (4, 5, 6), (4, 6, 7), (0, 1, 5), (0, 5, 4),
          (3, 7, 6), (3, 6, 2), (0, 4, 7), (0, 7, 3), (1, 2, 6), (1, 6, 5)]
    (d / "cube.obj").write_text(
        "".join("v %g %g %g\n" % v for v in vs)
        + "".join("f %d %d %d\n" % (a + 1, b + 1, c + 1) for a, b, c in fs))
    ixx = (8 * H * H) / 12.0
    for name, joint, xyz in (("cube", "floating", "0 0 0"),
                             ("cube_fixed", "fixed", "0.5 0.5 0.5")):
        (d / f"{name}.urdf").write_text(textwrap.dedent(f"""\
            <?xml version="1.0"?>
            <robot name="{name}">
              <link name="world"/>
              <joint name="cube_to_world" type="{joint}">
                <parent link="world"/> <child link="base_link"/>
                <origin xyz="{xyz}" rpy="0 0 0"/>
              </joint>
              <link name="base_link">
                <inertial>
                  <origin rpy="0 0 0" xyz="0 0 0"/> <mass value="1.0"/>
                  <inertia ixx="{ixx}" ixy="0" ixz="0" iyy="{ixx}" iyz="0"
                           izz="{ixx}"/>
                </inertial>
                <collision><geometry><mesh filename="cube.obj"/></geometry>
                </collision>
              </link>
            </robot>
            """))
    v, f = jload_obj(str(d / "cube.obj"))
    jpreprocess_sdf(v, f, d)
    return (d, jsdf_params(jpreprocess_sdf(v, f, d), jnp.float64),
            tsdf_params(tpreprocess_sdf(v, f, d), torch.float64))


def _cfg(CN, init_state, stick, stiffness=1e4, damping=10.0,
         gravity=(0.0, 0.0, 0.0)):
    cfg = CN()
    cfg.gravity = gravity
    cfg.init_state = init_state
    cfg.enable_floor = False
    cfg.floor_height = -0.08
    cfg.floor_stiffness = 1e4
    cfg.floor_damping = 10.0
    cfg.ext_grad_scale = 1.0
    cfg.body_contact = True
    cfg.body_contact_stiffness = stiffness
    cfg.body_contact_damping = damping
    cfg.body_contact_friction = 0.5
    cfg.body_contact_stick = stick
    return cfg


def _models(urdfs, init_state, stick, **kw):
    jm = jrigid.RigidModel([jload_urdf(str(u)) for u in urdfs],
                           _cfg(JCN, init_state, stick, **kw), env_dt=1e-3,
                           dtype=jnp.float64)
    tm = trigid.RigidModel([tload_urdf(str(u)) for u in urdfs],
                           _cfg(TCN, init_state, stick, **kw), 1e-3,
                           torch.float64)
    return jm, tm


@pytest.mark.parametrize("mesh", ["glass/glass.obj", "bowl/bowl.obj",
                                  "gripper/finger.obj", "gripper/palm.obj",
                                  "door/door.obj", "cube"])
def test_surface_points_bit_for_bit(cube, mesh):
    path = cube[0] / "cube.obj" if mesh == "cube" else ROOT / "assets" / mesh
    v, f = tload_obj(str(path))
    for k in (8, 256):
        got = trigid._surface_points(v, f, k)
        np.testing.assert_array_equal(got, jrigid._surface_points(v, f, k))
        assert got.shape == (min(k, len(got)), 3)


# two free cubes overlapping by 1 cm on x, closing, spinning and sliding
CUBES_Q = [0.1, -0.05, 0.2, 0.5 - H + 0.005, 0.5, 0.5,
           -0.1, 0.15, 0.0, 0.5 + H - 0.005, 0.51, 0.49]
CUBES_QD = [0.3, -0.2, 0.5, 0.4, 0.1, -0.2,
            -0.1, 0.2, 0.1, -0.4, -0.1, 0.3]


@pytest.mark.parametrize("stick", [0.0, 0.9])
def test_body_contact_wrenches_match_jax(cube, stick):
    d, jprim, tprim = cube
    jm, tm = _models([d / "cube.urdf"] * 2, (), stick)
    assert tm._contact_pairs == jm._contact_pairs == [(0, 1)]
    s = (jrigid.RigidState(q=jnp.asarray(CUBES_Q), qd=jnp.asarray(CUBES_QD)),
         trigid.RigidState(q=_t(CUBES_Q), qd=_t(CUBES_QD)))
    jbs, tbs = jm.body_states(s[0]), tm.body_states(s[1])
    ct = np.random.RandomState(1).randn(2, 6)

    def jfn(b):
        return jm.body_contact_wrenches(b, (jprim, jprim))

    # the wrenches and their vjp in one compilation
    ref, jg = jax.jit(lambda b, c: (jfn(b), jax.vjp(jfn, b)[1](c)[0]))(
        jbs, jnp.asarray(ct))
    fields = [getattr(tbs, f).clone().requires_grad_()
              for f in ("pos", "quat", "v", "w")]
    got = tm.body_contact_wrenches(TBodyState(*fields), (tprim, tprim))
    assert np.abs(np.asarray(ref)).max() > 1.0        # in contact
    _close(got.detach(), ref, 1e-12)
    np.testing.assert_allclose(got.detach()[0, :3].numpy(),
                               -got.detach()[1, :3].numpy(), atol=1e-12)
    tg = torch.autograd.grad(got, fields, _t(ct))
    for g, f in zip(tg, ("pos", "quat", "v", "w")):
        _close(g, getattr(jg, f), 1e-10)


def _bowl_models(stick):
    urdfs = [ROOT / "assets/glass/glass.urdf",
             ROOT / "assets/bowl/bowl_fixed.urdf"]
    # the glass just above its rest in the bowl (y ~0.30), falling
    init = (0.05, 0.0, -0.03, 0.66, 0.305, 0.5, 0.0, 0.0, 0.0, 0.0, -0.3, 0.0)
    jm, tm = _models(urdfs, init, stick, stiffness=5e4, damping=100.0,
                     gravity=(0.0, -9.8, 0.0))
    prims = []
    for name in ("glass", "bowl"):
        v, f = jload_obj(str(ROOT / f"assets/{name}/{name}.obj"))
        bake = jpreprocess_sdf(v, f, ROOT / f"assets/{name}")
        prims.append((jsdf_params(bake, jnp.float64),
                      tsdf_params(bake, torch.float64)))
    return jm, tm, tuple(p[0] for p in prims), tuple(p[1] for p in prims)


@pytest.mark.parametrize("stick", [0.0, 0.9])
def test_glass_on_fixed_bowl_matches_jax(stick):
    jm, tm, jprims, tprims = _bowl_models(stick)
    assert [b.jtype for b in tm.bodies] == ["floating", "fixed"]
    ext0 = jnp.zeros((2, 6), jnp.float64)

    def run(s, _):
        s = jm.step(s, None, ext0, prims=jprims)
        return s, (s.q, s.qd, jm.body_contact_wrenches(jm.body_states(s),
                                                        jprims))

    _, (jq, jqd, jw) = jax.jit(lambda s: jax.lax.scan(run, s, None,
                                                      length=20))(
        jm.init_state())
    assert np.abs(np.asarray(jw)).max() > 1.0     # the glass touched
    s = tm.init_state()
    for k in range(20):
        s = tm.step(s, None, torch.zeros(2, 6, dtype=torch.float64),
                    prims=tprims)
        _close(s.q, jq[k], 1e-10)
        _close(s.qd, jqd[k], 1e-10)
    with pytest.raises(ValueError, match="prims"):
        tm.step(s, None, torch.zeros(2, 6, dtype=torch.float64))


def test_body_contact_gradient_matches_jax(cube):
    """d (cube B's x after 20 steps) / d (push on cube A): reachable only
    through the contact, which starts after ~5 steps (the faces 2 mm
    apart, closing at 0.4 m/s)."""
    d, jprim, tprim = cube
    q0 = [0, 0, 0, 0.5 - H - 0.001, 0.5, 0.5, 0, 0, 0, 0.5 + H + 0.001,
          0.5, 0.5]
    qd0 = [0, 0, 0, 0.2, 0, 0.05, 0, 0, 0, -0.2, 0.02, 0]
    jm, tm = _models([d / "cube.urdf"] * 2, tuple(q0 + qd0), 0.9)
    ext0 = jnp.zeros((2, 6), jnp.float64)

    def jloss(push):
        a = jnp.zeros((12,), jnp.float64).at[3:6].set(push)

        def body(s, _):
            return jm.step(s, a, ext0, prims=(jprim, jprim)), None
        s, _ = jax.lax.scan(body, jm.init_state(), None, length=20)
        return s.q[9] + 0.3 * s.q[10] + 0.1 * s.qd[2]

    push0 = np.array([0.5, -0.2, 0.3])
    jg = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(push0)))
    push = _t(push0).requires_grad_()
    a = torch.cat([torch.zeros(3, dtype=torch.float64), push,
                   torch.zeros(6, dtype=torch.float64)])
    s = tm.init_state()
    for _ in range(20):
        s = tm.step(s, a, torch.zeros(2, 6, dtype=torch.float64),
                    prims=(tprim, tprim))
    g, = torch.autograd.grad(s.q[9] + 0.3 * s.q[10] + 0.1 * s.qd[2], push)
    assert np.abs(jg).max() > 0
    _close(g, jg, 1e-8)


def _drop_cfg(load, pkg):
    """scripts/demo_body_contact.py's set-up on the pour config: the
    settle-friendly contact, stick 0.9, the glass started on the bowl's
    rim (the floating bowl at (0.34, 0.127, 0.5))."""
    cfg = load(str(ROOT / pkg / "config/demo_pour_config.py"))
    cfg.defrost()
    cfg.RIGID.body_contact = True
    cfg.RIGID.body_contact_stiffness = 5e4
    cfg.RIGID.body_contact_damping = 100.0
    cfg.RIGID.body_contact_stick = 0.9
    init = list(cfg.RIGID.init_state)
    init[3], init[4], init[5] = 0.34, 0.31, 0.5
    cfg.RIGID.init_state = tuple(init)
    return cfg.freeze()


def _parked(n):
    base = np.load(ROOT / "envs/pour/pour_mpm_init_state_corotated.npy")
    pick = np.random.RandomState(0).choice(base.shape[0], n, replace=False)
    return base[pick, :3] * 0.3 + np.array([0.15, 0.0, 0.15])


def test_pour_with_body_contact_matches_jax():
    jenv = softmac_tpu.SoftMacEnv(_drop_cfg(softmac_tpu.load, "softmac_tpu"),
                                  init_particles=_parked(200))
    tenv = softmac_tpu_torch.SoftMacEnv(
        _drop_cfg(softmac_tpu_torch.load, "softmac_tpu_torch"),
        device="cpu", init_particles=_parked(200))
    assert tenv.rigid_model.body_contact
    acts = np.zeros((3, 12))
    jm, _, jr = jenv.rollout(acts)["carry"]
    tm, _, tr = tenv.rollout(acts)["carry"]
    for got, ref in ((tm.x, jm.x), (tm.v, jm.v), (tr.q, jr.q),
                     (tr.qd, jr.qd)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-8)
    # the contact pushed the floating bowl (the off run leaves it at rest,
    # its ext-force flag off)
    q0 = tenv.rigid_model.init_state().q
    assert (tr.q[6:] - q0[6:]).abs().max() > 1e-9


def test_transport_loss_matches_jax():
    rng = np.random.RandomState(8)
    scene = type("Scene", (), {"dtype": torch.float64, "device": "cpu"})()
    for n in (4, 9):
        x = rng.rand(n, 3)
        pos, v = rng.rand(2, 3), rng.randn(2, 3)
        cfgs = [JCN(), TCN()]
        for c in cfgs:
            c.weight = (1.0, 2.0, 3.0)
            c.target = tuple(rng.rand(3)) if n == 9 else (0.5, 0.4, 0.5)
        cfgs[1].target = cfgs[0].target
        jt = JTransportLoss(cfgs[0], scene).terms(JFrameSample(
            x=jnp.asarray(x), bodies=JBodyState(
                pos=jnp.asarray(pos), quat=jnp.zeros((2, 4)),
                v=jnp.asarray(v), w=jnp.zeros((2, 3)))))
        tt = LOSS_REGISTRY["TransportLoss"](cfgs[1], scene).terms(
            TFrameSample(x=_t(x), bodies=TBodyState(
                pos=_t(pos), quat=torch.zeros(2, 4, dtype=torch.float64),
                v=_t(v), w=torch.zeros(2, 3, dtype=torch.float64))))
        assert set(tt) == set(jt) == {"pose_loss", "vel_loss",
                                      "contact_loss"}
        for k in jt:
            _close(tt[k], jt[k], 1e-12)


def test_transport_loss_rollout_and_grad():
    """tests/test_losses.py's reduced pour_vel scene with TransportLoss on
    the port: finite terms, a finite nonzero action gradient."""
    cfg = softmac_tpu_torch.load(
        str(ROOT / "softmac_tpu_torch/config/demo_pour_vel_config.py"))
    cfg.defrost()
    cfg.SHAPES = [{"shape": "box", "width": (0.15, 0.05, 0.15),
                   "init_pos": [0.7, 0.32, 0.5], "n_particles": 256,
                   "color": 0, "init_rot": None}]
    cfg.ENV.loss_type = "TransportLoss"
    cfg.ENV.loss.weight = (1.0, 1.0, 1.0)
    env = softmac_tpu_torch.SoftMacEnv(cfg.freeze(), device="cpu")
    assert type(env.loss).__name__ == "TransportLoss"
    actions = np.zeros((2, env.action_dim))
    actions[:, 1] = 0.5
    out = env.rollout_and_grad(actions, loss_start_frame=0, loss_stride=2)
    for k in ("pose_loss", "vel_loss", "contact_loss"):
        assert np.isfinite(float(out["terms"][k])), k
    g = out["action_grad"].numpy()
    assert np.isfinite(g).all() and np.abs(g).sum() > 0


def test_drop_overlap_depths_match_jax(tmp_path):
    """demos.demo_body_contact's batched overlap on seeded glass poses in
    and around the bowl, against the JAX script's per-state depth
    (sample_sdf_world of each body's samples in the other's table); a
    facade step with contact on; --render's GIF of the recorded history."""
    from softmac_tpu.engine.sdf import sample_sdf_world
    from softmac_tpu_torch.demos import demo_body_contact as demo

    env = demo.build_env(True, True, device="cpu")
    env.step(np.zeros(env.action_dim))
    rng = np.random.RandomState(9)
    q0 = env.rigid_model.init_state().q.numpy()
    qs = np.repeat(q0[None], 6, axis=0)
    qs[:, :3] += rng.randn(6, 3) * 0.2
    qs[:, 4] = np.linspace(0.2, 0.4, 6)          # through the bowl's rim
    got = demo.overlap_depths(env, _t(qs)).numpy()

    jm = jrigid.RigidModel(
        [jload_urdf(str(ROOT / f"assets/{n}/{n}.urdf"))
         for n in ("glass", "bowl")],
        _drop_cfg(softmac_tpu.load, "softmac_tpu").RIGID, env_dt=1e-3,
        dtype=jnp.float64)
    jprims = []
    for n in ("glass", "bowl"):
        v, f = jload_obj(str(ROOT / f"assets/{n}/{n}.obj"))
        jprims.append(jsdf_params(jpreprocess_sdf(v, f, ROOT / f"assets/{n}"),
                                  jnp.float64))

    def depth_at(q):
        bs = jm.body_states(jrigid.RigidState(q=q, qd=jnp.zeros_like(q)))
        worst = jnp.inf
        for a, b in ((0, 1), (1, 0)):
            pts = jnp.asarray(jm.bodies[a].contact_points)
            p_w = jrigid.Q.qrot(jnp.broadcast_to(bs.quat[a], (len(pts), 4)),
                                pts) + bs.pos[a]
            sdf = sample_sdf_world(
                jprims[b], tuple(bs.pos[b]), tuple(bs.quat[b]),
                (p_w[:, 0], p_w[:, 1], p_w[:, 2]))
            worst = jnp.minimum(worst, sdf.min())
        return worst

    ref = np.asarray(jax.jit(jax.vmap(depth_at))(jnp.asarray(qs)))
    assert (ref < 0).any() and (ref > 0).any()
    _close(got, ref, 1e-10)
    demo.render_gif(env, tmp_path, 1)
    assert images.gif_info(tmp_path / "body_contact.gif") == {
        "size": (512, 512), "frames": 2, "loop": 0}
