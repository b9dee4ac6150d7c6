"""PyTorch port: welds in the port's RigidModel (softmac_tpu_torch.engine.
rigid: a mesh fixed to a moving link, folded into it as one composite
body) and the weld fold of SoftMacEnv.adjust_action_with_ext_force,
against the JAX package, in float64 on the CPU.

- The welded pendulum of tests/test_rigid.py (a revolute rod with a tip
  mass welded on): the kinds, the composite mass, COM and inertia,
  body_states at seeded states, 20 steps with seeded torques and wrenches
  on both rows (the weld's wrench folded onto the rod), under each
  ext-force flag pattern; compensation_mass; within 1e-10 (the JAX
  reference one jitted scan).
- A floating carrier with a plate welded on (tests/test_rigid.py:459's
  carrier), the floor on and the plate in it: 10 steps with seeded
  actions and wrenches, within 1e-10.
- adjust_action_with_ext_force on that carrier scene with a particle blob
  on the welded plate (the trap of test_adjust_action_weld_contact_folds_
  once: the rigid step folds the welds itself, so the compensation's fold
  is a copy): 3 env steps of compensated actions within 1e-10 of JAX's.
"""
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import softmac_tpu
from softmac_tpu.config.node import CN as JCN
from softmac_tpu.engine.meshio import load_obj as jload_obj
from softmac_tpu.engine.meshio import load_urdf as jload_urdf
from softmac_tpu.engine.rigid import RigidModel as JRigidModel
from softmac_tpu.engine.rigid import RigidState as JRigidState
from softmac_tpu.engine.sdf import preprocess_sdf as jpreprocess_sdf

import softmac_tpu_torch
from softmac_tpu_torch.config.node import CN as TCN
from softmac_tpu_torch.engine import rigid as trigid
from softmac_tpu_torch.engine.meshio import load_urdf as tload_urdf

torch.set_num_threads(1)


def _close(got, ref, rtol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _box(path, h):
    verts = [(x, y, z) for x in (-h, h) for y in (-h, h) for z in (-h, h)]
    lines = [f"v {x} {y} {z}" for x, y, z in verts]
    lines += ["f 1 2 4 3", "f 5 7 8 6", "f 1 5 6 2",
              "f 3 4 8 7", "f 1 3 7 5", "f 2 6 8 4"]
    path.write_text("\n".join(lines) + "\n")


def _welded_pendulum(tmp_path, m1=0.3, L1=0.1, m2=0.15, L=0.2):
    """tests/test_rigid.py's welded pendulum, with small inertias."""
    _box(tmp_path / "bit.obj", 0.01)
    urdf = tmp_path / "weld.urdf"
    urdf.write_text(textwrap.dedent(f"""\
        <?xml version="1.0"?>
        <robot name="weldpend">
          <link name="world"/>
          <joint name="j1" type="revolute">
            <parent link="world"/> <child link="rod"/>
            <origin xyz="0.5 0.6 0.5" rpy="0 0 0.2"/> <axis xyz="0 0 1"/>
          </joint>
          <link name="rod">
            <inertial>
              <origin rpy="0 0 0" xyz="0 {-L1} 0"/> <mass value="{m1}"/>
              <inertia ixx="1e-5" ixy="0" ixz="0" iyy="2e-5" iyz="0"
                       izz="3e-5"/>
            </inertial>
            <collision><geometry><mesh filename="bit.obj"/></geometry>
            </collision>
          </link>
          <joint name="wj" type="fixed">
            <parent link="rod"/> <child link="tip"/>
            <origin xyz="0.01 {-L} 0" rpy="0.3 0 0"/>
          </joint>
          <link name="tip">
            <inertial>
              <origin rpy="0 0 0" xyz="0 -0.01 0"/> <mass value="{m2}"/>
              <inertia ixx="1e-5" ixy="0" ixz="0" iyy="1e-5" iyz="0"
                       izz="1e-5"/>
            </inertial>
            <collision><geometry><mesh filename="bit.obj"/></geometry>
            </collision>
          </link>
        </robot>
        """))
    return urdf


def _carrier(tmp_path):
    """tests/test_rigid.py:459's floating carrier with a welded plate."""
    _box(tmp_path / "wbox.obj", 0.04)
    urdf = tmp_path / "carrier.urdf"
    urdf.write_text(textwrap.dedent("""\
        <?xml version="1.0"?>
        <robot name="carrier">
          <link name="world"/>
          <joint name="root" type="floating">
            <parent link="world"/> <child link="base"/>
          </joint>
          <link name="base">
            <inertial>
              <origin rpy="0 0 0" xyz="0 0 0"/> <mass value="0.5"/>
              <inertia ixx="5e-4" ixy="0" ixz="0" iyy="5e-4" iyz="0"
                       izz="5e-4"/>
            </inertial>
            <collision><geometry><mesh filename="wbox.obj"/></geometry>
            </collision>
          </link>
          <joint name="weldj" type="fixed">
            <parent link="base"/> <child link="plate"/>
            <origin xyz="0.12 0 0" rpy="0 0 0"/>
          </joint>
          <link name="plate">
            <inertial>
              <origin rpy="0 0 0" xyz="0 0 0"/> <mass value="0.2"/>
              <inertia ixx="2e-4" ixy="0" ixz="0" iyy="2e-4" iyz="0"
                       izz="2e-4"/>
            </inertial>
            <collision><geometry><mesh filename="wbox.obj"/></geometry>
            </collision>
          </link>
        </robot>
        """))
    return urdf


def _rigid_cfg(CN, init_state, floor=False, gravity=(0.0, -9.8, 0.0)):
    cfg = CN()
    cfg.gravity = gravity
    cfg.init_state = init_state
    cfg.enable_floor = floor
    cfg.floor_height = 0.2
    cfg.floor_stiffness = 1e4
    cfg.floor_damping = 10.0
    cfg.ext_grad_scale = 1.0
    cfg.joint_damping = 0.002
    return cfg


def _models(urdf, init_state, flags=None, **kw):
    jm = JRigidModel([jload_urdf(str(urdf))],
                     _rigid_cfg(JCN, init_state, **kw), env_dt=1e-3,
                     dtype=jnp.float64, ext_force_flags=flags)
    tm = trigid.RigidModel([tload_urdf(str(urdf))],
                           _rigid_cfg(TCN, init_state, **kw), 1e-3,
                           torch.float64, ext_force_flags=flags)
    return jm, tm


def _steps_match(jm, tm, q, qd, acts, exts, rtol=1e-10):
    """len(acts) steps of both from (q, qd): q, qd and body_states after
    each, the JAX side one jitted scan."""
    def run(s, ae):
        s = jm.step(s, ae[0], ae[1])
        b = jm.body_states(s)
        return s, (s.q, s.qd, b.pos, b.quat, b.v, b.w)

    _, refs = jax.jit(lambda s, a, e: jax.lax.scan(run, s, (a, e)))(
        JRigidState(q=jnp.asarray(q), qd=jnp.asarray(qd)), jnp.asarray(acts),
        jnp.asarray(exts))
    ts = trigid.RigidState(q=_t(q), qd=_t(qd))
    for k in range(len(acts)):
        ts = tm.step(ts, _t(acts[k]), _t(exts[k]))
        tb = tm.body_states(ts)
        for got, ref in zip((ts.q, ts.qd, tb.pos, tb.quat, tb.v, tb.w),
                            refs):
            _close(got, ref[k], rtol)


@pytest.mark.parametrize("flags", [None, (False, True), (True, False)])
def test_welded_pendulum_matches_jax(tmp_path, flags):
    jm, tm = _models(_welded_pendulum(tmp_path), (0.0, 0.0), flags)
    assert [b.jtype for b in tm.bodies] == ["revolute", "weld"]
    assert tm.action_dim == 1 and tm.bodies[1].weld_parent == 0
    for jb, tb in zip(jm.bodies, tm.bodies):
        _close(tb.mass, jb.mass, 1e-15)
        _close(tb.com, jb.com, 1e-15)
        _close(tb.inertia, jb.inertia, 1e-15)
    assert tm.compensation_mass(0) is None and tm.compensation_mass(1) is None
    rng = np.random.RandomState(3)
    for q, qd in rng.uniform(-1.0, 1.0, (3, 2)):
        s = (JRigidState(q=jnp.asarray([q]), qd=jnp.asarray([qd])),
             trigid.RigidState(q=_t([q]), qd=_t([qd])))
        jb, tb = jm.body_states(s[0]), tm.body_states(s[1])
        for f in ("pos", "quat", "v", "w"):
            _close(getattr(tb, f), getattr(jb, f), 1e-12)
    _steps_match(jm, tm, [0.4], [-0.3], rng.randn(20, 1) * 0.01,
                 rng.randn(20, 2, 6) * 0.1)


def test_weld_on_floating_carrier_matches_jax(tmp_path):
    """The carrier and its plate resting a few mm into the floor."""
    init = (0.1, -0.2, 0.05, 0.5, 0.235, 0.5)
    jm, tm = _models(_carrier(tmp_path), init + (0.0,) * 6, floor=True)
    assert [b.jtype for b in tm.bodies] == ["floating", "weld"]
    _close(tm.bodies[0].mass, 0.7, 1e-15)
    assert tm.compensation_mass(0) == pytest.approx(0.7, rel=1e-15)
    rng = np.random.RandomState(4)
    _steps_match(jm, tm, init, rng.randn(6) * 0.1, rng.randn(10, 6) * 0.01,
                 rng.randn(10, 2, 6) * 0.05)


def _carrier_env_cfg(get_defaults, CN, urdf):
    """tests/test_rigid.py:459's scene: a blob on the welded plate's top
    face, in contact at t = 0."""
    cfg = get_defaults()
    cfg.control_mode = "rigid"
    cfg.env_dt = 1e-3
    cfg.SIMULATOR.dt = 1e-3
    cfg.SIMULATOR.ptype = 1
    cfg.SIMULATOR.material_model = 0
    cfg.SIMULATOR.E = 50.0
    cfg.SIMULATOR.collision_type = 2
    cfg.SHAPES = [{"shape": "box", "width": (0.05, 0.04, 0.05),
                   "init_pos": [0.62, 0.35, 0.5], "n_particles": 256,
                   "color": 0, "init_rot": None}]
    prim = CN()
    prim.friction = 0.2
    prim.urdf_path = str(urdf)
    prim.enable_external_force = True
    cfg.PRIMITIVES = [prim]
    cfg.RIGID.gravity = (0.0, -9.8, 0.0)
    cfg.RIGID.enable_floor = False
    cfg.RIGID.init_state = (0.0, 0.0, 0.0, 0.5, 0.3, 0.5) + (0.0,) * 6
    cfg.TPU.active_window = (16, 16, 16)
    return cfg


def test_adjust_action_weld_folds_once_matches_jax(tmp_path):
    urdf = _carrier(tmp_path)
    jpreprocess_sdf(*jload_obj(str(tmp_path / "wbox.obj")), tmp_path)
    jenv = softmac_tpu.SoftMacEnv(
        _carrier_env_cfg(softmac_tpu.get_cfg_defaults, JCN, urdf), loss=False)
    tenv = softmac_tpu_torch.SoftMacEnv(
        _carrier_env_cfg(softmac_tpu_torch.get_cfg_defaults, TCN, urdf),
        device="cpu")
    assert [b.jtype for b in tenv.rigid_model.bodies] == ["floating", "weld"]
    acts = np.random.RandomState(6).randn(3, 6) * 0.01
    ref = np.asarray(jenv.adjust_action_with_ext_force(acts))
    got = tenv.adjust_action_with_ext_force(acts)
    # beyond the composite's weight (0.7 x 9.8), the plate's contact
    assert np.abs(ref[:, 4] - acts[:, 4] - 0.7 * 9.8).max() > 1e-6
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-10 * np.abs(ref).max())
