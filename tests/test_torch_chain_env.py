"""PyTorch port: articulated trees in the port's RigidModel
(softmac_tpu_torch.engine.rigid) and in the env, against the JAX package,
in float64 on the CPU.

- RigidModel on tree URDFs (tests/test_chain.py's two-link pendulum with a
  limited second joint, its Y branch, the flybot: a floating base carrying
  an arm): the detected tree and its BFS parents, 5 steps with seeded
  actions and wrenches, the floor penalty acting, q, qd and body_states
  within 1e-10 (the JAX reference one jitted scan); compensation_mass of
  the floating root, with and without its arm's ext-force flag.
- The chain env of tests/test_chain.py (a double pendulum swinging into an
  elastic blob, 300 particles): arm.obj baked by the JAX package's
  preprocess_sdf in a temporary directory, the port built on that cache;
  3 env steps, x, v, q and qd within 1e-8 of JAX's; the swing differs from
  the free pendulum's; rollout_and_grad under remat "step" equals remat
  "none" (the tree's derivatives inside a checkpoint).
"""
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import softmac_tpu
from softmac_tpu.config.node import CN as JCN
from softmac_tpu.engine.meshio import load_urdf as jload_urdf
from softmac_tpu.engine.rigid import RigidModel as JRigidModel
from softmac_tpu.engine.rigid import RigidState as JRigidState

import softmac_tpu_torch
from softmac_tpu_torch.config.node import CN as TCN
from softmac_tpu_torch.engine import rigid as trigid
from softmac_tpu_torch.engine.meshio import load_urdf as tload_urdf

torch.set_num_threads(1)

G = 9.8


def _close(got, ref, rtol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


# ---------------------------------------------------------------------------
# RigidModel on tree URDFs
# ---------------------------------------------------------------------------
_BOX = textwrap.dedent("""\
    v -0.01 -0.01 -0.01
    v -0.01 -0.01 0.01
    v -0.01 0.01 -0.01
    v -0.01 0.01 0.01
    v 0.01 -0.01 -0.01
    v 0.01 -0.01 0.01
    v 0.01 0.01 -0.01
    v 0.01 0.01 0.01
    f 1 2 4 3
    f 5 7 8 6
    f 1 5 6 2
    f 3 4 8 7
    f 1 3 7 5
    f 2 6 8 4
    """)


def _link(name, mass, com, inertia="0"):
    return f"""
  <link name="{name}">
    <inertial>
      <origin rpy="0 0 0" xyz="{com}"/> <mass value="{mass}"/>
      <inertia ixx="{inertia}" ixy="0" ixz="0" iyy="{inertia}" iyz="0"
               izz="{inertia}"/>
    </inertial>
    <collision><geometry><mesh filename="tip.obj"/></geometry></collision>
  </link>"""


def _joint_xml(name, jtype, parent, child, xyz, extra=""):
    return f"""
  <joint name="{name}" type="{jtype}">
    <parent link="{parent}"/> <child link="{child}"/>
    <origin xyz="{xyz}" rpy="0 0 0"/> <axis xyz="0 0 1"/>{extra}
  </joint>"""


def _urdf(tmp_path, kind):
    """tests/test_chain.py's tree URDFs: the two-link pendulum (with a Y
    branch) and the flybot (a floating base carrying a revolute arm)."""
    (tmp_path / "tip.obj").write_text(_BOX)
    if kind == "flybot":
        body = (_joint_xml("root", "floating", "world", "body", "0.5 0.5 0.5")
                + _link("body", 0.5, "0 0 0", "1e-3")
                + _joint_xml("shoulder", "revolute", "body", "arm",
                             "0.05 0 0")
                + _link("arm", 0.2, "0 -0.2 0", "1e-4"))
    else:
        body = (_joint_xml("j1", "revolute", "world", "arm1", "0 0 0")
                + _link("arm1", 0.7, "0 -0.5 0")
                + _joint_xml("j2", "revolute", "arm1", "arm2", "0 -0.5 0",
                             '\n    <limit lower="-1.0" upper="1.0" '
                             'velocity="3.0" effort="1"/>')
                + _link("arm2", 1.3, "0 -0.8 0"))
        if kind == "branch":
            body += (_joint_xml("j3", "revolute", "arm1", "arm3", "0 -0.5 0")
                     + _link("arm3", 0.4, "0 -0.35 0"))
    path = tmp_path / f"{kind}.urdf"
    path.write_text(f'<?xml version="1.0"?>\n<robot name="{kind}">\n'
                    f'  <link name="world"/>{body}\n</robot>\n')
    return path


def _rigid_cfg(CN, floor_height):
    cfg = CN()
    cfg.gravity = (0.0, -G, 0.0)
    cfg.init_state = ()
    cfg.enable_floor = True
    cfg.floor_height = floor_height
    cfg.floor_stiffness = 1e4
    cfg.floor_damping = 10.0
    cfg.ext_grad_scale = 1.0
    cfg.joint_damping = 0.01
    return cfg


# kind: (BFS parents, dofs, floor height: the lower link's origin, or the
# flybot's base, a few mm into the floor)
URDF_TREES = {"pendulum": ([-1, 0], 2, -0.46), "branch": ([-1, 0, 0], 3, -0.46),
              "flybot": ([-1, 0], 7, 0.45)}


def _models(tmp_path, kind, flags=None):
    path = _urdf(tmp_path, kind)
    floor = URDF_TREES[kind][2]
    jm = JRigidModel([jload_urdf(str(path))], _rigid_cfg(JCN, floor),
                     env_dt=1e-3, dtype=jnp.float64, ext_force_flags=flags)
    tm = trigid.RigidModel([tload_urdf(str(path))], _rigid_cfg(TCN, floor),
                           1e-3, torch.float64, ext_force_flags=flags)
    return jm, tm


@pytest.mark.parametrize("kind", list(URDF_TREES))
def test_rigid_model_tree_matches_jax(tmp_path, kind):
    jm, tm = _models(tmp_path, kind)
    parents, n_dof, _ = URDF_TREES[kind]
    assert [b.jtype for b in tm.bodies] == [b.jtype for b in jm.bodies] \
        == ["chain"] * len(parents)
    assert tm._chains[0]["chain"].parents == parents
    assert tm.action_dim == jm.action_dim == n_dof
    rng = np.random.RandomState(len(kind))
    q = rng.uniform(-1.0, 1.0, n_dof) * 0.5
    if kind == "flybot":
        q[3:6] = [0.5, 0.455, 0.5]       # the base's corners in the floor
    qd = rng.uniform(-1.0, 1.0, n_dof)
    acts = rng.randn(5, n_dof) * 0.05
    exts = rng.randn(5, len(parents), 6) * 0.1

    def run(s, ae):
        s = jm.step(s, ae[0], ae[1])
        b = jm.body_states(s)
        return s, (s.q, s.qd, b.pos, b.quat, b.v, b.w)

    _, refs = jax.jit(lambda s, a, e: jax.lax.scan(run, s, (a, e)))(
        JRigidState(q=jnp.asarray(q), qd=jnp.asarray(qd)), jnp.asarray(acts),
        jnp.asarray(exts))
    ts = trigid.RigidState(q=_t(q), qd=_t(qd))
    floor = 0.0
    for k in range(5):
        bs = tm.body_states(ts)
        # the lowest support corner of each link's +-0.01 box
        floor = max(floor, float((URDF_TREES[kind][2] + 0.01
                                  - bs.pos[:, 1]).max()))
        ts = tm.step(ts, _t(acts[k]), _t(exts[k]))
        tb = tm.body_states(ts)
        for got, ref in zip((ts.q, ts.qd, tb.pos, tb.quat, tb.v, tb.w),
                            refs):
            _close(got, ref[k], 1e-10)
    assert floor > 0, "the floor penalty never acted"
    if kind == "flybot":
        assert tm.compensation_mass(0) == pytest.approx(0.7, rel=1e-15)
        assert tm.compensation_mass(1) is None
        _, tm2 = _models(tmp_path, kind, flags=(True, False))
        assert tm2.compensation_mass(0) == pytest.approx(0.5, rel=1e-15)


# ---------------------------------------------------------------------------
# the chain env
# ---------------------------------------------------------------------------
def _chain_env_cfg(get_defaults, CN, urdf):
    cfg = get_defaults()
    cfg.control_mode = "rigid"
    cfg.env_dt = 1e-3
    cfg.SIMULATOR.dt = 1e-3
    cfg.SIMULATOR.E = 50.0
    cfg.SIMULATOR.ptype = 1
    cfg.SIMULATOR.material_model = 0
    cfg.SIMULATOR.ground_friction = 0.0
    cfg.SIMULATOR.collision_type = 2
    cfg.SHAPES = [{"shape": "box", "width": (0.06, 0.08, 0.06),
                   "init_pos": [0.60, 0.47, 0.5], "n_particles": 300,
                   "color": 0, "init_rot": None}]
    prim = CN()
    prim.friction = 0.1
    prim.urdf_path = str(urdf)
    prim.enable_external_force = True
    cfg.PRIMITIVES = [prim]
    cfg.RIGID.gravity = (0.0, -9.8, 0.0)
    cfg.RIGID.enable_floor = False
    cfg.RIGID.init_state = (1.2, 0.0, 0.0, 0.0)
    cfg.TPU.active_window = (24, 24, 16)
    # a loss for the gradient: the arm's tip pulled to a target, its
    # speed, each half of the blob's distance to it
    cfg.ENV.loss_type = "TransportLoss"
    cfg.ENV.loss.weight = (1.0, 1.0, 1.0)
    return cfg


def chain_env_urdf(tmp_path):
    """tests/test_chain.py's build_chain_env URDF and arm mesh (a box
    spanning y in [-0.16, 0] of each link), its SDF baked by the JAX
    package's preprocess_sdf into the mesh's directory."""
    from softmac_tpu.engine.meshio import load_obj
    from softmac_tpu.engine.sdf import preprocess_sdf
    L, half, m_arm = 0.16, 0.02, 0.2
    xs = (-half, half)
    verts = [(x, y, z) for x in xs for y in (-L, 0.0) for z in xs]
    lines = [f"v {x} {y} {z}" for x, y, z in verts]
    lines += ["f 1 2 4 3", "f 5 7 8 6", "f 1 5 6 2",
              "f 3 4 8 7", "f 1 3 7 5", "f 2 6 8 4"]
    (tmp_path / "arm.obj").write_text("\n".join(lines) + "\n")
    preprocess_sdf(*load_obj(str(tmp_path / "arm.obj")), tmp_path)
    izz = m_arm * L * L / 12

    def link(name):
        return f"""
  <link name="{name}">
    <inertial>
      <origin rpy="0 0 0" xyz="0 {-L / 2} 0"/>
      <mass value="{m_arm}"/>
      <inertia ixx="{izz}" ixy="0" ixz="0" iyy="1e-5" iyz="0" izz="{izz}"/>
    </inertial>
    <collision><geometry><mesh filename="arm.obj"/></geometry></collision>
  </link>"""
    urdf = tmp_path / "pend_env.urdf"
    urdf.write_text(
        '<?xml version="1.0"?>\n<robot name="pend_env">\n'
        '  <link name="world"/>'
        + _joint_xml("j1", "revolute", "world", "arm1", "0.5 0.7 0.5")
        + link("arm1")
        + _joint_xml("j2", "revolute", "arm1", "arm2", f"0 {-L} 0")
        + link("arm2") + "\n</robot>\n")
    return urdf


def test_chain_env_matches_jax(tmp_path):
    urdf = chain_env_urdf(tmp_path)
    cfgs = [_chain_env_cfg(softmac_tpu.get_cfg_defaults, JCN, urdf),
            _chain_env_cfg(softmac_tpu_torch.get_cfg_defaults, TCN, urdf)]
    for cfg in cfgs:
        # the lower arm already through the blob, swinging on
        cfg.RIGID.init_state = (0.45, 0.0, -1.0, 0.0)
    jenv = softmac_tpu.SoftMacEnv(cfgs[0])
    tenv = softmac_tpu_torch.SoftMacEnv(cfgs[1], device="cpu")
    assert [b.jtype for b in tenv.rigid_model.bodies] == ["chain", "chain"]
    acts = np.random.RandomState(5).randn(3, 2) * 1e-3
    jm, _, jr = jenv.rollout(acts)["carry"]
    tm, _, tr = tenv.rollout(acts)["carry"]
    for got, ref in ((tm.x, jm.x), (tm.v, jm.v), (tr.q, jr.q),
                     (tr.qd, jr.qd)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-8)
    # the blob's wrench moved the swing away from the free pendulum's
    free = tenv.rigid_model.init_state()
    for a in acts:
        free = tenv.rigid_model.step(free, _t(a),
                                     torch.zeros(2, 6, dtype=torch.float64))
    assert (tr.qd - free.qd).abs().max() > 1e-6
    # remat "step" (the tree's derivatives inside a checkpoint) = "none"
    outs = [tenv.rollout_and_grad(acts, loss_start_frame=0, loss_stride=1,
                                  remat=r) for r in ("step", "none")]
    g = [o["action_grad"].numpy() for o in outs]
    assert np.abs(g[1]).max() > 0
    np.testing.assert_allclose(g[0], g[1], rtol=0,
                               atol=1e-12 * np.abs(g[1]).max())


def _flybot_env_cfg(get_defaults, CN, urdf):
    """tests/test_chain.py's test_adjust_action_holds_floating_chain: the
    flybot above a small blob far from it (no contact)."""
    cfg = get_defaults()
    cfg.control_mode = "rigid"
    cfg.env_dt = 1e-3
    cfg.SIMULATOR.dt = 1e-3
    cfg.SIMULATOR.ptype = 1
    cfg.SIMULATOR.material_model = 0
    cfg.SIMULATOR.E = 50.0
    cfg.SIMULATOR.collision_type = 2
    cfg.SHAPES = [{"shape": "box", "width": (0.04, 0.04, 0.04),
                   "init_pos": [0.15, 0.8, 0.15], "n_particles": 64,
                   "color": 0, "init_rot": None}]
    prim = CN()
    prim.friction = 0.1
    prim.urdf_path = str(urdf)
    prim.enable_external_force = True
    cfg.PRIMITIVES = [prim]
    cfg.RIGID.gravity = (0.0, -G, 0.0)
    cfg.RIGID.enable_floor = False
    cfg.RIGID.init_state = (0.0, 0.0, 0.0, 0.5, 0.5, 0.5, 0.0) + (0.0,) * 7
    cfg.TPU.active_window = (16, 16, 16)
    return cfg


def test_adjust_action_floating_chain_matches_jax(tmp_path):
    """adjust_action_with_ext_force compensates a floating tree root for
    its whole subtree's weight (0.5 + 0.2 kg), as JAX's: 4 env steps of
    seeded actions within 1e-10."""
    from softmac_tpu.engine.meshio import load_obj
    from softmac_tpu.engine.sdf import preprocess_sdf
    urdf = _urdf(tmp_path, "flybot")
    preprocess_sdf(*load_obj(str(tmp_path / "tip.obj")), tmp_path)
    jenv = softmac_tpu.SoftMacEnv(
        _flybot_env_cfg(softmac_tpu.get_cfg_defaults, JCN, urdf), loss=False)
    tenv = softmac_tpu_torch.SoftMacEnv(
        _flybot_env_cfg(softmac_tpu_torch.get_cfg_defaults, TCN, urdf),
        device="cpu")
    acts = np.random.RandomState(2).randn(4, 7) * 0.01
    ref = np.asarray(jenv.adjust_action_with_ext_force(acts))
    got = tenv.adjust_action_with_ext_force(acts)
    np.testing.assert_allclose(got[:, 4] - acts[:, 4], 0.7 * G, rtol=1e-12)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-10 * np.abs(ref).max())
