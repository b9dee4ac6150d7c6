"""PyTorch port: the grip slice's RigidModel (softmac_tpu_torch.engine.
rigid) against the JAX package's, in float64 on the CPU: prismatic and
fixed bodies, and any mix of kinds in one model.

- The gripper (assets/gripper/gripper.urdf): the kinds [fixed, prismatic,
  prismatic]; 50 steps with seeded actions and contact wrenches, q, qd
  and body_states within 1e-12 of JAX's (the demo's RIGID, and one with
  gravity along the fingers' axis, joint damping and one finger's
  external-force flag off); both joint limits engaged by a large action;
  the gradient of a projection of q and qd after 20 steps with respect to
  the actions and the wrenches, autograd against jax.grad, within 1e-10.
- Mixed models: the glass's URDF with the door's (floating + revolute),
  and glass, door, gripper and glass again (every kind, interleaved, so
  that the kinds' rows are gathered back into body and dof order): 8
  steps within 1e-12, the floor penalty acting, and one step's cotangents
  against jax.vjp.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import softmac_tpu
from softmac_tpu.engine.meshio import load_urdf as jload_urdf
from softmac_tpu.engine.rigid import RigidModel as JRigidModel
from softmac_tpu.engine.rigid import RigidState as JRigidState

import softmac_tpu_torch
from softmac_tpu_torch.engine import rigid as trigid
from softmac_tpu_torch.engine.meshio import load_urdf as tload_urdf

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GRIPPER = ROOT / "assets/gripper/gripper.urdf"
GLASS = ROOT / "assets/glass/glass.urdf"
DOOR = ROOT / "assets/door/door.urdf"


def _close(got, ref, rtol=1e-12):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


def _models(paths, flags=None, **rigid):
    """Both packages' RigidModel on the URDFs, from the grip config's
    RIGID with ``rigid``'s entries replaced."""
    models = []
    for load, pkg, model, dtype, kw in (
            (softmac_tpu.load, "softmac_tpu", JRigidModel, jnp.float64, {}),
            (softmac_tpu_torch.load, "softmac_tpu_torch", trigid.RigidModel,
             torch.float64, {"device": "cpu"})):
        cfg = load(str(ROOT / pkg / "config/demo_grip_config.py"))
        cfg.defrost()
        for k, v in rigid.items():
            cfg.RIGID[k] = v
        urdf = (jload_urdf if pkg == "softmac_tpu" else tload_urdf)
        models.append(model([urdf(str(p)) for p in paths], cfg.RIGID,
                            cfg.env_dt, dtype, ext_force_flags=flags, **kw))
    return models


# the demo's RIGID; and gravity along the fingers' axis, joint damping and
# the second finger's external-force flag off
GRIPPERS = {"demo": ({}, None),
            "gravity_damping": (dict(gravity=(2.0, -9.8, 0.5),
                                     joint_damping=0.4),
                                (True, True, False))}


@pytest.fixture(scope="module", params=list(GRIPPERS))
def grippers(request):
    rigid, flags = GRIPPERS[request.param]
    return _models([GRIPPER], flags, **rigid)


def _rollout_both(jm, tm, q0, qd0, acts, ext):
    """Both models stepped from (q0, qd0) with acts[t] and ext[t], q, qd
    and body_states compared at every step; returns the torch states."""
    js = JRigidState(q=jnp.asarray(q0), qd=jnp.asarray(qd0))
    ts = trigid.RigidState(q=torch.as_tensor(q0), qd=torch.as_tensor(qd0))
    jstep, jstates = jax.jit(jm.step), jax.jit(jm.body_states)
    states = []
    for a, f in zip(acts, ext):
        js = jstep(js, jnp.asarray(a), jnp.asarray(f))
        ts = tm.step(ts, torch.as_tensor(a), torch.as_tensor(f))
        _close(ts.q.numpy(), js.q)
        _close(ts.qd.numpy(), js.qd)
        jb, tb = jstates(js), tm.body_states(ts)
        for k in ("pos", "quat", "v", "w"):
            _close(getattr(tb, k).numpy(), getattr(jb, k))
        states.append(ts)
    return states


def test_gripper_kinds(grippers):
    jm, tm = grippers
    assert [b.jtype for b in tm.bodies] == [b.jtype for b in jm.bodies] \
        == ["fixed", "prismatic", "prismatic"]
    assert [b.q_offset for b in tm.bodies] == [b.q_offset for b in jm.bodies]
    assert (tm.action_dim, tm.state_dim, tm.n_primitives) == (
        jm.action_dim, jm.state_dim, jm.n_primitives) == (2, 4, 3)
    assert all(tm.compensation_mass(i) is None for i in range(3))


def test_gripper_steps_match_jax(grippers):
    jm, tm = grippers
    rng = np.random.RandomState(0)
    acts = rng.randn(50, 2) * 2.0
    ext = rng.randn(50, 3, 6) * 0.5
    states = _rollout_both(jm, tm, np.zeros(2), np.zeros(2), acts, ext)
    assert np.abs(states[-1].q.numpy()).max() > 1e-4


def test_gripper_limits_match_jax(grippers):
    """A large action drives both fingers outward into the velocity limit
    (10) and the position stops (+-3), where qd is zeroed."""
    jm, tm = grippers
    acts = np.tile([-1e5, 1e5], (6, 1))
    ext = np.zeros((6, 3, 6))
    states = _rollout_both(jm, tm, np.array([-2.975, 2.975]), np.zeros(2),
                           acts, ext)
    qd = np.array([s.qd.numpy() for s in states])
    q = np.array([s.q.numpy() for s in states])
    assert np.abs(qd).max() == 10.0
    np.testing.assert_array_equal(q[-1], [-3.0, 3.0])
    np.testing.assert_array_equal(qd[-1], [0.0, 0.0])


def test_gripper_grad_matches_jax(grippers):
    jm, tm = grippers
    rng = np.random.RandomState(1)
    T = 20
    acts = rng.randn(T, 2)
    ext = rng.randn(T, 3, 6) * 0.5
    cq, cqd = rng.randn(2), rng.randn(2)

    def jloss(a, f):
        s = jm.init_state()
        for t in range(T):
            s = jm.step(s, a[t], f[t])
        return jnp.sum(s.q * cq) + jnp.sum(s.qd * cqd)
    ga, gf = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(acts),
                                             jnp.asarray(ext))
    a, f = (torch.as_tensor(v).requires_grad_() for v in (acts, ext))
    s = tm.init_state()
    for t in range(T):
        s = tm.step(s, a[t], f[t])
    loss = torch.sum(s.q * torch.as_tensor(cq)) + torch.sum(
        s.qd * torch.as_tensor(cqd))
    ta, tf = torch.autograd.grad(loss, (a, f))
    _close(ta.numpy(), ga, 1e-10)
    _close(tf.numpy(), gf, 1e-10)
    assert np.abs(np.asarray(ga)).max() > 0


MIXES = {"glass_door": [GLASS, DOOR],
         "interleaved": [GLASS, DOOR, GRIPPER, GLASS]}


def _mixed_state(tm, rng):
    """A seeded state of a mixed model: each floating body's lowest
    corners a few mm into the floor (the glass reaches 0.235 below its
    origin), so that the penalty acts; small rates."""
    q = rng.randn(tm.state_dim_half) * 0.05
    qd = rng.randn(tm.state_dim_half) * 0.3
    for b in tm.bodies:
        if b.jtype == "floating":
            q[b.q_offset + 3:b.q_offset + 6] = (0.5, 0.153, 0.5)
    return q, qd


@pytest.mark.parametrize("mix", list(MIXES))
def test_mixed_model_matches_jax(mix):
    paths = MIXES[mix]
    jm, tm = _models(paths, init_state=(), joint_damping=0.2)
    kinds = [b.jtype for b in tm.bodies]
    assert kinds == [b.jtype for b in jm.bodies]
    assert {"floating", "revolute"} <= set(kinds)
    rng = np.random.RandomState(2)
    q0, qd0 = _mixed_state(tm, rng)
    acts = rng.randn(8, tm.action_dim) * 0.05
    ext = rng.randn(8, tm.n_primitives, 6) * 0.05
    _rollout_both(jm, tm, q0, qd0, acts, ext)
    # the floor penalty acts on a floating body in the first step
    s = trigid.RigidState(q=torch.as_tensor(q0), qd=torch.as_tensor(qd0))
    k = [k for k in tm._kinds if k.kind == "floating"][0]
    q6 = trigid._take(s.q, k.dof_sel).reshape(-1, 6)
    bs = tm.body_states(s)
    qd6 = trigid._take(s.qd, k.dof_sel).reshape(-1, 6)
    f_fl, _ = tm._floor_wrench(k, q6[:, 3:],
                               trigid._take(bs.quat, k.slot_sel),
                               qd6[:, 3:], qd6[:, :3])
    assert float(f_fl.abs().max()) > 0

    ins = (q0, qd0, acts[0], ext[0])

    def jstep(q, qd, a, f):
        s = jm.step(JRigidState(q=q, qd=qd), a, f)
        b = jm.body_states(s)
        return s.q, s.qd, b.pos, b.quat, b.v
    shapes = jax.eval_shape(jstep, *map(jnp.asarray, ins))
    cts = [rng.randn(*o.shape) for o in shapes]
    ref = jax.jit(lambda i, c: jax.vjp(jstep, *i)[1](c))(
        tuple(map(jnp.asarray, ins)), tuple(map(jnp.asarray, cts)))
    tin = [torch.as_tensor(v).requires_grad_() for v in ins]
    s = tm.step(trigid.RigidState(q=tin[0], qd=tin[1]), tin[2], tin[3])
    b = tm.body_states(s)
    got = torch.autograd.grad((s.q, s.qd, b.pos, b.quat, b.v), tin,
                              tuple(map(torch.as_tensor, cts)))
    for g, r in zip(got, ref):
        _close(g.numpy(), r)
