"""PyTorch port: the floating part of the force-controlled RigidModel
(softmac_tpu_torch.engine.rigid) and the quaternion helpers it uses,
against the JAX package (softmac_tpu.engine.rigid / quat) and the NumPy
oracle (tests/oracle.py oracle_floating_step, oracle_body_state_floating),
in float64 on the CPU.

The model is built from the pour config's two URDFs (glass with its
external-force flag on, bowl with it off). States, actions and contact
wrenches are seeded; one case puts the glass below the floor height so that
the floor penalty acts. The step solves for the angular acceleration by
Cramer's rule where JAX calls jnp.linalg.solve: the step's agreement at
1e-12, values and cotangents, holds that solve to it.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import softmac_tpu
from softmac_tpu.engine import quat as jq
from softmac_tpu.engine.meshio import load_urdf as jload_urdf
from softmac_tpu.engine.rigid import RigidModel as JRigidModel
from softmac_tpu.engine.rigid import RigidState as JRigidState
from softmac_tpu.engine.rigid import grad_scale as jgrad_scale
from softmac_tpu.engine.types import BodyState as JBodyState

import softmac_tpu_torch
from softmac_tpu_torch import convert
from softmac_tpu_torch.engine import quat as tq
from softmac_tpu_torch.engine import rigid as trigid
from softmac_tpu_torch.engine.meshio import load_urdf as tload_urdf

sys.path.insert(0, str(Path(__file__).resolve().parent))
from oracle import oracle_body_state_floating, oracle_floating_step  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-12
FLAGS = (True, False)


def _close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


@pytest.fixture(scope="module")
def models():
    paths = [ROOT / "assets/glass/glass.urdf", ROOT / "assets/bowl/bowl.urdf"]
    jcfg = softmac_tpu.load(str(ROOT / "softmac_tpu/config/demo_pour_config.py"))
    tcfg = softmac_tpu_torch.load(
        str(ROOT / "softmac_tpu_torch/config/demo_pour_config.py"))
    jm = JRigidModel([jload_urdf(str(p)) for p in paths], jcfg.RIGID,
                     jcfg.env_dt, jnp.float64, ext_force_flags=FLAGS)
    tm = trigid.RigidModel([tload_urdf(str(p)) for p in paths], tcfg.RIGID,
                           tcfg.env_dt, torch.float64, "cpu",
                           ext_force_flags=FLAGS)
    return jm, tm


def _state(seed, below_floor=False):
    rng = np.random.RandomState(seed)
    q = np.concatenate([0.3 * rng.randn(3), [0.7, 0.3, 0.5],
                        0.3 * rng.randn(3), [0.34, 0.13, 0.5]])
    qd = np.concatenate([rng.randn(3), 0.5 * rng.randn(3),
                         rng.randn(3), 0.5 * rng.randn(3)])
    if below_floor:
        q[4] = -0.12     # the glass's origin under floor_height (-0.08)
        qd[4] = -0.3
    return q, qd, rng


def test_model_matches_jax(models):
    jm, tm = models
    assert (tm.state_dim, tm.action_dim, tm.n_primitives) == (
        jm.state_dim, jm.action_dim, jm.n_primitives)
    for jb, tb in zip(jm.bodies, tm.bodies):
        assert (tb.jtype, tb.q_offset, tb.gravity_on) == (
            jb.jtype, jb.q_offset, jb.gravity_on)
        assert tb.mass == jb.mass
        for k in ("inertia", "com", "support_points", "joint_pos",
                  "joint_rot"):
            np.testing.assert_array_equal(getattr(tb, k), getattr(jb, k))
    for k in ("floor_height", "floor_stiffness", "floor_damping",
              "enable_floor", "dt"):
        assert getattr(tm, k) == getattr(jm, k)
    js, ts = jm.init_state(), tm.init_state()
    np.testing.assert_array_equal(ts.q.numpy(), np.asarray(js.q))
    np.testing.assert_array_equal(ts.qd.numpy(), np.asarray(js.qd))


@pytest.mark.parametrize("seed", [0, 1])
def test_body_states_match_jax_and_oracle(models, seed):
    jm, tm = models
    q, qd, _ = _state(seed)
    got = tm.body_states(convert.rigid_state({"q": q, "qd": qd}))
    ref = jm.body_states(JRigidState(q=jnp.asarray(q), qd=jnp.asarray(qd)))
    for k in ("pos", "quat", "v", "w"):
        _close(getattr(got, k).numpy(), getattr(ref, k))
    for i, b in enumerate(tm.bodies):
        o = b.q_offset
        want = oracle_body_state_floating(q[o:o + 6], qd[o:o + 6], b.com)
        for g, w in zip((got.pos[i], got.quat[i], got.v[i], got.w[i]), want):
            _close(g.numpy(), w)


@pytest.mark.parametrize("seed,below_floor", [(0, False), (1, True)])
def test_step_matches_jax_and_oracle(models, seed, below_floor):
    jm, tm = models
    q, qd, rng = _state(seed, below_floor)
    action = 0.2 * rng.randn(tm.action_dim)
    ext_f = rng.randn(tm.n_primitives, 6)
    got = tm.step(convert.rigid_state({"q": q, "qd": qd}),
                  torch.as_tensor(action), torch.as_tensor(ext_f))
    ref = jm.step(JRigidState(q=jnp.asarray(q), qd=jnp.asarray(qd)),
                  jnp.asarray(action), jnp.asarray(ext_f))
    _close(got.q.numpy(), ref.q)
    _close(got.qd.numpy(), ref.qd)

    fl = [(b.support_points, tm.floor_height, tm.floor_stiffness,
           tm.floor_damping) for b in tm.bodies]
    pen = 0
    for i, b in enumerate(tm.bodies):
        o = b.q_offset
        ext = ext_f[i] * (1.0 if b.gravity_on else 0.0)
        q6, qd6 = oracle_floating_step(
            q[o:o + 6], qd[o:o + 6], mass=b.mass, inertia=b.inertia,
            com=b.com, gravity=tm.gravity, action6=action[o:o + 6],
            ext_f6=ext, dt=tm.dt, gravity_on=b.gravity_on, floor=fl[i])
        _close(got.q[o:o + 6].numpy(), q6)
        _close(got.qd[o:o + 6].numpy(), qd6)
        pts = tq.qrot(tq.w2quat(torch.as_tensor(q[o:o + 3])),
                      torch.as_tensor(b.support_points)) + torch.as_tensor(
                          q[o + 3:o + 6])
        pen += int((pts[:, 1] < tm.floor_height).sum())
    assert (pen > 0) == below_floor
    # without an action the step still runs (zero torque and force)
    tm.step(convert.rigid_state({"q": q, "qd": qd}), None,
            torch.as_tensor(ext_f))


def test_step_vjp_matches_jax(models):
    """Cotangents of (q, qd, action, ext_f) through one step with the glass
    on the floor, against jax.vjp of the JAX step."""
    jm, tm = models
    q, qd, rng = _state(2, below_floor=True)
    action, ext_f = 0.2 * rng.randn(tm.action_dim), rng.randn(2, 6)
    gq, gqd = rng.randn(12), rng.randn(12)

    def jstep(q_, qd_, a_, f_):
        s = jm.step(JRigidState(q=q_, qd=qd_), a_, f_)
        return s.q, s.qd

    _, vjp = jax.vjp(jstep, *(jnp.asarray(a) for a in (q, qd, action, ext_f)))
    ref = vjp((jnp.asarray(gq), jnp.asarray(gqd)))
    ins = [torch.as_tensor(a).requires_grad_() for a in (q, qd, action, ext_f)]
    s = tm.step(trigid.RigidState(q=ins[0], qd=ins[1]), ins[2], ins[3])
    got = torch.autograd.grad((s.q, s.qd), ins,
                              (torch.as_tensor(gq), torch.as_tensor(gqd)))
    for g, r in zip(got, ref):
        _close(g.numpy(), r)


def test_grad_scale_matches_jax():
    rng = np.random.RandomState(4)
    parts = [rng.randn(2, 3), rng.randn(2, 4), rng.randn(2, 3), rng.randn(2, 3)]
    gs = [rng.randn(*p.shape) for p in parts]

    def jfn(pos, quat, v, w):
        b = jgrad_scale(JBodyState(pos=pos, quat=quat, v=v, w=w), 0.025)
        return b.pos, b.quat, b.v, b.w

    outs, vjp = jax.vjp(jfn, *(jnp.asarray(p) for p in parts))
    ref = vjp(tuple(jnp.asarray(g) for g in gs))
    ins = [torch.as_tensor(p).requires_grad_() for p in parts]
    b = trigid.grad_scale(trigid.BodyState(*ins), 0.025)
    for o, p in zip((b.pos, b.quat, b.v, b.w), parts):
        np.testing.assert_array_equal(o.detach().numpy(), p)
    got = torch.autograd.grad((b.pos, b.quat, b.v, b.w), ins,
                              [torch.as_tensor(g) for g in gs])
    for g, r in zip(got, ref):
        _close(g.numpy(), r)


def test_quat_functions_match_jax():
    rng = np.random.RandomState(5)
    q = rng.randn(16, 4)
    v = rng.randn(16, 3)
    aa = rng.randn(16, 3)
    aa[0] = 0.0                      # the identity rotation
    tq_, tv, ta = (torch.as_tensor(a) for a in (q, v, aa))
    jq_, jv, ja = (jnp.asarray(a) for a in (q, v, aa))
    _close(tq.qrot(tq_, tv).numpy(), jq.qrot(jq_, jv))
    _close(tq.qconj(tq_).numpy(), jq.qconj(jq_))
    _close(tq.qnormalize(tq_).numpy(), jq.qnormalize(jq_))
    _close(tq.qmul(tq_, tq_.flip(0)).numpy(), jq.qmul(jq_, jq_[::-1]))
    _close(tq.w2quat(ta).numpy(), jq.w2quat(ja))
    _close(tq.quat2w(tq.w2quat(ta)).numpy(), jq.quat2w(jq.w2quat(ja)))
    _close(tq.quat2w(tq_).numpy(), jq.quat2w(jq_))
    _close(tq.quat2mat(tq_).numpy(), jq.quat2mat(jq_))
    for rpy in ((0.0, 0.0, 0.0), (0.3, -1.2, 2.5)):
        _close(tq.rpy2mat(rpy), jq.rpy2mat(rpy))
    # the log map's gradient stays finite at the identity, as JAX's
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64,
                         requires_grad=True)
    g, = torch.autograd.grad(tq.quat2w(ident).sum(), ident)
    jg = jax.grad(lambda a: jnp.sum(jq.quat2w(a)))(
        jnp.asarray([1.0, 0.0, 0.0, 0.0]))
    assert bool(torch.isfinite(g).all())
    _close(g.numpy(), jg)


def test_unported_bodies_raise(tmp_path):
    """The bodies an earlier port refused now build as the JAX package's
    (tests/test_torch_weld.py, test_torch_chain*.py and
    test_torch_body_contact.py hold them to JAX): the palm on a slider,
    whose prismatic fingers hang below it (an articulated tree) or, made
    fixed, are welded onto it, steps as JAX's; body contact builds. What
    the JAX package refuses still raises: a meshless link inside a tree,
    and moving links that no world-jointed root carries (a cycle)."""
    tcfg = softmac_tpu_torch.load(
        str(ROOT / "softmac_tpu_torch/config/demo_grip_config.py"))
    jcfg = softmac_tpu.load(str(ROOT / "softmac_tpu/config/demo_grip_config.py"))
    grip = ROOT / "assets/gripper/gripper.urdf"
    gripper = trigid.RigidModel([tload_urdf(str(grip))], tcfg.RIGID, 1e-3,
                                torch.float64)
    assert [b.jtype for b in gripper.bodies] == ["fixed", "prismatic",
                                                 "prismatic"]
    dcfg = softmac_tpu_torch.load(
        str(ROOT / "softmac_tpu_torch/config/demo_door_config.py"))
    door = trigid.RigidModel([tload_urdf(str(ROOT / "assets/door/door.urdf"))],
                             dcfg.RIGID, 1e-3, torch.float64)
    assert [b.jtype for b in door.bodies] == ["revolute"]
    text = grip.read_text().replace('filename="',
                                    f'filename="{grip.parent}/')
    for cfg in (tcfg, jcfg):
        cfg.defrost()
        cfg.RIGID.init_state = ()
    rng = np.random.RandomState(2)
    for kind, kinds, n_dof in (("prismatic", ["chain"] * 3, 3),
                               ("fixed", ["prismatic", "weld", "weld"], 1)):
        urdf = text.replace('"palm_to_world" type="fixed"',
                            '"palm_to_world" type="prismatic"').replace(
            '_to_palm" type="prismatic"', f'_to_palm" type="{kind}"')
        (tmp_path / "g.urdf").write_text(urdf)
        tm = trigid.RigidModel([tload_urdf(str(tmp_path / "g.urdf"))],
                               tcfg.RIGID, 1e-3, torch.float64)
        jm = JRigidModel([jload_urdf(str(tmp_path / "g.urdf"))], jcfg.RIGID,
                         1e-3, jnp.float64)
        assert [b.jtype for b in tm.bodies] == [b.jtype for b in jm.bodies] \
            == kinds
        assert tm.action_dim == jm.action_dim == n_dof
        q, qd = rng.randn(n_dof) * 0.01, rng.randn(n_dof) * 0.1
        a, ext = rng.randn(n_dof) * 0.1, rng.randn(3, 6) * 0.1
        js = jax.jit(jm.step)(JRigidState(q=jnp.asarray(q), qd=jnp.asarray(qd)),
                              jnp.asarray(a), jnp.asarray(ext))
        ts = tm.step(trigid.RigidState(q=torch.as_tensor(q),
                                       qd=torch.as_tensor(qd)),
                     torch.as_tensor(a), torch.as_tensor(ext))
        _close(ts.q.numpy(), js.q, 1e-10)
        _close(ts.qd.numpy(), js.qd, 1e-10)
    tcfg.RIGID.body_contact = True
    assert trigid.RigidModel([], tcfg.RIGID, 1e-3, torch.float64).body_contact
    tcfg.RIGID.body_contact = False
    # a meshless palm carrying the fingers' tree; the fingers' joints made
    # each other's parents (no root)
    meshless = urdf.replace('"finger1_to_palm" type="fixed"',
                            '"finger1_to_palm" type="prismatic"')
    i = meshless.index('<link name="palm"')
    j = meshless.index("</link>", i)
    meshless = meshless[:i] + '<link name="palm"/>' + meshless[j + 7:]
    cycle = text.replace('<parent link="palm"/>', '<parent link="SWAP"/>', 1)
    cycle = cycle.replace('<parent link="palm"/>', '<parent link="finger1"/>',
                          1).replace('<parent link="SWAP"/>',
                                     '<parent link="finger2"/>')
    for body, what in ((meshless, "meshless"), (cycle, "unsupported topology")):
        (tmp_path / "bad.urdf").write_text(body)
        for model, load, cfg, dt in ((JRigidModel, jload_urdf, jcfg, jnp.float64),
                                     (trigid.RigidModel, tload_urdf, tcfg,
                                      torch.float64)):
            with pytest.raises(NotImplementedError, match=what):
                model([load(str(tmp_path / "bad.urdf"))], cfg.RIGID, 1e-3, dt)
