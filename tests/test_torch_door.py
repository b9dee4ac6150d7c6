"""PyTorch port, the slice as a whole: the door scene (demo_door_config.py:
three corotated-elastic boxes, one MPM particle controller, forecast mixed
contact against a revolute door, window (32, 16, 32)) of softmac_tpu_torch
against the JAX package and the NumPy oracle, in float64 on the CPU.

- Box sampling: the door's particles bit for bit as JAX's Shapes, and the
  global NumPy random state restored; a rotated box too.
- The revolute RigidModel (door.urdf): body_states and step against JAX at
  1e-12, with the wrench's torque, gravity about the hinge, damping and
  both joint limits engaged; the step's cotangents against jax.vjp.
- DoorLoss: the hand values of tests/test_losses.py.
- One corotated-elastic substep of 300 of the door's particles, shifted
  3 mm toward the door frame's side post and moving into it, with seeded
  C and F, against oracle_substep_mixed at
  1e-10 of each output's largest |value| (the fused route, its plain
  versions).
- The door's rollout and rollout_and_grad against the JAX package:
  test_torch_door_rollout.py.
- The route, from the window alone: the door's substep takes the fused
  family (one call of each of its four transfers), while the pour's
  rollout keeps ops/transfer.py; a scene with no window or a window the
  fused rule refuses takes the dense route.
"""
import sys
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
from softmac_tpu.engine.shapes import Shapes as JShapes

import softmac_tpu_torch
from softmac_tpu_torch import SoftMacEnv as TorchEnv
from softmac_tpu_torch.engine import mpm as tmpm
from softmac_tpu_torch.engine import rigid as trigid
from softmac_tpu_torch.engine.losses import FrameSample
from softmac_tpu_torch.engine.meshio import load_urdf as tload_urdf
from softmac_tpu_torch.engine.shapes import Shapes
from softmac_tpu_torch.engine.types import BodyState, MPMConfig, MPMState
from softmac_tpu_torch.ops import fused, transfer

sys.path.insert(0, str(Path(__file__).resolve().parent))
from oracle import oracle_substep_mixed  # noqa: E402
from test_oracle_coupled import oracle_prim_of  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N = 300
N_STEPS = 3


def _cfg(load, pkg):
    return load(str(ROOT / pkg / "config/demo_door_config.py"))


def _close(got, ref, rtol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


def test_box_sampling_matches_jax():
    cfg = _cfg(softmac_tpu_torch.load, "softmac_tpu_torch")
    np.random.seed(123)
    before = np.random.get_state()[1].copy()
    got, got_colors = Shapes(cfg.SHAPES).get()
    assert np.array_equal(np.random.get_state()[1], before)
    ref, ref_colors = JShapes(_cfg(softmac_tpu.load,
                                   "softmac_tpu").SHAPES).get()
    assert got.shape == (5400, 3)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got_colors, ref_colors)
    spec = [{"shape": "box", "width": 0.05, "init_pos": (0.5, 0.4, 0.5),
             "n_particles": 100, "init_rot": (0.9, 0.1, 0.3, -0.2)},
            {"shape": "box", "width": "(0.02, 0.03, 0.04)",
             "init_pos": "(0.3, 0.2, 0.1)", "n_particles": None}]
    np.testing.assert_array_equal(Shapes(spec).get()[0],
                                  JShapes(spec).get()[0])


@pytest.fixture(scope="module")
def door_models():
    jcfg = _cfg(softmac_tpu.load, "softmac_tpu")
    tcfg = _cfg(softmac_tpu_torch.load, "softmac_tpu_torch")
    path = str(ROOT / "assets/door/door.urdf")
    jm = JRigidModel([jload_urdf(path)], jcfg.RIGID, jcfg.env_dt,
                     jnp.float64, ext_force_flags=(True,))
    tm = trigid.RigidModel([tload_urdf(path)], tcfg.RIGID, tcfg.env_dt,
                           torch.float64, "cpu", ext_force_flags=(True,))
    return jm, tm


# (q, qd, action, torque about y): free swing, the velocity limit (6.545)
# and the position limit (+-3.14) engaged
STATES = [(0.3, -0.7, 2e-5, 3e-6), (1.0, 6.5, 1e-3, 1e-4),
          (3.139, 2.0, 0.0, 1e-5), (-3.139, -2.0, 0.0, -1e-5)]


@pytest.mark.parametrize("q,qd,a,tau", STATES)
def test_revolute_step_and_body_states_match_jax(door_models, q, qd, a,
                                                 tau):
    jm, tm = door_models
    assert (tm.action_dim, tm.state_dim) == (jm.action_dim, jm.state_dim)
    rng = np.random.RandomState(int(abs(q) * 1000))
    ext = rng.randn(1, 6) * 1e-4
    ext[0, 4] = tau
    s = (np.array([q]), np.array([qd]))
    jn = jm.step(JRigidState(q=jnp.asarray(s[0]), qd=jnp.asarray(s[1])),
                 jnp.asarray([a]), jnp.asarray(ext))
    tn = tm.step(trigid.RigidState(q=torch.as_tensor(s[0]),
                                   qd=torch.as_tensor(s[1])),
                 torch.tensor([a], dtype=torch.float64), torch.as_tensor(ext))
    _close(tn.q.numpy(), jn.q, 1e-12)
    _close(tn.qd.numpy(), jn.qd, 1e-12)
    jb, tb = jm.body_states(jn), tm.body_states(tn)
    for k in ("pos", "quat", "v", "w"):
        _close(getattr(tb, k).numpy(), getattr(jb, k), 1e-12)
    if abs(qd) > 6 or abs(q) > 3:
        assert abs(float(tn.qd[0])) < abs(qd)     # a limit acted


def test_revolute_step_vjp_matches_jax(door_models):
    jm, tm = door_models
    rng = np.random.RandomState(3)
    ins = (np.array([0.4]), np.array([-1.2]), np.array([3e-5]),
           rng.randn(1, 6) * 1e-4)
    gq, gqd = rng.randn(1), rng.randn(1)

    def jstep(q, qd, a, f):
        s = jm.step(JRigidState(q=q, qd=qd), a, f)
        b = jm.body_states(s)
        return s.q, s.qd, b.quat
    _, vjp = jax.vjp(jstep, *map(jnp.asarray, ins))
    gquat = rng.randn(1, 4)
    ref = vjp((jnp.asarray(gq), jnp.asarray(gqd), jnp.asarray(gquat)))
    tin = [torch.as_tensor(a).requires_grad_() for a in ins]
    s = tm.step(trigid.RigidState(q=tin[0], qd=tin[1]), tin[2], tin[3])
    got = torch.autograd.grad((s.q, s.qd, tm.body_states(s).quat), tin,
                              tuple(map(torch.as_tensor, (gq, gqd, gquat))))
    for g, r in zip(got, ref):
        _close(g.numpy(), r, 1e-12)


def test_mat2quat_matches_jax():
    """quat.mat2quat on rotations that take each of Shepperd's four
    branches (trace > 0, then the largest diagonal entry x, y, z), values
    and the gradient of a seeded projection against JAX's, at 1e-12."""
    from softmac_tpu.engine import quat as jq
    from softmac_tpu_torch.engine import quat as tq
    rng = np.random.RandomState(8)
    axes = np.array([[0.1, 0.2, 0.3], [np.pi * 0.9, 0.1, 0.0],
                     [0.0, np.pi * 0.9, 0.1], [0.1, 0.0, np.pi * 0.9],
                     [0.0, 0.0, 0.0]])
    m = np.asarray(jq.quat2mat(jq.w2quat(jnp.asarray(axes))))
    d = rng.randn(len(axes), 4)
    ref = jq.mat2quat(jnp.asarray(m))
    jg = jax.grad(lambda a: jnp.sum(jq.mat2quat(a) * d))(jnp.asarray(m))
    tm_ = torch.tensor(m).requires_grad_()
    got = tq.mat2quat(tm_)
    g, = torch.autograd.grad(torch.sum(got * torch.as_tensor(d)), tm_)
    _close(got.detach().numpy(), ref, 1e-12)
    assert bool(torch.isfinite(g).all())
    _close(g.numpy(), jg, 1e-12)


def test_door_loss_hand_values():
    """tests/test_losses.py's DoorLoss case."""
    from softmac_tpu_torch.engine.losses import LOSS_REGISTRY

    class _W(dict):
        weight = (1.0, 0.5, 2.0)
    loss = LOSS_REGISTRY["DoorLoss"](_W(), None)
    x = np.array([[0.5, 0.5, 0.5], [0.3, 0.3, 0.3], [0.11, 0.1, 0.1]])
    t64 = dict(dtype=torch.float64)
    b = BodyState(pos=torch.tensor([[0.1, 0.1, 0.1]], **t64),
                  quat=torch.tensor([[0.9, 0.436, 0, 0]], **t64),
                  v=torch.tensor([[0.2, 0.0, 0.0]], **t64),
                  w=torch.zeros((1, 3), **t64))
    t = loss.terms(FrameSample(x=torch.as_tensor(x), bodies=b))
    np.testing.assert_allclose(float(t["pose_loss"]),
                               (0.9 - np.cos(np.pi / 8)) ** 2, rtol=1e-12)
    np.testing.assert_allclose(float(t["vel_loss"]), 0.5 * 0.04, rtol=1e-12)
    d2 = ((x - np.array([0.1, 0.1, 0.1])) ** 2).sum(-1)
    exp = 2.0 * np.maximum(d2 - 0.01, 0.0).min() ** 2
    np.testing.assert_allclose(float(t["contact_loss"]), exp, rtol=1e-10)
    assert loss.term_names == ("pose_loss", "vel_loss", "contact_loss")


def _particles(n=N):
    cfg = _cfg(softmac_tpu_torch.load, "softmac_tpu_torch")
    p, _ = Shapes(cfg.SHAPES).get()
    return p[np.random.RandomState(3).choice(p.shape[0], n, replace=False)]


@pytest.fixture(scope="module")
def envs():
    x0 = _particles()
    jenv = softmac_tpu.SoftMacEnv(_cfg(softmac_tpu.load, "softmac_tpu"),
                                  init_particles=x0)
    tenv = TorchEnv(_cfg(softmac_tpu_torch.load, "softmac_tpu_torch"),
                    device="cpu", init_particles=x0)
    for env in (jenv, tenv):
        env.set_control_idx(np.zeros(env.n_particles, np.int32))
    return jenv, tenv


def test_elastic_substep_matches_oracle(envs):
    jenv, tenv = envs
    cfg = tenv.mpm_cfg
    assert (cfg.material_model, cfg.ptype, cfg.n_controllers) == (0, 1, 1)
    rng = np.random.RandomState(11)
    mpm0, bodies, _ = tenv._initial_carry()
    # the boxes start in the frame's opening, 5.01 mm (just beyond the
    # contact threshold) from its +x post at the closest
    x = mpm0.x.numpy().T + np.array([0.003, 0.0, 0.0])
    v = 0.3 * rng.randn(N, 3) + np.array([1.0, 0.0, 0.0])
    C = 2.0 * rng.randn(N, 3, 3)
    F = np.eye(3) + 0.05 * rng.randn(N, 3, 3)
    t = torch.as_tensor
    state = MPMState(x=t(x.T.copy()), v=t(v.T.copy()),
                     C=t(np.moveaxis(C, 0, -1).copy()),
                     F=t(np.moveaxis(F, 0, -1).copy()))
    new, ext_f, aux = tmpm.substep(cfg, tenv.mpm_params, tenv.prims, state,
                                   bodies, 0)
    assert tmpm.transfer_route(cfg) == "fused"
    p = tenv.mpm_params
    ox, ov, oC, oF, owr = oracle_substep_mixed(
        x, v, C, F, dt=cfg.dt, n_grid=cfg.n_grid, mu=float(p.mu[0]),
        lam=float(p.lam[0]), gravity=p.gravity.numpy(),
        prims=[oracle_prim_of(jenv.prims[0])],
        bodies=[tuple(getattr(bodies, k)[0].numpy()
                      for k in ("pos", "quat", "v", "w"))],
        frictions=p.friction.numpy(), softnesses=p.softness.numpy(),
        life=1.0, material_model=0, ptype=1,
        ground_friction=cfg.ground_friction,
        push_cap=cfg.contact_push_velocity_cap)
    assert not bool(aux["window_overflow"])
    assert np.abs(owr).max() > 0, "the contact did not engage"
    _close(new.x.numpy().T, ox, 1e-10)
    _close(new.v.numpy().T, ov, 1e-10)
    _close(np.moveaxis(new.C.numpy(), -1, 0), oC, 1e-10)
    _close(np.moveaxis(new.F.numpy(), -1, 0), oF, 1e-10)
    _close(ext_f.numpy(), owr, 1e-10)


def _actions():
    a = 5.0 * np.random.RandomState(7).randn(N_STEPS, 3)
    a[:, 2] -= 40.0                  # push the boxes into the door
    return a


def _counting(monkeypatch, module, names):
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(module, name)

        def counted(*a, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*a)
        monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("window,route", [
    ((32, 16, 32), "fused"),          # the door: wy < 24
    ((32, 32, 16), "transfer"),       # the pour: the chunked rule holds
    ((40, 32, 16), "transfer"),       # pour_vel
    ((36, 16, 32), "dense"),          # wx not a multiple of 8
    ((32, 48, 32), "dense"),          # wy * wz > 1280
    (None, "dense"),                  # no window: the full grid
])
def test_route_rule(window, route):
    cfg = MPMConfig(n_particles=8, active_window=window)
    assert tmpm.transfer_route(cfg) == route


def test_routes(envs, monkeypatch):
    """One door env step runs each dense-weight transfer once and no
    ops/transfer.py one; the pour's rollout runs ops/transfer.py only."""
    _, tenv = envs
    names = ("p2g", "g2p", "gather", "splat")
    f = _counting(monkeypatch, fused, names)
    c = _counting(monkeypatch, transfer, names)
    tenv.rollout(_actions()[:1])
    assert f == dict.fromkeys(names, 1) and c == dict.fromkeys(names, 0)

    pcfg = softmac_tpu_torch.load(
        str(ROOT / "softmac_tpu_torch/config/demo_pour_config.py"))
    pour = TorchEnv(pcfg, device="cpu", init_particles=np.load(
        ROOT / "envs/pour/pour_mpm_init_state_corotated.npy")[:200, :3]
        + np.array([0.0, 0.04, 0.0]))
    assert tmpm.transfer_route(pour.mpm_cfg) == "transfer"
    for calls in (f, c):
        calls.update(dict.fromkeys(names, 0))
    pour.rollout(np.zeros((1, pour.action_dim)))
    assert c == dict.fromkeys(names, 1) and f == dict.fromkeys(names, 0)
