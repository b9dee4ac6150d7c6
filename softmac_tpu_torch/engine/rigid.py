"""Rigid bodies: the velocity-controlled model and the floating part of the
force-controlled ``RigidModel`` (``softmac_tpu/engine/rigid.py``).

``RigidVelocityModel`` (reference ``softmac/engine/rigid_simulator_vel.py``)
has no dynamics: actions set each body's (w, v) for the next window and
poses integrate kinematically every substep.

``RigidModel`` is the force-controlled simulator built from URDFs
(reference ``rigid_simulator.py``, Jade free joints), here for bodies on a
floating joint to the world, as in the pour scene: a semi-implicit
Newton-Euler step about the centre of mass with the window-averaged contact
wrench, the actions (a world-frame torque and force at the body origin),
gravity where the primitive's ``enable_external_force`` flag is set, and a
spring-damper floor penalty at the mesh's bounding-box corners. State
layout as the JAX package's: ``q`` = per body [exp(3), pos(3)], ``qd`` =
[w(3), v(3)] world-frame. Every body is floating, so the step runs batched
over the bodies, with no host sync. Revolute, prismatic, fixed and
articulated bodies, welds and body-body contact come with the grip/door
slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from softmac_tpu_torch.engine import quat as Q
from softmac_tpu_torch.engine.meshio import UrdfModel, load_obj
from softmac_tpu_torch.engine.types import BodyState, _Replace

_LATER = ("is not ported yet; it comes with the grip/door slice of the port "
          "(the port's RigidModel steps floating bodies)")


@dataclasses.dataclass
class RigidState(_Replace):
    q: torch.Tensor   # (D,)
    qd: torch.Tensor  # (D,)


class RigidVelocityModel:
    def __init__(self, n_primitives: int, cfg, dtype=torch.float32,
                 device="cpu"):
        self.n_primitives = n_primitives
        self.dtype = dtype
        self.device = torch.device(device)
        init = np.asarray(cfg.init_state, np.float64)
        if init.shape[0] != 12 * n_primitives:
            raise ValueError(f"RIGID.init_state has {init.shape[0]} values, "
                             f"expected 12 per primitive ({n_primitives})")
        self._init = init

    def init_bodies(self) -> BodyState:
        n = self.n_primitives
        pose = torch.as_tensor(self._init[:n * 6].reshape(n, 6))
        vel = torch.as_tensor(self._init[n * 6:].reshape(n, 6))
        quat = Q.w2quat(pose[:, :3])   # in float64, then cast

        def dev(t):
            return t.to(dtype=self.dtype, device=self.device).contiguous()
        return BodyState(pos=dev(pose[:, 3:]), quat=dev(quat),
                         v=dev(vel[:, 3:]), w=dev(vel[:, :3]))

    @staticmethod
    def forward_kinematics(bodies: BodyState, dt: float) -> BodyState:
        """One-substep pose integration (primitive_base.py:280-283)."""
        pos = bodies.pos + bodies.v * dt
        quat = Q.qmul(Q.w2quat(bodies.w * dt), bodies.quat)
        return bodies.replace(pos=pos, quat=quat)

    def apply_action(self, bodies: BodyState, action: torch.Tensor) -> BodyState:
        """Set (w, v) from the action for the coming window
        (primitive_base.py:299-313: action = [w(3), v(3)] per primitive)."""
        a = action.reshape(self.n_primitives, 6).to(self.dtype)
        return bodies.replace(w=a[:, :3].contiguous(), v=a[:, 3:].contiguous())


class GradScale(torch.autograd.Function):
    """Identity whose cotangents are scaled by s: the reference's
    ``ext_grad_scale`` damping of the mpm -> rigid gradient path
    (rigid_simulator.py:150; the JAX package's ``grad_scale`` custom_vjp)."""

    @staticmethod
    def forward(ctx, s, *tensors):
        ctx.s = s
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + tuple(None if g is None else g * ctx.s
                               for g in grads)


def grad_scale(bodies: BodyState, s: float) -> BodyState:
    """``bodies`` unchanged, their cotangents scaled by s."""
    pos, quat, v, w = GradScale.apply(float(s), bodies.pos, bodies.quat,
                                      bodies.v, bodies.w)
    return BodyState(pos=pos, quat=quat, v=v, w=w)


@dataclasses.dataclass
class _BodyDef:
    """One moving collision body = one contact primitive."""
    jtype: str                  # floating (the only type ported)
    q_offset: int               # dof offset into the global q vector
    mass: float
    inertia: np.ndarray         # (3,3) about the COM, inertial frame
    com: np.ndarray             # (3,) link-frame COM (URDF <inertial><origin>)
    joint_pos: np.ndarray       # (3,) world joint origin
    joint_rot: np.ndarray       # (3,3) world joint frame
    gravity_on: bool
    support_points: np.ndarray  # (8,3) body-frame points for floor penalty


def _solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A^-1 b for (..., 3, 3) A by Cramer's rule: a few elementwise ops and
    no host sync (``torch.linalg.solve`` on CUDA checks its result on the
    host). R I R^T is solved as it stands: R from a quaternion normalised
    with the 1e-12 inside the root is a rotation scaled by 1 - O(1e-12), so
    R I^-1 R^T would be off by as much."""
    c0, c1, c2 = A[..., :, 0], A[..., :, 1], A[..., :, 2]
    r0 = torch.cross(c1, c2, dim=-1)
    r1 = torch.cross(c2, c0, dim=-1)
    r2 = torch.cross(c0, c1, dim=-1)
    det = torch.sum(c0 * r0, dim=-1, keepdim=True)
    return torch.stack([torch.sum(r * b, dim=-1) for r in (r0, r1, r2)],
                       dim=-1) / det


def _support_points(verts: np.ndarray) -> np.ndarray:
    """Bounding-box corners of the collision mesh (floor-penalty contacts)."""
    lo, hi = verts.min(0), verts.max(0)
    return np.array([[x, y, z] for x in (lo[0], hi[0])
                     for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])


class RigidModel:
    """Force-controlled rigid simulator built from URDFs (floating bodies).

    ``step(state, action, ext_f) -> state`` and
    ``body_states(state) -> BodyState``, as the JAX package's."""

    def __init__(self, urdf_models: Sequence[UrdfModel], cfg, env_dt: float,
                 dtype=torch.float32, device="cpu",
                 ext_force_flags: Optional[Sequence[bool]] = None):
        self.dt = float(env_dt)
        self.dtype = dtype
        self.device = torch.device(device)
        self.gravity = np.asarray(cfg.gravity, np.float64)
        self.enable_floor = bool(cfg.enable_floor)
        self.floor_height = float(cfg.get("floor_height", -0.08))
        self.floor_stiffness = float(cfg.get("floor_stiffness", 1e4))
        self.floor_damping = float(cfg.get("floor_damping", 10.0))
        if cfg.get("body_contact", False):
            raise NotImplementedError(f"RIGID.body_contact {_LATER}")

        self.bodies: List[_BodyDef] = []
        offset = 0
        for model in urdf_models:
            links = {l.name: l for l in model.links}
            by_child = {j.child: j for j in model.joints}
            ndof_skel = 0
            for j in model.joints:
                link = links[j.child]
                if link.mesh_path is None:
                    continue
                if j.jtype != "floating":
                    raise NotImplementedError(
                        f"a {j.jtype} joint ({j.name}) {_LATER}")
                # the joint frame through the fixed joints above it; a
                # moving ancestor would make an articulated tree
                pos, rot = np.zeros(3), np.eye(3)
                name = j.parent
                while name in by_child:
                    up = by_child[name]
                    if up.jtype != "fixed":
                        raise NotImplementedError(
                            f"link {j.child} below moving link {name}: "
                            f"articulated trees {_LATER}")
                    pos = up.origin_xyz + Q.rpy2mat(up.origin_rpy) @ pos
                    rot = Q.rpy2mat(up.origin_rpy) @ rot
                    name = up.parent
                verts, _ = load_obj(link.mesh_path)
                self.bodies.append(_BodyDef(
                    jtype="floating", q_offset=offset + ndof_skel,
                    mass=float(link.mass),
                    inertia=np.asarray(link.inertia, np.float64),
                    com=np.asarray(link.inertial_origin, np.float64),
                    joint_pos=pos + rot @ j.origin_xyz,
                    joint_rot=rot @ Q.rpy2mat(j.origin_rpy),
                    gravity_on=True,
                    support_points=_support_points(verts)))
                ndof_skel += 6
            offset += ndof_skel
        if ext_force_flags:
            for b, flag in zip(self.bodies, ext_force_flags):
                b.gravity_on = bool(flag)

        self.state_dim_half = offset
        self.state_dim = 2 * offset
        self.action_dim = offset
        self.n_primitives = len(self.bodies)

        if len(cfg.init_state) > 0:
            init = np.asarray(cfg.init_state, np.float64)
            if init.shape[0] != self.state_dim:
                raise ValueError(f"init_state has {init.shape[0]} entries, "
                                 f"expected {self.state_dim}")
            self._q0 = init[:self.state_dim_half]
            self._qd0 = init[self.state_dim_half:]
        else:
            self._q0 = np.zeros(self.state_dim_half)
            self._qd0 = np.zeros(self.state_dim_half)

        # per-body constants, batched over the bodies (each body owns the
        # six dofs at 6 * its slot: q.view(B, 6) is [exp, pos] per body)
        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float64)).to(
                dtype=dtype, device=self.device)
        bs = self.bodies
        self._com = dev([b.com for b in bs]).reshape(-1, 3)
        self._inertia = dev([b.inertia for b in bs]).reshape(-1, 3, 3)
        self._mass = dev([b.mass for b in bs]).reshape(-1, 1)
        self._gravity_on = dev([1.0 if b.gravity_on else 0.0
                                for b in bs]).reshape(-1, 1)
        self._gravity_masked = not all(b.gravity_on for b in bs)
        self._support = dev([b.support_points for b in bs]).reshape(-1, 8, 3)
        self._g = dev(self.gravity)

    def compensation_mass(self, slot: int) -> float:
        """The gravity-affected mass the free joint of body ``slot`` holds
        (``adjust_action_with_ext_force``): the body's own mass, every body
        being floating here."""
        return self.bodies[slot].mass

    # ------------------------------------------------------------------
    def init_state(self) -> RigidState:
        def dev(a):
            return torch.as_tensor(a).to(dtype=self.dtype, device=self.device)
        return RigidState(q=dev(self._q0), qd=dev(self._qd0))

    def body_states(self, state: RigidState) -> BodyState:
        """Per-primitive world pose + BODY-frame COM spatial velocity (the
        reference exports DART's ``getCOMSpatialVelocity()``, in body
        coordinates; the contact collider rotates it body -> world)."""
        q = state.q.reshape(-1, 6)
        qd = state.qd.reshape(-1, 6)
        bq = Q.w2quat(q[:, :3])
        bqc = Q.qconj(bq)
        w_b = Q.qrot(bqc, qd[:, :3])
        v_b = Q.qrot(bqc, qd[:, 3:])
        return BodyState(pos=q[:, 3:], quat=bq,
                         v=v_b + torch.cross(w_b, self._com, dim=-1), w=w_b)

    def _floor_wrench(self, pos, bq, v, w):
        """Spring-damper floor penalty at the support points; (B, 3) force
        and torque about the body origin. v, w: world velocity at the
        origin and world angular velocity."""
        pts = self._support
        k = pts.shape[1]
        p_w = Q.qrot(bq[:, None, :].expand(-1, k, 4), pts) + pos[:, None]
        r = p_w - pos[:, None]
        v_pt = v[:, None] + torch.cross(w[:, None].expand_as(r), r, dim=-1)
        pen = self.floor_height - p_w[..., 1]
        active = pen > 0.0
        pen = torch.where(active, pen, 0.0)
        fn = (self.floor_stiffness * pen
              - self.floor_damping * v_pt[..., 1] * active)
        fn = torch.maximum(fn, torch.zeros_like(fn))
        # tangential: viscous friction proportional to the normal force
        zero = torch.zeros_like(fn)
        ft = -torch.stack([v_pt[..., 0], zero, v_pt[..., 2]], dim=-1)
        f = torch.stack([zero, fn, zero], dim=-1) + 2.0 * fn[..., None] * ft
        f = torch.where(active[..., None], f, 0.0)
        return f.sum(dim=1), torch.cross(r, f, dim=-1).sum(dim=1)

    def step(self, state: RigidState, action: Optional[torch.Tensor],
             ext_f: torch.Tensor) -> RigidState:
        """Semi-implicit Euler step. ext_f: (B, 6) window-averaged wrench
        [force, torque about the body origin] per primitive; action: the
        [torque(3), force(3)] per free joint, world frame, at the origin."""
        if action is None:
            action = torch.zeros((self.action_dim,), dtype=self.dtype,
                                 device=self.device)
        a = action.reshape(-1)[:self.action_dim].reshape(-1, 6)
        q = state.q.reshape(-1, 6)
        qd = state.qd.reshape(-1, 6)
        # each primitive's measured wrench is gated by its own ext-force
        # flag; the floor penalty below acts regardless of the flag
        if self._gravity_masked:
            ext_f = ext_f * self._gravity_on
        exp, pos = q[:, :3], q[:, 3:]
        w, v = qd[:, :3], qd[:, 3:]
        bq = Q.w2quat(exp)
        R = Q.quat2mat(bq)
        Rt = R.transpose(-1, -2)
        com = self._com
        r_c = (R @ com[..., None])[..., 0]        # world COM offset

        tau_o = a[:, :3] + ext_f[:, 3:]           # torque about the origin
        force = a[:, 3:] + ext_f[:, :3]           # excludes gravity
        if self.enable_floor:
            f_fl, t_fl = self._floor_wrench(pos, bq, v, w)
            force = force + f_fl
            tau_o = tau_o + t_fl

        # Newton-Euler about the COM: gravity contributes no torque there,
        # origin-referenced wrenches shift by -r_c x F
        tau_c = tau_o - torch.cross(r_c, force, dim=-1)
        force = force + self._gravity_on * (self._mass * self._g)

        I_w = R @ self._inertia @ Rt
        w_dot = _solve3(I_w, tau_c - torch.cross(
            w, (I_w @ w[..., None])[..., 0], dim=-1))
        w_new = w + self.dt * w_dot
        v_c = v + torch.cross(w, r_c, dim=-1)
        v_c_new = v_c + self.dt * force / self._mass
        bq_new = Q.qmul(Q.w2quat(w_new * self.dt), bq)
        r_c_new = Q.qrot(bq_new, com)
        pos_new = (pos + r_c) + self.dt * v_c_new - r_c_new
        v_new = v_c_new - torch.cross(w_new, r_c_new, dim=-1)
        exp_new = Q.quat2w(bq_new)
        return RigidState(q=torch.cat([exp_new, pos_new], dim=-1).reshape(-1),
                          qd=torch.cat([w_new, v_new], dim=-1).reshape(-1))
