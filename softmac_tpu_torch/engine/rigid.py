"""Rigid bodies: the velocity-controlled model and the floating part of the
force-controlled ``RigidModel`` (``softmac_tpu/engine/rigid.py``).

``RigidVelocityModel`` (reference ``softmac/engine/rigid_simulator_vel.py``)
has no dynamics: actions set each body's (w, v) for the next window and
poses integrate kinematically every substep.

``RigidModel`` is the force-controlled simulator built from URDFs
(reference ``rigid_simulator.py``, Jade joints) for bodies jointed to the
world (through fixed joints only) in one of two ways:
- floating, as in the pour scene: a semi-implicit Newton-Euler step about
  the centre of mass with the window-averaged contact wrench, the actions
  (a world-frame torque and force at the body origin), gravity where the
  primitive's ``enable_external_force`` flag is set, and a spring-damper
  floor penalty at the mesh's bounding-box corners;
- revolute (or continuous), as the door's hinge: the torque about the
  joint axis from the action, the wrench and gravity, the parallel-axis
  inertia about the axis, implicit viscous ``joint_damping``, and the
  URDF's velocity and position limits.
State layout as the JAX package's: ``q`` = per floating body [exp(3),
pos(3)] and per revolute body [angle], ``qd`` = [w(3), v(3)] world-frame
and [angular rate]. A model's bodies are all of one kind (every reference
scene's are), stepped batched, with no host sync. Prismatic, fixed and
articulated bodies, mixed kinds, welds and body-body contact come with the
grip slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from softmac_tpu_torch.engine import quat as Q
from softmac_tpu_torch.engine.meshio import UrdfModel, load_obj
from softmac_tpu_torch.engine.types import BodyState, _Replace

_LATER = ("is not ported yet; it comes with the grip slice of the port "
          "(the port's RigidModel steps floating and revolute bodies)")


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
    jtype: str                  # floating | revolute
    q_offset: int               # dof offset into the global q vector
    mass: float
    inertia: np.ndarray         # (3,3) about the COM, inertial frame
    com: np.ndarray             # (3,) link-frame COM (URDF <inertial><origin>)
    joint_pos: np.ndarray       # (3,) world joint origin
    joint_rot: np.ndarray       # (3,3) world joint frame
    gravity_on: bool
    support_points: np.ndarray  # (8,3) body-frame points for floor penalty
    axis: np.ndarray            # (3,) unit joint axis, joint frame (revolute)
    limit_lower: float = -np.inf
    limit_upper: float = np.inf
    limit_velocity: float = np.inf


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
    """Force-controlled rigid simulator built from URDFs (floating and
    revolute bodies).

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
        # viscous damping of 1-DoF joints, applied implicitly in the step
        self.joint_damping = float(cfg.get("joint_damping", 0.0))
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
                jtype = "revolute" if j.jtype == "continuous" else j.jtype
                if jtype not in ("floating", "revolute"):
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
                    jtype=jtype, q_offset=offset + ndof_skel,
                    mass=float(link.mass),
                    inertia=np.asarray(link.inertia, np.float64),
                    com=np.asarray(link.inertial_origin, np.float64),
                    joint_pos=pos + rot @ j.origin_xyz,
                    joint_rot=rot @ Q.rpy2mat(j.origin_rpy),
                    gravity_on=True,
                    support_points=_support_points(verts),
                    axis=(np.asarray(j.axis, np.float64)
                          / np.linalg.norm(j.axis)),
                    limit_lower=float(j.limit_lower),
                    limit_upper=float(j.limit_upper),
                    limit_velocity=float(j.limit_velocity)))
                ndof_skel += 6 if jtype == "floating" else 1
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

        kinds = {b.jtype for b in self.bodies}
        if len(kinds) > 1:
            raise NotImplementedError(f"floating and revolute bodies in one "
                                      f"model {_LATER}")
        self.floating = kinds != {"revolute"}

        # per-body constants, batched over the bodies (q.view(B, 6) is
        # [exp, pos] per floating body, q[i] the angle of revolute body i)
        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float64)).to(
                dtype=dtype, device=self.device)
        bs = self.bodies
        self._com = dev([b.com for b in bs]).reshape(-1, 3)
        self._g = dev(self.gravity)
        self._gravity_masked = not all(b.gravity_on for b in bs)
        self._gravity_on = dev([1.0 if b.gravity_on else 0.0
                                for b in bs]).reshape(-1, 1)
        if self.floating:
            self._inertia = dev([b.inertia for b in bs]).reshape(-1, 3, 3)
            self._mass = dev([b.mass for b in bs]).reshape(-1, 1)
            self._support = dev([b.support_points
                                 for b in bs]).reshape(-1, 8, 3)
            return
        self._axis = dev([b.axis for b in bs]).reshape(-1, 3)
        self._axis_w = dev([b.joint_rot @ b.axis for b in bs]).reshape(-1, 3)
        self._joint_quat = Q.mat2quat(dev([b.joint_rot
                                           for b in bs]).reshape(-1, 3, 3))
        self._joint_pos = dev([b.joint_pos for b in bs]).reshape(-1, 3)
        self._weight = dev([b.mass * self.gravity for b in bs]).reshape(-1, 3)
        # parallel axis: the URDF inertia is about the COM and the joint
        # axis passes through the body origin, |c - (c.a)a| from the COM
        i_a = [float(b.axis @ b.inertia @ b.axis
                     + b.mass * (b.com @ b.com - (b.com @ b.axis) ** 2))
               for b in bs]
        self._i_axis = dev(i_a)
        self._damp = dev([1.0 + self.dt * self.joint_damping / v for v in i_a])
        lo, hi, vmax = (np.array([getattr(b, k) for b in bs], np.float64)
                        for k in ("limit_lower", "limit_upper",
                                  "limit_velocity"))
        self._vmax = dev(vmax) if np.isfinite(vmax).any() else None
        self._range = ((dev(lo), dev(hi))
                       if np.isfinite(np.r_[lo, hi]).any() else None)

    def compensation_mass(self, slot: int) -> Optional[float]:
        """The gravity-affected mass the free joint of body ``slot`` holds
        (``adjust_action_with_ext_force``): a floating body's own mass;
        None for a revolute body, which has no free joint."""
        b = self.bodies[slot]
        return b.mass if b.jtype == "floating" else None

    # ------------------------------------------------------------------
    def init_state(self) -> RigidState:
        def dev(a):
            return torch.as_tensor(a).to(dtype=self.dtype, device=self.device)
        return RigidState(q=dev(self._q0), qd=dev(self._qd0))

    def _revolute_quat(self, angle):
        """Link frame of each revolute body: the joint frame composed with
        the rotation by ``angle`` about the joint axis."""
        return Q.qmul(self._joint_quat, Q.w2quat(self._axis * angle[:, None]))

    def body_states(self, state: RigidState) -> BodyState:
        """Per-primitive world pose + BODY-frame COM spatial velocity (the
        reference exports DART's ``getCOMSpatialVelocity()``, in body
        coordinates; the contact collider rotates it body -> world)."""
        if not self.floating:
            # the axis is invariant under its own rotation: the link-frame
            # angular velocity is axis * qd
            w_b = self._axis * state.qd[:, None]
            return BodyState(pos=self._joint_pos,
                             quat=self._revolute_quat(state.q),
                             v=torch.cross(w_b, self._com, dim=-1), w=w_b)
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
        [force, torque about the body origin] per primitive; action: per
        free joint the [torque(3), force(3)], world frame, at the origin,
        per revolute joint the torque about its axis."""
        if action is None:
            action = torch.zeros((self.action_dim,), dtype=self.dtype,
                                 device=self.device)
        action = action.reshape(-1)[:self.action_dim]
        # each primitive's measured wrench is gated by its own ext-force
        # flag; the floor penalty below acts regardless of the flag
        if self._gravity_masked:
            ext_f = ext_f * self._gravity_on
        if not self.floating:
            return self._revolute_step(state.q, state.qd, action, ext_f)
        q, qd = self._floating_step(state.q.reshape(-1, 6),
                                    state.qd.reshape(-1, 6),
                                    action.reshape(-1, 6), ext_f)
        return RigidState(q=q.reshape(-1), qd=qd.reshape(-1))

    def _floating_step(self, q, qd, a, ext_f):
        """The floating bodies' step; q, qd, a, ext_f: (B_floating, 6)."""
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
        return (torch.cat([exp_new, pos_new], dim=-1),
                torch.cat([w_new, v_new], dim=-1))

    def _revolute_step(self, q, qd, a, ext_f):
        """The revolute bodies' step; q, qd, a: (B,), ext_f: (B, 6). The
        torque about the joint axis from the body-origin wrench (body
        origin = joint origin in the reference's URDFs) and gravity about
        the hinge, then implicit viscous damping (explicit -c qd is
        unstable once dt c / I > 2, which a gram-scale hinge hits at once)
        and the joint limits."""
        tau = a + torch.sum(self._axis_w * ext_f[:, 3:], dim=-1)
        com_w = Q.qrot(self._revolute_quat(q), self._com)
        tau = tau + self._gravity_on[:, 0] * torch.sum(
            self._axis_w * torch.cross(com_w, self._weight, dim=-1), dim=-1)
        qd_new = (qd + self.dt * tau / self._i_axis) / self._damp
        # URDF joint limits (the reference's Jade/DART enforces the
        # declared <limit> tags, e.g. door.urdf velocity 6.545, position
        # +-3.14): velocity clamp, then position clamp with qd zeroed at
        # the stops
        if self._vmax is not None:
            qd_new = torch.minimum(torch.maximum(qd_new, -self._vmax),
                                   self._vmax)
        q_new = q + self.dt * qd_new
        if self._range is not None:
            lo, hi = self._range
            q_clamped = torch.minimum(torch.maximum(q_new, lo), hi)
            qd_new = torch.where(q_clamped != q_new, 0.0, qd_new)
            q_new = q_clamped
        return RigidState(q=q_new, qd=qd_new)
