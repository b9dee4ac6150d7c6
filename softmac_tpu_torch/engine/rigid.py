"""Rigid bodies: the velocity-controlled model and the force-controlled
``RigidModel`` (``softmac_tpu/engine/rigid.py``).

``RigidVelocityModel`` (reference ``softmac/engine/rigid_simulator_vel.py``)
has no dynamics: actions set each body's (w, v) for the next window and
poses integrate kinematically every substep.

``RigidModel`` is the force-controlled simulator built from URDFs
(reference ``rigid_simulator.py``, Jade joints) for bodies jointed to the
world (through fixed joints only), each in one of four ways:
- floating, as in the pour scene: a semi-implicit Newton-Euler step about
  the centre of mass with the window-averaged contact wrench, the actions
  (a world-frame torque and force at the body origin), gravity where the
  primitive's ``enable_external_force`` flag is set, and a spring-damper
  floor penalty at the mesh's bounding-box corners;
- revolute (or continuous), as the door's hinge: the torque about the
  joint axis from the action, the wrench and gravity, the parallel-axis
  inertia about the axis, implicit viscous ``joint_damping``, and the
  URDF's velocity and position limits;
- prismatic, as the gripper's fingers: the force along the joint axis
  from the action, the wrench and gravity, over the link mass, with the
  same damping and limits;
- fixed, as the gripper's palm: a constant pose, no dofs.
State layout as the JAX package's: ``q`` = per floating body [exp(3),
pos(3)], per revolute body [angle], per prismatic body [slide], in body
order; ``qd`` = [w(3), v(3)] world-frame and the 1-dof rates. Any mix of
the kinds is allowed; each moving kind is stepped in one batched call, and
a step runs with no host sync. Welds, articulated trees and body-body
contact are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from softmac_tpu_torch.engine import quat as Q
from softmac_tpu_torch.engine.meshio import UrdfModel, load_obj
from softmac_tpu_torch.engine.types import BodyState, _Replace

_LATER = ("is not ported yet: the port's RigidModel steps floating, "
          "revolute, prismatic and fixed bodies jointed to the world; welds, "
          "articulated trees and body-body contact come with the rest of the "
          "rigid family")
# dofs of a body of each joint kind
_NDOF = {"floating": 6, "revolute": 1, "prismatic": 1, "fixed": 0}


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
    jtype: str                  # floating | revolute | prismatic | fixed
    q_offset: int               # dof offset into the global q (-1: none)
    mass: float
    inertia: np.ndarray         # (3,3) about the COM, inertial frame
    com: np.ndarray             # (3,) link-frame COM (URDF <inertial><origin>)
    joint_pos: np.ndarray       # (3,) world joint origin
    joint_rot: np.ndarray       # (3,3) world joint frame
    gravity_on: bool
    support_points: np.ndarray  # (8,3) body-frame points for floor penalty
    axis: np.ndarray            # (3,) unit joint axis, joint frame (1 dof)
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


def _selector(idx, total, device):
    """``idx`` (ascending ints into a dimension of ``total``): None where
    it is all of it (the tensor itself: nothing to differentiate through),
    a slice where it is one contiguous range (a view), else an index
    tensor (one gather)."""
    idx = [int(i) for i in idx]
    if idx == list(range(total)):
        return None
    if idx == list(range(idx[0], idx[0] + len(idx))):
        return slice(idx[0], idx[0] + len(idx))
    return torch.as_tensor(idx, dtype=torch.int64, device=device)


def _take(t, sel):
    """The rows ``sel`` (a ``_selector``) of t."""
    return t if sel is None else t[sel]


def _order(groups, key, device):
    """The gather that puts the concatenated parts of ``groups`` (each with
    the ascending ints ``key(g)``) back in the order of those ints, or None
    where the concatenation already is in that order."""
    flat = [i for g in groups for i in key(g)]
    if flat == sorted(flat):
        return None
    return torch.as_tensor(np.argsort(flat, kind="stable"), dtype=torch.int64,
                           device=device)


def _assemble(parts, order):
    """One tensor from the parts of each group: the part itself where it is
    the only one, else one ``cat`` and, where ``order`` is given, one
    gather."""
    out = parts[0] if len(parts) == 1 else torch.cat(parts)
    return out if order is None else out[order]


class _Kind:
    """The bodies of one joint kind, stepped in one batched call: their
    slots, their dofs in the global q, and their constants (tensors over
    the kind's bodies, in slot order)."""

    def __init__(self, kind, slots, dofs, n_slots, n_dofs, device):
        self.kind = kind
        self.slots = slots                  # ascending body slots
        self.dofs = dofs                    # ascending global dofs
        self.slot_sel = _selector(slots, n_slots, device)
        self.dof_sel = _selector(dofs, n_dofs, device) if dofs else None


class RigidModel:
    """Force-controlled rigid simulator built from URDFs: floating,
    revolute (or continuous) and prismatic bodies jointed to the world,
    and fixed bodies, in any mix.

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
                if jtype not in _NDOF:
                    raise NotImplementedError(
                        f"a {j.jtype} joint ({j.name}) {_LATER}")
                # the joint frame through the fixed joints above it; a
                # moving ancestor would make a weld or an articulated tree
                pos, rot = np.zeros(3), np.eye(3)
                name = j.parent
                while name in by_child:
                    up = by_child[name]
                    if up.jtype != "fixed":
                        what = ("welds" if jtype == "fixed"
                                else "articulated trees")
                        raise NotImplementedError(
                            f"link {j.child} below moving link {name}: "
                            f"{what} {_LATER}")
                    pos = up.origin_xyz + Q.rpy2mat(up.origin_rpy) @ pos
                    rot = Q.rpy2mat(up.origin_rpy) @ rot
                    name = up.parent
                verts, _ = load_obj(link.mesh_path)
                ndof = _NDOF[jtype]
                self.bodies.append(_BodyDef(
                    jtype=jtype,
                    q_offset=offset + ndof_skel if ndof > 0 else -1,
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
                ndof_skel += ndof
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

        bs = self.bodies
        self._g = self._dev(self.gravity)
        self._gravity_masked = not all(b.gravity_on for b in bs)
        self._gravity_on = self._dev([1.0 if b.gravity_on else 0.0
                                      for b in bs]).reshape(-1, 1)
        # one group a moving kind, in the order of its first body; the
        # fixed bodies are constant rows of body_states
        self._kinds: List[_Kind] = []
        for kind in ("floating", "revolute", "prismatic"):
            slots = [s for s, b in enumerate(bs) if b.jtype == kind]
            if slots:
                self._kinds.append(self._make_kind(kind, slots))
        self._kinds.sort(key=lambda k: k.slots[0])
        rows = list(self._kinds)
        fixed = [s for s, b in enumerate(bs) if b.jtype == "fixed"]
        if fixed:
            fx = [bs[s] for s in fixed]
            zero = self._dev(np.zeros((len(fx), 3)))
            rows.append(_Kind("fixed", fixed, [], len(bs), offset,
                              self.device))
            rows[-1].rows = (self._dev([b.joint_pos for b in fx]),
                             Q.mat2quat(self._dev([b.joint_rot for b in fx])),
                             zero, zero)
        rows.sort(key=lambda k: k.slots[0])
        self._rows = rows
        self._slot_order = _order(rows, lambda k: k.slots, self.device)
        self._dof_order = _order(self._kinds, lambda k: k.dofs, self.device)

    def _dev(self, a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(
            dtype=self.dtype, device=self.device)

    def _make_kind(self, kind, slots) -> _Kind:
        """A kind's group and its constants."""
        bs = [self.bodies[s] for s in slots]
        dofs = [b.q_offset + i for b in bs for i in range(_NDOF[kind])]
        k = _Kind(kind, slots, dofs, len(self.bodies), self.state_dim_half,
                  self.device)
        dev = self._dev
        k.com = dev([b.com for b in bs]).reshape(-1, 3)
        k.gravity_on = dev([1.0 if b.gravity_on else 0.0 for b in bs])
        if kind == "floating":
            k.gravity_on = k.gravity_on.reshape(-1, 1)
            k.inertia = dev([b.inertia for b in bs]).reshape(-1, 3, 3)
            k.mass = dev([b.mass for b in bs]).reshape(-1, 1)
            k.support = dev([b.support_points for b in bs]).reshape(-1, 8, 3)
            return k
        k.axis = dev([b.axis for b in bs]).reshape(-1, 3)
        k.axis_w = dev([b.joint_rot @ b.axis for b in bs]).reshape(-1, 3)
        k.joint_quat = Q.mat2quat(dev([b.joint_rot
                                       for b in bs]).reshape(-1, 3, 3))
        k.joint_pos = dev([b.joint_pos for b in bs]).reshape(-1, 3)
        if kind == "revolute":
            k.weight = dev([b.mass * self.gravity for b in bs]).reshape(-1, 3)
            # parallel axis: the URDF inertia is about the COM and the
            # joint axis passes through the body origin, |c - (c.a)a| from
            # the COM
            inertia = [float(b.axis @ b.inertia @ b.axis
                             + b.mass * (b.com @ b.com - (b.com @ b.axis) ** 2))
                       for b in bs]
        else:
            # the weight along the axis; the link mass is the joint's
            # inertia; a slider does not turn
            k.weight = dev([float((b.joint_rot @ b.axis)
                                  @ (b.mass * self.gravity)) for b in bs])
            inertia = [b.mass for b in bs]
            k.zero = torch.zeros_like(k.axis)
        k.inertia = dev(inertia)
        k.damp = dev([1.0 + self.dt * self.joint_damping / v
                      for v in inertia])
        lo, hi, vmax = (np.array([getattr(b, a) for b in bs], np.float64)
                        for a in ("limit_lower", "limit_upper",
                                  "limit_velocity"))
        k.vmax = dev(vmax) if np.isfinite(vmax).any() else None
        k.range = ((dev(lo), dev(hi))
                   if np.isfinite(np.r_[lo, hi]).any() else None)
        return k

    def compensation_mass(self, slot: int) -> Optional[float]:
        """The gravity-affected mass the free joint of body ``slot`` holds
        (``adjust_action_with_ext_force``): a floating body's own mass;
        None for any other body, which has no free joint."""
        b = self.bodies[slot]
        return b.mass if b.jtype == "floating" else None

    # ------------------------------------------------------------------
    def init_state(self) -> RigidState:
        def dev(a):
            return torch.as_tensor(a).to(dtype=self.dtype, device=self.device)
        return RigidState(q=dev(self._q0), qd=dev(self._qd0))

    @staticmethod
    def _revolute_quat(k, angle):
        """Link frame of each revolute body: the joint frame composed with
        the rotation by ``angle`` about the joint axis."""
        return Q.qmul(k.joint_quat, Q.w2quat(k.axis * angle[:, None]))

    def body_states(self, state: RigidState) -> BodyState:
        """Per-primitive world pose + BODY-frame COM spatial velocity (the
        reference exports DART's ``getCOMSpatialVelocity()``, in body
        coordinates; the contact collider rotates it body -> world). Each
        kind's rows in one batched call, the fixed bodies' constant; put in
        slot order by one ``cat`` and, where the kinds interleave, one
        gather per field."""
        rows = []
        for k in self._rows:
            if k.kind == "fixed":
                rows.append(k.rows)
                continue
            q, qd = _take(state.q, k.dof_sel), _take(state.qd, k.dof_sel)
            if k.kind == "floating":
                q, qd = q.reshape(-1, 6), qd.reshape(-1, 6)
                bq = Q.w2quat(q[:, :3])
                bqc = Q.qconj(bq)
                w_b = Q.qrot(bqc, qd[:, :3])
                v_b = Q.qrot(bqc, qd[:, 3:])
                rows.append((q[:, 3:], bq,
                             v_b + torch.cross(w_b, k.com, dim=-1), w_b))
            elif k.kind == "revolute":
                # the axis is invariant under its own rotation: the
                # link-frame angular velocity is axis * qd
                w_b = k.axis * qd[:, None]
                rows.append((k.joint_pos, self._revolute_quat(k, q),
                             torch.cross(w_b, k.com, dim=-1), w_b))
            else:
                # prismatic: the link frame is the joint frame, slid along
                # the world axis; its body-frame velocity is axis * qd
                rows.append((k.joint_pos + k.axis_w * q[:, None],
                             k.joint_quat, k.axis * qd[:, None], k.zero))
        pos, quat, v, w = (_assemble([r[i] for r in rows], self._slot_order)
                           for i in range(4))
        return BodyState(pos=pos, quat=quat, v=v, w=w)

    def _floor_wrench(self, k, pos, bq, v, w):
        """Spring-damper floor penalty at the support points; (B, 3) force
        and torque about the body origin. v, w: world velocity at the
        origin and world angular velocity."""
        pts = k.support
        n = pts.shape[1]
        p_w = Q.qrot(bq[:, None, :].expand(-1, n, 4), pts) + pos[:, None]
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
        per revolute joint the torque about its axis, per prismatic joint
        the force along it. Each kind is stepped in one batched call; the
        new q and qd are put in dof order by one ``cat`` (and, where the
        kinds interleave, one gather)."""
        if not self._kinds:
            return state
        if action is None:
            action = torch.zeros((self.action_dim,), dtype=self.dtype,
                                 device=self.device)
        action = action.reshape(-1)[:self.action_dim]
        # each primitive's measured wrench is gated by its own ext-force
        # flag; the floor penalty below acts regardless of the flag
        if self._gravity_masked:
            ext_f = ext_f * self._gravity_on
        qs, qds = [], []
        for k in self._kinds:
            q, qd = _take(state.q, k.dof_sel), _take(state.qd, k.dof_sel)
            a, f = _take(action, k.dof_sel), _take(ext_f, k.slot_sel)
            if k.kind == "floating":
                q, qd = self._floating_step(k, q.reshape(-1, 6),
                                            qd.reshape(-1, 6),
                                            a.reshape(-1, 6), f)
                q, qd = q.reshape(-1), qd.reshape(-1)
            else:
                q, qd = self._one_dof_step(k, q, qd, a, f)
            qs.append(q)
            qds.append(qd)
        return RigidState(q=_assemble(qs, self._dof_order),
                          qd=_assemble(qds, self._dof_order))

    def _floating_step(self, k, q, qd, a, ext_f):
        """The floating bodies' step; q, qd, a, ext_f: (B_floating, 6)."""
        exp, pos = q[:, :3], q[:, 3:]
        w, v = qd[:, :3], qd[:, 3:]
        bq = Q.w2quat(exp)
        R = Q.quat2mat(bq)
        Rt = R.transpose(-1, -2)
        com = k.com
        r_c = (R @ com[..., None])[..., 0]        # world COM offset

        tau_o = a[:, :3] + ext_f[:, 3:]           # torque about the origin
        force = a[:, 3:] + ext_f[:, :3]           # excludes gravity
        if self.enable_floor:
            f_fl, t_fl = self._floor_wrench(k, pos, bq, v, w)
            force = force + f_fl
            tau_o = tau_o + t_fl

        # Newton-Euler about the COM: gravity contributes no torque there,
        # origin-referenced wrenches shift by -r_c x F
        tau_c = tau_o - torch.cross(r_c, force, dim=-1)
        force = force + k.gravity_on * (k.mass * self._g)

        I_w = R @ k.inertia @ Rt
        w_dot = _solve3(I_w, tau_c - torch.cross(
            w, (I_w @ w[..., None])[..., 0], dim=-1))
        w_new = w + self.dt * w_dot
        v_c = v + torch.cross(w, r_c, dim=-1)
        v_c_new = v_c + self.dt * force / k.mass
        bq_new = Q.qmul(Q.w2quat(w_new * self.dt), bq)
        r_c_new = Q.qrot(bq_new, com)
        pos_new = (pos + r_c) + self.dt * v_c_new - r_c_new
        v_new = v_c_new - torch.cross(w_new, r_c_new, dim=-1)
        exp_new = Q.quat2w(bq_new)
        return (torch.cat([exp_new, pos_new], dim=-1),
                torch.cat([w_new, v_new], dim=-1))

    def _one_dof_step(self, k, q, qd, a, ext_f):
        """The revolute or prismatic bodies' step; q, qd, a: (B,), ext_f:
        (B, 6). A hinge takes the torque about its axis from the
        body-origin wrench (body origin = joint origin in the reference's
        URDFs) and gravity about the hinge, over its parallel-axis inertia;
        a slider the force along its axis and the weight's share, over the
        link mass. Then implicit viscous damping (explicit -c qd is
        unstable once dt c / I > 2, which a gram-scale hinge hits at once)
        and the joint limits."""
        if k.kind == "revolute":
            gen = a + torch.sum(k.axis_w * ext_f[:, 3:], dim=-1)
            com_w = Q.qrot(self._revolute_quat(k, q), k.com)
            gen = gen + k.gravity_on * torch.sum(
                k.axis_w * torch.cross(com_w, k.weight, dim=-1), dim=-1)
        else:
            gen = a + torch.sum(k.axis_w * ext_f[:, :3], dim=-1)
            gen = gen + k.gravity_on * k.weight
        qd_new = (qd + self.dt * gen / k.inertia) / k.damp
        # URDF joint limits (the reference's Jade/DART enforces the
        # declared <limit> tags, e.g. door.urdf velocity 6.545, position
        # +-3.14): velocity clamp, then position clamp with qd zeroed at
        # the stops
        if k.vmax is not None:
            qd_new = torch.minimum(torch.maximum(qd_new, -k.vmax), k.vmax)
        q_new = q + self.dt * qd_new
        if k.range is not None:
            lo, hi = k.range
            q_clamped = torch.minimum(torch.maximum(q_new, lo), hi)
            qd_new = torch.where(q_clamped != q_new, 0.0, qd_new)
            q_new = q_clamped
        return q_new, qd_new
