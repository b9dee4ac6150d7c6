"""Articulated-tree rigid dynamics from the Lagrangian
(``softmac_tpu/engine/chain.py``).

Trees of revolute, prismatic and floating joints with a fixed base; a
serial chain is the case of a linear parent list. The JAX package derives
the dynamics from the energies by AD (M = the Hessian of the kinetic energy
over qd, the link velocities the jvp of forward kinematics). The port
computes the same functions with less AD: forward kinematics also carries
each link's velocity Jacobians (Jw qd the world angular velocity, Jv qd
the velocity of the joint origin; a revolute joint adds its world axis, a
prismatic one its sliding direction, a floating joint its chart's
derivative, and a parent's angular velocity carries each child's origin),
so that

    M(q)    = sum_i m_i Jc_i^T Jc_i + Jw_i^T I_i Jw_i  (Jc: the COM's)
    bias    = (d (M qd) / d q) qd - d KE / d q + d PE / d q
    tau_ext = sum_i Jv_i^T f_i + Jw_i^T t_i
    (M + dt D) qd' = M qd + dt (tau - bias)     (implicit joint damping)

with KE = qd^T M qd / 2. The bias takes three reverse passes
(``torch.autograd.grad`` with ``create_graph=True``); a floating joint's
chart derivative four more on its own small graph. A step stays
differentiable by ordinary autograd (a rollout's gradient differentiates
it once more), also inside a non-reentrant ``torch.utils.checkpoint`` (the
env's remat "step"): the tree's graph keeps its saved tensors itself, so
the inner passes never unpack the checkpoint's placeholders (the
``torch.func`` transforms refuse to run under a checkpoint's hooks at
all). A derivative along qd (the JAX package's ``jax.jvp``) is taken by
two reverse passes: u -> J^T u is linear in u, and its gradient along qd
is J qd. Each derivative is taken with respect to an alias of q or qd, so
that a q computed from the same qd (the previous step's q + dt qd) does
not leak into the partial derivatives.

All sizes are the dofs (a few); the linear solve is a Gaussian
elimination written out (M + dt D is symmetric positive definite), which
needs no host sync on the card.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List

import numpy as np
import torch

from softmac_tpu_torch.engine import quat as Q


@dataclasses.dataclass
class ChainJoint:
    """One joint of an articulated tree, with its child link's inertia.

    ``origin_pos``/``origin_rot``: the joint frame's fixed transform
    relative to the PARENT joint frame (URDF <origin> accumulated through
    interleaved fixed joints). ``axis``: motion axis in the joint frame
    (1-dof types). ``com``/``inertia``: the child link's inertial
    properties in the joint frame (inertia about the COM).

    ``floating`` joints carry 6 dofs [w(3) exp-coords, p(3) translation],
    the child's WORLD pose (the URDF <origin> and parent frame are
    ignored). The chart is re-centred to the principal rotation vector
    after every step; its velocity coordinates are chart rates, which equal
    the world angular velocity only at the identity orientation."""
    jtype: str                    # 'revolute' | 'prismatic' | 'floating'
    origin_pos: np.ndarray        # (3,)
    origin_rot: np.ndarray        # (3, 3)
    axis: np.ndarray              # (3,) unit (ignored for floating)
    mass: float
    inertia: np.ndarray           # (3, 3) about the COM, link frame
    com: np.ndarray               # (3,)
    damping: float = 0.0
    limit_lower: float = -np.inf
    limit_upper: float = np.inf
    limit_velocity: float = np.inf
    gravity_on: bool = True       # the RigidModel ext-force flag masks gravity

    @property
    def ndof(self) -> int:
        return 6 if self.jtype == "floating" else 1


def _alias(t: torch.Tensor) -> torch.Tensor:
    """A variable to differentiate with respect to: a view of t where t is
    in a graph (gradients still reach t), else a leaf that requires grad."""
    return t.view_as(t) if t.requires_grad else t.detach().requires_grad_()


def _grad(out, inputs, grad_outputs=None):
    """d out / d inputs (a list), itself differentiable; zeros where out
    does not depend on an input."""
    if not out.requires_grad:
        return [torch.zeros_like(i) for i in inputs]
    gs = torch.autograd.grad(out, inputs, grad_outputs, create_graph=True,
                             allow_unused=True)
    return [torch.zeros_like(i) if g is None else g
            for g, i in zip(gs, inputs)]


def _jvp(fn, x, v):
    """(fn(x), J v) for ``fn`` returning a tuple of tensors, J its
    Jacobian at x."""
    x_ = _alias(x)
    outs = fn(x_)
    return outs, _jvp_from(outs, x_, v)


def _jvps_from(outs, x, vs):
    """J v for each v of ``vs``, J the Jacobian of the tensors ``outs``
    with respect to x (which they were computed from): one reverse pass
    for u -> J^T u, linear in u, then one for each v (its gradient along v
    is J v)."""
    us = [torch.zeros_like(o, requires_grad=True) for o in outs]
    jtu = _grad(torch.stack([(o * u).sum() for o, u in zip(outs, us)]).sum(),
                [x])[0]
    return [tuple(_grad((jtu * v).sum(), us)) for v in vs]


def _jvp_from(outs, x, v):
    return _jvps_from(outs, x, [v])[0]


def _keep(t):
    return t


def _differentiates(fn):
    """Run ``fn`` with autograd on (it differentiates inside) and, where
    autograd was off on entry or no tensor argument requires grad, return
    its outputs detached. The tensors its graph saves are kept as they are
    (identity saved-tensor hooks): inside a non-reentrant checkpoint each
    inner ``autograd.grad`` would otherwise unpack the checkpoint's
    placeholders and recompute the whole checkpointed env step."""
    @functools.wraps(fn)
    def wrapper(*args, **kw):
        with torch.autograd.graph.saved_tensors_hooks(_keep, _keep):
            return _run(fn, args, kw)
    return wrapper


def _run(fn, args, kw):
    if torch.is_grad_enabled() and any(
            torch.is_tensor(a) and a.requires_grad for a in args):
        return fn(*args, **kw)
    with torch.enable_grad():
        out = fn(*args, **kw)
    if torch.is_tensor(out):
        return out.detach()
    return tuple(o.detach() for o in out)


def _wrench_forces(Jw, Jv, wrenches):
    """J^T w: per-link wrenches (n, 6) [force, torque] as generalized
    forces, through the links' velocity Jacobians (n, 3, n_dof)."""
    return ((Jv.transpose(1, 2) @ wrenches[:, :3, None]).sum(0)[:, 0]
            + (Jw.transpose(1, 2) @ wrenches[:, 3:, None]).sum(0)[:, 0])


def _solve(A, b):
    """A^-1 b for a small symmetric positive definite A (n, n): Gaussian
    elimination without pivoting, then back substitution."""
    n = A.shape[0]
    rows = [A[i] for i in range(n)]
    rhs = [b[i] for i in range(n)]
    for k in range(n):
        for i in range(k + 1, n):
            f = rows[i][k] / rows[k][k]
            rows[i] = rows[i] - f * rows[k]
            rhs[i] = rhs[i] - f * rhs[k]
    x = [None] * n
    for i in reversed(range(n)):
        s = rhs[i]
        for j in range(i + 1, n):
            s = s - rows[i][j] * x[j]
        x[i] = s / rows[i][i]
    return torch.stack(x)


class ArticulatedTree:
    """Fixed-base tree of revolute, prismatic and floating joints; every
    method is a function of (q, qd). q concatenates each joint's dofs in
    joint order. ``parents[i]``: the parent joint of joint i (-1 = the
    base), parents before children; None gives a serial chain. A floating
    root makes the whole assembly free-flying."""

    def __init__(self, joints: List[ChainJoint], base_pos, base_rot,
                 gravity, dt: float, dtype=torch.float64, parents=None):
        self.joints = joints
        self.n = len(joints)
        self.parents = (list(range(-1, self.n - 1)) if parents is None
                        else list(parents))
        if len(self.parents) != self.n or not all(
                p < i for i, p in enumerate(self.parents)):
            raise ValueError("parents must list each joint's parent before it")
        self.dof_off = np.concatenate(
            [[0], np.cumsum([j.ndof for j in joints])]).astype(int)
        self.n_dof = int(self.dof_off[-1])
        self.base_pos = np.asarray(base_pos, np.float64)
        self.base_rot = np.asarray(base_rot, np.float64)
        self.gravity = np.asarray(gravity, np.float64)
        self.dt = float(dt)
        self.dtype = dtype
        self._cache = {}

    def _per_dof(self, f, fill):
        out = []
        for j in self.joints:
            out += [fill] * 6 if j.jtype == "floating" else [f(j)]
        return np.asarray(out, np.float64)

    def _c(self, like):
        """The tree's constants as tensors of ``like``'s dtype and device
        (made once for each)."""
        key = (like.dtype, like.device)
        if key not in self._cache:
            def t(a):
                return torch.as_tensor(np.asarray(a, np.float64)).to(
                    dtype=like.dtype, device=like.device)
            js = self.joints
            lo = self._per_dof(lambda j: j.limit_lower, -np.inf)
            hi = self._per_dof(lambda j: j.limit_upper, np.inf)
            vcap = self._per_dof(lambda j: j.limit_velocity, np.inf)
            self._cache[key] = dict(
                base_pos=t(self.base_pos), base_rot=t(self.base_rot),
                origin_pos=[t(j.origin_pos) for j in js],
                origin_rot=[t(j.origin_rot) for j in js],
                axis=[t(j.axis) for j in js],
                com=t([j.com for j in js]).reshape(-1, 3),
                inertia=t([j.inertia for j in js]).reshape(-1, 3, 3),
                mass=t([j.mass for j in js]),
                weight=t([j.mass * float(j.gravity_on) for j in js]),
                g=t(self.gravity),
                onehot=t(np.eye(self.n_dof)),
                # (3, n_dof) blocks: the identity at dofs o..o+2
                onehot3=[t(np.eye(3, self.n_dof, o))
                         for o in range(self.n_dof)],
                damp=t(self.dt * np.diag(
                    self._per_dof(lambda j: j.damping, 0.0))),
                vcap=t(vcap) if np.isfinite(vcap).any() else None,
                range=((t(lo), t(hi)) if np.isfinite(np.r_[lo, hi]).any()
                       else None))
        return self._cache[key]

    # -- forward kinematics ------------------------------------------------
    def _frames(self, q):
        """World pose of every joint frame and its velocity Jacobians:
        ((n, 3) pos, (n, 3, 3) rot, (n, 3, n_dof) Jw, (n, 3, n_dof) Jv)."""
        c = self._c(q)
        D = self.n_dof
        zero = torch.zeros((3, D), dtype=q.dtype, device=q.device)
        ps, Rs, Jws, Jvs = [], [], [], []
        for i, j in enumerate(self.joints):
            par = self.parents[i]
            o = int(self.dof_off[i])
            if j.jtype == "floating":
                # the world-pose chart of a free joint: its own dofs only
                w = _alias(q[o:o + 3])
                rot = Q.quat2mat(Q.w2quat(w))
                E = self._chart_rate(w, rot)
                ps.append(q[o + 3:o + 6])
                Rs.append(rot)
                Jws.append(torch.cat([zero[:, :o], E, zero[:, o + 3:]], 1))
                Jvs.append(c["onehot3"][o + 3])
                continue
            pp = c["base_pos"] if par < 0 else ps[par]
            pr = c["base_rot"] if par < 0 else Rs[par]
            Jw = zero if par < 0 else Jws[par]
            Jv = zero if par < 0 else Jvs[par]
            pos = pp + pr @ c["origin_pos"][i]
            rot = pr @ c["origin_rot"][i]
            a_w = rot @ c["axis"][i]                # the world axis
            if j.jtype == "revolute":
                rot = rot @ Q.quat2mat(Q.w2quat(c["axis"][i] * q[o]))
                own_w, own_v = a_w[:, None] * c["onehot"][o], 0.0
            else:  # prismatic
                pos = pos + rot @ (c["axis"][i] * q[o])
                own_w, own_v = 0.0, a_w[:, None] * c["onehot"][o]
            # the parent's rotation carries this origin: w x (p - p_par)
            r = (pos - pp)[:, None].expand_as(Jw)
            Jvs.append(Jv + torch.cross(Jw, r, dim=0) + own_v)
            Jws.append(Jw + own_w)
            ps.append(pos)
            Rs.append(rot)
        return (torch.stack(ps), torch.stack(Rs), torch.stack(Jws),
                torch.stack(Jvs))

    @staticmethod
    def _chart_rate(w, rot):
        """(3, 3) E: the world angular velocity of the chart R(w) (w^ =
        Rdot R^T, as the JAX package extracts it) is E wd."""
        eye = torch.eye(3, dtype=w.dtype, device=w.device)
        cols = []
        for (dR,) in _jvps_from((rot,), w, list(eye)):
            W = dR @ rot.T
            cols.append(torch.stack([W[2, 1], W[0, 2], W[1, 0]]))
        return torch.stack(cols, dim=1)

    @_differentiates
    def fk(self, q):
        """World pose of every joint frame: ((n, 3) pos, (n, 3, 3) rot)."""
        return self._frames(q)[:2]

    def _mass_matrix(self, R, Jw, Jv):
        """M = sum_i m_i Jc_i^T Jc_i + Jw_i^T I_i Jw_i, Jc_i = Jv_i + w x
        c_i the COM's velocity Jacobian."""
        c = self._c(R)
        com_w = (R @ c["com"][..., None])[..., 0]          # (n, 3)
        Jc = Jv + torch.cross(Jw, com_w[:, :, None].expand_as(Jw), dim=1)
        I_w = R @ c["inertia"] @ R.transpose(-1, -2)
        return ((c["mass"][:, None, None] * Jc.transpose(1, 2) @ Jc).sum(0)
                + (Jw.transpose(1, 2) @ I_w @ Jw).sum(0))

    @_differentiates
    def link_velocities(self, q, qd):
        """World (w, v at the joint origin) of every link."""
        _, _, Jw, Jv = self._frames(q)
        return Jw @ qd, Jv @ qd

    # -- energies ------------------------------------------------------------
    @_differentiates
    def kinetic(self, q, qd):
        c = self._c(q)
        _, R, Jw, Jv = self._frames(q)
        w, v = Jw @ qd, Jv @ qd
        com_w = (R @ c["com"][..., None])[..., 0]
        v_com = v + torch.cross(w, com_w, dim=-1)
        I_w = R @ c["inertia"] @ R.transpose(-1, -2)
        Iw = (I_w @ w[..., None])[..., 0]
        return (0.5 * c["mass"] * (v_com * v_com).sum(-1)
                + 0.5 * (w * Iw).sum(-1)).sum()

    def _potential(self, p, R):
        c = self._c(p)
        com_w = p + (R @ c["com"][..., None])[..., 0]
        return -(c["weight"] * (com_w @ c["g"])).sum()

    @_differentiates
    def potential(self, q):
        return self._potential(*self._frames(q)[:2])

    # -- dynamics ------------------------------------------------------------
    @_differentiates
    def generalized_ext(self, q, qd, wrenches):
        """Per-link world wrenches (n, 6) [force, torque about the joint
        origin] as generalized forces: J^T w, the derivative of the wrench
        power over qd."""
        _, _, Jw, Jv = self._frames(q)
        return _wrench_forces(Jw, Jv, wrenches)

    @_differentiates
    def step(self, q, qd, tau_act, wrenches):
        """Semi-implicit Euler with implicit viscous joint damping and the
        URDF joint limits. tau_act: (n_dof,) actuation; wrenches: (n, 6)
        world wrenches about each link's joint origin."""
        c = self._c(q)
        dt = self.dt
        q_ = _alias(q)
        p, R, Jw, Jv = self._frames(q_)
        M = self._mass_matrix(R, Jw, Jv)
        # (d p / d q) qd with p = M qd: the derivative of M qd along qd
        dpdq_qd, = _jvp_from((M @ qd,), q_, qd)
        # d (PE - KE) / d q, KE = qd^T M qd / 2
        dv_dq = _grad(self._potential(p, R) - 0.5 * (qd @ M @ qd), [q_])[0]
        tau = tau_act + _wrench_forces(Jw, Jv, wrenches)
        rhs = tau - (dpdq_qd + dv_dq)
        qd_new = _solve(M + c["damp"], M @ qd + dt * rhs)

        if c["vcap"] is not None:
            qd_new = torch.minimum(torch.maximum(qd_new, -c["vcap"]),
                                   c["vcap"])
        q_new = q + dt * qd_new
        if c["range"] is not None:
            lo, hi = c["range"]
            q_c = torch.minimum(torch.maximum(q_new, lo), hi)
            qd_new = torch.where(q_c != q_new, 0.0, qd_new)
            q_new = q_c

        # re-centre floating charts to the principal rotation vector; the
        # velocity coordinates move through the chart map's derivative
        # (the identity whenever |w| < pi)
        for i, j in enumerate(self.joints):
            if j.jtype != "floating":
                continue
            o = int(self.dof_off[i])
            (w_c,), (wd_c,) = _jvp(
                lambda wv: (Q.quat2w(Q.w2quat(wv)),), q_new[o:o + 3],
                qd_new[o:o + 3])
            q_new = torch.cat([q_new[:o], w_c, q_new[o + 3:]])
            qd_new = torch.cat([qd_new[:o], wd_c, qd_new[o + 3:]])
        return q_new, qd_new

    # -- contact interface ----------------------------------------------------
    @_differentiates
    def body_states(self, q, qd):
        """Per link (pos, quat, BODY-frame COM spatial velocity), as
        RigidModel.body_states: the contact collider rotates body ->
        world."""
        c = self._c(q)
        p, R, Jw, Jv = self._frames(q)
        w, v = Jw @ qd, Jv @ qd
        bq = Q.mat2quat(R)
        bqc = Q.qconj(bq)
        w_b = Q.qrot(bqc, w)
        v_b = Q.qrot(bqc, v)
        return p, bq, v_b + torch.cross(w_b, c["com"], dim=-1), w_b


SerialChain = ArticulatedTree  # serial chains are the parents=None default
