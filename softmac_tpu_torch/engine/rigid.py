"""Rigid bodies: the velocity-controlled model and the force-controlled
``RigidModel`` (``softmac_tpu/engine/rigid.py``).

``RigidVelocityModel`` (reference ``softmac/engine/rigid_simulator_vel.py``)
has no dynamics: actions set each body's (w, v) for the next window and
poses integrate kinematically every substep.

``RigidModel`` is the force-controlled simulator built from URDFs
(reference ``rigid_simulator.py``, Jade joints). Each mesh link is a body
(a contact primitive) of one of these kinds:
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
- fixed, as the gripper's palm: a constant pose, no dofs;
- weld, a mesh fixed to a moving link: its mass, COM and inertia folded
  into that carrier (a composite body), its pose composed onto the
  carrier's, its wrenches (and floor penalty) shifted onto the carrier;
- chain, a member of an articulated tree (moving links below a moving
  link, the root jointed to the world, possibly floating): the whole tree
  steps through ``engine/chain.py``'s Lagrangian dynamics.
With ``RIGID.body_contact`` the bodies of different skeletons also push on
each other: a penalty on each body's surface samples inside the other's SDF
table, with Coulomb-clamped viscous friction or, with
``body_contact_stick``, a static-friction branch.
State layout as the JAX package's: ``q`` = per floating body [exp(3),
pos(3)], per revolute body [angle], per prismatic body [slide], per tree
its joints' dofs, in URDF joint order; ``qd`` = [w(3), v(3)] world-frame
and the 1-dof rates (a tree's floating joint: chart rates). Each moving
kind and each tree is stepped in one batched call, and a step runs with no
host sync.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from softmac_tpu_torch.engine import quat as Q
from softmac_tpu_torch.engine.chain import ArticulatedTree, ChainJoint
from softmac_tpu_torch.engine.meshio import UrdfModel, load_obj
from softmac_tpu_torch.engine.sdf import weld_vertices
from softmac_tpu_torch.engine.types import BodyState, _Replace
from softmac_tpu_torch.ops import contact as contact_ops

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
    """One collision body = one contact primitive."""
    jtype: str                  # floating | revolute | prismatic | fixed
                                # | chain | weld (fixed to a MOVING link)
    q_offset: int               # dof offset into the global q (-1: none)
    mass: float
    inertia: np.ndarray         # (3,3) about the COM, inertial frame
    com: np.ndarray             # (3,) link-frame COM (URDF <inertial><origin>)
    joint_pos: np.ndarray       # (3,) world joint origin (a weld's, and a
    joint_rot: np.ndarray       # (3,3) chain member's, relative to the
                                # moving ancestor's frame)
    gravity_on: bool
    support_points: np.ndarray  # (8,3) body-frame points for floor penalty
    axis: np.ndarray            # (3,) unit joint axis, joint frame (1 dof)
    limit_lower: float = -np.inf
    limit_upper: float = np.inf
    limit_velocity: float = np.inf
    ndof: int = 0
    contact_points: np.ndarray = None   # (K,3) body-frame surface samples
    skeleton: int = 0
    chain_id: int = -1          # index into RigidModel._chains (jtype chain)
    weld_parent: int = -1       # body slot the weld rides (jtype weld)


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


def _surface_points(verts: np.ndarray, faces: np.ndarray, k: int) -> np.ndarray:
    """Deterministic k-point surface sample for body-body contact: the
    welded mesh vertices (OBJ exports store per-face corners), evenly
    strided down where there are more than k; a coarse mesh filled up to k
    with seeded area-weighted samples of its triangles (vertices alone
    leave large flat faces unsampled)."""
    v, f = weld_vertices(np.asarray(verts, np.float64),
                         np.asarray(faces, np.int64))
    if len(v) >= k:
        return v[np.linspace(0, len(v) - 1, k).astype(int)]
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)
    if area.sum() <= 0.0:
        return v
    rng = np.random.RandomState(0)
    n_extra = k - len(v)
    fi = rng.choice(len(f), n_extra, p=area / area.sum())
    r1, r2 = rng.rand(n_extra), rng.rand(n_extra)
    su = np.sqrt(r1)
    extra = (a[fi] * (1 - su)[:, None]
             + b[fi] * (su * (1 - r2))[:, None]
             + c[fi] * (su * r2)[:, None])
    return np.concatenate([v, extra])


def _selector(idx, total, device):
    """``idx`` (ints into a dimension of ``total``): None where it is all
    of it in order (the tensor itself: nothing to differentiate through),
    a slice where it is one ascending contiguous range (a view), else an
    index tensor (one gather)."""
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
    the ints ``key(g)``) back in the order of those ints, or None where the
    concatenation already is in that order."""
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
    """The bodies of one joint kind (or one articulated tree, or all the
    welds), stepped in one batched call: their slots, their dofs in the
    global q, and their constants (tensors over the group's bodies, in its
    slot order)."""

    def __init__(self, kind, slots, dofs, n_slots, n_dofs, device):
        self.kind = kind
        self.slots = slots                  # body slots
        self.dofs = dofs                    # global dofs
        self.slot_sel = _selector(slots, n_slots, device)
        self.dof_sel = _selector(dofs, n_dofs, device) if dofs else None


class RigidModel:
    """Force-controlled rigid simulator built from URDFs: floating,
    revolute (or continuous), prismatic and fixed bodies jointed to the
    world, meshes welded onto a moving link (folded into it as one
    composite body), articulated trees of moving links below a
    world-jointed one (``engine/chain.py``: the root may be floating), in
    any mix; optionally body-body penalty contact between skeletons.

    ``step(state, action, ext_f, prims=None) -> state`` and
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
        # body-body penalty contact (the reference's Jade/DART world
        # resolves skeleton-vs-skeleton contact by LCP): off by default;
        # step() then needs the env's SDF tables. With
        # body_contact_stick > 0 the tangential force is the
        # Coulomb-clamped force that cancels the pair's mean relative
        # tangential momentum within one step (a static-friction branch);
        # at 0 it is the Coulomb-clamped viscous friction.
        self.body_contact = bool(cfg.get("body_contact", False))
        self.body_contact_stiffness = float(
            cfg.get("body_contact_stiffness", 1e4))
        self.body_contact_damping = float(cfg.get("body_contact_damping", 10.0))
        self.body_contact_friction = float(
            cfg.get("body_contact_friction", 0.5))
        self.body_contact_points = int(cfg.get("body_contact_points", 256))
        self.body_contact_stick = float(cfg.get("body_contact_stick", 0.0))

        self.bodies: List[_BodyDef] = []
        self.skeleton_ndof: List[int] = []
        self._chains: List[dict] = []
        offset = 0
        for skel_id, model in enumerate(urdf_models):
            offset = self._add_skeleton(skel_id, model, offset)
        if ext_force_flags:
            for b, flag in zip(self.bodies, ext_force_flags):
                b.gravity_on = bool(flag)
            for spec in self._chains:       # the trees' gravity masks
                for m, s in enumerate(spec["slots"]):
                    spec["chain"].joints[m].gravity_on = \
                        self.bodies[s].gravity_on

        self.state_dim_half = offset
        self.state_dim = 2 * offset
        self.action_dim = offset
        self.n_primitives = len(self.bodies)
        # body-body pairs: across skeletons only (DART's default; no scene
        # collides a skeleton with itself), at least one side moving
        dyn = [b.jtype != "fixed" for b in self.bodies]
        self._contact_pairs = [
            (i, j)
            for i in range(self.n_primitives)
            for j in range(i + 1, self.n_primitives)
            if (self.bodies[i].skeleton != self.bodies[j].skeleton
                and (dyn[i] or dyn[j]))]

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
        self._build_groups()

    def _add_skeleton(self, skel_id, model, offset):
        """The bodies of one URDF (its dofs from ``offset``): each mesh
        link, its joint frame through the fixed joints above it, welds
        folded into their carriers, the articulated trees. Returns the next
        dof offset."""
        links = {l.name: l for l in model.links}
        by_child = {j.child: j for j in model.joints}

        def anchor(parent_name):
            """Nearest MOVING ancestor link (None = world) and the fixed
            transform from its joint frame (or the world) to
            parent_name."""
            segs = []
            name = parent_name
            while name in by_child and by_child[name].jtype == "fixed":
                segs.append(by_child[name])
                name = by_child[name].parent
            ancestor = name if name in by_child else None
            pos, rot = np.zeros(3), np.eye(3)
            for jj in reversed(segs):
                pos = pos + rot @ jj.origin_xyz
                rot = rot @ Q.rpy2mat(jj.origin_rpy)
            return ancestor, pos, rot

        info = {}   # child link -> (joint, moving ancestor, jpos, jrot)
        for j in model.joints:
            anc, apos, arot = anchor(j.parent)
            info[j.child] = (j, anc, apos + arot @ j.origin_xyz,
                             arot @ Q.rpy2mat(j.origin_rpy))

        # articulated trees: moving joints whose parent link moves, each
        # tree in BFS order below its world-jointed root
        movers = [j for j in model.joints if j.jtype != "fixed"]
        moving_children = {}
        for j in movers:
            anc = info[j.child][1]
            if anc is not None:
                moving_children.setdefault(anc, []).append(j.child)
        in_chain, chain_paths = set(), []
        for j in movers:
            if info[j.child][1] is None and j.child in moving_children:
                path, parents = [j.child], [-1]
                frontier = [(j.child, 0)]
                while frontier:
                    cur, pi = frontier.pop(0)
                    for kid in moving_children.get(cur, ()):
                        path.append(kid)
                        parents.append(pi)
                        frontier.append((kid, len(path) - 1))
                chain_paths.append((path, parents))
                in_chain.update(path)
        for j in movers:
            if info[j.child][1] is not None and j.child not in in_chain:
                raise NotImplementedError(
                    f"link {j.child} attaches to moving link "
                    f"{info[j.child][1]} in an unsupported topology "
                    "(floating parents cannot carry child joints)")

        ndof_skel = 0
        slot_of, qoff_of = {}, {}
        welds = []   # (slot, moving-ancestor link name)
        for j in model.joints:
            link = links[j.child]
            if link.mesh_path is None:
                if j.child in in_chain:
                    raise NotImplementedError(
                        "meshless articulated-chain links not supported")
                continue
            _, anc, jpos, jrot = info[j.child]
            jtype = "revolute" if j.jtype == "continuous" else j.jtype
            if jtype not in _NDOF:
                raise NotImplementedError(
                    f"{j.jtype} joints ({j.name}) are not supported")
            ndof = _NDOF[jtype]
            verts, faces = load_obj(link.mesh_path)
            if jtype == "fixed" and anc is not None:
                # a mesh welded onto a moving link: a kinematic primitive
                # riding its carrier (jpos, jrot: its offset in the
                # carrier's frame), its inertia folded into the carrier
                jtype = "weld"
            elif j.child in in_chain:
                jtype = "chain"
            self.bodies.append(_BodyDef(
                jtype=jtype,
                q_offset=offset + ndof_skel if ndof > 0 else -1,
                ndof=ndof,
                mass=float(link.mass),
                inertia=np.asarray(link.inertia, np.float64),
                com=np.asarray(link.inertial_origin, np.float64),
                joint_pos=jpos,
                joint_rot=jrot,
                gravity_on=True,
                support_points=_support_points(verts),
                contact_points=_surface_points(verts, faces,
                                               self.body_contact_points),
                skeleton=skel_id,
                axis=(np.asarray(j.axis, np.float64)
                      / np.linalg.norm(j.axis)),
                limit_lower=float(j.limit_lower),
                limit_upper=float(j.limit_upper),
                limit_velocity=float(j.limit_velocity)))
            slot_of[j.child] = len(self.bodies) - 1
            qoff_of[j.child] = offset + ndof_skel if ndof > 0 else -1
            if jtype == "weld":
                welds.append((len(self.bodies) - 1, anc))
            ndof_skel += ndof
        self.skeleton_ndof.append(ndof_skel)

        # composite rigid bodies: each weld's mass, COM and inertia
        # (parallel axis) folded into its moving ancestor
        for s, anc in welds:
            if anc not in slot_of:
                raise NotImplementedError(
                    f"weld ancestor {anc} has no collision mesh")
            p = slot_of[anc]
            self.bodies[s].weld_parent = p
            pb, wb = self.bodies[p], self.bodies[s]
            d, Rd, m_w = wb.joint_pos, wb.joint_rot, wb.mass
            c_w = d + Rd @ wb.com
            I_w = Rd @ wb.inertia @ Rd.T
            m_t = pb.mass + m_w
            c_t = (pb.mass * pb.com + m_w * c_w) / m_t

            def shift(r):
                return (r @ r) * np.eye(3) - np.outer(r, r)

            I_t = (pb.inertia + pb.mass * shift(pb.com - c_t)
                   + I_w + m_w * shift(c_w - c_t))
            pb.mass, pb.inertia, pb.com = m_t, I_t, c_t

        for path, tree_parents in chain_paths:
            members, qidx = [], []
            for name in path:
                jj, _, jpos, jrot = info[name]
                if jj.jtype not in ("revolute", "prismatic", "continuous",
                                    "floating"):
                    raise NotImplementedError(
                        "articulated trees support revolute/prismatic/"
                        f"floating joints only (got {jj.jtype} at {name})")
                bb = self.bodies[slot_of[name]]   # composite if welded-on
                jt = "revolute" if jj.jtype == "continuous" else jj.jtype
                axis = np.asarray(jj.axis, np.float64)
                if jt != "floating":
                    axis = axis / np.linalg.norm(axis)
                members.append(ChainJoint(
                    jtype=jt, origin_pos=jpos, origin_rot=jrot, axis=axis,
                    mass=bb.mass, inertia=bb.inertia,
                    com=np.asarray(bb.com, np.float64),
                    damping=self.joint_damping,
                    limit_lower=float(jj.limit_lower),
                    limit_upper=float(jj.limit_upper),
                    limit_velocity=float(jj.limit_velocity)))
                qidx.append(qoff_of[name] + np.arange(members[-1].ndof))
            self._chains.append({
                "chain": ArticulatedTree(members, np.zeros(3), np.eye(3),
                                         self.gravity, self.dt, self.dtype,
                                         parents=tree_parents),
                "slots": [slot_of[n] for n in path],
                "qidx": np.concatenate(qidx),
            })
            for s in self._chains[-1]["slots"]:
                self.bodies[s].chain_id = len(self._chains) - 1
        return offset + ndof_skel

    def _build_groups(self):
        """The batched groups: one a moving kind and one an articulated
        tree, in the order of their first body; the fixed bodies' constant
        rows; all welds in one group composed after the rest."""
        bs = self.bodies
        offset = self.state_dim_half
        dev = self._dev
        self._g = dev(self.gravity)
        self._gravity_masked = not all(b.gravity_on for b in bs)
        self._gravity_on = dev([1.0 if b.gravity_on else 0.0
                                for b in bs]).reshape(-1, 1)
        self._com = dev([b.com for b in bs]).reshape(-1, 3)
        self._kinds: List[_Kind] = []
        for kind in ("floating", "revolute", "prismatic"):
            slots = [s for s, b in enumerate(bs) if b.jtype == kind]
            if slots:
                self._kinds.append(self._make_kind(kind, slots))
        for spec in self._chains:
            k = _Kind("chain", spec["slots"], list(spec["qidx"]), len(bs),
                      offset, self.device)
            k.tree = spec["chain"]
            k.support = dev([bs[s].support_points
                             for s in k.slots]).reshape(-1, 8, 3)
            k.com = dev([bs[s].com for s in k.slots]).reshape(-1, 3)
            # free-joint actions enter through the wrench rows
            k.free = [(m, int(k.tree.dof_off[m]))
                      for m, j in enumerate(k.tree.joints)
                      if j.jtype == "floating"]
            k.free_mask = dev([0.0 if j.jtype == "floating" else 1.0
                               for j in k.tree.joints for _ in range(j.ndof)])
            self._kinds.append(k)
        self._kinds.sort(key=lambda k: k.slots[0])
        rows = list(self._kinds)
        fixed = [s for s, b in enumerate(bs) if b.jtype == "fixed"]
        if fixed:
            fx = [bs[s] for s in fixed]
            zero = dev(np.zeros((len(fx), 3)))
            rows.append(_Kind("fixed", fixed, [], len(bs), offset,
                              self.device))
            rows[-1].rows = (dev([b.joint_pos for b in fx]),
                             Q.mat2quat(dev([b.joint_rot for b in fx])),
                             zero, zero)
        rows.sort(key=lambda k: k.slots[0])
        self._rows = rows
        self._welds = None
        welds = [s for s, b in enumerate(bs) if b.jtype == "weld"]
        groups = list(rows)
        if welds:
            # the welds' parents, by their place in the concatenated rows
            at = {s: i for i, s in enumerate(s for k in rows for s in k.slots)}
            w = _Kind("weld", welds, [], len(bs), offset, self.device)
            wb = [bs[s] for s in welds]
            parents = [b.weld_parent for b in wb]
            w.parent_at = torch.as_tensor([at[p] for p in parents],
                                          dtype=torch.int64,
                                          device=self.device)
            w.parent_sel = _selector(parents, len(bs), self.device)
            w.offset = dev([b.joint_pos for b in wb]).reshape(-1, 3)
            w.rot_t = dev([b.joint_rot.T for b in wb]).reshape(-1, 3, 3)
            w.quat = Q.mat2quat(dev([b.joint_rot for b in wb]).reshape(-1, 3, 3))
            w.parent_com = dev([bs[p].com for p in parents]).reshape(-1, 3)
            w.com = dev([b.com for b in wb]).reshape(-1, 3)
            w.support = dev([b.support_points for b in wb]).reshape(-1, 8, 3)
            # the fold: weld rows zeroed, each weld's wrench onto its parent
            w.keep = dev([0.0 if b.jtype == "weld" else 1.0
                          for b in bs]).reshape(-1, 1)
            w.to_parent = dev([[1.0 if p == s else 0.0 for p in parents]
                               for s in range(len(bs))])
            self._welds = w
            groups.append(w)
        self._slot_order = _order(groups, lambda k: k.slots, self.device)
        self._dof_order = _order(self._kinds, lambda k: k.dofs, self.device)
        self._do_body_contact = self.body_contact and bool(self._contact_pairs)
        self._need_states = (bool(welds) or self._do_body_contact
                             or (self.enable_floor and bool(self._chains)))
        if self._do_body_contact:
            self._contact_pts = {s: dev(bs[s].contact_points)
                                 for p in self._contact_pairs for s in p}

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
        (``adjust_action_with_ext_force``): a floating body's own
        (composite) mass; for a tree member on a floating joint, the mass
        of its whole subtree whose gravity is on (the tree's potential);
        None for a body without a free joint."""
        b = self.bodies[slot]
        if b.jtype == "floating":
            return b.mass
        if b.jtype != "chain":
            return None
        spec = self._chains[b.chain_id]
        m = spec["slots"].index(slot)
        ch = spec["chain"]
        if ch.joints[m].jtype != "floating":
            return None

        def in_subtree(j):
            while j >= 0:
                if j == m:
                    return True
                j = ch.parents[j]
            return False

        return sum(ch.joints[j].mass for j in range(len(ch.joints))
                   if in_subtree(j) and ch.joints[j].gravity_on)

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
        group's rows in one batched call, the fixed bodies' constant, the
        welds' composed onto their resolved parents; put in slot order by
        one ``cat`` and, where the groups interleave, one gather per
        field."""
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
            elif k.kind == "prismatic":
                # the link frame is the joint frame, slid along the world
                # axis; its body-frame velocity is axis * qd
                rows.append((k.joint_pos + k.axis_w * q[:, None],
                             k.joint_quat, k.axis * qd[:, None], k.zero))
            else:
                rows.append(k.tree.body_states(q, qd))
        if self._welds is not None:
            rows = [tuple(_assemble([r[i] for r in rows], None)
                          for i in range(4))]
            rows.append(self._weld_rows(*rows[0]))
        pos, quat, v, w = (_assemble([r[i] for r in rows], self._slot_order)
                           for i in range(4))
        return BodyState(pos=pos, quat=quat, v=v, w=w)

    def _weld_rows(self, pos, quat, v, w):
        """The welds' rows from their parents' (rows of the concatenated
        non-weld groups): the fixed offset composed onto the parent's pose;
        the parent's origin velocity from its COM spatial velocity, carried
        to the weld's origin and expressed as the weld's COM spatial
        velocity."""
        k = self._welds
        pp, pq = pos[k.parent_at], quat[k.parent_at]
        pv, pw = v[k.parent_at], w[k.parent_at]
        v_orig_p = pv - torch.cross(pw, k.parent_com, dim=-1)
        w_b = (k.rot_t @ pw[..., None])[..., 0]
        v_orig = (k.rot_t @ (v_orig_p + torch.cross(pw, k.offset, dim=-1))
                  [..., None])[..., 0]
        return (pp + Q.qrot(pq, k.offset), Q.qmul(pq, k.quat),
                v_orig + torch.cross(w_b, k.com, dim=-1), w_b)

    def _world_state(self, bs, sel, com):
        """(pos, quat, world velocity at the origin, world angular
        velocity) of the bodies ``sel`` (a ``_selector``) with COMs
        ``com``, from body_states' body-frame COM spatial velocity."""
        quat, v, w = _take(bs.quat, sel), _take(bs.v, sel), _take(bs.w, sel)
        return (_take(bs.pos, sel), quat,
                Q.qrot(quat, v - torch.cross(w, com, dim=-1)),
                Q.qrot(quat, w))

    def _floor_wrench(self, k, pos, bq, v, w):
        """Spring-damper floor penalty at the support points ``k.support``
        (B, 8, 3) of a group's bodies; (B, 3) force and torque about the
        body origin. v, w: world velocity at the origin and world angular
        velocity."""
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
             ext_f: torch.Tensor, prims=None) -> RigidState:
        """Semi-implicit Euler step. ext_f: (B, 6) window-averaged wrench
        [force, torque about the body origin] per primitive; action: per
        free joint the [torque(3), force(3)], world frame, at the origin,
        per revolute joint the torque about its axis, per prismatic joint
        the force along it. ``prims`` (the SDF tables, one a body) is
        needed with ``body_contact`` on. Each group is stepped in one
        batched call; the new q and qd are put in dof order by one ``cat``
        (and, where the groups interleave, one gather)."""
        if not self._kinds:
            return state
        if action is None:
            action = torch.zeros((self.action_dim,), dtype=self.dtype,
                                 device=self.device)
        action = action.reshape(-1)[:self.action_dim]
        # each primitive's measured wrench is gated by its own ext-force
        # flag; the floor penalty and body contact act regardless of it
        if self._gravity_masked:
            ext_f = ext_f * self._gravity_on
        bs = self.body_states(state) if self._need_states else None
        if self._do_body_contact:
            if prims is None:
                raise ValueError(
                    "RIGID.body_contact is on but no SDF tables were passed "
                    "to RigidModel.step(prims=...)")
            # before the weld fold: contact on a welded primitive acts on
            # its composite carrier
            ext_f = ext_f + self.body_contact_wrenches(bs, prims)
        if self._welds is not None:
            ext_f = self._fold_welds(ext_f, bs)
        qs, qds = [], []
        for k in self._kinds:
            q, qd = _take(state.q, k.dof_sel), _take(state.qd, k.dof_sel)
            a, f = _take(action, k.dof_sel), _take(ext_f, k.slot_sel)
            if k.kind == "floating":
                q, qd = self._floating_step(k, q.reshape(-1, 6),
                                            qd.reshape(-1, 6),
                                            a.reshape(-1, 6), f)
                q, qd = q.reshape(-1), qd.reshape(-1)
            elif k.kind == "chain":
                q, qd = self._chain_step(k, q, qd, a, f, bs)
            else:
                q, qd = self._one_dof_step(k, q, qd, a, f)
            qs.append(q)
            qds.append(qd)
        return RigidState(q=_assemble(qs, self._dof_order),
                          qd=_assemble(qds, self._dof_order))

    def _fold_welds(self, ext_f, bs):
        """Wrenches on welded primitives (the floor's included) act on the
        composite body: each is shifted to its parent's origin ([f, t + r x
        f]) and added to the parent's row; the weld rows are zeroed (welds
        have no dynamics of their own)."""
        k = self._welds
        f = _take(ext_f, k.slot_sel)
        if self.enable_floor:
            f_fl, t_fl = self._floor_wrench(
                k, *self._world_state(bs, k.slot_sel, k.com))
            f = f + torch.cat([f_fl, t_fl], dim=-1)
        r = _take(bs.pos, k.slot_sel) - _take(bs.pos, k.parent_sel)
        shifted = torch.cat(
            [f[:, :3], f[:, 3:] + torch.cross(r, f[:, :3], dim=-1)], dim=-1)
        return ext_f * k.keep + k.to_parent @ shifted

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

    def _chain_step(self, k, q, qd, a, ext_f, bs):
        """One articulated tree's step: its members' wrench rows (and the
        floor's, about each joint origin), free-joint actions routed
        through the wrench rows (the chart's J^T maps them exactly), the
        rest of the actions as joint forces."""
        rows = ext_f
        if self.enable_floor:
            f_fl, t_fl = self._floor_wrench(
                k, *self._world_state(bs, k.slot_sel, k.com))
            rows = rows + torch.cat([f_fl, t_fl], dim=-1)
        if k.free:
            zero = torch.zeros_like(rows[0])
            add = [zero] * len(k.slots)
            for m, o in k.free:
                add[m] = torch.cat([a[o + 3:o + 6], a[o:o + 3]])
            rows = rows + torch.stack(add)
            a = a * k.free_mask
        return k.tree.step(q, qd, a, rows)

    # ------------------------------------------------------------------
    # rigid-rigid (body-body) penalty contact
    # ------------------------------------------------------------------
    def body_contact_wrenches(self, bs: BodyState, prims) -> torch.Tensor:
        """(B, 6) world wrenches [force, torque about the body origin] of
        body-body penalty contact over all cross-skeleton pairs. Each pair
        is sampled from both sides (a's surface points against b's SDF and
        b's against a's); the forces are equal and opposite at the same
        world points."""
        world = self._world_state(bs, None, self._com)
        rows = [None] * self.n_primitives
        for i, j in self._contact_pairs:
            for a, b in ((i, j), (j, i)):
                F, tau_a, tau_b = self._points_vs_sdf_wrench(a, b, world,
                                                             prims)
                for s, row in ((a, torch.cat([F, tau_a])),
                               (b, torch.cat([-F, tau_b]))):
                    rows[s] = row if rows[s] is None else rows[s] + row
        zero = torch.zeros((6,), dtype=self.dtype, device=bs.pos.device)
        return torch.stack([zero if r is None else r for r in rows])

    def _pair_reduced_mass(self, a: int, b: int) -> float:
        """Reduced translational mass of a contact pair; fixed bodies count
        as infinite (their velocity is not changed by the contact)."""
        inv = 0.0
        for s in (a, b):
            if self.bodies[s].jtype != "fixed":
                inv += 1.0 / max(self.bodies[s].mass, 1e-12)
        return 1.0 / max(inv, 1e-12)

    def _points_vs_sdf_wrench(self, a: int, b: int, world, prims):
        """Penalty force of body a's surface samples against body b's SDF:
        (the force on a (3,), its torque about a's origin, the reaction's
        torque about b's origin)."""
        pts = self._contact_pts[a]                      # (K, 3)
        pos_a, q_a, v_a, w_a = (t[a] for t in world)
        pos_b, q_b, v_b, w_b = (t[b] for t in world)
        p_w = Q.qrot(q_a.expand(pts.shape[0], 4), pts) + pos_a
        sdf, n_t = contact_ops.sample_sdf_normal_world(
            prims[b], (pos_b[0], pos_b[1], pos_b[2]),
            (q_b[0], q_b[1], q_b[2], q_b[3]),
            (p_w[:, 0], p_w[:, 1], p_w[:, 2]))
        n = torch.stack(n_t, dim=-1)                    # (K, 3) world, unit
        act = (sdf < 0.0).to(self.dtype)                # BIG outside the box
        zero = torch.zeros_like(sdf)

        r_a = p_w - pos_a
        r_b = p_w - pos_b
        v_pa = v_a + torch.cross(w_a.expand_as(r_a), r_a, dim=-1)
        v_pb = v_b + torch.cross(w_b.expand_as(r_b), r_b, dim=-1)
        v_rel = v_pa - v_pb
        vn = torch.sum(v_rel * n, dim=-1)

        pen = torch.maximum(-sdf, zero) * act
        fn = torch.maximum(self.body_contact_stiffness * pen
                           - self.body_contact_damping * vn * act, zero)
        vt = v_rel - vn[:, None] * n
        vt_norm = torch.sqrt(torch.sum(vt * vt, dim=-1) + 1e-24)
        mu = self.body_contact_friction
        if self.body_contact_stick > 0.0:
            # the Coulomb-clamped force cancelling the pair's MEAN relative
            # tangential momentum within one step, spread over the samples
            # by normal force (each point's friction cone holds); 0.5: the
            # pair is sampled from both sides, and either pass alone would
            # cancel the whole momentum
            n_act = torch.clamp(torch.sum(act), min=1.0)
            fn_sum = torch.clamp(torch.sum(fn), min=1e-24)
            vt_mean = torch.sum(act[:, None] * vt, dim=0) / n_act
            vtm = torch.sqrt(torch.sum(vt_mean * vt_mean) + 1e-24)
            f_tot = torch.minimum(
                0.5 * self.body_contact_stick
                * self._pair_reduced_mass(a, b) * vtm / self.dt,
                mu * fn_sum)
            f_t = -(f_tot / fn_sum) * fn[:, None] * (vt_mean / vtm)
        else:
            # Coulomb-clamped viscous friction
            ft_mag = torch.minimum(self.body_contact_damping * vt_norm,
                                   mu * fn)
            f_t = -ft_mag[:, None] * vt / vt_norm[:, None]
        f = (fn[:, None] * n + f_t) * act[:, None]
        return (torch.sum(f, dim=0),
                torch.sum(torch.cross(r_a, f, dim=-1), dim=0),
                torch.sum(torch.cross(r_b, -f, dim=-1), dim=0))
