"""Scene building, the forward rollout and its gradient.

Counterpart of ``softmac_tpu/engine/env.py`` for the rigid-coupled scenes:
the velocity-controlled pour_vel (particle contact against SDF primitives
whose (w, v) the actions set), the flagship pour (forecast mixed contact
against floating, force-controlled bodies that the ``RigidModel`` steps
once per env step with the window-averaged contact wrench), the door and
the grip (``control_mode`` "mpm": the actions drive particle controllers,
and the ``RigidModel`` steps the bodies with no action), and the
cloth-coupled hit and taco (a ``CLOTH`` section: the carry is (mpm, cloth,
pen); each env step runs its substeps against the forecast cloth with the
contact pairs and penetration bits traced after each, then one
projective-dynamics cloth step on the window-averaged vertex forces, then
the pairs re-resolved against the moved cloth). In ``control_mode``
"cloth" (the taco) an action is the attachment vertices' targets, (3 *
n_att,), which the cloth step takes; the particle controllers get none.
``rollout`` (under ``torch.no_grad()``) and ``rollout_and_grad``
(autograd, then ``torch.autograd.grad`` of the loss with respect to the
actions) run one loop, eagerly on ``device`` (CUDA by default):

    sort particles by y-cell
    for each loss block:   clip the carry's cotangent (``grad_clip``),
                           re-sort (``_resort``)
        for each env step: substeps (P2G / grid / G2P kernels) + pose update
                           or rigid step, checkpointed per ``remat``
        loss terms at the block boundary, on the unsorted particle order
        at a ``bptt_window`` segment end: detach the carry
    unsort the exit carry

with the same loss-frame sampling as the JAX rollout (``_sample_mask``).
``batched_rollout`` and ``batched_rollout_and_grad`` run B trajectories
(a batched carry: the carry with a leading B on every tensor, from
``jittered_carry`` or the initial state broadcast B ways) one after
another through the same loop, which gives what JAX's vmap over the
rollout gives.

The imperative facade (the reference's ``TaichiEnv``: ``reset``, ``step``,
``get_observation``, ``get_state`` / ``set_state``, ``compute_loss``,
``backward``; JAX env.py:377-711) holds one carry between calls. It keeps
that carry sorted by y-cell, as the rollout does, with the permutation
(sorted position -> original particle index), and re-keys it at every
``step``; whatever a reader returns is in the original particle order.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from pathlib import Path

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from softmac_tpu_torch.engine import cloth_contact as cc
from softmac_tpu_torch.engine import mpm as mpm_mod
from softmac_tpu_torch.engine.cloth import (
    ClothModel, ClothState, parse_scene_config, transform_mesh,
)
from softmac_tpu_torch.engine.losses import LOSS_REGISTRY, FrameSample
from softmac_tpu_torch.engine.materials import lame_parameters
from softmac_tpu_torch.engine.meshio import load_obj, load_urdf
from softmac_tpu_torch.engine.rigid import (
    GradScale, RigidModel, RigidState, RigidVelocityModel, grad_scale,
)
from softmac_tpu_torch.engine.sdf import preprocess_sdf, sdf_params_from_bake
from softmac_tpu_torch.engine.shapes import Shapes
from softmac_tpu_torch.engine.types import (
    BodyState, MPMConfig, MPMParams, MPMState, mpm_state_from_packed,
    mpm_state_to_packed, mpm_state_zero,
)

REPO_ROOT = Path(__file__).resolve().parents[2]


def resolve_device(device) -> torch.device:
    """``None`` means CUDA, which must then be present: the port never
    moves to the CPU unless the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run the plain PyTorch path on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device


def _resolve_dtype(cfg, device: torch.device) -> torch.dtype:
    """float32 on CUDA, float64 on the CPU ("auto"), as the JAX package
    runs f32 on accelerators and f64 on the CPU under x64."""
    choice = cfg.TPU.compute_dtype if "TPU" in cfg else "auto"
    if choice in ("float32", "f32"):
        return torch.float32
    if choice in ("float64", "f64"):
        return torch.float64
    return torch.float32 if device.type == "cuda" else torch.float64


class ClipCotangent(torch.autograd.Function):
    """Identity whose backward zeroes non-finite cotangent entries and
    scales the cotangents of all its tensors together to global L2 norm
    <= cap (``clip_cotangent`` of the JAX package). Applied to the carry at
    block boundaries it clips the gradient through time only when it
    explodes."""

    @staticmethod
    def forward(ctx, cap, *tensors):
        ctx.cap = cap
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.where(torch.isfinite(g), g, 0.0) for g in grads]
        sq = sum(torch.sum(g * g) for g in grads)
        scale = torch.clamp(ctx.cap / torch.sqrt(sq + 1e-30), max=1.0)
        return (None,) + tuple(g * scale for g in grads)


def _carry_tensors(carry):
    """The tensors of a rigid carry (mpm, bodies, rigid) or a cloth carry
    (mpm, cloth, pen), in a fixed order."""
    mpm, second, third = carry
    head = (mpm.x, mpm.v, mpm.C, mpm.F)
    if isinstance(second, ClothState):
        return head + (second.x, second.v, third.contact_id,
                       third.penetration)
    return head + (second.pos, second.quat, second.v, second.w, third.q,
                   third.qd)


def _carry_from(t, like):
    """A carry of ``like``'s kind from the tensors ``t`` of
    ``_carry_tensors``."""
    mpm = MPMState(x=t[0], v=t[1], C=t[2], F=t[3])
    if isinstance(like[1], ClothState):
        return (mpm, ClothState(x=t[4], v=t[5]),
                cc.PenetrationState(contact_id=t[6], penetration=t[7]))
    return (mpm, BodyState(pos=t[4], quat=t[5], v=t[6], w=t[7]),
            RigidState(q=t[8], qd=t[9]))


def map_carry(fn, carry):
    """``fn`` applied to every tensor of a carry (``jax.tree.map`` over the
    port's (mpm, bodies, rigid) or (mpm, cloth, pen) carry), e.g. to tile
    or slice a batched carry along its leading axis."""
    return _carry_from([fn(t) for t in _carry_tensors(carry)], carry)


def _clip_carry(carry, cap):
    """``ClipCotangent`` over the carry's floating tensors together (the
    integer side-state has no cotangent)."""
    ts = list(_carry_tensors(carry))
    fl = [i for i, t in enumerate(ts) if t.is_floating_point()]
    for i, t in zip(fl, ClipCotangent.apply(cap, *(ts[i] for i in fl))):
        ts[i] = t
    return _carry_from(ts, carry)


def _remat_group(remat, block):
    """Env steps per checkpoint for ``remat``: 1 for "step", the largest
    divisor of the loss block <= K for "window:K" (as the JAX rollout),
    None (no checkpoint) for "none" and for None, the forward rollout."""
    if remat is None or remat == "none":
        return None
    if remat == "step":
        return 1
    if isinstance(remat, str) and remat.startswith("window:"):
        k = int(remat.split(":", 1)[1])
        if k < 1:
            raise ValueError(f"remat window must be >= 1, got {remat!r}")
        k = min(k, block)
        while block % k != 0:
            k -= 1
        return k
    raise ValueError(
        f"remat must be 'step', 'none' or 'window:K', got {remat!r}")


class SoftMacEnv:
    def __init__(self, cfg, device=None, init_particles=None):
        self.device = resolve_device(device)
        self.dtype = _resolve_dtype(cfg, self.device)
        if self.device.type == "cuda":
            if self.dtype != torch.float32:
                raise ValueError("the CUDA kernels run in float32; set "
                                 "TPU.compute_dtype to 'auto' or 'float32'")
            # the chamfer's a @ b.T must stay in full float32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        mpm_scale = cfg.get("mpm_scale", 1.0)
        self.mpm_scale = mpm_scale
        self.search_dirs = [".", str(REPO_ROOT)]
        self.has_cloth = bool(cfg.get("CLOTH") and cfg.CLOTH.get("sceneConfig"))
        if cfg.control_mode == "cloth" and not self.has_cloth:
            raise ValueError("control_mode 'cloth' needs a CLOTH section")

        # ---------------- particles ----------------------------------------
        # init_particles overrides SHAPES with an explicit (N, 3) position
        # array (or (N, >=6) packed state whose first 3 columns are x)
        # array (or (N, >=6) packed state whose first 3 columns are x); its
        # particles are drawn black, as the JAX package's
        if init_particles is not None:
            self.init_particles = np.asarray(init_particles, np.float64)[:, :3]
            self.particle_colors = np.zeros(len(init_particles), np.int64)
        else:
            self.init_particles, self.particle_colors = Shapes(
                cfg.SHAPES, self.search_dirs).get()
        self.n_particles = len(self.init_particles)

        # ---------------- primitives (URDF -> SDF tables) -------------------
        # per moving link, in the order of ``prims``: its table, its colour
        # and its rest-frame mesh (the renderer's)
        prims, prim_friction, prim_ext_force, urdf_models = [], [], [], []
        self.prim_colors, self.prim_meshes = [], []
        prim_cfgs = cfg.PRIMITIVES if isinstance(cfg.PRIMITIVES, (list, tuple)) else []
        for pc in prim_cfgs:
            model = load_urdf(str(self._resolve(pc.urdf_path)))
            urdf_models.append(model)
            for link, _joint in model.moving_links():
                verts, faces = load_obj(link.mesh_path)
                bake = preprocess_sdf(verts, faces,
                                      Path(link.mesh_path).parent,
                                      device=self.device)
                prims.append(sdf_params_from_bake(bake, self.dtype, self.device))
                self.prim_colors.append(link.color)
                self.prim_meshes.append((verts, faces))
                prim_friction.append(pc.friction)
                prim_ext_force.append(
                    bool(pc.get("enable_external_force", True)))
        self.prims = tuple(prims)
        self.n_primitives = len(self.prims)
        self.control_mode = cfg.control_mode

        # ---------------- MPM config/params ---------------------------------
        sim = cfg.SIMULATOR
        quality = sim.quality * (0.5 if sim.dim == 3 else 1.0)
        substeps = int(round(cfg.env_dt / sim.dt))
        self.substeps = substeps
        active_window = None
        if "TPU" in cfg and cfg.TPU.get("active_window"):
            active_window = tuple(cfg.TPU.active_window)
        if active_window is not None:
            cells = np.floor(self.init_particles
                             * (128 * quality / mpm_scale) - 0.5)
            ext = cells.max(0) - cells.min(0) + 3   # stencil rows base..+2
            for d, w in enumerate(active_window):
                if ext[d] > w:
                    warnings.warn(
                        f"TPU.active_window[{d}]={w} cannot cover the "
                        f"initial particle extent ({int(ext[d])} stencil "
                        "rows): mass will be dropped from the transfers "
                        "on the FIRST substep. Enlarge the window.")
        self.mpm_cfg = MPMConfig(
            n_particles=self.n_particles,
            n_grid=int(128 * quality),
            dt=sim.dt,
            substeps=substeps,
            active_window=active_window,
            material_model=sim.material_model,
            ptype=sim.ptype,
            collision_type=sim.collision_type,
            ground_friction=sim.ground_friction,
            n_primitives=self.n_primitives,
            n_controllers=int(sim.n_controllers),
            primitives_contact=(True,) * self.n_primitives,
            mpm_scale=mpm_scale,
            contact_push_velocity_cap=float(
                sim.get("contact_push_velocity_cap", np.inf)),
            cfl_velocity_clamp=float(sim.get("cfl_velocity_clamp", np.inf)),
            dtype=self.dtype,
        )
        mu, lam = lame_parameters(sim.E, sim.nu, sim.ptype)
        n = self.n_particles
        kw = dict(dtype=self.dtype, device=self.device)
        self.mpm_params = MPMParams(
            mu=torch.full((n,), mu, **kw),
            lam=torch.full((n,), lam, **kw),
            yield_stress=torch.full((n,), sim.yield_stress, **kw),
            gravity=torch.tensor(sim.gravity, **kw),
            control_idx=torch.full((n,), -1, dtype=torch.int32,
                                   device=self.device),
            friction=torch.tensor(prim_friction or [0.0], **kw),
            softness=torch.full((max(self.n_primitives, 1),), 666.0, **kw),
        )

        self.cloth_model = self.cloth_params = None
        if self.has_cloth:
            self._build_cloth(cfg, mpm_scale)

        # ---------------- rigid bodies ----------------------------------------
        self.rigid_vel_model = None
        self.rigid_model = None
        if self.n_primitives > 0:
            if cfg.rigid_velocity_control:
                self.rigid_vel_model = RigidVelocityModel(
                    self.n_primitives, cfg.RIGID, self.dtype, self.device)
            else:
                self.rigid_model = RigidModel(
                    urdf_models, cfg.RIGID, cfg.env_dt, self.dtype,
                    self.device, ext_force_flags=prim_ext_force)
                assert self.rigid_model.n_primitives == self.n_primitives
        self.ext_grad_scale = float(cfg.RIGID.get("ext_grad_scale", 1.0))

        # ---------------- loss ----------------------------------------------
        self.loss = None
        if cfg.ENV.loss_type != "":
            if cfg.ENV.loss_type not in LOSS_REGISTRY:
                raise NotImplementedError(
                    f"loss {cfg.ENV.loss_type} is not ported yet")
            self.loss = LOSS_REGISTRY[cfg.ENV.loss_type](cfg.ENV.loss, self)

        if self.control_mode == "mpm":
            self.action_dim = 3 * self.mpm_cfg.n_controllers
        elif self.control_mode == "cloth":
            self.action_dim = 3 * len(self.cloth_model.attachment_idx)
        elif self.rigid_model is not None:
            self.action_dim = self.rigid_model.action_dim
        else:
            self.action_dim = 6 * self.n_primitives
        self._overflow_warned = False
        self.n_observed = int(cfg.ENV.get("n_observed_particles", 200))
        self.render_cfg = cfg.RENDERER
        self._renderer = None

        # ---------------- runtime state (facade) ------------------------------
        self._is_copy = False
        self.keep_history = True
        self.reset()

    def _build_cloth(self, cfg, mpm_scale):
        """The cloth model and its contact parameters (JAX env.py:218-268):
        the mesh of the sceneConfig from ``envs/assets``, placed by
        ``CLOTH.transform``; the face adjacency read from its cached
        ``adjacency_<mesh>.npz`` beside it, or searched (and not written)
        where there is none."""
        scene = dict(cfg.CLOTH.sceneConfig[0])
        mesh_name = Path(str(scene["fabric:name"])).name
        mesh_path = self._resolve(Path("envs/assets") / mesh_name.split(".")[0]
                                  .split("_")[0] / mesh_name)
        cverts, cfaces = load_obj(mesh_path)
        if len(cfg.CLOTH.get("transform", [])) > 0:
            cverts = transform_mesh(cverts, dict(cfg.CLOTH.transform[0]))
        sp = parse_scene_config(scene)
        sp["dt"] = cfg.env_dt
        sp["velocity_damping"] = float(cfg.CLOTH.get("velocity_damping", 0.02))
        if cfg.CLOTH.get("n_iterations"):
            # CLOTH.n_iterations overrides the sceneConfig's solverIterations
            sp["n_iterations"] = int(cfg.CLOTH.n_iterations)
        self.cloth_model = ClothModel(cverts, cfaces, dtype=self.dtype,
                                      device=self.device, **sp)
        pcfg = cfg.PRIMITIVES     # cloth scenes: one contact-param node
        nb_cache = Path(mesh_path).parent / f"adjacency_{mesh_name}.npz"
        if nb_cache.exists():
            data = np.load(nb_cache)
            nb, nd = data["neighbors"], data["dirs"]
        else:
            nb, nd = cc.process_faces(cfaces, n_neighbors=200)
        kw = dict(dtype=self.dtype, device=self.device)
        self.cloth_params = cc.ClothContactParams(
            faces=torch.as_tensor(np.asarray(cfaces), dtype=torch.int64,
                                  device=self.device),
            neighbor_faces=torch.as_tensor(np.asarray(nb), dtype=torch.int32,
                                           device=self.device),
            neighbor_dirs=torch.as_tensor(np.asarray(nd), dtype=torch.int8,
                                          device=self.device),
            friction=torch.tensor(float(pcfg.friction), **kw),
            softness=torch.tensor(float(pcfg.get("softness", 666.0)), **kw),
            cloth_force_scale=torch.tensor(
                float(pcfg.get("cloth_force_scale", 1.0)), **kw),
            mpm_force_scale=torch.tensor(
                float(pcfg.get("mpm_force_scale", 1.0)), **kw),
            sticky=bool(pcfg.get("sticky", False)),
            mpm_scale=float(mpm_scale),
            push_velocity_cap=float(pcfg.get("push_velocity_cap", 5.0)),
            contact_geom_grad_scale=float(
                pcfg.get("contact_geom_grad_scale", 1.0)),
            contact_cv_grad_scale=float(
                pcfg.get("contact_cv_grad_scale", 1.0)))

    def _resolve(self, path) -> Path:
        p = Path(path)
        if p.exists():
            return p
        for d in self.search_dirs:
            cand = Path(d) / p
            if cand.exists():
                return cand
        raise FileNotFoundError(f"{path} not found in {self.search_dirs}")

    def set_primitives_contact(self, flags):
        """Turn each primitive's contact on or off (the reference's
        ``simulator.primitives_contact``; demo_grip turns the palm's off).
        A substep skips the primitives whose flag is off."""
        flags = tuple(bool(f) for f in flags)
        if len(flags) != self.n_primitives:
            raise ValueError(f"{len(flags)} contact flags for "
                             f"{self.n_primitives} primitives")
        self.mpm_cfg = dataclasses.replace(self.mpm_cfg,
                                           primitives_contact=flags)

    def set_control_mode(self, mode):
        """Switch between "mpm", "cloth" and "rigid" control (the
        reference's soft_cloth taichi_env.py:133-135; JAX env.py:588):
        "mpm" and "cloth" set ``action_dim`` (3 per particle controller, 3
        per attachment vertex); "rigid" leaves it as it was."""
        if mode not in ("mpm", "rigid", "cloth"):
            raise ValueError(f"unknown control mode {mode!r}")
        if mode == "cloth" and not self.has_cloth:
            raise ValueError("control_mode 'cloth' needs a CLOTH section")
        self.control_mode = mode
        if mode == "mpm":
            self.action_dim = 3 * self.mpm_cfg.n_controllers
        elif mode == "cloth":
            self.action_dim = 3 * len(self.cloth_model.attachment_idx)

    def set_control_idx(self, idx):
        """Assign each particle to a controller (-1: none), (N,) ints."""
        self.mpm_params = self.mpm_params.replace(
            control_idx=torch.as_tensor(np.asarray(idx), dtype=torch.int32,
                                        device=self.device))

    # ==================================================================
    # initial state and one env step
    # ==================================================================
    def _initial_carry(self):
        x0 = torch.as_tensor(np.asarray(self.init_particles, np.float64),
                             device=self.device)
        if x0.shape[1] == 3:
            mpm0 = mpm_state_zero(self.mpm_cfg, x0)
        else:
            mpm0 = mpm_state_from_packed(self.mpm_cfg, x0)
        if self.has_cloth:
            # (mpm, cloth, pen): the first pairs against the rest cloth
            cloth0 = self.cloth_model.init_state()
            pen0 = torch.zeros((self.n_particles,), dtype=torch.int8,
                               device=self.device)
            cid0 = cc.get_contact_pair(self.cloth_params, cloth0.x,
                                       tuple(mpm0.x), pen0)
            return (mpm0, cloth0, cc.PenetrationState(contact_id=cid0,
                                                      penetration=pen0))
        empty = torch.zeros((0,), dtype=self.dtype, device=self.device)
        rigid0 = RigidState(q=empty, qd=empty.clone())
        if self.rigid_vel_model is not None:
            bodies0 = self.rigid_vel_model.init_bodies()
        elif self.rigid_model is not None:
            rigid0 = self.rigid_model.init_state()
            bodies0 = self.rigid_model.body_states(rigid0)
        else:
            bodies0 = BodyState.identity(0, self.dtype, self.device)
        return (mpm0, bodies0, rigid0)

    def _env_step_fn(self, carry, action, params=None, loss_weights=None,
                     unsort_perm=None):
        """(carry, action) -> (carry, (overflow, ext_f[, loss_terms])).

        ``params`` are the per-particle parameters in the carry's particle
        order. ``loss_weights`` (substeps,) host floats engage the general
        loss-stride path: substep k adds weight[k] * loss terms of its
        post-substep state (particles in original order via
        ``unsort_perm``); zero weights are skipped."""
        params = self.mpm_params if params is None else params
        if self.has_cloth:
            return self._env_step_cloth(carry, action, params, loss_weights,
                                        unsort_perm)
        mpm, bodies, rigid = carry
        if self.rigid_model is not None:
            # the bodies stay frozen over the substeps; their cotangents
            # from the MPM side are damped by ext_grad_scale
            bodies = grad_scale(bodies, self.ext_grad_scale)
        mpm_action = None
        if self.control_mode == "mpm" and self.action_dim > 0:
            mpm_action = action.reshape(self.mpm_cfg.n_controllers, 3).to(
                self.dtype)
        mpm, bodies, ext_f, overflow, terms = self._substeps(
            mpm, bodies, params, loss_weights, unsort_perm, mpm_action)
        bodies, rigid = self._rigid_step(bodies, rigid, action, ext_f)
        out = (overflow, ext_f)
        if loss_weights is not None:
            out = out + (terms,)
        return (mpm, bodies, rigid), out

    def _substeps(self, mpm, bodies, params, loss_weights=None,
                  unsort_perm=None, mpm_action=None):
        """The env step's MPM half: ``substeps`` substeps against the
        bodies, with the particle controllers' ``mpm_action``. Returns
        (mpm, bodies, ext_f, overflow, loss terms): ext_f is the
        window-averaged wrench, overflow whether the active window missed a
        particle."""
        cfg = self.mpm_cfg
        ext, ovf, terms = [], [], {}
        for k in range(cfg.substeps):
            mpm, extf, aux = mpm_mod.substep(cfg, params, self.prims, mpm,
                                             bodies, k, mpm_action)
            if self.rigid_vel_model is not None:
                bodies = RigidVelocityModel.forward_kinematics(bodies, cfg.dt)
            ext.append(extf)
            ovf.append(aux["window_overflow"])
            if loss_weights is not None and loss_weights[k] != 0:
                sample = FrameSample(x=_unsort_rows(mpm.x_nd, unsort_perm),
                                     bodies=bodies)
                for name, v in self.loss.terms(sample).items():
                    terms[name] = terms.get(name, 0.0) + loss_weights[k] * v
        ext_f = torch.stack(ext).sum(dim=0) / cfg.substeps
        return mpm, bodies, ext_f, torch.stack(ovf).any(), terms

    def _env_step_cloth(self, carry, action, params, loss_weights=None,
                        unsort_perm=None):
        """One coupled MPM + cloth env step (soft_cloth taichi_env.py:74-96;
        JAX env.py:510-583): the substeps against the window's forecast
        cloth, each followed by the pair search and the penetration tracing
        after the MPM move; one cloth step on the window-averaged vertex
        forces; the pairs re-resolved against the moved cloth. In "mpm"
        control the action drives the particle controllers; in "cloth"
        control it is the attachment targets of the cloth step and never
        reaches the particles. Returns ((mpm, cloth, pen), (overflow,
        vertex force[, loss terms]))."""
        mpm, cloth, pen = carry
        cfg, cparams = self.mpm_cfg, self.cloth_params
        mpm_action = cloth_action = None
        if self.control_mode == "mpm" and self.action_dim > 0:
            mpm_action = action.reshape(cfg.n_controllers, 3).to(self.dtype)
        elif self.control_mode == "cloth":
            cloth_action = action
        # the forecast cloth of the window, its cotangents damped by
        # ext_grad_scale
        cxf, cvf = GradScale.apply(self.ext_grad_scale, cloth.x, cloth.v)
        ext, ovf, terms = [], [], {}
        for k in range(cfg.substeps):
            x_prev = mpm.x
            mpm, extv, aux = mpm_mod.substep_cloth(
                cfg, params, cparams, mpm, cxf, cvf, pen, k, mpm_action)
            cid = cc.get_contact_pair(cparams, cxf, tuple(mpm.x),
                                      pen.penetration)
            pen = cc.trace_penetration_after_mpm(
                cparams, cxf, tuple(mpm.x), tuple(x_prev), pen, cid)
            ext.append(extv)
            ovf.append(aux["window_overflow"])
            if loss_weights is not None and loss_weights[k] != 0:
                sample = FrameSample(x=_unsort_rows(mpm.x_nd, unsort_perm),
                                     bodies=None, cloth_x=cxf, cloth_v=cvf)
                for name, v in self.loss.terms(sample).items():
                    terms[name] = terms.get(name, 0.0) + loss_weights[k] * v
        ext_vertex_f = torch.stack(ext).sum(dim=0) / cfg.substeps
        cloth = self.cloth_model.step(cloth, cloth_action, ext_vertex_f)
        # re-resolve the pairs against the moved cloth (taichi_env:88-90)
        cid = cc.get_contact_pair(cparams, cloth.x, tuple(mpm.x),
                                  pen.penetration)
        pen = cc.trace_penetration_after_cloth(cparams, cloth.x, cxf,
                                               tuple(mpm.x), pen, cid)
        out = (torch.stack(ovf).any(), ext_vertex_f)
        if loss_weights is not None:
            out = out + (terms,)
        return (mpm, cloth, pen), out

    def _sample(self, carry, perm=None):
        """What the loss sees of a carry, particles in original order."""
        mpm, second, _ = carry
        x = _unsort_rows(mpm.x_nd, perm)
        if self.has_cloth:
            return FrameSample(x=x, bodies=None, cloth_x=second.x,
                               cloth_v=second.v)
        return FrameSample(x=x, bodies=second)

    def _permute(self, carry, q):
        """The carry's per-particle state under the permutation q."""
        mpm, second, third = carry
        if self.has_cloth:
            third = cc.permute_pen(third, q)
        return (mpm_mod.permute_state(mpm, q), second, third)

    def _rigid_step(self, bodies, rigid, action, ext_f):
        """The env step's rigid half: the action and the wrench ext_f move
        the bodies. Returns (bodies, rigid)."""
        if self.rigid_vel_model is not None:
            bodies = self.rigid_vel_model.apply_action(bodies, action)
        elif self.rigid_model is not None:
            rigid_action = action if self.control_mode == "rigid" else None
            rigid = self.rigid_model.step(rigid, rigid_action, ext_f,
                                          prims=self.prims)
            bodies = self.rigid_model.body_states(rigid)
        return bodies, rigid

    def _rekey(self, carry, perm):
        """Re-sort a carry by its particles' current y-cells. ``perm`` maps
        the carry's positions to original particle indices. Returns (carry,
        perm, params): the re-sorted carry, its permutation and the
        per-particle parameters in its order (the cloth's side-state rides
        the permutation)."""
        q, _ = mpm_mod.sort_perm(self.mpm_cfg, carry[0].x)
        perm = perm[q]
        return (self._permute(carry, q), perm,
                mpm_mod.permute_params(self.mpm_params, perm))

    # ==================================================================
    # imperative facade (reference API; JAX env.py:334, 377-711, 1229)
    # ==================================================================
    def set_copy(self, is_copy: bool):
        self._is_copy = is_copy
        self.keep_history = not is_copy

    def reset(self):
        self._hold(self._initial_carry())
        self.cur = 0
        self.action_list = []
        self._history = [self._snapshot()]

    def initialize(self):
        self.reset()

    def _hold(self, carry):
        """Hold ``carry`` (original particle order) sorted by y-cell."""
        self._carry, self._perm, _ = self._rekey(
            carry, torch.arange(self.n_particles, device=self.device))

    def _held(self):
        """The held carry in the original particle order."""
        return self._permute(self._carry, _inverse(self._perm))

    def _snapshot(self):
        """(x (N, 3), bodies | None, cloth_x | None, cloth_v | None) of the
        held carry as numpy arrays, the particles in original order; the
        bodies a BodyState of numpy arrays."""
        mpm, second, _ = self._carry
        x = _unsort_rows(mpm.x_nd, self._perm).cpu().numpy()
        if self.has_cloth:
            return (x, None, second.x.cpu().numpy(), second.v.cpu().numpy())
        bodies = BodyState(**{k: getattr(second, k).cpu().numpy()
                              for k in ("pos", "quat", "v", "w")})
        return (x, bodies, None, None)

    @torch.no_grad()
    def step(self, action=None):
        """One env step of the held carry. ``action``: a numpy array or a
        tensor, zeros of max(action_dim, 1) when None. The carry is
        re-sorted first; the action is kept for ``backward``; a snapshot is
        recorded (the history keeps only the last under ``set_copy``)."""
        if action is None:
            action = np.zeros((max(self.action_dim, 1),))
        if torch.is_tensor(action):
            action = action.detach().to(device=self.device, dtype=self.dtype,
                                        copy=True)
        else:
            action = torch.as_tensor(np.asarray(action, np.float64),
                                     dtype=self.dtype, device=self.device)
        self.action_list.append(action)
        carry, self._perm, params = self._rekey(self._carry, self._perm)
        self._carry, (_, ext_f) = self._env_step_fn(carry, action, params)
        self.last_ext_f = ext_f
        self.cur += self.substeps
        if self.keep_history:
            self._history.append(self._snapshot())
        else:
            self._history = [self._snapshot()]

    def get_x(self, f=None):
        if f is None:
            f = self.cur
        return self.get_state_frame(f)[0]

    def get_state_frame(self, f):
        """(x, bodies, cloth_x, cloth_v) snapshot at frame f (env step
        boundaries only)."""
        return self._history[min(f // self.substeps, len(self._history) - 1)]

    def compute_loss(self, f=None):
        """The loss terms (floats, and their sum "loss") at the snapshot of
        frame f, by default the current frame (frame 0 for a copy)."""
        if self.loss is None:
            raise ValueError("this env has no loss (ENV.loss_type is empty)")
        if f is None:
            f = 0 if self._is_copy else self.cur
        x, bodies, cx, cv = self.get_state_frame(f)

        def t(a):
            return None if a is None else torch.as_tensor(
                a, dtype=self.dtype, device=self.device)
        if bodies is not None:
            bodies = BodyState(**{k: t(getattr(bodies, k))
                                  for k in ("pos", "quat", "v", "w")})
        with torch.no_grad():
            terms = {k: float(v) for k, v in self.loss.terms(FrameSample(
                x=t(x), bodies=bodies, cloth_x=t(cx), cloth_v=t(cv))).items()}
        terms["loss"] = sum(terms.values())
        return terms

    def get_observation(self, f=None):
        """The flat observation of the held carry as a numpy array:
        ``n_observed`` subsampled particles' x and v, then the cloth's or
        the bodies' state (``policy.observation``; soft_cloth
        taichi_env.get_observation :148-156)."""
        from softmac_tpu_torch.engine import policy as policy_mod
        with torch.no_grad():
            obs = policy_mod.observation(self, self._carry, self.n_observed,
                                         _inverse(self._perm))
        return obs.cpu().numpy()

    def get_state(self, f=None):
        """The packed particle state, the reference's checkpoint layout:
        (N, 24) ``[x v F C]`` (softmac mpm_simulator.py:481-492); cloth envs
        append contact_id and penetration for (N, 26) (soft_cloth
        mpm_simulator.py:604-615)."""
        mpm, _, pen = self._held()
        packed = mpm_state_to_packed(mpm).cpu().numpy()
        if self.has_cloth:
            packed = np.hstack([
                packed,
                pen.contact_id.cpu().numpy().astype(np.float64)[:, None],
                pen.penetration.cpu().numpy().astype(np.float64)[:, None]])
        return packed

    def set_state(self, packed):
        """Load a packed (N, 24) or (N, 26) particle state into the held
        carry (the reference's setframe restores [x v F C], soft_cloth
        mpm_simulator.py:617-618; on a cloth env 26 columns also restore
        contact_id and penetration, 24 keep them). The bodies or the cloth
        stay as they are; the history restarts."""
        packed = np.asarray(packed)
        mpm = mpm_state_from_packed(self.mpm_cfg, torch.as_tensor(
            packed[:, :24], device=self.device))
        _, second, third = self._held()
        if self.has_cloth and packed.shape[1] >= 26:
            third = cc.PenetrationState(
                contact_id=torch.as_tensor(packed[:, 24].astype(np.int32),
                                           device=self.device),
                penetration=torch.as_tensor(packed[:, 25].astype(np.int8),
                                            device=self.device))
        self._hold((mpm, second, third))
        self._history = [self._snapshot()]

    def check_penetration(self) -> int:
        """Number of particles flagged as penetrating the cloth (soft_cloth
        mpm_simulator.py:555-561)."""
        if not self.has_cloth:
            return 0
        return int(self._carry[2].penetration.to(torch.int32).sum())

    def backward(self, loss_start_frame=None, loss_stride=20):
        """Gradient of the sampled-frame loss with respect to the actions
        recorded by ``step``: ``rollout_and_grad`` of them from the initial
        state, as a numpy array (T, action_dim)."""
        out = self.rollout_and_grad(torch.stack(self.action_list),
                                    loss_start_frame=loss_start_frame,
                                    loss_stride=loss_stride)
        return out["action_grad"].cpu().numpy()

    def _get_renderer(self):
        """The scene's ``PointRenderer`` (``RENDERER`` of the config) on the
        env's device, made at first use."""
        from softmac_tpu_torch.engine.renderer import PointRenderer
        if self._renderer is None:
            self._renderer = PointRenderer(self.render_cfg, self)
        return self._renderer

    def set_render_target(self, points):
        """Show target geometry in renders (reference renderer set_target)."""
        self._get_renderer().set_target(points)

    def render(self, f=None):
        """The snapshot of frame f (by default the current one) as a uint8
        (H, W, 3) image, drawn on the env's device."""
        if f is None:
            f = self.cur
        x, bodies, cx, _ = self.get_state_frame(f)
        cloth = None
        if cx is not None:
            cloth = (cx, self.cloth_model.faces)
        return self._get_renderer().render(x, self.particle_colors, bodies,
                                      cloth=cloth)

    @torch.no_grad()
    def adjust_action_with_ext_force(self, actions):
        """Compensate an action trajectory (T, action_dim) for gravity and
        the measured contact wrench, so that the floating bodies hold their
        intended motion (reference ``softmac/utils.py:76-119``; the JAX
        ``SoftMacEnv.adjust_action_with_ext_force``). A forward rollout from
        the initial carry: each env step's window-averaged wrench ext_f and
        each gravity-affected body's weight are subtracted from its action,
        and the rigid step takes the adjusted action. An active-window
        overflow warns, as in the rollouts. Returns the adjusted actions as
        a numpy array. Only a free joint is compensated (a floating body,
        or a tree's floating joint for its whole subtree's weight): a
        revolute, prismatic or fixed body's actions stay as they are (its
        ``compensation_mass`` is None). The compensation sees the wrench of
        each welded primitive folded onto its carrier, in a copy of ext_f:
        the rigid step folds the welds of the ext_f it takes itself."""
        if self.control_mode != "rigid" or self.rigid_model is None:
            raise ValueError("adjust_action_with_ext_force needs "
                             "force-controlled rigid bodies (control_mode "
                             "'rigid')")
        model = self.rigid_model
        cfg = self.mpm_cfg
        g = torch.as_tensor(model.gravity, dtype=self.dtype,
                            device=self.device)
        acts = torch.as_tensor(np.asarray(actions), dtype=self.dtype,
                               device=self.device)
        mpm, bodies, rigid = self._initial_carry()
        # the y-sorted order the kernels read best; the wrench is a sum
        q, _ = mpm_mod.sort_perm(cfg, mpm.x)
        mpm = mpm_mod.permute_state(mpm, q)
        params = mpm_mod.permute_params(self.mpm_params, q)
        overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        adjusted = []
        for action in acts:
            mpm, bodies, ext_f, ovf, _ = self._substeps(mpm, bodies, params)
            overflow = overflow | ovf
            ext_c = ext_f.clone()
            bs = None
            for i, b in enumerate(model.bodies):
                if b.jtype != "weld" or not b.gravity_on:
                    continue
                if bs is None:
                    bs = model.body_states(rigid)
                p = b.weld_parent
                f = ext_c[i, :3].clone()
                r = bs.pos[i] - bs.pos[p]
                ext_c[p, :3] += f
                ext_c[p, 3:] += ext_c[i, 3:] + torch.cross(r, f, dim=-1)
                ext_c[i] = 0.0
            adj = action.clone()
            for i, b in enumerate(model.bodies):
                mass = model.compensation_mass(i)
                if b.gravity_on and mass is not None:
                    o = b.q_offset
                    adj[o:o + 3] -= ext_c[i, 3:]
                    adj[o + 3:o + 6] -= ext_c[i, :3] + mass * g
            bodies, rigid = self._rigid_step(bodies, rigid, adj, ext_f)
            adjusted.append(adj)
        self._check_overflow({"window_overflow": overflow})
        return torch.stack(adjusted).cpu().numpy()

    # ==================================================================
    # functional rollout
    # ==================================================================
    def _sample_mask(self, n_steps, loss_start_frame, loss_stride):
        """Loss-frame sampling replicating ``range(start, T+1, stride)``
        over substep-indexed frames (reference ``demo_pour.py:172-173``).

        Fast path: every sampled frame >= 1 lands on a loss-block boundary
        -> per-block 0/1 mask. General path (any start/stride): block = 1
        and sub_weights (n_steps, substeps) select the sampled mid-window
        substeps."""
        start = 0 if loss_start_frame is None else int(loss_start_frame)
        total = n_steps * self.substeps
        wanted = set(range(start, total + 1, int(loss_stride)))
        include_f0 = 0 in wanted
        block = max(int(loss_stride) // self.substeps, 1)
        if n_steps % block == 0:
            n_blocks = n_steps // block
            frames = np.arange(1, n_blocks + 1) * block * self.substeps
            mask = np.isin(frames, sorted(wanted))
            if set(frames[mask].tolist()) == (wanted - {0}):
                return (block, n_blocks, mask.astype(np.float64),
                        include_f0, None)
        w = np.zeros((n_steps, self.substeps))
        bmask = np.zeros((n_steps,))
        for f in sorted(wanted - {0}):
            t, k = divmod(f - 1, self.substeps)
            if k == self.substeps - 1:
                bmask[t] = 1.0
            else:
                w[t, k] = 1.0
        return 1, n_steps, bmask, include_f0, w

    def _scalar(self, v):
        return torch.as_tensor(v, dtype=self.dtype, device=self.device)

    @torch.no_grad()
    def rollout(self, actions, loss_start_frame=None, loss_stride=20,
                carry0=None):
        """Forward rollout of ``actions`` (T, action_dim). Returns
        {"loss", "terms", "carry"} as the JAX ``SoftMacEnv.rollout`` does;
        the exit carry is in the original particle order. Nothing is saved
        for autograd. ``carry0``: the initial carry (original particle
        order), by default the scene's initial state."""
        actions = torch.as_tensor(actions, dtype=self.dtype, device=self.device)
        loss, terms, carry = self._run(actions, loss_start_frame, loss_stride,
                                       carry0=carry0)
        self._check_overflow(terms)
        return {"loss": loss, "terms": terms, "carry": carry}

    def rollout_and_grad(self, actions, loss_start_frame=None, loss_stride=20,
                         bptt_window=None, grad_clip=None, remat="step",
                         carry0=None):
        """Rollout and the gradient of its loss with respect to the actions:
        {"loss", "terms", "carry", "action_grad"}, as the JAX
        ``SoftMacEnv.rollout_and_grad``. ``remat``: "step" checkpoints each
        env step (memory O(1) in T; the backward replays each step's
        forward), "none" keeps every step's tensors, "window:K" checkpoints
        every K env steps. ``bptt_window``: the carry is detached every
        ~bptt_window env steps. ``grad_clip``: the carry's cotangent is
        clipped to that global L2 norm at every loss block start.
        ``carry0`` as for ``rollout``."""
        actions = torch.as_tensor(actions, dtype=self.dtype, device=self.device)
        actions = actions.detach().requires_grad_()
        with torch.enable_grad():
            loss, terms, carry = self._run(
                actions, loss_start_frame, loss_stride, bptt_window,
                grad_clip, remat, carry0)
            if loss.requires_grad:
                grad, = torch.autograd.grad(loss, actions, allow_unused=True)
            else:
                grad = None
        if grad is None:
            grad = torch.zeros_like(actions)
        terms = {k: v.detach() if torch.is_tensor(v) else v
                 for k, v in terms.items()}
        carry = map_carry(torch.Tensor.detach, carry)
        self._check_overflow(terms)
        return {"loss": loss.detach(), "terms": terms, "carry": carry,
                "action_grad": grad.detach()}

    # ------------------------------------------------------------------
    # batched multi-trajectory API (JAX env.py:1151-1205: a vmap there)
    # ------------------------------------------------------------------
    def _batched_carry(self, actions, carry0):
        """``carry0``, or the initial carry broadcast B ways."""
        if carry0 is None:
            B = actions.shape[0]
            carry0 = map_carry(lambda t: t.expand((B,) + t.shape),
                               self._initial_carry())
        return carry0

    def jittered_carry(self, n_replicas, sigma=3e-4, seed=0):
        """Batched initial carry whose particle positions are independently
        jittered per replica (replica 0 stays exact): the noise
        ``RandomState(seed).randn(B, 3, N) * sigma``, added to x in the
        env's dtype, the same draw as JAX's ``jittered_carry``. The
        robustification harness of demo_door ``--replicas``: the mean loss
        over replicas is not an artifact of one trajectory's reduction
        order. Compose with ``batched_rollout(_and_grad)`` by tiling the
        actions n_replicas ways."""
        c = self._initial_carry()
        B = int(n_replicas)
        carry = map_carry(lambda t: t.expand((B,) + t.shape), c)
        noise = np.random.RandomState(seed).randn(B, *c[0].x.shape) \
            * float(sigma)
        noise[0] = 0.0
        mpm = carry[0]
        mpm = MPMState(x=mpm.x + torch.as_tensor(noise, dtype=self.dtype,
                                                 device=self.device),
                       v=mpm.v, C=mpm.C, F=mpm.F)
        return (mpm,) + tuple(carry[1:])

    def _batched(self, run, actions, carry0, **kw):
        """``run`` (``rollout`` or ``rollout_and_grad``) of each trajectory
        from its replica of the batched carry, one after another; the
        results stacked along a leading B."""
        actions = torch.as_tensor(actions, dtype=self.dtype, device=self.device)
        carry0 = self._batched_carry(actions, carry0)
        outs = [run(actions[b], carry0=map_carry(lambda t, b=b: t[b], carry0),
                    **kw) for b in range(actions.shape[0])]
        res = {"loss": torch.stack([o["loss"] for o in outs]),
               "terms": {k: torch.stack([torch.as_tensor(o["terms"][k])
                                         for o in outs])
                         for k in outs[0]["terms"]},
               "carry": _carry_from([torch.stack(ts) for ts in zip(
                   *(_carry_tensors(o["carry"]) for o in outs))],
                   outs[0]["carry"])}
        if "action_grad" in outs[0]:
            res["action_grad"] = torch.stack([o["action_grad"] for o in outs])
        return res

    def batched_rollout(self, actions, carry0=None, loss_start_frame=None,
                        loss_stride=20, bptt_window=None, grad_clip=None,
                        remat="step"):
        """Roll out B independent trajectories: actions (B, T, action_dim);
        ``carry0`` an optional batched carry (leading B on every tensor),
        by default the initial state broadcast B ways. Returns {"loss" (B,),
        "terms" {k: (B,)}, "carry" batched}, as JAX's ``batched_rollout``.
        The trajectories run one after another through ``rollout``: the
        same function as JAX's vmap. ``bptt_window``, ``grad_clip`` and
        ``remat`` shape only a backward; a forward rollout ignores them,
        as JAX's does."""
        del bptt_window, grad_clip, remat
        return self._batched(self.rollout, actions, carry0,
                             loss_start_frame=loss_start_frame,
                             loss_stride=loss_stride)

    def batched_rollout_and_grad(self, actions, carry0=None,
                                 loss_start_frame=None, loss_stride=20,
                                 bptt_window=None, grad_clip=None,
                                 remat="step"):
        """Like ``batched_rollout``, plus each trajectory's "action_grad"
        (B, T, action_dim), through ``rollout_and_grad``."""
        return self._batched(self.rollout_and_grad, actions, carry0,
                             loss_start_frame=loss_start_frame,
                             loss_stride=loss_stride, bptt_window=bptt_window,
                             grad_clip=grad_clip, remat=remat)

    def _steps(self, carry, acts, params_s, weights, perm):
        """Env steps ``acts`` from ``carry`` (one checkpointed unit)."""
        overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        terms = {}
        for a, w in zip(acts, weights):
            carry, out = self._env_step_fn(carry, a, params_s, loss_weights=w,
                                           unsort_perm=perm)
            overflow = overflow | out[0]
            if w is not None:
                for k, v in out[2].items():
                    terms[k] = terms.get(k, 0.0) + v
        return carry, overflow, terms

    def _run(self, actions, loss_start_frame, loss_stride, bptt_window=None,
             grad_clip=None, remat=None, carry0=None):
        """The rollout loop of both entry points, from ``carry0`` (default
        the scene's initial carry). ``remat`` None runs each loss block's
        steps in one piece without checkpoints (the forward rollout under
        no_grad). Returns (loss, terms, exit carry)."""
        n_steps = actions.shape[0]
        block, n_blocks, mask_np, include_f0, sub_w = self._sample_mask(
            n_steps, loss_start_frame, loss_stride)
        use_general = sub_w is not None and self.loss is not None
        group = _remat_group(remat, block)
        run = self._steps if group is None else functools.partial(
            checkpoint, self._steps, use_reentrant=False)
        group = group or block
        seg_blocks = n_blocks
        if bptt_window is not None:
            seg_blocks = max(int(bptt_window) // block, 1)
            while n_blocks % seg_blocks != 0:
                seg_blocks -= 1

        if carry0 is None:
            carry0 = self._initial_carry()
        carry = carry0
        perm = torch.arange(self.n_particles, device=self.device)
        overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        per_block, general = [], []
        for b in range(n_blocks):
            if grad_clip is not None:
                carry = _clip_carry(carry, float(grad_clip))
            # _resort: re-key the sorted carry at every block boundary
            carry, perm, params_s = self._rekey(carry, perm)
            block_terms = {}
            for t0 in range(0, block, group):
                s0 = b * block + t0
                acts = actions[s0:s0 + group]
                weights = (list(sub_w[s0:s0 + group]) if use_general
                           else [None] * group)
                carry, ovf, terms = run(carry, acts, params_s, weights, perm)
                overflow = overflow | ovf
                for k, v in terms.items():
                    block_terms[k] = block_terms.get(k, 0.0) + v
            general.append(block_terms)
            if self.loss is not None and (mask_np[b] or b == n_blocks - 1):
                per_block.append(self.loss.terms(self._sample(carry, perm)))
            else:
                per_block.append(None)
            if (b + 1) % seg_blocks == 0 and b + 1 < n_blocks:
                # truncated BPTT: gradients stop at the segment boundary
                carry = map_carry(torch.Tensor.detach, carry)

        terms_acc = {"window_overflow": overflow}
        if self.has_cloth:
            # the reference's check_penetration (soft_cloth
            # mpm_simulator.py:556-561) at the last block
            terms_acc["n_penetration"] = (carry[2].penetration != 0).sum(
                dtype=torch.int32)
        loss_total = self._scalar(0.0)
        if self.loss is not None:
            mask = self._scalar(mask_np)
            zero = self._scalar(0.0)
            for k in self.loss.term_names:
                v = torch.stack([zero if pb is None else self._scalar(pb[k])
                                 for pb in per_block])
                terms_acc[k] = torch.sum(v * mask)
                if use_general:
                    terms_acc[k] = torch.sum(torch.stack(
                        [self._scalar(g.get(k, 0.0)) for g in general])) \
                        + terms_acc[k]
                loss_total = loss_total + terms_acc[k]
                terms_acc[f"final_{k}"] = v[-1]
            if include_f0:
                f0 = self.loss.terms(self._sample(carry0))
                for k, v in f0.items():
                    terms_acc[k] = terms_acc[k] + v
                    loss_total = loss_total + v

        # _sort_out: back to the original particle order
        return loss_total, terms_acc, self._permute(carry, _inverse(perm))

    def _check_overflow(self, terms):
        """Warn (once per env) when the active window missed a particle:
        its mass vanishes from the transfers."""
        ovf = terms.get("window_overflow")
        if ovf is not None and not self._overflow_warned and bool(ovf):
            warnings.warn(
                "active-window overflow: some particle's B-spline stencil "
                "fell outside TPU.active_window this rollout — its mass is "
                "dropped from the grid transfers. Enlarge the window or "
                "expect corrupted physics. (Reported once per env.)",
                RuntimeWarning, stacklevel=3)
            self._overflow_warned = True


def _inverse(perm):
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return inv


def _unsort_rows(x_nd, perm):
    """Rows of a sorted-order (N, k) tensor back in original order (a
    gather, so that gradients flow back to the sorted rows)."""
    if perm is None:
        return x_nd
    return x_nd[_inverse(perm)]


TaichiEnv = SoftMacEnv
