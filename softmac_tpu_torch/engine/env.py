"""Scene building, the forward rollout and its gradient.

Counterpart of ``softmac_tpu/engine/env.py`` for the rigid-velocity scene
family (pour_vel): particle contact against SDF primitives whose (w, v) the
actions set. ``rollout`` (under ``torch.no_grad()``) and
``rollout_and_grad`` (autograd, then ``torch.autograd.grad`` of the loss
with respect to the actions) run one loop, eagerly on ``device`` (CUDA by
default):

    sort particles by y-cell
    for each loss block:   clip the carry's cotangent (``grad_clip``),
                           re-sort (``_resort``)
        for each env step: substeps (P2G / grid / G2P kernels) + pose update,
                           checkpointed per ``remat``
        loss terms at the block boundary, on the unsorted particle order
        at a ``bptt_window`` segment end: detach the carry
    unsort the exit carry

with the same loss-frame sampling as the JAX rollout (``_sample_mask``).
The imperative facade, batching and the other scene families come with
later slices of the port.
"""
from __future__ import annotations

import functools
import warnings
from pathlib import Path

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from softmac_tpu_torch.engine import mpm as mpm_mod
from softmac_tpu_torch.engine.losses import LOSS_REGISTRY, FrameSample
from softmac_tpu_torch.engine.materials import lame_parameters
from softmac_tpu_torch.engine.meshio import load_obj, load_urdf
from softmac_tpu_torch.engine.rigid import RigidState, RigidVelocityModel
from softmac_tpu_torch.engine.sdf import preprocess_sdf, sdf_params_from_bake
from softmac_tpu_torch.engine.shapes import Shapes
from softmac_tpu_torch.engine.types import (
    BodyState, MPMConfig, MPMParams, MPMState, mpm_state_from_packed,
    mpm_state_zero,
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
    mpm, bodies, rigid = carry
    return (mpm.x, mpm.v, mpm.C, mpm.F, bodies.pos, bodies.quat, bodies.v,
            bodies.w, rigid.q, rigid.qd)


def _carry_from(t):
    return (MPMState(x=t[0], v=t[1], C=t[2], F=t[3]),
            BodyState(pos=t[4], quat=t[5], v=t[6], w=t[7]),
            RigidState(q=t[8], qd=t[9]))


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
        self.search_dirs = [".", str(REPO_ROOT)]
        if cfg.get("CLOTH") and cfg.CLOTH.get("sceneConfig"):
            raise NotImplementedError("cloth scenes are not ported yet")
        if cfg.control_mode == "mpm" and cfg.SIMULATOR.n_controllers > 0:
            raise NotImplementedError("MPM particle control is not ported yet")

        # ---------------- particles ----------------------------------------
        # init_particles overrides SHAPES with an explicit (N, 3) position
        # array (or (N, >=6) packed state whose first 3 columns are x)
        if init_particles is not None:
            self.init_particles = np.asarray(init_particles, np.float64)[:, :3]
        else:
            self.init_particles = Shapes(cfg.SHAPES, self.search_dirs).get()
        self.n_particles = len(self.init_particles)

        # ---------------- primitives (URDF -> SDF tables) -------------------
        prims, prim_friction = [], []
        prim_cfgs = cfg.PRIMITIVES if isinstance(cfg.PRIMITIVES, (list, tuple)) else []
        for pc in prim_cfgs:
            model = load_urdf(str(self._resolve(pc.urdf_path)))
            for link, _joint in model.moving_links():
                verts, faces = load_obj(link.mesh_path)
                bake = preprocess_sdf(verts, faces, Path(link.mesh_path).parent)
                prims.append(sdf_params_from_bake(bake, self.dtype, self.device))
                prim_friction.append(pc.friction)
        self.prims = tuple(prims)
        self.n_primitives = len(self.prims)
        if self.n_primitives > 0 and not cfg.rigid_velocity_control:
            raise NotImplementedError(
                "force-controlled rigid bodies (RigidModel) are not ported "
                "yet; the port runs velocity-controlled scenes")

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
            primitives_contact=(True,) * self.n_primitives,
            mpm_scale=mpm_scale,
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

        # ---------------- rigid bodies ----------------------------------------
        self.rigid_vel_model = None
        if self.n_primitives > 0:
            self.rigid_vel_model = RigidVelocityModel(
                self.n_primitives, cfg.RIGID, self.dtype, self.device)

        # ---------------- loss ----------------------------------------------
        self.loss = None
        if cfg.ENV.loss_type != "":
            if cfg.ENV.loss_type not in LOSS_REGISTRY:
                raise NotImplementedError(
                    f"loss {cfg.ENV.loss_type} is not ported yet")
            self.loss = LOSS_REGISTRY[cfg.ENV.loss_type](cfg.ENV.loss, self)

        self.action_dim = 6 * self.n_primitives
        self._overflow_warned = False

    def _resolve(self, path) -> Path:
        p = Path(path)
        if p.exists():
            return p
        for d in self.search_dirs:
            cand = Path(d) / p
            if cand.exists():
                return cand
        raise FileNotFoundError(f"{path} not found in {self.search_dirs}")

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
        empty = torch.zeros((0,), dtype=self.dtype, device=self.device)
        if self.rigid_vel_model is not None:
            bodies0 = self.rigid_vel_model.init_bodies()
        else:
            bodies0 = BodyState.identity(0, self.dtype, self.device)
        return (mpm0, bodies0, RigidState(q=empty, qd=empty.clone()))

    def _env_step_fn(self, carry, action, params=None, loss_weights=None,
                  unsort_perm=None):
        """(carry, action) -> (carry, (overflow, ext_f[, loss_terms])).

        ``params`` are the per-particle parameters in the carry's particle
        order. ``loss_weights`` (substeps,) host floats engage the general
        loss-stride path: substep k adds weight[k] * loss terms of its
        post-substep state (particles in original order via
        ``unsort_perm``); zero weights are skipped."""
        params = self.mpm_params if params is None else params
        mpm, bodies, rigid = carry
        cfg = self.mpm_cfg
        ext, ovf, terms = [], [], {}
        for k in range(cfg.substeps):
            mpm, extf, aux = mpm_mod.substep(cfg, params, self.prims, mpm,
                                             bodies, k)
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
        overflow = torch.stack(ovf).any()
        if self.rigid_vel_model is not None:
            bodies = self.rigid_vel_model.apply_action(bodies, action)
        out = (overflow, ext_f)
        if loss_weights is not None:
            out = out + (terms,)
        return (mpm, bodies, rigid), out

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
    def rollout(self, actions, loss_start_frame=None, loss_stride=20):
        """Forward rollout of ``actions`` (T, action_dim). Returns
        {"loss", "terms", "carry"} as the JAX ``SoftMacEnv.rollout`` does;
        the exit carry is in the original particle order. Nothing is saved
        for autograd."""
        actions = torch.as_tensor(actions, dtype=self.dtype, device=self.device)
        loss, terms, carry = self._run(actions, loss_start_frame, loss_stride)
        self._check_overflow(terms)
        return {"loss": loss, "terms": terms, "carry": carry}

    def rollout_and_grad(self, actions, loss_start_frame=None, loss_stride=20,
                         bptt_window=None, grad_clip=None, remat="step"):
        """Rollout and the gradient of its loss with respect to the actions:
        {"loss", "terms", "carry", "action_grad"}, as the JAX
        ``SoftMacEnv.rollout_and_grad``. ``remat``: "step" checkpoints each
        env step (memory O(1) in T; the backward replays each step's
        forward), "none" keeps every step's tensors, "window:K" checkpoints
        every K env steps. ``bptt_window``: the carry is detached every
        ~bptt_window env steps. ``grad_clip``: the carry's cotangent is
        clipped to that global L2 norm at every loss block start."""
        actions = torch.as_tensor(actions, dtype=self.dtype, device=self.device)
        actions = actions.detach().requires_grad_()
        with torch.enable_grad():
            loss, terms, carry = self._run(
                actions, loss_start_frame, loss_stride, bptt_window,
                grad_clip, remat)
            if loss.requires_grad:
                grad, = torch.autograd.grad(loss, actions, allow_unused=True)
            else:
                grad = None
        if grad is None:
            grad = torch.zeros_like(actions)
        terms = {k: v.detach() if torch.is_tensor(v) else v
                 for k, v in terms.items()}
        carry = _carry_from([t.detach() for t in _carry_tensors(carry)])
        self._check_overflow(terms)
        return {"loss": loss.detach(), "terms": terms, "carry": carry,
                "action_grad": grad.detach()}

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
             grad_clip=None, remat=None):
        """The rollout loop of both entry points. ``remat`` None runs each
        loss block's steps in one piece without checkpoints (the forward
        rollout under no_grad). Returns (loss, terms, exit carry)."""
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
        cfg = self.mpm_cfg

        carry0 = self._initial_carry()
        carry = carry0
        params_s = self.mpm_params
        perm = torch.arange(self.n_particles, device=self.device)
        overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        per_block, general = [], []
        for b in range(n_blocks):
            if grad_clip is not None:
                carry = _carry_from(ClipCotangent.apply(
                    float(grad_clip), *_carry_tensors(carry)))
            # _resort: re-key the sorted carry at every block boundary
            mpm, bodies, rigid = carry
            q, _ = mpm_mod.sort_perm(cfg, mpm.x)
            carry = (mpm_mod.permute_state(mpm, q), bodies, rigid)
            params_s = mpm_mod.permute_params(params_s, q)
            perm = perm[q]
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
            mpm, bodies, _ = carry
            if self.loss is not None and (mask_np[b] or b == n_blocks - 1):
                sample = FrameSample(x=_unsort_rows(mpm.x_nd, perm),
                                     bodies=bodies)
                per_block.append(self.loss.terms(sample))
            else:
                per_block.append(None)
            if (b + 1) % seg_blocks == 0 and b + 1 < n_blocks:
                # truncated BPTT: gradients stop at the segment boundary
                carry = _carry_from([t.detach()
                                     for t in _carry_tensors(carry)])

        terms_acc = {"window_overflow": overflow}
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
                mpm0, bodies0, _ = carry0
                f0 = self.loss.terms(FrameSample(x=mpm0.x_nd, bodies=bodies0))
                for k, v in f0.items():
                    terms_acc[k] = terms_acc[k] + v
                    loss_total = loss_total + v

        # _sort_out: back to the original particle order
        mpm, bodies, rigid = carry
        carry = (mpm_mod.permute_state(mpm, _inverse(perm)), bodies, rigid)
        return loss_total, terms_acc, carry

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
