"""Scene building and the forward rollout.

Counterpart of ``softmac_tpu/engine/env.py`` for the rigid-velocity scene
family (pour_vel): particle contact against SDF primitives whose (w, v) the
actions set. The rollout runs eagerly on ``device`` (CUDA by default) under
``torch.no_grad()``:

    sort particles by y-cell
    for each loss block:   re-sort (``_resort``)
        for each env step: substeps (P2G / grid / G2P kernels) + pose update
        loss terms at the block boundary, on the unsorted particle order
    unsort the exit carry

with the same loss-frame sampling as the JAX rollout (``_sample_mask``).
``rollout_and_grad``, the imperative facade, batching and the other scene
families come with later slices of the port.
"""
from __future__ import annotations

import warnings
from pathlib import Path

import numpy as np
import torch

from softmac_tpu_torch.engine import mpm as mpm_mod
from softmac_tpu_torch.engine.losses import LOSS_REGISTRY, FrameSample
from softmac_tpu_torch.engine.materials import lame_parameters
from softmac_tpu_torch.engine.meshio import load_obj, load_urdf
from softmac_tpu_torch.engine.rigid import RigidState, RigidVelocityModel
from softmac_tpu_torch.engine.sdf import preprocess_sdf, sdf_params_from_bake
from softmac_tpu_torch.engine.shapes import Shapes
from softmac_tpu_torch.engine.types import (
    BodyState, MPMConfig, MPMParams, mpm_state_from_packed, mpm_state_zero,
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
        the exit carry is in the original particle order."""
        actions = torch.as_tensor(actions, dtype=self.dtype, device=self.device)
        n_steps = actions.shape[0]
        block, n_blocks, mask_np, include_f0, sub_w = self._sample_mask(
            n_steps, loss_start_frame, loss_stride)
        use_general = sub_w is not None and self.loss is not None
        cfg = self.mpm_cfg

        carry0 = self._initial_carry()
        mpm, bodies, rigid = carry0
        params_s = self.mpm_params
        perm = torch.arange(self.n_particles, device=self.device)
        overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        per_block, general = [], []
        for b in range(n_blocks):
            # _resort: re-key the sorted carry at every block boundary
            q, _ = mpm_mod.sort_perm(cfg, mpm.x)
            mpm = mpm_mod.permute_state(mpm, q)
            params_s = mpm_mod.permute_params(params_s, q)
            perm = perm[q]
            block_terms = {}
            for t in range(block):
                s = b * block + t
                (mpm, bodies, rigid), out = self._env_step_fn(
                    (mpm, bodies, rigid), actions[s], params_s,
                    loss_weights=sub_w[s] if use_general else None,
                    unsort_perm=perm)
                overflow = overflow | out[0]
                if use_general:
                    for k, v in out[2].items():
                        block_terms[k] = block_terms.get(k, 0.0) + v
            general.append(block_terms)
            if self.loss is not None and (mask_np[b] or b == n_blocks - 1):
                sample = FrameSample(x=_unsort_rows(mpm.x_nd, perm),
                                     bodies=bodies)
                per_block.append(self.loss.terms(sample))
            else:
                per_block.append(None)

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
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(perm.shape[0], device=perm.device)
        carry = (mpm_mod.permute_state(mpm, inv), bodies, rigid)
        self._check_overflow(terms_acc)
        return {"loss": loss_total, "terms": terms_acc, "carry": carry}

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


def _unsort_rows(x_nd, perm):
    """Rows of a sorted-order (N, k) tensor back in original order."""
    if perm is None:
        return x_nd
    out = torch.empty_like(x_nd)
    out[perm] = x_nd
    return out
