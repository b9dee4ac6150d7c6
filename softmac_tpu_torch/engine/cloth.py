"""Projective-dynamics cloth (``softmac_tpu/engine/cloth.py``; it stands in
for the reference's C++ DiffCloth, ``soft_cloth/engine/cloth_simulator.py``).

- Constraints: a stretch spring on each unique mesh edge, a bending spring
  across each interior edge (its two opposite vertices), and stiff
  attachment springs at the scene's ``customAttachmentVertexIdx``. A vertex
  listed twice there (the taco's 193) gets two springs: its diagonal of A
  and its right-hand side both take the stiffness twice, as in JAX.
- The global matrix A = M/dt^2 + L + W is constant. A, its dense inverse and
  the edge incidence operators are built once on the host in float64 and
  cast to the env's dtype, so each local/global iteration is three dense
  products (``torch.matmul``; TF32 stays off, as ``SoftMacEnv`` sets it).
- With ``convergence_tol`` (the scene's ``forwardConvergenceThresh``) the
  iterates freeze once the fixed-point residual drops below it. The stop is
  a mask on the device: no host round trip a iteration, and the gradient is
  that of the masked loop, as the JAX package's ``lax.scan``.
- Scene parameters come from the reference's string-keyed sceneConfig
  (``parse_scene_config``); ``transform_mesh`` places the mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from softmac_tpu_torch.engine.types import _Replace


@dataclasses.dataclass
class ClothState(_Replace):
    x: torch.Tensor  # (V, 3)
    v: torch.Tensor  # (V, 3)


def build_springs(verts: np.ndarray, faces: np.ndarray):
    """Unique-edge stretch springs and cross-edge bending springs, each an
    (E, 2) int32 array sorted by (i, j)."""
    edges = {}
    for f in faces:
        for a, b in ((f[0], f[1]), (f[1], f[2]), (f[2], f[0])):
            key = (min(a, b), max(a, b))
            edges.setdefault(key, []).append(
                [v for v in f if v != a and v != b][0])
    stretch = np.array(sorted(edges.keys()), np.int32)
    bend = [(min(opp), max(opp)) for opp in edges.values() if len(opp) == 2]
    bend = np.array(sorted(set(bend)), np.int32).reshape(-1, 2)
    return stretch, bend


class ClothModel:
    """Projective-dynamics cloth with a precomputed dense global solve."""

    def __init__(self, verts: np.ndarray, faces: np.ndarray, *,
                 k_stretch: float, k_bend: float, density: float, dt: float,
                 attachment_idx: Sequence[int], gravity: float = -9.8,
                 n_iterations: int = 20, attachment_stiffness: float = 1e5,
                 velocity_damping: float = 0.02, convergence_tol=None,
                 dtype=torch.float32, device="cpu"):
        self.dtype, self.device = dtype, torch.device(device)
        self.dt = float(dt)
        self.n_iterations = int(n_iterations)
        self.convergence_tol = (None if convergence_tol is None
                                else float(convergence_tol))
        # per-step damping: DiffCloth's implicit Euler is dissipative, an
        # undamped PD cloth keeps flapping after the hit
        self.velocity_damping = float(velocity_damping)
        verts = np.asarray(verts, np.float64)
        self.n_vertices = V = verts.shape[0]
        self.faces = np.asarray(faces, np.int32)
        self.rest_verts = verts
        self.attachment_idx = np.asarray(attachment_idx, np.int32)
        self.gravity = np.array([0.0, gravity, 0.0])
        self.attachment_stiffness = attachment_stiffness

        stretch, bend = build_springs(verts, self.faces)
        springs = [(stretch, k_stretch)]
        if len(bend) > 0:
            springs.append((bend, k_bend))

        # lumped vertex masses: density * adjacent triangle area / 3
        tri = verts[self.faces]
        area = 0.5 * np.linalg.norm(
            np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
        mass = np.zeros(V)
        for k in range(3):
            np.add.at(mass, self.faces[:, k], density * area / 3.0)
        self.mass = np.maximum(mass, 1e-12)

        A = np.diag(self.mass / dt ** 2)
        for edges, k in springs:
            for (i, j) in edges:
                A[i, i] += k
                A[j, j] += k
                A[i, j] -= k
                A[j, i] -= k
        for i in self.attachment_idx:
            A[i, i] += attachment_stiffness

        def dev(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype,
                                   device=self.device)
        self._Ainv = dev(np.linalg.inv(A))
        self._mass = dev(self.mass)[:, None]
        self._gravity = dev(self.gravity)
        # dense incidence operators: d = D y (edge vectors), rhs += J p
        self._edge_ops = []
        for e, k in springs:
            E = len(e)
            D = np.zeros((E, V))
            D[np.arange(E), e[:, 0]] = 1.0
            D[np.arange(E), e[:, 1]] = -1.0
            rest = np.linalg.norm(verts[e[:, 0]] - verts[e[:, 1]], axis=1)
            self._edge_ops.append((dev(D), dev(k * D.T), dev(rest)[:, None]))
        self._att = torch.as_tensor(self.attachment_idx, dtype=torch.int64,
                                    device=self.device)
        self._att_rest = dev(verts[self.attachment_idx])

    def init_state(self) -> ClothState:
        return ClothState(x=torch.as_tensor(self.rest_verts, dtype=self.dtype,
                                            device=self.device),
                          v=torch.zeros((self.n_vertices, 3), dtype=self.dtype,
                                        device=self.device))

    def attachment_rest_positions(self) -> np.ndarray:
        """The handles' rest targets, flat (3 * n_att,): the cloth control
        mode's rest action (reference cloth_simulator.py:33). A vertex
        listed twice among the attachments is listed twice here too."""
        return self.rest_verts[self.attachment_idx].reshape(-1).copy()

    def _base_rhs_and_pred(self, state: ClothState, attach_pos, ext_f):
        dt, m = self.dt, self._mass
        # a device tensor: no host-to-device copy an env step
        attach_pos = self._att_rest if attach_pos is None else \
            torch.as_tensor(attach_pos, dtype=self.dtype,
                            device=self.device).reshape(-1, 3)
        x_pred = state.x + dt * state.v + (dt * dt) * (ext_f / m
                                                       + self._gravity)
        base_rhs = (m / dt ** 2) * x_pred
        base_rhs = base_rhs.index_add(
            0, self._att, self.attachment_stiffness * attach_pos)
        return base_rhs, x_pred

    def _pd_iteration(self, base_rhs, y):
        """One local/global iteration, the fixed-point map y -> T(y)."""
        rhs = base_rhs
        for (D, Jk, rest) in self._edge_ops:
            d = D @ y
            dn = d / torch.sqrt(torch.sum(d * d, dim=1, keepdim=True) + 1e-18)
            rhs = rhs + Jk @ (rest * dn)
        return self._Ainv @ rhs

    def _solve(self, base_rhs, x_pred):
        y = x_pred
        if self.convergence_tol is None:
            for _ in range(self.n_iterations):
                y = self._pd_iteration(base_rhs, y)
            return y
        done = torch.zeros((), dtype=torch.bool, device=self.device)
        for _ in range(self.n_iterations):
            y_next = self._pd_iteration(base_rhs, y)
            res = torch.max(torch.abs(y_next - y))
            y = torch.where(done, y, y_next)
            done = done | (res < self.convergence_tol)
        return y

    def step(self, state: ClothState, attach_pos: Optional[torch.Tensor],
             ext_f: torch.Tensor) -> ClothState:
        """One env-dt step. attach_pos: (n_att*3,) or (n_att, 3) handle
        targets (None: held at rest); ext_f: (V, 3) force from the MPM
        side."""
        base_rhs, x_pred = self._base_rhs_and_pred(state, attach_pos, ext_f)
        y = self._solve(base_rhs, x_pred)
        v_new = (1.0 - self.velocity_damping) * (y - state.x) / self.dt
        return ClothState(x=y, v=v_new)

    def pd_residual(self, state: ClothState, attach_pos=None,
                    ext_f=None) -> torch.Tensor:
        """max |T(y_K) - y_K| after the configured iterations for this
        step's inputs: what DiffCloth drives below
        ``forwardConvergenceThresh``."""
        if ext_f is None:
            ext_f = torch.zeros((self.n_vertices, 3), dtype=self.dtype,
                                device=self.device)
        base_rhs, x_pred = self._base_rhs_and_pred(state, attach_pos, ext_f)
        y = self._solve(base_rhs, x_pred)
        return torch.max(torch.abs(self._pd_iteration(base_rhs, y) - y))


def parse_scene_config(scene: dict):
    """Solver parameters from a DiffCloth-style string-keyed scene config
    (``demo_taco_config.py:58-76``)."""
    att = [int(s) for s in str(scene["customAttachmentVertexIdx"]).split(",")
           if s]
    gravity = -9.8
    if "gravity" in scene:
        gravity = -abs(float(scene["gravity"]))
    out = {
        "k_stretch": float(scene["fabric:k_stiff_stretching"]),
        "k_bend": float(scene["fabric:k_stiff_bending"]),
        "density": float(scene["fabric:density"]),
        "dt": float(scene["timeStep"]),
        "attachment_idx": att,
        "gravity": gravity,
    }
    if "forwardConvergenceThresh" in scene:
        out["convergence_tol"] = float(scene["forwardConvergenceThresh"])
    if "solverIterations" in scene:
        out["n_iterations"] = int(scene["solverIterations"])
    return out


def transform_mesh(verts: np.ndarray, config: dict) -> np.ndarray:
    """Scene-config mesh transform (cloth_simulator.py:41-56): scale, then
    translation, then a rotation about the mesh's lower corner."""
    v = verts.copy()
    if "scale" in config:
        s = config["scale"]
        if not isinstance(s, (tuple, list)):
            s = (s, s, s)
        v = v * np.asarray(s)
    if "translation" in config:
        v = v + np.asarray(config["translation"])
    if "rotation" in config:
        angle = config["rotation"]["angle"]
        direction = np.asarray(config["rotation"]["direction"], np.float64)
        direction = direction / max(np.linalg.norm(direction), 1e-12)
        center = v.min(0)
        c, s_ = np.cos(angle), np.sin(angle)
        K = np.array([[0, -direction[2], direction[1]],
                      [direction[2], 0, -direction[0]],
                      [-direction[1], direction[0], 0]])
        R = np.eye(3) + s_ * K + (1 - c) * (K @ K)
        v = (v - center) @ R.T + center
    return v
