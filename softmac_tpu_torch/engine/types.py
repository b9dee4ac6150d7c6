"""State containers and the static scene description.

Same layouts as the JAX package (``softmac_tpu/engine/types.py``) so tensors
map one to one onto its arrays: particles are struct-of-arrays with the
particle axis last, ``(3, N)`` vectors and ``(3, 3, N)`` matrices. The
containers are small dataclasses of tensors; ``replace`` returns a copy with
some fields swapped, as the JAX pytrees do.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

# material / model enums (parity with reference mpm_simulator.py:4-13)
MODEL_COROTATED = 0
MODEL_NEOHOOKEAN = 1

MAT_PLASTIC = 0
MAT_ELASTIC = 1
MAT_LIQUID = 2

CONTACT_GRID = 0
CONTACT_PARTICLE = 1
CONTACT_MIXED = 2


class _Replace:
    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class MPMState(_Replace):
    """Per-particle MLS-MPM state: position, velocity, affine field,
    deformation gradient."""
    x: torch.Tensor  # (3, N)
    v: torch.Tensor  # (3, N)
    C: torch.Tensor  # (3, 3, N)
    F: torch.Tensor  # (3, 3, N)

    @property
    def x_nd(self) -> torch.Tensor:
        """(N, 3) view for losses / IO."""
        return self.x.T


@dataclasses.dataclass
class BodyState(_Replace):
    """Rigid primitive states, batched over primitives (B bodies)."""
    pos: torch.Tensor   # (B, 3) body-frame origin in world
    quat: torch.Tensor  # (B, 4) wxyz
    v: torch.Tensor     # (B, 3) linear velocity
    w: torch.Tensor     # (B, 3) angular velocity

    @staticmethod
    def identity(n: int, dtype=torch.float32, device="cpu") -> "BodyState":
        quat = torch.zeros((n, 4), dtype=dtype, device=device)
        quat[:, 0] = 1.0
        z = torch.zeros((n, 3), dtype=dtype, device=device)
        return BodyState(pos=z, quat=quat, v=z.clone(), w=z.clone())


@dataclasses.dataclass
class SDFParams(_Replace):
    """Signed-distance tables of one primitive, on the device.

    ``neighborhood`` packs each base cell's 2x2x2 trilinear stencil of
    [sdf, nx, ny, nz] into one 32-wide row, so a query reads one row.
    ``geom`` holds (lower, upper, inv_dx) as host floats for the kernel's
    arguments; ``lower``/``upper``/``inv_dx`` are the same values as tensors.
    """
    neighborhood: torch.Tensor  # (rx*ry*rz, 32)
    lower: torch.Tensor         # (3,)
    upper: torch.Tensor         # (3,)
    inv_dx: torch.Tensor        # ()
    res: Tuple[int, int, int] = (0, 0, 0)
    geom: Tuple[float, ...] = ()


@dataclasses.dataclass
class MPMParams(_Replace):
    """Per-particle material parameters + scene-level dynamic params."""
    mu: torch.Tensor            # (N,)
    lam: torch.Tensor           # (N,)
    yield_stress: torch.Tensor  # (N,)
    gravity: torch.Tensor       # (3,)
    control_idx: torch.Tensor   # (N,) int32, -1 = uncontrolled
    friction: torch.Tensor      # (B,) per-primitive friction
    softness: torch.Tensor      # (B,)


@dataclasses.dataclass(frozen=True)
class MPMConfig:
    """Static simulator configuration."""
    n_particles: int
    n_grid: int = 64
    dt: float = 1e-4
    substeps: int = 20
    material_model: int = MODEL_COROTATED
    ptype: int = MAT_PLASTIC
    collision_type: int = CONTACT_MIXED
    ground_friction: float = 1.5
    n_primitives: int = 0
    # particle controllers: a particle with control_idx c >= 0 takes the
    # impulse of mpm_action[c] every substep
    n_controllers: int = 0
    plastic_mode: str = "clip"   # "clip" (reference runtime) | "von_mises"
    # Static-size active grid window (wx, wy, wz) in cells whose corner
    # tracks the particle centroid each substep; None = full grid.
    active_window: Any = None
    primitives_contact: Tuple[bool, ...] = ()
    mpm_scale: float = 1.0
    # mixed contact's penetration push-out speed cap (m/s); inf = the
    # reference's uncapped (sdf / dt) * life
    contact_push_velocity_cap: float = np.inf
    # grid-velocity clamp at this multiple of dx/dt; inf = off (mpm.cfl_clamp)
    cfl_velocity_clamp: float = np.inf
    dtype: Any = torch.float32

    @property
    def dx(self) -> float:
        # domain spans [0, mpm_scale]^3 (soft_cloth mpm_simulator.py:31)
        return self.mpm_scale / self.n_grid

    @property
    def inv_dx(self) -> float:
        return float(self.n_grid) / self.mpm_scale

    @property
    def p_vol(self) -> float:
        # parity with reference: (dx*0.5)**2 even in 3D (mpm_simulator.py:34)
        return (self.dx * 0.5) ** 2

    @property
    def p_mass(self) -> float:
        return self.p_vol * 1.0


def mpm_state_zero(cfg: MPMConfig, x: torch.Tensor) -> MPMState:
    """Initial state: particles at x (N, 3), zero velocity, identity F, zero
    C (parity with reset_kernel, mpm_simulator.py:495-501)."""
    n = x.shape[0]
    kw = dict(dtype=cfg.dtype, device=x.device)
    F = torch.zeros((3, 3, n), **kw)
    for d in range(3):
        F[d, d] = 1.0
    return MPMState(
        x=x.T.to(cfg.dtype).contiguous(),
        v=torch.zeros((3, n), **kw),
        C=torch.zeros((3, 3, n), **kw),
        F=F,
    )


def mpm_state_from_packed(cfg: MPMConfig, packed: torch.Tensor) -> MPMState:
    """Load an (N, 24) packed state [x(3) v(3) F(9) C(9)] — the reference's
    checkpoint layout (mpm_simulator.py:481-492, 504-512)."""
    n = packed.shape[0]
    p = packed.to(cfg.dtype)
    return MPMState(
        x=p[:, 0:3].T.contiguous(),
        v=p[:, 3:6].T.contiguous(),
        F=p[:, 6:15].reshape(n, 3, 3).permute(1, 2, 0).contiguous(),
        C=p[:, 15:24].reshape(n, 3, 3).permute(1, 2, 0).contiguous(),
    )


def mpm_state_to_packed(state: MPMState) -> torch.Tensor:
    """The (N, 24) packed state [x(3) v(3) F(9) C(9)], each 3x3 row-major:
    the layout ``mpm_state_from_packed`` reads."""
    n = state.x.shape[-1]
    return torch.cat(
        [state.x.T, state.v.T,
         state.F.permute(2, 0, 1).reshape(n, 9),
         state.C.permute(2, 0, 1).reshape(n, 9)], dim=1)
