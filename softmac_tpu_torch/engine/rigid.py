"""Velocity-controlled rigid bodies (``softmac_tpu/engine/rigid.py``,
``RigidVelocityModel``; reference ``softmac/engine/rigid_simulator_vel.py``).

No dynamics: actions set each body's (w, v) for the next window and poses
integrate kinematically every substep. The floating and articulated
``RigidModel`` comes with the flagship-pour slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from softmac_tpu_torch.engine import quat as Q
from softmac_tpu_torch.engine.types import BodyState, _Replace


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
