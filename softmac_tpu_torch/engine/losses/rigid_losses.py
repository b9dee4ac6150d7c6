"""Task losses of the rigid-coupled scenes
(``softmac_tpu/engine/losses/rigid_losses.py``). ``PourLoss`` is ported
(reference ``softmac/engine/losses/loss_pour.py``: chamfer + pose +
velocity); the grip, door and transport losses come with their scenes."""
from __future__ import annotations

import torch

from softmac_tpu_torch.engine.losses.common import (
    FrameSample, chamfer, load_target,
)


class LossBase:
    term_names = ()

    def __init__(self, cfg, scene):
        self.cfg = cfg
        self.scene = scene

    def terms(self, sample: FrameSample) -> dict:
        raise NotImplementedError


class PourLoss(LossBase):
    term_names = ("chamfer_loss", "pose_loss", "vel_loss")

    def __init__(self, cfg, scene):
        super().__init__(cfg, scene)
        w = cfg.weight
        self.chamfer_weight, self.pose_weight, self.velocity_weight = w[0], w[1], w[2]
        self.target_x = torch.as_tensor(
            load_target(cfg.target_path, scene.search_dirs),
            dtype=scene.dtype, device=scene.device)

    def terms(self, s: FrameSample) -> dict:
        out = {}
        out["chamfer_loss"] = self.chamfer_weight * (
            chamfer(s.x, self.target_x) if self.chamfer_weight > 0 else 0.0)
        # pose: pull the controlled body's height to 0.4 (loss_pour.py:73-79)
        out["pose_loss"] = self.pose_weight * 10.0 * (s.bodies.pos[0, 1] - 0.4) ** 2
        out["vel_loss"] = self.velocity_weight * (
            torch.sum(s.bodies.v[0] ** 2) + 0.1 * torch.sum(s.bodies.w[0] ** 2))
        return out
