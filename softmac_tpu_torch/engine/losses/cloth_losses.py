"""Task losses of the cloth-coupled scenes
(``softmac_tpu/engine/losses/cloth_losses.py``): ``TacoLoss`` (reference
``soft_cloth/engine/losses/loss_taco.py``: the chamfer of the particles
against a target cloud), ``HitLoss`` (``loss_hit.py``: the squared distance
of the cloth's vertices to a target pose) and ``HangLoss`` (``loss_hang.py``:
that distance plus the cloth's squared velocities, the target set at run
time)."""
from __future__ import annotations

import numpy as np
import torch

from softmac_tpu_torch.engine.losses.common import (
    FrameSample, chamfer, load_target,
)
from softmac_tpu_torch.engine.losses.rigid_losses import LossBase


class TacoLoss(LossBase):
    term_names = ("chamfer_loss",)

    def __init__(self, cfg, scene):
        super().__init__(cfg, scene)
        self.chamfer_weight = cfg.weight[0]
        self.target_x = torch.as_tensor(
            load_target(cfg.target_path, scene.search_dirs),
            dtype=scene.dtype, device=scene.device)

    def terms(self, s: FrameSample) -> dict:
        return {"chamfer_loss": self.chamfer_weight
                * chamfer(s.x, self.target_x)}


class HitLoss(LossBase):
    term_names = ("pose_loss",)

    def __init__(self, cfg, scene):
        super().__init__(cfg, scene)
        self.pose_weight = cfg.weight[0]
        self.target_x = torch.as_tensor(
            load_target(cfg.target_path, scene.search_dirs),
            dtype=scene.dtype, device=scene.device)

    def terms(self, s: FrameSample) -> dict:
        return {"pose_loss": self.pose_weight
                * torch.sum((s.cloth_x - self.target_x) ** 2)}


class HangLoss(LossBase):
    term_names = ("pose_loss", "vel_loss")

    def __init__(self, cfg, scene, target=None):
        super().__init__(cfg, scene)
        self.pose_weight = cfg.weight[0]
        self.velocity_weight = cfg.weight[1]
        self.target_x = None
        if target is not None:
            self.set_target(target)

    def set_target(self, x):
        self.target_x = torch.as_tensor(np.asarray(x), dtype=self.scene.dtype,
                                        device=self.scene.device)

    def terms(self, s: FrameSample) -> dict:
        return {"pose_loss": self.pose_weight
                * torch.sum((s.cloth_x - self.target_x) ** 2),
                "vel_loss": self.velocity_weight * torch.sum(s.cloth_v ** 2)}
