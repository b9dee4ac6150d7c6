"""Task losses of the cloth-coupled scenes
(``softmac_tpu/engine/losses/cloth_losses.py``): ``HitLoss`` (reference
``soft_cloth/engine/losses/loss_hit.py``: the squared distance of the cloth's
vertices to a target pose). The taco's and the hang's come with their
scenes."""
from __future__ import annotations

import torch

from softmac_tpu_torch.engine.losses.common import FrameSample, load_target
from softmac_tpu_torch.engine.losses.rigid_losses import LossBase


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
