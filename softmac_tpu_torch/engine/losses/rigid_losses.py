"""Task losses of the rigid-coupled scenes
(``softmac_tpu/engine/losses/rigid_losses.py``): ``PourLoss`` (reference
``softmac/engine/losses/loss_pour.py``: chamfer + pose + velocity),
``GripLoss`` (``loss_grip.py``: chamfer + the palm's pose, with a band on
its rotation, + velocity), ``DoorLoss`` (``loss_door.py``: pose on the
door's quaternion + velocity + min contact distance) and ``TransportLoss``
(the first body's position pulled to a target + velocity + each half of
the particles' min contact distance)."""
from __future__ import annotations

import numpy as np
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


class GripLoss(PourLoss):
    """PourLoss whose pose term also holds the first body's (the palm's)
    |quat_w| in a band (loss_grip.py:74-79)."""

    def terms(self, s: FrameSample) -> dict:
        out = super().terms(s)
        qw = torch.abs(s.bodies.quat[0, 0])
        band = (torch.clamp(qw - 0.5, max=0.0) ** 2
                + torch.clamp(qw - 0.9, min=0.0) ** 2)
        out["pose_loss"] = out["pose_loss"] + self.pose_weight * band
        return out


class DoorLoss(LossBase):
    term_names = ("pose_loss", "vel_loss", "contact_loss")

    def __init__(self, cfg, scene):
        super().__init__(cfg, scene)
        w = cfg.weight
        self.pose_weight, self.velocity_weight, self.contact_weight = w[0], w[1], w[2]

    def terms(self, s: FrameSample) -> dict:
        out = {}
        # loss_door.py:36-37: door quaternion w pulled to cos(pi/8)
        out["pose_loss"] = self.pose_weight * (
            s.bodies.quat[0, 0] - np.cos(np.pi / 8)) ** 2
        out["vel_loss"] = self.velocity_weight * torch.sum(s.bodies.v[0] ** 2)
        # loss_door.py:53-61: squared min over particles of hinged distance
        d2 = torch.sum((s.x - s.bodies.pos[0]) ** 2, dim=-1)
        min_dist = torch.min(torch.clamp(d2 - 0.01, min=0.0))
        out["contact_loss"] = self.contact_weight * min_dist ** 2
        return out


class TransportLoss(LossBase):
    term_names = ("pose_loss", "vel_loss", "contact_loss")

    def __init__(self, cfg, scene, target=(0.5, 0.4, 0.5)):
        super().__init__(cfg, scene)
        w = cfg.weight
        self.pose_weight, self.velocity_weight, self.contact_weight = w[0], w[1], w[2]
        self.target = torch.as_tensor(
            np.asarray(cfg.get("target", target), np.float64),
            dtype=scene.dtype, device=scene.device)

    def terms(self, s: FrameSample) -> dict:
        out = {}
        out["pose_loss"] = self.pose_weight * torch.sum(
            (s.bodies.pos[0] - self.target) ** 2)
        out["vel_loss"] = self.velocity_weight * torch.sum(s.bodies.v[0] ** 2)
        # each half of the particles' squared min hinged distance to the
        # body
        n_half = s.x.shape[0] // 2
        d2 = torch.sum((s.x - s.bodies.pos[0]) ** 2, dim=-1)
        m1 = torch.min(torch.clamp(d2[:n_half] - 0.01, min=0.0))
        m2 = torch.min(torch.clamp(d2[n_half:] - 0.01, min=0.0))
        out["contact_loss"] = self.contact_weight * (m1 ** 2 + m2 ** 2)
        return out
