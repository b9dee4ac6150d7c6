"""Loss registry: the pour, grip, door and hit losses are ported."""
from softmac_tpu_torch.engine.losses.cloth_losses import HitLoss
from softmac_tpu_torch.engine.losses.common import FrameSample, chamfer, pairwise_sqdist
from softmac_tpu_torch.engine.losses.rigid_losses import (
    DoorLoss, GripLoss, LossBase, PourLoss,
)

LOSS_REGISTRY = {
    "PourLoss": PourLoss,
    "GripLoss": GripLoss,
    "DoorLoss": DoorLoss,
    "HitLoss": HitLoss,
}

__all__ = ["FrameSample", "chamfer", "pairwise_sqdist", "LossBase",
           "PourLoss", "GripLoss", "DoorLoss", "HitLoss", "LOSS_REGISTRY"]
