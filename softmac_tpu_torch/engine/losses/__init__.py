"""Loss registry: the pour, grip and door losses are ported."""
from softmac_tpu_torch.engine.losses.common import FrameSample, chamfer, pairwise_sqdist
from softmac_tpu_torch.engine.losses.rigid_losses import (
    DoorLoss, GripLoss, LossBase, PourLoss,
)

LOSS_REGISTRY = {
    "PourLoss": PourLoss,
    "GripLoss": GripLoss,
    "DoorLoss": DoorLoss,
}

__all__ = ["FrameSample", "chamfer", "pairwise_sqdist", "LossBase",
           "PourLoss", "GripLoss", "DoorLoss", "LOSS_REGISTRY"]
