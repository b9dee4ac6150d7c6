"""Loss registry: the pour and door losses are ported."""
from softmac_tpu_torch.engine.losses.common import FrameSample, chamfer, pairwise_sqdist
from softmac_tpu_torch.engine.losses.rigid_losses import DoorLoss, LossBase, PourLoss

LOSS_REGISTRY = {
    "PourLoss": PourLoss,
    "DoorLoss": DoorLoss,
}

__all__ = ["FrameSample", "chamfer", "pairwise_sqdist", "LossBase",
           "PourLoss", "DoorLoss", "LOSS_REGISTRY"]
