"""Loss registry: the pour, grip, door, transport, taco, hang and hit
losses."""
from softmac_tpu_torch.engine.losses.cloth_losses import (
    HangLoss, HitLoss, TacoLoss,
)
from softmac_tpu_torch.engine.losses.common import FrameSample, chamfer, pairwise_sqdist
from softmac_tpu_torch.engine.losses.rigid_losses import (
    DoorLoss, GripLoss, LossBase, PourLoss, TransportLoss,
)

LOSS_REGISTRY = {
    "PourLoss": PourLoss,
    "GripLoss": GripLoss,
    "DoorLoss": DoorLoss,
    "TransportLoss": TransportLoss,
    "TacoLoss": TacoLoss,
    "HangLoss": HangLoss,
    "HitLoss": HitLoss,
}

__all__ = ["FrameSample", "chamfer", "pairwise_sqdist", "LossBase",
           "PourLoss", "GripLoss", "DoorLoss", "TransportLoss", "TacoLoss",
           "HangLoss", "HitLoss", "LOSS_REGISTRY"]
