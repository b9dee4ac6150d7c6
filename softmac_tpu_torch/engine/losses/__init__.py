"""Loss registry: the pour, grip, door, taco, hang and hit losses are
ported; the transport loss is not yet."""
from softmac_tpu_torch.engine.losses.cloth_losses import (
    HangLoss, HitLoss, TacoLoss,
)
from softmac_tpu_torch.engine.losses.common import FrameSample, chamfer, pairwise_sqdist
from softmac_tpu_torch.engine.losses.rigid_losses import (
    DoorLoss, GripLoss, LossBase, PourLoss,
)

LOSS_REGISTRY = {
    "PourLoss": PourLoss,
    "GripLoss": GripLoss,
    "DoorLoss": DoorLoss,
    "TacoLoss": TacoLoss,
    "HangLoss": HangLoss,
    "HitLoss": HitLoss,
}

__all__ = ["FrameSample", "chamfer", "pairwise_sqdist", "LossBase",
           "PourLoss", "GripLoss", "DoorLoss", "TacoLoss", "HangLoss",
           "HitLoss", "LOSS_REGISTRY"]
