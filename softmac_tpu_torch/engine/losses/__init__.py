"""Loss registry. Only the pour loss is ported so far."""
from softmac_tpu_torch.engine.losses.common import FrameSample, chamfer, pairwise_sqdist
from softmac_tpu_torch.engine.losses.rigid_losses import LossBase, PourLoss

LOSS_REGISTRY = {
    "PourLoss": PourLoss,
}

__all__ = ["FrameSample", "chamfer", "pairwise_sqdist", "LossBase",
           "PourLoss", "LOSS_REGISTRY"]
