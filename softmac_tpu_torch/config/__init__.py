from softmac_tpu_torch.config.node import (
    CN, ConfigNode, load, make_cls_config,
)
from softmac_tpu_torch.config.default_config import get_cfg_defaults

__all__ = ["CN", "ConfigNode", "get_cfg_defaults", "load", "make_cls_config"]
