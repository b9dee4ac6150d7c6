"""softmac-tpu on PyTorch and CUDA: the port of the JAX package
``softmac_tpu`` to an NVIDIA H100.

Plain tensor code is PyTorch; the kernels the JAX package wrote in Pallas
for the TPU are hand-written CUDA kernels (``ops/csrc``), built with nvcc at
first use. Entry points run on CUDA unless the caller passes
``device="cpu"``, which runs the kernels' plain PyTorch versions. This
package imports neither JAX nor ``softmac_tpu``.
"""
from softmac_tpu_torch.config import CN, get_cfg_defaults, load
from softmac_tpu_torch.engine.env import SoftMacEnv, TaichiEnv

__version__ = "0.1.0"

__all__ = ["load", "get_cfg_defaults", "CN", "SoftMacEnv", "TaichiEnv"]
