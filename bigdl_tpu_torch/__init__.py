"""bigdl_tpu_torch — the PyTorch/CUDA port of bigdl_tpu.

A second package beside the JAX one: the same low-bit formats, model
configurations, generation surface and QLoRA training (`train`), in
PyTorch, with the Pallas TPU kernels rewritten by hand as CUDA kernels
for Hopper (sm_90a). It imports
neither jax nor bigdl_tpu. Entry points run on the CUDA card unless
given device="cpu", where every kernel wrapper takes its plain PyTorch
version.
"""

from bigdl_tpu_torch.api import TorchModel, optimize_model
from bigdl_tpu_torch.models.config import PRESETS, ModelConfig

__all__ = ["ModelConfig", "PRESETS", "TorchModel", "optimize_model"]
