"""bigdl_tpu_torch — the PyTorch/CUDA port of bigdl_tpu.

A second package beside the JAX one: the same low-bit formats, model
configurations, generation surface and QLoRA training (`train`), in
PyTorch, with the Pallas TPU kernels rewritten by hand as CUDA kernels
for Hopper (sm_90a). It imports
neither jax nor bigdl_tpu. Entry points run on the CUDA card unless
given device="cpu", where every kernel wrapper takes its plain PyTorch
version.
"""

__version__ = "0.1.0"

from bigdl_tpu_torch.api import AutoModelForCausalLM, TorchModel, optimize_model
from bigdl_tpu_torch.convert.low_bit import load_low_bit, save_low_bit, verify_low_bit
from bigdl_tpu_torch.models.config import PRESETS, ModelConfig

__all__ = ["AutoModelForCausalLM", "ModelConfig", "PRESETS", "TorchModel", "load_low_bit",
           "optimize_model", "save_low_bit", "verify_low_bit"]
