"""Weight conversion into and out of the port: numpy arrays of the JAX
package's layout, the low-bit artifact, HuggingFace safetensors."""

from bigdl_tpu_torch.convert.from_jax import lora_from_numpy, params_from_numpy, params_to_numpy
from bigdl_tpu_torch.convert.hf import load_hf_checkpoint, open_checkpoint
from bigdl_tpu_torch.convert.low_bit import load_low_bit, save_low_bit, verify_low_bit

__all__ = ["load_hf_checkpoint", "load_low_bit", "lora_from_numpy", "open_checkpoint",
           "params_from_numpy", "params_to_numpy", "save_low_bit", "verify_low_bit"]
