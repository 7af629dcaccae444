"""Weight conversion into the port."""

from bigdl_tpu_torch.convert.from_jax import lora_from_numpy, params_from_numpy

__all__ = ["lora_from_numpy", "params_from_numpy"]
