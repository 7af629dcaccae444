"""Model families of the port: the llama-family decoder for now."""

from bigdl_tpu_torch.models import llama
from bigdl_tpu_torch.models.config import PRESETS, ModelConfig

__all__ = ["ModelConfig", "PRESETS", "llama"]
