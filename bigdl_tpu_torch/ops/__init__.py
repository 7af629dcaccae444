"""Ops of the port: plain torch where the JAX package leaves the work
to XLA, hand-written CUDA kernels (`ops.kernels`) where it has Pallas."""

from bigdl_tpu_torch.ops.attention import attention
from bigdl_tpu_torch.ops.linear import Linear, linear
from bigdl_tpu_torch.ops.norms import layer_norm, rms_norm
from bigdl_tpu_torch.ops.rope import apply_rotary_emb, rope_cos_sin

__all__ = ["Linear", "apply_rotary_emb", "attention", "layer_norm", "linear", "rms_norm",
           "rope_cos_sin"]
