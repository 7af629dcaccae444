"""Low-bit quantization core of the port (counterpart of bigdl_tpu/quant)."""

from bigdl_tpu_torch.quant.numerics import (
    dequantize_blockwise,
    pack_nibbles,
    quantize_blockwise,
    unpack_nibbles,
)
from bigdl_tpu_torch.quant.qtensor import (QTensor, concat_rows, dequantize,
                                           quantize)
from bigdl_tpu_torch.quant.qtypes import QTypeSpec, resolve_qtype

__all__ = [
    "QTensor", "QTypeSpec", "concat_rows", "dequantize",
    "dequantize_blockwise", "pack_nibbles", "quantize",
    "quantize_blockwise", "resolve_qtype", "unpack_nibbles",
]
