"""Low-bit quantization core of the port (counterpart of bigdl_tpu/quant)."""

from bigdl_tpu_torch.quant.numerics import (
    dequantize_blockwise,
    pack_nibbles,
    pack_planes,
    quantize_blockwise,
    unpack_nibbles,
    unpack_planes,
)
from bigdl_tpu_torch.quant.qtensor import (ARRAY_FIELDS, QTensor, concat_rows,
                                           dequantize, quantize,
                                           quantize_or_dense)
from bigdl_tpu_torch.quant.qtypes import QTypeSpec, resolve_qtype

__all__ = [
    "ARRAY_FIELDS", "QTensor", "QTypeSpec", "concat_rows", "dequantize",
    "dequantize_blockwise", "pack_nibbles", "pack_planes", "quantize",
    "quantize_blockwise", "quantize_or_dense", "resolve_qtype",
    "unpack_nibbles", "unpack_planes",
]
