"""QTensor — a quantized tensor (port of bigdl_tpu/quant/qtensor.py).

A plain dataclass over torch tensors: `data` holds the packed codes,
`scales` the float16 block scales, both row-leading ([..., O, *]) so row
slices and row concatenations keep the tensor self-consistent. The
logical shape is derived from the storage shape.
"""

from __future__ import annotations

import dataclasses

import torch

from bigdl_tpu_torch.quant.numerics import (dequantize_blockwise,
                                            quantize_blockwise)
from bigdl_tpu_torch.quant.qtypes import QTypeSpec, resolve_qtype

# array fields of a QTensor this port stores (sym_int4 has no mins or
# sub-block scales)
ARRAY_FIELDS = ("data", "scales")


@dataclasses.dataclass
class QTensor:
    data: torch.Tensor
    scales: torch.Tensor
    qtype: str = dataclasses.field(kw_only=True)

    @property
    def spec(self) -> QTypeSpec:
        return resolve_qtype(self.qtype)

    @property
    def shape(self) -> tuple[int, ...]:
        return (*self.data.shape[:-1], self.data.shape[-1] * 2)

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        return dequantize_blockwise(self.data, self.scales, self.spec, dtype)


def concat_rows(ws: list[QTensor]) -> QTensor:
    """Concatenate same-qtype QTensors along the output (row) axis — the
    lossless merge behind `merge_fused_params`."""
    if any(w.qtype != ws[0].qtype for w in ws):
        raise ValueError("concat_rows needs one qtype")
    return QTensor(qtype=ws[0].qtype, **{
        f: torch.cat([getattr(w, f) for w in ws], dim=-2)
        for f in ARRAY_FIELDS
    })


def quantize(x: torch.Tensor, qtype: str) -> QTensor:
    """Quantize `x` blockwise along its last (contraction) axis."""
    spec = resolve_qtype(qtype)
    if spec.is_dense:
        raise ValueError(f"qtype {qtype} is dense; keep the array as-is")
    return QTensor(qtype=spec.name, **quantize_blockwise(x, spec))


def dequantize(qt: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    return qt.dequantize(dtype)
