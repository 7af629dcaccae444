"""QTensor — a quantized tensor (port of bigdl_tpu/quant/qtensor.py).

A plain dataclass over torch tensors: `data` holds the packed codes,
`scales` the float16 block scales, and the optional `mins`, `sub_scales`
and `sub_mins` the asymmetric formats' block minimums and the planar
k-quants' second level (quant/numerics.py). Every field is row-leading
([..., O, *]) so row slices and row concatenations keep the tensor
self-consistent. The logical shape is derived from the storage shape.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch

from bigdl_tpu_torch.quant.numerics import (dequantize_blockwise,
                                            quantize_blockwise)
from bigdl_tpu_torch.quant.qtypes import QTypeSpec, resolve_qtype

# array fields of a QTensor, in declaration order; sub_scales/sub_mins
# carry the integer sub-block scales of two-level (k-quant) formats
ARRAY_FIELDS = ("data", "scales", "mins", "sub_scales", "sub_mins")


@dataclasses.dataclass
class QTensor:
    data: torch.Tensor
    scales: torch.Tensor
    mins: Optional[torch.Tensor] = None
    qtype: str = dataclasses.field(kw_only=True)
    sub_scales: Optional[torch.Tensor] = None
    sub_mins: Optional[torch.Tensor] = None

    @property
    def spec(self) -> QTypeSpec:
        return resolve_qtype(self.qtype)

    @property
    def shape(self) -> tuple[int, ...]:
        spec = self.spec
        if spec.storage == "packed_u8":
            return (*self.data.shape[:-1], self.data.shape[-1] * 2)
        if spec.storage == "packed_planes":
            return (*self.data.shape[:-1], self.data.shape[-1] * 8 // spec.bits)
        return tuple(self.data.shape)

    def fields(self) -> dict:
        """The present array fields by name."""
        return {f: getattr(self, f) for f in ARRAY_FIELDS
                if getattr(self, f) is not None}

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        return dequantize_blockwise(self.data, self.scales, self.mins,
                                    self.spec, dtype, self.sub_scales,
                                    self.sub_mins)


def concat_rows(ws: list[QTensor]) -> QTensor:
    """Concatenate same-qtype QTensors along the output (row) axis — the
    lossless merge behind `merge_fused_params`."""
    if any(w.qtype != ws[0].qtype for w in ws):
        raise ValueError("concat_rows needs one qtype")
    return QTensor(qtype=ws[0].qtype, **{
        f: torch.cat([w.fields()[f] for w in ws], dim=-2)
        for f in ws[0].fields()})


# k-quant fallbacks for weights whose contraction dim is not a multiple of
# the 256-element super-block (llama.cpp's policy, as the JAX package's)
_KQUANT_FALLBACK = {
    "q2_k": "sym_int4", "q3_k": "sym_int4", "q4_k": "sym_int4",
    "q5_k": "sym_int5", "q6_k": "sym_int8",
}


def effective_spec(last_dim: int, qtype: str) -> QTypeSpec:
    """The spec quantize() uses for a given last dim, the k-quant
    super-block fallback included."""
    spec = resolve_qtype(qtype)
    if spec.superblock and last_dim % spec.superblock and spec.name in _KQUANT_FALLBACK:
        spec = resolve_qtype(_KQUANT_FALLBACK[spec.name])
    return spec


def quantize(x: torch.Tensor, qtype: str) -> QTensor:
    """Quantize `x` blockwise along its last (contraction) axis, on its
    own device."""
    if resolve_qtype(qtype).is_dense:
        raise ValueError(f"qtype {qtype} is dense; keep the array as-is")
    spec = effective_spec(x.shape[-1], qtype)
    return QTensor(qtype=spec.name, **quantize_blockwise(x, spec))


def quantize_or_dense(x: torch.Tensor, qtype: str, what: str = "weight"):
    """quantize(), but a weight whose last dim the (effective) format's
    block does not divide stays dense with a warning, as in the JAX
    package."""
    spec = effective_spec(x.shape[-1], qtype)
    if x.shape[-1] % spec.block_size:
        warnings.warn(f"{what}: last dim {x.shape[-1]} not divisible by "
                      f"{spec.name}'s block size {spec.block_size}; keeping "
                      "this weight dense")
        return x
    return quantize(x, qtype)


def dequantize(qt: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    return qt.dequantize(dtype)
