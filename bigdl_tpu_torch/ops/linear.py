"""Quantized / dense linear op (port of bigdl_tpu/ops/linear.py).

One entry point dispatches on weight type and shape, with the JAX
package's rule: a QTensor whose shape the fused kernel takes (O % 128 ==
0, K % k_multiple == 0) goes to the fused dequant-matmul — the GEMV at
<= 32 rows, the GEMM above; any other shape dequantizes and multiplies
in plain torch, as JAX sends those shapes to its XLA dequant path. A
QTensor format without a kernel in the table raises. LoRA is not in this
slice (ROADMAP queue 2).

`Linear` is the module form: it holds a sym_int4 weight as `data` /
`scales` buffers, or a dense `weight` buffer, plus an optional bias.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch
from torch import nn

from bigdl_tpu_torch.ops import kernels
from bigdl_tpu_torch.quant import QTensor


def _run_sym_int4(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    # looked up at call time, so a caller can hold the module's kernel
    # against its plain version by patching `kernels.qmatmul_int4`
    return kernels.qmatmul_int4(x, w.data, w.scales)


class _Entry(NamedTuple):
    """Eligibility + kernel for one qtype: the contraction dim must be a
    multiple of k_multiple (whole quant blocks per nibble plane)."""
    k_multiple: int
    run: Callable  # (x [..., K] bf16, w) -> y [..., O] bf16, both row classes


_QGEMV_QTYPES = {"sym_int4": _Entry(64, _run_sym_int4)}


def _fused_kernel(x: torch.Tensor, w: QTensor) -> Optional[Callable]:
    """The fused kernel this (x, w) pair dispatches to, or None for the
    dequant path (the JAX package's shape guards)."""
    entry = _QGEMV_QTYPES.get(w.qtype)
    if entry is None:
        raise NotImplementedError(
            f"linear over a {w.qtype} weight: ROADMAP queue 1, the other 15 "
            "weight formats are still to be ported")
    if w.data.dim() != 2 or w.data.shape[0] % 128 != 0:
        return None
    if w.shape[-1] % entry.k_multiple != 0:
        return None
    return entry.run


def linear(x: torch.Tensor, w: Union[QTensor, torch.Tensor],
           bias: Optional[torch.Tensor] = None,
           compute_dtype=torch.bfloat16) -> torch.Tensor:
    """y = x @ W^T (+ bias), W of logical shape [out, in]."""
    if isinstance(w, QTensor):
        run = _fused_kernel(x, w)
        if run is not None:
            y = run(x.to(compute_dtype), w).to(compute_dtype)
            if bias is not None:
                y = y + bias.to(compute_dtype)
            return y
        wd = w.dequantize(compute_dtype)
    else:
        wd = w.to(compute_dtype)
    y = torch.matmul(x.to(compute_dtype), wd.t())
    if bias is not None:
        y = y + bias.to(compute_dtype)
    return y


class Linear(nn.Module):
    """A linear layer over a sym_int4 QTensor or a dense weight."""

    def __init__(self, weight: Union[QTensor, torch.Tensor],
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.qtype = weight.qtype if isinstance(weight, QTensor) else None
        if self.qtype is None:
            self.register_buffer("weight", weight)
        else:
            self.register_buffer("data", weight.data)
            self.register_buffer("scales", weight.scales)
        self.register_buffer("bias", bias)

    @property
    def w(self) -> Union[QTensor, torch.Tensor]:
        if self.qtype is None:
            return self.weight
        return QTensor(self.data, self.scales, qtype=self.qtype)

    def forward(self, x: torch.Tensor, compute_dtype=torch.bfloat16):
        return linear(x, self.w, self.bias, compute_dtype)
