"""Quantized / dense linear op (port of bigdl_tpu/ops/linear.py).

One entry point dispatches on weight type and shape, with the JAX
package's rule: a QTensor of any of the 16 quantized formats whose shape
the fused kernel takes (O % 128 == 0, K % the format's k_multiple == 0)
goes to the fused dequant-matmul — the GEMV at <= 32 rows, the GEMM
above; any other shape dequantizes and multiplies in plain torch, as JAX
sends those shapes to its XLA dequant path.

The fused matmul is differentiable in x (JAX's custom_vjp, `_fused_matmul`
/ `_fused_bwd`): its backward is the fused dequant dx kernel, and the
frozen weight gets no gradient. An optional shared LoRA pair
`lora=(a [r, K], b [O, r], scale)` folds into the GEMM's writeback on the
fused path (`_fused_lora_matmul`: the LoRA epilogue kernel forward; the
backward's base-weight term through the dx kernel and the rank-r terms in
plain torch, as JAX leaves them to XLA); everywhere else it applies as
`lora_epilogue`. Batched per-row adapters raise (ROADMAP queue 1 item 7).

`Linear` is the module form: it holds a QTensor's fields as buffers
(`data`, `scales`, and `mins` / `sub_scales` / `sub_mins` where the
format has them), or a dense `weight` buffer, plus an optional bias.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from bigdl_tpu_torch.ops import kernels
from bigdl_tpu_torch.quant import ARRAY_FIELDS, QTensor

_BATCHED_ADAPTERS = ("batched per-row LoRA adapters (serving): ROADMAP queue 1 "
                     "item 7, still to be ported")


def _qtensor(qtype: str, fields) -> QTensor:
    return QTensor(**dict(zip(ARRAY_FIELDS, fields)), qtype=qtype)


class _FusedMatmul(torch.autograd.Function):
    """y = x @ dq(W)^T through the fused kernel; dx = g @ dq(W) through
    the dx kernel. The weight crosses as its qtype and five fields (None
    where absent). The kernels are looked up at call time, so a caller can
    hold them against their plain versions by patching `kernels.*`."""

    @staticmethod
    def forward(ctx, x, qtype, *fields):
        ctx.qtype = qtype
        ctx.save_for_backward(*fields)
        return kernels.qmatmul(x, _qtensor(qtype, fields))

    @staticmethod
    def backward(ctx, g):
        w = _qtensor(ctx.qtype, ctx.saved_tensors)
        return (kernels.qmatmul_dx(g.contiguous(), w), None) + (None,) * len(ARRAY_FIELDS)


class _FusedLoraMatmul(torch.autograd.Function):
    """y = x @ dq(W)^T + bf16((x @ a^T) * gate) @ b^T through the LoRA
    epilogue kernel. The backward follows JAX's `_fused_lora_bwd`
    (ops/linear.py:398-418): with u = x @ a^T and dv = g @ b, du = dv *
    gate, dx = g @ dq(W) (dx kernel) + du @ a, da = du^T @ x, db = g^T @
    (u * gate), dgate = dv * u — the rank-r products in the compute
    dtype."""

    @staticmethod
    def forward(ctx, x, a, b, gate, qtype, *fields):
        ctx.qtype = qtype
        ctx.save_for_backward(x, a, b, gate, *fields)
        return kernels.qmatmul_lora(x, _qtensor(qtype, fields), a, b, gate)

    @staticmethod
    def backward(ctx, g):
        x, a, b, gt, *fields = ctx.saved_tensors
        cd = g.dtype
        K, O = x.shape[-1], g.shape[-1]
        xf = x.reshape(-1, K).to(cd)
        gf = g.reshape(-1, O).contiguous()
        ac, bc, gtc = a.to(cd), b.to(cd), gt.to(cd)
        u = xf @ ac.t()  # [M, R]
        dv = gf @ bc  # [M, R]
        du = dv * gtc
        need = ctx.needs_input_grad
        dx = da = db = dgate = None
        if need[0]:
            dxw = kernels.qmatmul_dx(gf, _qtensor(ctx.qtype, fields)).to(cd)
            dx = (dxw + du @ ac).reshape(x.shape).to(x.dtype)
        if need[1]:
            da = (du.t() @ xf).to(a.dtype)
        if need[2]:
            db = (gf.t() @ (u * gtc)).to(b.dtype)
        if need[3]:
            dgate = (dv * u).to(gt.dtype)
        return (dx, da, db, dgate, None) + (None,) * len(ARRAY_FIELDS)


def _fields(w: QTensor) -> tuple:
    return tuple(getattr(w, f) for f in ARRAY_FIELDS)


def _fused_kernel(x: torch.Tensor, w: QTensor) -> bool:
    """Whether this (x, w) pair goes to the fused kernels rather than the
    dequant path: the JAX package's shape guards (every quantized qtype
    has a kernel; its contraction dim must be a multiple of the format's
    k_multiple, `kernels.K_MULTIPLE`, JAX's `_QGEMV_QTYPES`)."""
    return (w.data.dim() == 2 and w.data.shape[0] % 128 == 0
            and w.shape[-1] % kernels.K_MULTIPLE[w.qtype] == 0)


def _rows(x: torch.Tensor) -> int:
    return x.numel() // x.shape[-1] if x.shape[-1] else 0


def _lora_cat_operands(x: torch.Tensor, lora, compute_dtype):
    """A shared LoRA triple (a [r, K], b [O, r], scale) in the fused
    epilogue's concatenated operand form (a_cat [R, K], b_cat [O, R],
    gate [M, R]): gate row m carries the scale in every column. None when
    the shape is ineligible — more adapter columns than the epilogue
    kernel takes (JAX's test is its VMEM allowance, `lora_fused_ok`)."""
    a, b, scale = lora
    if a.dim() == 3:
        raise NotImplementedError(f"linear(lora=...) with {_BATCHED_ADAPTERS}")
    r, ka = a.shape
    if ka != x.shape[-1] or r == 0 or r > kernels.LORA_MAX_RANK:
        return None
    M = _rows(x)
    if M <= kernels.GEMV_MAX_ROWS:
        raise NotImplementedError(
            f"linear(lora=...) at {M} <= {kernels.GEMV_MAX_ROWS} rows (the GEMV "
            "form of the fused LoRA epilogue): ROADMAP queue 2 item 4, still to "
            "be ported")
    sc = torch.as_tensor(scale, device=x.device).to(compute_dtype)
    return a, b, sc.expand(M, r).contiguous()


def lora_epilogue(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  scale, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The shared LoRA delta (x @ a^T) @ b^T * scale in the compute dtype,
    added to a projection's output: a [r, in], b [out, r], scalar scale.
    The scale is cast to the compute dtype, never the other way."""
    if a.dim() == 3:
        raise NotImplementedError(f"lora_epilogue with {_BATCHED_ADAPTERS}")
    xc = x.to(compute_dtype)
    xa = torch.matmul(xc, a.to(compute_dtype).t())
    sc = torch.as_tensor(scale, device=x.device).to(compute_dtype)
    return torch.matmul(xa, b.to(compute_dtype).t()) * sc


def linear(x: torch.Tensor, w: Union[QTensor, torch.Tensor],
           bias: Optional[torch.Tensor] = None,
           compute_dtype=torch.bfloat16, lora=None) -> torch.Tensor:
    """y = x @ W^T (+ bias) (+ LoRA delta), W of logical shape [out, in].
    `lora` is an optional shared (a, b, scale) triple: on the fused GEMM
    path it rides in the kernel's writeback, elsewhere it applies as
    `lora_epilogue`."""
    if isinstance(w, QTensor) and _fused_kernel(x, w):
        xc = x.to(compute_dtype)
        ops = None if lora is None else _lora_cat_operands(x, lora, compute_dtype)
        if ops is not None:
            y, lora = _FusedLoraMatmul.apply(xc, *ops, w.qtype, *_fields(w)), None
        else:
            y = _FusedMatmul.apply(xc, w.qtype, *_fields(w)).to(compute_dtype)
    else:
        wd = (w.dequantize(compute_dtype) if isinstance(w, QTensor)
              else w.to(compute_dtype))
        y = torch.matmul(x.to(compute_dtype), wd.t())
    if lora is not None:
        y = y + lora_epilogue(x, *lora, compute_dtype)
    if bias is not None:
        y = y + bias.to(compute_dtype)
    return y


class Linear(nn.Module):
    """A linear layer over a QTensor (its fields as buffers, None where the
    format has none) or a dense weight."""

    def __init__(self, weight: Union[QTensor, torch.Tensor],
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.qtype = weight.qtype if isinstance(weight, QTensor) else None
        if self.qtype is None:
            self.register_buffer("weight", weight)
        else:
            for f in ARRAY_FIELDS:
                self.register_buffer(f, getattr(weight, f))
        self.register_buffer("bias", bias)

    @property
    def w(self) -> Union[QTensor, torch.Tensor]:
        if self.qtype is None:
            return self.weight
        return _qtensor(self.qtype, [getattr(self, f) for f in ARRAY_FIELDS])

    def forward(self, x: torch.Tensor, compute_dtype=torch.bfloat16, lora=None):
        return linear(x, self.w, self.bias, compute_dtype, lora)
