"""Quantized / dense linear op (port of bigdl_tpu/ops/linear.py).

One entry point dispatches on weight type and shape, with the JAX
package's rule: a QTensor of any of the 16 quantized formats whose shape
the fused kernel takes (O % 128 == 0, K % the format's k_multiple == 0)
goes to the fused dequant-matmul — the GEMV at <= 32 rows, the GEMM
above; any other shape dequantizes and multiplies in plain torch, as JAX
sends those shapes to its XLA dequant path.

The fused matmul is differentiable in x (JAX's custom_vjp, `_fused_matmul`
/ `_fused_bwd`): its backward is the fused dequant dx kernel, and the
frozen weight gets no gradient. An optional LoRA triple — shared,
`lora=(a [r, K], b [O, r], scale)`, or batched per-row adapters of the
serving engine, `(a [B, rb, K], b [B, O, rb], scale [B])` against x
[B, T, K] — folds into the fused matmul's writeback wherever JAX's
`lora_fused_ok` admits its width (`_FusedLoraMatmul`: the LoRA GEMV or
GEMM forward; the backward's base-weight term through the dx kernel and
the rank-R terms in plain torch, as JAX leaves them to XLA); everywhere
else it applies as `lora_epilogue`.

A dense weight goes through `_DenseMatmul`: y = x @ W^T and dx = g @ W
in torch.matmul (JAX leaves both to XLA), dW = g^T @ x through the dW
kernel (`kernels.dw_matmul`, the port of the Pallas `_dw_kernel`). The
weight's cast to the compute dtype happens outside the Function, so an
f32 master weight receives the dW of its bf16 copy, as JAX's autodiff of
`w.astype(bf16)` gives it.

`fused_backward_scope(False)` sends dx of every quantized linear whose
forward runs inside it through the dequantize-then-matmul path instead
of the dx kernel (JAX's rematerialized-dequant oracle, its
`fused_backward_scope`); the training step chooses it per step function.

`Linear` is the module form: it holds a QTensor's fields as buffers
(`data`, `scales`, and `mins` / `sub_scales` / `sub_mins` where the
format has them), or a dense `weight` parameter, plus an optional `bias`
parameter (added in the compute dtype after the product, as JAX adds
it); parameters train only once asked to (`requires_grad=False` until
`models.llama.make_trainable`).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch
from torch import nn

from bigdl_tpu_torch.ops import kernels
from bigdl_tpu_torch.quant import ARRAY_FIELDS, QTensor

def _qtensor(qtype: str, fields) -> QTensor:
    return QTensor(**dict(zip(ARRAY_FIELDS, fields)), qtype=qtype)


# The backward-path selector, read when a fused forward runs (and kept by
# its autograd node): True takes the dx kernel, False the dequantize-then-
# matmul oracle. A process-wide flag, as JAX's, so that a layer recomputed
# in the backward (remat) reads the same value as its first forward.
_FUSED_BACKWARD = True


@contextlib.contextmanager
def fused_backward_scope(enabled: bool = True):
    """Choose the dx path of the quantized linears run inside the scope."""
    global _FUSED_BACKWARD
    prev = _FUSED_BACKWARD
    _FUSED_BACKWARD = bool(enabled)
    try:
        yield
    finally:
        _FUSED_BACKWARD = prev


def _dx(g: torch.Tensor, w: QTensor, fused: bool) -> torch.Tensor:
    """dx = g @ dq(W): the dx kernel, or the dequantized weight through
    torch.matmul in g's dtype (JAX's `_fused_dx` oracle)."""
    if fused:
        return kernels.qmatmul_dx(g, w)
    return torch.matmul(g, w.dequantize(g.dtype))


class _FusedMatmul(torch.autograd.Function):
    """y = x @ dq(W)^T through the fused kernel; dx = g @ dq(W) through
    the dx kernel. The weight crosses as its qtype and five fields (None
    where absent). The kernels are looked up at call time, so a caller can
    hold them against their plain versions by patching `kernels.*`."""

    @staticmethod
    def forward(ctx, x, qtype, *fields):
        ctx.qtype = qtype
        ctx.fused = _FUSED_BACKWARD
        ctx.save_for_backward(*fields)
        return kernels.qmatmul(x, _qtensor(qtype, fields))

    @staticmethod
    def backward(ctx, g):
        w = _qtensor(ctx.qtype, ctx.saved_tensors)
        return (_dx(g.contiguous(), w, ctx.fused), None) + (None,) * len(ARRAY_FIELDS)


class _FusedLoraMatmul(torch.autograd.Function):
    """y = x @ dq(W)^T + bf16((x @ a^T) * gate) @ b^T through the LoRA
    GEMV or GEMM (the operands cross to it in bf16). The backward follows JAX's `_fused_lora_bwd`
    (ops/linear.py:398-418): with u = x @ a^T and dv = g @ b, du = dv *
    gate, dx = g @ dq(W) (dx kernel) + du @ a, da = du^T @ x, db = g^T @
    (u * gate), dgate = dv * u — the rank-r products in the compute
    dtype."""

    @staticmethod
    def forward(ctx, x, a, b, gate, qtype, *fields):
        ctx.qtype = qtype
        ctx.fused = _FUSED_BACKWARD
        ctx.save_for_backward(x, a, b, gate, *fields)
        a16, b16, g16 = (t.to(torch.bfloat16).contiguous() for t in (a, b, gate))
        return kernels.qmatmul_lora(x, _qtensor(qtype, fields), a16, b16, g16)

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
            dxw = _dx(gf, _qtensor(ctx.qtype, fields), ctx.fused).to(cd)
            dx = (dxw + du @ ac).reshape(x.shape).to(x.dtype)
        if need[1]:
            da = (du.t() @ xf).to(a.dtype)
        if need[2]:
            db = (gf.t() @ (u * gtc)).to(b.dtype)
        if need[3]:
            dgate = (dv * u).to(gt.dtype)
        return (dx, da, db, dgate, None) + (None,) * len(ARRAY_FIELDS)


class _DenseMatmul(torch.autograd.Function):
    """y = x @ w^T for a dense weight already in the compute dtype; the
    backward's dx = g @ w in torch.matmul and dW = g^T @ x through the dW
    kernel, in w's dtype. The kernel is looked up at call time, so a
    caller can hold it against its plain version by patching
    `kernels.dw_matmul`."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.matmul(x, w.t())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(g, w)
        if ctx.needs_input_grad[1]:
            dw = kernels.dw_matmul(g, x, out_dtype=w.dtype)
        return dx, dw


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
    """A LoRA triple in the fused epilogue's concatenated operand form
    (a_cat [R, K], b_cat [O, R], gate [M, R]), as JAX's
    `_lora_cat_operands`, or None where JAX's `lora_fused_ok` refuses the
    width or the batched form does not line up with x's rows. Shared
    (a [r, K], b [O, r], scale): gate row m carries the scale in every
    column. Batched (a [B, rb, K], b [B, O, rb], scale [B] against x
    [B, T, K]): columns group-major, rank within; gate row m carries
    scale_g in its own group g's columns and 0 elsewhere."""
    a, b, scale = lora
    K = x.shape[-1]
    sc = torch.as_tensor(scale, device=x.device).to(compute_dtype)
    if a.dim() == 3:
        if x.dim() != 3 or a.shape[0] != x.shape[0]:
            return None
        B, rb, ka = a.shape
        R = B * rb
        if ka != K or rb == 0 or not kernels.lora_fused_ok(R, K):
            return None
        T = x.shape[1]
        a_cat = a.reshape(R, K)
        b_cat = b.movedim(0, 1).reshape(b.shape[1], R)
        grp = torch.arange(B, device=x.device).repeat_interleave(T)  # row -> group
        col = torch.arange(B, device=x.device).repeat_interleave(rb)  # col -> group
        gate = (grp[:, None] == col[None, :]).to(compute_dtype) * sc[grp][:, None]
        return a_cat, b_cat, gate
    r, ka = a.shape
    if ka != K or r == 0 or not kernels.lora_fused_ok(r, K):
        return None
    return a, b, sc.expand(_rows(x), r).contiguous()


def lora_epilogue(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  scale, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The LoRA delta (x @ a^T) @ b^T * scale in the compute dtype, added
    to a projection's output. Shared: a [r, in], b [out, r], scalar scale.
    Batched per-row adapters (the serving engine's mixed decode batch):
    a [B, r, in], b [B, out, r], scale [B] against x [B, T, in], row b
    through its own pair (zero-padded rank columns and a 0 scale add
    nothing). The scale is cast to the compute dtype, never the other
    way."""
    xc = x.to(compute_dtype)
    ac, bc = a.to(compute_dtype), b.to(compute_dtype)
    sc = torch.as_tensor(scale, device=x.device).to(compute_dtype)
    if a.dim() == 3:
        xa = torch.einsum("btk,brk->btr", xc, ac)
        return torch.einsum("btr,bor->bto", xa, bc) * sc[:, None, None]
    xa = torch.matmul(xc, ac.t())
    return torch.matmul(xa, bc.t()) * sc


def linear(x: torch.Tensor, w: Union[QTensor, torch.Tensor],
           bias: Optional[torch.Tensor] = None,
           compute_dtype=torch.bfloat16, lora=None) -> torch.Tensor:
    """y = x @ W^T (+ bias) (+ LoRA delta), W of logical shape [out, in].
    `lora` is an optional shared or batched (a, b, scale) triple: where
    the fused kernels take the weight and `lora_fused_ok` the width it
    rides in the kernel's writeback, elsewhere it applies as
    `lora_epilogue`."""
    if isinstance(w, QTensor) and _fused_kernel(x, w):
        xc = x.to(compute_dtype)
        ops = None if lora is None else _lora_cat_operands(x, lora, compute_dtype)
        if ops is not None:
            y, lora = _FusedLoraMatmul.apply(xc, *ops, w.qtype, *_fields(w)), None
        else:
            y = _FusedMatmul.apply(xc, w.qtype, *_fields(w)).to(compute_dtype)
    elif isinstance(w, QTensor):
        y = torch.matmul(x.to(compute_dtype), w.dequantize(compute_dtype).t())
    else:
        y = _DenseMatmul.apply(x.to(compute_dtype), w.to(compute_dtype))
    if lora is not None:
        y = y + lora_epilogue(x, *lora, compute_dtype)
    if bias is not None:
        y = y + bias.to(compute_dtype)
    return y


class Linear(nn.Module):
    """A linear layer over a QTensor (its fields as buffers, None where the
    format has none) or a dense weight, with an optional bias (parameters
    that require no gradient until asked to)."""

    def __init__(self, weight: Union[QTensor, torch.Tensor],
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.qtype = weight.qtype if isinstance(weight, QTensor) else None
        if self.qtype is None:
            self.weight = nn.Parameter(weight, requires_grad=False)
        else:
            for f in ARRAY_FIELDS:
                self.register_buffer(f, getattr(weight, f))
        if bias is None:
            self.register_parameter("bias", None)
        else:
            self.bias = nn.Parameter(bias, requires_grad=False)

    @property
    def w(self) -> Union[QTensor, torch.Tensor]:
        if self.qtype is None:
            return self.weight
        return _qtensor(self.qtype, [getattr(self, f) for f in ARRAY_FIELDS])

    def forward(self, x: torch.Tensor, compute_dtype=torch.bfloat16, lora=None):
        return linear(x, self.w, self.bias, compute_dtype, lora)
