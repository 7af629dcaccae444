"""Fused sym_int4 dequant-matmul: wrapper, plain version and launch counts.

Port of bigdl_tpu/ops/pallas/qmatmul.py (`qmatmul_int4`, `_fused`,
`_kernel`) for the sym_int4 format. The CUDA source is
`csrc/qmatmul_sym_int4.cu`; its header note says what bounds each form on
the card and what the design does about it. Two kernels split the TPU
kernel's two shape classes at `GEMV_MAX_ROWS` rows: a GEMV for decode and
a tensor-core GEMM for prefill. A third entry is the GEMM with `_kernel`'s
LoRA epilogue (`qmatmul_lora`), for up to `LORA_MAX_RANK` adapter columns
at more than `GEMV_MAX_ROWS` rows (the training shapes); the GEMV form of
the epilogue (serving adapters) is still to port (ROADMAP queue 2).

The wrapper dispatches on the tensor's device: a CPU tensor takes the
plain version, a CUDA tensor launches a kernel or raises.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.ops.kernels._build import Kernel
from bigdl_tpu_torch.quant.numerics import dequantize_blockwise
from bigdl_tpu_torch.quant.qtypes import resolve_qtype

GEMV_MAX_ROWS = 32  # ops/linear.py _GEMV_MAX_ROWS in the JAX package

# (x, data, scales, out, M, K, O)
GEMV = Kernel("qmatmul_sym_int4_gemv", "qmatmul_sym_int4", "ppppiii",
              replaces="bigdl_tpu/ops/pallas/qmatmul.py:90")
GEMM = Kernel("qmatmul_sym_int4_gemm", "qmatmul_sym_int4", "ppppiii",
              replaces="bigdl_tpu/ops/pallas/qmatmul.py:90")
# (x, data, scales, a_cat, b_cat, gate, out, M, K, O, R)
LORA_GEMM = Kernel("qmatmul_sym_int4_gemm_lora", "qmatmul_sym_int4", "pppppppiiii",
                   replaces="bigdl_tpu/ops/pallas/qmatmul.py:90")
LORA_MAX_RANK = 16  # adapter columns R the epilogue takes (one 16-wide tile)

_SYM_INT4 = resolve_qtype("sym_int4")


def qmatmul_int4_plain(x: torch.Tensor, data: torch.Tensor,
                       scales: torch.Tensor) -> torch.Tensor:
    """y[..., O] = x @ dequant(W)^T with the kernels' arithmetic: weights
    decode as (code - 8) * scale in f32 rounded to bf16, x is rounded to
    bf16, products sum in f32 and the result rounds to bf16."""
    K = x.shape[-1]
    w = dequantize_blockwise(data, scales, _SYM_INT4, torch.bfloat16)
    y = torch.matmul(x.reshape(-1, K).to(torch.bfloat16).float(), w.float().t())
    return y.to(torch.bfloat16).reshape(*x.shape[:-1], w.shape[0])


def _check(x: torch.Tensor, data: torch.Tensor, scales: torch.Tensor) -> None:
    K = x.shape[-1]
    O = data.shape[0]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"qmatmul_int4: x must be bfloat16, got {x.dtype}")
    if data.dtype != torch.uint8 or scales.dtype != torch.float16:
        raise TypeError("qmatmul_int4: data must be uint8 and scales float16, "
                        f"got {data.dtype} / {scales.dtype}")
    if data.dim() != 2 or data.shape[1] * 2 != K or scales.shape != (O, K // 32):
        raise ValueError(f"qmatmul_int4: shapes x {tuple(x.shape)}, data "
                         f"{tuple(data.shape)}, scales {tuple(scales.shape)} "
                         "do not describe one [O, K] sym_int4 weight")
    if K % 64:
        raise ValueError(f"qmatmul_int4: K={K} is not a multiple of 64")
    # x and the packed rows are read in 16-byte vectors, scales one by one
    for name, t, align in (("x", x, 16), ("data", data, 16), ("scales", scales, 2)):
        if t.device != x.device:
            raise ValueError(f"qmatmul_int4: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"qmatmul_int4: {name} must be contiguous and "
                             f"{align}-byte aligned")


def qmatmul_int4(x: torch.Tensor, data: torch.Tensor,
                 scales: torch.Tensor) -> torch.Tensor:
    """y[..., O] = x @ dequant(W)^T for a sym_int4 weight's fields:
    x [..., K] bf16, data [O, K/2] uint8 (half-split), scales [O, K/32]
    float16; returns bf16 [..., O]. Rows <= GEMV_MAX_ROWS launch the GEMV,
    more rows the GEMM."""
    if x.device.type == "cpu":
        return qmatmul_int4_plain(x, data, scales)
    if x.device.type != "cuda":
        raise NotImplementedError(f"qmatmul_int4: no kernel for {x.device}")
    _check(x, data, scales)
    K = x.shape[-1]
    O = data.shape[0]
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    out = torch.empty((M, O), dtype=torch.bfloat16, device=x.device)
    if M:
        kernel = GEMV if M <= GEMV_MAX_ROWS else GEMM
        kernel(x2, data, scales, out, M, K, O, device=x.device)
    return out.reshape(*x.shape[:-1], O)


def qmatmul_int4_lora_plain(x: torch.Tensor, data: torch.Tensor,
                            scales: torch.Tensor, a_cat: torch.Tensor,
                            b_cat: torch.Tensor,
                            gate: torch.Tensor) -> torch.Tensor:
    """y = x @ dequant(W)^T + bf16((x @ A_cat^T) * gate) @ B_cat^T with the
    kernel's rounding: bf16 operands, f32 sums, xa * gate rounded to bf16
    before its product with B_cat, the sum rounded to bf16 once."""
    K = x.shape[-1]
    w = dequantize_blockwise(data, scales, _SYM_INT4, torch.bfloat16)
    xf = x.reshape(-1, K).to(torch.bfloat16).float()
    acc = torch.matmul(xf, w.float().t())
    xa = torch.matmul(xf, a_cat.to(torch.bfloat16).float().t())
    xa = (xa * gate.to(torch.bfloat16).float()).to(torch.bfloat16)
    acc = acc + torch.matmul(xa.float(), b_cat.to(torch.bfloat16).float().t())
    return acc.to(torch.bfloat16).reshape(*x.shape[:-1], w.shape[0])


def qmatmul_int4_lora(x: torch.Tensor, data: torch.Tensor,
                      scales: torch.Tensor, a_cat: torch.Tensor,
                      b_cat: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """`qmatmul_int4` with the LoRA epilogue folded into the GEMM's
    writeback: y = x @ dq(W)^T + ((x @ A_cat^T) * gate) @ B_cat^T. x
    [..., K] bf16 with more than GEMV_MAX_ROWS rows; a_cat [R, K], b_cat
    [O, R], gate [M, R] bf16, R <= LORA_MAX_RANK; returns bf16 [..., O]."""
    if x.device.type == "cpu":
        return qmatmul_int4_lora_plain(x, data, scales, a_cat, b_cat, gate)
    if x.device.type != "cuda":
        raise NotImplementedError(f"qmatmul_int4_lora: no kernel for {x.device}")
    _check(x, data, scales)
    K = x.shape[-1]
    O = data.shape[0]
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    R = a_cat.shape[0]
    if M <= GEMV_MAX_ROWS:
        raise NotImplementedError(
            f"qmatmul_int4_lora at M={M} <= {GEMV_MAX_ROWS} rows (the GEMV "
            "form of the LoRA epilogue, serving adapters): ROADMAP queue 2 "
            "item 4, still to be ported")
    if not 1 <= R <= LORA_MAX_RANK:
        raise ValueError(f"qmatmul_int4_lora: R={R} adapter columns, the "
                         f"kernel takes 1..{LORA_MAX_RANK}")
    if a_cat.shape != (R, K) or b_cat.shape != (O, R) or gate.shape != (M, R):
        raise ValueError(f"qmatmul_int4_lora: a_cat {tuple(a_cat.shape)}, b_cat "
                         f"{tuple(b_cat.shape)}, gate {tuple(gate.shape)} do not "
                         f"match M={M} K={K} O={O} R={R}")
    # A_cat rows are read in 16-byte vectors, B_cat and the gate one by one
    for name, t, align in (("a_cat", a_cat, 16), ("b_cat", b_cat, 2), ("gate", gate, 2)):
        if t.dtype != torch.bfloat16 or t.device != x.device:
            raise TypeError(f"qmatmul_int4_lora: {name} must be bfloat16 on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"qmatmul_int4_lora: {name} must be contiguous "
                             f"and {align}-byte aligned")
    out = torch.empty((M, O), dtype=torch.bfloat16, device=x.device)
    LORA_GEMM(x2, data, scales, a_cat, b_cat, gate, out, M, K, O, R,
              device=x.device)
    return out.reshape(*x.shape[:-1], O)
