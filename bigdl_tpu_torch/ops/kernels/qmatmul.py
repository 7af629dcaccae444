"""Fused sym_int4 dequant-matmul: wrapper, plain version and launch counts.

Port of bigdl_tpu/ops/pallas/qmatmul.py (`qmatmul_int4`, `_fused`,
`_kernel`) for the sym_int4 format. The CUDA source is
`csrc/qmatmul_sym_int4.cu`; its header note says what bounds each form on
the card and what the design does about it. Two kernels split the TPU
kernel's two shape classes at `GEMV_MAX_ROWS` rows: a GEMV for decode and
a tensor-core GEMM for prefill.

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
