"""Fused sym_int4 dequant dx: wrapper, plain version and launch count.

Port of bigdl_tpu/ops/pallas/qbackward.py (`qmatmul_dx`, `_dxmm`,
`_dx_kernel`) for the sym_int4 format: dx = g @ dequant(W), the backward
of the frozen quantized projection. The CUDA source is
`csrc/qbackward_sym_int4.cu`; its header note says what bounds it on the
card and what the design does about it. The wrapper takes any number of
rows: JAX's dx has no GEMV/GEMM split. `_dw_kernel` (dW = g^T @ x) is on
no path of the JAX package and stays to port (ROADMAP queue 2).

The wrapper dispatches on the tensor's device: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.ops.kernels._build import Kernel
from bigdl_tpu_torch.quant.numerics import dequantize_blockwise
from bigdl_tpu_torch.quant.qtypes import resolve_qtype

# (g, data, scales, dx, M, K, O)
DX = Kernel("qmatmul_sym_int4_dx", "qbackward_sym_int4", "ppppiii",
            replaces="bigdl_tpu/ops/pallas/qbackward.py:68")

_SYM_INT4 = resolve_qtype("sym_int4")


def qmatmul_dx_plain(g: torch.Tensor, data: torch.Tensor,
                     scales: torch.Tensor) -> torch.Tensor:
    """dx[..., K] = g @ dequant(W) with the kernel's arithmetic: weights
    decode as (code - 8) * scale in f32 rounded to bf16, g is rounded to
    bf16, products sum in f32 and dx rounds to bf16."""
    O = g.shape[-1]
    w = dequantize_blockwise(data, scales, _SYM_INT4, torch.bfloat16)
    dx = torch.matmul(g.reshape(-1, O).to(torch.bfloat16).float(), w.float())
    return dx.to(torch.bfloat16).reshape(*g.shape[:-1], w.shape[1])


def _check(g: torch.Tensor, data: torch.Tensor, scales: torch.Tensor) -> None:
    O = g.shape[-1]
    K = data.shape[-1] * 2
    if g.dtype != torch.bfloat16:
        raise TypeError(f"qmatmul_dx: g must be bfloat16, got {g.dtype}")
    if data.dtype != torch.uint8 or scales.dtype != torch.float16:
        raise TypeError("qmatmul_dx: data must be uint8 and scales float16, "
                        f"got {data.dtype} / {scales.dtype}")
    if data.dim() != 2 or data.shape[0] != O or scales.shape != (O, K // 32):
        raise ValueError(f"qmatmul_dx: shapes g {tuple(g.shape)}, data "
                         f"{tuple(data.shape)}, scales {tuple(scales.shape)} "
                         "do not describe one [O, K] sym_int4 weight")
    if K % 64 or O % 8:
        raise ValueError(f"qmatmul_dx: K={K} must be a multiple of 64 and "
                         f"O={O} of 8")
    # g rows and the packed rows are read in 16-byte vectors
    for name, t, align in (("g", g, 16), ("data", data, 16), ("scales", scales, 2)):
        if t.device != g.device:
            raise ValueError(f"qmatmul_dx: {name} is on {t.device}, g on {g.device}")
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"qmatmul_dx: {name} must be contiguous and "
                             f"{align}-byte aligned")


def qmatmul_dx(g: torch.Tensor, data: torch.Tensor,
               scales: torch.Tensor) -> torch.Tensor:
    """dx[..., K] = g @ dequant(W) for a sym_int4 weight's fields: g
    [..., O] bf16, data [O, K/2] uint8 (half-split), scales [O, K/32]
    float16; returns bf16 [..., K]."""
    if g.device.type == "cpu":
        return qmatmul_dx_plain(g, data, scales)
    if g.device.type != "cuda":
        raise NotImplementedError(f"qmatmul_dx: no kernel for {g.device}")
    _check(g, data, scales)
    O = g.shape[-1]
    K = data.shape[1] * 2
    g2 = g.reshape(-1, O)
    M = g2.shape[0]
    dx = torch.empty((M, K), dtype=torch.bfloat16, device=g.device)
    if M:
        DX(g2, data, scales, dx, M, K, O, device=g.device)
    return dx.reshape(*g.shape[:-1], K)
