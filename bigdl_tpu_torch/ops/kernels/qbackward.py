"""Fused dequant dx for every weight format: wrapper, plain version and
launch count.

Port of bigdl_tpu/ops/pallas/qbackward.py (`qmatmul_dx`, `_dxmm`,
`_dx_kernel`): dx = g @ dequant(W), the backward of the frozen quantized
projection. The CUDA source is `csrc/qbackward.cu`, built once per qtype;
its header note says what bounds it on the card and what the design does
about it. The wrapper takes any number of rows (JAX's dx has no GEMV/GEMM
split); `qtile.dx_tile` chooses the tile. `_dw_kernel` (dW = g^T @ x) is
ported in `dw_matmul`.

The wrapper dispatches on the tensor's device: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.ops.kernels._build import Kernel
from bigdl_tpu_torch.ops.kernels.qmatmul import kernel_fields
from bigdl_tpu_torch.ops.kernels.qtile import dx_tile
from bigdl_tpu_torch.quant import QTensor

# (g, data, scales, mins, sub_scales, sub_mins, dx, M, K, O, bm, bn,
#  stages, smem): the tile of qtile.dx_tile
DX = Kernel("qmatmul_dx", "qbackward", "pppppppiiiiiii",
            replaces="bigdl_tpu/ops/pallas/qbackward.py:68", per_format=True)


def qmatmul_dx_plain(g: torch.Tensor, w: QTensor) -> torch.Tensor:
    """dx[..., K] = g @ dequant(W) with the kernel's arithmetic: weights
    decode in f32 and round to bf16, g is rounded to bf16, products sum in
    f32 and dx rounds to bf16."""
    O = g.shape[-1]
    wd = w.dequantize(torch.bfloat16)
    dx = torch.matmul(g.reshape(-1, O).to(torch.bfloat16).float(), wd.float())
    return dx.to(torch.bfloat16).reshape(*g.shape[:-1], wd.shape[1])


def qmatmul_dx(g: torch.Tensor, w: QTensor) -> torch.Tensor:
    """dx[..., K] = g @ dequant(W): g [..., O] bf16, w a QTensor [O, K]
    with O % 8 == 0; returns bf16 [..., K]."""
    if g.device.type == "cpu":
        return qmatmul_dx_plain(g, w)
    if g.device.type != "cuda":
        raise NotImplementedError(f"qmatmul_dx: no kernel for {g.device}")
    O = g.shape[-1]
    K = w.shape[-1]
    fields = kernel_fields(w, K, g.device, "qmatmul_dx")
    if w.data.shape[0] != O or O % 8:
        raise ValueError(f"qmatmul_dx: g {tuple(g.shape)} against a weight of "
                         f"{w.data.shape[0]} rows; O must match and be a multiple of 8")
    g2 = g.reshape(-1, O)
    # g rows are read in 16-byte vectors
    if g2.dtype != torch.bfloat16:
        raise TypeError(f"qmatmul_dx: g must be bfloat16, got {g2.dtype}")
    if not g2.is_contiguous() or g2.data_ptr() % 16:
        raise ValueError("qmatmul_dx: g must be contiguous and 16-byte aligned")
    M = g2.shape[0]
    dx = torch.empty((M, K), dtype=torch.bfloat16, device=g.device)
    if M:
        t = dx_tile(M, O, K, w.qtype)
        DX(g2, *fields, dx, M, K, O, t.bm, t.bn, t.stages, t.smem, device=g.device,
           qtype=w.qtype)
    return dx.reshape(*g.shape[:-1], K)
