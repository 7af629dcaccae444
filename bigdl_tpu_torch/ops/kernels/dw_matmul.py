"""Weight gradient of a dense projection: wrapper, plain version and
launch count.

Port of bigdl_tpu/ops/pallas/qbackward.py (`dw_matmul`, `_dwmm`,
`_dw_kernel`): dW[O, K] = g^T @ x for y = x @ W^T, the weight-shaped
gradient of every dense weight that trains (ops/linear.py's
`_DenseMatmul`, the full fine-tune's path). g and x are cast to bf16,
products sum in f32 over all rows, and dW rounds once to `out_dtype`. The
CUDA source is `csrc/dw_matmul.cu`, built once (no weight format is
involved); its header note says what bounds it on the card and what the
design does about it.

The wrapper dispatches on the tensor's device: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.ops.kernels._build import Kernel

# (g, x, dw, M, O, K, out_f32, vec)
DW = Kernel("dw_matmul", "dw_matmul", "pppiiiii",
            replaces="bigdl_tpu/ops/pallas/qbackward.py:190")

_OUT_DTYPES = (torch.bfloat16, torch.float32)


def _flatten(g: torch.Tensor, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """g [..., O] and x [..., K] with equal leading dims, as [M, O] and
    [M, K] rows."""
    if g.shape[:-1] != x.shape[:-1]:
        raise ValueError(f"dw_matmul: leading dims of g {tuple(g.shape)} and "
                         f"x {tuple(x.shape)} differ")
    return g.reshape(-1, g.shape[-1]), x.reshape(-1, x.shape[-1])


def dw_matmul_plain(g: torch.Tensor, x: torch.Tensor,
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """dW[O, K] = g^T @ x with the kernel's arithmetic: both operands
    rounded to bf16, products summed in f32, one cast to `out_dtype`."""
    g2, x2 = _flatten(g, x)
    dw = torch.einsum("mo,mk->ok", g2.to(torch.bfloat16).float(),
                      x2.to(torch.bfloat16).float())
    return dw.to(out_dtype)


def dw_matmul(g: torch.Tensor, x: torch.Tensor,
              out_dtype=torch.bfloat16) -> torch.Tensor:
    """dW[O, K] = g^T @ x: g [..., O], x [..., K] of any float type (cast
    to bf16), leading dims flattened to the shared row axis; returns
    `out_dtype` (bf16 or f32) [O, K]."""
    if g.device.type == "cpu":
        return dw_matmul_plain(g, x, out_dtype)
    if g.device.type != "cuda" or x.device != g.device:
        raise NotImplementedError(f"dw_matmul: no kernel for g on {g.device}, "
                                  f"x on {x.device}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"dw_matmul: out_dtype must be bfloat16 or float32, got {out_dtype}")
    g2, x2 = _flatten(g, x)
    g2 = g2.to(torch.bfloat16).contiguous()
    x2 = x2.to(torch.bfloat16).contiguous()
    (M, O), K = g2.shape, x2.shape[1]
    dw = torch.empty((O, K), dtype=out_dtype, device=g.device)
    if M == 0:
        return dw.zero_()
    if O and K:
        # 16-byte pieces where every row starts on a 16-byte boundary
        vec = int(O % 8 == 0 and K % 8 == 0 and g2.data_ptr() % 16 == 0
                  and x2.data_ptr() % 16 == 0)
        DW(g2, x2, dw, M, O, K, int(out_dtype == torch.float32), vec, device=g.device)
    return dw
