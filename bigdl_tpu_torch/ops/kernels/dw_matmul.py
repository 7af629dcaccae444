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
plain version, a CUDA tensor launches a kernel or raises. On the card
`dw_variant` picks one of two kernels by shape, both counted on `DW`: the
persistent TMA + wgmma kernel, which walks the 128 x 256 tiles of dW in
the order `dw_tile` gives, wherever TMA can read g and x, else the
mma.sync kernel with scalar loads.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.ops.kernels._build import Kernel, sm_count

# (g, x, dw, M, O, K, out_f32, tma, sms)
DW = Kernel("dw_matmul", "dw_matmul", "pppiiiiii",
            replaces="bigdl_tpu/ops/pallas/qbackward.py:190")

_OUT_DTYPES = (torch.bfloat16, torch.float32)

TILE_O, TILE_K = 128, 256  # the wgmma kernel's tile of dW (csrc/dw_matmul.cu kBO, kBK)
GROUP_O = 8  # o-blocks side by side in its tile order (kGroupO)


def dw_variant(O: int, K: int, g_ptr: int, x_ptr: int) -> str:
    """"tma" (the wgmma kernel) where TMA can read both operands: rows of
    16-byte multiples (O and K multiples of 8) from 16-byte aligned bases;
    else "any" (the mma.sync kernel, scalar loads)."""
    ok = O % 8 == 0 and K % 8 == 0 and g_ptr % 16 == 0 and x_ptr % 16 == 0
    return "tma" if ok else "any"


def dw_tile(t: int, O: int, K: int) -> tuple[int, int]:
    """The first dW row and column of the wgmma kernel's tile t: groups of
    GROUP_O o-blocks, the o-block fastest within a group, so the tiles at
    work at once share x's column panels and a few of g's."""
    no, nk = -(-O // TILE_O), -(-K // TILE_K)
    group, r = divmod(t, GROUP_O * nk)
    go = min(GROUP_O, no - group * GROUP_O)
    return (group * GROUP_O + r % go) * TILE_O, (r // go) * TILE_K


def dw_schedule(O: int, K: int, sms: int) -> list[list[tuple[int, int]]]:
    """The persistent grid's walk: block b takes tiles b, b + grid, ...
    (grid = min(tiles, sms)); [block][tile origins in its order]."""
    tiles = -(-O // TILE_O) * -(-K // TILE_K)
    grid = min(tiles, sms)
    return [[dw_tile(t, O, K) for t in range(b, tiles, grid)] for b in range(grid)]



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
        tma = dw_variant(O, K, g2.data_ptr(), x2.data_ptr()) == "tma"
        DW(g2, x2, dw, M, O, K, int(out_dtype == torch.float32), int(tma),
           sm_count(g.device.index or 0), device=g.device)
    return dw
