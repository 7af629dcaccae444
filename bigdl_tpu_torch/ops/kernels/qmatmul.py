"""Fused dequant-matmul for every weight format: wrappers, plain versions
and launch counts.

Port of bigdl_tpu/ops/pallas/qmatmul.py (`qmatmul`, `qmatmul_lora`,
`_fused`, `_kernel`). The CUDA source is `csrc/qmatmul.cu`, built once per
qtype (ops/kernels/_build.py); its header note says what bounds each form
on the card and what the design does about it, and `csrc/qdecode.cuh`
holds every format's decode. Two kernels split the TPU kernel's two shape
classes at `GEMV_MAX_ROWS` rows: a GEMV for decode and a tensor-core GEMM
for prefill, whose tile `qtile.gemm_tile` chooses. `_kernel`'s LoRA
epilogue (`qmatmul_lora`) has the same two forms, the LoRA GEMV (serving
decode steps, short prefill tails) and the LoRA GEMM (prefill, training),
for any adapter width R that the JAX package's `lora_fused_ok` admits
(copied here with its constants).

The wrappers take a `QTensor` of any quantized qtype whose contraction
dim is a multiple of the format's `K_MULTIPLE` and dispatch on the
tensor's device: a CPU tensor takes the plain version, a CUDA tensor
launches a kernel or raises.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.ops.kernels._build import Kernel
from bigdl_tpu_torch.ops.kernels.qtile import gemm_tile, plane_split
from bigdl_tpu_torch.quant import QTensor

GEMV_MAX_ROWS = 32  # ops/linear.py _GEMV_MAX_ROWS in the JAX package

_REPLACES = "bigdl_tpu/ops/pallas/qmatmul.py:90"
# (x, data, scales, mins, sub_scales, sub_mins, out, M, K, O)
GEMV = Kernel("qmatmul_gemv", "qmatmul", "pppppppiii", replaces=_REPLACES,
              per_format=True)
# (x, xo scratch for x in the GEMM's order (None where S = 1), data,
#  scales, mins, sub_scales, sub_mins, out, M, K, O, bm, bn, stages, smem):
#  the tile of qtile.gemm_tile
GEMM = Kernel("qmatmul_gemm", "qmatmul", "ppppppppiiiiiii", replaces=_REPLACES,
              per_format=True)
# (x, data, scales, mins, sub_scales, sub_mins, a_cat, b_cat, gate, xg
#  scratch, out, M, K, O, R); the LoRA GEMM with xo after x and bm, bn,
#  stages, smem at the end
LORA_GEMV = Kernel("qmatmul_gemv_lora", "qmatmul", "pppppppppppiiii",
                   replaces=_REPLACES, per_format=True)
LORA_GEMM = Kernel("qmatmul_gemm_lora", "qmatmul", "ppppppppppppiiiiiiii",
                   replaces=_REPLACES, per_format=True)

# The fused epilogue's eligibility, copied from bigdl_tpu/ops/pallas/
# tiling.py so that the port fuses exactly where JAX does: bytes per
# element of the LoRA operands, and their share of the TPU kernel's VMEM.
LORA_BPE = 2
LORA_VMEM_CAP = 4 * 1024 * 1024


def lora_operand_bytes(R: int, K: int, O_block: int, M_block: int) -> int:
    """The TPU kernel's VMEM for the epilogue's operands: A_cat [R, K], a
    B_cat tile [O_block, R], a gate tile [M_block, R] and the f32 xa
    [M_block, R]."""
    return (R * K * LORA_BPE + O_block * R * LORA_BPE
            + M_block * R * LORA_BPE + M_block * R * 4)


def lora_fused_ok(R: int, K: int) -> bool:
    """Whether R adapter columns over a K-wide contraction take the fused
    epilogue (at the largest tiles, 256 x 256); else the epilogue runs
    unfused after the base kernel."""
    return R > 0 and lora_operand_bytes(R, K, 256, 256) <= LORA_VMEM_CAP

# The contraction dims the kernels take, per qtype: the JAX package's
# k_multiple (bigdl_tpu/ops/linear.py _QGEMV_QTYPES): whole quant blocks
# per packed plane, whole super-blocks, and the finest plane split's
# alignment. Here they also keep every plane and row 16-byte aligned.
K_MULTIPLE = {
    "sym_int4": 64, "asym_int4": 64, "nf4": 128, "fp4": 128,
    "sym_int8": 32, "asym_int5": 32, "fp8_e4m3": 128, "fp8_e5m2": 128,
    "sym_int5": 1024, "fp6": 512, "nf3": 1024,
    "q2_k": 512, "q3_k": 256, "q4_k": 256, "q5_k": 1024, "q6_k": 256,
}

_DATA_DTYPE = {"packed_u8": torch.uint8, "packed_planes": torch.uint8,
               "int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn,
               "fp8_e5m2": torch.float8_e5m2}


def kernel_fields(w: QTensor, K: int, device: torch.device, who: str) -> list:
    """The weight's five fields in the kernels' argument order (None where
    the format has none, fp8 codes as their uint8 view), after checking
    that they describe one [O, K] weight the kernels take."""
    spec = w.spec
    if w.qtype not in K_MULTIPLE:
        raise ValueError(f"{who}: qtype {w.qtype} has no kernel")
    if K % K_MULTIPLE[w.qtype]:
        raise ValueError(f"{who}: K={K} is not a multiple of {K_MULTIPLE[w.qtype]} "
                         f"({w.qtype})")
    data = w.data
    O = data.shape[0] if data.dim() == 2 else -1
    nb = K // spec.block_size
    nsup = K // spec.superblock if spec.superblock else nb
    shapes = {"data": (O, K * spec.bits // 8 if spec.storage.startswith("packed") else K),
              "scales": (O, nsup)}
    dtypes = {"data": _DATA_DTYPE[spec.storage], "scales": torch.float16}
    if spec.asymmetric:
        shapes["mins"], dtypes["mins"] = (O, nsup), torch.float16
    if spec.superblock:
        shapes["sub_scales"] = (O, nb)
        dtypes["sub_scales"] = torch.int8 if spec.storage == "int8" else torch.uint8
        if spec.asymmetric:
            shapes["sub_mins"], dtypes["sub_mins"] = (O, nb), torch.uint8
    got = w.fields()
    if set(got) != set(shapes) or any(
            tuple(got[f].shape) != shapes[f] or got[f].dtype != dtypes[f] for f in shapes):
        raise ValueError(f"{who}: fields { {f: (tuple(t.shape), t.dtype) for f, t in got.items()} } "
                         f"do not describe one [O, {K}] {w.qtype} weight; want "
                         f"{ {f: (shapes[f], dtypes[f]) for f in shapes} }")
    # packed rows are read in 16-byte vectors, scales one by one
    for name, t in got.items():
        if t.device != device:
            raise ValueError(f"{who}: {name} is on {t.device}, the input on {device}")
        align = 16 if name == "data" else t.element_size()
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"{who}: {name} must be contiguous and {align}-byte aligned")
    if data.dtype.is_floating_point:
        got["data"] = data.view(torch.uint8)
    return [got.get(f) for f in ("data", "scales", "mins", "sub_scales", "sub_mins")]


def _check_x(x: torch.Tensor, who: str) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{who}: x must be bfloat16, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{who}: x must be contiguous and 16-byte aligned")


def _x_order_scratch(x2: torch.Tensor, qtype: str):
    """The GEMM's scratch for x in its steps' order (csrc/qmatmul.cu
    x_order_kernel), None where the format's order is K's own (S = 1)."""
    return torch.empty_like(x2) if plane_split(qtype)[0] > 1 else None


def qmatmul_plain(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """y[..., O] = x @ dequant(W)^T with the kernels' arithmetic: weights
    decode in f32 and round to bf16 (QTensor.dequantize), x is rounded to
    bf16, products sum in f32 and the result rounds to bf16."""
    K = x.shape[-1]
    wd = w.dequantize(torch.bfloat16)
    y = torch.matmul(x.reshape(-1, K).to(torch.bfloat16).float(), wd.float().t())
    return y.to(torch.bfloat16).reshape(*x.shape[:-1], wd.shape[0])


def qmatmul(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """y[..., O] = x @ dequant(W)^T: x [..., K] bf16, w a QTensor [O, K];
    returns bf16 [..., O]. Rows <= GEMV_MAX_ROWS launch the GEMV, more rows
    the GEMM."""
    if x.device.type == "cpu":
        return qmatmul_plain(x, w)
    if x.device.type != "cuda":
        raise NotImplementedError(f"qmatmul: no kernel for {x.device}")
    K = x.shape[-1]
    fields = kernel_fields(w, K, x.device, "qmatmul")
    x2 = x.reshape(-1, K)
    _check_x(x2, "qmatmul")
    M, O = x2.shape[0], w.data.shape[0]
    out = torch.empty((M, O), dtype=torch.bfloat16, device=x.device)
    if 0 < M <= GEMV_MAX_ROWS:
        GEMV(x2, *fields, out, M, K, O, device=x.device, qtype=w.qtype)
    elif M:
        t = gemm_tile(M, O, K, w.qtype)
        GEMM(x2, _x_order_scratch(x2, w.qtype), *fields, out, M, K, O, t.bm, t.bn, t.stages,
             t.smem, device=x.device, qtype=w.qtype)
    return out.reshape(*x.shape[:-1], O)


def qmatmul_lora_plain(x: torch.Tensor, w: QTensor, a_cat: torch.Tensor,
                       b_cat: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """y = x @ dequant(W)^T + bf16((x @ A_cat^T) * gate) @ B_cat^T with the
    kernel's rounding: bf16 operands, f32 sums, xa * gate rounded to bf16
    before its product with B_cat, the sum rounded to bf16 once."""
    K = x.shape[-1]
    wd = w.dequantize(torch.bfloat16)
    xf = x.reshape(-1, K).to(torch.bfloat16).float()
    acc = torch.matmul(xf, wd.float().t())
    xa = torch.matmul(xf, a_cat.to(torch.bfloat16).float().t())
    xa = (xa * gate.to(torch.bfloat16).float()).to(torch.bfloat16)
    acc = acc + torch.matmul(xa.float(), b_cat.to(torch.bfloat16).float().t())
    return acc.to(torch.bfloat16).reshape(*x.shape[:-1], wd.shape[0])


def qmatmul_lora(x: torch.Tensor, w: QTensor, a_cat: torch.Tensor,
                 b_cat: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """`qmatmul` with the LoRA epilogue folded into the writeback:
    y = x @ dq(W)^T + bf16((x @ A_cat^T) * gate) @ B_cat^T. x [..., K]
    bf16; a_cat [R, K], b_cat [O, R], gate [M, R] bf16 with
    `lora_fused_ok(R, K)`; returns bf16 [..., O]. Rows <= GEMV_MAX_ROWS
    launch the LoRA GEMV, more rows the LoRA GEMM."""
    if x.device.type == "cpu":
        return qmatmul_lora_plain(x, w, a_cat, b_cat, gate)
    if x.device.type != "cuda":
        raise NotImplementedError(f"qmatmul_lora: no kernel for {x.device}")
    K = x.shape[-1]
    fields = kernel_fields(w, K, x.device, "qmatmul_lora")
    x2 = x.reshape(-1, K)
    _check_x(x2, "qmatmul_lora")
    M, O = x2.shape[0], w.data.shape[0]
    R = a_cat.shape[0]
    if not lora_fused_ok(R, K):
        raise ValueError(f"qmatmul_lora: R={R} adapter columns at K={K} exceed "
                         "the fused epilogue's operand budget (lora_fused_ok)")
    if a_cat.shape != (R, K) or b_cat.shape != (O, R) or gate.shape != (M, R):
        raise ValueError(f"qmatmul_lora: a_cat {tuple(a_cat.shape)}, b_cat "
                         f"{tuple(b_cat.shape)}, gate {tuple(gate.shape)} do not "
                         f"match M={M} K={K} O={O} R={R}")
    # A_cat rows are read in 16-byte vectors, B_cat and the gate one by one
    for name, t, align in (("a_cat", a_cat, 16), ("b_cat", b_cat, 2), ("gate", gate, 2)):
        if t.dtype != torch.bfloat16 or t.device != x.device:
            raise TypeError(f"qmatmul_lora: {name} must be bfloat16 on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"qmatmul_lora: {name} must be contiguous and "
                             f"{align}-byte aligned")
    out = torch.empty((M, O), dtype=torch.bfloat16, device=x.device)
    if M:
        xg = torch.empty((M, R), dtype=torch.bfloat16, device=x.device)  # first pass
        args = (*fields, a_cat, b_cat, gate, xg, out, M, K, O, R)
        if M <= GEMV_MAX_ROWS:
            LORA_GEMV(x2, *args, device=x.device, qtype=w.qtype)
        else:
            t = gemm_tile(M, O, K, w.qtype)
            LORA_GEMM(x2, _x_order_scratch(x2, w.qtype), *args, t.bm, t.bn, t.stages, t.smem,
                      device=x.device, qtype=w.qtype)
    return out.reshape(*x.shape[:-1], O)
