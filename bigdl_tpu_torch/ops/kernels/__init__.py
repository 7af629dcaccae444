"""Hand-written CUDA kernels of the port (counterparts of the Pallas
kernels in bigdl_tpu/ops/pallas). Importing this package builds nothing:
sources compile at the first launch (`_build.py`)."""

from bigdl_tpu_torch.ops.kernels.dw_matmul import DW, dw_matmul, dw_matmul_plain
from bigdl_tpu_torch.ops.kernels.flash_attention import (
    FLASH, FLASH_FP8, flash_attention, flash_attention_plain,
)
from bigdl_tpu_torch.ops.kernels.flash_backward import (
    FLASH_DKV, FLASH_DQ, FLASH_FWD, flash_attention_train,
    flash_attention_train_bwd_plain, flash_attention_train_plain,
    flash_train_dkv, flash_train_dkv_plain, flash_train_dq,
    flash_train_dq_plain, flash_train_fwd,
)
from bigdl_tpu_torch.ops.kernels.paged_attention import (
    PAGED, PAGED_FP8, paged_attention, paged_attention_plain,
)
from bigdl_tpu_torch.ops.kernels.qbackward import (
    DX, qmatmul_dx, qmatmul_dx_plain,
)
from bigdl_tpu_torch.ops.kernels.qmatmul import (
    GEMM, GEMV, GEMV_MAX_ROWS, K_MULTIPLE, LORA_GEMM, LORA_GEMV, lora_fused_ok,
    qmatmul, qmatmul_lora, qmatmul_lora_plain, qmatmul_plain,
)

# every kernel of the port, in the order the main paths first run them:
# generation (prefill, decode), a training step (forward, backward), then
# serving (paged decode, bf16 and fp8 pages; the dense fp8 pool's prefill;
# adapter decode steps), then the full fine-tune's weight gradients
KERNELS = (GEMM, FLASH, GEMV, FLASH_FWD, LORA_GEMM, DX, FLASH_DQ, FLASH_DKV,
           PAGED, PAGED_FP8, FLASH_FP8, LORA_GEMV, DW)


def reset_launches() -> None:
    for k in KERNELS:
        k.reset()


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}


def format_launch_counts() -> dict:
    """{kernel name: {qtype: launches}} of the per-format kernels."""
    return {k.name: dict(k.by_format) for k in KERNELS if k.per_format}


__all__ = ["DW", "DX", "FLASH", "FLASH_DKV", "FLASH_DQ", "FLASH_FP8", "FLASH_FWD",
           "GEMM", "GEMV", "GEMV_MAX_ROWS", "KERNELS", "K_MULTIPLE", "LORA_GEMM",
           "LORA_GEMV", "PAGED", "PAGED_FP8", "dw_matmul", "dw_matmul_plain",
           "format_launch_counts",
           "flash_attention", "flash_attention_plain",
           "flash_attention_train", "flash_attention_train_bwd_plain",
           "flash_attention_train_plain", "flash_train_dkv",
           "flash_train_dkv_plain", "flash_train_dq", "flash_train_dq_plain",
           "flash_train_fwd", "launch_counts", "lora_fused_ok", "paged_attention",
           "paged_attention_plain",
           "qmatmul", "qmatmul_dx", "qmatmul_dx_plain", "qmatmul_lora",
           "qmatmul_lora_plain", "qmatmul_plain", "reset_launches"]
