"""Hand-written CUDA kernels of the port (counterparts of the Pallas
kernels in bigdl_tpu/ops/pallas). Importing this package builds nothing:
sources compile at the first launch (`_build.py`)."""

from bigdl_tpu_torch.ops.kernels.flash_attention import (
    FLASH, flash_attention, flash_attention_plain,
)
from bigdl_tpu_torch.ops.kernels.flash_backward import (
    FLASH_DKV, FLASH_DQ, FLASH_FWD, flash_attention_train,
    flash_attention_train_bwd_plain, flash_attention_train_plain,
    flash_train_dkv, flash_train_dkv_plain, flash_train_dq,
    flash_train_dq_plain, flash_train_fwd,
)
from bigdl_tpu_torch.ops.kernels.qbackward import (
    DX, qmatmul_dx, qmatmul_dx_plain,
)
from bigdl_tpu_torch.ops.kernels.qmatmul import (
    GEMM, GEMV, GEMV_MAX_ROWS, LORA_GEMM, LORA_MAX_RANK, qmatmul_int4,
    qmatmul_int4_lora, qmatmul_int4_lora_plain, qmatmul_int4_plain,
)

# every kernel of the port, in the order the main paths first run them:
# generation (prefill, decode), then a training step (forward, backward)
KERNELS = (GEMM, FLASH, GEMV, FLASH_FWD, LORA_GEMM, DX, FLASH_DQ, FLASH_DKV)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}


__all__ = ["DX", "FLASH", "FLASH_DKV", "FLASH_DQ", "FLASH_FWD", "GEMM", "GEMV",
           "GEMV_MAX_ROWS", "KERNELS", "LORA_GEMM", "LORA_MAX_RANK",
           "flash_attention", "flash_attention_plain",
           "flash_attention_train", "flash_attention_train_bwd_plain",
           "flash_attention_train_plain", "flash_train_dkv",
           "flash_train_dkv_plain", "flash_train_dq", "flash_train_dq_plain",
           "flash_train_fwd", "launch_counts", "qmatmul_dx", "qmatmul_dx_plain",
           "qmatmul_int4", "qmatmul_int4_lora", "qmatmul_int4_lora_plain",
           "qmatmul_int4_plain", "reset_launches"]
