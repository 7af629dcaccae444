"""Hand-written CUDA kernels of the port (counterparts of the Pallas
kernels in bigdl_tpu/ops/pallas). Importing this package builds nothing:
sources compile at the first launch (`_build.py`)."""

from bigdl_tpu_torch.ops.kernels.flash_attention import (
    FLASH, flash_attention, flash_attention_plain,
)
from bigdl_tpu_torch.ops.kernels.qmatmul import (
    GEMM, GEMV, GEMV_MAX_ROWS, qmatmul_int4, qmatmul_int4_plain,
)

# every kernel of the port, in the order the main path first runs them
KERNELS = (GEMM, FLASH, GEMV)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}


__all__ = ["FLASH", "GEMM", "GEMV", "GEMV_MAX_ROWS", "KERNELS",
           "flash_attention", "flash_attention_plain", "launch_counts",
           "qmatmul_int4", "qmatmul_int4_plain", "reset_launches"]
