"""bigdl_tpu_torch sym_int4 dequant-matmul: the plain version against the
JAX Pallas kernel (interpret mode) and the linear dispatch rules against
the JAX package's. The CUDA kernels against the plain version are in
test_torch_gpu.py."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.pallas.qmatmul import qmatmul_int4 as jax_qmatmul_int4
from bigdl_tpu.quant import quantize as jquantize
from bigdl_tpu_torch.ops import kernels, linear
from bigdl_tpu_torch.quant import QTensor, quantize

# Both sides decode (code - 8) * scale in f32, round the weight to bf16,
# sum bf16 x bf16 products in f32 (in different orders) and round the
# output to bf16 once: outputs may differ by one bf16 rounding step, i.e.
# up to 2^-8 relative, plus f32 reordering far below that.
_ULPS = 2 ** -7

# the module, not the `linear` function that ops/__init__ exports
linear_mod = importlib.import_module("bigdl_tpu_torch.ops.linear")


def _within_bf16_ulps(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    bound = _ULPS * np.abs(ref) + 1e-6 * np.abs(ref).max()
    assert np.all(np.abs(got - ref) <= bound), np.abs(got - ref).max()


def _operands(M, O, K, seed):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(O, K)) * 0.05).astype(np.float32)
    x = rng.normal(size=(M, K)).astype(np.float32)
    qt = jquantize(jnp.asarray(w), "sym_int4")
    return x, qt


@pytest.mark.parametrize("K", [256, 1024, 4096])
@pytest.mark.parametrize("O", [128, 384])
@pytest.mark.parametrize("M", [1, 4, 32, 33, 128])
def test_plain_matches_pallas_interpret(M, O, K):
    x, qt = _operands(M, O, K, M * 7 + O + K)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = jax_qmatmul_int4(xb, qt.data, qt.scales, interpret=True)
    got = kernels.qmatmul_int4(
        torch.from_numpy(x).to(torch.bfloat16),
        torch.from_numpy(np.array(qt.data)),
        torch.from_numpy(np.array(qt.scales)))
    assert got.dtype == torch.bfloat16 and got.shape == (M, O)
    _within_bf16_ulps(got.float().numpy(), ref)


def test_linear_dispatch_follows_jax_rules():
    """Kernel-eligible shapes (O % 128 == 0, K % 64 == 0) route to the
    fused kernel; others dequantize and multiply, as JAX's XLA path."""
    def qt(O, K):
        return quantize(torch.randn(O, K) * 0.05, "sym_int4")

    x = torch.zeros(2, 3, 256)
    assert linear_mod._fused_kernel(x, qt(384, 256)) is not None
    assert linear_mod._fused_kernel(x, qt(200, 256)) is None  # O % 128
    assert linear_mod._fused_kernel(torch.zeros(1, 96), qt(128, 96)) is None  # K % 64
    bad = QTensor(torch.zeros(128, 64, dtype=torch.uint8),
                  torch.zeros(128, 4, dtype=torch.float16), qtype="asym_int4")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        linear(torch.zeros(1, 128), bad)


@pytest.mark.parametrize("O,K", [(384, 256), (96, 64)])
def test_linear_matches_jax_linear(O, K):
    """The port's linear (kernel plain version, or dequant path) against
    the JAX package's linear on its CPU (XLA dequant) path."""
    from bigdl_tpu.ops.linear import linear as jax_linear

    x, qt = _operands(5, O, K, O + K)
    x3 = x.reshape(1, 5, K)
    ref = jax_linear(jnp.asarray(x3), qt)
    w = QTensor(torch.from_numpy(np.array(qt.data)),
                torch.from_numpy(np.array(qt.scales)), qtype="sym_int4")
    got = linear(torch.from_numpy(x3), w)
    _within_bf16_ulps(got.float().numpy(), ref)


def test_cpu_tensor_takes_plain_version_without_launch():
    kernels.reset_launches()
    w = quantize(torch.randn(128, 128) * 0.05, "sym_int4")
    x = torch.randn(40, 128).to(torch.bfloat16)
    y = kernels.qmatmul_int4(x, w.data, w.scales)
    torch.testing.assert_close(y, kernels.qmatmul_int4_plain(x, w.data, w.scales),
                               rtol=0, atol=0)
    assert kernels.launch_counts() == {k.name: 0 for k in kernels.KERNELS}

