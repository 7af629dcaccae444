"""bigdl_tpu_torch dequant-matmul for every weight format: the plain
version against the JAX Pallas kernel (interpret mode) and the linear
dispatch rules against the JAX package's. The CUDA kernels against the
plain version are in test_torch_gpu.py."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.pallas.qmatmul import qmatmul as jax_qmatmul
from bigdl_tpu.quant import quantize as jquantize
from bigdl_tpu.quant.qtypes import qtype_registry
from bigdl_tpu_torch.ops import kernels, linear
from bigdl_tpu_torch.quant import ARRAY_FIELDS, QTensor, quantize

torch.set_num_threads(1)

# Both sides decode each weight in f32 and round it to bf16 (the same
# bits), sum bf16 x bf16 products in f32 (in different orders) and round
# the output to bf16 once: outputs may differ by one bf16 rounding step,
# i.e. up to 2^-8 relative, plus f32 reordering far below that.
_ULPS = 2 ** -7
QTYPES = [n for n, s in qtype_registry().items() if not s.is_dense]

# the modules, not the `linear` functions that ops/__init__ export
linear_mod = importlib.import_module("bigdl_tpu_torch.ops.linear")
jax_linear_mod = importlib.import_module("bigdl_tpu.ops.linear")


def _within_bf16_ulps(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    bound = _ULPS * np.abs(ref) + 1e-6 * np.abs(ref).max()
    assert np.all(np.abs(got - ref) <= bound), np.abs(got - ref).max()


def to_torch(qt) -> QTensor:
    """A JAX QTensor's fields as the port's QTensor (fp8 codes through
    their bytes)."""
    fields = {}
    for f in ARRAY_FIELDS:
        a = getattr(qt, f)
        if a is not None:
            a = np.array(a)
            fields[f] = (torch.from_numpy(a.view(np.uint8)).view(getattr(torch, a.dtype.name))
                         if a.dtype.name.startswith("float8") else torch.from_numpy(a))
    return QTensor(qtype=qt.qtype, **fields)


def _operands(M, O, K, seed, qtype="sym_int4"):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(O, K)) * 0.05).astype(np.float32)
    x = rng.normal(size=(M, K)).astype(np.float32)
    qt = jquantize(jnp.asarray(w), qtype)
    return x, qt


@pytest.mark.parametrize("K", [256, 1024, 4096])
@pytest.mark.parametrize("O", [128, 384])
@pytest.mark.parametrize("M", [1, 4, 32, 33, 128])
def test_plain_matches_pallas_interpret(M, O, K):
    x, qt = _operands(M, O, K, M * 7 + O + K)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = jax_qmatmul(xb, qt, interpret=True)
    got = kernels.qmatmul(torch.from_numpy(x).to(torch.bfloat16), to_torch(qt))
    assert got.dtype == torch.bfloat16 and got.shape == (M, O)
    _within_bf16_ulps(got.float().numpy(), ref)


@pytest.mark.parametrize("M", [4, 33])
@pytest.mark.parametrize("qtype", [q for q in QTYPES if q != "sym_int4"])
def test_formats_plain_matches_pallas_interpret(qtype, M):
    """Every other format at a decode (GEMV) and a prefill (GEMM) row
    count: K = 1024 is a multiple of every format's k_multiple."""
    O, K = 256, 1024
    x, qt = _operands(M, O, K, M + len(qtype), qtype)
    ref = jax_qmatmul(jnp.asarray(x, jnp.bfloat16), qt, interpret=True)
    got = kernels.qmatmul(torch.from_numpy(x).to(torch.bfloat16), to_torch(qt))
    assert got.dtype == torch.bfloat16 and got.shape == (M, O)
    _within_bf16_ulps(got.float().numpy(), ref)


def test_dispatch_table_matches_jax():
    """One fused kernel per quantized format, eligible at JAX's
    k_multiple for each."""
    assert kernels.K_MULTIPLE == {q: e.k_multiple for q, e in
                                  jax_linear_mod._QGEMV_QTYPES.items()}
    assert sorted(kernels.K_MULTIPLE) == sorted(QTYPES)


def test_linear_dispatch_follows_jax_rules():
    """Kernel-eligible shapes (O % 128 == 0, K % k_multiple == 0) route to
    the fused kernel; others dequantize and multiply, as JAX's XLA path."""
    def qt(O, K, qtype="sym_int4"):
        return quantize(torch.randn(O, K) * 0.05, qtype)

    x = torch.zeros(2, 3, 256)
    assert linear_mod._fused_kernel(x, qt(384, 256))
    assert not linear_mod._fused_kernel(x, qt(200, 256))  # O % 128
    assert not linear_mod._fused_kernel(torch.zeros(1, 96), qt(128, 96))  # K % 64
    assert linear_mod._fused_kernel(x, qt(128, 256, "q4_k"))
    assert not linear_mod._fused_kernel(x, qt(128, 256, "q5_k"))  # K % 1024


@pytest.mark.parametrize("O,K,qtype", [(384, 256, "sym_int4"), (96, 64, "sym_int4"),
                                       (128, 512, "q2_k"), (128, 256, "nf3")])
def test_linear_matches_jax_linear(O, K, qtype):
    """The port's linear (kernel plain version, or dequant path) against
    the JAX package's linear on its CPU (XLA dequant) path."""
    from bigdl_tpu.ops.linear import linear as jax_linear

    x, qt = _operands(5, O, K, O + K, qtype)
    x3 = x.reshape(1, 5, K)
    ref = jax_linear(jnp.asarray(x3), qt)
    got = linear(torch.from_numpy(x3), to_torch(qt))
    _within_bf16_ulps(got.float().numpy(), ref)


def test_cpu_tensor_takes_plain_version_without_launch():
    kernels.reset_launches()
    w = quantize(torch.randn(128, 128) * 0.05, "sym_int4")
    x = torch.randn(40, 128).to(torch.bfloat16)
    y = kernels.qmatmul(x, w)
    torch.testing.assert_close(y, kernels.qmatmul_plain(x, w), rtol=0, atol=0)
    assert kernels.launch_counts() == {k.name: 0 for k in kernels.KERNELS}
    assert kernels.format_launch_counts() == {k.name: {} for k in kernels.KERNELS
                                              if k.per_format}

