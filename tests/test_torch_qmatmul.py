"""bigdl_tpu_torch dequant-matmul for every weight format: the plain
version against the JAX Pallas kernel (interpret mode) and the linear
dispatch rules against the JAX package's. The CUDA kernels against the
plain version are in test_torch_gpu.py."""

import importlib
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.pallas.qmatmul import qmatmul as jax_qmatmul
from bigdl_tpu.quant import quantize as jquantize
from bigdl_tpu.quant.qtypes import qtype_registry
from bigdl_tpu_torch import PRESETS
from bigdl_tpu_torch.ops import kernels, linear
from bigdl_tpu_torch.ops.kernels import qtile
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



def _gate(M, R, kind, rng):
    """A LoRA gate [M, R]: "dense" holds a scale in every column;
    "block" is the serving decode's block-diagonal form (row m carries
    its group's scale in its own R // M-wide group of columns, zero
    elsewhere), with its last row all zero (a base row) when M > 1."""
    if kind == "dense":
        return np.full((M, R), 2.0, np.float32)
    gate = np.zeros((M, R), np.float32)
    width = max(R // M, 1)
    for m in range(max(M - 1, 1)):
        gate[m, (m * width) % R:(m * width) % R + width] = rng.choice([0.5, 1.0, 2.0])
    return gate


@pytest.mark.parametrize("gate_kind", ["block", "dense"])
@pytest.mark.parametrize("R", [4, 48, 128])
@pytest.mark.parametrize("M", [1, 8, 32])
@pytest.mark.parametrize("qtype", ["sym_int4", "nf4", "fp6", "q4_k"])
def test_lora_gemv_plain_matches_pallas_interpret(qtype, M, R, gate_kind):
    """The LoRA epilogue at the GEMV's row counts (the serving decode and
    short prefill tails): the plain version against JAX's qmatmul_lora in
    interpret mode, dense and block-diagonal gates. K = 512 takes all four
    formats' k_multiple. A zero gate row gets the plain GEMV's bits."""
    from bigdl_tpu.ops.pallas.qmatmul import qmatmul_lora as jax_qmatmul_lora

    O, K = 128, 512
    x, qt = _operands(M, O, K, M * 31 + R, qtype)
    rng = np.random.default_rng(M + R)
    a = rng.normal(size=(R, K)) / R
    b = rng.normal(size=(O, R)) * 0.1
    gate = _gate(M, R, gate_kind, rng)
    j = [jnp.asarray(v, jnp.float32).astype(jnp.bfloat16) for v in (x, a, b, gate)]
    t = [torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16) for v in j]
    ref = jax_qmatmul_lora(*j[:1], qt, *j[1:], interpret=True)
    w = to_torch(qt)
    got = kernels.qmatmul_lora(t[0], w, *t[1:])
    assert got.dtype == torch.bfloat16 and got.shape == (M, O)
    _within_bf16_ulps(got.float().numpy(), ref)
    base = kernels.qmatmul(t[0], w)
    assert (got.float() - base.float()).abs().max() > 0.01  # a real epilogue
    zero = ~t[3].float().abs().sum(1).bool()
    assert torch.equal(got[zero], base[zero])


def test_lora_fused_ok_matches_jax():
    """The copied eligibility rule agrees with JAX's over a grid of widths
    that crosses the edge at llama3-8b's K (wo 4096: R <= 409; w_down
    14336: R <= 136)."""
    from bigdl_tpu.ops.pallas.tiling import lora_fused_ok as jax_lora_fused_ok

    for K in (256, 1024, 4096, 14336):
        for R in list(range(0, 20)) + [32, 128, 135, 136, 137, 256, 408, 409, 410, 1000]:
            assert kernels.lora_fused_ok(R, K) == jax_lora_fused_ok(R, K), (R, K)
    assert kernels.lora_fused_ok(409, 4096) and not kernels.lora_fused_ok(410, 4096)
    assert kernels.lora_fused_ok(136, 14336) and not kernels.lora_fused_ok(137, 14336)


# The tensor-core GEMM's tile policy and column order (ops/kernels/
# qtile.py, the host's side of csrc/qtile.cuh).

def path_shapes():
    """llama3-8b's [O, K] weights on the paths: the fused projections and
    the lm head."""
    c = PRESETS["llama3-8b"]
    H, I = c.hidden_size, c.intermediate_size
    return {"wqkv": (c.q_dim + 2 * c.kv_dim, H), "wo": (H, c.q_dim),
            "w_gateup": (2 * I, H), "w_down": (H, I), "lm_head": (c.vocab_size, H)}


# every GEMM row count up to 4096, and a few beyond
TILE_M = list(range(kernels.GEMV_MAX_ROWS + 1, 4097)) + [6000, 8192, 65536]


def test_plane_table_matches_the_cuda_traits():
    """qtile.PLANES, from which the host sizes the shared memory, is the
    plane table of csrc/qdecode.cuh's QF_<qtype> traits."""
    text = (Path(kernels.__file__).parents[2] / "csrc" / "qdecode.cuh").read_text()
    got = {m[1]: (int(m[2]), int(m[3])) for m in
           re.finditer(r"using QF_(\w+)\s*=\s*QFormat<(\d+),\s*(\d+),", text)}
    assert got == qtile.PLANES and sorted(got) == sorted(QTYPES)


@pytest.mark.parametrize("qtype", QTYPES)
def test_gemm_tile_policy_is_legal_and_fills_the_card(qtype):
    """Every M the GEMM takes, at every path shape: a tile the kernel was
    built for (64 or 128 rows, 3-6 stages within 227 KB of shared memory),
    a grid that covers M and O, and at least one block per SM unless the
    tile is already the smallest; at the paths' M = 1024 always."""
    for name, (O, K) in path_shapes().items():
        for M in TILE_M:
            t = qtile.gemm_tile(M, O, K, qtype)
            assert (t.bm, t.bn) in qtile.tiles(qtype) and 3 <= t.stages <= qtile.MAX_STAGES
            assert t.smem <= qtile.SMEM_LIMIT
            assert t.threads in (32 * (4 * max(1, t.bm // 128) + d) for d in (4, 8))
            assert t.grid == (math.ceil(M / t.bm), math.ceil(O / t.bn))
            assert t.blocks >= qtile.FILL * qtile.SMS or (t.bm, t.bn) == (64, 128), (name, M, t)
        assert qtile.gemm_tile(1024, O, K, qtype).blocks >= qtile.FILL * qtile.SMS


@pytest.mark.parametrize("mult", [1, 3, 7])
@pytest.mark.parametrize("qtype", QTYPES)
def test_gemm_k_order_is_a_permutation_the_product_does_not_see(qtype, mult):
    """The order of K in which the GEMM's steps see it (the groups of the
    finest plane split) is a permutation of K, and the product over the
    permuted columns equals the unpermuted one (exactly: small integers
    times bf16 weights sum without rounding in f64)."""
    K = mult * kernels.K_MULTIPLE[qtype]
    order = qtile.k_order(K, qtype, qtile.depth(qtype))
    assert torch.equal(order.sort().values, torch.arange(K))
    rng = np.random.default_rng(K + len(qtype))
    w = quantize(torch.from_numpy(rng.normal(size=(24, K)) * 0.05).float(), qtype)
    wd = w.dequantize(torch.bfloat16).double()
    x = torch.from_numpy(rng.integers(-8, 8, size=(5, K))).double()
    assert torch.equal(x[:, order] @ wd[:, order].T, x @ wd.T)
