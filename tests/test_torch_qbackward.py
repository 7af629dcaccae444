"""bigdl_tpu_torch's fused dequant dx and the GEMM's LoRA epilogue, for
every weight format: the plain versions against the JAX Pallas kernels
(interpret mode), and the
gradients of the port's `linear` (the autograd Functions over the fused
GEMM, the LoRA epilogue and the dx kernel) against `jax.vjp` of the JAX
package's `linear` on its Pallas path. The CUDA kernels against the plain
versions are in test_torch_gpu.py."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.linear import linear as jax_linear
from bigdl_tpu.ops.pallas.qbackward import qmatmul_dx as jax_qmatmul_dx
from bigdl_tpu.ops.pallas.qmatmul import qmatmul_lora as jax_qmatmul_lora
from bigdl_tpu.quant import quantize as jquantize
from bigdl_tpu.quant.qtypes import qtype_registry
from bigdl_tpu_torch.ops import kernels, linear
from bigdl_tpu_torch.quant import ARRAY_FIELDS, QTensor

torch.set_num_threads(1)

OTHER_FORMATS = [n for n, s in qtype_registry().items()
                 if not s.is_dense and n != "sym_int4"]

# Both sides decode each weight in f32 rounded to bf16, sum bf16
# products in f32 in different orders and round the result to bf16 once:
# one bf16 rounding step (2^-8 relative) per element, plus the f32
# reordering (about K * 2^-24 of the largest term) where sums cancel.
_ULPS = 2 ** -7

# the module, not the `linear` function that ops/__init__ exports
linear_mod = importlib.import_module("bigdl_tpu_torch.ops.linear")


def _within_bf16_ulps(got, ref, floor=1e-5):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    bound = _ULPS * np.abs(ref) + floor * np.abs(ref).max()
    assert np.all(np.abs(got - ref) <= bound), np.abs(got - ref).max()


def _weight(O, K, seed, qtype="sym_int4"):
    """A JAX QTensor and the port's holding the same fields (fp8 codes
    through their bytes)."""
    rng = np.random.default_rng(seed)
    qt = jquantize(jnp.asarray(rng.normal(size=(O, K)) * 0.05, jnp.float32), qtype)
    fields = {}
    for f in ARRAY_FIELDS:
        a = getattr(qt, f)
        if a is not None:
            a = np.array(a)
            fields[f] = (torch.from_numpy(a.view(np.uint8)).view(getattr(torch, a.dtype.name))
                         if a.dtype.name.startswith("float8") else torch.from_numpy(a))
    return qt, QTensor(qtype=qt.qtype, **fields), rng


def _bf16(a):
    """numpy f32 -> (jax bf16, torch bf16) holding the same values."""
    j = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("M", [1, 33, 96])
@pytest.mark.parametrize("O,K", [(384, 320), (256, 1024)])
def test_dx_plain_matches_pallas_interpret(M, O, K):
    qt, w, rng = _weight(O, K, M + O + K)
    jg, tg = _bf16(rng.normal(size=(M, O)))
    ref = jax_qmatmul_dx(jg, qt, interpret=True)
    got = kernels.qmatmul_dx(tg, w)
    assert got.dtype == torch.bfloat16 and got.shape == (M, K)
    _within_bf16_ulps(got.float().numpy(), ref)


@pytest.mark.parametrize("qtype", OTHER_FORMATS)
def test_formats_dx_plain_matches_pallas_interpret(qtype):
    """Every other format's dx at M = 33 (K = 1024 takes every format's
    k_multiple)."""
    M, O, K = 33, 256, 1024
    qt, w, rng = _weight(O, K, len(qtype), qtype)
    jg, tg = _bf16(rng.normal(size=(M, O)))
    ref = jax_qmatmul_dx(jg, qt, interpret=True)
    got = kernels.qmatmul_dx(tg, w)
    assert got.dtype == torch.bfloat16 and got.shape == (M, K)
    _within_bf16_ulps(got.float().numpy(), ref)


@pytest.mark.parametrize("qtype", OTHER_FORMATS)
def test_formats_lora_gemm_plain_matches_pallas_interpret(qtype):
    """Every other format's LoRA GEMM at M = 33, R = 8."""
    M, O, K, R = 33, 256, 1024, 8
    qt, w, rng = _weight(O, K, len(qtype) + 1, qtype)
    jx, tx = _bf16(rng.normal(size=(M, K)))
    ja, ta = _bf16(rng.normal(size=(R, K)) / R)
    jb, tb = _bf16(rng.normal(size=(O, R)) * 0.1)
    jgate, tgate = _bf16(np.full((M, R), 2.0))
    ref = jax_qmatmul_lora(jx, qt, ja, jb, jgate, interpret=True)
    got = kernels.qmatmul_lora(tx, w, ta, tb, tgate)
    assert (got.float() - kernels.qmatmul(tx, w).float()).abs().max() > 0.01
    _within_bf16_ulps(got.float().numpy(), ref)


@pytest.mark.parametrize("M,R", [(33, 8), (96, 16), (96, 3)])
def test_lora_gemm_plain_matches_pallas_interpret(M, R):
    O, K = 384, 320
    qt, w, rng = _weight(O, K, M + R)
    jx, tx = _bf16(rng.normal(size=(M, K)))
    ja, ta = _bf16(rng.normal(size=(R, K)) / R)
    jb, tb = _bf16(rng.normal(size=(O, R)) * 0.1)
    jgate, tgate = _bf16(np.full((M, R), 2.0))
    ref = jax_qmatmul_lora(jx, qt, ja, jb, jgate, interpret=True)
    got = kernels.qmatmul_lora(tx, w, ta, tb, tgate)
    base = kernels.qmatmul(tx, w)
    assert (got.float() - base.float()).abs().max() > 0.01  # a real epilogue
    _within_bf16_ulps(got.float().numpy(), ref)


@pytest.mark.parametrize("with_lora", [True, False])
def test_linear_grads_match_jax_vjp(with_lora, monkeypatch):
    """y and the x/a/b gradients through the fused path (LoRA epilogue
    kernel forward; dx kernel + rank-r torch terms backward) against
    jax.vjp of the JAX linear with its Pallas kernels in interpret mode."""
    monkeypatch.setenv("BIGDL_TPU_PALLAS", "interpret")
    O, K, R = 384, 320, 8
    qt, w, rng = _weight(O, K, 11)
    x = rng.normal(size=(2, 24, K)).astype(np.float32)  # 48 rows: the GEMM
    ja, ta = _bf16(rng.normal(size=(R, K)) / R)
    jb, tb = _bf16(rng.normal(size=(O, R)) * 0.1)
    jg, tg = _bf16(rng.normal(size=(2, 24, O)))
    scale = 2.0

    if with_lora:
        def f(x_, a_, b_):
            return jax_linear(x_, qt, lora=(a_, b_, jnp.asarray(scale, jnp.bfloat16)))
        y_ref, vjp = jax.vjp(f, jnp.asarray(x), ja, jb)
        dx_ref, da_ref, db_ref = vjp(jg)
    else:
        y_ref, vjp = jax.vjp(lambda x_: jax_linear(x_, qt), jnp.asarray(x))
        (dx_ref,) = vjp(jg)

    tx = torch.from_numpy(x).requires_grad_()
    ta.requires_grad_()
    tb.requires_grad_()
    lora = (ta, tb, torch.tensor(scale, dtype=torch.bfloat16)) if with_lora else None
    kernels.reset_launches()
    y = linear(tx, w, lora=lora)
    y.backward(tg)
    assert all(n == 0 for n in kernels.launch_counts().values())  # CPU: plain
    _within_bf16_ulps(y.detach().float().numpy(), y_ref)
    # dx adds a bf16 rank-8 term to the bf16 dx of the kernel: two bf16
    # roundings of the largest term
    _within_bf16_ulps(tx.grad.numpy(), dx_ref, floor=2 ** -8)
    if with_lora:
        # bf16 products of bf16 operands over 48 rows, rounded once
        for got, ref in ((ta.grad, da_ref), (tb.grad, db_ref)):
            _within_bf16_ulps(got.float().numpy(), np.asarray(ref, np.float32),
                              floor=2 ** -8)


def test_lora_dispatch_follows_jax_rules():
    """The shared pair folds into the GEMM above 32 rows; more adapter
    columns than the epilogue kernel takes run the unfused epilogue after
    the base kernel, as JAX does past its VMEM allowance; the GEMV form
    and batched per-row adapters raise until ported."""
    O, K = 256, 256
    _, w, rng = _weight(O, K, 5)
    x = torch.from_numpy(rng.normal(size=(40, K)).astype(np.float32))

    def pair(r):
        return (torch.from_numpy(rng.normal(size=(r, K)).astype(np.float32)).to(torch.bfloat16),
                torch.from_numpy(rng.normal(size=(O, r)).astype(np.float32)).to(torch.bfloat16),
                torch.tensor(2.0, dtype=torch.bfloat16))

    wide = pair(kernels.LORA_MAX_RANK + 1)
    unfused = (kernels.qmatmul(x.to(torch.bfloat16), w)
               + linear_mod.lora_epilogue(x, *wide))
    torch.testing.assert_close(linear(x, w, lora=wide), unfused, rtol=0, atol=0)
    a, b, s = pair(8)
    gate = s.expand(40, 8).contiguous()
    torch.testing.assert_close(
        linear(x, w, lora=(a, b, s)),
        kernels.qmatmul_lora(x.to(torch.bfloat16), w, a, b, gate),
        rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
        linear(x[:32], w, lora=(a, b, s))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 7"):
        linear(x, w, lora=(a[None], b[None], s[None]))
