"""bigdl_tpu_torch's fused dequant dx and the GEMM's LoRA epilogue, for
every weight format, and the dense weight gradient dW = g^T @ x: the plain
versions against the JAX Pallas kernels (interpret mode), and the
gradients of the port's `linear` (the autograd Functions over the fused
GEMM, the LoRA epilogue and the dx kernel) against `jax.vjp` of the JAX
package's `linear` on its Pallas path. The CUDA kernels against the plain
versions are in test_torch_gpu.py."""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.linear import linear as jax_linear
from bigdl_tpu.ops.pallas.qbackward import dw_matmul as jax_dw_matmul
from bigdl_tpu.ops.pallas.qbackward import qmatmul_dx as jax_qmatmul_dx
from bigdl_tpu.ops.pallas.qmatmul import qmatmul_lora as jax_qmatmul_lora
from bigdl_tpu.quant import quantize as jquantize
from bigdl_tpu.quant.qtypes import qtype_registry
from bigdl_tpu_torch import PRESETS
from bigdl_tpu_torch.ops import kernels, linear
from bigdl_tpu_torch.ops.kernels import qtile
from bigdl_tpu_torch.quant import ARRAY_FIELDS, QTensor, quantize

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


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("lead", [(1, 1), (1, 33), (2, 256)])
def test_dw_plain_matches_pallas_interpret(lead, out_dtype):
    """dW = g^T @ x at test_qbackward.py's test_dw_parity shapes (flattened
    M = 1, 33, 512; O = 384, K = 320; leading batch dims) against the
    Pallas kernel in interpret mode. Both sides sum exact products of bf16
    operands in f32 (in different orders) and round once: one bf16
    rounding step per element with a bf16 output; with an f32 output the
    sums' reordering alone, 2^-16 of the largest |g| |x| row sum."""
    O, K = 384, 320
    rng = np.random.default_rng(sum(lead) + K)
    jg, tg = _bf16(rng.normal(size=(*lead, O)))
    jx, tx = _bf16(rng.normal(size=(*lead, K)))
    ref = np.asarray(jax_dw_matmul(jg, jx, out_dtype=getattr(jnp, out_dtype),
                                   interpret=True), np.float32)
    kernels.reset_launches()
    got = kernels.dw_matmul(tg, tx, out_dtype=getattr(torch, out_dtype))
    assert kernels.DW.launches == 0  # CPU: the plain version
    assert got.dtype == getattr(torch, out_dtype) and got.shape == (O, K)
    if out_dtype == "bfloat16":
        _within_bf16_ulps(got.float().numpy(), ref)
    else:
        scale = (np.abs(np.asarray(jg, np.float32)).reshape(-1, O).T
                 @ np.abs(np.asarray(jx, np.float32)).reshape(-1, K)).max()
        assert np.abs(got.numpy() - ref).max() <= 2 ** -16 * scale


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
    """A shared pair folds into the fused kernel at any row count (the
    LoRA GEMV at <= 32 rows, the LoRA GEMM above) wherever JAX's
    `lora_fused_ok` admits its width, and runs the unfused epilogue after
    the base kernel past it, as JAX does; batched per-row adapters fuse
    through their concatenated operands."""
    O, K = 256, 256
    _, w, rng = _weight(O, K, 5)
    x = torch.from_numpy(rng.normal(size=(40, K)).astype(np.float32))

    def pair(r, *lead):
        return (torch.from_numpy(rng.normal(size=(*lead, r, K)).astype(np.float32)).to(torch.bfloat16),
                torch.from_numpy(rng.normal(size=(*lead, O, r)).astype(np.float32)).to(torch.bfloat16),
                torch.full(lead, 2.0, dtype=torch.bfloat16))

    wide_r = next(r for r in range(1, 4096) if not kernels.lora_fused_ok(r, K))
    wide = pair(wide_r)
    unfused = (kernels.qmatmul(x.to(torch.bfloat16), w)
               + linear_mod.lora_epilogue(x, *wide))
    torch.testing.assert_close(linear(x, w, lora=wide), unfused, rtol=0, atol=0)
    a, b, s = pair(8)
    for rows in (40, 32, 1):  # the LoRA GEMM, then the GEMV form
        gate = s.expand(rows, 8).contiguous()
        torch.testing.assert_close(
            linear(x[:rows], w, lora=(a, b, s)),
            kernels.qmatmul_lora(x[:rows].to(torch.bfloat16), w, a, b, gate),
            rtol=0, atol=0)
    # batched: 4 rows of one token, each through its own rank-8 pair
    ab, bb, sb = pair(8, 4)
    sb = torch.tensor([2.0, 0.0, 0.5, 1.0], dtype=torch.bfloat16)
    x3 = x[:4, None]
    a_cat, b_cat, gate = linear_mod._lora_cat_operands(x3, (ab, bb, sb), torch.bfloat16)
    assert a_cat.shape == (32, K) and b_cat.shape == (O, 32) and gate.shape == (4, 32)
    fused = linear(x3, w, lora=(ab, bb, sb))
    torch.testing.assert_close(
        fused, kernels.qmatmul_lora(x3.to(torch.bfloat16), w, a_cat, b_cat, gate),
        rtol=0, atol=0)
    assert torch.equal(fused[1], kernels.qmatmul(x3[1].to(torch.bfloat16), w))  # scale 0
    unfused = kernels.qmatmul(x3.to(torch.bfloat16), w) + linear_mod.lora_epilogue(
        x3, ab, bb, sb)
    _within_bf16_ulps(fused.float().numpy(), unfused.float().numpy(), floor=2 ** -7)


def test_qlora_step_at_16_rows_rank32_matches_jax(monkeypatch):
    """QLoRA at <= 32 rows per projection (B=1, 17 tokens: 16 rows), rank
    32 on all seven projections, over a kernel-eligible sym_int4 model: wo
    and w_down take the fused LoRA GEMV (its plain version here; JAX's
    Pallas kernel in interpret mode, fused as well since R = 32 passes
    `lora_fused_ok`). Loss to 1e-3 relative and every adapter gradient
    within 5 % of its leaf's largest element (test_torch_train.py's
    tolerances)."""
    import dataclasses
    import functools

    from bigdl_tpu.api import optimize_model as jax_optimize_model
    from bigdl_tpu.models import llama as jllama
    from bigdl_tpu.models.config import ModelConfig as JaxConfig
    from bigdl_tpu.quant import QTensor as JaxQTensor
    from bigdl_tpu.train import init_lora as jax_init_lora
    from bigdl_tpu.train import next_token_loss as jax_next_token_loss
    from bigdl_tpu_torch.convert import lora_from_numpy, params_from_numpy
    from bigdl_tpu_torch.models import llama
    from bigdl_tpu_torch.models.config import ModelConfig
    from bigdl_tpu_torch.train import next_token_loss

    monkeypatch.setenv("BIGDL_TPU_PALLAS", "interpret")
    jcfg = JaxConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                     num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1)
    jparams = jax.jit(functools.partial(jllama.init_params, jcfg))(jax.random.PRNGKey(0))
    jparams = jax.jit(lambda p: jax_optimize_model(p, jcfg, "sym_int4"))(jparams)
    jlora = jax_init_lora(jcfg, jax.random.PRNGKey(1), rank=32)
    rng = np.random.default_rng(3)
    for t, pair_ in jlora["layers"].items():  # B != 0: dA is compared too
        pair_["b"] = jnp.asarray(rng.normal(size=pair_["b"].shape) * 0.02, jnp.bfloat16)

    def flatten(tree, prefix, arrays, qtypes):
        if isinstance(tree, JaxQTensor):
            qtypes[prefix] = tree.qtype
            for f in ARRAY_FIELDS:
                if getattr(tree, f) is not None:
                    arrays[f"{prefix}@{f}"] = np.asarray(getattr(tree, f))
        elif isinstance(tree, dict):
            for k in sorted(tree):
                flatten(tree[k], f"{prefix}.{k}" if prefix else k, arrays, qtypes)
        else:
            arrays[prefix] = np.asarray(tree, np.float32)

    arrays, qtypes, larrays = {}, {}, {}
    flatten(jparams, "", arrays, qtypes)
    flatten(jlora, "", larrays, {})
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    model = params_from_numpy(arrays, qtypes, tcfg, device="cpu")
    lora = lora_from_numpy(larrays, tcfg, device="cpu")
    tokens = rng.integers(1, jcfg.vocab_size, (1, 17)).astype(np.int32)
    mask = np.ones((1, 17), np.float32)

    j_loss, j_grads = jax.value_and_grad(lambda layers: jax_next_token_loss(
        jcfg, jllama.forward, jparams, {"layers": layers, "scale": jlora["scale"]},
        jnp.asarray(tokens), jnp.asarray(mask)))(jlora["layers"])
    linear_calls = []
    real = linear_mod._FusedLoraMatmul.apply
    monkeypatch.setattr(linear_mod._FusedLoraMatmul, "apply",
                        lambda *a: linear_calls.append(a[0].shape) or real(*a))
    loss = next_token_loss(tcfg, llama.forward, model, lora, torch.from_numpy(tokens),
                           torch.from_numpy(mask))
    loss.backward()
    # wo and w_down of both layers took the fused form at 16 rows
    assert len(linear_calls) == 4 and all(s_[-2] == 16 for s_ in linear_calls)
    assert abs(loss.item() - float(j_loss)) <= 1e-3 * abs(float(j_loss))
    for t, g in j_grads.items():
        for leaf in ("a", "b"):
            ref = np.asarray(g[leaf], np.float32)
            got = lora.layers[t][leaf].grad.float().numpy()
            assert np.abs(ref).max() > 0
            assert np.abs(got - ref).max() <= 0.05 * np.abs(ref).max(), (t, leaf)


# The tensor-core dx's tile policy and column order (ops/kernels/qtile.py,
# the host's side of csrc/qtile.cuh).

def path_shapes():
    """llama3-8b's [O, K] weights whose dx a QLoRA step takes: the fused
    projections and the lm head."""
    c = PRESETS["llama3-8b"]
    H, I = c.hidden_size, c.intermediate_size
    return {"wqkv": (c.q_dim + 2 * c.kv_dim, H), "wo": (H, c.q_dim),
            "w_gateup": (2 * I, H), "w_down": (H, I), "lm_head": (c.vocab_size, H)}


ALL_FORMATS = ["sym_int4"] + OTHER_FORMATS


@pytest.mark.parametrize("qtype", ALL_FORMATS)
def test_dx_tile_policy_is_legal_and_fills_the_card(qtype):
    """Every M from 33 (and some beyond 4096) at every path shape: a tile
    the kernel was built for within 227 KB of shared memory, a grid that
    covers M and K's 128-column blocks, at least one block per SM unless
    the tile is already the smallest, and always at the paths' M = 1024.
    The whole O walk stays in one block (no split, no atomics)."""
    for name, (O, K) in path_shapes().items():
        for M in list(range(33, 4097)) + [6000, 8192, 65536]:
            t = qtile.dx_tile(M, O, K, qtype)
            assert (t.bm, t.bn) in qtile.tiles(qtype) and 3 <= t.stages <= qtile.MAX_STAGES
            assert t.smem <= qtile.SMEM_LIMIT
            assert t.threads in (32 * (4 * max(1, t.bm // 128) + d) for d in (4, 8))
            assert t.grid == (math.ceil(M / t.bm), math.ceil(K / t.bn))
            assert t.blocks >= qtile.FILL * qtile.SMS or (t.bm, t.bn) == (64, 128), (name, M, t)
        assert qtile.dx_tile(1024, O, K, qtype).blocks >= qtile.FILL * qtile.SMS


@pytest.mark.parametrize("bn", [128, 256])
@pytest.mark.parametrize("mult", [1, 3, 5])
@pytest.mark.parametrize("qtype", ALL_FORMATS)
def test_dx_column_order_is_a_permutation_the_product_does_not_see(qtype, mult, bn):
    """dx's blocks cover K's columns in the groups' order (bn columns a
    block): a permutation of K, and dx computed in that order and put back
    equals dx computed in order (exactly, in f64 over small integers)."""
    K = mult * kernels.K_MULTIPLE[qtype]
    order = qtile.k_order(K, qtype, bn)
    assert torch.equal(order.sort().values, torch.arange(K))
    rng = np.random.default_rng(K + len(qtype))
    w = quantize(torch.from_numpy(rng.normal(size=(24, K)) * 0.05).float(), qtype)
    wd = w.dequantize(torch.bfloat16).double()
    g = torch.from_numpy(rng.integers(-8, 8, size=(5, 24))).double()
    dx = torch.zeros(5, K, dtype=torch.float64)
    dx[:, order] = g @ wd[:, order]
    assert torch.equal(dx, g @ wd)


# The dW kernel's persistent tile order and its variant rule
# (ops/kernels/dw_matmul.py, the host's side of csrc/dw_matmul.cu).

dw_mod = importlib.import_module("bigdl_tpu_torch.ops.kernels.dw_matmul")


@pytest.mark.parametrize("O,K", [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336),
                                 (128256, 4096), (200, 136), (385, 321), (1000, 3000), (8, 8)])
@pytest.mark.parametrize("sms", [132, 7, 1])
def test_dw_schedule_covers_every_tile_once(O, K, sms):
    """The persistent grid (min(tiles, sms) blocks, block b taking tiles
    b, b + grid, ...) visits every 128 x 256 tile of dW exactly once, at
    the full fine-tune's shapes and at ragged O and K; a block's tiles of
    one group share x's column panel with the blocks beside it."""
    tiles = math.ceil(O / dw_mod.TILE_O) * math.ceil(K / dw_mod.TILE_K)
    sched = dw_mod.dw_schedule(O, K, sms)
    assert len(sched) == min(tiles, sms)
    seen = [t for block in sched for t in block]
    want = {(o, k) for o in range(0, O, dw_mod.TILE_O) for k in range(0, K, dw_mod.TILE_K)}
    assert len(seen) == tiles and set(seen) == want
    # consecutive tiles walk a group's o-blocks at one k
    first = [dw_mod.dw_tile(t, O, K) for t in range(min(dw_mod.GROUP_O, math.ceil(O / dw_mod.TILE_O)))]
    assert len({k for _, k in first}) == 1 and len(set(first)) == len(first)


def test_dw_variant_rule_sends_what_tma_cannot_read_to_the_other_kernel():
    assert dw_mod.dw_variant(4096, 4096, 256, 512) == "tma"
    assert dw_mod.dw_variant(200, 136, 0, 16) == "tma"
    for O, K, gp, xp in ((385, 320, 0, 0), (384, 321, 0, 0), (4, 8, 0, 0),
                         (384, 320, 2, 0), (384, 320, 0, 8)):
        assert dw_mod.dw_variant(O, K, gp, xp) == "any", (O, K, gp, xp)
