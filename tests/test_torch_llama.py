"""The slice end to end: the JAX package's llama parameters carried into
bigdl_tpu_torch with `params_from_numpy`, then prefill logits and greedy
generation compared between the packages.

Two configurations: a small kernel-eligible one (hidden 256, 2 heads of
128, 1 kv head, intermediate 512, vocab 512 — every projection passes
O % 128 and K % 64, so the port runs its kernels' plain versions and JAX,
with BIGDL_TPU_PALLAS=interpret, its Pallas kernels) and tiny-llama
(hidden 64: both packages take the dequant path)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import kvcache as jkv
from bigdl_tpu.api import TpuModel
from bigdl_tpu.api import optimize_model as jax_optimize_model
from bigdl_tpu.models import llama as jllama
from bigdl_tpu.models.config import PRESETS as JAX_PRESETS
from bigdl_tpu.models.config import ModelConfig as JaxConfig
from bigdl_tpu.quant import QTensor as JaxQTensor
from bigdl_tpu_torch import TorchModel, kvcache
from bigdl_tpu_torch.convert import params_from_numpy
from bigdl_tpu_torch.generate import pad_prompts
from bigdl_tpu_torch.models import llama
from bigdl_tpu_torch.models.config import ModelConfig
from bigdl_tpu_torch.ops import kernels

CONFIGS = {
    "kernel-eligible": JaxConfig(vocab_size=512, hidden_size=256,
                                 intermediate_size=512, num_hidden_layers=2,
                                 num_attention_heads=2, num_key_value_heads=1),
    "tiny-llama": JAX_PRESETS["tiny-llama"],
}
PROMPT_LENS = (11, 5, 16)
NEW_TOKENS = 6

# Logits leave the lm head rounded to bf16 and the hidden state crosses
# two layers in bf16, where one rounding flip propagates: allow 4 bf16
# ULPs of the largest logit. A greedy token may differ only where JAX's
# top-1/top-2 margin is within twice that (both logits can move by it).
_TOL_ULPS = 2 ** -6


def _flatten(tree, prefix, arrays, qtypes):
    """The JAX parameter tree under convert/low_bit.py's key naming, bf16
    leaves widened to float32 (exact)."""
    if isinstance(tree, JaxQTensor):
        qtypes[prefix] = tree.qtype
        arrays[f"{prefix}@data"] = np.asarray(tree.data)
        arrays[f"{prefix}@scales"] = np.asarray(tree.scales)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}.{k}" if prefix else k, arrays, qtypes)
    else:
        arrays[prefix] = np.asarray(tree, np.float32)


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    jcfg = CONFIGS[request.param]
    # jitted whole: one compile instead of one per eager op and shape
    jparams = jax.jit(functools.partial(jllama.init_params, jcfg))(
        jax.random.PRNGKey(0))
    jparams = jax.jit(lambda p: jax_optimize_model(p, jcfg, "sym_int4"))(jparams)
    arrays, qtypes = {}, {}
    _flatten(jparams, "", arrays, qtypes)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    model = params_from_numpy(arrays, qtypes, tcfg, device="cpu")
    prompts = [list(np.random.default_rng(i).integers(1, jcfg.vocab_size, n))
               for i, n in enumerate(PROMPT_LENS)]
    return request.param, jcfg, jparams, tcfg, model, prompts


def _jax_last_logits(jcfg, jparams, prompts):
    tokens, start = pad_prompts(prompts, 0)
    cache = jkv.init_cache(jcfg.num_hidden_layers, len(prompts), 32,
                           jcfg.num_key_value_heads, jcfg.head_dim_)
    cache = dataclasses.replace(cache, start=jnp.asarray(start))
    logits, _ = jllama.forward(jcfg, jparams, jnp.asarray(tokens), cache,
                               mode="prefill", last_logits_only=True)
    return np.asarray(logits)[:, -1]


def _port_last_logits(tcfg, model, prompts):
    tokens, start = pad_prompts(prompts, 0)
    cache = kvcache.init_cache(tcfg.num_hidden_layers, len(prompts), 32,
                               tcfg.num_key_value_heads, tcfg.head_dim_,
                               device="cpu")
    cache = dataclasses.replace(cache, start=torch.from_numpy(start))
    with torch.inference_mode():
        logits, cache = llama.forward(tcfg, model, torch.from_numpy(tokens).long(),
                                      cache, "prefill", last_logits_only=True)
    assert cache.pos == tokens.shape[1] and logits.shape[1] == 1
    return logits[:, -1].numpy()


def test_weights_carry_over_exactly(pair):
    name, jcfg, jparams, tcfg, model, _ = pair
    layer = model.layers[1]
    assert set(layer.proj) == {"wqkv", "wo", "w_gateup", "w_down"}
    np.testing.assert_array_equal(layer.proj["wqkv"].data.numpy(),
                                  np.asarray(jparams["layers"]["wqkv"].data[1]))
    np.testing.assert_array_equal(model.embed.float().numpy(),
                                  np.asarray(jparams["embed"], np.float32))


@pytest.mark.parametrize("pallas", ["interpret", "0"])
def test_prefill_logits_match_jax(pair, pallas, monkeypatch):
    """Against JAX's Pallas kernels (interpret) and its XLA oracles (0)."""
    name, jcfg, jparams, tcfg, model, prompts = pair
    monkeypatch.setenv("BIGDL_TPU_PALLAS", pallas)
    ref = _jax_last_logits(jcfg, jparams, prompts)
    got = _port_last_logits(tcfg, model, prompts)
    tol = _TOL_ULPS * np.abs(ref).max()
    assert np.abs(got - ref).max() <= tol, (np.abs(got - ref).max(), tol)


def _assert_tokens_match_where_margin_allows(name, jcfg, jparams, prompts, got,
                                             want, penalty=1.0, ulps=_TOL_ULPS):
    """Equal tokens, or a first divergence where JAX's top-1/top-2 margin
    (after the repetition penalty, over the same history) is within twice
    the logit tolerance."""
    assert got.shape == want.shape == (len(prompts), NEW_TOKENS)
    for b in range(len(prompts)):
        diff = np.nonzero(got[b] != want[b])[0]
        if diff.size == 0:
            continue
        i = diff[0]  # first divergence: same history up to here
        ctx = prompts[b] + list(want[b, :i])
        ref = _jax_last_logits(jcfg, jparams, [ctx])[0]
        if penalty != 1.0:
            seen = np.zeros(ref.shape, bool)
            seen[ctx] = True
            ref = np.where(seen, np.where(ref < 0, ref * penalty, ref / penalty), ref)
        top = np.sort(ref)
        margin = top[-1] - top[-2]
        assert margin <= 2 * ulps * np.abs(ref).max(), (name, b, i, margin)


def test_greedy_tokens_match_jax_where_margin_allows(pair, monkeypatch):
    name, jcfg, jparams, tcfg, model, prompts = pair
    monkeypatch.setenv("BIGDL_TPU_PALLAS", "interpret")
    want = TpuModel(jcfg, jparams, "sym_int4").generate(prompts, NEW_TOKENS)
    kernels.reset_launches()
    got = TorchModel(tcfg, model, "sym_int4", device="cpu").generate(prompts, NEW_TOKENS)
    assert all(n == 0 for n in kernels.launch_counts().values())
    _assert_tokens_match_where_margin_allows(name, jcfg, jparams, prompts, got, want)


def test_repetition_penalty_generate_matches_jax(pair):
    """The penalty divides (multiplies, if negative) the logits of every
    prompt and emitted token, as HF and JAX do."""
    name, jcfg, jparams, tcfg, model, prompts = pair
    want = TpuModel(jcfg, jparams, "sym_int4").generate(
        prompts, NEW_TOKENS, repetition_penalty=1.3)
    got = TorchModel(tcfg, model, "sym_int4", device="cpu").generate(
        prompts, NEW_TOKENS, repetition_penalty=1.3)
    _assert_tokens_match_where_margin_allows(name, jcfg, jparams, prompts, got,
                                             want, penalty=1.3)


def test_quantize_kv_generate_matches_jax(pair, monkeypatch):
    """generate over the fp8 cache: prefill through the flash kernel's fp8
    arm (its plain version here; JAX's Pallas kernel in interpret mode),
    decode over the dequantized cache. The fp8 codes of K/V that differ by
    a bf16 rounding may land a code step apart, so the margin bound is 4
    times the bf16 one; the first divergence is measured against JAX's
    bf16 history."""
    name, jcfg, jparams, tcfg, model, prompts = pair
    monkeypatch.setenv("BIGDL_TPU_PALLAS", "interpret")
    want = TpuModel(jcfg, jparams, "sym_int4").generate(prompts, NEW_TOKENS,
                                                       quantize_kv=True)
    got = TorchModel(tcfg, model, "sym_int4", device="cpu").generate(
        prompts, NEW_TOKENS, quantize_kv=True)
    _assert_tokens_match_where_margin_allows(name, jcfg, jparams, prompts, got,
                                             want, ulps=4 * _TOL_ULPS)


def test_eos_stops_rows_and_pads(pair):
    """A row that emits EOS pads with pad_token_id afterwards (JAX
    semantics)."""
    name, jcfg, jparams, tcfg, model, prompts = pair
    tm = TorchModel(tcfg, model, "sym_int4", device="cpu")
    free = tm.generate(prompts, NEW_TOKENS)
    eos = int(free[0, 1])
    out = tm.generate(prompts, NEW_TOKENS, eos_token_id=eos, pad_token_id=7)
    for b in range(len(prompts)):
        hits = np.nonzero(free[b] == eos)[0]
        if hits.size:
            j = hits[0]
            np.testing.assert_array_equal(out[b, :j + 1], free[b, :j + 1])
            assert np.all(out[b, j + 1:] == 7)
        else:
            np.testing.assert_array_equal(out[b], free[b])


def test_unsupported_paths_raise(pair):
    name, jcfg, jparams, tcfg, model, prompts = pair
    tm = TorchModel(tcfg, model, "sym_int4", device="cpu")
    for kw in ({"compress_kv": 8}, {"streaming_window": 64}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tm.generate(prompts, 2, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        llama.check_supported(dataclasses.replace(tcfg, qk_norm=True))
