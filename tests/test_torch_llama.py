"""The slice end to end: the JAX package's llama parameters carried into
bigdl_tpu_torch with `params_from_numpy`, then prefill logits and greedy
generation compared between the packages.

Three sym_int4 configurations: a small kernel-eligible one (hidden 256, 2
heads of 128, 1 kv head, intermediate 512, vocab 512 — every projection
passes O % 128 and K % 64, so the port runs its kernels' plain versions
and JAX, with BIGDL_TPU_PALLAS=interpret, its Pallas kernels),
tiny-llama (hidden 64: both packages take the dequant path) and a
phi3-mini-shaped one (hidden 192, 2 heads of 96 over 2 kv heads: its
head_dim and group). Then nf4
and q4_k_m (q4_k body, q6_k lm head) at hidden 1024, where every
projection passes every format's k_multiple, and the weight carry in
formats with mins, sub-scales and fp8 codes."""

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
from bigdl_tpu.quant.qtypes import resolve_qtype, split_mixed_qtype
from bigdl_tpu_torch import TorchModel, kvcache
from bigdl_tpu_torch.convert import params_from_numpy
from bigdl_tpu_torch.generate import pad_prompts
from bigdl_tpu_torch.models import llama
from bigdl_tpu_torch.models.config import ModelConfig
from bigdl_tpu_torch.ops import kernels
from bigdl_tpu_torch.quant import ARRAY_FIELDS

torch.set_num_threads(1)

CONFIGS = {
    "kernel-eligible": JaxConfig(vocab_size=512, hidden_size=256,
                                 intermediate_size=512, num_hidden_layers=2,
                                 num_attention_heads=2, num_key_value_heads=1),
    "tiny-llama": JAX_PRESETS["tiny-llama"],
    # phi3-mini's head_dim 96 and group 1 (32 heads over 32 kv heads),
    # narrowed to two heads
    "phi3-shaped": JaxConfig(vocab_size=512, hidden_size=192, intermediate_size=512,
                             num_hidden_layers=2, num_attention_heads=2,
                             num_key_value_heads=2),
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
        for f in ARRAY_FIELDS:
            if getattr(tree, f) is not None:
                arrays[f"{prefix}@{f}"] = np.asarray(getattr(tree, f))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}.{k}" if prefix else k, arrays, qtypes)
    else:
        arrays[prefix] = np.asarray(tree, np.float32)


def _make_pair(name, jcfg, qtype):
    # jitted whole: one compile instead of one per eager op and shape
    jparams = jax.jit(functools.partial(jllama.init_params, jcfg))(
        jax.random.PRNGKey(0))
    if resolve_qtype(split_mixed_qtype(qtype)[0]).superblock:
        jparams = jax_optimize_model(jparams, jcfg, qtype)  # host encoder
    else:
        jparams = jax.jit(lambda p: jax_optimize_model(p, jcfg, qtype))(jparams)
    arrays, qtypes = {}, {}
    _flatten(jparams, "", arrays, qtypes)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    model = params_from_numpy(arrays, qtypes, tcfg, device="cpu")
    prompts = [list(np.random.default_rng(i).integers(1, jcfg.vocab_size, n))
               for i, n in enumerate(PROMPT_LENS)]
    return name, jcfg, jparams, tcfg, model, prompts


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    return _make_pair(request.param, CONFIGS[request.param], "sym_int4")


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


def test_unsupported_paths_raise(pair, monkeypatch):
    name, jcfg, jparams, tcfg, model, prompts = pair
    tm = TorchModel(tcfg, model, "sym_int4", device="cpu")
    # SnapKV and streaming run since generation's cache policies were
    # ported (test_torch_snapkv.py, test_torch_streaming.py), and
    # performance mode's switch to prompt-lookup decoding since the decode
    # algorithms were (test_torch_decode.py)
    monkeypatch.setenv("BIGDL_TPU_PERFORMANCE_MODE", "1")
    long = [list(prompts[0]) * 24]
    np.testing.assert_array_equal(tm.generate(long, 2), tm.generate_lookup(long, 2))
    # qk_norm runs since the llama flags were ported (test_torch_flags.py),
    # alibi and the experts since their slice (test_torch_alibi_logn.py,
    # test_torch_moe.py), gemma3's local rope and the layer shapes since
    # theirs (test_torch_gemma3.py, test_torch_layer_shapes.py); the
    # families with modules of their own still raise, naming their item
    for kw in ({"qk_norm": True}, {"alibi": True}, {"num_experts": 4},
               {"rope_local_theta": 1e4}, {"norm_type": "layernorm"}):
        llama.check_supported(dataclasses.replace(tcfg, **kw))
    with pytest.raises(NotImplementedError, match=r"ROADMAP queue 1 item \[9\]"):
        llama.check_supported(dataclasses.replace(tcfg, q_lora_rank=64))
    with pytest.raises(NotImplementedError, match=r"ROADMAP queue 1 item \[9\]"):
        llama.check_supported(dataclasses.replace(tcfg, cross_attention_layers=(1,)))


# nf4 and q4_k_m at a width where every projection passes every format's
# k_multiple (hidden and intermediate 1024): the port runs its kernels'
# plain versions, JAX its Pallas kernels in interpret mode
FORMAT_CFG = JaxConfig(vocab_size=512, hidden_size=1024, intermediate_size=1024,
                       num_hidden_layers=2, num_attention_heads=8,
                       num_key_value_heads=2)


@pytest.fixture(scope="module", params=["nf4", "q4_k_m"])
def fmt_pair(request):
    return _make_pair(request.param, FORMAT_CFG, request.param)


def _assert_same_fields(got, ref, what):
    for f in ARRAY_FIELDS:
        r = getattr(ref, f)
        assert (getattr(got, f) is None) == (r is None), (what, f)
        if r is not None:
            g = getattr(got, f)
            r = np.asarray(r)
            assert str(g.dtype).removeprefix("torch.") == r.dtype.name, (what, f)
            np.testing.assert_array_equal(g.view(torch.uint8).numpy() if g.element_size() == 1
                                          else g.numpy(), r.view(np.uint8) if
                                          r.dtype.itemsize == 1 else r, err_msg=f"{what} {f}")


def test_formats_weights_carry_over_exactly(fmt_pair):
    name, jcfg, jparams, tcfg, model, _ = fmt_pair
    head = "q6_k" if name == "q4_k_m" else name
    assert model.lm_head.qtype == jparams["lm_head"].qtype == head
    for i in range(tcfg.num_hidden_layers):
        for p, lin in model.layers[i].proj.items():
            ref = jparams["layers"][p]
            ref_i = type(ref)(qtype=ref.qtype, **{
                f: None if getattr(ref, f) is None else getattr(ref, f)[i]
                for f in ARRAY_FIELDS})
            _assert_same_fields(lin.w, ref_i, f"layer {i} {p}")
    _assert_same_fields(model.lm_head.w, jparams["lm_head"], "lm_head")


@pytest.mark.parametrize("pallas", ["interpret", "0"])
def test_formats_prefill_logits_match_jax(fmt_pair, pallas, monkeypatch):
    """Against JAX's Pallas kernels (interpret) and its XLA oracles (0):
    4 bf16 ULPs of the largest logit."""
    name, jcfg, jparams, tcfg, model, prompts = fmt_pair
    monkeypatch.setenv("BIGDL_TPU_PALLAS", pallas)
    ref = _jax_last_logits(jcfg, jparams, prompts)
    got = _port_last_logits(tcfg, model, prompts)
    tol = _TOL_ULPS * np.abs(ref).max()
    assert np.abs(got - ref).max() <= tol, (np.abs(got - ref).max(), tol)


def test_formats_greedy_tokens_match_jax_where_margin_allows(fmt_pair, monkeypatch):
    """Greedy generation against JAX's (its XLA dequant path, the same
    arithmetic as its kernels, fast on the CPU)."""
    name, jcfg, jparams, tcfg, model, prompts = fmt_pair
    monkeypatch.setenv("BIGDL_TPU_PALLAS", "0")
    want = TpuModel(jcfg, jparams, name).generate(prompts, NEW_TOKENS)
    kernels.reset_launches()
    got = TorchModel(tcfg, model, name, device="cpu").generate(prompts, NEW_TOKENS)
    assert all(n == 0 for n in kernels.launch_counts().values())
    _assert_tokens_match_where_margin_allows(name, jcfg, jparams, prompts, got, want)


@pytest.mark.parametrize("qtype", ["fp8_e4m3", "fp8_e5m2", "asym_int4", "q5_k", "q3_k"])
def test_params_from_numpy_carries_every_field(qtype):
    """mins, sub-scales, sub-mins and fp8 codes (numpy float8 arrays)
    cross into the port byte for byte."""
    jcfg = CONFIGS["kernel-eligible"]
    _, _, jparams, _, model, _ = _make_pair(qtype, jcfg, qtype)
    ref = jparams["layers"]["w_gateup"]
    ref_1 = type(ref)(qtype=ref.qtype, **{
        f: None if getattr(ref, f) is None else getattr(ref, f)[1] for f in ARRAY_FIELDS})
    _assert_same_fields(model.layers[1].proj["w_gateup"].w, ref_1, qtype)
    _assert_same_fields(model.lm_head.w, jparams["lm_head"], qtype)


@pytest.mark.parametrize("low_bit,lm_head_qtype,head", [
    ("nf4", "sym_int8", "sym_int8"), ("q4_k_m", None, "q6_k"), ("q4_k_m", "fp8_e4m3", "fp8_e4m3")])
def test_optimize_model_lm_head_qtype_matches_jax(low_bit, lm_head_qtype, head):
    """The lm head takes `lm_head_qtype`, else the mixed alias's head
    format (JAX's quantize_params rule); its bytes equal JAX's quantize of
    the same dense weight, and the body keeps the body format."""
    from bigdl_tpu.quant import quantize as jquantize
    from bigdl_tpu_torch import optimize_model

    cfg = ModelConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1)
    model = llama.init_params(cfg, 3, device="cpu")
    dense_head = model.lm_head.weight.float().numpy()
    model = optimize_model(model, cfg, low_bit, lm_head_qtype=lm_head_qtype)
    assert model.lm_head.qtype == head
    assert model.layers[0].proj["wo"].qtype == split_mixed_qtype(low_bit)[0]
    _assert_same_fields(model.lm_head.w, jquantize(jnp.asarray(dense_head), head), head)
