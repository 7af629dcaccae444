"""ALiBi and logn attention in the port against the JAX package, on the
CPU.

Four tiny sym_int4 configurations (hidden 256, intermediate 512, vocab
512, 2 layers; JAX's parameters cross with `params_from_numpy`):

- alibi: 6 q heads of 64 over 6 kv heads (6 is not a power of two: the
  slopes interpolate, as baichuan-13b's 40 heads do);
- alibi_gqa: 6 q heads over 2 kv heads;
- alibi_scale: 6 over 3, the bias scaled by 64^-0.5 (falcon-rw's rule);
- logn: 2 heads of 128 over 1 (the flash kernels' width), q/k/v biases,
  logn_train_len 8, so the prompts of 12-16 tokens run past it.

wq and wk are 4x init_params' N(0, 0.02^2) draws, so that the scores are
of order 1 and logn's factor moves the logits by several times the
bound (at 0.02 the scores are ~0.05, and a port that ignored logn would
stay within 4 ULPs of JAX's logits).

Each: prefill logits (JAX with its Pallas kernels in interpret mode and
without), dense-cache decode logits, greedy tokens by the margin rule,
the cache-free forward, the paged engine in lockstep with JAX's. An
ALiBi model never reaches an attention kernel (JAX's rule: the plain
attention with the bias as a float mask, on every route); logn reaches
the flash kernels with the scaled q. Logits within 4 bf16 ULPs of JAX's
largest logit (test_torch_llama.py). Then the slopes and the float mask
alone, the route table, logn against logn_attn=False, streaming's
eviction under ALiBi (keys moved without re-rotation) and generation far
past its window against JAX's, SnapKV's skip under ALiBi, and a
speculative engine at per-row positions under logn.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import kvcache as jkv
from bigdl_tpu.api import TpuModel
from bigdl_tpu.api import optimize_model as jax_optimize_model
from bigdl_tpu.models import llama as jllama
from bigdl_tpu.models.config import ModelConfig as JaxConfig
from bigdl_tpu.ops.attention import attention as jax_attention
from bigdl_tpu.ops.rope import alibi_slopes as jax_alibi_slopes
from bigdl_tpu.serving.engine import InferenceEngine as JaxEngine
from bigdl_tpu.streaming import make_evict as jax_make_evict
from bigdl_tpu.streaming import make_sink_shift as jax_make_sink_shift
from bigdl_tpu_torch import TorchModel, kvcache
from bigdl_tpu_torch.convert import params_from_numpy
from bigdl_tpu_torch.models import llama
from bigdl_tpu_torch.models.config import ModelConfig
from bigdl_tpu_torch.ops import attention, kernels
from bigdl_tpu_torch.ops.rope import alibi_slopes
from bigdl_tpu_torch.serving import InferenceEngine
from bigdl_tpu_torch.streaming import default_chunk, make_evict, make_sink_shift
from test_torch_flags import _jax_steps, _perturb, _port_steps
from test_torch_llama import _flatten, _jax_last_logits
from test_torch_serving import _compare, _lockstep
from test_torch_snapkv import assert_margin_rule, port_cache

torch.set_num_threads(1)

BASE = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2)
MODELS = {
    "alibi": dict(model_type="baichuan", num_attention_heads=6, num_key_value_heads=6,
                  head_dim=64, alibi=True),
    "alibi_gqa": dict(model_type="baichuan", num_attention_heads=6, num_key_value_heads=2,
                      head_dim=64, alibi=True),
    "alibi_scale": dict(model_type="falcon", num_attention_heads=6, num_key_value_heads=3,
                        head_dim=64, alibi=True, alibi_scale=64 ** -0.5),
    "logn": dict(model_type="qwen", num_attention_heads=2, num_key_value_heads=1,
                 attention_bias=True, logn_attn=True, logn_train_len=8),
}
PROMPT_LENS = (14, 12, 16)
NEW_TOKENS = 6
_TOL_ULPS = 2 ** -6  # 4 bf16 ULPs of the largest logit (test_torch_llama.py)


def _jax_config(name, **kw):
    return JaxConfig(**{**BASE, **MODELS[name], **kw})


def _port_config(jcfg):
    return ModelConfig(**dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=None)
def _quantized(name, **kw):
    """(jcfg, JAX sym_int4 tree, tcfg, the port's model of its bytes)."""
    jcfg = _jax_config(name, **kw)
    jparams = jax.jit(functools.partial(jllama.init_params, jcfg))(jax.random.PRNGKey(0))
    jparams = _perturb(jparams, jcfg, 1)
    jparams["layers"] = {k: v * 4 if k in ("wq", "wk") else v
                         for k, v in jparams["layers"].items()}
    jparams = jax.jit(lambda p: jax_optimize_model(p, jcfg, "sym_int4"))(jparams)
    arrays, qtypes = {}, {}
    _flatten(jparams, "", arrays, qtypes)
    tcfg = _port_config(jcfg)
    return jcfg, jparams, tcfg, params_from_numpy(arrays, qtypes, tcfg, device="cpu")


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    return (request.param,) + _quantized(request.param)


def _prompts(vocab):
    return [list(np.random.default_rng(i).integers(1, vocab, n))
            for i, n in enumerate(PROMPT_LENS)]


def _assert_logits_close(got, ref, what):
    for i, (g, r) in enumerate(zip(got, ref)):
        tol = _TOL_ULPS * np.abs(r).max()
        assert np.abs(g - r).max() <= tol, (what, i, np.abs(g - r).max(), tol)


@pytest.fixture
def no_attention_kernel(monkeypatch):
    """Every attention kernel wrapper raises if called: an ALiBi model's
    forward must take the plain attention on every route."""
    def refuse(*a, **kw):
        raise AssertionError("an attention kernel was called under ALiBi")

    for name in ("flash_attention", "flash_attention_train", "paged_attention"):
        monkeypatch.setattr(kernels, name, refuse)


@pytest.mark.parametrize("n", [1, 2, 3, 6, 8, 12, 16, 32, 40, 48, 64, 80])
def test_alibi_slopes_match_jax(n):
    """JAX's slopes bit for bit, the heads past a power of two included
    (baichuan-13b's 40: 32 + every other slope of 64's series)."""
    np.testing.assert_array_equal(alibi_slopes(n).numpy(), np.asarray(jax_alibi_slopes(n)))
    assert alibi_slopes(n).dtype == torch.float32


def test_float_mask_is_added_as_jax_adds_it():
    """A float mask (ALiBi's bias, -1e30 where masked) is added to the
    scaled, capped scores; a bool mask masks them. Both against JAX's
    attention on the same bf16 inputs, within 1e-5 of f32 sums."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 5, 6, 16), (2, 9, 2, 16), (2, 9, 2, 16)))
    keep = rng.random((2, 1, 1, 5, 9)) > 0.3
    keep[..., 0] = True
    bias = np.where(keep, rng.standard_normal((2, 2, 3, 5, 9)), -1e30).astype(np.float32)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
                  for a in (jq, jk, jv))
    for mask, cap in ((bias, None), (bias, 2.0), (keep, None)):
        want = np.asarray(jax_attention(jq, jk, jv, jnp.asarray(mask), softcap=cap), np.float32)
        got = attention(tq, tk, tv, torch.from_numpy(mask), softcap=cap).float().numpy()
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-5)


def test_attention_route_takes_the_plain_attention_under_alibi():
    """JAX's `not config.alibi` on the flash prefill, the paged decode and
    the cache-free training kernels: every layer, cache kind and mode is
    "plain"; logn keeps the kernels."""
    a = _port_config(_jax_config("alibi"))
    g = _port_config(_jax_config("logn"))
    for cache, mode, T, per_row in (("dense", "prefill", 300, False), ("dense", "decode", 1, False),
                                    ("paged", "decode", 1, True), ("paged", "prefill", 40, True),
                                    ("none", "prefill", 300, False)):
        for layer in range(a.num_hidden_layers):
            assert llama.attention_route(a, layer, cache, mode, T, per_row).kernel == "plain"
    assert llama.attention_route(g, 0, "dense", "prefill", 300).kernel == "flash"
    assert llama.attention_route(g, 0, "paged", "decode", 1, True).kernel == "paged"
    assert llama.attention_route(g, 0, "none", "prefill", 300).kernel == "flash_train"


@pytest.mark.parametrize("pallas", ["interpret", "0"])
def test_prefill_logits_match_jax(pair, pallas, monkeypatch, request):
    name, jcfg, jparams, tcfg, model = pair
    monkeypatch.setenv("BIGDL_TPU_PALLAS", pallas)
    prompts = _prompts(jcfg.vocab_size)
    none = np.zeros((len(prompts), 0), np.int64)
    ref = _jax_steps(jcfg, jparams, prompts, none)
    calls = []
    if tcfg.alibi:
        request.getfixturevalue("no_attention_kernel")
    else:  # logn: the flash kernel takes q already scaled
        flash = kernels.flash_attention
        monkeypatch.setattr(kernels, "flash_attention",
                            lambda q, *a, **kw: calls.append(q) or flash(q, *a, **kw))
    got = _port_steps(tcfg, model, prompts, none)
    _assert_logits_close(got, ref, name)
    assert len(calls) == (0 if tcfg.alibi else tcfg.num_hidden_layers)


def test_dense_decode_logits_match_jax(pair, monkeypatch):
    name, jcfg, jparams, tcfg, model = pair
    monkeypatch.setenv("BIGDL_TPU_PALLAS", "0")
    prompts = _prompts(jcfg.vocab_size)
    steps = np.random.default_rng(9).integers(1, jcfg.vocab_size, (len(prompts), 3))
    _assert_logits_close(_port_steps(tcfg, model, prompts, steps),
                         _jax_steps(jcfg, jparams, prompts, steps), name)


def test_greedy_tokens_match_jax_where_margin_allows(pair, monkeypatch):
    name, jcfg, jparams, tcfg, model = pair
    monkeypatch.setenv("BIGDL_TPU_PALLAS", "interpret")
    prompts = _prompts(jcfg.vocab_size)
    want = TpuModel(jcfg, jparams, "sym_int4").generate(prompts, NEW_TOKENS)
    got = TorchModel(tcfg, model, "sym_int4", device="cpu").generate(prompts, NEW_TOKENS)
    assert got.shape == want.shape == (len(prompts), NEW_TOKENS)
    for b in range(len(prompts)):
        diff = np.nonzero(got[b] != want[b])[0]
        if diff.size:
            ref = _jax_last_logits(jcfg, jparams, [prompts[b] + list(want[b, :diff[0]])])[0]
            top = np.sort(ref)
            assert top[-1] - top[-2] <= 2 * _TOL_ULPS * np.abs(ref).max(), (name, b)


def test_cache_free_forward_matches_jax(pair, monkeypatch):
    """Training and scoring's path with left padding: the plain attention
    with the bias under ALiBi, the training flash kernel's plain version
    with the scaled q under logn (JAX's in interpret mode)."""
    name, jcfg, jparams, tcfg, model = pair
    monkeypatch.setenv("BIGDL_TPU_PALLAS", "interpret")
    tokens = np.random.default_rng(11).integers(1, jcfg.vocab_size, (2, 14)).astype(np.int32)
    start = np.array([0, 3], np.int32)
    want, _ = jllama.forward(jcfg, jparams, jnp.asarray(tokens), None, start=jnp.asarray(start))
    with torch.inference_mode():
        got, _ = llama.forward(tcfg, model, torch.from_numpy(tokens).long(), None,
                               start=torch.from_numpy(start))
    want, got = np.asarray(want), got.numpy()
    for b in range(2):
        _assert_logits_close(got[b, start[b]:], want[b, start[b]:], (name, b))


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_engine_matches_jax(pair, paged, request):
    """Both packages' engines in lockstep (per-row positions; prefix-
    sharing requests over pages of 8): pages after every step, greedy
    tokens by the margin rule, chosen-token logprobs within twice the
    logit bound, no page leaks. ALiBi's paged decode is the plain
    attention over the gathered pages."""
    name, jcfg, jparams, tcfg, model = pair
    if tcfg.alibi:
        request.getfixturevalue("no_attention_kernel")
    kw = dict(n_slots=2, max_len=64, paged=paged, page_size=8)
    jeng = JaxEngine(TpuModel(jcfg, jparams, "sym_int4"), logprobs_top_k=2, **kw)
    teng = InferenceEngine(TorchModel(tcfg, model, "sym_int4", device="cpu"), **kw)
    with torch.inference_mode():
        logits, _ = llama.forward(tcfg, model, torch.arange(1, 17)[None], None)
    tol = _TOL_ULPS * float(logits.abs().max())
    prompts = _prompts(jcfg.vocab_size)
    script = {0: [dict(prompt=prompts[0], max_new_tokens=8),
                  dict(prompt=prompts[0][:9] + prompts[1], max_new_tokens=8)],
              3: [dict(prompt=prompts[2], max_new_tokens=8)]}
    reqs = _lockstep(jeng, teng, script)
    _compare(reqs, tol, [])
    assert [r.finish_reason for _, r in reqs] == ["length"] * 3
    if paged:
        assert teng.page_leaks() == jeng.page_leaks() == 0


def test_logn_scales_past_the_training_length_only():
    """With logn_attn off, the same weights give the same logits up to
    position 7 (max(1, .) keeps positions inside logn_train_len exact)
    and logits past it more than 4 times the parity bound away: the
    scaling acted, and the JAX comparisons would catch its absence. The
    logits without logn against JAX's too."""
    jcfg, jparams, tcfg, model = _quantized("logn")
    off_j = dataclasses.replace(jcfg, logn_attn=False)
    off_t = _port_config(off_j)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(1, 512, (1, 16)))
    with torch.inference_mode():
        on = llama.forward(tcfg, model, tokens, None)[0].numpy()
        off = llama.forward(off_t, model, tokens, None)[0].numpy()
    np.testing.assert_array_equal(on[:, :8], off[:, :8])
    assert np.abs(on[:, 8:] - off[:, 8:]).max() > 4 * _TOL_ULPS * np.abs(on).max()
    want = np.asarray(jllama.forward(off_j, jparams, jnp.asarray(tokens.numpy()), None)[0])
    _assert_logits_close(off[0], want[0], "logn off")


def _alibi_random_cache(seed, L=2, B=2, S=16, H=6, D=64, pos=16):
    rng = np.random.default_rng(seed)
    k, v = (jnp.asarray(rng.standard_normal((L, B, S, H, D)), jnp.bfloat16) for _ in range(2))
    return dataclasses.replace(jkv.init_cache(L, B, S, H, D), k=k, v=v,
                               pos=jnp.asarray(pos, jnp.int32))


@pytest.mark.parametrize("chunk", [1, 3, 12])
def test_streaming_eviction_under_alibi_matches_jax(chunk):
    """Under ALiBi the eviction moves the keys as they are: JAX's cache
    bit for bit, keys and values, the freed tail zeroed."""
    jcfg = _jax_config("alibi")
    jc = _alibi_random_cache(chunk)
    want = jax_make_evict(jcfg, 16, 4, chunk)(jc)
    got = make_evict(_port_config(jcfg), 16, 4, chunk)(port_cache(jc))
    assert got.pos == int(want.pos) == 16 - chunk
    np.testing.assert_array_equal(got.k.float().numpy(), np.asarray(want.k, np.float32))
    np.testing.assert_array_equal(got.v.float().numpy(), np.asarray(want.v, np.float32))
    moved = np.asarray(jc.k, np.float32)[:, :, 4 + chunk:]
    np.testing.assert_array_equal(got.k[:, :, 4:16 - chunk].float().numpy(), moved)


@pytest.mark.parametrize("window,sink", [(24, 4)])
def test_streaming_generation_far_past_window_matches_jax(window, sink, monkeypatch):
    """generate with attention sinks under ALiBi, three windows long:
    JAX's tokens by the margin rule, the logits of every step along JAX's
    tokens within the bound (both packages step their own ring)."""
    monkeypatch.setenv("BIGDL_TPU_PALLAS", "0")
    jcfg, jparams, tcfg, model = _quantized("alibi_gqa")
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8]]
    N = 3 * window
    want = np.asarray(TpuModel(jcfg, jparams, "sym_int4").generate(
        prompts, N, streaming_window=window, streaming_sink=sink))
    got = TorchModel(tcfg, model, "sym_int4", device="cpu").generate(
        prompts, N, streaming_window=window, streaming_sink=sink)
    chunk = default_chunk(window, sink)
    jshift = jax_make_sink_shift(jcfg, window, sink, chunk)
    tshift = make_sink_shift(tcfg, window, sink, chunk)
    L, Hkv, D = jcfg.num_hidden_layers, jcfg.num_key_value_heads, jcfg.head_dim_
    jc = jkv.init_cache(L, 2, window, Hkv, D)
    tc = kvcache.init_cache(L, 2, window, Hkv, D, device="cpu")
    tokens = np.asarray(prompts, np.int32)
    jl, jc = jllama.forward(jcfg, jparams, jnp.asarray(tokens), jc)
    js, ts = [np.asarray(jl)[:, -1]], []
    with torch.inference_mode():
        tl, tc = llama.forward(tcfg, model, torch.from_numpy(tokens).long(), tc)
        ts.append(tl[:, -1].numpy())
        for i in range(N - 1):
            cur = want[:, i:i + 1].astype(np.int32)
            jc, tc = jshift(jc), tshift(tc)
            jl, jc = jllama.forward(jcfg, jparams, jnp.asarray(cur), jc, mode="decode")
            tl, tc = llama.forward(tcfg, model, torch.from_numpy(cur).long(), tc, "decode")
            js.append(np.asarray(jl)[:, -1])
            ts.append(tl[:, -1].numpy())
    js, ts = np.stack(js, 1), np.stack(ts, 1)
    assert np.abs(ts - js).max() <= _TOL_ULPS * np.abs(js).max()
    assert_margin_rule(got, want, js)


def test_snapkv_is_skipped_under_alibi():
    """SnapKV's compressed slots are no longer positions, so an ALiBi
    model warns and generates over the whole cache, as JAX does."""
    _, _, tcfg, model = _quantized("alibi")
    tm = TorchModel(tcfg, model, "sym_int4", device="cpu")
    prompt = [list(np.random.default_rng(2).integers(1, 512, 40))]
    with pytest.warns(UserWarning, match="SnapKV compress_kv skipped"):
        got = tm.generate(prompt, 4, compress_kv=16, compress_window=4)
    np.testing.assert_array_equal(got, tm.generate(prompt, 4))


def test_speculative_engine_under_logn_equals_the_plain_engine():
    """The dense-pool engine with the model as its own draft (K = 4): the
    verify runs T = 4 rows at per-row positions, each row's logn factor
    from its own positions; every token and logprob equals the plain
    engine's (both run the plain attention over the dense pool)."""
    _, _, tcfg, model = _quantized("logn")
    tm = TorchModel(tcfg, model, "sym_int4", device="cpu")
    specs = [dict(prompt=p, max_new_tokens=10) for p in _prompts(512)]
    kw = dict(n_slots=2, max_len=64)

    def serve(eng):
        reqs = [eng.submit(**sp) for sp in specs]
        eng.run_until_idle()
        return reqs

    with torch.inference_mode():
        logits, _ = llama.forward(tcfg, model, torch.arange(1, 17)[None], None)
    tol = _TOL_ULPS * float(logits.abs().max())
    plain = serve(InferenceEngine(tm, **kw))
    eng = InferenceEngine(tm, speculative=True, draft_params=tm.params, draft_k=4, **kw)
    spec = serve(eng)
    assert eng.spec_rounds > 0 and eng.spec_emitted / eng.spec_rounds > 1.0
    for a, b in zip(plain, spec):
        assert a.out_tokens == b.out_tokens
        np.testing.assert_allclose(a.out_logprobs, b.out_logprobs, rtol=0, atol=2 * tol)
        assert all(math.isfinite(x) for x in b.out_logprobs)
