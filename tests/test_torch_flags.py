"""The llama-family flags in the port against the JAX package, on the CPU.

One tiny configuration per group of flags (hidden 256, 2 q heads of 128
over 1 kv head, intermediate 512, vocab 512, 2 layers: every projection
passes the fused kernels' shape guards, so the port runs their plain
versions and JAX, with BIGDL_TPU_PALLAS=interpret, its Pallas kernels):

- mistral: a uniform sliding window of 4 (prompts of 12-16 tokens, so
  the window bites), rope theta 1e6;
- bias: the q/k/v, o and MLP biases, drawn non-zero;
- qk_norm: qwen3's per-head q/k RMSNorm, weights drawn around 1;
- tied: the lm head tied to the embedding;
- gemma2: every flag above at window 4 alternating with global layers
  (pattern 2), gemma2's (1 + w) norms with weights drawn around 0, post
  norms, the embedding scale, gelu-tanh, an attention scale and softcaps
  small enough to bite on these weights.

JAX's parameters (drawn from numpy seeds where init_params would give
zeros or ones) cross with `params_from_numpy`. Each group: prefill
logits and dense-cache decode logits, greedy tokens, the paged and dense
serving engines in lockstep, the cache-free QLoRA loss and adapter
gradients, and the full fine-tune's gradient of every leaf (biases, post
norms, q/k norms, a tied embedding's summed gradient); generate over the
fp8 cache and an engine with adapters for some groups. Then each
rope-scaling scheme: inv_freq and cos/sin against JAX's, and a forward.
And the dispatch rule: which kernel each preset's layers reach.
"""

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
from bigdl_tpu.models.config import ModelConfig as JaxConfig
from bigdl_tpu.ops import rope as jrope
from bigdl_tpu.serving.adapters import AdapterRegistry as JaxRegistry
from bigdl_tpu.serving.adapters import save_adapter as jax_save_adapter
from bigdl_tpu.serving.engine import InferenceEngine as JaxEngine
from bigdl_tpu.train import init_lora as jax_init_lora
from bigdl_tpu.train import next_token_loss as jax_next_token_loss
from bigdl_tpu_torch import PRESETS, TorchModel, kvcache
from bigdl_tpu_torch.convert import params_from_numpy
from bigdl_tpu_torch.generate import pad_prompts
from bigdl_tpu_torch.models import llama
from bigdl_tpu_torch.models.config import ModelConfig
from bigdl_tpu_torch.ops import kernels
from bigdl_tpu_torch.ops.rope import make_inv_freq_scaled, rope_cos_sin
from bigdl_tpu_torch.serving import InferenceEngine
from bigdl_tpu_torch.serving.adapters import AdapterRegistry
from bigdl_tpu_torch.train import next_token_loss
from test_torch_adapters import _compare as adapter_compare
from test_torch_adapters import _mk_lora
from test_torch_llama import _assert_tokens_match_where_margin_allows, _flatten
from test_torch_recipes import _port_lora
from test_torch_serving import _compare, _lockstep

torch.set_num_threads(1)

BASE = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
            num_attention_heads=2, num_key_value_heads=1)
GROUPS = {
    "mistral": dict(model_type="mistral", sliding_window=4, rope_theta=1e6),
    "bias": dict(attention_bias=True, attention_out_bias=True, mlp_bias=True),
    "qk_norm": dict(model_type="qwen3", qk_norm=True),
    "tied": dict(tie_word_embeddings=True),
    "gemma2": dict(model_type="gemma2", sliding_window=4, sliding_window_pattern=2,
                   scale_embeddings=True, rms_norm_offset=True, post_attn_norm=True,
                   attn_logit_softcap=0.5, final_logit_softcap=2.0, attn_scale=96 ** -0.5,
                   tie_word_embeddings=True, hidden_act="gelu_pytorch_tanh",
                   attention_bias=True, attention_out_bias=True, mlp_bias=True, qk_norm=True),
}
PROMPT_LENS = (14, 12, 16)
NEW_TOKENS = 6
# Logits within 4 bf16 ULPs of the largest (test_torch_llama.py: one
# rounding flip crosses two layers in bf16); a greedy token may differ
# only where JAX's top-1/top-2 margin is within twice that.
_TOL_ULPS = 2 ** -6
# gradients: 5 % of each leaf's largest element, loss 1e-3 (QLoRA) and
# 1e-4 (f32 full fine-tune) of itself (test_torch_train.py, recipes.py)
_GRAD_FRAC = 0.05


def _perturb(jparams, jcfg, seed):
    """Random values where init_params gives constants: biases N(0, 0.1^2),
    norms 1 + N(0, 0.1^2), or N(0, 0.1^2) under the (1 + w) offset."""
    rng = np.random.default_rng(seed)
    out = dict(jparams)
    out["layers"] = dict(jparams["layers"])

    def draw(a, around):
        v = around + 0.1 * rng.standard_normal(a.shape)
        return jnp.asarray(v, a.dtype)

    norm_at = 0.0 if jcfg.rms_norm_offset else 1.0
    for k, a in jparams["layers"].items():
        if k.startswith("b"):
            out["layers"][k] = draw(a, 0.0)
        elif k.endswith("norm"):
            out["layers"][k] = draw(a, norm_at)
    out["final_norm"] = draw(jparams["final_norm"], norm_at)
    return out


def _jax_config(group):
    return JaxConfig(**BASE, **GROUPS[group])


@functools.lru_cache(maxsize=None)
def _quantized(group):
    """(jcfg, JAX sym_int4 tree in the fused layout, tcfg, port model)."""
    jcfg = _jax_config(group)
    jparams = jax.jit(functools.partial(jllama.init_params, jcfg))(jax.random.PRNGKey(0))
    jparams = _perturb(jparams, jcfg, 1)
    jparams = jax.jit(lambda p: jax_optimize_model(p, jcfg, "sym_int4"))(jparams)
    arrays, qtypes = {}, {}
    _flatten(jparams, "", arrays, qtypes)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    return jcfg, jparams, tcfg, params_from_numpy(arrays, qtypes, tcfg, device="cpu")


def _prompts(vocab):
    return [list(np.random.default_rng(i).integers(1, vocab, n)) for i, n in enumerate(PROMPT_LENS)]


@pytest.fixture(scope="module", params=list(GROUPS))
def pair(request):
    return (request.param,) + _quantized(request.param)


def _jax_steps(jcfg, jparams, prompts, steps):
    """Prefill last logits, then one decode step per column of `steps`,
    over a dense cache of 32 slots: [B, V] logits per call."""
    tokens, start = pad_prompts(prompts, 0)
    cache = jkv.init_cache(jcfg.num_hidden_layers, len(prompts), 32,
                           jcfg.num_key_value_heads, jcfg.head_dim_)
    cache = dataclasses.replace(cache, start=jnp.asarray(start))
    logits, cache = jllama.forward(jcfg, jparams, jnp.asarray(tokens), cache,
                                   mode="prefill", last_logits_only=True)
    out = [np.asarray(logits)[:, -1]]
    for col in steps.T:
        logits, cache = jllama.forward(jcfg, jparams, jnp.asarray(col[:, None]), cache,
                                       mode="decode")
        out.append(np.asarray(logits)[:, -1])
    return out


def _port_steps(tcfg, model, prompts, steps):
    tokens, start = pad_prompts(prompts, 0)
    cache = kvcache.init_cache(tcfg.num_hidden_layers, len(prompts), 32,
                               tcfg.num_key_value_heads, tcfg.head_dim_, device="cpu")
    cache = dataclasses.replace(cache, start=torch.from_numpy(start))
    with torch.inference_mode():
        logits, cache = llama.forward(tcfg, model, torch.from_numpy(tokens).long(), cache,
                                      "prefill", last_logits_only=True)
        out = [logits[:, -1].numpy()]
        for col in steps.T:
            logits, cache = llama.forward(tcfg, model, torch.from_numpy(col[:, None]).long(),
                                          cache, "decode")
            out.append(logits[:, -1].numpy())
    return out


def _assert_logits_close(got, ref, what):
    for i, (g, r) in enumerate(zip(got, ref)):
        tol = _TOL_ULPS * np.abs(r).max()
        assert np.abs(g - r).max() <= tol, (what, i, np.abs(g - r).max(), tol)


@pytest.mark.parametrize("pallas", ["interpret", "0"])
def test_prefill_logits_match_jax(pair, pallas, monkeypatch):
    """Prefill logits against JAX's Pallas kernels (interpret) and its
    XLA oracles (0): the flash kernel's plain version where the dispatch
    takes it with the window, the plain attention for gemma2 (both
    packages), within 4 bf16 ULPs of JAX's largest logit."""
    group, jcfg, jparams, tcfg, model = pair
    monkeypatch.setenv("BIGDL_TPU_PALLAS", pallas)
    prompts = _prompts(jcfg.vocab_size)
    none = np.zeros((len(prompts), 0), np.int64)
    ref = _jax_steps(jcfg, jparams, prompts, none)
    kernels.reset_launches()
    got = _port_steps(tcfg, model, prompts, none)
    assert all(n == 0 for n in kernels.launch_counts().values())  # CPU: plain versions
    _assert_logits_close(got, ref, group)
    if jcfg.final_logit_softcap:
        assert np.abs(got[0]).max() <= jcfg.final_logit_softcap


def test_dense_decode_logits_match_jax(pair, monkeypatch):
    """Three decode steps over the dense cache after the prefill (the
    plain attention under each layer's mask), logits as above."""
    group, jcfg, jparams, tcfg, model = pair
    monkeypatch.setenv("BIGDL_TPU_PALLAS", "0")
    prompts = _prompts(jcfg.vocab_size)
    steps = np.random.default_rng(9).integers(1, jcfg.vocab_size, (len(prompts), 3))
    _assert_logits_close(_port_steps(tcfg, model, prompts, steps),
                         _jax_steps(jcfg, jparams, prompts, steps), group)


def test_greedy_tokens_match_jax_where_margin_allows(pair, monkeypatch):
    group, jcfg, jparams, tcfg, model = pair
    monkeypatch.setenv("BIGDL_TPU_PALLAS", "0")
    prompts = _prompts(jcfg.vocab_size)
    want = TpuModel(jcfg, jparams, "sym_int4").generate(prompts, NEW_TOKENS)
    got = TorchModel(tcfg, model, "sym_int4", device="cpu").generate(prompts, NEW_TOKENS)
    assert got.shape == want.shape == (len(prompts), NEW_TOKENS)
    for b in range(len(prompts)):
        diff = np.nonzero(got[b] != want[b])[0]
        if diff.size:
            ctx = prompts[b] + list(want[b, :diff[0]])
            ref = _jax_steps(jcfg, jparams, [ctx], np.zeros((1, 0), np.int64))[0][0]
            top = np.sort(ref)
            assert top[-1] - top[-2] <= 2 * _TOL_ULPS * np.abs(ref).max(), (group, b)


def test_paged_engine_matches_jax(pair):
    _engine_case(pair, True)


@pytest.mark.parametrize("group", ["mistral", "gemma2"])
def test_dense_engine_matches_jax(group):
    _engine_case((group,) + _quantized(group), False)


def _engine_case(pair, paged):
    """Both packages' engines in lockstep over requests of 12-21 tokens
    sharing a page (pages of 8): pages after every step, greedy tokens by
    the margin rule, chosen-token logprobs within twice the logit bound,
    no page leaks. The paged decode takes each layer's window, the
    softcap and the scale (the paged kernel's plain version)."""
    group, jcfg, jparams, tcfg, model = pair
    tm = TorchModel(tcfg, model, "sym_int4", device="cpu")
    kw = dict(n_slots=2, max_len=64, paged=paged, page_size=8)
    jeng, teng = JaxEngine(TpuModel(jcfg, jparams, "sym_int4"), logprobs_top_k=2, **kw), \
        InferenceEngine(tm, **kw)
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


@pytest.mark.parametrize("group", ["mistral", "gemma2"])
def test_quantize_kv_generate_matches_jax(group, monkeypatch):
    """generate over the fp8 cache: mistral's prefill through the flash
    kernel's fp8 arm with its window (plain version; JAX's Pallas kernel
    in interpret mode), gemma2's through the plain attention over the
    dequantized cache; greedy tokens by test_torch_llama.py's fp8 margin
    rule (4 times the bf16 bound)."""
    jcfg, jparams, tcfg, model = _quantized(group)
    monkeypatch.setenv("BIGDL_TPU_PALLAS", "interpret")
    prompts = _prompts(jcfg.vocab_size)
    want = TpuModel(jcfg, jparams, "sym_int4").generate(prompts, NEW_TOKENS, quantize_kv=True)
    got = TorchModel(tcfg, model, "sym_int4", device="cpu").generate(prompts, NEW_TOKENS,
                                                                      quantize_kv=True)
    _assert_tokens_match_where_margin_allows(group, jcfg, jparams, prompts, got, want,
                                             ulps=4 * _TOL_ULPS)


@pytest.mark.parametrize("group", ["gemma2"])
def test_adapter_engine_matches_jax(group, tmp_path):
    """Two tenants (ranks 2 and 5, every projection, B drawn) and a base
    request in one paged engine of each package over the flagged base
    (gemma2's group holds every flag, the biases among them):
    the adapters' deltas add to the fused projections' slices, beside
    the biases; tokens by the margin rule, chosen-token logprobs within
    twice the logit bound, no page leaks."""
    jcfg, jparams, tcfg, model = _quantized(group)
    for name, seed, rank in (("t2", 11, 2), ("t5", 13, 5)):
        jax_save_adapter(str(tmp_path / f"{name}.npz"), _mk_lora(jcfg, seed, rank))
    kw = dict(n_slots=3, max_len=64, paged=True, page_size=8)
    jeng = JaxEngine(TpuModel(jcfg, jparams, "sym_int4"), adapters=JaxRegistry(dir=str(tmp_path)),
                     logprobs_top_k=2, **kw)
    teng = InferenceEngine(TorchModel(tcfg, model, "sym_int4", device="cpu"),
                           adapters=AdapterRegistry(dir=str(tmp_path)), **kw)
    jobs = list(zip(_prompts(jcfg.vocab_size), [None, "t2", "t5"]))
    jreqs = [jeng.submit(p, max_new_tokens=6, adapter=a) for p, a in jobs]
    jeng.run_until_idle()
    treqs = [teng.submit(p, max_new_tokens=6, adapter=a) for p, a in jobs]
    teng.run_until_idle()
    with torch.inference_mode():
        logits, _ = llama.forward(tcfg, model, torch.arange(1, 17)[None], None)
    adapter_compare(list(zip(jreqs, treqs)), _TOL_ULPS * float(logits.abs().max()))
    assert all(r.finish_reason == "length" for r in treqs) and teng.page_leaks() == 0


def _lora_pair(jcfg, tcfg, seed):
    """JAX's rank-4 adapters with B drawn (every A gets a gradient) and
    the port's copy."""
    jlora = jax_init_lora(jcfg, jax.random.PRNGKey(seed), rank=4)
    rng = np.random.default_rng(seed)
    for t in jlora["layers"]:
        b = jlora["layers"][t]["b"]
        jlora["layers"][t]["b"] = jnp.asarray(rng.normal(size=b.shape) * 0.02, jnp.bfloat16)
    return jlora, _port_lora(jlora, tcfg)


def _train_pallas(group):
    """The full fine-tune's dense weights take no Pallas kernel: JAX's
    flash training kernels (interpret) against mistral's window, its XLA
    attention for the others (the windowless kernels are held to JAX's in
    test_torch_recipes.py)."""
    return "interpret" if group == "mistral" else "0"


def _tokens(vocab, T=25):
    tokens = np.random.default_rng(3).integers(1, vocab, (2, T)).astype(np.int32)
    mask = np.ones_like(tokens, np.float32)
    mask[1, :4] = 0.0
    return tokens, mask


def test_qlora_loss_and_adapter_grads_match_jax(pair, monkeypatch):
    """The cache-free path over sym_int4 against JAX's Pallas kernels
    (interpret): mistral through the flash training kernels with its
    window, gemma2 through the plain attention (softcap), both as JAX
    dispatches. Loss to 1e-3, every adapter gradient within 5 % of its
    largest element."""
    group, jcfg, jparams, tcfg, model = pair
    monkeypatch.setenv("BIGDL_TPU_PALLAS", "interpret")
    jlora, lora = _lora_pair(jcfg, tcfg, 4)
    tokens, mask = _tokens(jcfg.vocab_size)
    scale = jlora["scale"]
    j_loss, j_grads = jax.value_and_grad(lambda layers: jax_next_token_loss(
        jcfg, jllama.forward, jparams, {"layers": layers, "scale": scale},
        jnp.asarray(tokens), jnp.asarray(mask)))(jlora["layers"])
    loss = next_token_loss(tcfg, llama.forward, model, lora, torch.from_numpy(tokens),
                           torch.from_numpy(mask))
    loss.backward()
    assert abs(loss.item() - float(j_loss)) <= 1e-3 * abs(float(j_loss)), (group, loss.item())
    for t, g in j_grads.items():
        for ab in ("a", "b"):
            ref = np.asarray(g[ab], np.float32)
            got = lora.layers[t][ab].grad.float().numpy()
            assert np.abs(ref).max() > 0, (group, t, ab)
            assert np.abs(got - ref).max() <= _GRAD_FRAC * np.abs(ref).max(), (group, t, ab)


@functools.lru_cache(maxsize=None)
def _dense(group):
    jcfg = _jax_config(group)
    jparams = jax.jit(functools.partial(jllama.init_params, jcfg, dtype=jnp.float32))(
        jax.random.PRNGKey(0))
    jparams = _perturb(jparams, jcfg, 1)
    arrays, qtypes = {}, {}
    _flatten(jparams, "", arrays, qtypes)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    return jcfg, jparams, tcfg, arrays


# the leaves each fused leaf of optimize_model's layout holds
_FUSED = (("wq", "wk", "wv"), ("bq", "bk", "bv"), ("w_gate", "w_up"), ("b_gate", "b_up"))


def _port_leaf(model, path):
    """The port's parameter at a JAX path ("embed", "layers.bq.0", ...)."""
    parts = path.split(".")
    if parts[0] != "layers":
        return model.lm_head.weight if parts[0] == "lm_head" else getattr(model, parts[0])
    name, i = parts[1], int(parts[2])
    layer = model.layers[i]
    if name in layer.proj:
        return layer.proj[name].weight
    if name in llama.BIAS_OF.values():
        return next(layer.proj[w].bias for w, b in llama.BIAS_OF.items() if b == name)
    return getattr(layer, name)


@pytest.mark.parametrize("group", list(GROUPS))
def test_full_finetune_grads_of_every_leaf_match_jax(group, monkeypatch):
    """The full fine-tune's loss (1e-4) and the gradient of every leaf of
    JAX's f32 tree — the biases, post norms and q/k norms among them,
    a tied embedding's gradient summed over the lookup and the head —
    each within 5 % of its largest element; q/k/v and gate/up (weights
    and biases) within 5 % of the largest element of the fused leaf they
    form (wqkv, bqkv, w_gateup, b_gateup). A query or key bias shifts a
    query's scores almost alike (rope's rotation apart), so next to the
    random biases the q/k gradients of the last layer shrink to a few
    hundredths of v's, the size of the bf16 noise."""
    monkeypatch.setenv("BIGDL_TPU_PALLAS", _train_pallas(group))
    jcfg, jparams, tcfg, arrays = _dense(group)
    model = params_from_numpy(arrays, {}, tcfg, device="cpu", dtype=None)
    tokens, mask = _tokens(jcfg.vocab_size)
    j_loss, j_grads = jax.value_and_grad(lambda p: jax_next_token_loss(
        jcfg, jllama.forward, p, None, jnp.asarray(tokens), jnp.asarray(mask)))(jparams)
    params = llama.make_trainable(model)
    loss = next_token_loss(tcfg, llama.forward, model, None, torch.from_numpy(tokens),
                           torch.from_numpy(mask))
    loss.backward()
    assert abs(loss.item() - float(j_loss)) <= 1e-4 * abs(float(j_loss)), (group, loss.item())
    flat = {}
    _flatten(j_grads, "", flat, {})
    n = 0
    for path, ref in flat.items():
        per = [(f"{path}.{i}", ref[i]) for i in range(len(ref))] if path.startswith("layers.") \
            else [(path, ref)]
        for p, r in per:
            got = _port_leaf(model, p).grad
            assert got is not None and got.dtype == torch.float32, (group, p)
            fused = next((grp for grp in _FUSED if path[len("layers."):] in grp), None)
            scale = np.abs(r).max() if fused is None else max(
                np.abs(flat[f"layers.{n}"][int(p.split(".")[-1])]).max() for n in fused)
            assert scale > 0, (group, p)
            err = np.abs(got.numpy() - r).max()
            assert err <= _GRAD_FRAC * scale, (group, p, err, scale)
            n += 1
    assert n == len(params), (n, len(params))


# ---------------------------------------------------------------------------
# rope scaling
# ---------------------------------------------------------------------------

SCHEMES = {
    "linear": {"rope_type": "linear", "factor": 4.0},
    "dynamic": {"rope_type": "dynamic", "factor": 2.0, "original_max_position_embeddings": 8},
    "llama3": {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0, "original_max_position_embeddings": 64},
    "yarn": {"rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 16},
    "yarn-mscale": {"type": "yarn", "factor": 4.0, "original_max_position_embeddings": 16,
                    "mscale": 0.707, "mscale_all_dim": 1.0, "beta_fast": 16.0},
    "longrope": {"type": "longrope", "original_max_position_embeddings": 16,
                 "max_position_embeddings": 64,
                 "short_factor": [1.0 + 0.01 * i for i in range(64)],
                 "long_factor": [1.0 + 0.2 * i for i in range(64)]},
}


@pytest.mark.parametrize("seq_len", [None, 12, 32])
@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_rope_scheme_tables_match_jax(scheme, seq_len):
    """inv_freq and the attention factor (f32 on both sides: a few f32
    ULPs) and cos/sin at positions up to 300 (a few f32 ULPs of the
    angle), for each length the schemes read (dynamic and longrope switch
    past the original length)."""
    rs = SCHEMES[scheme]
    inv_j, att_j = jrope.make_inv_freq_scaled(128, 10000.0, rs, seq_len=seq_len)
    inv_t, att_t = make_inv_freq_scaled(128, 10000.0, rs, seq_len=seq_len, device="cpu")
    assert inv_t.dtype == torch.float32 and inv_t.shape == (64,)
    np.testing.assert_allclose(inv_t.numpy(), np.asarray(inv_j), rtol=2e-6)
    assert att_t == pytest.approx(att_j, rel=1e-12)
    pos = np.random.default_rng(1).integers(0, 300, (2, 7)).astype(np.int32)
    cos_j, sin_j = jrope.rope_cos_sin(jnp.asarray(pos), inv_j, scale=att_j)
    cos_t, sin_t = rope_cos_sin(torch.from_numpy(pos), inv_t, scale=att_t)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=1e-4)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=1e-4)


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_rope_scheme_forward_matches_jax(scheme, monkeypatch):
    """Prefill and decode logits of a plain llama under each scheme (the
    cache's 32 slots are the length dynamic and longrope read)."""
    monkeypatch.setenv("BIGDL_TPU_PALLAS", "0")
    rs = SCHEMES[scheme]
    jcfg = JaxConfig(**BASE, rope_scaling=rs, max_position_embeddings=64)
    jparams = jax.jit(functools.partial(jllama.init_params, jcfg))(jax.random.PRNGKey(0))
    jparams = jax.jit(lambda p: jax_optimize_model(p, jcfg, "sym_int4"))(jparams)
    arrays, qtypes = {}, {}
    _flatten(jparams, "", arrays, qtypes)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    model = params_from_numpy(arrays, qtypes, tcfg, device="cpu")
    prompts = _prompts(jcfg.vocab_size)
    steps = np.random.default_rng(9).integers(1, jcfg.vocab_size, (len(prompts), 1))
    ref = _jax_steps(jcfg, jparams, prompts, steps)
    got = _port_steps(tcfg, model, prompts, steps)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert np.abs(g - r).max() <= _TOL_ULPS * np.abs(r).max(), (scheme, i)


# ---------------------------------------------------------------------------
# the dispatch rule
# ---------------------------------------------------------------------------

def _jax_rule(cfg, layer, cache, mode, T, per_row):
    """bigdl_tpu/models/llama.py:644-697, 805-847, written out: which
    kernel the JAX package's forward takes, with Pallas on."""
    uniform = cfg.sliding_window_pattern is None and cfg.sliding_layers is None
    if cache == "paged" and mode == "decode" and T == 1:
        win = None if cfg.sliding_window is None else (
            cfg.sliding_window if cfg.layer_is_sliding(layer) else 2 ** 30)
        return "paged", win
    if cache == "none":
        if T > 1 and uniform and cfg.attn_logit_softcap is None:
            return "flash_train", cfg.sliding_window
        return "plain", cfg.sliding_window if cfg.layer_is_sliding(layer) else None
    if mode == "prefill" and T > 1 and uniform and not per_row:
        return "flash", cfg.sliding_window
    return "plain", cfg.sliding_window if cfg.layer_is_sliding(layer) else None


CALLS = [("dense", "prefill", 64, False), ("dense", "decode", 1, False),
         ("dense", "decode", 1, True), ("paged", "prefill", 64, True),
         ("paged", "decode", 1, True), ("none", "prefill", 64, False),
         ("none", "prefill", 1, False)]


@pytest.mark.parametrize("name", ["llama3-8b", "mistral-7b", "qwen2-7b", "gemma2-9b",
                                  "phi3-mini"])
def test_attention_route_follows_jax_rule(name):
    cfg = PRESETS[name]
    for cache, mode, T, per_row in CALLS:
        for layer in range(4):
            r = llama.attention_route(cfg, layer, cache, mode, T, per_row)
            kernel, win = _jax_rule(cfg, layer, cache, mode, T, per_row)
            assert r.kernel == kernel, (name, cache, mode, T, per_row, layer)
            assert r.window == (None if win == 2 ** 30 else win)
            assert r.scale == cfg.attn_scale
            assert r.softcap == (None if kernel == "flash_train" else cfg.attn_logit_softcap)


def test_mistral_and_gemma2_routes():
    """mistral: flash prefill and flash training with its window; gemma2:
    plain prefill and training, paged decode with a window on the
    sliding (even) layers only and the softcap on every layer."""
    m, g = PRESETS["mistral-7b"], PRESETS["gemma2-9b"]
    assert llama.attention_route(m, 5, "dense", "prefill", 300) == llama.AttentionRoute(
        "flash", 4096, None, None)
    assert llama.attention_route(m, 5, "none", "prefill", 300).kernel == "flash_train"
    assert llama.attention_route(m, 5, "none", "prefill", 300).window == 4096
    for layer in range(g.num_hidden_layers):
        assert llama.attention_route(g, layer, "dense", "prefill", 300).kernel == "plain"
        assert llama.attention_route(g, layer, "none", "prefill", 300).kernel == "plain"
        r = llama.attention_route(g, layer, "paged", "decode", 1, True)
        assert (r.kernel, r.window, r.softcap, r.scale) == (
            "paged", 4096 if layer % 2 == 0 else None, 50.0, 224.0 ** -0.5)


def test_check_supported_admits_the_flags_and_names_items_for_the_rest():
    for name in ("mistral-7b", "qwen2-7b", "gemma2-9b"):
        llama.check_supported(PRESETS[name])
    base = PRESETS["tiny-llama"]
    for act in llama.ACTIVATIONS:
        llama.check_supported(dataclasses.replace(base, hidden_act=act))
    for rs in SCHEMES.values():
        llama.check_supported(dataclasses.replace(base, rope_scaling=rs))
    # since the MoE group, ALiBi and logn were ported (test_torch_moe.py,
    # test_torch_alibi_logn.py) every preset runs, and since the rest of
    # the llama flags were (test_torch_gemma3.py, test_torch_layer_shapes.py)
    # gemma3's local rope, the layer shapes and phixtral's experts do too;
    # a family's own fields raise, naming item [9]
    llama.check_supported(PRESETS["mixtral-8x7b"])
    for kw in ({"alibi": True, "alibi_scale": 0.125}, {"logn_attn": True, "logn_train_len": 8},
               {"num_experts": 8, "shared_expert_intermediate_size": 64, "moe_dispatch": "ragged"},
               {"rope_local_theta": 1e4}, {"sliding_layers": (True, False)},
               {"norm_type": "layernorm"}, {"parallel_residual": True},
               {"partial_rotary_factor": 0.5}, {"learned_positions": True},
               {"num_experts": 4, "gated_mlp": False}):
        llama.check_supported(dataclasses.replace(base, **kw))
    for kw in ({"kv_lora_rank": 64}, {"mrope_section": (16, 24, 24)},
               {"rwkv_head_size": 64}):
        with pytest.raises(NotImplementedError, match=r"ROADMAP queue 1 item \[9\]"):
            llama.check_supported(dataclasses.replace(base, **kw))
    with pytest.raises(NotImplementedError, match="rope_scaling type 'mystery'"):
        llama.check_supported(dataclasses.replace(base, rope_scaling={"type": "mystery"}))
    with pytest.raises(NotImplementedError, match="hidden_act 'swish2'"):
        llama.check_supported(dataclasses.replace(base, hidden_act="swish2"))


@pytest.mark.parametrize("M", [1, 8, 16, 17, 32])
def test_gemv_tiles_at_the_new_widths(M):
    """The GEMV's host policy at the flagged presets' projections (qwen2's
    K = 18944 among them): every M <= 32 gets a tile that fits shared
    memory; where x's columns leave no room for the widest adapter, the
    tile fits the GEMV alone and a LoRA row too wide gets no tile (its
    rows go to the LoRA GEMM) instead of failing to launch."""
    from bigdl_tpu_torch.ops.kernels import qtile

    for name in ("mistral-7b", "qwen2-7b", "gemma2-9b"):
        cfg = PRESETS[name]
        H, I = cfg.hidden_size, cfg.intermediate_size
        for O, K in ((cfg.q_dim + 2 * cfg.kv_dim, H), (H, cfg.q_dim), (2 * I, H), (H, I)):
            t = qtile.gemv_tile(M, O, K, "sym_int4")
            assert t.smem <= qtile.SMEM_LIMIT and t.grid[1] * 16 * t.wr >= O
    if M == 32:
        assert qtile.gemv_tile(M, 3584, 18944, "sym_int4", R=128) is None
