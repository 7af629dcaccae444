"""The llama flags of the other layer shapes in the port against the JAX
package, on the CPU.

One tiny configuration per family (hidden 256, 2 q heads of 128 over 1
kv head, intermediate 512, vocab 512, 2 layers: every projection passes
the fused kernels' shape guards, so the port runs their plain versions
and JAX, with BIGDL_TPU_PALLAS=interpret, its Pallas kernels), each with
its family's flags as the JAX package's `from_hf_config` sets them:

- phi: layernorm with biases, a parallel residual, a plain biased MLP,
  rope over 50 of 128 lanes (partial 0.4), a biased lm head;
- phixtral: phi's shape over 4 non-gated biased experts, top 2, the
  dense combine; phixtral_ragged the same through the capacity dispatch;
- starcoder2: biased layernorms and projections, a window of 4;
- gpt_neox: partial rope (0.25), a parallel residual;
- cohere: one bias-free layernorm, a parallel residual, interleaved rope,
  logit_scale;
- gpt2: learned positions (no rope), tied head;
- bloom: ALiBi and the embedding layernorm;
- stablelm: biased layernorms, partial rope;
- minicpm: embedding_scale, residual_scale and logit_scale.

JAX's parameters (norms, biases and the top-level leaves drawn from numpy
seeds where init_params gives constants; routers N(0, 0.2^2), so that
routing has few near-ties) cross with `params_from_numpy`. One JAX
reference run per family is shared by the cases. Logits within 4 bf16
ULPs of JAX's largest (tests/test_torch_llama.py); a greedy token may
differ only where JAX's top-1/top-2 margin is within twice that.
"""

import contextlib
import dataclasses
import functools
import importlib
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import kvcache as jkv
from bigdl_tpu.api import AutoModelForCausalLM as JaxAuto
from bigdl_tpu.api import TpuModel
from bigdl_tpu.api import optimize_model as jax_optimize_model
from bigdl_tpu.convert.low_bit import _flatten as jax_flatten_artifact
from bigdl_tpu.models import llama as jllama
from bigdl_tpu.models.config import ModelConfig as JaxConfig
from bigdl_tpu.ops import norms as jnorms
from bigdl_tpu.ops import rope as jrope
from bigdl_tpu.serving.engine import InferenceEngine as JaxEngine
from bigdl_tpu.streaming import make_evict as jax_make_evict
from bigdl_tpu.streaming import validate_streaming as jax_validate_streaming
from bigdl_tpu.train import init_lora as jax_init_lora
from bigdl_tpu.train import next_token_loss as jax_next_token_loss
from bigdl_tpu_torch import AutoModelForCausalLM, TorchModel, kvcache
from bigdl_tpu_torch.convert import params_from_numpy, params_to_numpy
from bigdl_tpu_torch.generate import pad_prompts
from bigdl_tpu_torch.models import llama
from bigdl_tpu_torch.models.config import ModelConfig
from bigdl_tpu_torch.ops import kernels
from bigdl_tpu_torch.ops.norms import layer_norm
from bigdl_tpu_torch.ops.rope import apply_rotary_emb, make_inv_freq_scaled, rope_cos_sin
from bigdl_tpu_torch.serving import InferenceEngine
from bigdl_tpu_torch.streaming import make_evict, validate_streaming
from bigdl_tpu_torch.train import adamw, make_train_step, next_token_loss
from test_torch_llama import _flatten
from test_torch_recipes import _port_lora
from test_torch_serving import _compare, _lockstep
from test_torch_snapkv import port_cache

torch.set_num_threads(1)

BASE = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
            num_attention_heads=2, num_key_value_heads=1)
_PHI = dict(model_type="phi", norm_type="layernorm", norm_bias=True, parallel_residual=True,
            gated_mlp=False, mlp_bias=True, attention_bias=True, attention_out_bias=True,
            lm_head_bias=True, partial_rotary_factor=0.4, hidden_act="gelu_new")
_PHIXTRAL = dict(_PHI, model_type="phixtral", num_experts=4, num_experts_per_tok=2,
                 norm_topk_prob=True)
_LN = dict(norm_type="layernorm", norm_bias=True, gated_mlp=False, mlp_bias=True,
           attention_bias=True, attention_out_bias=True)
FAMILIES = {
    "phi": _PHI,
    "phixtral": _PHIXTRAL,
    "phixtral_ragged": dict(_PHIXTRAL, moe_dispatch="ragged"),
    "starcoder2": dict(_LN, model_type="starcoder2", sliding_window=4,
                       hidden_act="gelu_pytorch_tanh", tie_word_embeddings=True),
    "gpt_neox": dict(_LN, model_type="gpt_neox", parallel_residual=True,
                     partial_rotary_factor=0.25, hidden_act="gelu"),
    "cohere": dict(model_type="cohere", norm_type="layernorm", parallel_residual=True,
                   rope_interleaved=True, logit_scale=0.0625, tie_word_embeddings=True),
    "gpt2": dict(_LN, model_type="gpt2", learned_positions=True, tie_word_embeddings=True,
                 hidden_act="gelu_new", max_position_embeddings=64),
    "bloom": dict(_LN, model_type="bloom", alibi=True, embed_layernorm=True,
                  tie_word_embeddings=True, hidden_act="gelu_pytorch_tanh"),
    "stablelm": dict(model_type="stablelm", norm_type="layernorm", norm_bias=True,
                     partial_rotary_factor=0.25),
    "minicpm": dict(model_type="minicpm", embedding_scale=12.0, residual_scale=1.4 / 2 ** 0.5,
                    logit_scale=0.25, tie_word_embeddings=True),
}
PROMPT_LENS = (14, 12, 16)
DECODE_STEPS = 2
_TOL_ULPS = 2 ** -6
# QLoRA: the loss to 1e-3 of itself, each adapter gradient within 5 % of
# its largest element (tests/test_torch_flags.py)
_GRAD_FRAC = 0.05


@contextlib.contextmanager
def pallas(mode):
    """BIGDL_TPU_PALLAS set to `mode` for JAX's calls inside."""
    old = os.environ.get("BIGDL_TPU_PALLAS")
    os.environ["BIGDL_TPU_PALLAS"] = mode
    try:
        yield
    finally:
        if old is None:
            del os.environ["BIGDL_TPU_PALLAS"]
        else:
            os.environ["BIGDL_TPU_PALLAS"] = old


def perturb(jparams, jcfg, seed):
    """Random values where init_params gives constants: biases and norm
    biases N(0, 0.1^2), norm weights 1 + N(0, 0.1^2) (N(0, 0.1^2) under
    gemma's (1 + w) offset), routers N(0, 0.2^2)."""
    rng = np.random.default_rng(seed)

    def draw(a, around, scale=0.1):
        return jnp.asarray(around + scale * rng.standard_normal(a.shape), a.dtype)

    norm_at = 0.0 if jcfg.rms_norm_offset else 1.0

    def one(name, a):
        if name == "router":
            return draw(a, 0.0, 0.2)
        if name.startswith("b") or name.endswith("_b"):
            return draw(a, 0.0)
        if name.endswith("norm"):
            return draw(a, norm_at)
        return a

    out = {k: one(k, v) for k, v in jparams.items() if k != "layers"}
    out["layers"] = {k: one(k, v) for k, v in jparams["layers"].items()}
    return out


def jax_config(family, **kw):
    return JaxConfig(**{**BASE, **FAMILIES[family], **kw})


def port_config(jcfg):
    return ModelConfig(**dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=None)
def dense_tree(family):
    """JAX's perturbed bf16 tree in the unfused layout."""
    jcfg = jax_config(family)
    jparams = jax.jit(functools.partial(jllama.init_params, jcfg))(jax.random.PRNGKey(0))
    return jcfg, perturb(jparams, jcfg, 1)


@functools.lru_cache(maxsize=None)
def quantized(family):
    """(jcfg, JAX sym_int4 tree in the fused layout, tcfg, port model)."""
    jcfg, jparams = dense_tree(family)
    jparams = jax.jit(lambda p: jax_optimize_model(p, jcfg, "sym_int4"))(jparams)
    arrays, qtypes = {}, {}
    _flatten(jparams, "", arrays, qtypes)
    tcfg = port_config(jcfg)
    return jcfg, jparams, tcfg, params_from_numpy(arrays, qtypes, tcfg, device="cpu")


def prompts_for(vocab):
    return [list(np.random.default_rng(i).integers(1, vocab, n))
            for i, n in enumerate(PROMPT_LENS)]


def jax_steps(jcfg, jparams, prompts, n_steps):
    """Prefill last logits over a dense cache of 32 slots, then n_steps
    greedy decode steps: ([n_steps + 1] of [B, V], greedy tokens [B, n])."""
    tokens, start = pad_prompts(prompts, 0)
    cache = jkv.init_cache(jcfg.num_hidden_layers, len(prompts), 32,
                           jcfg.num_key_value_heads, jcfg.head_dim_)
    cache = dataclasses.replace(cache, start=jnp.asarray(start))
    # jitted whole (traced here, so under the caller's BIGDL_TPU_PALLAS):
    # one compile instead of one per eager op and shape
    prefill = jax.jit(lambda p, t, c: jllama.forward(jcfg, p, t, c, mode="prefill",
                                                     last_logits_only=True))
    decode = jax.jit(lambda p, t, c: jllama.forward(jcfg, p, t, c, mode="decode"))
    logits, cache = prefill(jparams, jnp.asarray(tokens), cache)
    out, toks = [np.asarray(logits)[:, -1]], []
    for _ in range(n_steps):
        toks.append(out[-1].argmax(-1))
        logits, cache = decode(jparams, jnp.asarray(toks[-1][:, None]), cache)
        out.append(np.asarray(logits)[:, -1])
    return out, np.stack(toks, 1) if toks else np.zeros((len(prompts), 0), np.int64)


def port_steps(tcfg, model, prompts, steps):
    """The port's prefill and decode logits over the same cache, fed the
    tokens `steps` [B, n]."""
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


def cache_free_inputs(vocab):
    tokens = np.random.default_rng(3).integers(1, vocab, (2, 13)).astype(np.int32)
    return tokens, np.array([0, 4], np.int32)


@functools.lru_cache(maxsize=None)
def reference(family):
    """JAX's outputs the cases share: the prefill's last logits with its
    Pallas kernels in interpret mode and with its XLA oracles, greedy
    decode steps (their logits and tokens) over the dense cache, and the
    cache-free forward's logits (left pad 4 in row 1) through its XLA
    attention (the flash training kernels' plain reference; the Pallas
    kernels themselves are held in test_torch_flash_backward.py)."""
    jcfg, jparams, _, _ = quantized(family)
    prompts = prompts_for(jcfg.vocab_size)
    out = {}
    with pallas("interpret"):
        out["prefill_interpret"] = jax_steps(jcfg, jparams, prompts, 0)[0][0]
    with pallas("0"):
        out["decode"], out["greedy"] = jax_steps(jcfg, jparams, prompts, DECODE_STEPS)
        out["prefill_0"] = out["decode"][0]
        tokens, start = cache_free_inputs(jcfg.vocab_size)
        logits, _ = jllama.forward(jcfg, jparams, jnp.asarray(tokens), None,
                                   start=jnp.asarray(start))
        out["cache_free"] = np.asarray(logits)
    return out


def assert_logits_close(got, ref, what):
    tol = _TOL_ULPS * np.abs(ref).max()
    assert np.abs(got - ref).max() <= tol, (what, np.abs(got - ref).max(), tol)


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bias", [True, False])
def test_layer_norm_matches_jax(bias):
    """layer_norm in f32 with the biased variance, bf16 out: within one
    bf16 rounding of JAX's."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 96)).astype(np.float32) * 3 + 1
    w = 1 + 0.1 * rng.standard_normal(96).astype(np.float32)
    b = 0.1 * rng.standard_normal(96).astype(np.float32) if bias else None
    want = np.asarray(jnorms.layer_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                                        None if b is None else jnp.asarray(b), 1e-5), np.float32)
    got = layer_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                     None if b is None else torch.from_numpy(b), 1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("rotary", [64, 24])
def test_partial_and_interleaved_rope_match_jax(rotary, interleaved):
    """cos/sin tables (angles duplicated or repeated pairwise) and the
    rotation of the first `rotary` of 64 lanes, the rest passed through
    bit for bit."""
    rng = np.random.default_rng(rotary)
    pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
    inv_j = jrope.make_inv_freq(rotary, 10000.0, None)
    inv_t, _ = make_inv_freq_scaled(rotary, 10000.0, None, device="cpu")
    cos_j, sin_j = jrope.rope_cos_sin(jnp.asarray(pos), inv_j, interleaved=interleaved)
    cos_t, sin_t = rope_cos_sin(torch.from_numpy(pos), inv_t, interleaved=interleaved)
    assert cos_t.shape == (2, 7, rotary)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=1e-4)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=1e-4)
    q = rng.standard_normal((2, 7, 4, 64)).astype(np.float32)
    k = rng.standard_normal((2, 7, 2, 64)).astype(np.float32)
    qj, kj = jrope.apply_rotary_emb(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                                    cos_j, sin_j, interleaved)
    qt, kt = apply_rotary_emb(torch.from_numpy(q).bfloat16(), torch.from_numpy(k).bfloat16(),
                              cos_t, sin_t, interleaved)
    for got, want, raw in ((qt, qj, q), (kt, kj, k)):
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7)
        pass_through = np.asarray(torch.from_numpy(raw).bfloat16().float())[..., rotary:]
        np.testing.assert_array_equal(got[..., rotary:], pass_through)


# ---------------------------------------------------------------------------
# the families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", list(FAMILIES))
def test_trees_and_weights_match_jax(family):
    """The port's init_params makes JAX's leaves (names and shapes: the
    norms' biases, wpe, the embedding layernorm, lm_head_b, a plain MLP's
    w_up/w_down, non-gated experts with b_up_e/b_down_e and the dense MLP
    biases JAX carries beside experts), and `params_from_numpy` carries
    JAX's quantized tree over exactly: its artifact arrays are JAX's."""
    jcfg, jparams, tcfg, model = quantized(family)
    jdense = dense_tree(family)[1]
    want = {}
    jax_flatten_artifact(jdense, "", want, {})
    ours, _ = params_to_numpy(llama.init_params(tcfg, 0, device="cpu"))
    assert {k: v.shape for k, v in ours.items()} == {k: v.shape for k, v in want.items()}
    want, got = {}, params_to_numpy(model)[0]
    jax_flatten_artifact(jparams, "", want, {})
    assert got.keys() == want.keys()
    for k, a in want.items():
        np.testing.assert_array_equal(got[k], a, err_msg=k)


@pytest.mark.parametrize("mode", ["interpret", "0"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_prefill_logits_match_jax(family, mode):
    """Prefill last logits against JAX's Pallas kernels in interpret mode
    and against its XLA oracles: the flash kernel's plain version with
    the partial or interleaved rope, starcoder2's window; the plain
    attention under ALiBi (both packages)."""
    jcfg, _, tcfg, model = quantized(family)
    ref = reference(family)[f"prefill_{mode}"]
    kernels.reset_launches()
    got = port_steps(tcfg, model, prompts_for(jcfg.vocab_size), np.zeros((3, 0), np.int64))
    assert all(n == 0 for n in kernels.launch_counts().values())  # CPU: plain versions
    assert_logits_close(got[0], ref, family)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_dense_decode_logits_and_greedy_tokens_match_jax(family):
    """Two greedy decode steps over the dense cache (the plain attention
    under each layer's mask), fed JAX's greedy tokens: logits within the
    bound at every step, and the port's greedy token JAX's wherever JAX's
    top-1/top-2 margin clears twice the bound."""
    jcfg, _, tcfg, model = quantized(family)
    ref = reference(family)
    got = port_steps(tcfg, model, prompts_for(jcfg.vocab_size), ref["greedy"])
    for i, (g, r) in enumerate(zip(got, ref["decode"])):
        assert_logits_close(g, r, (family, i))
        top = np.sort(r, -1)
        clear = top[:, -1] - top[:, -2] > 2 * _TOL_ULPS * np.abs(r).max()
        np.testing.assert_array_equal(g.argmax(-1)[clear], r.argmax(-1)[clear])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_cache_free_forward_matches_jax(family):
    """The cache-free path (training, scoring) with a left pad: every
    position's logits; the flash training kernels' plain version where
    JAX's dispatch takes its Pallas kernels."""
    jcfg, _, tcfg, model = quantized(family)
    tokens, start = cache_free_inputs(jcfg.vocab_size)
    with torch.inference_mode():
        got, _ = llama.forward(tcfg, model, torch.from_numpy(tokens).long(), None,
                               start=torch.from_numpy(start))
    ref = reference(family)["cache_free"]
    for b, s in enumerate(start):  # pad positions carry no meaning
        assert_logits_close(got[b, s:].numpy(), ref[b, s:], (family, b))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_attention_kernels_get_operands_their_card_checks_take(family, monkeypatch):
    """Each attention wrapper's card-side checks (`_check`: contiguous,
    aligned operands of the kernel's shapes) hold on the operands the
    forward hands it: the flash prefill and the paged decode of a short
    engine run. Without rope (gpt2's learned positions) q is no longer a
    view of the fused projection's output."""
    fa = importlib.import_module("bigdl_tpu_torch.ops.kernels.flash_attention")
    pa = importlib.import_module("bigdl_tpu_torch.ops.kernels.paged_attention")
    seen = []

    def checked(real, check, name):
        def run(*a, **kw):
            check(*a, **kw)
            seen.append(name)
            return real(*a, **kw)
        return run

    def flash_check(q, k, v, start=None, *_, k_scale=None, v_scale=None, **kw):
        fa._check(q, k, v, start, k_scale, v_scale)

    def paged_check(q, k, v, bt, layer, pos, start, k_scale=None, v_scale=None, **kw):
        pa._check(q, k, v, bt, pos, start, k_scale, v_scale)

    monkeypatch.setattr(kernels, "flash_attention",
                        checked(kernels.flash_attention, flash_check, "flash"))
    monkeypatch.setattr(kernels, "paged_attention",
                        checked(kernels.paged_attention, paged_check, "paged"))
    jcfg, _, tcfg, model = quantized(family)
    prompts = prompts_for(jcfg.vocab_size)
    port_steps(tcfg, model, prompts, np.zeros((3, 0), np.int64))
    eng = InferenceEngine(TorchModel(tcfg, model, "sym_int4", device="cpu"), n_slots=1,
                          max_len=32, paged=True, page_size=8)
    eng.submit(prompts[0], max_new_tokens=2)
    eng.run_until_idle()
    route = llama.attention_route(tcfg, 0, "dense", "prefill", 16)
    assert ("flash" in seen) == (route.kernel == "flash")
    assert ("paged" in seen) == (not tcfg.alibi)


def test_phi_generate_and_paged_engine_match_jax():
    """phi through `generate` (greedy tokens by the margin rule) and both
    packages' paged engines in lockstep (pages of 8; pages after every
    step, tokens by the margin rule, chosen-token logprobs within twice
    the logit bound, no page leaks)."""
    jcfg, jparams, tcfg, model = quantized("phi")
    prompts = prompts_for(jcfg.vocab_size)
    with pallas("0"):
        want = TpuModel(jcfg, jparams, "sym_int4").generate(prompts, 6)
    tm = TorchModel(tcfg, model, "sym_int4", device="cpu")
    got = tm.generate(prompts, 6)
    ref = reference("phi")
    tol = _TOL_ULPS * np.abs(ref["prefill_0"]).max()
    for b in range(len(prompts)):
        diff = np.nonzero(got[b] != want[b])[0]
        if diff.size:  # the first divergence on a near-tie of JAX's
            ctx = prompts[b] + list(want[b, :diff[0]])
            with pallas("0"):
                r = jax_steps(jcfg, jparams, [ctx], 0)[0][0][0]
            top = np.sort(r)
            assert top[-1] - top[-2] <= 2 * tol, (b, diff[0])
    kw = dict(n_slots=2, max_len=64, paged=True, page_size=8)
    with pallas("0"):
        jeng = JaxEngine(TpuModel(jcfg, jparams, "sym_int4"), logprobs_top_k=2, **kw)
        teng = InferenceEngine(tm, **kw)
        script = {0: [dict(prompt=prompts[0], max_new_tokens=8),
                      dict(prompt=prompts[0][:9] + prompts[1], max_new_tokens=8)],
                  3: [dict(prompt=prompts[2], max_new_tokens=8)]}
        reqs = _lockstep(jeng, teng, script)
    _compare(reqs, tol, [])
    assert [r.finish_reason for _, r in reqs] == ["length"] * 3
    assert teng.page_leaks() == jeng.page_leaks() == 0


def test_phixtral_dispatches_and_dense_mlp_biases_it_carries():
    """phixtral's two dispatches hold the same non-gated experts (the
    capacity dispatch at capacity factor E / k drops nothing, so it gives
    the dense combine's logits); the dense MLP biases JAX's init_params
    makes beside experts ride in the MoEBlock and move nothing."""
    _, _, tcfg, model = quantized("phixtral")
    prompts = prompts_for(tcfg.vocab_size)
    dense = port_steps(tcfg, model, prompts, np.zeros((3, 0), np.int64))[0]
    cap = dataclasses.replace(tcfg, moe_dispatch="ragged",
                              moe_capacity_factor=tcfg.num_experts / tcfg.num_experts_per_tok)
    assert_logits_close(port_steps(cap, model, prompts, np.zeros((3, 0), np.int64))[0], dense,
                        "ragged")
    moe = model.layers[0].moe
    assert set(moe.proj) == {"w_up_e", "w_down_e"} and set(moe.unused()) == {"b_up", "b_down"}
    assert moe.proj["w_up_e"].bias.shape == (4, 512)
    kept = [layer.moe.b_up.detach().clone() for layer in model.layers]
    with torch.no_grad():
        for layer in model.layers:
            layer.moe.b_up.add_(1.0)
        moved = port_steps(tcfg, model, prompts, np.zeros((3, 0), np.int64))[0]
        for layer, b in zip(model.layers, kept):
            layer.moe.b_up.copy_(b)
    np.testing.assert_array_equal(moved, dense)


def test_qlora_step_on_a_plain_mlp_matches_jax():
    """One QLoRA step over phi's sym_int4 base, rank 4 on JAX's seven
    default targets (`make_train_step`): the loss and every adapter
    gradient against JAX's (its XLA attention: the flash training
    kernels' plain reference); the w_gate adapter, which a plain MLP never reads, gets JAX's
    zero gradient (`fill_missing_grads`: optax updates every leaf)."""
    jcfg, jparams, tcfg, model = quantized("phi")
    jlora = jax_init_lora(jcfg, jax.random.PRNGKey(4), rank=4)
    rng = np.random.default_rng(4)
    for t in jlora["layers"]:
        b = jlora["layers"][t]["b"]
        jlora["layers"][t]["b"] = jnp.asarray(rng.normal(size=b.shape) * 0.02, jnp.bfloat16)
    lora = _port_lora(jlora, tcfg)
    tokens = np.random.default_rng(3).integers(1, jcfg.vocab_size, (2, 25)).astype(np.int32)
    mask = np.ones_like(tokens, np.float32)
    mask[1, :4] = 0.0
    scale = jlora["scale"]
    with pallas("0"):  # jitted whole: one compile instead of one per eager op
        j_loss, j_grads = jax.jit(jax.value_and_grad(lambda layers: jax_next_token_loss(
            jcfg, jllama.forward, jparams, {"layers": layers, "scale": scale},
            jnp.asarray(tokens), jnp.asarray(mask))))(jlora["layers"])
    step = make_train_step(tcfg, llama.forward, adamw(lora))
    loss = step(model, lora, torch.from_numpy(tokens), torch.from_numpy(mask))
    assert abs(loss.item() - float(j_loss)) <= 1e-3 * abs(float(j_loss)), loss.item()
    for t, g in j_grads.items():
        for ab in ("a", "b"):
            ref = np.asarray(g[ab], np.float32)
            got = lora.layers[t][ab].grad.float().numpy()  # the step keeps its gradients
            if t == "w_gate":
                assert not ref.any() and not got.any()
                continue
            assert np.abs(ref).max() > 0, (t, ab)
            assert np.abs(got - ref).max() <= _GRAD_FRAC * np.abs(ref).max(), (t, ab)


# ---------------------------------------------------------------------------
# streaming: the refusals and the sink shift under partial and interleaved rope
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["gpt2", "starcoder2"])
def test_streaming_refusals_match_jax(family):
    """gpt2's learned positions cannot be re-based and starcoder2's window
    already bounds the cache: both packages refuse, with the same
    message."""
    jcfg = jax_config(family)
    with pytest.raises(NotImplementedError) as jerr:
        jax_validate_streaming(jcfg, 16, 4, 1)
    with pytest.raises(NotImplementedError) as terr:
        validate_streaming(port_config(jcfg), 16, 4, 1)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("family,chunk", [("gpt_neox", 3), ("cohere", 1), ("stablelm", 8)])
def test_sink_shift_under_partial_and_interleaved_rope_matches_jax(family, chunk):
    """The eviction's -chunk-step re-rotation of the moved keys at
    gpt-neox's and stablelm's partial rope (32 of 128 lanes) and cohere's
    interleaved pairs, on a random bf16 cache: values, sinks and the
    unrotated lanes bit for bit, the rotated ones within a bf16 step."""
    jcfg = jax_config(family)
    rng = np.random.default_rng(chunk)
    L, B, S, H, D = 2, 2, 16, 1, 128
    k = jnp.asarray(rng.standard_normal((L, B, S, H, D)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((L, B, S, H, D)), jnp.bfloat16)
    jc = dataclasses.replace(jkv.init_cache(L, B, S, H, D), k=k, v=v,
                             pos=jnp.asarray(S, jnp.int32))
    want = jax_make_evict(jcfg, S, 4, chunk)(jc)
    got = make_evict(port_config(jcfg), S, 4, chunk)(port_cache(jc))
    assert got.pos == int(want.pos) == S - chunk
    wk, gk = np.asarray(want.k, np.float32), got.k.float().numpy()
    np.testing.assert_array_equal(got.v.float().numpy(), np.asarray(want.v, np.float32))
    R = jcfg.rotary_dim
    np.testing.assert_array_equal(gk[..., R:], wk[..., R:])
    np.testing.assert_array_equal(gk[:, :, :4], wk[:, :, :4])
    np.testing.assert_allclose(gk, wk, rtol=2 ** -8, atol=1e-6)
    moved = np.asarray(k, np.float32)[:, :, 4 + chunk:, :, :R]
    assert np.abs(gk[:, :, 4:S - chunk, :, :R] - moved).max() > 0.01  # the rotation bit


# ---------------------------------------------------------------------------
# the artifact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["phi", "phixtral"])
def test_artifacts_are_the_same_bytes_both_ways(family, tmp_path):
    """A phi-2-shaped and a phixtral-shaped model saved by each package:
    the same npz members (the norms' biases, lm_head_b, a plain MLP's
    w_up/b_up, the experts' b_up_e/b_down_e and the dense MLP biases JAX
    carries beside them), digests, manifest and model_config; the port
    loads JAX's (every array as JAX holds it) and JAX the port's under
    verify="full" (its greedy tokens exactly)."""
    jcfg, jparams, tcfg, model = quantized(family)
    jm = TpuModel(jcfg, jparams, "sym_int4")
    TorchModel(tcfg, model, "sym_int4", device="cpu").save_low_bit(str(tmp_path / "port"))
    jm.save_low_bit(str(tmp_path / "jax"))
    metas, members = {}, {}
    for side in ("jax", "port"):
        metas[side] = json.loads((tmp_path / side / "bigdl_tpu_config.json").read_text())
        with zipfile.ZipFile(tmp_path / side / metas[side]["weights_file"]) as zf:
            members[side] = {n: zf.read(n) for n in zf.namelist()}
    assert members["port"].keys() == members["jax"].keys()
    want = {"layers.attn_norm_b.npy", "final_norm_b.npy", "lm_head_b.npy", "layers.bqkv.npy"}
    want |= ({"layers.b_up_e.npy", "layers.b_down_e.npy", "layers.b_up.npy"}
             if family == "phixtral" else {"layers.b_up.npy", "layers.w_up@data.npy"})
    assert want <= members["jax"].keys()
    for member, raw in members["jax"].items():
        assert members["port"][member] == raw, member
    for key in ("format_version", "qtype", "model_config", "manifest", "integrity"):
        assert metas["port"][key] == metas["jax"][key], key
    loaded = AutoModelForCausalLM.load_low_bit(str(tmp_path / "jax"), device="cpu")
    got_arrays, _ = params_to_numpy(loaded.params)
    jarrays = {}
    jax_flatten_artifact(jparams, "", jarrays, {})
    assert got_arrays.keys() == jarrays.keys()
    for k, a in jarrays.items():
        np.testing.assert_array_equal(got_arrays[k], a, err_msg=k)
    with pallas("0"):
        back = JaxAuto.load_low_bit(str(tmp_path / "port"), verify="full")
        assert back.salvage_report is None and back.config == jm.config
        prompts = prompts_for(jcfg.vocab_size)
        np.testing.assert_array_equal(back.generate(prompts, 4), jm.generate(prompts, 4))
