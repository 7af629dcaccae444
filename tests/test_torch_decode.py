"""Self-speculative and prompt-lookup decoding in the port against the JAX
package, on the CPU (tiny-llama; the port on its plain versions).

`rejection_accept` is held against JAX's bit for bit on JAX's own noise
(the uniforms of its acceptance draw and the Gumbel noise of its
`jax.random.categorical` residual draw, crossed over as arrays), over
rows that are greedy, sampled and neither; without injected noise the
port's draw keeps the output law (a total-variation check as JAX's).

End to end, both packages run the same weights: tiny-llama's dense bf16
target and JAX's sym_int4 draft of it (`optimize_model`), crossed over
with `params_from_numpy`. Greedy speculative tokens (adaptive drafting
off and on, a perfect and a garbage draft) and lookup tokens (candidates
that match, and none) are held equal to JAX's and to the port's plain
`generate`, with JAX's round counters; the port's self-draft equals
JAX's byte for byte. Then the API: `generate_speculative` with the
cached self-draft, its refusal for a quantized target, and the
performance-mode switch, taken under the flag and not under each of
JAX's exclusions.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.api import TpuModel
from bigdl_tpu.api import optimize_model as jax_optimize_model
from bigdl_tpu.decode import lookup_generate as jax_lookup_generate
from bigdl_tpu.decode.speculative import rejection_accept as jax_rejection_accept
from bigdl_tpu.decode.speculative import speculative_tokens as jax_speculative_tokens
from bigdl_tpu.generate import GenerationConfig as JaxGen
from bigdl_tpu.models import llama as jllama
from bigdl_tpu.models.config import PRESETS as JAX_PRESETS
from bigdl_tpu_torch import TorchModel, decode
from bigdl_tpu_torch.convert import params_from_numpy
from bigdl_tpu_torch.generate import GenerationConfig, pad_prompts
from bigdl_tpu_torch.models import llama
from bigdl_tpu_torch.models.config import ModelConfig
from bigdl_tpu_torch.quant import QTensor
from test_torch_llama import _flatten

torch.set_num_threads(1)

JCFG = JAX_PRESETS["tiny-llama"]
TCFG = ModelConfig(**dataclasses.asdict(JCFG))
PROMPT = [[5, 6, 7, 8, 9, 10, 11]]


def _port(jparams):
    arrays, qtypes = {}, {}
    _flatten(jparams, "", arrays, qtypes)
    return params_from_numpy(arrays, qtypes, TCFG, device="cpu")


@functools.lru_cache(maxsize=None)
def models(draft_seed=None):
    """(JAX target, JAX draft, port target, port draft): tiny-llama's
    dense bf16 weights from PRNGKey(0) and the sym_int4 draft JAX's
    optimize_model makes of them — or, with draft_seed, a dense model of
    other weights (a garbage draft)."""
    jt = jllama.init_params(JCFG, jax.random.PRNGKey(0))
    if draft_seed is None:
        jd = jax_optimize_model(jt, JCFG, "sym_int4")
    else:
        jd = jllama.init_params(JCFG, jax.random.PRNGKey(draft_seed))
    return jt, jd, _port(jt), _port(jd)


def _jax_spec(jt, jd, prompts, n, k, **kw):
    tokens, start = pad_prompts(prompts, 0)
    out, rounds, drafted, matched = jax_speculative_tokens(
        JCFG, jt, jd, jnp.asarray(tokens), jnp.asarray(start), jax.random.PRNGKey(0),
        JaxGen(max_new_tokens=n), jllama.forward, cache_len=128, draft_k=k, **kw)
    return np.asarray(out), int(rounds), int(drafted), int(matched)


def _port_spec(tt, td, prompts, n, k, **kw):
    tokens, start = pad_prompts(prompts, 0)
    out, rounds, drafted, matched = decode.speculative_tokens(
        TCFG, tt, td, torch.as_tensor(tokens), torch.as_tensor(start), None,
        GenerationConfig(max_new_tokens=n), cache_len=128, draft_k=k, **kw)
    return out.numpy(), rounds, drafted, matched


def _plain(tt, prompts, n):
    return TorchModel(TCFG, tt, "bf16", device="cpu").generate(prompts, n)


# ---------------------------------------------------------------------------
# rejection_accept
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_rejection_accept_matches_jax_on_injected_noise(seed):
    """Rows greedy, sampled and neither, drafts that mostly follow the
    target (some rows accept all K-1 and draw the bonus token): n_acc
    and extra equal JAX's exactly on JAX's uniforms and Gumbel noise."""
    B, K, V = 9, 4, 40
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, K, V)).astype(np.float32) * 3.0
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    greedy = logits.argmax(-1).astype(np.int32)
    drafts = np.where(rng.random((B, K)) < 0.8, greedy,
                      rng.integers(0, V, (B, K))).astype(np.int32)
    drafts[0] = greedy[0]  # a full acceptance on a greedy row
    row_greedy = np.array([1, 1, 1, 0, 0, 0, 0, 0, 0], bool)
    row_sampled = np.array([0, 0, 0, 1, 1, 1, 1, 0, 0], bool)
    key = jax.random.PRNGKey(100 + seed)
    want_n, want_x = jax_rejection_accept(key, jnp.asarray(probs), jnp.asarray(drafts),
                                          jnp.asarray(greedy), jnp.asarray(row_greedy),
                                          jnp.asarray(row_sampled))
    k_u, k_res = jax.random.split(key)
    u = np.array(jax.random.uniform(k_u, (B, K - 1)))
    gumbel = np.array(jax.random.gumbel(k_res, (B, V)))
    got_n, got_x = decode.rejection_accept(
        torch.from_numpy(probs), torch.from_numpy(drafts), torch.from_numpy(greedy),
        torch.from_numpy(row_greedy), torch.from_numpy(row_sampled),
        u=torch.from_numpy(u), gumbel=torch.from_numpy(gumbel))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    assert (got_n.numpy()[7:] == 0).all()  # rows in neither mask accept none


def test_rejection_accept_keeps_the_output_law():
    """Drawing its own noise from a generator, the first emitted token's
    empirical law is p_0 for an arbitrary draft (TV < 3 %, as JAX's
    test), and greedy rows keep the argmax-match rule."""
    V, K, n = 6, 4, 20000
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(size=(1, K, V)).astype(np.float32) * 1.5)
    probs = torch.softmax(logits, -1)
    drafts = torch.tensor([[2, 4, 1, 3]])
    greedy = logits.argmax(-1)
    g = torch.Generator().manual_seed(1)
    n_acc, extra = decode.rejection_accept(
        probs.expand(n, K, V), drafts.expand(n, K), greedy.expand(n, K),
        torch.zeros(n, dtype=torch.bool), torch.ones(n, dtype=torch.bool), generator=g)
    first = torch.where(n_acc > 0, drafts[0, 0], extra)
    emp = torch.bincount(first, minlength=V).double() / n
    tv = 0.5 * (emp - probs[0, 0].double()).abs().sum().item()
    assert tv < 0.03, tv
    n_acc, extra = decode.rejection_accept(probs, drafts, greedy, torch.tensor([True]),
                                           torch.tensor([False]), generator=g)
    want = 0
    while want < K - 1 and int(drafts[0, want]) == int(greedy[0, want]):
        want += 1
    assert int(n_acc[0]) == want and int(extra[0]) == int(greedy[0, want])


# ---------------------------------------------------------------------------
# speculative decoding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("adaptive", [False, True])
def test_speculative_matches_jax_and_plain(adaptive):
    """The sym_int4 draft of the target, draft_k 4: the port's tokens and
    round counters equal JAX's, and the tokens equal plain generate's."""
    jt, jd, tt, td = models()
    want = _jax_spec(jt, jd, PROMPT, 24, 4, adaptive=adaptive)
    got = _port_spec(tt, td, PROMPT, 24, 4, adaptive=adaptive)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:], (got[1:], want[1:])
    np.testing.assert_array_equal(got[0], _plain(tt, PROMPT, 24))
    assert want[1] < 24  # the draft is accepted at times


def test_speculative_perfect_draft_accepts_k_minus_1():
    """The target as its own draft: every round accepts K-1 drafts."""
    jt, _, tt, _ = models()
    got = _port_spec(tt, tt, PROMPT, 24, 4, adaptive=False)
    want = _jax_spec(jt, jt, PROMPT, 24, 4, adaptive=False)
    assert got[1:] == want[1:] and got[3] == 3 * got[1], got[1:]
    np.testing.assert_array_equal(got[0], _plain(tt, PROMPT, 24))


def test_speculative_garbage_draft_and_adaptive_stop():
    """A draft of other weights: the tokens stay plain generate's, and
    adaptive drafting (th 0.95, min_step 1) drafts fewer than K a round
    where fixed drafting drafts K; counters equal JAX's in both modes."""
    jt, jd, tt, td = models(draft_seed=99)
    prompt = [[3, 1, 4, 1, 5, 9, 2, 6]]
    plain = _plain(tt, prompt, 20)
    for adaptive in (False, True):
        kw = dict(adaptive=adaptive, min_step_draft=1, th_stop_draft=0.95)
        got = _port_spec(tt, td, prompt, 20, 6, **kw)
        want = _jax_spec(jt, jd, prompt, 20, 6, **kw)
        np.testing.assert_array_equal(got[0], plain)
        np.testing.assert_array_equal(want[0], plain)
        assert got[1:] == want[1:], (adaptive, got[1:], want[1:])
        per_round = got[2] / got[1]
        assert per_round == 6.0 if not adaptive else per_round < 6.0


def test_speculative_generate_eos_and_self_draft_bytes():
    """speculative_generate with an EOS id met mid-round: pad after it, as
    JAX's mask_after_eos leaves it; and the port's self-draft holds JAX's
    sym_int4 bytes."""
    jt, jd, tt, td = models()
    plain = _plain(tt, PROMPT, 24)
    eos = int(plain[0, 9])
    got = decode.speculative_generate(TCFG, tt, td, PROMPT, max_new_tokens=24,
                                      eos_token_id=eos, pad_token_id=7)
    free = plain[0]
    j = int(np.nonzero(free == eos)[0][0])
    np.testing.assert_array_equal(got[0, :j + 1], free[:j + 1])
    assert (got[0, j + 1:] == 7).all()
    draft = TorchModel(TCFG, tt, "bf16", device="cpu").self_draft_params()
    for i, layer in enumerate(draft.layers):
        for name in ("wo", "w_down"):
            w = layer.proj[name].w
            assert isinstance(w, QTensor) and w.qtype == "sym_int4"
            np.testing.assert_array_equal(w.data.numpy(), np.asarray(jd["layers"][name].data[i]))
            np.testing.assert_array_equal(w.scales.float().numpy(),
                                          np.asarray(jd["layers"][name].scales[i], np.float32))
        assert layer.attn_norm.data_ptr() == tt.layers[i].attn_norm.data_ptr()


# ---------------------------------------------------------------------------
# prompt lookup
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prompt,k,ngram,n", [
    ([5, 6, 7, 8, 5, 6, 7, 8, 5, 6], 4, 3, 20),  # repetitive: lookup hits
    ([1, 2, 3, 4, 5, 6, 7], 3, 2, 12),  # no repeated n-gram at first
], ids=["match", "no-match"])
def test_lookup_matches_jax_and_plain(prompt, k, ngram, n):
    jt, _, tt, _ = models()
    want = jax_lookup_generate(JCFG, jt, [prompt], jllama.forward, max_new_tokens=n,
                               lookahead=k, max_ngram=ngram)
    got = decode.lookup_generate(TCFG, tt, [prompt], max_new_tokens=n, lookahead=k,
                                 max_ngram=ngram)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, _plain(tt, [prompt], n))


def test_lookup_rounds_and_candidate_rule():
    """A history that repeats: the most recent earlier occurrence, longest
    n first, gives the candidates; with none, a round emits one token."""
    hist = np.array([0, 0, 4, 5, 6, 9, 4, 5, 6, 8, 1, 4, 5, 6, 0, 0, 0])
    cand = decode.lookup._find_candidate(hist, 14, 2, 3, 3)
    np.testing.assert_array_equal(cand, [8, 1, 4])  # the match at 6, not at 2
    assert decode.lookup._find_candidate(hist, 14, 7, 3, 3) is None  # 2 and 6 before start
    _, _, tt, _ = models()
    tokens, start = pad_prompts([[1, 2, 3, 4, 5, 6, 7]], 0)
    out, rounds, matched = decode.lookup_tokens(
        TCFG, tt, torch.as_tensor(tokens), torch.as_tensor(start), None,
        GenerationConfig(max_new_tokens=12), cache_len=128, lookahead=3, max_ngram=2)
    # each round emits n_acc + 1; the last may run past the budget by K-1
    assert 11 <= rounds + matched <= 11 + 2 and out.shape == (1, 12)


# ---------------------------------------------------------------------------
# the API
# ---------------------------------------------------------------------------

def _assert_margin_rule(jt, prompt, got, want):
    """Equal tokens, or a first divergence where JAX's top-1/top-2 margin
    (its cache-free logits along its own tokens) is within twice the
    packages' logit bound, 4 bf16 ULPs of the largest logit
    (test_torch_llama.py)."""
    diff = np.nonzero(got != want)[0]
    if diff.size:
        i = int(diff[0])
        seq = jnp.asarray([list(prompt) + [int(x) for x in want[:i]]], jnp.int32)
        logits = np.asarray(jllama.forward(JCFG, jt, seq, None)[0], np.float32)[0, -1]
        top = np.sort(logits)
        assert top[-1] - top[-2] <= 2 * 2 ** -6 * np.abs(logits).max(), (i, top[-2:])


@pytest.mark.parametrize("prompt", [[1, 2, 3, 4, 5], [2, 7, 1, 8, 2, 8, 1, 8]])
def test_generate_speculative_api_matches_jax(prompt):
    """The bf16 target with its cached sym_int4 self-draft: plain
    generate's tokens, and JAX's generate_speculative's by the margin
    rule (the first prompt's first token is a near-tie: top-1/top-2
    margin 0.002 on logits of 0.64); the target stays dense."""
    jt, _, tt, _ = models()
    tm = TorchModel(TCFG, tt, "bf16", device="cpu")
    got = tm.generate_speculative([prompt], max_new_tokens=8, draft_k=3)
    want = TpuModel(JCFG, jt, "bf16").generate_speculative([prompt], max_new_tokens=8, draft_k=3)
    np.testing.assert_array_equal(got, tm.generate([prompt], 8))
    _assert_margin_rule(jt, prompt, got[0], np.asarray(want)[0])
    assert tm.self_draft_params() is tm.self_draft_params()
    assert all(lin.qtype is None for lin in tm.params.layers[0].proj.values())


@pytest.mark.parametrize("qtype", ["sym_int4", "q4_k_m"])
def test_self_draft_refuses_a_quantized_target(qtype):
    _, _, _, td = models()
    tm = TorchModel(TCFG, td, qtype, device="cpu")
    with pytest.raises(ValueError, match="already quantized"):
        tm.self_draft_params()
    with pytest.raises(ValueError, match="already quantized"):
        tm.generate_speculative([[1, 2, 3]], max_new_tokens=4)
    # an explicit draft runs: the model as its own draft
    out = tm.generate_speculative([[1, 2, 3]], draft_params=td, max_new_tokens=6)
    np.testing.assert_array_equal(out, tm.generate([[1, 2, 3]], 6))


LONG = list(np.random.default_rng(5).integers(1, 256, 64)) * 4  # 256 tokens


@pytest.mark.parametrize("case", ["taken", "sampled", "streaming", "compress_kv",
                                  "penalty", "short"])
def test_performance_mode_switch(case, monkeypatch):
    """BIGDL_TPU_PERFORMANCE_MODE switches a greedy generate of a prompt
    of 256 or more to prompt lookup — the tokens then are lookup's, and
    plain greedy generate's — and not under JAX's exclusions: sampling,
    streaming, SnapKV, a repetition penalty, a shorter prompt."""
    _, _, tt, _ = models()
    tm = TorchModel(TCFG, tt, "bf16", device="cpu")
    calls = []
    real = decode.lookup_generate

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(decode, "lookup_generate", spy)
    monkeypatch.setenv("BIGDL_TPU_PERFORMANCE_MODE", "1")
    kw = {"sampled": dict(do_sample=True), "streaming": dict(streaming_window=300),
          "compress_kv": dict(compress_kv=128), "penalty": dict(repetition_penalty=1.2),
          }.get(case, {})
    prompt = [LONG[:200]] if case == "short" else [LONG]
    out = tm.generate(prompt, 10, **kw)
    assert len(calls) == (case == "taken"), (case, calls)
    monkeypatch.delenv("BIGDL_TPU_PERFORMANCE_MODE")
    if case == "taken":
        assert calls[0]["max_new_tokens"] == 10
        np.testing.assert_array_equal(out, tm.generate(prompt, 10))
        np.testing.assert_array_equal(out, real(TCFG, tt, prompt, max_new_tokens=10))
