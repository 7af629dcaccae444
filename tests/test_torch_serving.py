"""The serving engine of bigdl_tpu_torch against the JAX package's
InferenceEngine on the request scripts of tests/test_paged.py and
tests/test_serving_overload.py, both stepped in lockstep over the same
weights (JAX's parameter tree carried in with `params_from_numpy`).

Two configurations, as in test_torch_llama.py: tiny-llama and the small
kernel-eligible one. Compared: the physical pages of every slot after
every step, greedy tokens (by the margin rule below), chosen-token
logprobs, finish reasons, prefix hits (full page and sub-page), the
preemption count, and page_leaks() == 0 after the drain. The JAX engines
run on the CPU with the package's default dispatch (XLA attention and
page gather)."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu.api import TpuModel
from bigdl_tpu.api import optimize_model as jax_optimize_model
from bigdl_tpu.models import llama as jllama
from bigdl_tpu.models.config import PRESETS as JAX_PRESETS
from bigdl_tpu.models.config import ModelConfig as JaxConfig
from bigdl_tpu.quant import QTensor as JaxQTensor
from bigdl_tpu.serving.engine import InferenceEngine as JaxEngine
from bigdl_tpu_torch import TorchModel
from bigdl_tpu_torch.convert import params_from_numpy
from bigdl_tpu_torch.models import llama
from bigdl_tpu_torch.models.config import ModelConfig
from bigdl_tpu_torch.ops import kernels
from bigdl_tpu_torch.serving import InferenceEngine

# One intra-op thread: the suite runs in parallel worker processes, and a
# torch thread pool per worker oversubscribes the cores (tiny ops then
# run tens of times slower). Process-wide, like the import itself.
torch.set_num_threads(1)

CONFIGS = {
    "kernel-eligible": JaxConfig(vocab_size=512, hidden_size=256,
                                 intermediate_size=512, num_hidden_layers=2,
                                 num_attention_heads=2, num_key_value_heads=1),
    "tiny-llama": JAX_PRESETS["tiny-llama"],
}

# The logits of the two packages agree within 4 bf16 ULPs of the largest
# logit (test_torch_llama.py), so a chosen-token logprob (logit minus the
# row's logsumexp) within twice that, and a greedy token may differ only
# where JAX's top-1/top-2 margin is within twice that too. An fp8 pool
# quantizes K/V that already differ by a bf16 rounding: one code may land
# a step (a quarter of its value) apart, so fp8 engines get 8 times the
# bound.
_TOL_ULPS = 2 ** -6


def _flatten(tree, prefix, arrays, qtypes):
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
    jparams = jax.jit(functools.partial(jllama.init_params, jcfg))(
        jax.random.PRNGKey(0))
    jparams = jax.jit(lambda p: jax_optimize_model(p, jcfg, "sym_int4"))(jparams)
    arrays, qtypes = {}, {}
    _flatten(jparams, "", arrays, qtypes)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tmodel = TorchModel(tcfg, params_from_numpy(arrays, qtypes, tcfg, device="cpu"),
                        "sym_int4", device="cpu")
    with torch.inference_mode():  # the logit scale the tolerances follow
        logits, _ = llama.forward(tcfg, tmodel.params,
                                  torch.arange(1, 17)[None] % tcfg.vocab_size, None)
    tol = _TOL_ULPS * float(logits.abs().max())
    return TpuModel(jcfg, jparams, "sym_int4"), tmodel, tol


def _lockstep(jeng, teng, script, max_steps=2000):
    """Run both engines step by step; `script` maps a step index to the
    submit kwargs issued before it. Pages of every slot must agree after
    every step. Returns the (jax, port) request pairs."""
    reqs = []
    for i in range(max_steps):
        for kw in script.get(i, ()):
            reqs.append((jeng.submit(**kw), teng.submit(**kw)))
        more_j, more_t = jeng.step(), teng.step()
        assert more_j == more_t, i
        assert list(jeng.active) == list(teng.active), i
        if jeng.paged:
            assert [list(p) for p in jeng._slot_pages] == teng._slot_pages, i
        if not more_j and i >= max(script, default=0):
            return reqs
    raise AssertionError("engines did not drain")


def _compare(reqs, tol, near_ties):
    """Finish reasons, tokens (margin rule) and logprobs of each pair."""
    for jr, tr in reqs:
        assert (tr.finish_reason, tr.error is None) == (jr.finish_reason, jr.error is None)
        n = len(jr.out_tokens)
        assert len(tr.out_tokens) == n or jr.finish_reason == "stop"
        diff = [i for i, (a, b) in enumerate(zip(jr.out_tokens, tr.out_tokens)) if a != b]
        upto = diff[0] if diff else min(n, len(tr.out_tokens))
        np.testing.assert_allclose(tr.out_logprobs[:upto], jr.out_logprobs[:upto],
                                   atol=2 * tol, rtol=0)
        if diff:  # the first divergence must sit on a near-tie of JAX's
            top = sorted(jr.out_top_logprobs[upto].values(), reverse=True)
            assert top[0] - top[1] <= 2 * tol, (upto, top, tol)
            near_ties.append((jr.rid, upto))


def _engines(pair, **kw):
    jm, tm, tol = pair
    return (JaxEngine(jm, logprobs_top_k=2, **kw), InferenceEngine(tm, **kw),
            tol * (8 if kw.get("quantize_kv") else 1))


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_prefix_subpage_and_page_growth_match_jax(pair, paged):
    """test_paged.py's shared-prefix, sub-page copy and 200-token page
    growth scripts through one engine of each package."""
    jeng, teng, tol = _engines(pair, n_slots=2, max_len=256, paged=paged,
                               page_size=8)
    p1 = list(range(10, 26))  # two full pages
    script = {
        0: [dict(prompt=p1, max_new_tokens=6)],
        # after p1's pages are registered: a full-page hit + a 5-token copy,
        # a 6-token copy with no full page, and a 200-token page growth
        1: [dict(prompt=p1[:13] + [99 + i for i in range(29)], max_new_tokens=6),
            dict(prompt=p1[:6] + [77 + i for i in range(28)], max_new_tokens=6),
            dict(prompt=[3, 1, 4, 1, 5], max_new_tokens=200)],
    }
    near_ties = []
    reqs = _lockstep(jeng, teng, script)
    _compare(reqs, tol, near_ties)
    assert [r.finish_reason for _, r in reqs] == ["length"] * 4
    assert len(reqs[3][1].out_tokens) == 200
    if paged:
        assert (teng.prefix_hits, teng.prefix_partial_hits, teng.prefix_tokens_reused) \
            == (jeng.prefix_hits, jeng.prefix_partial_hits, jeng.prefix_tokens_reused) \
            == (1, 2, 11)
        assert teng.page_leaks() == jeng.page_leaks() == 0
        assert teng.radix.n_nodes == jeng.radix.n_nodes


def test_preemption_storm_matches_jax(pair):
    """test_serving_overload.py's storm: 3 slots need up to 18 pages of a
    9-page pool, so decode growth preempts; the swap is byte-exact."""
    jeng, teng, tol = _engines(pair, n_slots=3, max_len=64, paged=True,
                               page_size=8, n_pages=10)
    prompts = [[3, 1, 4, 1, 5], [9, 9, 8, 2], [2, 7, 1, 8, 3, 6]]
    near_ties = []
    reqs = _lockstep(jeng, teng, {0: [dict(prompt=p, max_new_tokens=40)
                                      for p in prompts]}, max_steps=5000)
    _compare(reqs, tol, near_ties)
    assert teng.preemptions == jeng.preemptions > 0
    assert teng.preemption_resumes == jeng.preemption_resumes
    assert [len(r.out_tokens) for _, r in reqs] == [40] * 3
    assert teng.page_leaks() == 0
    assert teng._pool.n_free + teng.radix.n_nodes == teng.n_pages - 1


def test_impossible_and_invalid_requests_match_jax(pair):
    """An impossible prompt errors at admission without blocking the
    queue; an empty prompt and an out-of-vocabulary id finish "invalid"
    at submit."""
    jm, tm, tol = pair
    V = tm.config.vocab_size
    jeng, teng, tol = _engines(pair, n_slots=2, max_len=256, paged=True,
                               page_size=16, n_pages=4)
    script = {0: [dict(prompt=list(range(1, 100)), max_new_tokens=4),
                  dict(prompt=[1, 2, 3], max_new_tokens=4),
                  dict(prompt=[], max_new_tokens=4),
                  dict(prompt=[1, V], max_new_tokens=4)]}
    near_ties = []
    reqs = _lockstep(jeng, teng, script)
    _compare(reqs, tol, near_ties)
    assert [r.finish_reason for _, r in reqs] == ["error", "length", "invalid", "invalid"]
    assert "pages" in reqs[0][1].error and len(reqs[1][1].out_tokens) == 4
    assert teng.page_leaks() == 0
    assert teng.finish_reasons == jeng.finish_reasons


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_fp8_pools_match_jax(pair, paged):
    """quantize_kv on both pools: fp8 codes and scales, the dense pool's
    prefill through the flash kernel's fp8 arm (its plain version here)."""
    jeng, teng, tol = _engines(pair, n_slots=2, max_len=128, paged=paged,
                               page_size=16, quantize_kv=True)
    assert teng.cache.k.dtype == torch.float8_e5m2
    assert teng.cache.k_scale.dtype == (torch.float32 if paged else torch.float16)
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8], [11, 12, 13]]
    kernels.reset_launches()
    near_ties = []
    reqs = _lockstep(jeng, teng, {0: [dict(prompt=p, max_new_tokens=10)
                                      for p in prompts]})
    _compare(reqs, tol, near_ties)
    assert all(n == 0 for n in kernels.launch_counts().values())  # CPU: plain
    assert teng.page_leaks() == 0


def test_sampling_penalty_and_cancel(pair):
    """A sampled request stays in the vocabulary and is reproducible from
    the seed; a penalized greedy request matches JAX by the margin rule;
    a cancel frees the slot and its pages."""
    jm, tm, tol = pair
    outs = []
    for _ in range(2):
        eng = InferenceEngine(tm, n_slots=2, max_len=128, paged=True, page_size=16,
                              seed=3)
        s = eng.submit([5, 6, 7], max_new_tokens=12, do_sample=True,
                       temperature=0.8, top_p=0.9)
        c = eng.submit([8, 9, 10, 11], max_new_tokens=50)
        for _ in range(4):
            eng.step()
        eng.cancel(c)
        eng.run_until_idle()
        assert s.finish_reason == "length" and c.finish_reason == "stop"
        assert len(c.out_tokens) < 50 and eng.page_leaks() == 0
        assert all(0 <= t < tm.config.vocab_size for t in s.out_tokens)
        outs.append(s.out_tokens)
    assert outs[0] == outs[1]
    jeng, teng, tol = _engines(pair, n_slots=1, max_len=64)
    near_ties = []
    reqs = _lockstep(jeng, teng, {0: [dict(prompt=[3, 1, 4, 1, 5], max_new_tokens=16,
                                           repetition_penalty=1.5)]})
    _compare(reqs, tol, near_ties)


def test_out_of_slice_arguments_raise(pair):
    """Every argument of JAX's engine is ported (the control plane is held
    against JAX in test_torch_serving_control.py and
    test_torch_journal_tracing.py): what raises now is an argument JAX's
    engine does not take, and JAX's own refusals."""
    jm, tm, tol = pair
    with pytest.raises(TypeError, match="no_such_argument"):
        InferenceEngine(tm, n_slots=1, max_len=64, no_such_argument=1)
    for kw, err, match in (
            ({"prefill_chunk_tokens": 8}, ValueError, "requires paged=True"),
            ({"prefill_chunk_tokens": 0, "paged": True}, ValueError, ">= 1"),
            ({"prefill_chunk_tokens": 8, "paged": True, "speculative": True,
              "draft_params": tm.params}, NotImplementedError, "draft admission")):
        with pytest.raises(err, match=match):
            InferenceEngine(tm, n_slots=1, max_len=64, **kw)
        with pytest.raises(err, match=match):
            JaxEngine(jm, n_slots=1, max_len=64,
                      **{**kw, **({"draft_params": jm.params} if "draft_params" in kw else {})})
    eng = InferenceEngine(tm, n_slots=1, max_len=64)
    # adapters are ported (test_torch_adapters.py): naming one on an engine
    # without a registry finishes "invalid" at submit, as in JAX
    req = eng.submit([1, 2], adapter="a")
    assert req.done and req.finish_reason == "invalid" and "registry" in req.error
    # the drain is ported: an engine with nothing in flight drains at once
    assert eng.drain() is True
    late = eng.submit([1, 2])
    assert (late.finish_reason, late.shed_kind) == ("shed", "draining")
