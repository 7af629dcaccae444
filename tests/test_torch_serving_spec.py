"""Speculative serving in the port's InferenceEngine against the port's own
non-speculative engine and the JAX package's engines, on the CPU (the
scenarios of tests/test_serving.py's speculative tests).

The target is tiny-llama's dense bf16 model (JAX's weights crossed over
with `params_from_numpy`) with its sym_int4 self-draft, or itself as a
perfect draft; a kernel-eligible sym_int4 config (hidden 256) serves
adapters through the LoRA GEMV's plain version. Greedy rows must emit
the non-speculative engine's tokens exactly over the dense pool (the
verify and the decode step both run the plain masked attention), over
pages by the margin rule of test_torch_serving.py (the decode step runs
the paged kernel's plain version there), and JAX's by the margin rule;
logprobs agree within that file's bound. Sampled and penalty rows ride
along, adaptive drafting leaves the tokens as they are, prefix hits and
preemption keep them and leak no page, a request whose window ends
flush with max_len keeps its whole budget (the reserve past max_len),
a poisoned row is quarantined alone, and JAX's refusals stand.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu.api import TpuModel
from bigdl_tpu.models import llama as jllama
from bigdl_tpu.models.config import PRESETS as JAX_PRESETS
from bigdl_tpu.serving.engine import InferenceEngine as JaxEngine
from bigdl_tpu_torch import ModelConfig, TorchModel, optimize_model
from bigdl_tpu_torch.convert import params_from_numpy
from bigdl_tpu_torch.models import llama
from bigdl_tpu_torch.ops import kernels
from bigdl_tpu_torch.serving import InferenceEngine
from bigdl_tpu_torch.serving.adapters import AdapterRegistry, save_adapter
from bigdl_tpu_torch.train import init_lora
from test_torch_llama import _flatten

torch.set_num_threads(1)

JCFG = JAX_PRESETS["tiny-llama"]
TCFG = ModelConfig(**dataclasses.asdict(JCFG))
_TOL_ULPS = 2 ** -6  # test_torch_serving.py: 4 bf16 ULPs of the largest logit
PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8], [9, 9, 8, 2, 4], [5, 6, 7, 8, 9, 10, 11]]


@pytest.fixture(scope="module")
def setup():
    """(JAX model, port model, logit tolerance): tiny-llama dense bf16."""
    jparams = jllama.init_params(JCFG, jax.random.PRNGKey(0))
    arrays, qtypes = {}, {}
    _flatten(jparams, "", arrays, qtypes)
    tm = TorchModel(TCFG, params_from_numpy(arrays, qtypes, TCFG, device="cpu"), "bf16",
                    device="cpu")
    with torch.inference_mode():
        logits, _ = llama.forward(TCFG, tm.params, torch.arange(1, 17)[None], None)
    return TpuModel(JCFG, jparams, "bf16"), tm, _TOL_ULPS * float(logits.abs().max())


def _serve(eng, specs):
    reqs = [eng.submit(**sp) for sp in specs]
    eng.run_until_idle()
    assert eng.page_leaks() == 0
    return reqs


def _same(a, b, tol):
    """Equal tokens and finish reasons, logprobs within 2 tol."""
    for ra, rb in zip(a, b):
        assert ra.out_tokens == rb.out_tokens and ra.finish_reason == rb.finish_reason
        np.testing.assert_allclose(ra.out_logprobs, rb.out_logprobs, atol=2 * tol, rtol=0)


def _margin_rule(refs, reqs, tol):
    """Tokens equal the reference's up to a first divergence where the
    reference's top-1/top-2 margin (its engine's top-2 logprobs) is
    within 2 tol, with logprobs within 2 tol before it. Returns the
    divergences."""
    ties = []
    for rr, r in zip(refs, reqs):
        diff = [i for i, (a, b) in enumerate(zip(rr.out_tokens, r.out_tokens)) if a != b]
        upto = diff[0] if diff else len(rr.out_tokens)
        np.testing.assert_allclose(r.out_logprobs[:upto], rr.out_logprobs[:upto],
                                   atol=2 * tol, rtol=0)
        if diff:
            top = sorted(rr.out_top_logprobs[upto].values(), reverse=True)
            assert top[0] - top[1] <= 2 * tol, (upto, top, tol)
            ties.append((rr.rid, upto, top[0] - top[1]))
        else:
            assert len(rr.out_tokens) == len(r.out_tokens)
    return ties


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_greedy_equals_plain_engine_and_jax(setup, paged):
    """The self-draft at draft_k 4 over both pools: the non-speculative
    engine's tokens (and logprobs within the bound) — exactly over the
    dense pool, where the verify and the decode step both run the plain
    masked attention; over pages the decode step runs the paged kernel's
    plain version and the verify the plain attention over the gathered
    pages, so there by the margin rule (this trace diverges once, at the
    fourth request's token 6 on a margin of 0.00195 nat, tol 0.01); JAX's speculative engine's tokens by
    the margin rule (JAX's own plain engine gives the margins: its
    speculative engine emits the same tokens); more than one token a
    round."""
    jm, tm, tol = setup
    kw = dict(n_slots=2, max_len=128, paged=paged, page_size=16)
    specs = [dict(prompt=p, max_new_tokens=12) for p in PROMPTS]
    plain = _serve(InferenceEngine(tm, logprobs_top_k=2, **kw), specs)
    eng = InferenceEngine(tm, speculative=True, draft_k=4, **kw)
    spec = _serve(eng, specs)
    if paged:
        assert len(_margin_rule(plain, spec, tol)) <= 1
    else:
        _same(spec, plain, tol)
    assert eng.spec_rounds > 0 and eng.spec_emitted == 4 * 12 - len(PROMPTS)
    assert eng.spec_emitted / eng.spec_rounds > 1.0, (eng.spec_emitted, eng.spec_rounds)
    jplain = JaxEngine(jm, logprobs_top_k=2, **kw)
    jreqs = [jplain.submit(**sp) for sp in specs]
    jplain.run_until_idle()
    jspec = JaxEngine(jm, speculative=True, draft_k=4, **kw)
    jsreqs = [jspec.submit(**sp) for sp in specs]
    jspec.run_until_idle()
    assert [r.out_tokens for r in jsreqs] == [r.out_tokens for r in jreqs]
    _margin_rule(jreqs, spec, tol)


def test_sampled_and_penalty_rows_ride_along(setup):
    """A mixed batch: greedy rows keep the plain engine's tokens; a
    penalty row accepts no draft and takes the penalty sampler's token
    (the plain engine's, logprobs of the penalized law); sampled rows
    keep their budget, stay in the vocabulary and repeat under one seed."""
    _, tm, tol = setup
    kw = dict(n_slots=4, max_len=128, paged=True, page_size=16, seed=3)
    specs = [dict(prompt=PROMPTS[0], max_new_tokens=10),
             dict(prompt=PROMPTS[1], max_new_tokens=10, do_sample=True, temperature=0.8,
                  top_p=0.9),
             dict(prompt=PROMPTS[2], max_new_tokens=10, repetition_penalty=1.3),
             dict(prompt=PROMPTS[3], max_new_tokens=10, do_sample=True, temperature=0.7)]
    plain = _serve(InferenceEngine(tm, **kw), specs)
    runs = [_serve(InferenceEngine(tm, speculative=True, **kw), specs) for _ in range(2)]
    for spec in runs:
        _same([spec[0], spec[2]], [plain[0], plain[2]], tol)
        for r in (spec[1], spec[3]):
            assert r.finish_reason == "length" and len(r.out_tokens) == 10
            assert all(0 <= t < TCFG.vocab_size for t in r.out_tokens)
            assert all(lp <= 0 for lp in r.out_logprobs)
    assert [r.out_tokens for r in runs[0]] == [r.out_tokens for r in runs[1]]


def test_adaptive_draft_identical_and_ladder(setup):
    """adaptive_draft with a perfect draft: the tokens of plain serving,
    the ladder [2, 4] never downshifted; sustained low acceptance
    downshifts it and full acceptance climbs back, as JAX's."""
    _, tm, tol = setup
    kw = dict(n_slots=2, max_len=128)
    specs = [dict(prompt=p, max_new_tokens=12) for p in PROMPTS[:3]]
    plain = _serve(InferenceEngine(tm, **kw), specs)
    eng = InferenceEngine(tm, speculative=True, draft_params=tm.params, draft_k=4,
                          adaptive_draft=True, **kw)
    assert eng._k_ladder == [2, 4]
    _same(_serve(eng, specs), plain, tol)
    assert eng._cur_k == 4
    eng._cur_k, eng._accept_ema = 4, None
    for _ in range(8):
        eng._adapt_draft_k(np.zeros(2, np.int32))
    assert eng._cur_k == 2
    for _ in range(8):
        eng._adapt_draft_k(np.full(2, eng._cur_k - 1, np.int32))
    assert eng._cur_k == 4
    assert InferenceEngine(tm, speculative=True, draft_k=8, adaptive_draft=True,
                           **kw)._k_ladder == [2, 4, 8]


def test_logprobs_plain_and_speculative_agree(setup):
    """Every emitted token carries the target's logprob: the speculative
    engine reports plain serving's (the verify scores with the target);
    a penalty row the logprob of the penalized law it was drawn from."""
    _, tm, tol = setup
    for extra in ({}, {"repetition_penalty": 1.3}):
        sp = [dict(prompt=[3, 1, 4, 1, 5, 9], max_new_tokens=10, **extra)]
        plain = _serve(InferenceEngine(tm, n_slots=2, max_len=128), sp)
        spec = _serve(InferenceEngine(tm, n_slots=2, max_len=128, speculative=True,
                                      draft_params=tm.params, draft_k=4), sp)
        assert len(spec[0].out_logprobs) == 10 and all(lp <= 0 for lp in spec[0].out_logprobs)
        _same(spec, plain, tol)


@pytest.fixture(scope="module")
def fused(tmp_path_factory):
    """A kernel-eligible sym_int4 model (hidden 256), a registry of three
    adapters (ranks 2, 3, 5; B != 0 from a seed) saved by the port, and
    the logit tolerance."""
    cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1)
    tm = TorchModel(cfg, optimize_model(llama.init_params(cfg, 0, device="cpu"), cfg),
                    "sym_int4", device="cpu")
    root = tmp_path_factory.mktemp("adapters")
    for r in (2, 3, 5):
        lo = init_lora(cfg, seed=r, rank=r, alpha=2.0 * r, device="cpu")
        g = torch.Generator().manual_seed(100 + r)
        with torch.no_grad():
            for t in lo.layers.values():
                t["b"].copy_(torch.randn(t["b"].shape, generator=g) * 0.05)
        save_adapter(os.path.join(root, f"t{r}.npz"), lo)
    with torch.inference_mode():
        logits, _ = llama.forward(cfg, tm.params, torch.arange(1, 17)[None], None)
    return tm, str(root), _TOL_ULPS * float(logits.abs().max())


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_adapters_speculative(fused, paged):
    """Four slots, three adapters and a base row, the model as its own
    explicit draft (the base draft is advisory): the verify applies the
    slots' adapters through the LoRA GEMV at 4 slots x K = 16 rows (its
    plain version here), and every request emits the non-speculative
    adapter engine's tokens by the margin rule (the LoRA GEMV's plain
    version at 16 rows and at 4 may round apart)."""
    tm, root, tol = fused
    jobs = [(p, a) for p, a in zip(PROMPTS, [None, "t2", "t3", "t5"])]
    kw = dict(n_slots=4, max_len=128, paged=paged, page_size=16)

    def run(**extra):
        eng = InferenceEngine(tm, adapters=AdapterRegistry(dir=root), **kw, **extra)
        reqs = [eng.submit(p, max_new_tokens=8, adapter=a) for p, a in jobs]
        eng.run_until_idle()
        assert eng.page_leaks() == 0
        return eng, reqs

    _, plain = run(logprobs_top_k=2)
    rows, real = [], kernels.qmatmul_lora

    def spy(x, *a):
        rows.append(x.reshape(-1, x.shape[-1]).shape[0])
        return real(x, *a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kernels, "qmatmul_lora", spy)
        eng, spec = run(speculative=True, draft_params=tm.params, draft_k=4)
    _margin_rule(plain, spec, tol)
    assert 16 in rows
    assert eng.spec_emitted / eng.spec_rounds > 1.0


def test_paged_prefix_hits_and_preemption_resume(setup):
    """Shared prefixes hit the radix cache (the draft prefills its whole
    context); a pool too small for decode growth preempts and resumes
    (the draft row rebuilt from prompt + output): tokens of the
    unpreempted run, no page leaked."""
    _, tm, tol = setup
    prefix = list(range(20, 52))  # two full pages of 16
    specs = [dict(prompt=prefix + [3 + i, 7], max_new_tokens=40) for i in range(3)]
    kw = dict(n_slots=3, max_len=128, paged=True, page_size=16, speculative=True)
    ref_eng = InferenceEngine(tm, **kw)
    ref = _serve(ref_eng, specs)
    assert ref_eng.prefix_hits >= 2
    eng = InferenceEngine(tm, n_pages=11, **kw)
    got = _serve(eng, specs)
    assert eng.preemptions > 0 and eng.preemption_resumes > 0
    _same(got, ref, tol)
    assert all(r.finish_reason == "length" and len(r.out_tokens) == 40 for r in got)
    assert eng._pool.n_free + eng.radix.n_nodes == eng.n_pages - 1


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_window_flush_with_max_len_keeps_its_budget(setup, paged):
    """A prompt of max_len - max_new_tokens: the decode window ends flush
    with max_len, and a verify round starting within K - 1 of it writes
    past it (the self-draft accepts partly, so rounds start off the
    K-grid). The pools keep that reserve: paged, the request keeps its
    whole budget (without the reserve its last round finds no logical
    page and ends it "length" one token short); dense, the target's and
    the draft's rows are max_len + K - 1 long, as JAX's; and plain
    serving's tokens."""
    _, tm, tol = setup
    K, max_len, n = 4, 128, 16
    specs = [dict(prompt=list(np.random.default_rng(1).integers(1, 256, max_len - n)),
                  max_new_tokens=n)]
    kw = dict(n_slots=2, max_len=max_len, paged=paged, page_size=16)
    plain = _serve(InferenceEngine(tm, **kw), specs)
    eng = InferenceEngine(tm, speculative=True, draft_k=K, **kw)
    if paged:
        assert eng.max_pages_per_row * 16 >= max_len + K - 1
    else:
        assert eng.cache.max_len == eng.dcache.max_len == max_len + K - 1
    spec = _serve(eng, specs)
    assert spec[0].finish_reason == "length" and len(spec[0].out_tokens) == n
    _same(spec, plain, tol)


def test_non_finite_row_is_quarantined_alone(setup):
    """A verify whose logprobs for one row are not finite finishes that
    request "error"; the other slot serves on."""
    _, tm, _ = setup
    eng = InferenceEngine(tm, n_slots=2, max_len=128, speculative=True)
    real = eng._spec_decode

    def poisoned(K):
        choice, lp, n_acc, drafts = real(K)
        lp[0] = float("nan")
        return choice, lp, n_acc, drafts

    eng._spec_decode = poisoned
    bad, good = _serve(eng, [dict(prompt=PROMPTS[0], max_new_tokens=6),
                             dict(prompt=PROMPTS[1], max_new_tokens=6)])
    assert bad.finish_reason == "error" and "non-finite" in bad.error
    assert good.finish_reason == "length" and len(good.out_tokens) == 6


def test_refusals_match_jax(setup):
    """draft_k < 2, adaptive_draft without speculative, logprobs_top_k with
    speculative, a sym_int4 target's self-draft and chunked prefill with
    speculative refuse as in JAX."""
    jm, tm, _ = setup
    q = TorchModel(TCFG, optimize_model(llama.init_params(TCFG, 0, device="cpu"), TCFG),
                   "sym_int4", device="cpu")
    for kw, exc in (({"speculative": True, "draft_k": 1}, ValueError),
                    ({"adaptive_draft": True}, ValueError),
                    ({"speculative": True, "logprobs_top_k": 2}, NotImplementedError)):
        with pytest.raises(exc):
            JaxEngine(jm, n_slots=1, max_len=64, **kw)
        with pytest.raises(exc):
            InferenceEngine(tm, n_slots=1, max_len=64, **kw)
    with pytest.raises(ValueError, match="already quantized"):
        InferenceEngine(q, n_slots=1, max_len=64, speculative=True)
    for eng, m in ((InferenceEngine, tm), (JaxEngine, jm)):
        with pytest.raises(NotImplementedError, match="draft admission"):
            eng(m, n_slots=1, max_len=64, paged=True, speculative=True,
                prefill_chunk_tokens=8)
