"""The serving engine's control plane in bigdl_tpu_torch against the JAX
package's InferenceEngine: chunked prefill, overload control (the queue
bound, queue and request deadlines) and the drain, each on request
scripts of tests/test_chunked_prefill.py, tests/test_serving_overload.py
and tests/test_serving_chaos.py.

Both engines step in lockstep over the same weights (JAX's tree carried in
with `params_from_numpy`) and read one manual clock, a list cell the test
moves between steps: deadlines expire at the same step in both, and every
timestamp is equal however often each engine reads its clock. Compared:
the physical pages of every slot after every step, greedy tokens by the
margin rule of test_torch_serving.py, chosen-token logprobs, finish
reasons, shed kinds, error prefixes, partial outputs, the prefill-chunk,
shed and timeout counters, prefix hits and page_leaks() == 0."""

import dataclasses
import functools
import os
import queue

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.api import TpuModel
from bigdl_tpu.api import optimize_model as jax_optimize_model
from bigdl_tpu.models import llama as jllama
from bigdl_tpu.models.config import PRESETS as JAX_PRESETS
from bigdl_tpu.models.config import ModelConfig as JaxConfig
from bigdl_tpu.quant import QTensor as JaxQTensor
from bigdl_tpu.serving.adapters import AdapterRegistry as JaxRegistry
from bigdl_tpu.serving.adapters import save_adapter as jax_save_adapter
from bigdl_tpu.serving.engine import InferenceEngine as JaxEngine
from bigdl_tpu.serving.faults import FaultInjector as JaxInjector
from bigdl_tpu.train import init_lora as jax_init_lora
from bigdl_tpu_torch import TorchModel
from bigdl_tpu_torch.convert import params_from_numpy
from bigdl_tpu_torch.models import llama
from bigdl_tpu_torch.models.config import ModelConfig
from bigdl_tpu_torch.serving import InferenceEngine
from bigdl_tpu_torch.serving.adapters import AdapterRegistry
from bigdl_tpu_torch.serving.faults import FaultInjector
from bigdl_tpu_torch.serving.journal import RequestJournal

# one intra-op thread per test worker (see test_torch_serving.py)
torch.set_num_threads(1)

CONFIGS = {
    "kernel-eligible": JaxConfig(vocab_size=512, hidden_size=256,
                                 intermediate_size=512, num_hidden_layers=2,
                                 num_attention_heads=2, num_key_value_heads=1),
    "tiny-llama": JAX_PRESETS["tiny-llama"],
}
# the margin rule's bound, as test_torch_serving.py: logits agree within
# 4 bf16 ULPs of the largest, so chosen-token logprobs within twice that
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


def _models(jcfg):
    jparams = jax.jit(functools.partial(jllama.init_params, jcfg))(jax.random.PRNGKey(0))
    jparams = jax.jit(lambda p: jax_optimize_model(p, jcfg, "sym_int4"))(jparams)
    arrays, qtypes = {}, {}
    _flatten(jparams, "", arrays, qtypes)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tmodel = TorchModel(tcfg, params_from_numpy(arrays, qtypes, tcfg, device="cpu"),
                        "sym_int4", device="cpu")
    with torch.inference_mode():  # the logit scale the tolerances follow
        logits, _ = llama.forward(tcfg, tmodel.params,
                                  torch.arange(1, 17)[None] % tcfg.vocab_size, None)
    return TpuModel(jcfg, jparams, "sym_int4"), tmodel, _TOL_ULPS * float(logits.abs().max())


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    return _models(CONFIGS[request.param])


@pytest.fixture(scope="module")
def tiny():
    return _models(CONFIGS["tiny-llama"])


class Clock:
    """One manual clock for both engines."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _engines(models, clock, jax_kw=None, port_kw=None, **kw):
    jm, tm, tol = models
    return (JaxEngine(jm, logprobs_top_k=2, clock=clock, **{**kw, **(jax_kw or {})}),
            InferenceEngine(tm, clock=clock, **{**kw, **(port_kw or {})}))


def _step_both(jeng, teng, i=None):
    more_j, more_t = jeng.step(), teng.step()
    assert more_j == more_t, i
    assert list(jeng.active) == list(teng.active), i
    assert jeng.prefill_chunks == teng.prefill_chunks, i
    assert (jeng._prefilling is None) == (teng._prefilling is None), i
    if jeng.paged:
        assert [list(p) for p in jeng._slot_pages] == teng._slot_pages, i
    return more_j


def _lockstep(jeng, teng, script, clock=None, tick=0.0, max_steps=2000):
    """Step both engines; `script` maps a step index to the submit kwargs
    issued before it. The clock moves `tick` seconds a step. Returns the
    (JAX, port) request pairs."""
    reqs = []
    for i in range(max_steps):
        for kw in script.get(i, ()):
            reqs.append((jeng.submit(**kw), teng.submit(**kw)))
        more = _step_both(jeng, teng, i)
        if clock is not None:
            clock.t += tick
        if not more and i >= max(script, default=0):
            return reqs
    raise AssertionError("engines did not drain")


def _compare(reqs, tol):
    """Finish reasons, shed kinds, error prefixes, tokens (margin rule) and
    logprobs of each (JAX, port) pair."""
    for jr, tr in reqs:
        assert (tr.finish_reason, tr.shed_kind, tr.done) == (jr.finish_reason, jr.shed_kind,
                                                            jr.done)
        assert (tr.error or "")[:24] == (jr.error or "")[:24]
        assert len(tr.out_tokens) == len(jr.out_tokens)
        diff = [i for i, (a, b) in enumerate(zip(jr.out_tokens, tr.out_tokens)) if a != b]
        upto = diff[0] if diff else len(jr.out_tokens)
        np.testing.assert_allclose(tr.out_logprobs[:upto], jr.out_logprobs[:upto],
                                   atol=2 * tol, rtol=0)
        if diff:  # the first divergence must sit on a near-tie of JAX's
            top = sorted(jr.out_top_logprobs[upto].values(), reverse=True)
            assert top[0] - top[1] <= 2 * tol, (upto, top, tol)


def _counters(eng):
    return (eng.requests_shed, eng.request_timeouts, dict(eng.finish_reasons),
            eng.prefill_chunks, eng.preemptions)


PAGED = dict(n_slots=2, max_len=256, paged=True, page_size=8)
P1 = list(range(10, 26))  # two full pages
# test_paged.py's script: p1's pages registered, then a full-page hit plus
# a 5-token sub-page copy, a 6-token copy with no full page, a 100-token
# prompt and a short one
CHUNK_SCRIPT = {
    0: [dict(prompt=P1, max_new_tokens=6)],
    1: [dict(prompt=P1[:13] + [99 + i for i in range(29)], max_new_tokens=6),
        dict(prompt=P1[:6] + [77 + i for i in range(28)], max_new_tokens=6),
        dict(prompt=[(7 * i) % 200 + 1 for i in range(100)], max_new_tokens=8),
        dict(prompt=[3, 1, 4, 1, 5], max_new_tokens=12)],
}


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [1, 16, 48])
def test_chunked_prefill_matches_jax_and_monolithic(pair, chunk):
    """Chunks of 1 (a 1-token last chunk: T = 1 here, a 16-row bucket in
    JAX), 16 (two pages) and 48 (mid-page edges) against JAX's chunked
    engine step by step (pages, chunk counts, which request is mid-plan),
    then the tokens against the port's own monolithic engine."""
    clock = Clock()
    jeng, teng = _engines(pair, clock, prefill_chunk_tokens=chunk, **PAGED)
    reqs = _lockstep(jeng, teng, CHUNK_SCRIPT)
    _compare(reqs, pair[2])
    assert [r.finish_reason for _, r in reqs] == ["length"] * 5
    assert (teng.prefix_hits, teng.prefix_partial_hits, teng.prefix_tokens_reused) \
        == (jeng.prefix_hits, jeng.prefix_partial_hits, jeng.prefix_tokens_reused)
    assert teng.prefix_hits >= 1 and teng.prefix_partial_hits >= 1
    assert teng.prefill_chunks == jeng.prefill_chunks > (5 if chunk < 100 else 4)
    assert teng.page_leaks() == jeng.page_leaks() == 0
    mono = InferenceEngine(pair[1], logprobs_top_k=2, **PAGED)
    ref = []
    for i in sorted(CHUNK_SCRIPT):
        ref += [mono.submit(**kw) for kw in CHUNK_SCRIPT[i]]
        mono.step()
    mono.run_until_idle()
    _compare(list(zip(ref, [r for _, r in reqs])), pair[2])
    assert mono.prefill_chunks == 5


def test_chunked_prefill_with_an_adapter_request(tiny, tmp_path):
    """A tenant's long prompt chunk-prefills with its adapter tree on every
    chunk (the prefill's LoRA forms) beside a base request."""
    jm, tm, tol = tiny
    cfg = jm.config
    targets = ("wq", "wv", "wo", "w_down")
    lora = jax_init_lora(cfg, jax.random.PRNGKey(3), rank=4, alpha=8.0, targets=targets)
    for i, t in enumerate(targets):
        b = lora["layers"][t]["b"]
        lora["layers"][t]["b"] = (jax.random.normal(jax.random.PRNGKey(40 + i), b.shape,
                                                    jnp.float32) * 0.05).astype(b.dtype)
    jax_save_adapter(str(tmp_path / "ten.npz"), lora)
    clock = Clock()
    jeng, teng = _engines(tiny, clock, prefill_chunk_tokens=16,
                          jax_kw=dict(adapters=JaxRegistry(dir=str(tmp_path))),
                          port_kw=dict(adapters=AdapterRegistry(dir=str(tmp_path))), **PAGED)
    script = {0: [dict(prompt=[5, 6, 7], max_new_tokens=20)],
              1: [dict(prompt=list(range(20, 90)), max_new_tokens=8, adapter="ten")]}
    reqs = _lockstep(jeng, teng, script)
    _compare(reqs, tol)
    assert [r.finish_reason for _, r in reqs] == ["length", "length"]
    assert teng.prefill_chunks == jeng.prefill_chunks == 1 + 5
    assert teng.page_leaks() == 0


def _start_chunked(jeng, teng, clock=None, **kw):
    """Submit to both and step until the request is mid-chunked-prefill."""
    jr, tr = jeng.submit(**kw), teng.submit(**kw)
    for _ in range(3):
        _step_both(jeng, teng)
        if teng._prefilling is not None and teng._prefilling.req is tr:
            break
    assert jeng._prefilling.req is jr and teng._prefilling.req is tr
    assert not tr.done and tr.out_tokens == []
    return jr, tr


@pytest.mark.parametrize("event", ["cancel", "deadline", "preempt", "fail_all"])
def test_lifecycle_between_chunks_matches_jax(tiny, event):
    """cancel, a deadline, preempt and fail_all land while a request is
    mid-chunked-prefill, beside a decoding one: every page comes back,
    and the decoding request goes on as JAX's."""
    clock = Clock()
    jeng, teng = _engines(tiny, clock, prefill_chunk_tokens=16, n_slots=2, max_len=256,
                          paged=True, page_size=16)
    free0 = len(teng._pool.free)
    a = (jeng.submit([1, 2, 3], max_new_tokens=30), teng.submit([1, 2, 3], max_new_tokens=30))
    _step_both(jeng, teng)
    b = _start_chunked(jeng, teng, prompt=list(range(1, 129)), max_new_tokens=4,
                       deadline_s=5.0)
    if event == "cancel":
        jeng.cancel(b[0]), teng.cancel(b[1])
    elif event == "deadline":
        clock.t += 10.0
    elif event == "preempt":
        jeng.preempt(b[0]), teng.preempt(b[1])
    else:
        jeng.fail_all("injected crash"), teng.fail_all("injected crash")
    for i in range(200):
        if not _step_both(jeng, teng, i):
            break
    _compare([a, b], tiny[2])
    want = {"cancel": "stop", "deadline": "timeout", "preempt": "length",
            "fail_all": "error"}[event]
    assert b[1].finish_reason == want and b[1].preemptions == 0
    assert teng._prefilling is None and teng.page_leaks() == 0
    assert len(teng._pool.free) + teng.radix.n_nodes == free0
    assert _counters(teng) == _counters(jeng)


def test_chunk_plan_yields_pages_to_a_decoding_slot(tiny):
    """test_chunked_prefill.py's pool of 14 pages: a decoding request's
    page boundary arrives while a 12-chunk plan holds the rest of the
    pool; the plan yields, restarts, and both requests finish whole."""
    clock = Clock()
    jeng, teng = _engines(tiny, clock, prefill_chunk_tokens=8, n_slots=2, max_len=128,
                          paged=True, page_size=8, n_pages=15)
    script = {0: [dict(prompt=[1, 2, 3, 4, 5], max_new_tokens=40)],
              1: [dict(prompt=list(range(10, 106)), max_new_tokens=8)]}
    reqs = _lockstep(jeng, teng, script)
    _compare(reqs, tiny[2])
    assert [len(r.out_tokens) for _, r in reqs] == [40, 8]
    assert teng.prefill_chunks == jeng.prefill_chunks >= 14
    assert teng.preemptions == jeng.preemptions == 0 and teng.page_leaks() == 0


# ---------------------------------------------------------------------------
# overload control (tests/test_serving_overload.py:193-324)
# ---------------------------------------------------------------------------

DENSE = dict(n_slots=1, max_len=64)


def test_queue_bound_sheds_fast(tiny):
    clock = Clock()
    jeng, teng = _engines(tiny, clock, max_queue=1, **DENSE)
    script = {0: [dict(prompt=[3, 1, 4], max_new_tokens=30)],
              1: [dict(prompt=[2, 7], max_new_tokens=4), dict(prompt=[5, 6], max_new_tokens=4)]}
    reqs = _lockstep(jeng, teng, script)
    _compare(reqs, tiny[2])
    c = reqs[2][1]
    assert (c.finish_reason, c.shed_kind) == ("shed", "queue_full")
    assert c.error.startswith("queue full") and not c.out_tokens
    assert _counters(teng) == _counters(jeng) and teng.requests_shed == 1


@pytest.mark.parametrize("saturated", [False, True])
def test_queue_deadline_sheds_at_the_step_its_clock_passes(tiny, saturated):
    """A queued request past its queue deadline is shed, by admission or
    (saturated: no slot frees) by the per-step sweep; the capacity it held
    admits a new submit."""
    clock = Clock()
    jeng, teng = _engines(tiny, clock, max_queue=1, **DENSE)
    a = (jeng.submit([3, 1, 4], max_new_tokens=30), teng.submit([3, 1, 4], max_new_tokens=30))
    _step_both(jeng, teng)
    kw = dict(prompt=[2, 7], max_new_tokens=4, queue_deadline_s=0.5)
    b = (jeng.submit(**kw), teng.submit(**kw))
    _step_both(jeng, teng)
    assert not b[1].done  # 0.0 s waited
    clock.t += 0.5
    _step_both(jeng, teng)
    assert not b[1].done  # not past
    clock.t += 0.01 if saturated else 0.0
    if not saturated:
        jeng.cancel(a[0]), teng.cancel(a[1])
        clock.t += 0.01
    _step_both(jeng, teng)
    assert b[1].done and (b[1].finish_reason, b[1].shed_kind) == ("shed", "queue_deadline")
    assert b[1].error.startswith("queue deadline")
    c = (jeng.submit([5, 6], max_new_tokens=4), teng.submit([5, 6], max_new_tokens=4))
    assert not c[1].done  # queued, not shed
    while _step_both(jeng, teng):
        pass
    _compare([a, b, c], tiny[2])
    assert _counters(teng) == _counters(jeng)
    assert teng.queue_wait.count == sum(jeng.queue_wait.counts)  # admitted ones only


def test_queued_and_parked_cancels_free_their_capacity(tiny):
    """A cancel reaches a queued request (its max_queue capacity frees at
    the next step) and a request parked in host RAM (its blob is dropped
    and its stream gets the end marker)."""
    clock = Clock()
    jeng, teng = _engines(tiny, clock, max_queue=1, **DENSE)
    a = (jeng.submit([3, 1, 4], max_new_tokens=30), teng.submit([3, 1, 4], max_new_tokens=30))
    _step_both(jeng, teng)
    b = (jeng.submit([2, 7], max_new_tokens=4), teng.submit([2, 7], max_new_tokens=4))
    jeng.cancel(b[0]), teng.cancel(b[1])
    _step_both(jeng, teng)
    assert b[1].done and b[1].finish_reason == "stop" and not a[1].done
    c = (jeng.submit([5, 6], max_new_tokens=4), teng.submit([5, 6], max_new_tokens=4))
    assert not c[1].done
    while _step_both(jeng, teng):
        pass
    _compare([a, b, c], tiny[2])
    assert not teng._cancelled and _counters(teng) == _counters(jeng)
    # parked
    jeng, teng = _engines(tiny, clock, n_slots=1, max_len=64, paged=True, page_size=8)
    qs = (queue.SimpleQueue(), queue.SimpleQueue())
    r = (jeng.submit([3, 1, 4], max_new_tokens=30, stream=qs[0]),
         teng.submit([3, 1, 4], max_new_tokens=30, stream=qs[1]))
    for _ in range(3):
        _step_both(jeng, teng)
    jeng._preempt_slot(0), teng._preempt_slot(0)
    jeng.cancel(r[0]), teng.cancel(r[1])
    _step_both(jeng, teng)
    _compare([r], tiny[2])
    assert r[1].finish_reason == "stop" and not teng._preempted and not teng._cancelled
    got = []
    while (x := qs[1].get_nowait()) is not None:
        got.append(x)
    assert got == r[1].out_tokens and teng.page_leaks() == 0


def test_shed_stream_gets_its_end_marker(tiny):
    clock = Clock()
    jeng, teng = _engines(tiny, clock, max_queue=1, **DENSE)
    for eng in (jeng, teng):
        eng.submit([3, 1, 4], max_new_tokens=30)
    _step_both(jeng, teng)
    for eng in (jeng, teng):
        eng.submit([2, 7], max_new_tokens=4)
    qs = (queue.SimpleQueue(), queue.SimpleQueue())
    c = (jeng.submit([5, 6], max_new_tokens=4, stream=qs[0]),
         teng.submit([5, 6], max_new_tokens=4, stream=qs[1]))
    _compare([c], tiny[2])
    assert c[1].finish_reason == "shed" and qs[1].get_nowait() is None


@pytest.mark.parametrize("default", [False, True], ids=["per-request", "engine-default"])
def test_deadline_mid_decode_times_out_with_partial_output(tiny, default):
    """deadline_s (per request, or the engine's default resolved at
    submit) expires after 10 steps of 0.1 s: "timeout", partial output."""
    clock = Clock()
    kw = dict(deadline_s=1.0) if default else {}
    jeng, teng = _engines(tiny, clock, n_slots=1, max_len=128, **kw)
    sub = dict(prompt=[3, 1, 4], max_new_tokens=100)
    if not default:
        sub["deadline_s"] = 1.0
    reqs = _lockstep(jeng, teng, {0: [sub]}, clock=clock, tick=0.1)
    _compare(reqs, tiny[2])
    r = reqs[0][1]
    assert r.deadline_s == 1.0 and r.finish_reason == "timeout"
    assert r.error.startswith("deadline_s=1.0 exceeded after") and 0 < len(r.out_tokens) < 100
    assert _counters(teng) == _counters(jeng) and teng.request_timeouts == 1


# ---------------------------------------------------------------------------
# the drain (tests/test_serving_chaos.py:395-460)
# ---------------------------------------------------------------------------

def test_drain_finishes_inflight_sheds_new_and_compacts_the_journal(tiny, tmp_path):
    clock = Clock()
    paths = [str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")]
    jeng, teng = _engines(tiny, clock, n_slots=2, max_len=64, jax_kw=dict(journal=paths[0]),
                          port_kw=dict(journal=paths[1]))
    inflight = [(jeng.submit([2 + i, 7], max_new_tokens=5),
                 teng.submit([2 + i, 7], max_new_tokens=5)) for i in range(3)]
    _step_both(jeng, teng)
    assert jeng.drain(timeout_s=30.0) is teng.drain(timeout_s=30.0) is True
    late = (jeng.submit([9, 9], max_new_tokens=3), teng.submit([9, 9], max_new_tokens=3))
    _compare(inflight + [late], tiny[2])
    assert (late[1].finish_reason, late[1].shed_kind) == ("shed", "draining")
    assert all(len(tr.out_tokens) == 5 for _, tr in inflight)
    assert _counters(teng) == _counters(jeng)
    for eng in (jeng, teng):
        eng.close()
        eng.close()  # idempotent
    for p in paths:
        assert RequestJournal.pending(p) == [] and os.path.getsize(p) == 0
    assert InferenceEngine(tiny[1], n_slots=2, max_len=64,
                           journal=paths[1]).recovered_requests == []


def test_drain_timeout_leaves_the_unfinished_tail_for_replay(tiny, tmp_path):
    """A drain that cannot finish in its budget gives up without losing
    work: the request stays pending in the compacted journal and replays
    at the next start, in either package."""
    out = []
    for Eng, m, Inj, name in ((JaxEngine, tiny[0], JaxInjector, "jax"),
                              (InferenceEngine, tiny[1], FaultInjector, "port")):
        clock = Clock()
        path = str(tmp_path / f"{name}.jsonl")
        inj = Inj(seed=0).arm("slow_step", times=-1, seconds=0.0)

        def tick(c=clock, f=inj):  # each stalled step costs 0.2 s of the clock
            c.t += 0.2 * (f.fired["slow_step"] > tick.seen)
            tick.seen = f.fired["slow_step"]
            return c.t
        tick.seen = 0
        eng = Eng(m, n_slots=1, max_len=64, journal=path, faults=inj, clock=tick)
        req = eng.submit([3, 1, 4], max_new_tokens=50)
        out.append((eng.drain(timeout_s=0.3), req.done, len(req.out_tokens)))
        eng.close()
        out.append([e["prompt"] for e in RequestJournal.pending(path)])
    assert out[0] == out[2] and out[1] == out[3] == [[3, 1, 4]]
    assert out[2][0] is False and out[2][1] is False
    # each package replays the other's journal
    rec = InferenceEngine(tiny[1], n_slots=1, max_len=64, journal=str(tmp_path / "jax.jsonl"))
    assert [r.prompt for r in rec.recovered_requests] == [[3, 1, 4]]
    rec = JaxEngine(tiny[0], n_slots=1, max_len=64, journal=str(tmp_path / "port.jsonl"))
    assert [r.prompt for r in rec.recovered_requests] == [[3, 1, 4]]
