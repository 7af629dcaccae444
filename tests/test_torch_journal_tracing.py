"""The serving engine's crash journal, fault injection, tracing, request
log and metrics exposition in bigdl_tpu_torch against the JAX package
(bigdl_tpu/serving/{faults,journal,metrics}.py, bigdl_tpu/obs/tracing.py,
bigdl_tpu/utils/diskfaults.py and the engine's fire points).

The host-only modules are held function to function: the same seeds and
arms fire the same sequence, the journals and request logs each package
writes are read by the other's readers (byte-equal where the records
are), and the same storage faults leave the same files. The engine's
pieces run both engines in lockstep on one manual clock over the same
weights, as tests/test_torch_serving_control.py does: crash, replay,
quarantine and page storms end as JAX's, and one traced run exports the
same trace events, request-log records and metric samples."""

import json
import os
import shutil
import warnings

import jax
import jax.numpy as jnp
import pytest

from bigdl_tpu.convert.low_bit import save_low_bit as jax_save_low_bit
from bigdl_tpu.convert.low_bit import verify_low_bit as jax_verify_low_bit
from bigdl_tpu.obs import tracing as jtracing
from bigdl_tpu.serving import faults as jfaults
from bigdl_tpu.serving import journal as jjournal
from bigdl_tpu.serving import metrics as jmetrics
from bigdl_tpu.serving.adapters import AdapterRegistry as JaxRegistry
from bigdl_tpu.serving.adapters import save_adapter as jax_save_adapter
from bigdl_tpu.serving.engine import InferenceEngine as JaxEngine
from bigdl_tpu.serving.engine import Request as JaxRequest
from bigdl_tpu.train import init_lora as jax_init_lora
from bigdl_tpu.utils import diskfaults as jdiskfaults
from bigdl_tpu.utils import durability as jdurability
from bigdl_tpu_torch.convert.low_bit import save_low_bit, verify_low_bit
from bigdl_tpu_torch.obs import tracing
from bigdl_tpu_torch.serving import InferenceEngine, Request
from bigdl_tpu_torch.serving import faults, journal, metrics
from bigdl_tpu_torch.serving.adapters import AdapterRegistry
from bigdl_tpu_torch.utils import diskfaults, durability
# the lockstep helpers and the tiny-llama pair (a module fixture)
from test_torch_serving_control import Clock, _compare, _lockstep, _step_both, tiny  # noqa: F401


def _run_both(jeng, teng):
    _lockstep(jeng, teng, {})


# ---------------------------------------------------------------------------
# fault injectors (host only)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arm", [dict(times=2, after=1, extra="x"), dict(times=-1, prob=0.5),
                                 dict(times=3, after=0, prob=0.3, slots=[1])])
def test_fault_injector_fires_the_same_sequence_as_jax(arm):
    for J, T, point in ((jfaults.FaultInjector, faults.FaultInjector, "alloc_page"),
                        (jdiskfaults.DiskFaultInjector, diskfaults.DiskFaultInjector,
                         "bit_flip")):
        j, t = J(seed=7).arm(point, **arm), T(seed=7).arm(point, **arm)
        assert [j.fire(point) for _ in range(40)] == [t.fire(point) for _ in range(40)]
        assert (dict(j.seen), dict(j.fired)) == (dict(t.seen), dict(t.fired))
        t.disarm(point)
        assert t.fire(point) is None
    assert faults.POINTS == jfaults.POINTS and diskfaults.DISK_POINTS == jdiskfaults.DISK_POINTS
    with pytest.raises(ValueError, match="unknown injection point"):
        faults.FaultInjector().arm("no_such_point")
    with pytest.raises(RuntimeError, match="no-op injector"):
        faults.NULL_INJECTOR.arm("slow_step")
    with pytest.raises(RuntimeError, match="no-op disk injector"):
        diskfaults.NULL_DISK_INJECTOR.arm("bit_flip")


@pytest.mark.parametrize("mode", ["torn_rename", "drop_file", "bit_flip", "truncate"])
def test_disk_faults_through_atomic_write_leave_what_jax_leaves(tmp_path, mode):
    """Over an existing file: a torn rename raises and leaves the old file
    and the tmp, a dropped file leaves the old one, rot corrupts the new
    one at the same byte."""
    out = {}
    for name, aw, Inj, Err in (("jax", jdurability.atomic_write, jdiskfaults.DiskFaultInjector,
                                jdiskfaults.DiskFaultError),
                               ("port", durability.atomic_write, diskfaults.DiskFaultInjector,
                                diskfaults.DiskFaultError)):
        d = tmp_path / name
        d.mkdir()
        (d / "f.bin").write_bytes(b"old contents")
        kw = {"bit_flip": dict(offset=5, bit=3), "truncate": dict(keep=0.25)}.get(mode, {})
        inj = Inj(seed=3).arm(mode, **kw)
        raised = None
        try:
            aw(str(d / "f.bin"), lambda f: f.write(bytes(range(200))), faults=inj)
        except Err as e:
            raised = str(e).replace(str(d), "<d>")
        out[name] = (raised, sorted((p.name, p.read_bytes()) for p in d.iterdir()))
    assert out["port"] == out["jax"]
    assert (out["port"][0] is not None) == (mode == "torn_rename")


@pytest.mark.parametrize("mode", ["drop_file", "torn_rename", "bit_flip"])
def test_disk_faults_through_save_low_bit_leave_what_jax_leaves(tiny, tmp_path, mode):
    """A fresh save and then an overwrite under each fault: the same files
    (the overwrite's token normalised), the same verification verdicts."""
    jm, tm, _ = tiny
    out = {}
    for name, save, verify, Inj in (
            ("jax", lambda p, f: jax_save_low_bit(p, jm.config, jm.params, "sym_int4", faults=f),
             jax_verify_low_bit, jdiskfaults.DiskFaultInjector),
            ("port", lambda p, f: save_low_bit(p, tm.config, tm.params, "sym_int4", faults=f),
             verify_low_bit, diskfaults.DiskFaultInjector)):
        d = str(tmp_path / name)
        res = []
        for after in (0, 1):  # the weights' write, then the config's
            shutil.rmtree(d, ignore_errors=True)
            if after:
                save(d, None)  # an overwrite: the fault hits the new pair
            inj = Inj(seed=5).arm(mode, times=1, after=after,
                                  **({"offset": 300} if mode == "bit_flip" else {}))
            try:
                save(d, inj)
                err = None
            except Exception as e:  # noqa: BLE001 - the type is compared
                err = type(e).__name__
            files = sorted("weights-<t>.npz" if f.startswith("weights-") else f
                           for f in os.listdir(d))
            res.append((err, files, verify(d).ok if "bigdl_tpu_config.json" in files else None))
        out[name] = res
    assert out["port"] == out["jax"]


# ---------------------------------------------------------------------------
# the journal (host only)
# ---------------------------------------------------------------------------

JOURNAL_LINES = [
    {"op": "submit", "rid": 0, "prompt": [1, 2, 3], "max_new_tokens": 4},
    {"op": "submit", "rid": 1, "prompt": [4], "temperature": 0.5, "adapter": "a"},
    {"op": "done", "rid": 0},
    {"op": "submit", "rid": 2, "prompt": [5, 6], "deadline_s": 3.0},
]


def test_journals_cross_both_ways_byte_for_byte(tmp_path):
    """The same records through each package's RequestJournal give the
    same bytes; each package's scan, pending and compact read the other's
    file alike."""
    paths = {}
    for name, J, R in (("jax", jjournal.RequestJournal, JaxRequest),
                       ("port", journal.RequestJournal, Request)):
        paths[name] = str(tmp_path / f"{name}.jsonl")
        j = J(paths[name])
        j.record_submit(R(rid=3, prompt=[7, 8], max_new_tokens=9, temperature=0.7, top_k=5,
                          deadline_s=2.5, adapter="ten"))
        j.record_submit(R(rid=4, prompt=[9], repetition_penalty=1.1, eos_token_id=2))
        j.record_done(3)
        j.close()
    raw = open(paths["jax"], "rb").read()
    assert open(paths["port"], "rb").read() == raw
    for path in paths.values():
        assert journal.RequestJournal.scan(path) == jjournal.RequestJournal.scan(path)
        assert journal.RequestJournal.pending(path) == [
            {"op": "submit", "rid": 4, "prompt": [9], "max_new_tokens": 64,
             "repetition_penalty": 1.1, "eos_token_id": 2}]
    journal.RequestJournal.compact(paths["port"])
    jjournal.RequestJournal.compact(paths["jax"])
    assert open(paths["port"], "rb").read() == open(paths["jax"], "rb").read()
    assert journal.crc_line('{"a":1}') == jjournal.crc_line('{"a":1}')
    for line in ('{"a":1}\t00000000', '{"a":1}', journal.crc_line("{}")):
        assert journal.split_crc_line(line) == jjournal.split_crc_line(line)


@pytest.mark.parametrize("damage", ["torn_tail", "interior", "crc_mismatch", "legacy"])
def test_damaged_journals_are_counted_alike(tmp_path, damage):
    lines = [journal.crc_line(json.dumps(e, separators=(",", ":")))
             for e in JOURNAL_LINES]
    if damage == "torn_tail":
        lines[-1] = lines[-1][: len(lines[-1]) // 2]
    elif damage == "interior":
        lines.insert(1, "xx-not-json-xx")
    elif damage == "crc_mismatch":
        body, _ = journal.split_crc_line(lines[1])
        lines[1] = body.replace("[4]", "[5]") + lines[1][len(body):]
    else:  # pre-crc lines parse as before
        lines = [journal.split_crc_line(x)[0] for x in lines]
    path = str(tmp_path / "j.jsonl")
    with open(path, "w") as f:
        f.write("\n".join(lines) + ("" if damage == "torn_tail" else "\n"))
    got = []
    for scan in (journal.RequestJournal.scan, jjournal.RequestJournal.scan):
        stats = {}
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            res = scan(path, stats=stats)
        got.append((res, stats, sorted(str(x.message).split(":")[1][:30] for x in w)))
    assert got[0] == got[1]
    want = {"torn_tail": 0, "interior": 1, "crc_mismatch": 1, "legacy": 0}[damage]
    assert got[0][1]["corrupt_lines"] == want


# ---------------------------------------------------------------------------
# the engine's fault points and the journal's replay
# ---------------------------------------------------------------------------

def test_crash_before_done_then_replay_matches_jax(tiny, tmp_path):
    """crash_before_done leaves step() as FaultError at the same step in
    both; a successor replays the same requests (new rids, the sampling
    fields, a fresh deadline window); after drain and close a third engine
    replays nothing. fail_all after the crash keeps the finished request's
    state and writes no tombstone (a second charge does not fire)."""
    clock = Clock()
    jpaths = [str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")]
    engs = [JaxEngine(tiny[0], n_slots=1, max_len=64, journal=jpaths[0], clock=clock,
                      logprobs_top_k=2,
                      faults=jfaults.FaultInjector(0).arm("crash_before_done", times=2)),
            InferenceEngine(tiny[1], n_slots=1, max_len=64, journal=jpaths[1], clock=clock,
                            faults=faults.FaultInjector(0).arm("crash_before_done", times=2))]
    subs = [dict(prompt=[3, 1, 4], max_new_tokens=5, temperature=0.7, top_p=0.9,
                 deadline_s=60.0, top_k=4),
            dict(prompt=[2, 7, 1], max_new_tokens=3)]
    reqs = [[e.submit(**kw) for kw in subs] for e in engs]
    crashed = []
    for e in engs:
        for i in range(100):
            try:
                e.step()
            except (jfaults.FaultError, faults.FaultError) as ex:
                crashed.append((i, str(ex)))
                break
    assert crashed[0] == crashed[1] and reqs[1][0].done and not reqs[1][1].done
    for e in engs:
        e.fail_all("engine error: injected crash")
    _compare(list(zip(*reqs)), tiny[2])
    assert reqs[1][0].finish_reason == "length" and reqs[1][1].finish_reason == "error"
    clock.t += 100.0
    succ = [JaxEngine(tiny[0], n_slots=1, max_len=64, journal=jpaths[0], clock=clock,
                      logprobs_top_k=2),
            InferenceEngine(tiny[1], n_slots=1, max_len=64, journal=jpaths[1], clock=clock)]
    fields = ("rid", "prompt", "max_new_tokens", "temperature", "top_p", "top_k",
              "deadline_s", "submit_ts")
    recs = [[tuple(getattr(r, f) for f in fields) for r in e.recovered_requests] for e in succ]
    # the finished request replays (its tombstone was never written); the
    # one fail_all failed was tombstoned
    assert recs[0] == recs[1] and [r[1] for r in recs[1]] == [[3, 1, 4]]
    _run_both(*succ)
    _compare(list(zip(succ[0].recovered_requests, succ[1].recovered_requests)), tiny[2])
    for e in succ:
        assert e.drain() is True
        e.close()
    assert [e.recovered_requests for e in (
        JaxEngine(tiny[0], n_slots=1, max_len=64, journal=jpaths[1]),
        InferenceEngine(tiny[1], n_slots=1, max_len=64, journal=jpaths[0]))] == [[], []]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_nan_logits_quarantines_only_the_poisoned_slot(tiny, paged):
    clock = Clock()
    kw = dict(n_slots=2, max_len=64, clock=clock, **(dict(paged=True, page_size=8)
                                                      if paged else {}))
    ji, ti = jfaults.FaultInjector(0), faults.FaultInjector(0)
    jeng = JaxEngine(tiny[0], faults=ji, logprobs_top_k=2, **kw)
    teng = InferenceEngine(tiny[1], faults=ti, **kw)
    reqs = [(jeng.submit(p, max_new_tokens=10), teng.submit(p, max_new_tokens=10))
            for p in ([3, 1, 4], [2, 7, 1, 8])]
    _step_both(jeng, teng)
    ji.arm("nan_logits", times=1, slots=[0])
    ti.arm("nan_logits", times=1, slots=[0])
    _run_both(jeng, teng)
    _compare(reqs, tiny[2])
    assert [r.finish_reason for _, r in reqs] == ["error", "length"]
    assert "non-finite" in reqs[0][1].error and ti.fired["nan_logits"] == 1
    assert teng.finish_reasons == jeng.finish_reasons and teng.page_leaks() == 0


def test_alloc_page_storm_preempts_as_jax(tiny):
    """Injected pool exhaustion mid-decode: the same victims swap out and
    back at the same steps (pages compared every step), tokens unchanged."""
    clock = Clock()
    ji = jfaults.FaultInjector(1).arm("alloc_page", times=6, after=4, prob=0.5)
    ti = faults.FaultInjector(1).arm("alloc_page", times=6, after=4, prob=0.5)
    kw = dict(n_slots=3, max_len=64, paged=True, page_size=8, clock=clock)
    jeng = JaxEngine(tiny[0], faults=ji, logprobs_top_k=2, **kw)
    teng = InferenceEngine(tiny[1], faults=ti, **kw)
    reqs = [(jeng.submit(p, max_new_tokens=30), teng.submit(p, max_new_tokens=30))
            for p in ([3, 1, 4, 1, 5], [9, 9, 8, 2], [2, 7, 1, 8, 3, 6])]
    _run_both(jeng, teng)
    _compare(reqs, tiny[2])
    assert teng.preemptions == jeng.preemptions > 0
    assert teng.preemption_resumes == jeng.preemption_resumes
    # a slot that cannot extend and made no progress since its resume
    # finishes "length" short of its budget, in both (the livelock guard)
    assert [r.finish_reason for _, r in reqs] == ["length"] * 3 and teng.page_leaks() == 0
    assert (dict(ti.seen), dict(ti.fired)) == (dict(ji.seen), dict(ji.fired))


@pytest.mark.parametrize("point", ["adapter_load_corrupt", "adapter_page_in_stall"])
def test_adapter_fault_points_fail_one_request(tiny, tmp_path, point):
    """A corrupt load or a page-in stall, armed on the engine's injector
    (bound into the registry with bind), fails only the tenant's request;
    the registry's and the pager's counts come back, and the registry
    records its events on the engine's track."""
    cfg = tiny[0].config
    lora = jax_init_lora(cfg, jax.random.PRNGKey(3), rank=4, alpha=8.0, targets=("wq", "wo"))
    lora["layers"]["wo"]["b"] = (jax.random.normal(jax.random.PRNGKey(9), lora["layers"]["wo"]
                                                   ["b"].shape) * 0.05).astype(jnp.bfloat16)
    jax_save_adapter(str(tmp_path / "ten.npz"), lora)
    clock = Clock()
    tr = tracing.TraceRecorder(clock=clock)
    injs = [I(0).arm(point, times=1) for I in (jfaults.FaultInjector, faults.FaultInjector)]
    # JAX's registry raises TypeError on its first event with a tracer (its
    # `name=` argument collides with the recorder's): no tracer there
    regs = [JaxRegistry(dir=str(tmp_path)).bind(clock=clock, faults=injs[0]),
            AdapterRegistry(dir=str(tmp_path)).bind(tracer=tr, clock=clock, faults=injs[1])]
    kw = dict(n_slots=2, max_len=64, paged=True, page_size=8, clock=clock)
    jeng = JaxEngine(tiny[0], adapters=regs[0], faults=injs[0], logprobs_top_k=2, **kw)
    teng = InferenceEngine(tiny[1], adapters=regs[1], faults=injs[1], **kw)
    reqs = (jeng.submit([3, 1, 4], max_new_tokens=6, adapter="ten"),
            teng.submit([3, 1, 4], max_new_tokens=6, adapter="ten"))
    base = (jeng.submit([2, 7], max_new_tokens=6), teng.submit([2, 7], max_new_tokens=6))
    again = (jeng.submit([5, 6], max_new_tokens=6, adapter="ten"),
             teng.submit([5, 6], max_new_tokens=6, adapter="ten"))
    _run_both(jeng, teng)
    _compare([reqs, base, again], tiny[2])
    assert (reqs[1].finish_reason, base[1].finish_reason, again[1].finish_reason) == \
        ("error", "length", "length")
    assert regs[1].stats() == regs[0].stats()
    assert teng._pager.page_ins == jeng._pager.page_ins and teng.page_leaks() == 0
    # one load lands either way (a failed load records nothing)
    assert [(e["name"], e["cat"], e["tid"], e["args"]) for e in tr.events()] == [
        ("adapter_load", "adapter", 0, {"name": "ten", "rank": 4, "nbytes": 4096,
                                        "seconds": 0.0})]


# ---------------------------------------------------------------------------
# tracing, the request log and the metrics exposition on one scripted run
# ---------------------------------------------------------------------------

def _traced_run(tiny, tmp_path):
    """Both engines over one script on one manual clock that moves 10 ms
    a step: chunked prefill, a prefix hit, a forced preemption and resume,
    a cancel while queued, a queue-deadline shed and a shed over the
    queue bound."""
    clock = Clock()
    trs = [jtracing.TraceRecorder(clock=clock), tracing.TraceRecorder(clock=clock)]
    logs = [str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")]
    kw = dict(n_slots=2, max_len=128, paged=True, page_size=8, prefill_chunk_tokens=16,
              trace_decode_every=3, max_queue=4, clock=clock)
    jeng = JaxEngine(tiny[0], tracer=trs[0], request_log=logs[0], logprobs_top_k=2, **kw)
    teng = InferenceEngine(tiny[1], tracer=trs[1], request_log=logs[1], **kw)
    prefix = list(range(30, 54))
    script = {0: [dict(prompt=prefix + [1, 2], max_new_tokens=12),
                  dict(prompt=[3, 1, 4, 1, 5], max_new_tokens=20)],
              1: [dict(prompt=prefix + [7, 8, 9], max_new_tokens=6),
                  dict(prompt=[4, 4], max_new_tokens=4, queue_deadline_s=0.015),
                  dict(prompt=[6, 6], max_new_tokens=4),
                  dict(prompt=[8, 8], max_new_tokens=4)],
              6: [dict(prompt=list(range(60, 100)), max_new_tokens=5)]}
    reqs = []
    for i in range(400):
        for sub in script.get(i, ()):
            reqs.append((jeng.submit(**sub), teng.submit(**sub)))
        if i == 2:
            jeng.cancel(reqs[4][0]), teng.cancel(reqs[4][1])
        if i == 9:
            for e, k in ((jeng, 0), (teng, 1)):
                e.preempt(reqs[1][k])
        more = _step_both(jeng, teng, i)
        clock.t += 0.01
        if not more and i > max(script):
            break
    for e in (jeng, teng):
        e.close()
    return jeng, teng, reqs, trs, logs


def test_trace_request_log_and_metrics_match_jax(tiny, tmp_path):
    jeng, teng, reqs, trs, logs = _traced_run(tiny, tmp_path)
    _compare(reqs, tiny[2])
    reasons = [r.finish_reason for _, r in reqs]
    assert reasons.count("shed") == 2 and "stop" in reasons and teng.preemptions == 1
    # the trace: the same events, span for span (ts and dur in µs of the
    # one clock, args included), nested on every track
    jev, tev = (t.export()["traceEvents"] for t in trs)
    assert tev == jev
    assert tracing.validate_nesting(tev) == [] and jtracing.validate_nesting(jev) == []
    names = {e["name"] for e in tev}
    assert {"submit", "queued", "prefill", "decode", "swap_out", "preempted", "finish",
            "decode_step", "batch"} <= names
    assert tracing.summarize_trace({"traceEvents": tev}) == jtracing.summarize_trace(
        {"traceEvents": jev})
    s = tracing.summarize_trace(tev)
    assert tracing.format_summary(s) == jtracing.format_summary(s)
    # the request log: equal record for record, each package reading the
    # other's file
    recs = [tracing.RequestLog.read(p) for p in logs]
    assert recs[1] == recs[0] == jtracing.RequestLog.read(logs[1])
    assert tracing.RequestLog.read(logs[0]) == recs[0] and len(recs[1]) == len(reqs)
    assert open(logs[1], "rb").read() == open(logs[0], "rb").read()
    # the exposition: no drift, and every sample equal to JAX's but the
    # build labels and the process-wide counters each package keeps alone
    tm, jm = metrics.Metrics(teng).render(), jmetrics.Metrics(jeng).render()
    assert metrics.metric_drift(tm, teng) == ([], [])
    own = ("bigdl_tpu_build_info", "bigdl_tpu_checkpoint_verify_failures_total",
           "bigdl_tpu_train_")

    def samples(text):
        return [ln for ln in text.splitlines() if not ln.startswith(own)]
    assert samples(tm) == samples(jm)
    assert f"bigdl_tpu_checkpoint_verify_failures_total {durability.VERIFY_FAILURES.value}" in tm
    assert 'torch_version="' in tm and 'format_version="4"' in tm


def test_trace_export_file_and_recorder_discipline(tmp_path):
    """The export is standard JSON (non-finite args as null) through the
    atomic write, and reads as JAX's; the ring evicts and counts drops;
    a disabled recorder records nothing."""
    status = []
    for T in (tracing.TraceRecorder, jtracing.TraceRecorder):
        tr = T(capacity=4, clock=lambda: 2.0)
        tr.complete("step", 1.0, 0.5, tid=3, loss=float("nan"))
        tr.instant("finish", tid=3, rid=3)
        for i in range(4):
            tr.counter("batch", occupancy=i)
        path = str(tmp_path / f"{T.__module__}.json")
        obj = tr.export(path)
        assert json.load(open(path)) == obj
        status.append(tr.status())
    assert status[0] == status[1] and status[0]["dropped"] == 3
    a, b = (json.load(open(str(tmp_path / f"{m}.json"))) for m in
            (tracing.__name__, jtracing.__name__))
    assert a == b
    off = tracing.TraceRecorder(enabled=False)
    off.complete("x", 0.0, 1.0)
    off.instant("y")
    assert off.events() == []
    with pytest.raises(ValueError):
        tracing.TraceRecorder(capacity=0)


def test_metrics_registry_and_engineless_render_match_jax():
    assert metrics.FINISH_REASONS == jmetrics.FINISH_REASONS
    assert metrics.FAST_BUCKETS == jmetrics.FAST_BUCKETS
    assert metrics.expected_families() == jmetrics.expected_families()
    m, j = metrics.Metrics(), jmetrics.Metrics()
    for x in (m, j):
        x.observe_request("/v1/completions", 200, 0.3)
        x.observe_request("/v1/completions", 503, 0.01)
        x.observe_request("/v1/completions", 500, 2.0)
        x.count_tokens(17)
    tm, jm = m.render(), j.render()
    assert metrics.metric_drift(tm) == ([], [])

    def own(text):  # the families each package keeps alone
        return [ln for ln in text.splitlines()
                if not ln.startswith(("bigdl_tpu_build_info", "bigdl_tpu_train_",
                                      "bigdl_tpu_checkpoint_verify_failures_total"))]
    assert own(tm) == own(jm)
    tr = metrics.render_train_series()
    assert [ln for ln in tr if ln.startswith("#")] == \
        [ln for ln in jmetrics.render_train_series() if ln.startswith("#")]
    c = metrics.Counter()
    c.inc(3)
    assert c.value == 3


def test_control_plane_modules_load_no_jax_in_fresh_process(tmp_path):
    """The control plane's modules import and serve a chunked, journaled,
    traced engine with its metrics on the CPU without loading jax or
    bigdl_tpu."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "from bigdl_tpu_torch import ModelConfig, TorchModel, optimize_model\n"
        "from bigdl_tpu_torch.models import llama\n"
        "from bigdl_tpu_torch.obs.tracing import TraceRecorder, validate_nesting\n"
        "from bigdl_tpu_torch.serving import InferenceEngine\n"
        "from bigdl_tpu_torch.serving.faults import FaultInjector\n"
        "from bigdl_tpu_torch.serving.metrics import Metrics, metric_drift\n"
        "from bigdl_tpu_torch.utils.diskfaults import DiskFaultInjector\n"
        "cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512,"
        " num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1)\n"
        "tm = TorchModel(cfg, optimize_model(llama.init_params(cfg, 0, device='cpu'), cfg),"
        " 'sym_int4', device='cpu')\n"
        "tr = TraceRecorder()\n"
        "eng = InferenceEngine(tm, n_slots=2, max_len=64, paged=True, page_size=8,"
        " prefill_chunk_tokens=8, journal='j.jsonl', request_log='r.jsonl', tracer=tr,"
        " faults=FaultInjector(0), max_queue=2)\n"
        "r = eng.submit(list(range(1, 30)), max_new_tokens=4)\n"
        "assert eng.drain() and r.finish_reason == 'length' and eng.prefill_chunks == 4\n"
        "eng.close()\n"
        "assert validate_nesting(tr.events()) == [] and metric_drift(Metrics(eng).render(),"
        " eng) == ([], [])\n"
        "DiskFaultInjector(0).arm('bit_flip')\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'bigdl_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-2000:]
