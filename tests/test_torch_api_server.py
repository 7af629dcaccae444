"""The HTTP layer of bigdl_tpu_torch (serving/api_server.py, obs/profiler.py,
utils/errors.py and the adapter registry's operator calls) against the JAX
package's server (bigdl_tpu/serving/api_server.py), which runs as its own
tests run it (tests/test_serving.py, test_obs.py, test_serving_overload.py).

Both servers hold the same tiny-llama weights (JAX's tree carried in with
`params_from_numpy`, the port's on the CPU), bind ephemeral ports in this
process, share one stub tokenizer and take the same requests. Compared:
status codes, Content-Type, Retry-After's presence, the key skeleton of
every JSON body and SSE frame, error prefixes, greedy tokens by the margin
rule of test_torch_serving.py (logprobs within twice its bound), the
status mapping on one manual clock (the engines stepped in lockstep from
the test, no engine thread), the drain and the journal's replay, the
adapter lifecycle's codes and `page_leaks() == 0`, the `/metrics`
families, and the profiler window's guards."""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from bigdl_tpu.obs import profiler as jprofiler
from bigdl_tpu.serving import api_server as japi
from bigdl_tpu.serving.adapters import AdapterRegistry as JaxRegistry
from bigdl_tpu.serving.adapters import save_adapter as jax_save_adapter
from bigdl_tpu.serving.engine import InferenceEngine as JaxEngine
from bigdl_tpu.train import init_lora as jax_init_lora
from bigdl_tpu_torch.obs import profiler, tracing
from bigdl_tpu_torch.serving import InferenceEngine
from bigdl_tpu_torch.serving import api_server as api
from bigdl_tpu_torch.serving.adapters import AdapterRegistry
from bigdl_tpu_torch.serving.metrics import metric_drift
from bigdl_tpu_torch.utils import errors
# the tiny-llama pair (a module fixture: JAX model, port model, logit tolerance)
from test_torch_serving_control import Clock, tiny  # noqa: F401

SERVE = dict(n_slots=2, max_len=128, logprobs_top_k=2)


class StubTokenizer:
    """One tokenizer for both servers: words "t<id>" (or bare ids) encode
    to ids, each id decodes to "t<id> ", so stop strings can cut."""

    eos_token_id = None

    def __call__(self, text):
        return {"input_ids": [int(w.lstrip("t")) for w in text.split()]}

    def decode(self, tokens, skip_special_tokens=True):
        return "".join(f"t{int(t)} " for t in tokens)


TOK = StubTokenizer()


def ids_of(text: str) -> list:
    return TOK(text)["input_ids"]


def http(port, path, payload=None, raw=None, timeout=120):
    """(status, headers, body bytes) of one GET (no payload) or POST."""
    data = raw if raw is not None else (None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def skeleton(v):
    """The shape of a JSON value: keys, list shapes and scalar types."""
    if isinstance(v, dict):
        return {k: skeleton(x) for k, x in sorted(v.items())}
    if isinstance(v, list):
        return [skeleton(v[0])] if v else []
    return type(v).__name__


def frames(body: bytes) -> list:
    """An SSE body's data frames: "[DONE]" or the decoded JSON."""
    out = []
    for part in body.decode().split("\n\n"):
        if part.startswith("data: "):
            d = part[len("data: "):]
            out.append(d if d == "[DONE]" else json.loads(d))
    return out


def parse(headers, body):
    ctype = headers.get("Content-Type", "")
    if ctype.startswith("application/json"):
        return json.loads(body)
    if ctype.startswith("text/event-stream"):
        return frames(body)
    return body.decode()


def same_shape(j, t, what=""):
    """Status, Content-Type, Retry-After presence, body skeleton and error
    prefix of a (JAX, port) pair of responses; returns both bodies."""
    (js, jh, jb), (ts, th, tb) = j, t
    assert ts == js, (what, js, ts, jb[:300], tb[:300])
    assert th.get("Content-Type") == jh.get("Content-Type"), what
    assert ("Retry-After" in th) == ("Retry-After" in jh), what
    jo, to = parse(jh, jb), parse(th, tb)
    if isinstance(jo, list):
        assert [skeleton(f) for f in to] == [skeleton(f) for f in jo], what
    elif isinstance(jo, dict):
        assert skeleton(to) == skeleton(jo), (what, jo, to)
        if "error" in jo:
            assert str(to["error"])[:24] == str(jo["error"])[:24], (what, jo, to)
    return jo, to


def margin_rule(j_toks, t_toks, top, tol):
    """Port tokens as JAX's up to the first difference, which must sit on
    a near-tie of JAX's top two logprobs (`top`: per-position dicts)."""
    assert len(t_toks) == len(j_toks)
    diff = next((i for i, (a, b) in enumerate(zip(j_toks, t_toks)) if a != b), None)
    if diff is not None:
        best = sorted(top[diff].values(), reverse=True)
        assert best[0] - best[1] <= 2 * tol, (diff, best, tol)


def jax_reference(srv, prompt, n, **kw):
    """JAX's greedy tokens and top-2 logprobs for one prompt, from its
    server's engine (its thread steps it)."""
    req = srv.engine.submit(prompt, n, **kw)
    until(lambda: req.done)
    return req


def until(cond, timeout=60.0):
    t0 = time.time()
    while not cond():
        assert time.time() - t0 < timeout, "timed out"
        time.sleep(0.005)


def serve_http_only(srv):
    """The HTTP thread alone: the test steps the engine itself."""
    threading.Thread(target=srv.httpd.serve_forever, daemon=True).start()
    return srv


def make_pair(tiny, start=True, jax_kw=None, port_kw=None, **kw):
    jm, tm, _ = tiny
    js = japi.ApiServer(jm, port=0, **{**kw, **(jax_kw or {})})
    ts = api.ApiServer(tm, port=0, **{**kw, **(port_kw or {})})
    for s in (js, ts):
        s.start() if start else serve_http_only(s)
    return js, ts


def stop_pair(js, ts, started=True):
    for s in (js, ts):
        if started:
            s.shutdown()
        else:
            s.httpd.shutdown()
            s.engine.close()


class Client(threading.Thread):
    """One request on its own thread; `.result` when joined."""

    def __init__(self, port, path, payload):
        super().__init__(daemon=True)
        self.args = (port, path, payload)
        self.result = None

    def run(self):
        self.result = http(*self.args)


def step_both(js, ts, n=1):
    for _ in range(n):
        js.engine.step()
        ts.engine.step()


@pytest.fixture(scope="module")
def servers(tiny):
    js, ts = make_pair(tiny, tokenizer=TOK, **SERVE)
    yield js, ts
    stop_pair(js, ts)


# ---------------------------------------------------------------------------
# every endpoint: status, headers and body shape
# ---------------------------------------------------------------------------

CASES = {
    "health": ("/health", None, None),
    "info": ("/info", None, None),
    "recovered": ("/recovered", None, None),
    "adapters-without-registry": ("/adapters", None, None),
    "trace-export": ("/debug/trace", None, None),
    "profiler-status": ("/debug/profiler", None, None),
    "get-unknown": ("/nope", None, None),
    "generate": ("/generate", {"prompt": [3, 1, 4, 1, 5], "max_new_tokens": 6}, None),
    "generate-text": ("/generate", {"prompt": "t3 t1 t4", "max_new_tokens": 4}, None),
    "tgi-details": ("/generate", {"inputs": "t3 t1 t4 t1",
                                  "parameters": {"max_new_tokens": 5, "details": True}}, None),
    "completions-logprobs": ("/v1/completions", {"prompt": [2, 7, 1, 8], "max_tokens": 5,
                                                 "logprobs": 2}, None),
    "chat": ("/v1/chat/completions", {"messages": [{"role": "user", "content": [9, 9, 8, 2]}],
                                      "max_tokens": 5}, None),
    "stream": ("/generate_stream", {"prompt": [3, 1, 4], "max_new_tokens": 4}, None),
    "stream-chat": ("/v1/chat/completions", {"messages": [{"role": "user", "content": [5, 6, 7]}],
                                             "max_tokens": 4, "stream": True}, None),
    "stream-tgi": ("/generate_stream", {"inputs": "t5 t6 t7",
                                        "parameters": {"max_new_tokens": 4}}, None),
    "stream-rejected": ("/generate_stream", {"prompt": [], "max_new_tokens": 4}, None),
    "embeddings": ("/v1/embeddings", {"input": "hello"}, None),
    "transcriptions": ("/v1/audio/transcriptions", None, b"RIFF0000WAVE"),
    "bad-json": ("/generate", None, b"{nope"),
    "post-unknown": ("/nope", {}, None),
    "sample-contradiction": ("/generate", {"prompt": [1, 2], "temperature": 0,
                                           "do_sample": True}, None),
    "penalty-zero": ("/generate", {"prompt": [1, 2], "repetition_penalty": 0}, None),
    "deadline-not-a-number": ("/generate", {"prompt": [1, 2], "deadline_s": "soon"}, None),
    "deadline-negative": ("/v1/completions", {"prompt": [1, 2], "queue_deadline_s": -1}, None),
    "empty-prompt": ("/generate", {"prompt": []}, None),
    "out-of-vocabulary": ("/v1/completions", {"prompt": [10 ** 6]}, None),
    "adapter-without-registry": ("/generate", {"prompt": [1, 2, 3], "adapter": "x"}, None),
    "adapter-not-a-string": ("/generate", {"prompt": [1, 2, 3], "adapter": 5}, None),
    "adapter-load-without-registry": ("/adapters/load", {"name": "a"}, None),
    "tgi-bad-stop": ("/generate", {"inputs": "t1 t2", "parameters": {"stop": "t3"}}, None),
    "trace-toggle": ("/debug/trace", {"enabled": False, "clear": True}, None),
    "profiler-unknown-action": ("/debug/profiler", {"action": "pause"}, None),
    "profiler-start-without-logdir": ("/debug/profiler", {"action": "start"}, None),
    "profiler-stop-idle": ("/debug/profiler", {"action": "stop"}, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_endpoint_matches_jax(servers, tiny, case):
    js, ts = servers
    path, payload, raw = CASES[case]
    jo, to = same_shape(http(js.port, path, payload, raw), http(ts.port, path, payload, raw), case)
    if case in ("health", "recovered", "profiler-status", "adapters-without-registry"):
        assert to == jo
    if case == "info":
        assert {k: v for k, v in to.items() if k != "version"} == \
            {k: v for k, v in jo.items() if k != "version"}
    if case in ("generate", "completions-logprobs", "chat", "stream", "stream-chat",
                "generate-text", "tgi-details", "stream-tgi"):
        if isinstance(jo, list):  # SSE: every stream ends as JAX's
            assert (to[-1] == "[DONE]") == (jo[-1] == "[DONE]")
            j_toks, t_toks = sse_tokens(jo), sse_tokens(to)
        else:
            j_toks, t_toks = body_tokens(jo), body_tokens(to)
        prompt = prompt_of(payload)
        ref = jax_reference(js, prompt, len(j_toks))
        assert ref.out_tokens == j_toks
        margin_rule(j_toks, t_toks, ref.out_top_logprobs, tiny[2])
    if case == "completions-logprobs":
        jl, tl = jo["choices"][0]["logprobs"], to["choices"][0]["logprobs"]
        n = next((i for i, (a, b) in enumerate(zip(jl["tokens"], tl["tokens"])) if a != b),
                 len(jl["tokens"]))
        np.testing.assert_allclose(tl["token_logprobs"][:n], jl["token_logprobs"][:n],
                                   atol=2 * tiny[2], rtol=0)
        assert [len(d) for d in tl["top_logprobs"]] == [len(d) for d in jl["top_logprobs"]]


def prompt_of(payload):
    if "messages" in payload:
        return [t for m in payload["messages"] for t in m["content"]]
    p = payload.get("prompt", payload.get("inputs"))
    return ids_of(p) if isinstance(p, str) else p


def body_tokens(o):
    if "tokens" in o:
        return o["tokens"]
    if "generated_text" in o:
        return ids_of(o["generated_text"])
    c = o["choices"][0]
    return ids_of(c["text"] if "text" in c else c["message"]["content"])


def sse_tokens(fs):
    toks = []
    for f in fs:
        if f == "[DONE]":
            continue
        if "choices" in f:
            toks += ids_of(f["choices"][0]["delta"]["content"])
        elif isinstance(f.get("token"), dict):
            toks.append(f["token"]["id"])
        else:
            toks.append(f["token"])
    return toks


def test_tgi_stream_stop_sequence_and_one_behind_final_event(servers):
    """A stop sequence cuts the TGI stream at the token that completes it:
    every event carries a token, generated_text rides only the last one
    (one event behind), cut before the stop string, as JAX's."""
    js, ts = servers
    prompt = "t3 t1 t4 t1 t5"
    full = jax_reference(js, ids_of(prompt), 8).out_tokens
    stop = f"t{full[3]} "
    payload = {"inputs": prompt, "parameters": {"max_new_tokens": 8, "stop": [stop]}}
    jo, to = same_shape(http(js.port, "/generate_stream", payload),
                        http(ts.port, "/generate_stream", payload), "tgi stop")
    for fs in (jo, to):
        assert all(f["generated_text"] is None for f in fs[:-1])
        assert stop not in fs[-1]["generated_text"]
        assert "[DONE]" not in fs
    assert to[-1]["generated_text"] == jo[-1]["generated_text"]
    jo, to = same_shape(http(js.port, "/generate", {**payload, "parameters": {
        **payload["parameters"], "details": True}}), http(ts.port, "/generate", {
            **payload, "parameters": {**payload["parameters"], "details": True}}), "tgi stop")
    assert to == jo and jo["details"]["finish_reason"] == "stop_sequence"


def test_text_prompt_without_tokenizer_is_a_server_error(tiny):
    """No tokenizer: a text prompt is a plain ValueError, so 500 (not 400)
    in both; token ids still serve, with empty text."""
    js, ts = make_pair(tiny, **SERVE)
    try:
        same_shape(http(js.port, "/generate", {"prompt": "t1 t2"}),
                   http(ts.port, "/generate", {"prompt": "t1 t2"}), "text")
        jo, to = same_shape(http(js.port, "/generate", {"prompt": [1, 2], "max_new_tokens": 3}),
                            http(ts.port, "/generate", {"prompt": [1, 2], "max_new_tokens": 3}),
                            "ids")
        assert to["text"] == jo["text"] == ""
    finally:
        stop_pair(js, ts)


@pytest.mark.parametrize("payload", [
    {}, {"temperature": 0.7}, {"temperature": 0}, {"temperature": 0, "do_sample": True},
    {"top_p": 0.9}, {"top_p": 1.0}, {"top_k": 5}, {"top_k": 0}, {"do_sample": False, "top_k": 5},
    {"repetition_penalty": 1.2}, {"repetition_penalty": -1}, {"eos_token_id": "7"},
    {"adapter": "t1"}, {"adapter": ""}, {"queue_deadline_s": 2}, {"deadline_s": "x"},
    {"deadline_s": 0},
])
def test_sampling_kwargs_match_jax(payload):
    """The request-field mapping, and InvalidInputError (HTTP 400) where
    JAX raises its own."""
    try:
        want = japi._sampling_kwargs(payload)
    except Exception as e:  # noqa: BLE001
        with pytest.raises(errors.InvalidInputError) as got:
            api._sampling_kwargs(payload)
        assert type(e).__name__ == "InvalidInputError" and str(got.value) == str(e)
        assert isinstance(got.value, ValueError)
        return
    assert api._sampling_kwargs(payload) == want


def test_unported_models_refuse_with_their_item(tiny):
    for kw in ({"whisper": object()}, {"embedder": object()}):
        with pytest.raises(NotImplementedError, match=r"item \[9\]"):
            api.ApiServer(tiny[1], port=0, **kw)


# ---------------------------------------------------------------------------
# the status mapping on one manual clock
# ---------------------------------------------------------------------------

def test_status_mapping_on_a_manual_clock(tiny):
    """429 over max_queue, 503 past a queue deadline (both with
    Retry-After), 504 with the partial tokens for an engine deadline and
    for the server's own wait budget, 400 for an invalid request: both
    servers on one manual clock, their engines stepped in lockstep."""
    clock = Clock()
    js, ts = make_pair(tiny, start=False, n_slots=1, max_len=128, max_queue=2,
                       logprobs_top_k=2, request_timeout_s=30.0, clock=clock)
    try:
        def both(path, payload):
            cs = [Client(s.port, path, payload) for s in (js, ts)]
            for c in cs:
                c.start()
            return cs

        a = both("/generate", {"prompt": [3, 1, 4, 1, 5], "max_new_tokens": 40,
                               "deadline_s": 2.0})
        until(lambda: js.engine._queue.qsize() == ts.engine._queue.qsize() == 1)
        step_both(js, ts, 3)  # a is admitted and decodes
        b = both("/generate", {"prompt": [2, 7, 1], "max_new_tokens": 4})
        d = both("/v1/completions", {"prompt": [9, 8, 7], "max_tokens": 4,
                                     "queue_deadline_s": 0.5})
        until(lambda: js.engine._queue.qsize() == ts.engine._queue.qsize() == 2)
        # over the bound: shed at once
        jc, tc = same_shape(http(js.port, "/generate", {"prompt": [5, 6]}),
                            http(ts.port, "/generate", {"prompt": [5, 6]}), "429")
        same_shape(http(js.port, "/generate", {"prompt": [10 ** 6]}),
                   http(ts.port, "/generate", {"prompt": [10 ** 6]}), "400")
        clock.t += 3.0  # past a's deadline and d's queue deadline
        step_both(js, ts)
        for c in a + d:
            c.join(60)
        ja, ta = same_shape(a[0].result, a[1].result, "504 deadline")
        jd, td = same_shape(d[0].result, d[1].result, "503")
        assert (a[0].result[0], d[0].result[0]) == (504, 503)
        assert d[0].result[1]["Retry-After"] == d[1].result[1]["Retry-After"]
        assert len(ta["tokens"]) == len(ja["tokens"]) > 0
        while js.engine.step() | ts.engine.step():
            pass
        for c in b:
            c.join(60)
        jb, tb = same_shape(b[0].result, b[1].result, "200")
        assert len(tb["tokens"]) == len(jb["tokens"]) == 4
        # the server's own wait budget on the same clock: 504, counted once
        f = both("/generate", {"prompt": [4, 4, 4], "max_new_tokens": 4})
        until(lambda: js.engine._queue.qsize() == ts.engine._queue.qsize() == 1)
        time.sleep(0.3)  # both handlers are inside _wait
        clock.t += 31.0
        for c in f:
            c.join(60)
        jf, tf = same_shape(f[0].result, f[1].result, "504 wait")
        assert f[0].result[0] == 504 and "tokens" not in tf
        step_both(js, ts, 2)  # reap the cancels
        for s in (js, ts):
            assert (s.engine.requests_shed, s.engine.request_timeouts) == (2, 2)
        assert ts.engine.page_leaks() == 0
    finally:
        stop_pair(js, ts, started=False)


def test_http_shed_counts_reach_metrics(tiny):
    """429 and its counter in the Prometheus exposition, as JAX's
    test_http_shed_maps_to_429_with_retry_after reads it."""
    js, ts = make_pair(tiny, start=False, n_slots=1, max_len=64, max_queue=1)
    try:
        cs = [Client(s.port, "/generate", {"prompt": [3, 1, 4]}) for s in (js, ts)]
        for c in cs:
            c.start()
        until(lambda: js.engine._queue.qsize() == ts.engine._queue.qsize() == 1)
        jr, tr = http(js.port, "/generate", {"prompt": [5]}), http(ts.port, "/generate",
                                                                    {"prompt": [5]})
        same_shape(jr, tr, "429")
        assert tr[0] == 429 and int(tr[1]["Retry-After"]) >= 1 and b"queue full" in tr[2]
        while js.engine.step() | ts.engine.step():
            pass
        for c in cs:
            c.join(60)
        _, _, text = http(ts.port, "/metrics")
        assert b"bigdl_tpu_requests_shed_total 1" in text
        assert b"bigdl_tpu_queue_wait_seconds_count" in text
    finally:
        stop_pair(js, ts, started=False)


# ---------------------------------------------------------------------------
# lifecycle: the drain, the journal's replay, /recovered
# ---------------------------------------------------------------------------

def test_graceful_shutdown_and_journal_replay(tiny, tmp_path):
    """A crashed server's journaled requests replay in a successor and are
    collected from /recovered with JAX's tokens; a graceful shutdown
    drains in-flight requests, returns True and leaves nothing to
    replay."""
    jm, tm, tol = tiny
    paths = {k: str(tmp_path / f"{k}.jsonl") for k in ("jax", "port")}
    clock = Clock()

    def pair(start):
        return make_pair(tiny, start=start, request_timeout_s=5.0, clock=clock,
                         jax_kw=dict(journal=paths["jax"]), port_kw=dict(journal=paths["port"]),
                         **SERVE)

    js, ts = pair(start=False)  # no engine thread: nothing runs before the crash
    prompts = [[3, 1, 4, 1, 5], [2, 7, 1, 8, 2, 8]]
    cs = [Client(s.port, "/generate", {"prompt": p, "max_new_tokens": 6})
          for p in prompts for s in (js, ts)]
    for c in cs:
        c.start()
    until(lambda: js.engine._queue.qsize() == ts.engine._queue.qsize() == 2)
    time.sleep(0.3)
    clock.t += 10.0  # the clients give up (504); the process then dies
    for c in cs:
        c.join(60)
    assert [c.result[0] for c in cs] == [504] * 4
    for s in (js, ts):
        s.httpd.shutdown()
    js, ts = pair(start=True)
    try:
        assert len(js.engine.recovered_requests) == len(ts.engine.recovered_requests) == 2
        until(lambda: js.engine.idle() and ts.engine.idle()
              and all(r.done for s in (js, ts) for r in s.engine.recovered_requests))
        jo, to = same_shape(http(js.port, "/recovered"), http(ts.port, "/recovered"), "recovered")
        # the clients' submit order was a race: match by prompt
        jo["recovered"].sort(key=lambda r: r["prompt"] != prompts[0])
        to["recovered"].sort(key=lambda r: r["prompt"] != prompts[0])
        for jr, tr, p in zip(jo["recovered"], to["recovered"], prompts):
            assert jr["prompt"] == tr["prompt"] == p and tr["done"]
            assert tr["finish_reason"] == jr["finish_reason"] == "length"
            ref = jax_reference(js, p, 6)
            margin_rule(jr["tokens"], tr["tokens"], ref.out_top_logprobs, tol)
        # in-flight requests finish through the drain
        done0 = {s: s.engine.requests_completed for s in (js, ts)}
        cs = [Client(s.port, "/generate", {"prompt": p, "max_new_tokens": 6})
              for p in prompts for s in (js, ts)]
        for c in cs:
            c.start()
        until(lambda: all(s.engine._inflight + s.engine.requests_completed - done0[s] == 2
                          for s in (js, ts)))  # every request accepted
        assert js.shutdown(graceful=True) is True
        assert ts.shutdown(graceful=True) is True
        for c in cs:
            c.join(60)
        assert [c.result[0] for c in cs] == [200] * 4
    finally:
        for s in (js, ts):
            s.worker.stop_flag.set()
    js, ts = pair(start=False)
    try:
        assert js.engine.recovered_requests == ts.engine.recovered_requests == []
        jo, to = same_shape(http(js.port, "/recovered"), http(ts.port, "/recovered"), "empty")
        assert to == jo == {"recovered": []}
    finally:
        stop_pair(js, ts, started=False)


def test_signal_handlers_install_only_on_the_main_thread(tiny):
    """install_signal_handlers is a no-op off the main thread (embedded
    servers manage their own lifecycle), as JAX's."""
    import signal

    ts = api.ApiServer(tiny[1], port=0, **SERVE)
    try:
        before = signal.getsignal(signal.SIGTERM)
        t = threading.Thread(target=ts.install_signal_handlers)
        t.start()
        t.join()
        assert signal.getsignal(signal.SIGTERM) is before
    finally:
        ts.httpd.server_close()
        ts.engine.close()


# ---------------------------------------------------------------------------
# adapters over HTTP
# ---------------------------------------------------------------------------

def _adapter(cfg, path, seed, rank=4):
    import jax.numpy as jnp

    targets = ("wq", "wv", "wo", "w_down")
    lora = jax_init_lora(cfg, jax.random.PRNGKey(seed), rank=rank, alpha=8.0, targets=targets)
    for i, t in enumerate(targets):
        b = lora["layers"][t]["b"]
        lora["layers"][t]["b"] = (jax.random.normal(jax.random.PRNGKey(seed + 40 + i), b.shape,
                                                    jnp.float32) * 0.05).astype(b.dtype)
    jax_save_adapter(path, lora)


def test_adapter_lifecycle_matches_jax(tiny, tmp_path):
    """/adapters/load and /unload: 200, 404 (missing), 409 (held by a
    request), 422 (corrupt; dimensions the serving model cannot take),
    507 (over budget); an adapter request's tokens as JAX's; no page leak
    after load, serve, unload and reload. JAX's side runs with tracing
    off (queue 3: a traced JAX server fails every adapter load)."""
    import dataclasses

    jm, tm, tol = tiny
    cfg = jm.config
    _adapter(cfg, str(tmp_path / "a1.npz"), 3)
    _adapter(dataclasses.replace(cfg, hidden_size=2 * cfg.hidden_size), str(tmp_path / "wide.npz"), 4)
    (tmp_path / "bad.npz").write_bytes(b"not an npz")
    js, ts = make_pair(tiny, start=False, paged=True, page_size=8,
                       jax_kw=dict(adapters=JaxRegistry(dir=str(tmp_path))),
                       port_kw=dict(adapters=AdapterRegistry(dir=str(tmp_path))), **SERVE)
    try:
        for name, code in (("a1", 200), ("nope", 404), ("bad", 422), ("wide", 422)):
            r = (http(js.port, "/adapters/load", {"name": name}),
                 http(ts.port, "/adapters/load", {"name": name}))
            jo, to = same_shape(*r, name)
            assert r[0][0] == code, (name, r[0])
            if code == 200:
                assert to == jo
            else:
                assert to["kind"] == jo["kind"]
        prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]
        cs = [Client(s.port, "/generate", {"prompt": prompt, "max_new_tokens": 6,
                                           "adapter": "a1"}) for s in (js, ts)]
        for c in cs:
            c.start()
        until(lambda: js.engine._queue.qsize() == ts.engine._queue.qsize() == 1)
        step_both(js, ts)  # admitted: the request holds the adapter
        r = (http(js.port, "/adapters/unload", {"name": "a1"}),
             http(ts.port, "/adapters/unload", {"name": "a1"}))
        same_shape(*r, "busy")
        assert r[1][0] == 409
        while js.engine.step() | ts.engine.step():
            pass
        for c in cs:
            c.join(60)
        jo, to = same_shape(cs[0].result, cs[1].result, "adapter request")
        jo_tokens, to_tokens_first = jo["tokens"], to["tokens"]
        ref = JaxEngine(jm, n_slots=1, max_len=128, logprobs_top_k=2,
                        adapters=JaxRegistry(dir=str(tmp_path)))
        jr = ref.submit(prompt, 6, adapter="a1")
        ref.run_until_idle()
        assert jr.out_tokens == jo["tokens"]
        margin_rule(jo["tokens"], to["tokens"], jr.out_top_logprobs, tol)
        jo, to = same_shape(http(js.port, "/adapters"), http(ts.port, "/adapters"), "inventory")
        assert to == jo
        for code in (200, 404):
            r = (http(js.port, "/adapters/unload", {"name": "a1"}),
                 http(ts.port, "/adapters/unload", {"name": "a1"}))
            same_shape(*r, "unload")
            assert r[1][0] == code
        assert ts.engine.page_leaks() == js.engine.page_leaks() == 0
        # reload and serve again: the same tokens, no leak
        for s in (js, ts):
            assert http(s.port, "/adapters/load", {"name": "a1"})[0] == 200
        cs = [Client(s.port, "/generate", {"prompt": prompt, "max_new_tokens": 6,
                                           "adapter": "a1"}) for s in (js, ts)]
        for c in cs:
            c.start()
        until(lambda: js.engine._queue.qsize() == ts.engine._queue.qsize() == 1)
        while js.engine.step() | ts.engine.step():
            pass
        for c in cs:
            c.join(60)
        assert [to_tokens(c) for c in cs] == [jo_tokens, to_tokens_first]
        assert ts.engine.page_leaks() == 0
    finally:
        stop_pair(js, ts, started=False)
    # over budget: 507
    js, ts = make_pair(tiny, start=False,
                       jax_kw=dict(adapters=JaxRegistry(dir=str(tmp_path), budget_bytes=16)),
                       port_kw=dict(adapters=AdapterRegistry(dir=str(tmp_path), budget_bytes=16)),
                       **SERVE)
    try:
        r = (http(js.port, "/adapters/load", {"name": "a1"}),
             http(ts.port, "/adapters/load", {"name": "a1"}))
        same_shape(*r, "budget")
        assert r[1][0] == 507
    finally:
        stop_pair(js, ts, started=False)


def to_tokens(client):
    return json.loads(client.result[2])["tokens"]


def test_adapter_reload_under_the_same_name_serves_the_new_weights(tiny, tmp_path):
    """The port's pager keys a page-in by the registry entry: after an
    unload and a load of another artifact under the same name, a request
    gets the new weights (a bare engine's tokens with that artifact), not
    the old pages, and the old pages go back to the pool."""
    jm, tm, _ = tiny
    _adapter(jm.config, str(tmp_path / "x.npz"), 3)
    _adapter(jm.config, str(tmp_path / "y.npz"), 11)
    reg = AdapterRegistry()
    eng = InferenceEngine(tm, n_slots=2, max_len=128, paged=True, page_size=8, adapters=reg)
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    reg.load("t", path=str(tmp_path / "x.npz"))
    r1 = eng.submit(prompt, 6, adapter="t")
    eng.run_until_idle()
    pages_before = eng._pager.pages_resident
    assert pages_before > 0
    reg.unload("t")
    reg.load("t", path=str(tmp_path / "y.npz"))
    r2 = eng.submit(prompt, 6, adapter="t")
    eng.run_until_idle()
    assert eng._pager.pages_resident == pages_before and eng.page_leaks() == 0
    for path, got in (("x.npz", r1), ("y.npz", r2)):
        bare_reg = AdapterRegistry()
        bare_reg.load("t", path=str(tmp_path / path))
        bare = InferenceEngine(tm, n_slots=2, max_len=128, paged=True, page_size=8,
                               adapters=bare_reg)
        want = bare.submit(prompt, 6, adapter="t")
        bare.run_until_idle()
        assert got.out_tokens == want.out_tokens, path
    assert r1.out_tokens != r2.out_tokens


def test_registry_peek_and_unload_match_jax(tmp_path, tiny):
    """peek has no side effects (no LRU refresh, hit or reload); unload
    raises missing/busy as JAX's and keeps the path for a later reload."""
    _adapter(tiny[0].config, str(tmp_path / "a.npz"), 3)
    _adapter(tiny[0].config, str(tmp_path / "b.npz"), 5)
    regs = (JaxRegistry(dir=str(tmp_path)), AdapterRegistry(dir=str(tmp_path)))
    for reg in regs:
        reg.load("a")
        reg.load("b")
        assert reg.peek("zzz") is None
        assert reg.peek("a").name == "a"
        assert [e["name"] for e in reg.resident()] == ["a", "b"]  # LRU order kept
        held = reg.acquire("a")
        with pytest.raises(ValueError) as e:
            reg.unload("a")
        assert e.value.kind == "busy"
        reg.release(held)
        assert reg.unload("a")["name"] == "a"
        with pytest.raises(ValueError) as e:
            reg.unload("a")
        assert e.value.kind == "missing"
        assert reg.get("a").name == "a"  # reloads by the kept path
    assert regs[1].stats() == regs[0].stats()


# ---------------------------------------------------------------------------
# metrics, tracing, the profiler window
# ---------------------------------------------------------------------------

def families(text: str) -> set:
    return {ln.split()[2] for ln in text.splitlines() if ln.startswith("# TYPE ")}


def test_metrics_families_match_jax(servers):
    js, ts = servers
    for s in (js, ts):
        assert http(s.port, "/generate", {"prompt": [1, 2, 3], "max_new_tokens": 3})[0] == 200
    (jc, jh, jb), (tc, th, tb) = http(js.port, "/metrics"), http(ts.port, "/metrics")
    assert tc == jc == 200 and th["Content-Type"] == jh["Content-Type"]
    assert families(tb.decode()) == families(jb.decode())
    assert metric_drift(tb.decode(), ts.engine) == ([], [])
    assert 'bigdl_tpu_requests_total{endpoint="/generate",status="200"}' in tb.decode()


def test_debug_trace_toggles_and_exports_nested_spans(servers):
    js, ts = servers
    names = []
    for s in (js, ts):
        assert json.loads(http(s.port, "/debug/trace", {"enabled": True, "clear": True})[2])[
            "enabled"] is True
        assert http(s.port, "/generate", {"prompt": [5, 4, 3], "max_new_tokens": 4})[0] == 200
        _, _, body = http(s.port, "/debug/trace")
        ev = json.loads(body)["traceEvents"]
        names.append({e["name"] for e in ev})
        http(s.port, "/debug/trace", {"enabled": False})
    assert names[1] == names[0] and {"queued", "prefill", "decode"} <= names[1]
    assert tracing.validate_nesting(json.loads(body)["traceEvents"]) == []


def test_profiler_window_guards():
    """As JAX's test_profiler_window_guards: stub start/stop, busy and
    idle refusals, a failed stop frees the window, a failed start leaves
    it idle."""
    calls = []
    win = profiler.ProfilerWindow(start_fn=lambda d: calls.append(("start", d)),
                                  stop_fn=lambda: calls.append(("stop",)))
    with pytest.raises(profiler.ProfilerIdle):
        win.stop()
    st = win.start("/tmp/prof-x")
    assert st["active"] and st["logdir"] == "/tmp/prof-x"
    with pytest.raises(profiler.ProfilerBusy):
        win.start("/tmp/prof-y")
    out = win.stop()
    assert out["logdir"] == "/tmp/prof-x" and not win.status()["active"]
    assert calls == [("start", "/tmp/prof-x"), ("stop",)]

    def bad_stop():
        raise RuntimeError("profiler said no")

    win2 = profiler.ProfilerWindow(start_fn=lambda d: None, stop_fn=bad_stop)
    win2.start("/tmp/prof-z")
    with pytest.raises(RuntimeError, match="said no"):
        win2.stop()
    assert not win2.status()["active"]

    def bad_start(d):
        raise RuntimeError("no backend")

    win3 = profiler.ProfilerWindow(start_fn=bad_start, stop_fn=lambda: None)
    with pytest.raises(RuntimeError, match="no backend"):
        win3.start("/tmp/p")
    assert not win3.status()["active"]
    with pytest.raises(ValueError):
        win3.start("")


def test_profiler_endpoint_codes_match_jax(servers, monkeypatch):
    """POST /debug/profiler start/start/stop/stop: 200, 409, 200, 409 with
    the same bodies, both windows stubbed."""
    js, ts = servers
    clock = Clock()
    monkeypatch.setattr(jprofiler, "PROFILER", jprofiler.ProfilerWindow(
        start_fn=lambda d: None, stop_fn=lambda: None, clock=clock))
    monkeypatch.setattr(profiler, "PROFILER", profiler.ProfilerWindow(
        start_fn=lambda d: None, stop_fn=lambda: None, clock=clock))
    for payload in ({"action": "start", "logdir": "/tmp/w"}, {"action": "start", "logdir": "/x"},
                    None, {"action": "stop"}, {"action": "stop"}):
        path = "/debug/profiler"
        jo, to = same_shape(http(js.port, path, payload), http(ts.port, path, payload), payload)
        assert to == jo
    st = (json.loads(http(ts.port, "/debug/profiler")[2]))
    assert st == {"active": False, "logdir": None}


def test_real_profiler_window_records_the_engine_thread(tiny, tmp_path, monkeypatch):
    """The default window (torch.profiler, CPU activity here) opened over
    HTTP while the engine thread serves a request writes a Chrome trace
    holding the engine thread's ops (profile_all_threads), not the
    handler's alone."""
    monkeypatch.setattr(profiler, "PROFILER", profiler.ProfilerWindow())
    ts = api.ApiServer(tiny[1], port=0, **SERVE).start()
    try:
        logdir = str(tmp_path / "prof")
        code, _, body = http(ts.port, "/debug/profiler", {"action": "start", "logdir": logdir})
        assert code == 200 and json.loads(body)["active"]
        assert http(ts.port, "/debug/profiler", {"action": "start", "logdir": logdir})[0] == 409
        assert http(ts.port, "/generate", {"prompt": [3, 1, 4], "max_new_tokens": 4})[0] == 200
        code, _, body = http(ts.port, "/debug/profiler", {"action": "stop"})
        assert code == 200 and json.loads(body)["logdir"] == logdir
        traces = [f for f in os.listdir(logdir) if f.startswith("trace-")]
        assert len(traces) == 1
        events = json.load(open(os.path.join(logdir, traces[0])))["traceEvents"]
        tids = {e.get("tid") for e in events if str(e.get("name", "")).startswith("aten::")}
        assert ts.worker.native_id in tids, tids
    finally:
        ts.shutdown()


def test_request_timer_feeds_metrics():
    seen = []

    class M:
        def observe_request(self, endpoint, status, seconds):
            seen.append((endpoint, status))

    with errors.request_timer(M(), "/x") as t:
        t.status = 429
    with pytest.raises(KeyError):
        with errors.request_timer(M(), "/y"):
            raise KeyError("boom")
    assert seen == [("/x", 429), ("/y", 500)]
    with pytest.raises(errors.InvalidInputError, match="bad. fix it"):
        errors.invalid_input_error(False, "bad", "fix it")
    errors.invalid_input_error(True, "fine")


def test_listen_backlog_takes_a_burst_of_clients(tiny):
    """The server's listen backlog is 128, not the standard library's 5,
    which dropped the 16th of 16 concurrent connections while the engine
    thread held the interpreter lock (its SYN came again a second
    later); the FastChat worker shares the server class."""
    from bigdl_tpu_torch.serving import FastChatWorker

    ts = api.ApiServer(tiny[1], port=0, **SERVE)
    w = FastChatWorker(tiny[1], port=0, n_slots=1, max_len=64)
    try:
        for httpd in (ts.httpd, w.httpd):
            assert isinstance(httpd, api._HTTPServer) and httpd.request_queue_size == 128
        ts.start()
        http(ts.port, "/health")  # the client's opener, built once
        out = []
        cs = [threading.Thread(target=lambda: out.append(http(ts.port, "/health")[0]))
              for _ in range(32)]
        for c in cs:
            c.start()
        for c in cs:
            c.join(60)
        assert out == [200] * 32
    finally:
        ts.shutdown()
        w.httpd.server_close()
