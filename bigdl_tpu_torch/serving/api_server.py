"""OpenAI- and TGI-compatible HTTP server over the continuous-batching
engine (port of bigdl_tpu/serving/api_server.py), on the standard
library's threading HTTP server: no third-party serving dependency; one
engine thread steps the engine, handler threads submit and wait.

Endpoints (the JAX package's, with its status mapping):
    GET  /health /recovered /info /metrics /adapters /debug/trace
         /debug/profiler
    POST /generate /generate_stream  legacy {"prompt": str|[int]} or TGI
                                     {"inputs", "parameters"}; SSE stream
    POST /v1/completions             OpenAI completion schema (subset),
                                     logprobs and top_logprobs
    POST /v1/chat/completions        OpenAI chat schema (subset), streaming
    POST /debug/trace /debug/profiler /adapters/load /adapters/unload
    POST /v1/audio/transcriptions /v1/embeddings
                                     400: whisper and bert are not ported
                                     (ROADMAP queue 1 item [9])

400 is a caller's mistake, 429 a full queue and 503 a passed queue
deadline (both with Retry-After), 504 a blown budget (with the partial
tokens), 500 anything else; adapter errors map to 404/409/422/507.

Text prompts need a tokenizer (pass tokenizer=); token-id list prompts
work without one. The server serves the model on the device it was built
on: the engine thread launches the card's kernels, and nothing here
moves work to the CPU.
"""

from __future__ import annotations

import json
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Optional

from bigdl_tpu_torch.serving.engine import InferenceEngine


def _sampling_kwargs(payload: dict) -> dict:
    """OpenAI-ish request fields → per-request engine sampling kwargs.
    temperature<=0 means greedy (the OpenAI convention); presence of a
    positive temperature / top_p<1 / top_k>0 implies sampling unless
    do_sample is given explicitly. do_sample:true with temperature<=0 is
    contradictory and rejected (it would silently sample at the engine
    default temperature)."""
    from bigdl_tpu_torch.utils.errors import invalid_input_error

    kw: dict = {}
    if "temperature" in payload:
        t = float(payload["temperature"])
        if t <= 0:
            invalid_input_error(
                not payload.get("do_sample"),
                "do_sample=true with temperature<=0 is contradictory; "
                "drop do_sample for greedy or set temperature>0",
            )
            kw["do_sample"] = False
        else:
            kw.update(do_sample=True, temperature=t)
    if "top_p" in payload:
        kw["top_p"] = float(payload["top_p"])  # 1.0 = explicit disable
        if kw["top_p"] < 1.0:
            kw.setdefault("do_sample", True)
    if "top_k" in payload:
        kw["top_k"] = int(payload["top_k"])  # 0 = explicit disable
        if kw["top_k"] > 0:
            kw.setdefault("do_sample", True)
    if "do_sample" in payload:
        # explicit value wins over implied sampling (the t<=0 contradiction
        # was already rejected above)
        kw["do_sample"] = bool(payload["do_sample"])
    if "repetition_penalty" in payload:
        p = float(payload["repetition_penalty"])
        # HF/TGI contract: penalty > 0 (0 divides logits to inf/NaN)
        invalid_input_error(
            p > 0, f"repetition_penalty must be > 0, got {p}"
        )
        kw["repetition_penalty"] = p
    if "eos_token_id" in payload:
        kw["eos_token_id"] = int(payload["eos_token_id"])
    if payload.get("adapter") is not None:
        # multi-tenant LoRA (docs/serving.md §7): the named adapter this
        # request decodes with; resolution/refcounting happens at engine
        # admission, so a bad name is a structured per-request error
        a = payload["adapter"]
        invalid_input_error(
            isinstance(a, str) and bool(a),
            f"adapter must be a non-empty string, got {a!r}",
        )
        kw["adapter"] = a
    for f in ("queue_deadline_s", "deadline_s"):
        # per-request overload controls (docs/serving.md): how long the
        # request may wait for a slot, and its total wall-clock budget
        if f in payload:
            try:
                v = float(payload[f])
            except (TypeError, ValueError):
                invalid_input_error(
                    False, f"{f} must be a number, got {payload[f]!r}"
                )
            invalid_input_error(v > 0, f"{f} must be > 0, got {v}")
            kw[f] = v
    return kw


class _EngineThread(threading.Thread):
    def __init__(self, engine: InferenceEngine):
        super().__init__(daemon=True)
        self.engine = engine
        self.stop_flag = threading.Event()

    def run(self):
        while not self.stop_flag.is_set():
            try:
                busy = self.engine.step()
            except Exception as e:  # noqa: BLE001
                # fail everything in flight so clients unblock, then keep
                # serving (a poisoned request must not kill the server)
                self.engine.fail_all(f"engine error: {e}")
                busy = False
            if not busy:
                time.sleep(0.002)


class _HTTPServer(ThreadingHTTPServer):
    """The standard library's threading server with a listen backlog for
    a burst of clients. Its default of 5 drops connections past it while
    the accept loop waits for the interpreter lock behind the engine
    thread, and a dropped client sends its SYN again a second later."""

    request_queue_size = 128


class ApiServer:
    """The HTTP front of one `InferenceEngine`: every engine argument of
    JAX's server passes straight through. `start()` runs the engine thread
    and the HTTP server; `shutdown(graceful=True)` drains first."""

    def __init__(
        self,
        model,
        tokenizer=None,
        host: str = "127.0.0.1",
        port: int = 8000,
        n_slots: int = 8,
        max_len: int = 1024,
        gen=None,
        whisper=None,  # JAX's (WhisperConfig, params): not ported
        whisper_tokenizer=None,  # JAX's, for whisper's text
        embedder=None,  # JAX's (BertConfig, params, tokenizer): not ported
        paged: bool = False,  # paged KV pool + radix prefix caching
        page_size: int = 64,
        n_pages=None,
        prefill_chunk_tokens=None,  # paged: prefill in chunks of at most
        # this many tokens, one a step; None = monolithic prefill
        speculative: bool = False,  # in-engine draft-K-then-verify
        draft_params=None,  # None = sym_int4 self-draft of the model
        draft_k: int = 4,
        adaptive_draft: bool = False,  # acceptance-steered draft length
        truncate_prompts: bool = False,  # opt-in: keep over-long tails
        logprobs_top_k: int = 0,  # OpenAI top_logprobs alternatives
        journal: Optional[str] = None,  # crash-recovery request journal
        request_timeout_s: float = 300.0,  # buffered-wait / stream-stall
        # budget; on expiry the request is cancelled in the engine (the
        # slot frees) and the client sees 504
        max_queue: Optional[int] = None,  # admission bound: 429 above it
        queue_deadline_s: Optional[float] = None,  # default queue wait (503)
        deadline_s: Optional[float] = None,  # default total budget (504)
        preemption: bool = True,  # host-RAM KV swap under page pressure
        faults=None,  # FaultInjector (serving/faults.py)
        adapters=None,  # AdapterRegistry (serving/adapters.py): per-request
        # "adapter" fields and the /adapters lifecycle endpoints
        tracing: bool = False,  # request-lifecycle spans (obs/tracing.py);
        # the ring always exists so POST /debug/trace can turn it on
        trace_capacity: int = 65536,  # span ring-buffer bound
        request_log: Optional[str] = None,  # per-request timings JSONL
        clock: Callable[[], float] = time.time,  # every server-side
        # timestamp (uptime, `created`, the Retry-After rate, wait, stream
        # and drain deadlines) and the engine's and tracer's
    ):
        from bigdl_tpu_torch.obs.tracing import TraceRecorder
        from bigdl_tpu_torch.serving.metrics import Metrics

        for arg, name, what in ((whisper, "whisper", "whisper"), (embedder, "embedder", "bert")):
            if arg is not None:
                raise NotImplementedError(f"ApiServer({name}=...): {what} is not ported yet "
                                          "(ROADMAP queue 1 item [9])")
        self._clock = clock
        self.tracer = TraceRecorder(capacity=trace_capacity, enabled=tracing, clock=clock)
        self.adapters = adapters
        if adapters is not None:
            # registry events land in the engine's trace ring, clock domain
            # and fault-injection table
            adapters.bind(tracer=self.tracer, clock=clock, faults=faults)
        self.engine = InferenceEngine(
            model, n_slots=n_slots, max_len=max_len, gen=gen,
            paged=paged, page_size=page_size, n_pages=n_pages,
            prefill_chunk_tokens=prefill_chunk_tokens,
            speculative=speculative, draft_params=draft_params,
            draft_k=draft_k, adaptive_draft=adaptive_draft,
            truncate_prompts=truncate_prompts,
            logprobs_top_k=logprobs_top_k, journal=journal,
            max_queue=max_queue, queue_deadline_s=queue_deadline_s,
            deadline_s=deadline_s, preemption=preemption, faults=faults,
            adapters=adapters,
            tracer=self.tracer, request_log=request_log, clock=clock,
        )
        self.request_timeout_s = request_timeout_s
        self._t_start = clock()
        self.tokenizer = tokenizer
        self.metrics = Metrics(self.engine)
        self.worker = _EngineThread(self.engine)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json_raw(self, code: int, obj: Any, headers=None):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, str(v))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code: int, obj: Any, headers=None):
                self._status = code  # annotated for metrics
                return self._json_raw(code, obj, headers)

            def do_GET(self):
                if self.path == "/health":
                    return self._json(200, {"status": "ok"})
                if self.path == "/recovered":
                    # journal-replayed requests from a previous process:
                    # their original clients died with that process, so
                    # the results are retrievable here instead of being
                    # recomputed-and-discarded (decode happens once; the
                    # operator or a reconciliation job collects them)
                    out = []
                    for r in outer.engine.recovered_requests:
                        out.append({
                            "rid": r.rid,
                            "prompt": r.prompt,
                            "done": r.done,
                            "finish_reason": r.finish_reason,
                            "tokens": list(r.out_tokens),
                            "text": outer._decode_tok(r.out_tokens)
                            if r.done else None,
                        })
                    return self._json(200, {"recovered": out})
                if self.path == "/info":  # TGI-protocol model info
                    from bigdl_tpu_torch import __version__

                    cfg = outer.engine.config
                    return self._json(200, {
                        "model_id": cfg.model_type,
                        "model_dtype": outer.engine.model.qtype,
                        "max_total_tokens": outer.engine.max_len,
                        "max_concurrent_requests": outer.engine.n_slots,
                        "version": __version__,
                    })
                if self.path == "/metrics":
                    body = outer.metrics.render().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", "text/plain; version=0.0.4"
                    )
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return None
                if self.path == "/adapters":
                    # multi-tenant LoRA inventory (docs/serving.md §7):
                    # residency, refcounts, pin state, churn counters
                    if outer.adapters is None:
                        return self._json(
                            400, {"error": "no adapter registry (pass "
                                  "adapters= to ApiServer)"})
                    return self._json(200, {
                        "adapters": outer.adapters.resident(),
                        "stats": outer.adapters.stats(),
                    })
                if self.path == "/debug/trace":
                    # the ring buffer as Chrome trace-event JSON — saved
                    # to a file it loads directly in Perfetto
                    # (docs/observability.md; `bigdl-tpu-torch trace dump`)
                    return self._json(200, outer.tracer.export())
                if self.path == "/debug/profiler":
                    from bigdl_tpu_torch.obs.profiler import PROFILER

                    return self._json(200, PROFILER.status())
                return self._json(404, {"error": "not found"})

            def _debug_trace(self, payload):
                """POST /debug/trace: toggle span recording / clear the
                ring on a live server ({"enabled": bool?, "clear":
                bool?}); responds with the recorder status."""
                if "enabled" in payload:
                    outer.tracer.enabled = bool(payload["enabled"])
                if payload.get("clear"):
                    outer.tracer.clear()
                return self._json(200, outer.tracer.status())

            def _debug_profiler(self, payload):
                """POST /debug/profiler: {"action": "start", "logdir":
                ...} opens a guarded torch.profiler window; {"action":
                "stop"} closes it and writes its Chrome trace into the
                logdir. Busy/idle misuse is 409, never a wedged
                profiler."""
                from bigdl_tpu_torch.obs.profiler import (
                    PROFILER, ProfilerBusy, ProfilerIdle,
                )

                action = payload.get("action")
                try:
                    if action == "start":
                        logdir = payload.get("logdir")
                        if not logdir:
                            return self._json(
                                400, {"error": "profiler start needs "
                                      "a logdir"})
                        return self._json(200, PROFILER.start(logdir))
                    if action == "stop":
                        return self._json(200, PROFILER.stop())
                except (ProfilerBusy, ProfilerIdle) as e:
                    return self._json(409, {"error": str(e)})
                return self._json(
                    400, {"error": f"unknown profiler action "
                          f"{action!r}; use start|stop"})

            _KNOWN_POSTS = {
                "/generate", "/generate_stream", "/v1/completions",
                "/v1/chat/completions", "/v1/audio/transcriptions",
                "/v1/embeddings", "/debug/trace", "/debug/profiler",
                "/adapters/load", "/adapters/unload",
            }

            # AdapterError.kind -> HTTP status (docs/serving.md §7):
            # missing artifacts are a 404, a live-referenced unload is a
            # 409 the operator retries after drain, corrupt/mismatched
            # artifacts are an unprocessable 422, and an over-budget
            # load is a 507 (insufficient storage — literally)
            _ADAPTER_STATUS = {"missing": 404, "busy": 409,
                               "corrupt": 422, "rank_mismatch": 422,
                               "budget": 507}

            def _adapter_op(self, payload, op: str):
                """POST /adapters/{load,unload}: operator lifecycle for
                the multi-tenant registry."""
                if outer.adapters is None:
                    return self._json(
                        400, {"error": "no adapter registry (pass "
                              "adapters= to ApiServer)"})
                from bigdl_tpu_torch.serving.adapters import AdapterError

                name = payload.get("name")
                if not isinstance(name, str) or not name:
                    return self._json(
                        400, {"error": "body needs a non-empty "
                              '"name" string'})
                try:
                    if op == "load":
                        desc = outer.adapters.load(
                            name, path=payload.get("path"),
                            pin=bool(payload.get("pin", False)),
                        )
                        # validate against the SERVING model now: an
                        # operator pre-loading a wrong-base artifact
                        # should hear 422 here, not watch every tenant
                        # request error later (the registry alone
                        # cannot see the model's dims). peek() — a
                        # validation pass must not count as a hit.
                        entry = outer.adapters.peek(name)
                        if entry is not None:
                            try:
                                outer.engine._check_adapter_dims(entry)
                            except AdapterError:
                                outer.adapters.reject(entry, held=False)
                                raise
                    else:
                        desc = outer.adapters.unload(name)
                except AdapterError as e:
                    return self._json(
                        self._ADAPTER_STATUS.get(e.kind, 400),
                        {"error": str(e), "kind": e.kind, "name": name},
                    )
                return self._json(200, {"adapter": desc, "op": op})

            def do_POST(self):
                from bigdl_tpu_torch.utils.errors import (
                    InvalidInputError, request_timer,
                )

                self._status = 200
                # unknown paths share one metrics label — raw paths would
                # let a scanner grow the registry without bound
                label = self.path if self.path in self._KNOWN_POSTS else "other"
                with request_timer(outer.metrics, label) as timer:
                    try:
                        self._route_post()
                    except InvalidInputError as e:
                        self._json(400, {"error": str(e)})
                    except Exception as e:  # noqa: BLE001
                        self._json(500, {"error": str(e)})
                    timer.status = self._status

            def _route_post(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    raw = self.rfile.read(n)
                except Exception as e:
                    return self._json(400, {"error": f"bad request: {e}"})
                if self.path == "/v1/audio/transcriptions":
                    return self._transcribe(raw)
                try:
                    payload = json.loads(raw or b"{}")
                except Exception as e:
                    return self._json(400, {"error": f"bad json: {e}"})
                # TGI request schema: "inputs" (parameters optional); the
                # legacy shape uses "prompt"
                is_tgi = "parameters" in payload or (
                    "inputs" in payload and "prompt" not in payload
                )
                if self.path == "/debug/trace":
                    return self._debug_trace(payload)
                if self.path == "/debug/profiler":
                    return self._debug_profiler(payload)
                if self.path == "/adapters/load":
                    return self._adapter_op(payload, "load")
                if self.path == "/adapters/unload":
                    return self._adapter_op(payload, "unload")
                if self.path == "/v1/embeddings":
                    return self._embeddings(payload)
                if self.path == "/generate":
                    if is_tgi:
                        return self._tgi_generate(payload, stream=False)
                    return self._generate(payload, stream=False)
                if self.path == "/generate_stream":
                    if is_tgi:
                        return self._tgi_generate(payload, stream=True)
                    return self._generate(payload, stream=True)
                if self.path == "/v1/completions":
                    return self._completions(payload)
                if self.path == "/v1/chat/completions":
                    return self._chat(payload)
                return self._json(404, {"error": "not found"})

            def _tgi_generate(self, payload, stream: bool):
                """text-generation-inference protocol (the reference's
                TGI-protocol worker, serving/fastchat/tgi_api_server.py):
                {"inputs": str, "parameters"?: {...}} ->
                {"generated_text": ...}. The stream variant follows the
                TGI StreamResponse shape: every event carries a token
                object and generated_text rides the LAST token event."""
                from bigdl_tpu_torch.utils.errors import invalid_input_error

                params = payload.get("parameters") or {}
                ids = outer._encode(payload.get("inputs", ""))
                maxnt = int(params.get("max_new_tokens", 64))
                kw = _sampling_kwargs(params)
                stops = params.get("stop", []) or []
                invalid_input_error(
                    isinstance(stops, list)
                    and all(isinstance(s, str) for s in stops),
                    "parameters.stop must be a list of strings",
                )

                def cut(text):
                    for s in stops:
                        idx = text.find(s)
                        if idx >= 0:
                            return text[:idx], True
                    return text, False

                def tokens_until_cut(out_tokens):
                    """(text, finish_reason_override, n_tokens): decode
                    incrementally so generated_tokens matches the cut."""
                    pieces = []
                    for n, tok in enumerate(out_tokens, start=1):
                        pieces.append(outer._decode_tok([tok]))
                        full, hit = cut("".join(pieces))
                        if hit:
                            return full, "stop_sequence", n
                    full, _ = cut("".join(pieces))
                    return full, None, len(out_tokens)

                if not stream:
                    req = outer.engine.submit(ids, maxnt, **kw)
                    if outer._wait(req):
                        return self._timeout_504(req)
                    if req.error:
                        return self._req_error(req)
                    text, stop_reason, n_gen = tokens_until_cut(req.out_tokens)
                    body = {"generated_text": text}
                    if params.get("details"):
                        body["details"] = {
                            "finish_reason": stop_reason or (
                                "eos_token" if req.finish_reason == "stop"
                                else "length"
                            ),
                            "generated_tokens": n_gen,
                        }
                    return self._json(200, body)

                q: queue.SimpleQueue = queue.SimpleQueue()
                req = outer.engine.submit(ids, maxnt, stream=q, **kw)
                if self._rejected(req):  # 400 beats a dead SSE stream
                    return self._req_error(req)
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.end_headers()

                def emit(tok, text, generated_text):
                    evt = {
                        "token": {"id": tok, "text": text, "special": False},
                        "generated_text": generated_text,
                    }
                    self.wfile.write(f"data: {json.dumps(evt)}\n\n".encode())
                    self.wfile.flush()

                # emit one event BEHIND so generated_text can ride the
                # last token event (the TGI schema has no token-less
                # final event)
                pieces: list[str] = []
                pending = None  # (tok, piece)
                stopped = False
                for tok in outer._stream_iter(q, req=req):
                    piece = outer._decode_tok([tok])
                    if pending is not None:
                        emit(*pending, None)
                    pieces.append(piece)
                    full, hit = cut("".join(pieces))
                    if hit:
                        stopped = True
                        emit(tok, piece, full)
                        outer.engine.cancel(req)  # free the slot: the
                        # client got its final event
                        break
                    pending = (tok, piece)
                if not stopped:
                    if req.error:
                        # match the plain stream path: clients must see
                        # the failure, not a fake successful final event
                        err = json.dumps({"error": req.error})
                        self.wfile.write(f"data: {err}\n\n".encode())
                    elif pending is not None:
                        emit(*pending, "".join(pieces))
                return None

            def _embeddings(self, payload):
                """OpenAI embeddings: JAX serves them over its bert
                encoder, which is not ported; 400 as JAX's server answers
                without an embedder."""
                return self._json(
                    400, {"error": "no embedding model loaded (pass "
                          "embedder=(config, params, tokenizer) to "
                          "ApiServer)"}
                )

            @staticmethod
            def _rejected(req):
                return req.done and req.finish_reason in (
                    "invalid", "shed"
                )

            def _timeout_504(self, req, error="generation timed out"):
                """504 with the partial output delivered (docs/serving.md):
                whether the kill came from the server's wait budget or
                the engine's own deadline, a buffered transport must not
                drop tokens a streaming client would already have
                received."""
                body = {"error": error}
                # one snapshot: the engine thread may still be appending
                # until the cancel reaps, and tokens/text must agree
                toks = list(req.out_tokens)
                if toks:
                    body["tokens"] = toks
                    body["text"] = outer._decode_tok(toks)
                return self._json(504, body)

            def _req_error(self, req):
                """One mapping for every endpoint: submit-time rejection
                ("invalid", a client mistake) is 400; overload shedding
                is 429 (queue full) / 503 (queue deadline) with a
                Retry-After derived from current throughput; a blown
                deadline is 504; anything else is a server-side 500."""
                reason = req.finish_reason
                if reason == "invalid":
                    return self._json(400, {"error": req.error})
                if reason == "shed":
                    code = 429 if req.shed_kind == "queue_full" else 503
                    return self._json(
                        code, {"error": req.error},
                        headers={"Retry-After": outer._retry_after()},
                    )
                if reason == "timeout":
                    return self._timeout_504(req, req.error)
                return self._json(500, {"error": req.error})

            def _transcribe(self, raw: bytes):
                """Whisper transcription: not ported; 400 as JAX's server
                answers without a whisper model."""
                return self._json(
                    400, {"error": "no whisper model loaded "
                          "(pass whisper=(config, params) to ApiServer)"}
                )

            # ---- endpoint bodies ----
            def _generate(self, payload, stream: bool):
                ids = outer._encode(payload.get("prompt", payload.get("inputs", "")))
                maxnt = int(payload.get("max_new_tokens", payload.get("max_tokens", 64)))
                if stream:
                    q: queue.SimpleQueue = queue.SimpleQueue()
                    req = outer.engine.submit(ids, maxnt, stream=q,
                                              **_sampling_kwargs(payload))
                    if self._rejected(req):
                        return self._req_error(req)
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.end_headers()
                    for tok in outer._stream_iter(q, req=req):
                        text = outer._decode_tok([tok])
                        evt = json.dumps({"token": tok, "text": text})
                        self.wfile.write(f"data: {evt}\n\n".encode())
                        self.wfile.flush()
                    if req.error:
                        err = json.dumps({"error": req.error})
                        self.wfile.write(f"data: {err}\n\n".encode())
                    self.wfile.write(b"data: [DONE]\n\n")
                    return None
                req = outer.engine.submit(ids, maxnt,
                                          **_sampling_kwargs(payload))
                if outer._wait(req):
                    return self._timeout_504(req)
                if req.error:
                    return self._req_error(req)
                return self._json(200, {
                    "tokens": req.out_tokens,
                    "text": outer._decode_tok(req.out_tokens),
                })

            def _completions(self, payload):
                ids = outer._encode(payload.get("prompt", ""))
                maxnt = int(payload.get("max_tokens", 64))
                req = outer.engine.submit(ids, maxnt,
                                          **_sampling_kwargs(payload))
                if outer._wait(req):
                    return self._timeout_504(req)
                if req.error:
                    return self._req_error(req)
                choice = {
                    "index": 0,
                    "text": outer._decode_tok(req.out_tokens),
                    "finish_reason": req.finish_reason or "length",
                }
                if payload.get("logprobs") is not None:
                    # OpenAI completions logprobs subset: the chosen
                    # token's log-softmax under the model (pre-filtering)
                    choice["logprobs"] = {
                        "tokens": [outer._decode_tok([t])
                                   for t in req.out_tokens],
                        "token_logprobs": req.out_logprobs,
                    }
                    n_req = 0
                    try:
                        n_req = int(payload.get("logprobs") or 0)
                    except (TypeError, ValueError):
                        pass
                    if req.out_top_logprobs and n_req > 0:
                        # honor the requested count (engine serves up to
                        # its static logprobs_top_k); on decoded-string
                        # collisions keep the HIGHER logprob
                        tops = []
                        for alt in req.out_top_logprobs:
                            d = {}
                            for t, lp in list(alt.items())[:n_req]:
                                s_tok = outer._decode_tok([t])
                                if s_tok not in d or lp > d[s_tok]:
                                    d[s_tok] = lp
                            tops.append(d)
                        choice["logprobs"]["top_logprobs"] = tops
                return self._json(200, {
                    "id": f"cmpl-{uuid.uuid4().hex[:12]}",
                    "object": "text_completion",
                    "created": int(outer._clock()),
                    "model": payload.get("model", "bigdl-tpu"),
                    "choices": [choice],
                    "usage": {
                        "prompt_tokens": len(ids),
                        "completion_tokens": len(req.out_tokens),
                        "total_tokens": len(ids) + len(req.out_tokens),
                    },
                })

            def _chat(self, payload):
                messages = payload.get("messages", [])
                ids = outer._encode_chat(messages)
                maxnt = int(payload.get("max_tokens", 64))
                if payload.get("stream"):
                    q: queue.SimpleQueue = queue.SimpleQueue()
                    req = outer.engine.submit(ids, maxnt, stream=q,
                                              **_sampling_kwargs(payload))
                    if self._rejected(req):
                        return self._req_error(req)
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.end_headers()
                    cid = f"chatcmpl-{uuid.uuid4().hex[:12]}"
                    for tok in outer._stream_iter(q, req=req):
                        chunk = {
                            "id": cid, "object": "chat.completion.chunk",
                            "choices": [{
                                "index": 0,
                                "delta": {"content": outer._decode_tok([tok])},
                            }],
                        }
                        self.wfile.write(
                            f"data: {json.dumps(chunk)}\n\n".encode()
                        )
                        self.wfile.flush()
                    if req.error:
                        err = json.dumps({"error": req.error})
                        self.wfile.write(f"data: {err}\n\n".encode())
                    self.wfile.write(b"data: [DONE]\n\n")
                    return None
                req = outer.engine.submit(ids, maxnt,
                                          **_sampling_kwargs(payload))
                if outer._wait(req):
                    return self._timeout_504(req)
                if req.error:
                    return self._req_error(req)
                return self._json(200, {
                    "id": f"chatcmpl-{uuid.uuid4().hex[:12]}",
                    "object": "chat.completion",
                    "created": int(outer._clock()),
                    "model": payload.get("model", "bigdl-tpu"),
                    "choices": [{
                        "index": 0,
                        "message": {
                            "role": "assistant",
                            "content": outer._decode_tok(req.out_tokens),
                        },
                        "finish_reason": req.finish_reason or "length",
                    }],
                })

        self.httpd = _HTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]

    # ---- helpers ----------------------------------------------------------

    def _encode(self, prompt) -> list[int]:
        if isinstance(prompt, list):
            return [int(t) for t in prompt]
        if self.tokenizer is None:
            raise ValueError("text prompt but no tokenizer configured")
        return list(self.tokenizer(prompt)["input_ids"])

    def _encode_chat(self, messages) -> list[int]:
        if self.tokenizer is not None and hasattr(
            self.tokenizer, "apply_chat_template"
        ):
            return list(self.tokenizer.apply_chat_template(
                messages, add_generation_prompt=True
            ))
        # tokenizer-less fallback: messages may carry raw token ids
        ids: list[int] = []
        for m in messages:
            c = m.get("content")
            if isinstance(c, list):
                ids.extend(int(t) for t in c)
            else:
                ids.extend(self._encode(c))
        return ids

    def _decode_tok(self, tokens: list[int]) -> str:
        if self.tokenizer is None:
            return ""
        return self.tokenizer.decode(tokens, skip_special_tokens=True)

    def _retry_after(self) -> int:
        """Seconds a shed client should back off: queue depth over the
        engine's observed completion throughput (conservative 30 s before
        the first completion — no rate signal yet). The lifetime-average
        rate goes stale across idle stretches, so the advice is capped:
        a shed client should re-probe within minutes regardless."""
        eng = self.engine
        rate = eng.requests_completed / max(self._clock() - self._t_start,
                                            1e-6)
        if rate <= 0:
            return 30
        depth = eng._queue.qsize() + 1
        return max(1, min(int(depth / rate) + 1, 120))

    def _stream_iter(self, q, timeout: Optional[float] = None, req=None):
        """Yield tokens until the None sentinel. A stall past the timeout
        (dead engine, injected stuck step) ends the stream AND cancels
        the request in the engine — a stalled client stream must not keep
        burning a decode slot.

        The blocking q.get tick stays real time (a queue cannot sleep on
        a simulated clock), but the stall *verdict* — has `timeout`
        elapsed since the last token — is measured on the injected
        clock, so the simulated-clock benchmark drives stream deadlines
        exactly like every other deadline."""
        timeout = self.request_timeout_s if timeout is None else timeout
        tick = min(timeout, 0.05)
        last = self._clock()
        while True:
            try:
                tok = q.get(timeout=tick)
            except queue.Empty:
                if self._clock() - last < timeout:
                    continue
                if req is not None and not req.done:
                    self.engine.cancel(req)
                    # re-check AFTER the cancel, mirroring _wait: a
                    # request that finished in the race window must not
                    # be stamped stalled or counted as a timeout
                    if not req.done:
                        # the error makes every stream consumer's
                        # post-loop branch emit a failure event — without
                        # it, a timeout-truncated stream ends with the
                        # same [DONE]/final-success shape as a complete
                        # one (the engine reaps the cancel as a clean
                        # "stop" and never clears the stamp)
                        req.error = (
                            f"stream stalled > {timeout}s; "
                            "request cancelled"
                        )
                        self.engine._bump("request_timeouts")
                return
            if tok is None:
                return
            last = self._clock()
            self.metrics.count_tokens(1)
            yield tok

    def _wait(self, req, timeout: Optional[float] = None) -> bool:
        """Block until the request finishes; True = the server-side wait
        budget expired. Callers must 504 on True without re-checking
        req.done — the engine reaps the cancel concurrently, and a late
        done/'stop' must not turn a timeout into a 200 with silently
        truncated output."""
        timeout = self.request_timeout_s if timeout is None else timeout
        t0 = self._clock()
        while not req.done and self._clock() - t0 < timeout:
            time.sleep(0.005)
        if not req.done:
            # engine-cancelling timeout: before this, a timed-out
            # buffered request kept decoding into its slot forever
            self.engine.cancel(req)
            if not req.done:
                self.engine._bump("request_timeouts")
                return True
            # lost the race: the engine finished (and, for its own
            # deadline kill, already counted) the request between our
            # last poll and the cancel — bumping would double-count it;
            # fall through to normal handling of the finished request
        if not req.error:
            self.metrics.count_tokens(len(req.out_tokens))
        return False

    # ---- lifecycle ---------------------------------------------------------

    def start(self):
        self.worker.start()
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        return self

    def shutdown(self, graceful: bool = False,
                 drain_timeout_s: Optional[float] = None) -> bool:
        """Stop the server. graceful=True first drains: admissions shed
        with 503 + Retry-After while the engine thread finishes every
        in-flight and queued request, bounded by `drain_timeout_s`
        (default: request_timeout_s — no client is waiting longer than
        that anyway). Either way the journal is then flushed + compacted
        (engine.close), so a clean drain leaves nothing to replay and a
        kill mid-batch still only relies on replay for the unfinished
        tail. Returns True when the drain completed (vacuously for
        graceful=False)."""
        drained = True
        if graceful:
            self.engine.begin_drain()
            timeout = (self.request_timeout_s if drain_timeout_s is None
                       else drain_timeout_s)
            deadline = self._clock() + timeout
            while not self.engine.idle():
                if self._clock() > deadline:
                    drained = False
                    break
                time.sleep(0.01)
        self.worker.stop_flag.set()
        if self.worker.is_alive():
            # the engine thread must be parked before close(): the
            # journal handle closes and compaction renames the file —
            # doing either under a live writer turns the next
            # record_done into an I/O error that kills the thread
            self.worker.join(timeout=10.0)
        if not self.worker.is_alive():
            self.engine.close()
        # else: a wedged step outlived the join budget — leave the
        # journal attached (the process is exiting anyway) and let the
        # next start's replay cover the unfinished tail
        self.httpd.shutdown()
        return drained

    def install_signal_handlers(self) -> None:
        """SIGTERM -> graceful drain + exit 0 (k8s preStop/termination
        path: the pod's termination grace period must exceed
        request_timeout_s for the drain to finish). Main-thread only;
        cmd_serve calls this — embedded/test servers manage their own
        lifecycle."""
        import signal

        if threading.current_thread() is not threading.main_thread():
            return

        def _handler(signum, frame):
            # restore first: a second SIGTERM mid-drain kills for real
            signal.signal(signum, signal.SIG_DFL)
            self.shutdown(graceful=True)
            raise SystemExit(0)

        signal.signal(signal.SIGTERM, _handler)
