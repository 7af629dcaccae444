"""FastChat model-worker protocol over the continuous-batching engine
(port of bigdl_tpu/serving/fastchat_worker.py): a worker process that
registers with a FastChat controller, heartbeats its queue length so the
controller can route, and serves the worker HTTP surface
(`/worker_generate_stream`, `/worker_generate`, `/worker_get_status`,
`/count_token`, `/model_details`, `/worker_get_conv_template`), so the
port drops into a FastChat deployment (controller + openai_api_server)
as a worker.

- standard library only (ThreadingHTTPServer + urllib), as api_server.py;
- generation runs through the slot engine, so one worker serves
  `n_slots` requests at once;
- streaming frames follow FastChat's wire format: JSON chunks terminated
  by NUL (b"\\0"), each {"text", "error_code", "usage", "finish_reason"}
  with cumulative text.
"""

from __future__ import annotations

import json
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler
from typing import Optional
from urllib import request as urlrequest

from bigdl_tpu_torch.serving.api_server import _EngineThread, _HTTPServer, _sampling_kwargs
from bigdl_tpu_torch.serving.engine import InferenceEngine

HEARTBEAT_S = 45  # FastChat controller expiry default is 90s


class FastChatWorker:
    def __init__(
        self,
        model,
        tokenizer=None,
        controller_addr: Optional[str] = None,  # e.g. http://host:21001
        worker_addr: Optional[str] = None,  # how the controller reaches us
        model_names: Optional[list[str]] = None,
        host: str = "127.0.0.1",
        port: int = 21002,
        n_slots: int = 8,
        max_len: int = 2048,
        gen=None,
        paged: bool = False,
        speculative: bool = False,
        draft_k: int = 4,
        heartbeat_s: float = HEARTBEAT_S,
        truncate_prompts: bool = False,
        journal: Optional[str] = None,  # crash-recovery request journal
        # overload protection (docs/serving.md), same knobs as ApiServer
        max_queue: Optional[int] = None,
        queue_deadline_s: Optional[float] = None,
        deadline_s: Optional[float] = None,
        preemption: bool = True,
        adapters=None,  # AdapterRegistry (serving/adapters.py): worker
        # payloads gain an "adapter" field — one FastChat worker serves
        # many tenants' fine-tunes over one shared base
    ):
        self.adapters = adapters
        self.engine = InferenceEngine(
            model, n_slots=n_slots, max_len=max_len, gen=gen,
            paged=paged, speculative=speculative, draft_k=draft_k,
            truncate_prompts=truncate_prompts, journal=journal,
            max_queue=max_queue, queue_deadline_s=queue_deadline_s,
            deadline_s=deadline_s, preemption=preemption,
            adapters=adapters,
        )
        self.tokenizer = tokenizer
        self.controller_addr = controller_addr
        self.model_names = model_names or ["bigdl-tpu"]
        self.worker_id = uuid.uuid4().hex[:8]
        self.max_len = max_len
        self.call_ct = 0
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self.worker = _EngineThread(self.engine)
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self.heartbeat_s = heartbeat_s
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, code: int, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                try:
                    payload = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError:
                    return self._json(400, {"error": "invalid JSON"})
                route = self.path
                if route == "/worker_get_status":
                    return self._json(200, outer.status())
                if route == "/count_token":
                    try:
                        count = len(outer._encode(payload.get("prompt", "")))
                        return self._json(200, {"count": count,
                                                "error_code": 0})
                    except ValueError as e:  # text prompt, no tokenizer
                        return self._json(200, {"count": 0,
                                                "error_code": 50001,
                                                "text": str(e)})
                if route == "/model_details":
                    return self._json(200, {"context_length": outer.max_len})
                if route == "/worker_get_conv_template":
                    # a full Conversation field dict — the FastChat API
                    # server instantiates it directly, so None would
                    # crash every chat completion. sep_style 1 =
                    # ADD_COLON_SINGLE, the registry's generic default.
                    return self._json(200, {"conv": {
                        "name": outer.model_names[0],
                        "system_template": "{system_message}",
                        "system_message": "",
                        "roles": ["USER", "ASSISTANT"],
                        "messages": [],
                        "offset": 0,
                        "sep_style": 1,
                        "sep": "\n",
                        "sep2": None,
                        "stop_str": None,
                        "stop_token_ids": None,
                    }})
                if route == "/worker_generate":
                    return self._json(200, outer._generate_blocking(payload))
                if route == "/worker_generate_stream":
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.end_headers()
                    for chunk in outer._generate_stream(payload):
                        self.wfile.write(json.dumps(chunk).encode() + b"\0")
                        self.wfile.flush()
                    return None
                return self._json(404, {"error": f"no route {route}"})

        self.httpd = _HTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self.worker_addr = worker_addr or f"http://{host}:{self.port}"

    # ---- controller protocol ---------------------------------------------

    def status(self) -> dict:
        return {
            "model_names": self.model_names,
            "speed": 1,
            "queue_length": self._inflight,
        }

    def _post_controller(self, route: str, obj: dict) -> dict:
        req = urlrequest.Request(
            self.controller_addr + route,
            data=json.dumps(obj).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urlrequest.urlopen(req, timeout=15) as resp:
            body = resp.read()
            return json.loads(body) if body else {}

    def register(self) -> None:
        """POST /register_worker — the FastChat controller handshake."""
        self._post_controller("/register_worker", {
            "worker_name": self.worker_addr,
            "check_heart_beat": True,
            "worker_status": self.status(),
        })

    def _heartbeat_loop(self) -> None:
        while not self._hb_stop.wait(self.heartbeat_s):
            try:
                resp = self._post_controller("/receive_heart_beat", {
                    "worker_name": self.worker_addr,
                    "queue_length": self._inflight,
                })
                if not resp.get("exist", True):
                    self.register()  # controller restarted: re-handshake
            except Exception:  # noqa: BLE001 — controller outage: retry
                pass

    # ---- generation -------------------------------------------------------

    def _encode(self, prompt) -> list[int]:
        if isinstance(prompt, list):
            return [int(t) for t in prompt]
        if self.tokenizer is None:
            raise ValueError("text prompt but no tokenizer configured")
        return list(self.tokenizer(prompt)["input_ids"])

    def _decode(self, tokens: list[int]) -> str:
        if self.tokenizer is None:
            return " ".join(str(t) for t in tokens)
        return self.tokenizer.decode(tokens, skip_special_tokens=True)

    def _submit(self, payload: dict):
        self.call_ct += 1
        ids = self._encode(payload.get("prompt", ""))
        maxnt = int(payload.get("max_new_tokens", 256))
        kw = _sampling_kwargs(payload)
        # the engine knows ONE eos id; the full stop_token_ids set is
        # enforced worker-side in _generate_stream (any match cuts)
        stop_ids = {int(t) for t in payload.get("stop_token_ids") or []}
        if "eos_token_id" not in kw and stop_ids:
            kw["eos_token_id"] = next(iter(stop_ids))
        q: queue.SimpleQueue = queue.SimpleQueue()
        req = self.engine.submit(ids, maxnt, stream=q, **kw)
        return ids, req, q, stop_ids

    STREAM_INTERVAL = 2  # decode/emit every N tokens (reference default)

    def _generate_stream(self, payload: dict):
        """FastChat chunk protocol: cumulative text per frame, final
        frame carries finish_reason. Frames are emitted every
        STREAM_INTERVAL tokens (decode re-runs over the full output per
        frame — per-token frames would be O(n^2) detokenization)."""
        echo = bool(payload.get("echo", False))
        stops = payload.get("stop")
        stops = ([stops] if isinstance(stops, str) else list(stops or []))
        try:
            ids, req, q, stop_ids = self._submit(payload)
        except ValueError as e:
            yield {"text": str(e), "error_code": 50001, "usage": {},
                   "finish_reason": None}
            return
        with self._inflight_lock:
            self._inflight += 1
        finished = False
        try:
            prefix = self._decode(ids) if echo else ""
            toks: list[int] = []
            cut = None
            while True:
                try:
                    tok = q.get(timeout=300.0)
                except queue.Empty:
                    yield {"text": "generation timed out",
                           "error_code": 50004, "usage": {},
                           "finish_reason": "error"}
                    return
                if tok is None:
                    break
                if tok in stop_ids:  # any stop id cuts (engine knows one)
                    cut = "stop"
                    self.engine.cancel(req)
                    break
                toks.append(tok)
                if len(toks) % self.STREAM_INTERVAL:
                    continue
                text = self._decode(toks)
                for s in stops:  # stop-string cut, FastChat semantics
                    i = text.find(s)
                    if i >= 0:
                        cut, text = "stop", text[:i]
                        break
                yield {
                    "text": prefix + text,
                    "error_code": 0,
                    "usage": {
                        "prompt_tokens": len(ids),
                        "completion_tokens": len(toks),
                        "total_tokens": len(ids) + len(toks),
                    },
                    "finish_reason": None,
                }
                if cut:
                    self.engine.cancel(req)
                    break
            final_text = self._decode(toks)
            if cut:
                for s in stops:
                    i = final_text.find(s)
                    if i >= 0:
                        final_text = final_text[:i]
                        break
            if req.error:
                # 50007 = FastChat CONTEXT_OVERFLOW: a client mistake
                # (over-long prompt rejected at submit), not a worker
                # failure — gateways must not health-flap on it.
                # 42903 = ENGINE_OVERLOADED: shed requests (queue bound
                # / queue deadline) and per-request deadline kills
                # (docs/serving.md) are retryable load pressure, not
                # worker failures either.
                code = {"invalid": 50007, "shed": 42903,
                        "timeout": 42903}.get(req.finish_reason, 50002)
                yield {"text": req.error, "error_code": code, "usage": {},
                       "finish_reason": "error"}
            else:
                yield {
                    "text": prefix + final_text,
                    "error_code": 0,
                    "usage": {
                        "prompt_tokens": len(ids),
                        "completion_tokens": len(toks),
                        "total_tokens": len(ids) + len(toks),
                    },
                    "finish_reason": cut or req.finish_reason or "length",
                }
            finished = True
        finally:
            if not finished and not req.done:
                # client disconnect (GeneratorExit via BrokenPipeError) or
                # timeout: stop burning decode steps for a gone consumer
                self.engine.cancel(req)
            with self._inflight_lock:
                self._inflight -= 1

    def _generate_blocking(self, payload: dict) -> dict:
        last = {"text": "", "error_code": 50002, "usage": {},
                "finish_reason": "error"}
        for last in self._generate_stream(payload):
            pass
        return last

    # ---- lifecycle --------------------------------------------------------

    def start(self, register: bool = True) -> None:
        self.worker.start()
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()
        if register and self.controller_addr:
            self.register()
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, daemon=True
            )
            self._hb_thread.start()

    def shutdown(self) -> None:
        self._hb_stop.set()
        self.httpd.shutdown()
        self.worker.stop_flag.set()
