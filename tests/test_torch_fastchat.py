"""The FastChat worker of bigdl_tpu_torch (serving/fastchat_worker.py)
against the JAX package's (bigdl_tpu/serving/fastchat_worker.py), as
tests/test_fastchat.py runs it: both workers register with one stub
controller and heartbeat to it, and take the same worker requests. The
NUL-terminated frames of `/worker_generate_stream` compare frame by frame
(keys, usage, finish reasons, the cumulative text's token ids by the
margin rule of test_torch_serving.py); the other routes' bodies compare
equal."""

import json
import queue
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from bigdl_tpu.serving.fastchat_worker import FastChatWorker as JaxWorker
from bigdl_tpu_torch.serving import FastChatWorker
# the tiny-llama pair (a module fixture) and the HTTP helpers
from test_torch_api_server import jax_reference, margin_rule, skeleton
from test_torch_serving_control import tiny  # noqa: F401


class StubController:
    """A FastChat controller that records registrations and heartbeats
    (the worker's name in each) and answers `exist` as told."""

    def __init__(self):
        self.events: "queue.SimpleQueue[tuple]" = queue.SimpleQueue()
        self.exist = True
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                payload = json.loads(self.rfile.read(n) or b"{}")
                outer.events.put((self.path, payload))
                body = json.dumps({"exist": outer.exist}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.addr = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def by_worker(self, n, timeout=20):
        """The next `n` events, grouped by worker name."""
        out: dict = {}
        for _ in range(n):
            route, payload = self.events.get(timeout=timeout)
            out.setdefault(payload["worker_name"], []).append((route, payload))
        return out

    def shutdown(self):
        self.httpd.shutdown()


def post(url, obj, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, dict(r.headers), r.read()


@pytest.fixture(scope="module")
def workers(tiny):
    jm, tm, _ = tiny
    ws = (JaxWorker(jm, port=0, n_slots=2, max_len=128),
          FastChatWorker(tm, port=0, n_slots=2, max_len=128))
    for w in ws:
        w.start(register=False)
    yield ws
    for w in ws:
        w.shutdown()


def both(workers, route, payload):
    return [post(f"http://127.0.0.1:{w.port}{route}", payload) for w in workers]


def nul_frames(body: bytes) -> list:
    assert body.endswith(b"\0")
    return [json.loads(c) for c in body.split(b"\0") if c]


def test_workers_register_heartbeat_and_reregister(tiny):
    jm, tm, _ = tiny
    ctrl = StubController()
    ws = (JaxWorker(jm, controller_addr=ctrl.addr, port=0, n_slots=2, max_len=128,
                    model_names=["tiny-llama"], heartbeat_s=0.2),
          FastChatWorker(tm, controller_addr=ctrl.addr, port=0, n_slots=2, max_len=128,
                         model_names=["tiny-llama"], heartbeat_s=0.2))
    try:
        for w in ws:
            w.start()
        got = ctrl.by_worker(4)  # a registration and a heartbeat each
        assert set(got) == {w.worker_addr for w in ws}
        seen = [[(r, skeleton(p)) for r, p in got[w.worker_addr]] for w in ws]
        assert seen[1] == seen[0]
        route, payload = got[ws[1].worker_addr][0]
        assert route == "/register_worker"
        assert payload["worker_status"] == {"model_names": ["tiny-llama"], "speed": 1,
                                            "queue_length": 0}
        assert [r for r, _ in got[ws[1].worker_addr]] == ["/register_worker",
                                                          "/receive_heart_beat"]
        # the controller forgot the workers: each registers again
        ctrl.exist = False
        routes = {name: [] for name in got}
        while not all("/register_worker" in r for r in routes.values()):
            route, payload = ctrl.events.get(timeout=20)
            routes[payload["worker_name"]].append(route)
    finally:
        for w in ws:
            w.shutdown()
        ctrl.shutdown()


@pytest.mark.parametrize("payload", [
    {"prompt": [3, 1, 4, 1, 5], "max_new_tokens": 8},
    {"prompt": [2, 7, 1, 8], "max_new_tokens": 5, "echo": True},
    {"prompt": [9, 9, 8], "max_new_tokens": 6, "stop_token_ids": [10 ** 5]},
])
def test_stream_frames_match_jax(workers, tiny, payload):
    """NUL-terminated frames every 2 tokens with cumulative text, the last
    carrying finish_reason; usage counts equal the generated tokens."""
    (jc, jh, jb), (tc, th, tb) = both(workers, "/worker_generate_stream", payload)
    assert tc == jc == 200 and th["Content-Type"] == jh["Content-Type"]
    jf, tf = nul_frames(jb), nul_frames(tb)
    assert [skeleton(f) for f in tf] == [skeleton(f) for f in jf]
    assert [(f["error_code"], f["finish_reason"], f["usage"]) for f in tf] == \
        [(f["error_code"], f["finish_reason"], f["usage"]) for f in jf]
    n = payload["max_new_tokens"]
    assert tf[-1]["finish_reason"] == "length" and tf[-1]["usage"]["completion_tokens"] == n
    # echo: the prompt's text, then the generated text, unseparated
    skip = len(" ".join(map(str, payload["prompt"]))) if payload.get("echo") else 0
    j_toks = [int(t) for t in jf[-1]["text"][skip:].split()]
    t_toks = [int(t) for t in tf[-1]["text"][skip:].split()]
    ref = jax_reference(workers[0], payload["prompt"], n)
    assert ref.out_tokens == j_toks
    margin_rule(j_toks, t_toks, ref.out_top_logprobs, tiny[2])


def test_stop_string_cuts_the_stream_as_jax(workers):
    """A stop string (the tokenizer-less decode is space-joined ids) ends
    the stream with finish_reason "stop", the text cut before it."""
    prompt = [3, 1, 4, 1, 5]
    full = jax_reference(workers[0], prompt, 8).out_tokens
    stop = str(full[3])
    payload = {"prompt": prompt, "max_new_tokens": 8, "stop": stop}
    (_, _, jb), (_, _, tb) = both(workers, "/worker_generate_stream", payload)
    jf, tf = nul_frames(jb), nul_frames(tb)
    assert tf[-1]["finish_reason"] == jf[-1]["finish_reason"] == "stop"
    assert tf[-1]["text"] == jf[-1]["text"]
    assert stop not in tf[-1]["text"].split()


@pytest.mark.parametrize("route,payload", [
    ("/worker_generate", {"prompt": [3, 1, 4, 1, 5], "max_new_tokens": 4}),
    ("/worker_get_status", {}),
    ("/count_token", {"prompt": [1, 2, 3]}),
    ("/count_token", {"prompt": "no tokenizer"}),
    ("/model_details", {}),
    ("/worker_get_conv_template", {}),
    ("/worker_generate", {"prompt": "text without a tokenizer"}),
    ("/worker_generate", {"prompt": list(range(1, 126)), "max_new_tokens": 8}),
    ("/worker_generate", {"prompt": [1, 2], "temperature": 0, "do_sample": True}),
])
def test_worker_routes_match_jax(workers, route, payload):
    """The other routes' bodies: equal, the error codes too (50001 a text
    prompt without a tokenizer or a contradictory sampling request, whose
    InvalidInputError is a ValueError, 50007 a prompt over the
    context)."""
    (jc, _, jb), (tc, _, tb) = both(workers, route, payload)
    assert tc == jc
    jo, to = json.loads(jb), json.loads(tb)
    assert skeleton(to) == skeleton(jo)
    if route == "/worker_generate" and jo.get("error_code") == 0:
        assert (to["finish_reason"], to["usage"]) == (jo["finish_reason"], jo["usage"])
    else:
        assert to == jo
    if route == "/worker_get_status":
        assert to["queue_length"] == 0


def test_overload_and_adapter_arguments_reach_the_engine(tiny):
    jm, tm, _ = tiny
    from bigdl_tpu_torch.serving.adapters import AdapterRegistry

    reg = AdapterRegistry()
    w = FastChatWorker(tm, port=0, n_slots=1, max_len=64, max_queue=3,
                       queue_deadline_s=2.0, deadline_s=9.0, adapters=reg, paged=True)
    try:
        e = w.engine
        assert (e.max_queue, e.queue_deadline_s, e.deadline_s, e.adapters, e.paged) == \
            (3, 2.0, 9.0, reg, True)
        w.start(register=False)
        _, _, body = post(f"http://127.0.0.1:{w.port}/worker_generate_stream",
                          {"prompt": [1, 2, 3], "adapter": "missing-tenant"})
        f = nul_frames(body)[-1]
        assert f["error_code"] == 50002 and f["finish_reason"] == "error"
    finally:
        w.shutdown()
