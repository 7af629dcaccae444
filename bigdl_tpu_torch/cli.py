"""bigdl-tpu-torch command line (port of bigdl_tpu/cli.py): the same
subcommands, options and defaults as the JAX package's `bigdl-tpu`, plus
`--device` on every command that loads a model (default `cuda`: without
a card it raises, and nothing drops to the CPU unless asked).

    python -m bigdl_tpu_torch.cli convert  <hf_dir> -o <out_dir> -q sym_int4
    python -m bigdl_tpu_torch.cli generate <model_dir> -p "3 1 4 1 5" -n 64
    python -m bigdl_tpu_torch.cli serve    <model_dir> --paged --port 8000
    python -m bigdl_tpu_torch.cli fastchat-worker <model_dir> --controller-address URL
    python -m bigdl_tpu_torch.cli bench    <model_dir>
    python -m bigdl_tpu_torch.cli chat     <model_dir>
    python -m bigdl_tpu_torch.cli verify   <low_bit_dir>
    python -m bigdl_tpu_torch.cli trace    dump|summarize|profile-start|profile-stop ...
    python -m bigdl_tpu_torch.cli adapters list|load|unload|inspect ...

Commands whose modules are not ported raise NotImplementedError naming
their ROADMAP queue 1 item: `convert -f gguf`, a `.gguf` model and
`fetch-iq-tables` (item [10]), `txt2img` and `serve --embedder` (item
[9]), `train-status` and `verify` of a train checkpoint (item [6]),
`serve --comm-qtype` other than none (item [8]), `simserve` and `lint`
(item [12]).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_ITEM = {
    6: "ROADMAP queue 1 item [6], the training supervisor, which the port's "
       "train checkpoint layout waits for",
    8: "ROADMAP queue 1 item [8], multi-GPU",
    9: "ROADMAP queue 1 item [9], the rest of the zoo",
    10: "ROADMAP queue 1 item [10], the rest of convert",
    12: "ROADMAP queue 1 item [12], the outer surface",
}


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet ({_ITEM[item]})")


def _load(path: str, qtype, device="cuda"):
    """A `save_low_bit` directory, or an HF checkpoint directory quantized
    to `qtype` (sym_int4 by default), on `device`."""
    from bigdl_tpu_torch.api import AutoModelForCausalLM
    from bigdl_tpu_torch.utils import resolve_device

    if path.endswith(".gguf"):
        raise _not_ported("loading a .gguf model", 10)
    device = resolve_device(device)  # no card: raise before any file is read
    if os.path.exists(os.path.join(path, "bigdl_tpu_config.json")):
        return AutoModelForCausalLM.load_low_bit(path, device=device)
    return AutoModelForCausalLM.from_pretrained(path, load_in_low_bit=qtype or "sym_int4",
                                                device=device)


def _tokenizer(path: str):
    """The checkpoint directory's HF tokenizer, or None (no `transformers`,
    or no tokenizer files): prompts are then whitespace-separated token
    ids. Local files only."""
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(path, local_files_only=True)
    except Exception:
        return None


def _gen_text(model, tok, ids, max_new_tokens, temperature):
    """The one-shot and chat commands' generate: greedy or sampled, cut at
    EOS before decoding (generate pads the fixed output window after EOS;
    stripping pad values instead would eat real id-0 tokens)."""
    eos = tok.eos_token_id if tok else None
    out = model.generate([ids], max_new_tokens=max_new_tokens, do_sample=temperature > 0,
                         temperature=max(temperature, 1e-5), eos_token_id=eos)
    toks = out[0].tolist()
    if eos is not None and eos in toks:
        toks = toks[: toks.index(eos) + 1]
    return toks, (tok.decode(toks, skip_special_tokens=True) if tok else str(toks))


def cmd_convert(args):
    if args.format == "gguf":
        raise _not_ported("convert -f gguf (the gguf exporter)", 10)
    model = _load(args.model, args.qtype, args.device)
    model.save_low_bit(args.output)
    print(f"saved {args.qtype} model to {args.output}")


def cmd_generate(args):
    model = _load(args.model, args.qtype, args.device)
    tok = _tokenizer(args.model)
    if tok is None:
        ids = [int(t) for t in args.prompt.split()]
    else:
        ids = list(tok(args.prompt)["input_ids"])
    t0 = time.time()
    toks, text = _gen_text(model, tok, ids, args.max_new_tokens, args.temperature)
    dt = time.time() - t0
    print(text)
    print(f"[{len(toks)} tokens in {dt:.2f}s — {1000 * dt / max(len(toks), 1):.1f} ms/token]",
          file=sys.stderr)


def cmd_chat(args):
    """Interactive chat REPL over an incremental `ChatSession` (the cache
    persists across turns; --streaming-window makes the conversation
    unbounded through attention sinks)."""
    model = _load(args.model, args.qtype, args.device)
    if args.adapter:
        # one-tenant chat: fold the adapter into the loaded weights
        import torch

        from bigdl_tpu_torch.serving.adapters import load_adapter
        from bigdl_tpu_torch.train.qlora import LoRA, merge_lora

        lora, meta = load_adapter(args.adapter)
        dev = model.device
        merge_lora(model.params, LoRA({t: (p["a"].to(dev), p["b"].to(dev))
                                       for t, p in lora["layers"].items()},
                                      torch.tensor(lora["scale"], dtype=torch.float32,
                                                   device=dev)))
        print(f"note: merged adapter {args.adapter} (rank {meta.get('rank')})", file=sys.stderr)
    tok = _tokenizer(args.model)
    history: list[dict] = []

    def new_session():
        from bigdl_tpu_torch.chat import ChatSession

        streaming = ((args.streaming_sink, args.streaming_window)
                     if args.streaming_window else None)
        return ChatSession(model, max_len=args.max_len, streaming=streaming)

    session = None
    consumed: list[int] = []
    try:
        session = new_session()
    except NotImplementedError as e:
        print(f"note: {e}; using one-shot generation", file=sys.stderr)
    templated = tok is not None and getattr(tok, "chat_template", None)
    if args.system:
        if not templated:
            print("warning: --system needs a tokenizer chat template; ignored for this model",
                  file=sys.stderr)
        else:
            history.append({"role": "system", "content": args.system})
    print("bigdl-tpu-torch chat — empty line or /exit quits", file=sys.stderr)
    while True:
        try:
            line = input("you> ")
        except (EOFError, KeyboardInterrupt):
            break
        if not line.strip() or line.strip() == "/exit":
            break
        if templated:
            history.append({"role": "user", "content": line})
            ids = list(tok.apply_chat_template(history, add_generation_prompt=True))
        elif tok is not None:
            ids = list(tok(line)["input_ids"])
        else:  # no tokenizer: whitespace token ids
            ids = [int(t) for t in line.split()]
        if session is not None:
            eos = tok.eos_token_id if tok else None
            if ids[: len(consumed)] == consumed and len(ids) > len(consumed):
                delta = ids[len(consumed):]
            else:
                # the template rewrote earlier tokens (or the first turn):
                # start the session over with the full ids
                session.reset()
                consumed, delta = [], ids
            try:
                toks = session.send(delta, args.max_new_tokens, eos, temperature=args.temperature)
            except ValueError as e:  # window or max_len overflow
                print(f"note: {e}; restarting context", file=sys.stderr)
                session.reset()
                consumed = []
                try:
                    toks = session.send(ids, args.max_new_tokens, eos,
                                        temperature=args.temperature)
                except ValueError as e2:
                    # even a fresh context cannot fit this turn
                    print(f"error: {e2}", file=sys.stderr)
                    session.reset()
                    continue
            consumed = ids + toks
            text = tok.decode(toks, skip_special_tokens=True) if tok else str(toks)
        else:
            _, text = _gen_text(model, tok, ids, args.max_new_tokens, args.temperature)
        print(f"bot> {text}")
        if templated:
            history.append({"role": "assistant", "content": text})


def cmd_serve(args):
    from bigdl_tpu_torch.generate import GenerationConfig
    from bigdl_tpu_torch.serving.api_server import ApiServer

    if args.comm_qtype != "none":
        raise _not_ported(f"--comm-qtype {args.comm_qtype} (quantized TP collectives)", 8)
    if args.embedder:
        raise _not_ported("--embedder (bert embeddings)", 9)
    if args.speculative:
        # the sym_int4 self-draft needs a higher-precision target: fail
        # before the model load, and default the target to bf16
        if args.qtype is None:
            print("--speculative: loading target as bf16 (self-draft is sym_int4); "
                  "pass -q to override")
            args.qtype = "bf16"
        else:
            from bigdl_tpu_torch.quant.qtypes import resolve_qtype

            try:
                dense = resolve_qtype(args.qtype).is_dense
            except ValueError:
                dense = False
            if not dense:
                raise SystemExit(f"--speculative needs an unquantized target "
                                 f"(-q bf16/fp16); got -q {args.qtype}")
    model = _load(args.model, args.qtype, args.device)
    tok = _tokenizer(args.model)
    gen = GenerationConfig(eos_token_id=(tok.eos_token_id if tok is not None else None))
    adapters = None
    if args.adapter_dir or args.adapter_budget_mb or args.adapters:
        # any adapter flag enables the registry: a budget without a dir
        # still serves explicit-path POST /adapters/load
        from bigdl_tpu_torch.serving.adapters import AdapterRegistry

        adapters = AdapterRegistry(
            dir=args.adapter_dir,
            budget_bytes=(args.adapter_budget_mb * (1 << 20) if args.adapter_budget_mb
                          else None))
        for spec in args.adapters or []:
            name, _, path = spec.partition("=")
            desc = adapters.load(name, path=path or None, pin=True)
            print(f"pinned adapter {desc['name']} (rank {desc['rank']})", file=sys.stderr)
    server = ApiServer(
        model, tokenizer=tok, host=args.host, port=args.port, n_slots=args.slots,
        max_len=args.max_len, gen=gen, paged=args.paged,
        prefill_chunk_tokens=args.prefill_chunk_tokens, speculative=args.speculative,
        draft_k=args.draft_k, adaptive_draft=args.adaptive_draft,
        truncate_prompts=args.truncate_prompts, logprobs_top_k=args.logprobs_top_k,
        tracing=args.trace, trace_capacity=args.trace_capacity,
        request_log=args.request_log, adapters=adapters)
    server.start()
    server.install_signal_handlers()  # SIGTERM -> drain, flush, exit 0
    print(f"bigdl-tpu-torch serving {args.model} on {args.host}:{server.port}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        # ^C drains as SIGTERM does
        server.shutdown(graceful=True)


def cmd_fastchat_worker(args):
    from bigdl_tpu_torch.serving.fastchat_worker import FastChatWorker

    model = _load(args.model, args.qtype, args.device)
    worker = FastChatWorker(
        model, tokenizer=_tokenizer(args.model), controller_addr=args.controller_address,
        worker_addr=args.worker_address,
        model_names=(args.model_names.split(",") if args.model_names else None),
        host=args.host, port=args.port, n_slots=args.slots, max_len=args.max_len,
        paged=args.paged)
    worker.start(register=args.controller_address is not None)
    print(f"fastchat worker {worker.worker_id} serving {args.model} at {worker.worker_addr}",
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        worker.shutdown()


def cmd_fetch_iq_tables(args):
    raise _not_ported("fetch-iq-tables (the IQ-quant codebooks)", 10)


def cmd_txt2img(args):
    raise _not_ported("txt2img (Stable Diffusion)", 9)


def cmd_verify(args):
    """Offline integrity and numerical validation of a `save_low_bit`
    directory (full mode: sizes, shapes, crc32 and sha256 against the
    artifact's manifest, NaN/inf and scale-range scans), a per-tensor
    report; exit 1 on any finding."""
    path = args.path
    if os.path.isdir(path) and os.path.exists(os.path.join(path, "bigdl_tpu_config.json")):
        from bigdl_tpu_torch.convert.low_bit import verify_low_bit

        rep = verify_low_bit(path)
        print(rep.format())
        if not rep.ok:
            raise SystemExit(1)
        print("OK")
        return
    if os.path.isdir(path) or path.endswith(".npz"):
        raise _not_ported("verify of a train checkpoint", 6)
    raise SystemExit(f"{path}: expected a checkpoint directory or a .npz file")


def cmd_train_status(args):
    raise _not_ported("train-status (the training supervisor's run view)", 6)


def cmd_trace(args):
    """Observability against a live server or a dumped trace:

        bigdl-tpu-torch trace dump http://127.0.0.1:8000 -o trace.json
        bigdl-tpu-torch trace summarize trace.json
        bigdl-tpu-torch trace profile-start http://127.0.0.1:8000 --logdir /tmp/prof
        bigdl-tpu-torch trace profile-stop  http://127.0.0.1:8000

    `dump` fetches the server's span ring as Chrome trace-event JSON
    (Perfetto loads it); `summarize` reduces a trace file to a per-phase
    latency table; `profile-start`/`profile-stop` drive the server's
    guarded torch.profiler window."""
    if args.action == "summarize":
        from bigdl_tpu_torch.obs.tracing import format_summary, summarize_trace

        with open(args.target, encoding="utf-8") as f:
            trace = json.load(f)
        print(format_summary(summarize_trace(trace)))
        return
    import urllib.error
    import urllib.request

    base = args.target.rstrip("/")

    def fetch(req_or_path):
        req = req_or_path if not isinstance(req_or_path, str) else base + req_or_path
        path = req if isinstance(req, str) else req.full_url
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.read()
        except urllib.error.HTTPError as e:
            body = e.read().decode(errors="replace")
            raise SystemExit(f"{path} -> HTTP {e.code}: {body}")
        except urllib.error.URLError as e:
            raise SystemExit(f"cannot reach {path}: {e.reason}")

    def post(path, payload):
        return json.loads(fetch(urllib.request.Request(
            base + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})))

    if args.action == "dump":
        data = fetch("/debug/trace")
        try:
            n = len(json.loads(data).get("traceEvents", []))
        except json.JSONDecodeError:
            raise SystemExit(f"{base}/debug/trace returned non-JSON — is this a "
                             "bigdl-tpu server?")
        from bigdl_tpu_torch.utils.durability import atomic_write

        atomic_write(args.output, lambda f: f.write(data))
        print(f"wrote {n} trace events to {args.output} — open in Perfetto "
              "(https://ui.perfetto.dev) or chrome://tracing")
    elif args.action == "profile-start":
        if not args.logdir:
            raise SystemExit("profile-start needs --logdir")
        out = post("/debug/profiler", {"action": "start", "logdir": args.logdir})
        print(f"profiler window open -> {out['logdir']}")
    elif args.action == "profile-stop":
        out = post("/debug/profiler", {"action": "stop"})
        print(f"profiler window closed after {out.get('seconds')}s; open the trace JSON "
              f"in {out['logdir']} with Perfetto or chrome://tracing")


def cmd_adapters(args):
    """Multi-tenant LoRA adapter lifecycle against a live server, or a
    local artifact:

        bigdl-tpu-torch adapters list   http://127.0.0.1:8000
        bigdl-tpu-torch adapters load   http://127.0.0.1:8000 my-tenant [--path p] [--pin]
        bigdl-tpu-torch adapters unload http://127.0.0.1:8000 my-tenant
        bigdl-tpu-torch adapters inspect path/to/adapter.npz

    `inspect` verifies the artifact offline (full integrity mode) and
    prints its rank, scale, targets and size; the server actions drive
    the registry's endpoints."""
    if args.action == "inspect":
        from bigdl_tpu_torch.serving.adapters import load_adapter, lora_nbytes
        from bigdl_tpu_torch.utils.durability import IntegrityError

        try:
            lora, meta = load_adapter(args.target, verify="full")
        except FileNotFoundError:
            raise SystemExit(f"{args.target}: no such adapter artifact")
        except IntegrityError as e:
            raise SystemExit(f"FAILED {e}")
        print(json.dumps({
            "path": args.target, "rank": meta.get("rank"), "scale": meta.get("scale"),
            "targets": meta.get("targets"), "nbytes": lora_nbytes(lora), "verified": "full",
        }, indent=2))
        return
    import urllib.error
    import urllib.request

    base = args.target.rstrip("/")

    def call(path, payload=None):
        req = (base + path if payload is None else urllib.request.Request(
            base + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}))
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            body = e.read().decode(errors="replace")
            raise SystemExit(f"{base}{path} -> HTTP {e.code}: {body}")
        except urllib.error.URLError as e:
            raise SystemExit(f"cannot reach {base}{path}: {e.reason}")

    if args.action == "list":
        print(json.dumps(call("/adapters"), indent=2))
    elif args.action == "load":
        if not args.name:
            raise SystemExit("adapters load needs a NAME")
        payload = {"name": args.name, "pin": args.pin}
        if args.path:
            payload["path"] = args.path
        a = call("/adapters/load", payload)["adapter"]
        print(f"loaded {a['name']} (rank {a['rank']}, "
              f"{a['nbytes']}B{', pinned' if a['pinned'] else ''})")
    elif args.action == "unload":
        if not args.name:
            raise SystemExit("adapters unload needs a NAME")
        out = call("/adapters/unload", {"name": args.name})
        print(f"unloaded {out['adapter']['name']}")


def cmd_simserve(args):
    raise _not_ported("simserve (the simulated-clock serving benchmark)", 12)


def cmd_lint(args):
    raise _not_ported("lint (graftlint over the port)", 12)


def cmd_bench(args):
    model = _load(args.model, args.qtype, args.device)
    n_in, n_out = args.in_len, args.out_len
    ids = list(range(1, n_in + 1))
    # warm both lengths before any timing: the first calls build the
    # kernels and the allocator's pools
    model.generate([ids], max_new_tokens=1)
    model.generate([ids], max_new_tokens=n_out)
    t1 = time.time()
    model.generate([ids], max_new_tokens=1)
    first = time.time() - t1
    t0 = time.time()
    model.generate([ids], max_new_tokens=n_out)
    dt = max((time.time() - t0 - first) / max(n_out - 1, 1), 1e-5) * 1000
    print(json.dumps({
        "metric": "decode_latency", "value": round(dt, 2), "unit": "ms/token",
        "first_token_ms": round(first * 1000, 1), "protocol": f"in{n_in}-out{n_out}",
    }))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bigdl-tpu-torch")
    # -q works both before the subcommand and after it: the subparser copy
    # defaults to SUPPRESS so it never clobbers a top-level value
    p.add_argument("-q", "--qtype", default=None,
                   help="sym_int4 (HF default) / q4_k_m / ... ; low-bit dirs keep theirs")
    qp = argparse.ArgumentParser(add_help=False)
    qp.add_argument("-q", "--qtype", default=argparse.SUPPRESS, help=argparse.SUPPRESS)
    # the port's idiom: where a command loads a model, it loads it on the
    # card unless told otherwise
    dp = argparse.ArgumentParser(add_help=False)
    dp.add_argument("--device", default="cuda",
                    help="torch device of the model (default cuda: raises without a "
                         "card; cpu runs the kernels' plain versions)")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("convert", help="quantize + save_low_bit", parents=[qp, dp])
    c.add_argument("model")
    c.add_argument("-o", "--output", required=True)
    c.add_argument("-f", "--format", choices=("low_bit", "gguf"), default="low_bit",
                   help="low_bit: the reload format; gguf: not ported (item [10])")
    c.add_argument("--gguf-qtype", default="q8_0",
                   choices=("bf16", "f16", "f32", "q2_k", "q3_k", "q4_0", "q4_k", "q5_k",
                            "q6_k", "q8_0"),
                   help="gguf payload type")
    c.set_defaults(fn=cmd_convert)

    g = sub.add_parser("generate", help="one-shot generation", parents=[qp, dp])
    g.add_argument("model")
    g.add_argument("-p", "--prompt", required=True)
    g.add_argument("-n", "--max-new-tokens", type=int, default=64)
    g.add_argument("-t", "--temperature", type=float, default=0.0)
    g.set_defaults(fn=cmd_generate)

    s = sub.add_parser("serve", help="OpenAI-compatible server", parents=[qp, dp])
    s.add_argument("model")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--slots", type=int, default=8)
    s.add_argument("--max-len", type=int, default=2048)
    s.add_argument("--speculative", action="store_true",
                   help="in-engine speculative decoding (sym_int4 self-draft; needs an "
                        "unquantized model load)")
    s.add_argument("--draft-k", type=int, default=4)
    s.add_argument("--adaptive-draft", action="store_true",
                   help="steer draft length from recent acceptance")
    s.add_argument("--embedder", default=None,
                   help="bert checkpoint dir for POST /v1/embeddings: not ported (item [9])")
    s.add_argument("--truncate-prompts", action="store_true",
                   help="keep the tail of over-long prompts instead of rejecting them "
                        "with 400")
    s.add_argument("--logprobs-top-k", type=int, default=0,
                   help="serve OpenAI top_logprobs with up to N alternatives per token")
    s.add_argument("--paged", action="store_true", help="paged KV pool + radix prefix caching")
    s.add_argument("--prefill-chunk-tokens", type=int, default=None,
                   help="paged: interleave prompt prefill with decode in chunks of at most "
                        "N tokens, one a step (default: monolithic)")
    s.add_argument("--trace", action="store_true",
                   help="record request-lifecycle spans into a bounded ring buffer (dump: "
                        "`trace dump`, or GET /debug/trace)")
    s.add_argument("--trace-capacity", type=int, default=65536,
                   help="span ring-buffer bound (newest kept)")
    s.add_argument("--request-log", default=None,
                   help="append one derived-timings JSONL record per finished request")
    s.add_argument("--adapter-dir", default=None,
                   help="multi-tenant LoRA: directory of <name>.npz adapter artifacts; "
                        'requests may then carry "adapter": "<name>"')
    s.add_argument("--adapter-budget-mb", type=int, default=None,
                   help="host-RAM budget for resident adapters; LRU eviction above it "
                        "(enables the registry even without --adapter-dir)")
    s.add_argument("--adapters", action="append", default=None, metavar="NAME[=PATH]",
                   help="preload + pin an adapter at startup (repeatable; PATH defaults to "
                        "<adapter-dir>/NAME.npz)")
    s.add_argument("--comm-qtype", default="none", choices=("none", "int8", "fp8_e4m3"),
                   help="multi-chip: quantized TP collectives; only 'none' until item [8]")
    s.set_defaults(fn=cmd_serve)

    fw = sub.add_parser("fastchat-worker",
                        help="FastChat model-worker (register + heartbeat + "
                             "worker_generate_stream)", parents=[qp, dp])
    fw.add_argument("model")
    fw.add_argument("--controller-address", default=None,
                    help="FastChat controller URL, e.g. http://host:21001 (omit to run "
                         "unregistered)")
    fw.add_argument("--worker-address", default=None,
                    help="URL the controller should reach us at")
    fw.add_argument("--model-names", default=None, help="comma-separated names to register")
    fw.add_argument("--host", default="127.0.0.1")
    fw.add_argument("--port", type=int, default=21002)
    fw.add_argument("--slots", type=int, default=8)
    fw.add_argument("--max-len", type=int, default=2048)
    fw.add_argument("--paged", action="store_true")
    fw.set_defaults(fn=cmd_fastchat_worker)

    ft = sub.add_parser("fetch-iq-tables",
                        help="IQ-quant codebook grids: not ported (item [10])")
    ft.add_argument("--url", default=None, help="override the llama.cpp ggml-common.h URL")
    ft.set_defaults(fn=cmd_fetch_iq_tables)

    ti = sub.add_parser("txt2img", help="Stable Diffusion: not ported (item [9])",
                        parents=[qp, dp])
    ti.add_argument("model", help="local diffusers pipeline directory")
    ti.add_argument("-p", "--prompt", required=True)
    ti.add_argument("--negative", default=None)
    ti.add_argument("-o", "--output", default="out.png")
    ti.add_argument("--size", type=int, default=512)
    ti.add_argument("--steps", type=int, default=20)
    ti.add_argument("--guidance", type=float, default=7.5)
    ti.add_argument("--seed", type=int, default=0)
    ti.set_defaults(fn=cmd_txt2img)

    ch = sub.add_parser("chat", help="interactive chat REPL", parents=[qp, dp])
    ch.add_argument("model")
    ch.add_argument("-n", "--max-new-tokens", type=int, default=256)
    ch.add_argument("-t", "--temperature", type=float, default=0.7)
    ch.add_argument("--system", default=None, help="system prompt")
    ch.add_argument("--max-len", type=int, default=2048, help="session KV cache length")
    ch.add_argument("--streaming-window", type=int, default=None,
                    help="attention-sink window: unbounded conversation in constant memory")
    ch.add_argument("--streaming-sink", type=int, default=4)
    ch.add_argument("--adapter", default=None,
                    help="LoRA adapter artifact (.npz) merged into the model for this "
                         "chat session")
    ch.set_defaults(fn=cmd_chat)

    v = sub.add_parser("verify", help="full integrity + numerical validation of a low-bit "
                                      "checkpoint; exit 1 on any finding")
    v.add_argument("path", help="save_low_bit dir (train checkpoints: item [6])")
    v.set_defaults(fn=cmd_verify)

    ts = sub.add_parser("train-status", help="training-run health: not ported (item [6])")
    ts.add_argument("ckpt_dir", help="the trainer's --ckpt-dir")
    ts.add_argument("--events", type=int, default=15, help="event-log tail length")
    ts.set_defaults(fn=cmd_train_status)

    tr = sub.add_parser("trace", help="serving observability: dump a live server's span "
                                      "ring buffer, summarize a trace file, or start/stop "
                                      "a torch.profiler window")
    tr.add_argument("action", choices=("dump", "summarize", "profile-start", "profile-stop"))
    tr.add_argument("target", help="server base URL (dump/profile-*) or a dumped trace "
                                   ".json file (summarize)")
    tr.add_argument("-o", "--output", default="trace.json", help="dump: output file")
    tr.add_argument("--logdir", default=None,
                    help="profile-start: trace output directory on the server's filesystem")
    tr.set_defaults(fn=cmd_trace)

    ad = sub.add_parser("adapters", help="multi-tenant LoRA lifecycle: list/load/unload "
                                         "against a live server, or inspect a local "
                                         "adapter artifact")
    ad.add_argument("action", choices=("list", "load", "unload", "inspect"))
    ad.add_argument("target", help="server base URL (list/load/unload) or an adapter .npz "
                                   "path (inspect)")
    ad.add_argument("name", nargs="?", default=None, help="adapter name (load/unload)")
    ad.add_argument("--path", default=None,
                    help="load: explicit artifact path (default: <adapter-dir>/<name>.npz "
                         "on the server)")
    ad.add_argument("--pin", action="store_true", help="load: exempt from LRU eviction")
    ad.set_defaults(fn=cmd_adapters)

    sv = sub.add_parser("simserve", help="simulated-clock serving benchmark: not ported "
                                         "(item [12])")
    sv.add_argument("--trace", default="poisson",
                    choices=("poisson", "bursty", "prefix-heavy", "overload", "adapter-zipf",
                             "speculative", "adapter-spec"))
    sv.add_argument("--speculative", action="store_true")
    sv.add_argument("--draft-k", type=int, default=None)
    sv.add_argument("--trace-file", default=None)
    sv.add_argument("--seed", type=int, default=0)
    sv.add_argument("--hbm-gbps", type=float, default=None)
    sv.add_argument("--ici-gbps", type=float, default=None)
    sv.add_argument("--tp", type=int, default=None)
    sv.add_argument("--comm-qtype", default=None, choices=("none", "int8", "fp8_e4m3"))
    sv.add_argument("--save-trace", default=None)
    sv.add_argument("-o", "--output", default=None)
    sv.set_defaults(fn=cmd_simserve)

    ln = sub.add_parser("lint", help="graftlint: not ported (item [12])")
    ln.add_argument("paths", nargs="*")
    ln.add_argument("--baseline", default=None)
    ln.add_argument("--rules", default=None)
    ln.add_argument("--write-baseline", action="store_true")
    ln.add_argument("--update-baseline", action="store_true")
    ln.add_argument("--format", choices=("human", "json", "github"), default="human")
    ln.add_argument("--list-rules", action="store_true")
    ln.set_defaults(fn=cmd_lint)

    b = sub.add_parser("bench", help="quick decode-latency check", parents=[qp, dp])
    b.add_argument("model")

    def _min2(v):
        iv = int(v)
        if iv < 2:  # one timed token cannot separate decode from first-token
            raise argparse.ArgumentTypeError("--out-len must be >= 2")
        return iv

    b.add_argument("--in-len", type=int, default=32)
    b.add_argument("--out-len", type=_min2, default=32)
    b.set_defaults(fn=cmd_bench)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
