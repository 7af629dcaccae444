"""The command line of bigdl_tpu_torch (cli.py) against the JAX package's
(bigdl_tpu/cli.py), run in process through `main(argv)` as
tests/test_cli.py runs JAX's: the two argparse trees (every subcommand's
options and defaults; the port adds `--device` where a model loads),
`trace summarize` and `adapters inspect` printing the same, `convert -f
low_bit` then `verify` across both packages' artifacts, `generate`'s
tokens by the margin rule, the refusals naming their ROADMAP items, and
one `serve --device cpu --port 0` subprocess draining on SIGTERM."""

import argparse
import json
import os
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import jax
import pytest
import torch

from bigdl_tpu import cli as jcli
from bigdl_tpu.api import TpuModel
from bigdl_tpu.api import optimize_model as jax_optimize_model
from bigdl_tpu.models import llama as jllama
from bigdl_tpu.models.config import PRESETS as JAX_PRESETS
from bigdl_tpu.serving.adapters import save_adapter as jax_save_adapter
from bigdl_tpu.serving.engine import InferenceEngine as JaxEngine
from bigdl_tpu.train import init_lora as jax_init_lora
from bigdl_tpu_torch import cli
from bigdl_tpu_torch.obs.tracing import TraceRecorder
from test_torch_api_server import margin_rule
from test_torch_serving_control import _TOL_ULPS

ROOT = Path(__file__).resolve().parents[1]
CFG = JAX_PRESETS["tiny-llama"]
# the subcommands that load a model take the port's --device
LOADS_A_MODEL = {"convert", "generate", "serve", "fastchat-worker", "txt2img", "chat", "bench"}


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """JAX's tiny-llama sym_int4 artifact (tests/test_cli.py's) and the
    model it holds."""
    d = tmp_path_factory.mktemp("tiny") / "model"
    model = TpuModel(CFG, jax_optimize_model(jllama.init_params(CFG, jax.random.PRNGKey(0)), CFG),
                     "sym_int4")
    model.save_low_bit(str(d))
    return str(d), model


class _Parsed(Exception):
    pass


def jax_parser() -> argparse.ArgumentParser:
    """The parser JAX's main() builds (it builds and parses in one go)."""
    orig = argparse.ArgumentParser.parse_args

    def capture(self, *a, **k):
        raise _Parsed(self)

    argparse.ArgumentParser.parse_args = capture
    try:
        jcli.main([])
    except _Parsed as e:
        return e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = orig
    raise AssertionError("JAX's main() built no parser")


def subparsers(p) -> dict:
    sp = next(a for a in p._actions if isinstance(a, argparse._SubParsersAction))
    return dict(sp.choices)


def options(p, drop=()) -> list:
    """Each argument: flags, dest, default, choices, nargs, required, type."""
    out = []
    for a in p._actions:
        if isinstance(a, (argparse._HelpAction, argparse._SubParsersAction)) or a.dest in drop:
            continue
        out.append((tuple(a.option_strings), a.dest, repr(a.default),
                    tuple(a.choices) if a.choices else None, a.nargs, a.required,
                    getattr(a.type, "__name__", None), type(a).__name__))
    return sorted(out)


JAX_SUBCOMMANDS = ("convert", "generate", "serve", "fastchat-worker", "fetch-iq-tables", "txt2img",
                   "chat", "verify", "train-status", "trace", "adapters", "simserve", "lint",
                   "bench")


def test_top_level_parser_matches_jax():
    jp, tp = jax_parser(), cli.build_parser()
    assert options(tp) == options(jp)
    assert list(subparsers(tp)) == list(subparsers(jp)) == list(JAX_SUBCOMMANDS)


@pytest.mark.parametrize("name", JAX_SUBCOMMANDS)
def test_subcommand_options_and_defaults_match_jax(name):
    """The same options, defaults, choices and types as JAX's subparser;
    the port adds --device (default cuda) where a model loads."""
    jsub, tsub = subparsers(jax_parser())[name], subparsers(cli.build_parser())[name]
    assert options(tsub, drop=("device",)) == options(jsub)
    dev = [a for a in tsub._actions if a.dest == "device"]
    if name in LOADS_A_MODEL:
        assert len(dev) == 1 and dev[0].default == "cuda" and dev[0].option_strings == ["--device"]
    else:
        assert dev == []


def test_trace_summarize_prints_as_jax(tmp_path, capsys):
    rec = TraceRecorder(clock=lambda: 0.0)
    for rid, (q, p, d) in enumerate(((0.01, 0.2, 1.5), (0.05, 0.3, 2.0)), start=1):
        rec.instant("submit", ts=10.0, tid=rid, cat="request", rid=rid, prompt_tokens=8)
        rec.complete("queued", 10.0, q, tid=rid, cat="request", rid=rid)
        rec.complete("prefill", 10.0 + q, p, tid=rid, cat="request", rid=rid, tokens=8)
        rec.complete("decode", 10.0 + q + p, d, tid=rid, cat="request", rid=rid, tokens=16)
        rec.instant("finish", ts=10.0 + q + p + d, tid=rid, cat="request", rid=rid,
                    reason="length", tokens=16)
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(rec.export()))
    jcli.main(["trace", "summarize", str(path)])
    want = capsys.readouterr().out
    cli.main(["trace", "summarize", str(path)])
    got = capsys.readouterr().out
    assert got == want and "decode" in got


def test_adapters_inspect_prints_as_jax(tmp_path, capsys):
    lora = jax_init_lora(CFG, jax.random.PRNGKey(1), rank=4, alpha=8.0, targets=("wq", "wo"))
    path = str(tmp_path / "ten.npz")
    jax_save_adapter(path, lora)
    jcli.main(["adapters", "inspect", path])
    want = json.loads(capsys.readouterr().out)
    cli.main(["adapters", "inspect", path])
    assert json.loads(capsys.readouterr().out) == want
    assert want["rank"] == 4 and want["verified"] == "full"
    raw = bytearray(Path(path).read_bytes())
    raw[len(raw) // 3] ^= 0xFF  # a payload byte
    Path(path).write_bytes(bytes(raw))
    for main in (jcli.main, cli.main):
        with pytest.raises(SystemExit, match="FAILED"):
            main(["adapters", "inspect", path])
    for main in (jcli.main, cli.main):
        with pytest.raises(SystemExit, match="no such adapter"):
            main(["adapters", "inspect", str(tmp_path / "none.npz")])


def test_convert_low_bit_then_verify_across_packages(saved, tmp_path, capsys):
    """The port converts JAX's artifact (-f low_bit), each package's
    `verify` passes the other's, and the port's artifact reloads in JAX
    with its tokens."""
    d, jm = saved
    out = str(tmp_path / "port")
    cli.main(["convert", d, "-o", out, "-q", "sym_int4", "--device", "cpu"])
    assert "saved sym_int4 model" in capsys.readouterr().out
    for main, path in ((cli.main, out), (jcli.main, out), (cli.main, d)):
        main(["verify", path])
        assert capsys.readouterr().out.rstrip().endswith("OK")
    from bigdl_tpu.api import AutoModelForCausalLM as JaxAuto

    again = JaxAuto.load_low_bit(out)
    prompt = [[3, 1, 4, 1, 5]]
    assert (again.generate(prompt, max_new_tokens=6) == jm.generate(prompt, max_new_tokens=6)).all()
    # a damaged tensor: exit 1 from both
    victim = Path(out) / "weights.npz"
    raw = bytearray(victim.read_bytes())
    raw[len(raw) // 2] ^= 0xFF  # inside a tensor's payload
    victim.write_bytes(bytes(raw))
    for main in (jcli.main, cli.main):
        with pytest.raises(SystemExit) as e:
            main(["verify", out])
        assert e.value.code == 1


def test_generate_chat_and_bench_as_jax(saved, capsys, monkeypatch):
    d, jm = saved
    jcli.main(["generate", d, "-p", "3 1 4 1 5", "-n", "8"])
    want = json.loads(capsys.readouterr().out.strip())
    cli.main(["generate", d, "-p", "3 1 4 1 5", "-n", "8", "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip())
    eng = JaxEngine(jm, n_slots=1, max_len=64, logprobs_top_k=2)
    ref = eng.submit([3, 1, 4, 1, 5], 8)
    eng.run_until_idle()
    assert ref.out_tokens == want
    from bigdl_tpu_torch import AutoModelForCausalLM
    from bigdl_tpu_torch.models import llama

    tm = AutoModelForCausalLM.load_low_bit(d, device="cpu")
    with torch.inference_mode():  # the logit scale the margin rule's bound follows
        logits, _ = llama.forward(tm.config, tm.params, torch.arange(1, 17)[None], None)
    tol = _TOL_ULPS * float(logits.abs().max())
    margin_rule(want, got, ref.out_top_logprobs, tol)
    lines = iter(["3 1 4 1 5", "/exit"])
    monkeypatch.setattr("builtins.input", lambda *a: next(lines))
    cli.main(["chat", d, "-n", "6", "-t", "0", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("bot> [") and len(json.loads(out[len("bot> "):].strip())) == 6
    cli.main(["bench", d, "--in-len", "16", "--out-len", "8", "--device", "cpu"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["metric"] == "decode_latency" and res["value"] > 0
    assert res["protocol"] == "in16-out8" and "first_token_ms" in res


@pytest.mark.parametrize("argv,item", [
    (["convert", "{d}", "-o", "{tmp}/x.gguf", "-f", "gguf"], 10),
    (["generate", "{tmp}/m.gguf", "-p", "1 2", "--device", "cpu"], 10),
    (["fetch-iq-tables"], 10),
    (["txt2img", "{tmp}", "-p", "a cat"], 9),
    (["serve", "{d}", "--embedder", "{tmp}", "--device", "cpu"], 9),
    (["serve", "{d}", "--comm-qtype", "int8", "--device", "cpu"], 8),
    (["train-status", "{tmp}"], 6),
    (["verify", "{tmp}"], 6),
    (["verify", "{tmp}/ckpt-00000004.npz"], 6),
    (["simserve", "--trace", "overload"], 12),
    (["lint"], 12),
])
def test_refusals_name_their_item(saved, tmp_path, argv, item):
    argv = [a.format(d=saved[0], tmp=tmp_path) for a in argv]
    with pytest.raises(NotImplementedError, match=rf"item \[{item}\]"):
        cli.main(argv)


def test_device_defaults_to_the_card(saved):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: --device cuda resolves to it")
    for argv in (["generate", saved[0], "-p", "1 2"], ["serve", saved[0]]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(argv)
    with pytest.raises(SystemExit, match="unquantized target"):
        cli.main(["serve", saved[0], "--speculative", "-q", "sym_int4", "--device", "cpu"])


def test_serve_subprocess_drains_on_sigterm(saved):
    """`python -m bigdl_tpu_torch.cli serve <dir> --paged --device cpu
    --port 0`: prints its port, answers /generate with in-vocabulary
    tokens, and exits 0 on SIGTERM."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "bigdl_tpu_torch.cli", "serve", saved[0], "--paged",
         "--device", "cpu", "--port", "0", "--max-len", "256"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "serving" in line, (line, proc.stderr.read()[-2000:] if proc.poll() else "")
        port = int(line.rsplit(":", 1)[1])
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate",
            data=json.dumps({"prompt": [3, 1, 4, 1, 5], "max_new_tokens": 5}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            toks = json.loads(r.read())["tokens"]
        assert len(toks) == 5 and all(0 <= t < CFG.vocab_size for t in toks)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
