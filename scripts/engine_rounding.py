#!/usr/bin/env python3
"""chip_smoke phase 11's 2-layer adapter engine check, taken apart on one
CUDA card; and the QLoRA training step's time.

    python3 scripts/engine_rounding.py [--root DIR ...]
    python3 scripts/engine_rounding.py --qlora --root PARENT --root CHANGE

Each --root (default: the checkout this script lies in) runs in its own
process, importing that checkout's `bigdl_tpu_torch` and building only the
libraries the path needs (qmatmul for sym_int4, paged and flash
attention; with --qlora qbackward and the flash backward).

The engine mode builds phase 11's 2-layer llama3-8b-wide sym_int4 model
and its four adapters from the same seeds, serves the first 8 requests
of phase 7's traffic under both of its adapter assignments through the
kernels and through every kernel's plain version, and prints the check's
reading (the largest chosen-token logprob difference up to the first
differing token, the 0.05 nat bound), where it falls (request, position)
and the two runs' logprobs there. A second run through the kernels must
give the same logprobs (the engine is deterministic). Then one more run
through the kernels in which every dequant matmul, LoRA matmul and paged
attention call is also computed by its plain version and exactly (f64
sums, one rounding) on the same inputs, counting the bf16 outputs where
kernel, plain version and exact value differ, by form (GEMV, GEMM, LoRA
GEMV, LoRA GEMM), and for the LoRA forms the elements of their first
pass's xg = bf16(f32(x . A_cat^T) * gate) — one element of xg rounded
the other way moves a whole row of y.

The --qlora mode times the llama3-8b QLoRA step of chip_smoke phase 5
(32 layers, sym_int4, rank-8 LoRA, B=1 T=1024) by wall clock after a
warm step, and the host time a call of the flash training wrappers takes
at a small shape (B=1 T=16, the kernel shorter than the call). With two
roots it runs first, second, second, first and prints them side by side.
The last line of a run is one JSON object of its readings.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

HERE = Path(__file__).resolve().parents[1]


def helpers():
    """This checkout's chip_smoke, for its traffic, adapters and check."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def build(stems) -> None:
    """Build only (stem, qtype) libraries of the imported checkout."""
    from concurrent.futures import ThreadPoolExecutor

    from bigdl_tpu_torch.ops.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [(s, q, _build._library_path(s, q)) for s, q in stems]
    with ThreadPoolExecutor(max_workers=len(todo)) as pool:
        failed = [f for f in pool.map(lambda t: None if t[2].exists() else _build._compile(*t), todo) if f]
    if failed:
        raise RuntimeError("\n".join(failed))
    for s, q, lib in todo:
        _build._libs[(s, q)] = ctypes.CDLL(str(lib))


class Tally:
    """bf16 outputs compared three ways, summed over calls."""

    def __init__(self):
        self.calls = self.n = self.k_p = self.k_e = self.p_e = 0

    def add(self, k, p, e=None) -> None:
        self.calls += 1
        self.n += k.numel()
        self.k_p += int((k != p).sum())
        if e is not None:
            self.k_e += int((k != e).sum())
            self.p_e += int((p != e).sum())

    def text(self) -> str:
        return (f"{self.calls} calls, {self.n} outputs: kernel vs plain {self.k_p}, kernel vs exact "
                f"{self.k_e}, plain vs exact {self.p_e}")


def engine_mode(torch, root: Path) -> dict:
    cs = helpers()
    from bigdl_tpu_torch import PRESETS, TorchModel, optimize_model
    from bigdl_tpu_torch.models import llama
    from bigdl_tpu_torch.ops import kernels
    from bigdl_tpu_torch.serving import InferenceEngine
    from bigdl_tpu_torch.serving.adapters import AdapterRegistry

    qmm = importlib.import_module("bigdl_tpu_torch.ops.kernels.qmatmul")  # the module, not the function
    build([("qmatmul", "sym_int4"), ("paged_attention", None), ("flash_attention", None)])
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg2 = dataclasses.replace(PRESETS["llama3-8b"], num_hidden_layers=2)
    tm2 = TorchModel(cfg2, optimize_model(llama.init_params(cfg2, seed=5), cfg2, "sym_int4"), "sym_int4")
    where = root / "build" / "adapters" / "two_layers"
    cs.make_adapters(torch, dev, cfg2, where)
    shared, _ = cs.serving_traffic(cfg2.vocab_size)
    plain = {"qmatmul": kernels.qmatmul_plain, "qmatmul_lora": kernels.qmatmul_lora_plain,
             "flash_attention": kernels.flash_attention_plain,
             "paged_attention": kernels.paged_attention_plain}

    def run2(assignment):
        e2 = InferenceEngine(tm2, n_slots=cs.SLOTS, max_len=cs.MAX_LEN, page_size=cs.PAGE,
                             adapters=AdapterRegistry(dir=str(where)), paged=True)
        rs = [e2.submit(**dict(sp, adapter=a)) for sp, a in zip(shared, assignment)]
        e2.run_until_idle()
        return [r.out_logprobs for r in rs], [r.out_tokens for r in rs]

    def where_worst(lp_a, lp_b, tok_a, tok_b):
        best = (0.0, -1, -1)
        for i, (a, b, ta, tb) in enumerate(zip(lp_a, lp_b, tok_a, tok_b)):
            n = next((j for j, (x, y) in enumerate(zip(ta, tb)) if x != y), len(ta)) + 1
            for j, (x, y) in enumerate(zip(a[:n], b[:n])):
                best = max(best, (abs(x - y), i, j))
        return best

    out = {"cases": {}}
    for case, assignment in (("phase 11's", cs.ADAPTER_OF), ("round-robin", cs.ADAPTER_OF_ROUND_ROBIN)):
        lk, tk = run2(assignment)
        lk2, tk2 = run2(assignment)
        with mock.patch.multiple(kernels, **plain):
            lp, tp = run2(assignment)
        worst, i, j = where_worst(lk, lp, tk, tp)
        lo, hi = max(0, j - 3), j + 4
        print(f"{root.name} {case}: kernels vs plain {worst:.5f} nat at request {i} position {j} "
              f"(tol 0.05); kernels rerun identical: {lk == lk2 and tk == tk2}", flush=True)
        print(f"  request {i} positions {lo}..{hi - 1}: kernels {[round(v, 5) for v in lk[i][lo:hi]]} "
              f"tokens {tk[i][lo:hi]}; plain {[round(v, 5) for v in lp[i][lo:hi]]} tokens {tp[i][lo:hi]}",
              flush=True)
        out["cases"][case] = {"worst": worst, "request": i, "position": j,
                              "rerun_identical": lk == lk2 and tk == tk2,
                              "kernels": lk[i][:hi], "plain": lp[i][:hi]}

    # every matmul and paged call three ways on the engine's own inputs
    dq = {}

    def wd(w):
        key = w.data.data_ptr()
        if key not in dq:
            dq[key] = w.dequantize(torch.bfloat16).double()
        return dq[key]

    tallies = {k: Tally() for k in ("gemv", "gemm", "lora_gemv", "lora_gemm", "xg_gemv", "xg_gemm", "paged")}
    real_q, real_l, real_p = kernels.qmatmul, kernels.qmatmul_lora, kernels.paged_attention
    seen = {}

    class Capture:
        """A LoRA kernel whose xg scratch is kept after the launch: the
        last bf16 argument of shape [M, R]."""

        def __init__(self, k):
            self.k = k

        def __getattr__(self, name):
            return getattr(self.k, name)

        def __call__(self, *args, **kw):
            self.k(*args, **kw)
            shape = seen["MR"]
            seen["xg"] = [t for t in args if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16
                          and tuple(t.shape) == shape][-1].clone()

    def bf(t):
        return t.float().to(torch.bfloat16)

    def q3(x, w):
        y = real_q(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        e = bf(x2.double() @ wd(w).t()).reshape(y.shape)
        tallies["gemv" if x2.shape[0] <= 32 else "gemm"].add(y, kernels.qmatmul_plain(x, w), e)
        return y

    def l3(x, w, a, b, gate):
        x2 = x.reshape(-1, x.shape[-1])
        seen["MR"] = (x2.shape[0], a.shape[0])
        y = real_l(x, w, a, b, gate)
        p = kernels.qmatmul_lora_plain(x, w, a, b, gate)
        form = "gemv" if x2.shape[0] <= 32 else "gemm"
        xg_k = seen.pop("xg")
        xa = (x2.double() @ a.double().t()).float()
        xg_e = (xa * gate.float()).to(torch.bfloat16)
        xg_p = ((x2.float() @ a.float().t()) * gate.float()).to(torch.bfloat16)
        tallies["xg_" + form].add(xg_k, xg_p, xg_e)
        # y exact given the kernel's own xg: the matmul's rounding alone
        e = bf(x2.double() @ wd(w).t() + xg_k.double() @ b.double().t()).reshape(y.shape)
        tallies["lora_" + form].add(y, p, e)
        return y

    def p3(q, *args, **kw):
        o = real_p(q, *args, **kw)
        pl = kernels.paged_attention_plain(q, *args, **kw)
        tallies["paged"].add(o, pl)
        return o

    assignment = cs.ADAPTER_OF_ROUND_ROBIN
    with mock.patch.multiple(qmm, LORA_GEMV=Capture(qmm.LORA_GEMV), LORA_GEMM=Capture(qmm.LORA_GEMM)), \
            mock.patch.multiple(kernels, qmatmul=q3, qmatmul_lora=l3, paged_attention=p3):
        lt, tt = run2(assignment)
    lk, tk = run2(assignment)
    print(f"{root.name} round-robin with the three-way count: the same logprobs as without "
          f"{lt == lk and tt == tk}", flush=True)
    for name, t in tallies.items():
        print(f"  {name}: {t.text()}", flush=True)
    out["tallies"] = {k: vars(t) for k, t in tallies.items()}
    return out


def qlora_mode(torch, root: Path) -> dict:
    import numpy as np

    from bigdl_tpu_torch import PRESETS, optimize_model
    from bigdl_tpu_torch.models import llama
    from bigdl_tpu_torch.ops import kernels
    from bigdl_tpu_torch.train import adamw, init_lora, make_train_step

    build([("qmatmul", "sym_int4"), ("qbackward", "sym_int4"), ("flash_backward", None)])
    dev = torch.device("cuda")
    cfg = PRESETS["llama3-8b"]
    T = 1024
    tokens = torch.as_tensor(np.random.default_rng(0).integers(1, cfg.vocab_size, (1, T + 1)),
                             dtype=torch.long, device=dev)
    mask = torch.ones((1, T + 1), dtype=torch.float32, device=dev)
    model = optimize_model(llama.init_params(cfg, seed=0, device=dev), cfg, "sym_int4")
    lora = init_lora(cfg, seed=1, rank=8, device=dev)
    step = make_train_step(cfg, llama.forward, adamw(lora, 1e-4))

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(model, lora, tokens, mask)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, loss.item()

    timed()
    runs = [timed() for _ in range(8)]
    ms = [r[0] for r in runs]
    # host time of a wrapper call at a shape whose kernel is shorter
    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*s):
        return torch.randn(s, device=dev, generator=g).to(torch.bfloat16)

    q, k, v, do = rnd(1, 16, Hq, D), rnd(1, 16, Hkv, D), rnd(1, 16, Hkv, D), rnd(1, 16, Hq, D)
    start = torch.zeros(1, dtype=torch.int32, device=dev)
    o, lse = kernels.flash_train_fwd(q, k, v, start)
    delta = (do.float() * o.float()).sum(-1)
    host = {}
    calls = {"flash_train_fwd": lambda: kernels.flash_train_fwd(q, k, v, start),
             "flash_train_dq": lambda: kernels.flash_train_dq(q, k, v, start, do, lse, delta),
             "flash_train_dkv": lambda: kernels.flash_train_dkv(q, k, v, start, do, lse, delta)}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        host[name] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    print(f"{root.name} QLoRA step ms {[round(x, 3) for x in ms]} median {statistics.median(ms):.3f}; "
          "host us a call " + ", ".join(f"{k} {v:.2f}" for k, v in host.items()), flush=True)
    return {"step_ms": ms, "median_ms": statistics.median(ms), "host_us": host}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", action="append", default=[])
    ap.add_argument("--qlora", action="store_true")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    roots = args.root or [str(HERE)]
    if not args.one:
        order = [roots[0], roots[1], roots[1], roots[0]] if args.qlora and len(roots) == 2 else roots
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip()
        print(f"card {smi}", flush=True)
        res = []
        for r in order:
            proc = subprocess.run([sys.executable, __file__, "--one", "--root", r]
                                  + (["--qlora"] if args.qlora else []), capture_output=True, text=True)
            sys.stdout.write(proc.stdout)
            sys.stderr.write(proc.stderr[-4000:])
            if proc.returncode != 0:
                print(f"engine_rounding: the run on {r} failed (exit {proc.returncode})", flush=True)
                return proc.returncode
            res.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        if args.qlora:
            print("QLoRA step median ms " + " ".join(f"{Path(r).name}={x['median_ms']:.3f}"
                                                     for r, x in zip(order, res)))
        print(json.dumps({"roots": order, "runs": res}))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("engine_rounding: no CUDA device", file=sys.stderr)
        return 1
    root = Path(roots[0]).resolve()
    sys.path.insert(0, str(root))
    out = qlora_mode(torch, root) if args.qlora else engine_mode(torch, root)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
