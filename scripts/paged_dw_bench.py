#!/usr/bin/env python3
"""The dW kernel and the paged decode kernel alone on one CUDA card:
build, check, time.

    python3 scripts/paged_dw_bench.py [--root DIR] [--iters N]
    python3 scripts/paged_dw_bench.py --root PARENT --root CHANGE

Builds only `csrc/dw_matmul.cu` and `csrc/paged_attention.cu` of the
checkout at DIR (default: the one this script lies in) and prints the
ptxas report of their kernels (registers, spill bytes, HMMA/HGMMA count; a
spill fails the run). Holds dW = g^T x against its plain version (2 bf16
ULPs of the largest output, 2^-16 with an f32 output) at M = 1, 63, 65,
1000 over aligned and unaligned O and K and a misaligned base (printing
which variant each case ran), and at every llama3-8b weight of the full
fine-tune at M = 1024; holds the paged kernel over bf16 and fp8 pages
against its plain version (2^-7 |ref| + 1e-5 an element) at the serving
engine's decode shape, at chunk edges inside and at page boundaries,
with windows that skip chunks, a one-slot row and a row with no valid
slot (exactly 0). Every case launches twice and must give the same bits.
The cases are chip_smoke's phase-2 ones (`DW_EDGE_CASES`,
`PAGED_CHECK_CASES`). Then times with CUDA events, operands cycled past
the 50 MB L2: dW at each path shape (M = 1024) beside cuBLAS g^T x,
summed over a full fine-tune step; the paged kernel per layer at the
engine's steady decode shape (8 rows of ~1,160 live slots, pages of 64),
over a 32-layer step, beside SDPA over views gathered beforehand
(yardsticks the port never calls) and each one's bound. Each kernel's
profiled device time per call is printed beside its events time: where
the two differ, the events time waited on the host, so the host's time a
call of each wrapper (and of cuBLAS and SDPA) is timed too, at a shape
the card finishes first. The last line is one JSON object.

With --root given twice the script runs itself on each checkout in turns
(first, second, second, first), each in its own process, and prints the
times side by side: a parent against a change on one card.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

LAYERS, M_PATH = 32, 1024
HQ, HKV, D = 32, 8, 128  # llama3-8b's heads
STEADY = [1100 + 13 * i + 14 for i in range(8)]  # chip_smoke phase 8's rows after 14 steps


def compare(roots, argv_rest) -> int:
    """Each root in turns (a, b, b, a) in its own process; the JSON lines
    side by side."""
    runs = []
    for root in (roots[0], roots[1], roots[1], roots[0]):
        proc = subprocess.run([sys.executable, __file__, "--root", root, *argv_rest],
                              capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f"paged_dw_bench: the run on {root} failed (exit {proc.returncode})", flush=True)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(f"side by side (ms; runs on {roots[0]}, {roots[1]}, {roots[1]}, {roots[0]}):")
    for key in runs[0]["times"]:
        vals = [r["times"].get(key) for r in runs]
        print(f"  {key:48s} " + " ".join("-" if v is None else f"{v:10.5f}" for v in vals))
    print(json.dumps({"roots": [roots[0], roots[1], roots[1], roots[0]],
                      "times": {k: [r["times"].get(k) for r in runs] for k in runs[0]["times"]}}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", action="append", default=[])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if len(args.root) == 2:
        return compare(args.root, ["--iters", str(args.iters)])
    if len(args.root) > 2:
        ap.error("--root at most twice")
    import torch

    if not torch.cuda.is_available():
        print("paged_dw_bench: no CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root[0] if args.root else Path(__file__).resolve().parents[1]).resolve()
    sys.path.insert(0, str(root))
    import ctypes
    import importlib
    import importlib.util
    from concurrent.futures import ThreadPoolExecutor

    from bigdl_tpu_torch.ops import kernels
    from bigdl_tpu_torch.ops.kernels import _build

    # this checkout's chip_smoke (its timing and report helpers), also when
    # --root names another checkout
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [(stem, None, _build._library_path(stem, None)) for stem in ("dw_matmul", "paged_attention")]
    with ThreadPoolExecutor(max_workers=len(todo)) as pool:
        failed = [f for f in pool.map(lambda t: None if t[2].exists() else _build._compile(*t), todo) if f]
    if failed:
        print("\n".join(failed), file=sys.stderr)
        return 1
    spills = 0
    for stem, _, lib in todo:
        _build._libs[(stem, None)] = ctypes.CDLL(str(lib))
        print(f"{stem}:", flush=True)
        spills += cs.tc_kernel_report(lib, ("dw_tma_kernel", "dw_kernel", "paged_split_kernel", "paged_kernel"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"root {root}; card {smi}; spill bytes {spills}", flush=True)

    dw_mod = importlib.import_module("bigdl_tpu_torch.ops.kernels.dw_matmul")
    pa_mod = importlib.import_module("bigdl_tpu_torch.ops.kernels.paged_attention")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    failures = []

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)

    def variant(O, K, gr, x):
        if hasattr(dw_mod, "dw_variant"):
            return dw_mod.dw_variant(O, K, gr.data_ptr(), x.data_ptr())
        return "mma.sync (no variant rule)"

    # ------------------------------------------------------------ dW checks
    def dw_case(label, gr, x, out_dtype):
        got = kernels.dw_matmul(gr, x, out_dtype)
        again = kernels.dw_matmul(gr, x, out_dtype)
        ref = kernels.dw_matmul_plain(gr, x, out_dtype).float()
        err = (got.float() - ref).abs().max().item()
        tol = (2 ** -7 if out_dtype == torch.bfloat16 else 2 ** -16) * ref.abs().max().item()
        same = torch.equal(got, again)
        ok = bool(torch.isfinite(got).all()) and err <= tol and same
        if not ok:
            failures.append(label)
        return f"{label} {err:.4g}/{tol:.4g} relaunch bit-equal {same}{'' if ok else ' FAILED'}"

    lines = []
    for M, O, K, skew in cs.DW_EDGE_CASES:
        if skew:  # g's base 2 bytes past a 16-byte boundary
            gr = torch.empty(M * O + 1, dtype=torch.bfloat16, device=dev)[1:].view(M, O)
            gr.copy_(randn(M, O))
        else:
            gr = randn(M, O)
        x = randn(M, K)
        for out_dtype in (torch.bfloat16, torch.float32):
            lines.append(dw_case(f"dW M={M} O={O} K={K} skew={skew} {str(out_dtype)[6:]} "
                                 f"[{variant(O, K, gr, x)}]", gr, x, out_dtype))
    print("check " + "\n      ".join(lines), flush=True)
    shapes = cs.dw_shapes(type("C", (), dict(hidden_size=4096, intermediate_size=14336, num_hidden_layers=LAYERS,
                                             q_dim=4096, kv_dim=1024, vocab_size=128256)))
    lines = []
    for O, K in shapes:
        gr, x = randn(M_PATH, O), randn(M_PATH, K)
        lines.append(dw_case(f"dW M={M_PATH} O={O} K={K} bf16 [{variant(O, K, gr, x)}]", gr, x, torch.bfloat16))
        del gr, x
    print("check " + "\n      ".join(lines), flush=True)

    # --------------------------------------------------------- paged checks
    lines = []
    for fp8 in (False, True):
        for label, page, mp, pos, start, window, cap in cs.PAGED_CHECK_CASES:
            B = len(pos)
            k, v, ks, vs, bt, p_t, _, _ = cs.paged_operands(torch, dev, g, 2, HKV, D, pos, fp8, page, mp)
            q = randn(B, HQ, D)
            s_t = torch.tensor(start, dtype=torch.int32, device=dev)
            y = kernels.paged_attention(q, k, v, bt, 1, p_t, s_t, ks, vs, softcap=cap, window=window)
            y2 = kernels.paged_attention(q, k, v, bt, 1, p_t, s_t, ks, vs, softcap=cap, window=window)
            ref = kernels.paged_attention_plain(q, k, v, bt, 1, p_t, s_t, ks, vs, softcap=cap,
                                                window=window).float()
            yf = (y.float() - ref).abs()
            within = bool((yf <= 2 ** -7 * ref.abs() + 1e-5).all()) and bool(torch.isfinite(y).all())
            none = [b for b in range(B) if start[b] > min(pos[b], mp * page - 1)]
            zero = all(bool((y[b] == 0).all()) for b in none)
            same = torch.equal(y, y2)
            chunk = (pa_mod.split_chunk(B, HKV, mp * page) if hasattr(pa_mod, "split_chunk") else None)
            ok = within and zero and same
            if not ok:
                failures.append(f"paged {label} fp8={fp8}")
            lines.append(f"paged {'fp8' if fp8 else 'bf16'} {label}: B={B} page={page} pos={pos} start={start} "
                         f"window={window} softcap={cap} chunk={chunk}: max_abs_err {yf.max().item():.4g} "
                         f"within 2^-7|ref|+1e-5 {within}, rows without a slot exactly 0 {zero} ({none}), "
                         f"relaunch bit-equal {same}{'' if ok else ' FAILED'}")
            del k, v, ks, vs
    print("check " + "\n      ".join(lines), flush=True)

    # ---------------------------------------------------------------- times
    times = {}
    sums = {}
    for (O, K), n in shapes.items():
        copies = max(1, math.ceil(cs.L2_COPIES_BYTES / (M_PATH * (O + K) * 2)))
        sets = [(randn(M_PATH, O), randn(M_PATH, K)) for _ in range(copies)]
        t_k = cs.time_ms(torch, lambda a, b: kernels.dw_matmul(a, b), sets, args.iters)
        t_l = cs.time_ms(torch, lambda a, b: torch.matmul(a.t(), b), sets, args.iters)
        d_k = cs.device_ms(torch, lambda a, b: kernels.dw_matmul(a, b), sets, args.iters)
        d_l = cs.device_ms(torch, lambda a, b: torch.matmul(a.t(), b), sets, args.iters)
        flops = 2.0 * M_PATH * O * K
        b_ms, by = cs.bound_ms(M_PATH * (O + K) * 2 + O * K * 2, flops)
        times[f"dw {O}x{K}"] = t_k
        times[f"dw {O}x{K} cublas"] = t_l
        times[f"dw {O}x{K} device"] = d_k
        times[f"dw {O}x{K} cublas device"] = d_l
        for key, val in (("", t_k), (" cublas", t_l), (" device", d_k), (" cublas device", d_l)):
            sums[f"dw step{key}"] = sums.get(f"dw step{key}", 0.0) + n * val
        print(f"time dW M={M_PATH} O={O} K={K} ({n} a step): {t_k:.5f} ms ({flops / t_k / 1e9:.1f} TFLOP/s), "
              f"device {d_k:.5f} ({flops / d_k / 1e9:.1f}); cuBLAS {t_l:.5f} ({flops / t_l / 1e9:.1f}), device "
              f"{d_l:.5f}; bound {b_ms:.5f} ({by})", flush=True)
        del sets
    times.update(sums)
    print(f"per step: dW {sums['dw step']:.3f} ms (device {sums['dw step device']:.3f}), cuBLAS "
          f"{sums['dw step cublas']:.3f} ms (device {sums['dw step cublas device']:.3f})", flush=True)

    G = HQ // HKV
    for fp8 in (False, True):
        name = "fp8" if fp8 else "bf16"
        k, v, ks, vs, bt, p_t, s_t, live = cs.paged_operands(torch, dev, g, LAYERS, HKV, D, STEADY, fp8)
        q = randn(8, HQ, D)
        layers = [(layer,) for layer in range(LAYERS)]
        t_k = cs.time_ms(torch, lambda layer: kernels.paged_attention(q, k, v, bt, layer, p_t, s_t, ks, vs),
                         layers, max(64, args.iters))
        d_k = cs.device_ms(torch, lambda layer: kernels.paged_attention(q, k, v, bt, layer, p_t, s_t, ks, vs),
                           layers, max(64, args.iters))
        mask = (torch.arange(2048, device=dev)[None, :] <= p_t[:, None].long())[:, None, None]
        views = []
        for layer in (0, 1):
            kd, vd = (pa_mod._decoded(x, sc, layer, bt.long()).bfloat16().repeat_interleave(G, dim=2)
                      .transpose(1, 2).contiguous() for x, sc in ((k, ks), (v, vs)))
            views.append((q[:, :, None], kd, vd))
        t_l = cs.time_ms(torch, lambda q_, k_, v_: torch.nn.functional.scaled_dot_product_attention(
            q_, k_, v_, attn_mask=mask), views, args.iters)
        d_l = cs.device_ms(torch, lambda q_, k_, v_: torch.nn.functional.scaled_dot_product_attention(
            q_, k_, v_, attn_mask=mask), views, args.iters)
        per_slot = HKV * D * (1 if fp8 else 2) * 2 + (HKV * 4 * 2 if fp8 else 0)
        b_ms, by = cs.bound_ms(live * per_slot + 8 * HQ * D * 6 + bt.numel() * 4 + 64, 4.0 * D * HQ * live)
        times[f"paged {name} layer"] = t_k
        times[f"paged {name} layer sdpa"] = t_l
        times[f"paged {name} step"] = LAYERS * t_k
        times[f"paged {name} step sdpa"] = LAYERS * t_l
        times[f"paged {name} layer device"] = d_k
        times[f"paged {name} layer sdpa device"] = d_l
        chunk = pa_mod.split_chunk(8, HKV, 2048) if hasattr(pa_mod, "split_chunk") else None
        blocks = (HKV * sum(len(pa_mod.split_plan(0, p, chunk)) for p in STEADY) if chunk else 8 * HKV)
        print(f"time paged {name} 8 rows at {STEADY} ({live} live slots): {t_k:.5f} ms a layer (device "
              f"{d_k:.5f}), {LAYERS * t_k:.3f} a step; SDPA over gathered views {t_l:.5f} a layer (device "
              f"{d_l:.5f}); bound {b_ms:.5f} ({by}); chunk {chunk}, {blocks} blocks with work", flush=True)
        del k, v, ks, vs, views
    # the host's side of a launch: microseconds a call at small shapes,
    # where the card waits on the host
    def host_us(fn, n=2000):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / n * 1e6

    gs, xs = randn(64, 1024), randn(64, 1024)
    k, v, ks, vs, bt, p_t, s_t, _ = cs.paged_operands(torch, dev, g, 1, HKV, D, [100, 200], False)
    qs = randn(2, HQ, D)
    for key, fn in (("dw", lambda: kernels.dw_matmul(gs, xs)),
                    ("dw cublas", lambda: torch.matmul(gs.t(), xs)),
                    ("paged", lambda: kernels.paged_attention(qs, k, v, bt, 0, p_t, s_t)),
                    ("paged sdpa", lambda: torch.nn.functional.scaled_dot_product_attention(
                        qs[:, :, None], qs[:, :, None], qs[:, :, None]))):
        times[f"host us {key}"] = host_us(fn)
    print("host us a call (dW 64 x 1024 x 1024, paged 2 rows): " + ", ".join(
        f"{key[8:]} {val:.2f}" for key, val in times.items() if key.startswith("host us")), flush=True)
    print(json.dumps({"root": str(root), "card": smi, "spill_bytes": spills, "failed": failures,
                      "times": times}), flush=True)
    return 1 if failures or spills else 0


if __name__ == "__main__":
    sys.exit(main())
