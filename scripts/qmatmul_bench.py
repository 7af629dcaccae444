#!/usr/bin/env python3
"""The dequant GEMM, LoRA GEMM, dx, GEMV and LoRA GEMV kernels alone on
one CUDA card: build, check, time.

    python3 scripts/qmatmul_bench.py [--root DIR] [--iters N] [--forms F,..] [--qtypes Q,..]
    python3 scripts/qmatmul_bench.py --root PARENT --root CHANGE

Builds only `csrc/qmatmul.cu` and `csrc/qbackward.cu` of the checkout at
DIR (default: the one this script lies in), for sym_int4, nf4, q4_k and
q6_k (the generation, training and q4_k_m paths' formats), and prints the
ptxas report of the tensor-core kernels (registers, spill bytes, HMMA
count; a spill fails the run). Holds the GEMM, the LoRA GEMM and dx
against their plain versions within 2 bf16 ULPs of the largest output
(chip_smoke's phase-2 tolerance) at llama3-8b's path shapes and at ragged
M (33, 255, 257, 1000, 4096) with a ragged O edge, checks that a second
launch gives the same bits and that rows whose LoRA gate is zero give the
GEMM's bits. Then times with CUDA events, operands cycled past the 50 MB
L2: the GEMM at the prefill shapes (M = 1024, every projection), dx and
the LoRA GEMM at the training shapes (M = 1024, R = 8), each beside
cuBLAS on the weight dequantized beforehand (a yardstick the port never
calls) and the least time the card could take (bytes / 3.35 TB/s or
flops / 989 TFLOP/s), with each tile's blocks and waves.

The decode forms (`--forms gemv,lora_gemv`): the GEMV at every path
shape and M = 1, 3, 4, 8, 17, 32 and the LoRA GEMV at wo and w_down
(R = 128, the serving decode's block-diagonal gate with a zero row) are
held against their plain versions the same way, relaunched (the same
bits) and, for the LoRA GEMV, the zero-gate row held to the GEMV's bits;
then timed at M = 1, 4, 8, 32 by CUDA events and by profiled device time
(torch.profiler: events around a call also count the wrapper's host time
where it outlasts the kernel), each beside cuBLAS on the weight
dequantized beforehand (plus two matmuls for the adapter), summed over a
decode step (32 x the four layer projections + the lm head) and over an
adapter decode step (32 x (wo + w_down)). The last line is one JSON
object of the times.

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
from pathlib import Path

QTYPES = ("sym_int4", "nf4", "q4_k", "q6_k")
LAYERS, M_PATH, RANK = 32, 1024, 8
RAGGED_M = (33, 255, 257, 1000, 4096)
# dx calls per train step (layer 0's wqkv has none): chip_smoke phase 6
DX_CALLS = {"wqkv": LAYERS - 1, "wo": LAYERS, "w_gateup": LAYERS, "w_down": LAYERS, "lm_head": 1}
FORMS = ("gemm", "dx", "lora_gemm", "gemv", "lora_gemv")
GEMV_CHECK_M = (1, 3, 4, 8, 17, 32)
GEMV_TIME_M = (1, 4, 8, 32)
LORA_R = 128


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
            print(f"qmatmul_bench: the run on {root} failed (exit {proc.returncode})", flush=True)
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
    ap.add_argument("--forms", default=",".join(FORMS))
    ap.add_argument("--qtypes", default=",".join(QTYPES))
    args = ap.parse_args()
    forms, qtypes = args.forms.split(","), args.qtypes.split(",")
    if len(args.root) == 2:
        return compare(args.root, ["--iters", str(args.iters), "--forms", args.forms,
                                   "--qtypes", args.qtypes])
    if len(args.root) > 2:
        ap.error("--root at most twice")
    import torch

    if not torch.cuda.is_available():
        print("qmatmul_bench: no CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root[0] if args.root else Path(__file__).resolve().parents[1]).resolve()
    sys.path.insert(0, str(root))
    import ctypes
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

    # build the libraries this script needs, not every source
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stems = ("qmatmul", "qbackward") if "dx" in forms else ("qmatmul",)
    todo = [(stem, q, _build._library_path(stem, q)) for stem in stems for q in qtypes]
    with ThreadPoolExecutor(max_workers=len(todo)) as pool:
        failed = [f for f in pool.map(lambda t: None if t[2].exists() else _build._compile(*t), todo) if f]
    if failed:
        print("\n".join(failed), file=sys.stderr)
        return 1
    spills = 0
    for stem, q, lib in todo:
        _build._libs[(stem, q)] = ctypes.CDLL(str(lib))
        print(f"{stem}[{q}]:", flush=True)
        spills += cs.tc_kernel_report(lib, ("gemm_kernel", "dx_kernel"))
        if stem == "qmatmul":  # the decode GEMV: reported, a spill counted apart
            gemv_spills = cs.tc_kernel_report(lib, ("gemv_kernel", "lora_xa_split_kernel"))
            print(f"  gemv spill bytes {gemv_spills}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"root {root}; card {smi}; spill bytes of the GEMM and dx kernels {spills}", flush=True)

    try:  # the tile policy, where the checkout has one
        from bigdl_tpu_torch.ops.kernels.qtile import dx_tile, gemm_tile
    except ImportError:
        gemm_tile = dx_tile = None
    try:
        from bigdl_tpu_torch.ops.kernels.qtile import gemv_tile
    except ImportError:
        gemv_tile = None

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    failures = []

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)

    def held(label, got, ref):
        got, ref = got.float(), ref.float()
        err = (got - ref).abs().max().item()
        tol = ref.abs().max().item() * 2 ** -7
        ok = bool(torch.isfinite(got).all()) and got.shape == ref.shape and err <= tol
        if not ok:
            failures.append(label)
        return f"{label} {err:.4g}/{tol:.4g}{'' if ok else ' FAILED'}"

    H, I, V = 4096, 14336, 128256
    shapes = {"wqkv": (6144, H), "wo": (H, H), "w_gateup": (2 * I, H), "w_down": (H, I),
              "lm_head": (V, H)}
    times = {}
    for qi, qtype in enumerate(qtypes):
        if "gemv" in forms or "lora_gemv" in forms:
            decode_forms(torch, cs, kernels, dev, qtype, qi, shapes, forms, args.iters, randn, held,
                         failures, times, gemv_tile)
        if not {"gemm", "dx", "lora_gemm"} & set(forms):
            continue
        # correctness: ragged M with a ragged O edge (O = 200), second
        # launches, zero-gate LoRA rows; then every path shape
        w = cs.qweight_of(torch, dev, qtype, 200, 2048, 7 + qi)
        lines = []
        for M in RAGGED_M:
            x, gr = randn(M, 2048), randn(M, 200)
            a, b_ = randn(RANK, 2048) / RANK, randn(200, RANK) * 0.1
            gate = torch.full((M, RANK), 2.0, dtype=torch.bfloat16, device=dev)
            gate[::3] = 0  # every third row a base row
            y = kernels.qmatmul(x, w)
            yl = kernels.qmatmul_lora(x, w, a, b_, gate)
            dx = kernels.qmatmul_dx(gr, w)
            lines += [held(f"GEMM M={M}", y, kernels.qmatmul_plain(x, w)),
                      held(f"LoRA GEMM M={M}", yl, kernels.qmatmul_lora_plain(x, w, a, b_, gate)),
                      held(f"dx M={M}", dx, kernels.qmatmul_dx_plain(gr, w))]
            same = (torch.equal(y, kernels.qmatmul(x, w)) and torch.equal(dx, kernels.qmatmul_dx(gr, w))
                    and torch.equal(yl, kernels.qmatmul_lora(x, w, a, b_, gate)))
            base = torch.equal(yl[::3], y[::3])
            lines.append(f"M={M} relaunch bit-equal {same}, zero-gate rows = GEMM bits {base}")
            if not (same and base):
                failures.append(f"{qtype} M={M} relaunch/zero-gate")
        print(f"check {qtype} O=200 K=2048: " + "; ".join(lines), flush=True)

        for name, (O, K) in shapes.items():
            w = cs.qweight_of(torch, dev, qtype, O, K, 100 * qi + len(name))
            wb = cs.weight_bytes(w)
            copies = max(1, math.ceil(cs.L2_COPIES_BYTES / wb))
            ws = [(w,)] + [(cs.qweight_of(torch, dev, qtype, O, K, 1000 * qi + c),) for c in range(1, copies)]
            dense = [(w_.dequantize(torch.bfloat16),) for w_, in ws[:max(1, copies // 2)]]
            M = M_PATH
            x, gr = randn(M, K), randn(M, O)
            lines = []
            if name != "lm_head":  # the prefill GEMM (the lm head takes the GEMV there)
                lines.append(held(f"{name} GEMM", kernels.qmatmul(x, w), kernels.qmatmul_plain(x, w)))
                t_k = cs.time_ms(torch, lambda w_: kernels.qmatmul(x, w_), ws, args.iters)
                t_l = cs.time_ms(torch, lambda d: torch.matmul(x, d.t()), dense, args.iters)
                b_ms, by = cs.bound_ms(M * K * 2 + wb + M * O * 2, 2.0 * M * O * K)
                tile = gemm_tile(M, O, K, qtype) if gemm_tile else None
                times[f"{qtype} gemm {name}"] = t_k
                times[f"{qtype} gemm {name} cublas"] = t_l
                print(f"time {qtype} GEMM {name} M={M} O={O} K={K}: {t_k:.5f} ms, cuBLAS {t_l:.5f}, "
                      f"bound {b_ms:.5f} ({by})"
                      + (f", tile bm={tile.bm} stages={tile.stages} smem={tile.smem} "
                         f"blocks={tile.blocks} waves={tile.waves:.2f}" if tile else ""), flush=True)
            lines.append(held(f"{name} dx", kernels.qmatmul_dx(gr, w), kernels.qmatmul_dx_plain(gr, w)))
            t_k = cs.time_ms(torch, lambda w_: kernels.qmatmul_dx(gr, w_), ws, args.iters)
            t_l = cs.time_ms(torch, lambda d: torch.matmul(gr, d), dense, args.iters)
            b_ms, by = cs.bound_ms(M * O * 2 + wb + M * K * 2, 2.0 * M * O * K)
            tile = dx_tile(M, O, K, qtype) if dx_tile else None
            times[f"{qtype} dx {name}"] = t_k
            times[f"{qtype} dx {name} cublas"] = t_l
            print(f"time {qtype} dx {name} M={M} O={O} K={K}: {t_k:.5f} ms, cuBLAS {t_l:.5f}, "
                  f"bound {b_ms:.5f} ({by})"
                  + (f", tile bm={tile.bm} stages={tile.stages} smem={tile.smem} "
                     f"blocks={tile.blocks} waves={tile.waves:.2f}" if tile else ""), flush=True)
            if name in ("wo", "w_down"):
                a, b_ = randn(RANK, K) / RANK, randn(O, RANK) * 0.01
                gate = torch.full((M, RANK), 2.0, dtype=torch.bfloat16, device=dev)
                lines.append(held(f"{name} LoRA GEMM", kernels.qmatmul_lora(x, w, a, b_, gate),
                                  kernels.qmatmul_lora_plain(x, w, a, b_, gate)))
                t_k = cs.time_ms(torch, lambda w_: kernels.qmatmul_lora(x, w_, a, b_, gate), ws, args.iters)
                t_l = cs.time_ms(torch, lambda d: torch.matmul(x, d.t()) + torch.matmul(
                    torch.matmul(x, a.t()) * 2.0, b_.t()), dense, args.iters)
                b_ms, by = cs.bound_ms(M * K * 2 + wb + (RANK * K + O * RANK + 2 * M * RANK + M * O) * 2,
                                       2.0 * M * O * K + 2.0 * M * RANK * (K + O))
                times[f"{qtype} lora_gemm {name}"] = t_k
                times[f"{qtype} lora_gemm {name} cublas"] = t_l
                print(f"time {qtype} LoRA GEMM {name} M={M} O={O} K={K} R={RANK}: {t_k:.5f} ms, "
                      f"cuBLAS + two matmuls {t_l:.5f}, bound {b_ms:.5f} ({by})", flush=True)
            print(f"check {qtype} {name} M={M}: " + "; ".join(lines), flush=True)
            del w, ws, dense

        # per path unit: a prefill's 4 x 32 GEMMs, a train step's dx and LoRA GEMMs
        for key, parts in ((f"{qtype} gemm prefill", {f"gemm {n}": LAYERS for n in
                                                      ("wqkv", "wo", "w_gateup", "w_down")}),
                           (f"{qtype} dx step", {f"dx {n}": c for n, c in DX_CALLS.items()}),
                           (f"{qtype} lora_gemm step", {f"lora_gemm {n}": LAYERS for n in ("wo", "w_down")})):
            for suffix in ("", " cublas"):
                times[key + suffix] = sum(n * times[f"{qtype} {p}{suffix}"] for p, n in parts.items())
        print(f"per unit {qtype}: GEMM {times[f'{qtype} gemm prefill']:.3f} ms a prefill (cuBLAS "
              f"{times[f'{qtype} gemm prefill cublas']:.3f}); dx {times[f'{qtype} dx step']:.3f} ms a "
              f"step ({times[f'{qtype} dx step cublas']:.3f}); LoRA GEMM "
              f"{times[f'{qtype} lora_gemm step']:.3f} ms a step "
              f"({times[f'{qtype} lora_gemm step cublas']:.3f})", flush=True)
    print(json.dumps({"root": str(root), "card": smi, "spill_bytes": spills, "failed": failures,
                      "times": times}), flush=True)
    return 1 if failures or spills else 0


def decode_forms(torch, cs, kernels, dev, qtype, qi, shapes, forms, iters, randn, held, failures,
                 times, gemv_tile) -> None:
    """The GEMV and the LoRA GEMV of one format: checks at every path
    shape, then events and profiled device ms beside cuBLAS, per call and
    summed over a decode step and an adapter decode step."""
    for name, (O, K) in shapes.items():
        w = cs.qweight_of(torch, dev, qtype, O, K, 300 * qi + len(name))
        wb = cs.weight_bytes(w)
        lora = "lora_gemv" in forms and name in ("wo", "w_down")
        a, b_ = randn(LORA_R, K) / 16, randn(O, LORA_R) * 0.02
        lines = []
        for M in GEMV_CHECK_M:
            x = randn(M, K)
            y = kernels.qmatmul(x, w)
            lines.append(held(f"M={M}", y, kernels.qmatmul_plain(x, w)))
            same = torch.equal(y, kernels.qmatmul(x, w))
            if lora:
                gate = cs.lora_gate(torch, dev, M, LORA_R, "block")
                yl = kernels.qmatmul_lora(x, w, a, b_, gate)
                lines.append(held(f"LoRA M={M}", yl, kernels.qmatmul_lora_plain(x, w, a, b_, gate)))
                same = same and torch.equal(yl, kernels.qmatmul_lora(x, w, a, b_, gate))
                if M > 1 and not torch.equal(yl[-1], y[-1]):
                    failures.append(f"{qtype} {name} M={M} zero-gate row")
                    lines.append("zero-gate row FAILED")
            if not same:
                failures.append(f"{qtype} {name} M={M} relaunch")
                lines.append("relaunch FAILED")
        print(f"check {qtype} GEMV {name} O={O} K={K}: " + "; ".join(lines)
              + "; relaunches bit-equal, zero-gate rows = GEMV bits", flush=True)
        copies = max(1, math.ceil(cs.L2_COPIES_BYTES / wb))
        ws = [(w,)] + [(cs.qweight_of(torch, dev, qtype, O, K, 3000 * qi + c),) for c in range(1, copies)]
        dense = [(w_.dequantize(torch.bfloat16),) for w_, in ws[:max(1, copies // 2)]]
        for M in GEMV_TIME_M:
            x = randn(M, K)
            cases = [("gemv", lambda w_: kernels.qmatmul(x, w_), ws,
                      lambda d: torch.matmul(x, d.t()), dense,
                      M * K * 2 + wb + M * O * 2, 2.0 * M * O * K)]
            if lora:
                gate = cs.lora_gate(torch, dev, M, LORA_R, "block")
                la = [(w_, a, b_) for w_, in ws]
                ld = [(d, a, b_) for d, in dense]
                nb, fl = cs.lora_gemv_cost(M, O, K, LORA_R, wb)
                cases.append(("lora_gemv", lambda w_, a_, b2: kernels.qmatmul_lora(x, w_, a_, b2, gate), la,
                              lambda d, a_, b2: cs.lora_gemv_library(torch, x, d, a_, b2, gate), ld, nb, fl))
            for form, fn, sets, lib, lib_sets, nb, fl in cases:
                if form not in forms:
                    continue
                ev = cs.time_ms(torch, fn, sets, iters)
                dv = cs.device_ms(torch, fn, sets, iters)
                lev = cs.time_ms(torch, lib, lib_sets, iters)
                ldv = cs.device_ms(torch, lib, lib_sets, iters)
                b_ms, by = cs.bound_ms(nb, fl)
                key = f"{qtype} {form} {name} M={M}"
                times.update({key: ev, key + " device": dv, key + " cublas": lev,
                              key + " cublas device": ldv, key + " bound": b_ms})
                tile = gemv_tile(M, O, K, qtype) if gemv_tile else None
                print(f"time {qtype} {form} {name} M={M} O={O} K={K}: events {ev:.5f} ms, device "
                      f"{dv:.5f}; cuBLAS events {lev:.5f}, device {ldv:.5f}; bound {b_ms:.5f} ({by})"
                      + (f"; tile rows={tile.rows} kc={tile.kc} blocks={tile.blocks}" if tile else ""),
                      flush=True)
        del w, ws, dense
    for M in GEMV_TIME_M:
        for form, parts in (("gemv", {n: (LAYERS if n != "lm_head" else 1) for n in shapes}),
                            ("lora_gemv", {"wo": LAYERS, "w_down": LAYERS})):
            if form not in forms:
                continue
            for suffix in ("", " device", " cublas", " cublas device", " bound"):
                times[f"{qtype} {form} step M={M}{suffix}"] = sum(
                    n * times[f"{qtype} {form} {p} M={M}{suffix}"] for p, n in parts.items())
            k = f"{qtype} {form} step M={M}"
            print(f"per unit {qtype} {form} M={M} ({'a decode step' if form == 'gemv' else 'an adapter decode step, R=128'}): "
                  f"events {times[k]:.3f} ms, device {times[k + ' device']:.3f}; cuBLAS events "
                  f"{times[k + ' cublas']:.3f}, device {times[k + ' cublas device']:.3f}; bound "
                  f"{times[k + ' bound']:.3f}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
