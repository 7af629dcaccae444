#!/usr/bin/env python3
"""The flash kernels alone on one CUDA card: build, check, time.

    python3 scripts/flash_train_bench.py [--root DIR] [--iters N]

Builds only `csrc/flash_backward.cu` and `csrc/flash_attention.cu` of the
checkout at DIR (default: the one this script lies in) and prints their
ptxas report for the tensor-core kernels (registers, spill bytes, HMMA
count). Holds the training forward, dQ and dK/dV kernels against their
plain versions at the llama3-8b training shape (B=1, T=1024, 32 q heads
over 8 kv heads, D=128) and at small GQA + pad + window cases (dQ and
dK/dV of rows and keys before start exactly 0, a second launch of each
bit-equal), and the prefill kernel's bf16 and fp8 arms at their path
shapes and at small edge cases (chip_smoke's phase-2 tolerances). Then
times each per layer with CUDA events (operands cycled past the 50 MB
L2): the training trio beside SDPA's forward and backward (profiled
device time and events), the bf16 arm at the generation prefill (B=4,
T=256 over 320 slots, ragged left padding) and the fp8 arm at the dense
fp8 pool's prefill (B=1, T=S=1024, 24 pad slots), each beside SDPA. The
last line is one JSON object of the times. Run it with --root pointing
at two checkouts in one call to compare them on one card.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

PREFILL = (4, 256, 320, (0, 56, 127, 239))  # B, T, S, start: chip_smoke phase 4
FP8_PREFILL = (1, 1024, 1024, (24,))  # engine (e)'s prefill: chip_smoke phase 8


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_train_bench: no CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import ctypes

    from bigdl_tpu_torch.kvcache import _quantize_heads
    from bigdl_tpu_torch.ops import kernels
    from bigdl_tpu_torch.ops.kernels import _build
    from bigdl_tpu_torch.ops.kernels.flash_attention import valid_mask

    # this checkout's chip_smoke (its timing and report helpers), also when
    # --root names another checkout
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    # build the two libraries this script needs, not every source
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {}
    for stem in ("flash_backward", "flash_attention"):
        lib = _build._library_path(stem, None)
        if not lib.exists():
            failed = _build._compile(stem, None, lib)
            if failed:
                print(failed, file=sys.stderr)
                return 1
        _build._libs[(stem, None)] = ctypes.CDLL(str(lib))
        libs[stem] = lib
    spills = cs.tc_kernel_report(libs["flash_backward"], ("fwd_kernel", "dq_kernel", "dkv_kernel"))
    spills += cs.tc_kernel_report(libs["flash_attention"], ("flash_kernel",))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"root {root}; card {smi}; spill bytes of the tensor-core kernels {spills}", flush=True)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    failures = []

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)

    # correctness, with chip_smoke's phase-2 tolerances
    for label, B, T, Hq, Hkv, D, win, st in (
            ("train", 1, 1024, 32, 8, 128, None, (0,)),
            ("gqa+pad+window", 2, 160, 8, 2, 128, 48, (0, 37)),
            ("G=8+pad covers a key tile", 2, 130, 8, 1, 64, 64, (0, 70))):
        q, k, v, do = randn(B, T, Hq, D), randn(B, T, Hkv, D), randn(B, T, Hkv, D), randn(B, T, Hq, D)
        start = torch.tensor(st, dtype=torch.int32, device=dev)
        out, lse = kernels.flash_train_fwd(q, k, v, start, win)
        rout, rlse = kernels.flash_attention_train_plain(q, k, v, start, win)
        pad = rlse <= -1e29
        bad = ((out.float() - rout.float()).abs() > 2 ** -7 * rout.float().abs() + 1e-5).sum().item()
        lse_err = (lse[~pad] - rlse[~pad]).abs().max().item()
        pad_ok = bool((lse[pad] == -1e30).all() and (out[pad.any(-1)] == 0).all())
        delta = (do.float() * out.float()).sum(-1)
        dq = kernels.flash_train_dq(q, k, v, start, do, lse, delta, win)
        dk, dv = kernels.flash_train_dkv(q, k, v, start, do, lse, delta, win)
        dq2 = kernels.flash_train_dq(q, k, v, start, do, lse, delta, win)
        dk2, dv2 = kernels.flash_train_dkv(q, k, v, start, do, lse, delta, win)
        refs = kernels.flash_attention_train_bwd_plain(q, k, v, start, do, lse, delta, win)
        same = torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)
        zeros = all(bool((dq[i, :s0] == 0).all() and (dk[i, :s0] == 0).all() and (dv[i, :s0] == 0).all())
                    for i, s0 in enumerate(st))
        line = (f"check {label}: fwd elements outside 2^-7|ref|+1e-5: {bad}, lse_err {lse_err:.3g}, "
                f"pad exact {pad_ok}, dq/dk/dv bit-equal relaunch {same}, zeros before start {zeros}")
        ok = bad == 0 and lse_err <= 1e-4 and pad_ok and same and zeros
        for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
            err = (got.float() - ref.float()).abs().max().item()
            tol = 2 ** -6 * ref.float().abs().max().item()
            frob = ((got.float() - ref.float()).norm() / ref.float().norm()).item()
            line += f"; {name} max_abs_err {err:.4g} tol {tol:.4g} rel_frobenius {frob:.3g}"
            ok = ok and err <= tol and frob <= 1e-2
        print(line, "OK" if ok else "FAILED", flush=True)
        if not ok:
            failures.append(label)

    for label, B, T, S, Hq, Hkv, D, qoff, st, win, cap, fp8 in (
            ("bf16 generation prefill", *PREFILL[:3], 32, 8, 128, 0, PREFILL[3], None, None, False),
            ("bf16 T=17 q_offset window across a tile", 2, 17, 192, 32, 8, 128, 100, (0, 3), 50, None, False),
            ("bf16 T=30 softcap", 2, 30, 96, 8, 2, 128, 40, (0, 50), None, 30.0, False),
            ("bf16 head_dim 64", 2, 96, 128, 8, 2, 64, 0, (0, 37), None, None, False),
            ("bf16 head_dim 256", 1, 70, 96, 2, 1, 256, 0, (13,), None, None, False),
            ("fp8 dense prefill", *FP8_PREFILL[:3], 32, 8, 128, 0, FP8_PREFILL[3], None, None, True),
            ("fp8 window+softcap", 2, 128, 192, 32, 8, 128, 40, (0, 37), 64, 30.0, True),
            ("fp8 subnormal scales", 2, 30, 96, 32, 8, 128, 20, (0, 9), None, None, True),
            ("fp8 head_dim 256", 2, 70, 96, 4, 1, 256, 0, (0, 37), None, None, True)):
        q = randn(B, T, Hq, D)
        amp = 0.2 if "subnormal" in label else 3.0
        ks = vs = None
        if fp8:
            k, ks = _quantize_heads(torch.randn((B, S, Hkv, D), device=dev, generator=g) * amp)
            v, vs = _quantize_heads(torch.randn((B, S, Hkv, D), device=dev, generator=g) * amp / 3)
        else:
            k, v = randn(B, S, Hkv, D), randn(B, S, Hkv, D)
        start = torch.tensor(st, dtype=torch.int32, device=dev)
        y = kernels.flash_attention(q, k, v, start=start, q_offset=qoff, window=win, softcap=cap,
                                    k_scale=ks, v_scale=vs).float()
        ref = kernels.flash_attention_plain(q, k, v, start, qoff, win, cap, k_scale=ks,
                                            v_scale=vs).float()
        bad = ((y - ref).abs() > 2 ** -7 * ref.abs() + 1e-5).sum().item()
        pad_rows = ~valid_mask(start, qoff, T, S, win).any(-1)
        zeros = bool((y[pad_rows] == 0).all())
        ok = bad == 0 and zeros and bool(torch.isfinite(y).all())
        print(f"check flash {label}: elements outside 2^-7|ref|+1e-5: {bad}, max_abs_err "
              f"{(y - ref).abs().max().item():.4g}, pad rows {int(pad_rows.sum())} exact 0 {zeros}",
              "OK" if ok else "FAILED", flush=True)
        if not ok:
            failures.append(label)

    # times per layer at the training shape
    B, T, Hq, Hkv, D = 1, 1024, 32, 8, 128
    start = torch.zeros((1,), dtype=torch.int32, device=dev)
    io = 2 * T * Hq * D * 2 + 2 * T * Hkv * D * 2
    sets = []
    for _ in range(math.ceil(cs.L2_COPIES_BYTES / io)):
        q, k, v, do = randn(1, T, Hq, D), randn(1, T, Hkv, D), randn(1, T, Hkv, D), randn(1, T, Hq, D)
        out, lse = kernels.flash_train_fwd(q, k, v, start)
        sets.append((q, k, v, do, lse, (do.float() * out.float()).sum(-1)))
    it = args.iters
    res = {
        "fwd_ms": cs.time_ms(torch, lambda q, k, v, *_: kernels.flash_train_fwd(q, k, v, start), sets, it),
        "dq_ms": cs.time_ms(torch, lambda *a: kernels.flash_train_dq(*a[:3], start, *a[3:]), sets, it),
        "dkv_ms": cs.time_ms(torch, lambda *a: kernels.flash_train_dkv(*a[:3], start, *a[3:]), sets, it),
    }
    res.update({f"sdpa_{key}": val for key, val in
                cs.sdpa_train_yardstick(torch, [s_[:4] for s_ in sets], Hq // Hkv).items()})
    live = T * (T + 1) // 2
    for key, per_pair in (("fwd_ms", 4), ("dq_ms", 6), ("dkv_ms", 8)):
        res[key.replace("_ms", "_tflops")] = per_pair * D * Hq * live / res[key] / 1e9
    del sets

    # the prefill arms at their path shapes
    sdpa = torch.nn.functional.scaled_dot_product_attention
    G = Hq // Hkv
    for key, (B, T, S, st), fp8 in (("flash_bf16", PREFILL, False), ("flash_fp8", FP8_PREFILL, True)):
        start = torch.tensor(st, dtype=torch.int32, device=dev)
        mask = valid_mask(start, 0, T, S)[:, None]
        io = B * T * Hq * D * 2 * 2 + 2 * B * S * Hkv * D * (1 if fp8 else 2)
        sets, expanded = [], []
        for _ in range(math.ceil(cs.L2_COPIES_BYTES / io)):
            q = randn(B, T, Hq, D)
            if fp8:
                (k, ks), (v, vs) = (_quantize_heads(torch.randn((B, S, Hkv, D), device=dev, generator=g))
                                    for _ in range(2))
                kd, vd = ((x.float() * s_.float()[..., None]).bfloat16() for x, s_ in ((k, ks), (v, vs)))
            else:
                k, v, ks, vs = randn(B, S, Hkv, D), randn(B, S, Hkv, D), None, None
                kd, vd = k, v
            sets.append((q, k, v, ks, vs))
            if len(expanded) < 4:  # the yardstick's K/V, dequantized and expanded beforehand
                expanded.append((q.transpose(1, 2), *(x.repeat_interleave(G, dim=2).transpose(1, 2)
                                                      for x in (kd, vd))))
        res[f"{key}_ms"] = cs.time_ms(torch, lambda q, k, v, ks, vs: kernels.flash_attention(
            q, k, v, start=start, k_scale=ks, v_scale=vs), sets, it)
        res[f"{key}_sdpa_ms"] = cs.time_ms(torch, lambda q, k, v: sdpa(q, k, v, attn_mask=mask), expanded, it)
        res[f"{key}_tflops"] = 4 * D * Hq * int(mask.sum()) / res[f"{key}_ms"] / 1e9
        del sets, expanded
    print(json.dumps({"root": str(root), "card": smi, "spill_bytes": spills, "failed": failures, **res}),
          flush=True)
    return 1 if failures or spills else 0


if __name__ == "__main__":
    sys.exit(main())
