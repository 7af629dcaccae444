#!/usr/bin/env python3
"""The training flash kernels alone on one CUDA card: build, check, time.

    python3 scripts/flash_train_bench.py [--root DIR] [--iters N]

Builds only `csrc/flash_backward.cu` of the checkout at DIR (default: the
one this script lies in), prints its ptxas report for the forward and
dK/dV kernels (registers, spill bytes, HMMA count), holds the forward,
dQ and dK/dV kernels against their plain versions at the llama3-8b
training shape (B=1, T=1024, 32 q heads over 8 kv heads, D=128) and a
small GQA + pad + window case, then times each per layer with CUDA events
(operands cycled past the 50 MB L2) beside SDPA's forward and backward.
The last line is one JSON object of the times. Run it twice with --root
pointing at two checkouts in one call to compare them on one card.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path


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

    from bigdl_tpu_torch.ops import kernels
    from bigdl_tpu_torch.ops.kernels import _build

    # this checkout's chip_smoke (its timing and report helpers), also when
    # --root names another checkout
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    # build the one library this script needs, not every source
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = _build._library_path("flash_backward", None)
    if not lib.exists():
        failed = _build._compile("flash_backward", None, lib)
        if failed:
            print(failed, file=sys.stderr)
            return 1
    _build._libs[("flash_backward", None)] = ctypes.CDLL(str(lib))
    cs.tc_kernel_report(lib, ("fwd_kernel", "dkv_kernel"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"root {root}; card {smi}", flush=True)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)

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
        dk, dv = kernels.flash_train_dkv(q, k, v, start, do, lse, delta, win)
        dk2, dv2 = kernels.flash_train_dkv(q, k, v, start, do, lse, delta, win)
        _, rdk, rdv = kernels.flash_attention_train_bwd_plain(q, k, v, start, do, lse, delta, win)
        line = (f"check {label}: fwd elements outside 2^-7|ref|+1e-5: {bad}, lse_err {lse_err:.3g}, "
                f"pad exact {pad_ok}, dk/dv bit-equal relaunch "
                f"{torch.equal(dk, dk2) and torch.equal(dv, dv2)}")
        ok = bad == 0 and lse_err <= 1e-4 and pad_ok
        for name, got, ref in (("dk", dk, rdk), ("dv", dv, rdv)):
            err = (got.float() - ref.float()).abs().max().item()
            tol = 2 ** -6 * ref.float().abs().max().item()
            frob = ((got.float() - ref.float()).norm() / ref.float().norm()).item()
            line += f"; {name} max_abs_err {err:.4g} tol {tol:.4g} rel_frobenius {frob:.3g}"
            ok = ok and err <= tol and frob <= 1e-2
        print(line, "OK" if ok else "FAILED", flush=True)

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
    sdpa = torch.nn.functional.scaled_dot_product_attention
    G = Hq // Hkv
    exp = [tuple(t_.repeat_interleave(r, dim=2).transpose(1, 2).contiguous().requires_grad_()
                 for t_, r in ((q, 1), (k, G), (v, G))) + (do.transpose(1, 2),)
           for q, k, v, do, _, _ in sets]
    res["sdpa_fwd_ms"] = cs.time_ms(torch, lambda q, k, v, do: sdpa(q, k, v, is_causal=True), exp, it)
    res["sdpa_fwd_bwd_ms"] = cs.time_ms(torch, lambda q, k, v, do: torch.autograd.grad(
        sdpa(q, k, v, is_causal=True), (q, k, v), do), exp, it)
    live = T * (T + 1) // 2
    for key, per_pair in (("fwd_ms", 4), ("dq_ms", 6), ("dkv_ms", 8)):
        res[key.replace("_ms", "_tflops")] = per_pair * D * Hq * live / res[key] / 1e9
    print(json.dumps({"root": str(root), "card": smi, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
