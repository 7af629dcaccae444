#!/usr/bin/env python3
"""Smoke run of bigdl_tpu_torch, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. build every CUDA kernel from csrc/ (one nvcc per source, in parallel)
   and print the card's name and power limit;
2. hold each kernel against its plain PyTorch version at the main path's
   shapes: the sym_int4 dequant-matmul GEMV (M <= 32) and GEMM (M > 32) at
   every llama3-8b projection, flash attention at the prefill shape with
   ragged left padding, plus a window+softcap case and a head_dim-64 case;
3. the main path: llama3-8b at full width and depth (32 layers) with
   seeded random weights, `optimize_model(..., "sym_int4")`, greedy
   `TorchModel.generate` of 32 tokens for 4 ragged prompts — launch counts
   of every kernel, tokens in the vocabulary, the same tokens on a second
   call, and prefill logits of a 2-layer full-width model against the
   plain versions on the card;
4. times: each kernel's device time on the main path itself (`ms`, from
   a `torch.profiler` window over two prefills and five decode steps);
   with CUDA events after warm-up and operands cycled through copies
   larger than the L2, each kernel at each path shape (`isolated_ms`)
   beside its plain version (`plain_ms`) and one PyTorch call computing
   the same function (`library_ms`, a yardstick the port never calls);
   the least time the card could take (`bound_ms`, from the H100 SXM data
   sheet); prefill ms, decode ms per token and peak memory.

It prints one `{"kernels": [...]}` line, and as its last line
`{"ok": true, "device": {...}}`. Without a CUDA card, or without the
package beside it, it exits non-zero before printing either.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
B, PROMPT_LENS, NEW_TOKENS = 4, (256, 200, 129, 17), 32
L2_COPIES_BYTES = 200e6  # operands cycled through 4x the 50 MB L2
PROFILED_PREFILLS, PROFILED_STEPS = 2, 5


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def time_ms(torch, fn, args_list, iters: int = 20) -> float:
    """Mean ms per call over `iters` calls after 3 warm-up calls, cycling
    through `args_list` (copies that together exceed the 50 MB L2, so each
    call finds its operands in device memory as the model's layers do)."""
    for i in range(3):
        fn(*args_list[i % len(args_list)])
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch import PRESETS, TorchModel, optimize_model
    from bigdl_tpu_torch.generate import pad_prompts
    from bigdl_tpu_torch.kvcache import init_cache
    from bigdl_tpu_torch.models import llama
    from bigdl_tpu_torch.ops import kernels
    from bigdl_tpu_torch.ops.kernels import _build
    from bigdl_tpu_torch.ops.kernels.flash_attention import valid_mask
    from bigdl_tpu_torch.quant import dequantize_blockwise, resolve_qtype
    from bigdl_tpu_torch.utils import cache_len_for

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = PRESETS["llama3-8b"]
    L, H, I, V = (cfg.num_hidden_layers, cfg.hidden_size,
                  cfg.intermediate_size, cfg.vocab_size)
    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    shapes = {"wqkv": (cfg.q_dim + 2 * cfg.kv_dim, H), "wo": (H, cfg.q_dim),
              "w_gateup": (2 * I, H), "w_down": (H, I), "lm_head": (V, H)}
    prompt_tokens, starts = pad_prompts(
        [list(np.random.default_rng(i).integers(0, V, n)) for i, n in
         enumerate(PROMPT_LENS)], 0)
    T = prompt_tokens.shape[1]
    S = cache_len_for(T, NEW_TOKENS)
    tok = torch.as_tensor(prompt_tokens, dtype=torch.long, device=dev)
    st = torch.as_tensor(starts, device=dev)

    # ---------------------------------------------------------------- 1
    t = time.time()
    libs = _build.build_all()
    log(f"phase 1: built {sorted(libs)} for sm_90a in {time.time() - t:.1f} s")
    for stem, path in libs.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line and " 0 bytes spill" not in line:
                log(f"  ptxas {stem}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    card = f"{torch.cuda.get_device_name(0)} ({smi})"

    # ---------------------------------------------------------------- 2
    g = torch.Generator(device=dev).manual_seed(0)
    sym_int4 = resolve_qtype("sym_int4")

    def qweight(O, K, copies=1):
        return [((torch.randint(0, 256, (O, K // 2), dtype=torch.uint8,
                                device=dev, generator=g)),
                 (torch.rand((O, K // 32), device=dev, generator=g) * 0.02
                  + 1e-3).to(torch.float16)) for _ in range(copies)]

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)

    errs = {k.name: 0.0 for k in kernels.KERNELS}
    for name, (O, K) in shapes.items():
        (data, scales), = qweight(O, K)
        for M in (1, 4, 32, 33, 1024):
            x = randn(M, K)
            y = kernels.qmatmul_int4(x, data, scales).float()
            ref = kernels.qmatmul_int4_plain(x, data, scales).float()
            err = (y - ref).abs().max().item()
            # f32 sums in another order, then one bf16 rounding on each
            # side: within 2 bf16 ULPs of the largest output
            tol = ref.abs().max().item() * 2 ** -7
            kname = (kernels.GEMV if M <= kernels.GEMV_MAX_ROWS else kernels.GEMM).name
            errs[kname] = max(errs[kname], err)
            log(f"phase 2: {kname} {name} M={M} O={O} K={K} max_abs_err={err:.6g} tol={tol:.6g}")
            check(bool(torch.isfinite(y).all()) and err <= tol, f"{kname} {name} M={M}")
    flash_cases = [("prefill", B, T, S, Hq, Hkv, D, 0, None, None),
                   ("window+softcap", 2, 128, 192, Hq, Hkv, D, 40, 64, 30.0),
                   ("head_dim 64", 2, 96, 128, 8, 2, 64, 0, None, None)]
    for label, b, t_, s, hq, hkv, d, qoff, win, cap in flash_cases:
        q, k, v = randn(b, t_, hq, d), randn(b, s, hkv, d), randn(b, s, hkv, d)
        start = torch.as_tensor((starts if label == "prefill" else
                                 np.arange(b, dtype=np.int32) * 37 % t_),
                                dtype=torch.int32, device=dev)
        y = kernels.flash_attention(q, k, v, start=start, q_offset=qoff,
                                    window=win, softcap=cap).float()
        ref = kernels.flash_attention_plain(q, k, v, start, qoff, win, cap).float()
        err = (y - ref).abs().max().item()
        # per element, as the CPU tests hold it: one bf16 rounding step of
        # each output (2^-7 relative) above a floor far below a ULP. A
        # bound scaled by the largest output would not see a dropped slot
        # in a row that averages hundreds of slots.
        within = bool(((y - ref).abs() <= 2 ** -7 * ref.abs() + 1e-5).all())
        rel = ((y - ref).abs() / (ref.abs() + 1e-5)).max().item()
        pad_rows = ~valid_mask(start, qoff, t_, s, win).any(-1)  # [b, t]
        zeros_ok = bool((y[pad_rows] == 0).all())
        errs[kernels.FLASH.name] = max(errs[kernels.FLASH.name], err)
        log(f"phase 2: flash {label} B={b} T={t_} S={s} Hq={hq} Hkv={hkv} D={d} "
            f"q_offset={qoff} window={win} softcap={cap} max_abs_err={err:.6g} "
            f"max_rel_err={rel:.6g} tol=2^-7*|ref|+1e-5 per element "
            f"pad_rows={int(pad_rows.sum())} exact_zero={zeros_ok}")
        check(bool(torch.isfinite(y).all()) and within and zeros_ok, f"flash {label}")
    torch.cuda.synchronize()

    # ---------------------------------------------------------------- 3
    t = time.time()
    model = optimize_model(llama.init_params(cfg, seed=0), cfg, "sym_int4")
    tm = TorchModel(cfg, model, "sym_int4")
    torch.cuda.synchronize()
    log(f"phase 3: llama3-8b {L} layers sym_int4 built in {time.time() - t:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB on the card")
    prompts = [list(row[s0:]) for row, s0 in zip(prompt_tokens, starts)]
    kernels.reset_launches()
    out1 = tm.generate(prompts, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    want = {kernels.GEMM.name: 4 * L,
            kernels.GEMV.name: 1 + (NEW_TOKENS - 1) * (4 * L + 1),
            kernels.FLASH.name: L}
    log(f"phase 3: launches {launches} expected {want}")
    check(launches == want, "launch counts of the main path")
    check(out1.shape == (B, NEW_TOKENS) and bool(((out1 >= 0) & (out1 < V)).all()),
          "generated tokens in the vocabulary")
    out2 = tm.generate(prompts, max_new_tokens=NEW_TOKENS)
    check(bool((out1 == out2).all()), "identical tokens on a second call")
    log(f"phase 3: greedy tokens (row 0) {out1[0].tolist()}; second call identical")

    cfg2 = dataclasses.replace(cfg, num_hidden_layers=2)
    m2 = optimize_model(llama.init_params(cfg2, seed=1), cfg2, "sym_int4")

    def prefill_logits():
        cache = dataclasses.replace(
            init_cache(2, B, S, Hkv, D, device=dev), start=st)
        with torch.inference_mode():
            return llama.forward(cfg2, m2, tok, cache, "prefill",
                                 last_logits_only=True)[0][:, -1]

    kern_logits = prefill_logits()
    with mock.patch.object(kernels, "qmatmul_int4", kernels.qmatmul_int4_plain), \
            mock.patch.object(kernels, "flash_attention", kernels.flash_attention_plain):
        plain_logits = prefill_logits()
    lerr = (kern_logits - plain_logits).abs().max().item()
    lscale = plain_logits.abs().max().item()
    # bf16 activations: a 1-ULP flip anywhere propagates through two
    # layers; 2% of the largest logit bounds it with room
    ltol = 0.02 * lscale
    same_top1 = bool((kern_logits.argmax(-1) == plain_logits.argmax(-1)).all())
    log(f"phase 3: 2-layer full-width prefill logits kernel vs plain: "
        f"max_abs_err={lerr:.6g} tol={ltol:.6g} max|logit|={lscale:.6g} "
        f"same_top1={same_top1}")
    check(bool(torch.isfinite(kern_logits).all()) and lerr <= ltol, "prefill logits")
    del m2

    # ---------------------------------------------------------------- 4
    rows = {}
    for name, (O, K) in shapes.items():
        copies = max(1, math.ceil(L2_COPIES_BYTES / (O * K * 0.5625)))
        ws = qweight(O, K, copies)
        dense = [dequantize_blockwise(d_, s_, sym_int4, torch.bfloat16)
                 for d_, s_ in ws[:max(1, copies // 2)]]
        for M in ((4,) if name == "lm_head" else (4, 1024)):
            x = randn(M, K)
            kern = time_ms(torch, lambda d_, s_: kernels.qmatmul_int4(x, d_, s_), ws)
            plain = time_ms(torch, lambda d_, s_: kernels.qmatmul_int4_plain(x, d_, s_), ws)
            lib = time_ms(torch, lambda w_: torch.matmul(x, w_.t()), [(w,) for w in dense])
            nbytes = M * K * 2 + O * K // 2 + O * K // 32 * 2 + M * O * 2
            bms, by = bound_ms(nbytes, 2.0 * M * O * K)
            rows[(name, M)] = (kern, plain, lib, bms, nbytes, 2.0 * M * O * K)
            log(f"phase 4: qmatmul {name} M={M} O={O} K={K} isolated_ms={kern:.5f} "
                f"plain_ms={plain:.5f} library_ms={lib:.5f} bound_ms={bms:.5f} ({by})")
        del ws, dense

    start = torch.as_tensor(starts, device=dev)
    mask = valid_mask(start, 0, T, S)
    f_bytes = (2 * B * T * Hq * D + 2 * B * S * Hkv * D) * 2 + 4 * B
    qkv = [(randn(B, T, Hq, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D))
           for _ in range(math.ceil(L2_COPIES_BYTES / f_bytes))]
    # the library call's GQA-expanded [B, H, S, D] operands, as many copies
    expanded = [(q_.transpose(1, 2),
                 *(t_.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2)
                   for t_ in (k_, v_))) for q_, k_, v_ in qkv]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    f_kern = time_ms(torch, lambda q_, k_, v_: kernels.flash_attention(
        q_, k_, v_, start=start), qkv)
    f_plain = time_ms(torch, lambda q_, k_, v_: kernels.flash_attention_plain(
        q_, k_, v_, start), qkv)
    f_lib = time_ms(torch, lambda q_, k_, v_: sdpa(q_, k_, v_, attn_mask=mask[:, None]),
                    expanded)
    del qkv, expanded
    f_flops = 4.0 * D * Hq * int(mask.sum())
    f_bms, f_by = bound_ms(f_bytes, f_flops)
    log(f"phase 4: flash B={B} T={T} S={S} Hq={Hq} Hkv={Hkv} D={D} live pairs "
        f"{int(mask.sum())} isolated_ms={f_kern:.5f} plain_ms={f_plain:.5f} "
        f"library_ms={f_lib:.5f} bound_ms={f_bms:.5f} ({f_by})")

    # the main path end to end: host clock around synchronized work
    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    gen_ms = sorted(wall_ms(lambda: tm.generate(prompts, NEW_TOKENS)) for _ in range(5))
    prefill_ms = sorted(wall_ms(lambda: tm.generate(prompts, 1)) for _ in range(5))
    torch.cuda.reset_peak_memory_stats()
    tm.generate(prompts, NEW_TOKENS)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    def prefill_state():
        cache = dataclasses.replace(init_cache(L, B, S, Hkv, D, device=dev), start=st)
        logits, cache = llama.forward(cfg, tm.params, tok, cache, "prefill",
                                      last_logits_only=True)
        return cache, logits[:, -1].argmax(-1)

    def step(cache, cur):
        logits, cache = llama.forward(cfg, tm.params, cur[:, None], cache, "decode")
        return cache, logits[:, -1].argmax(-1)

    with torch.inference_mode():
        step_ms = []
        state = prefill_state()
        torch.cuda.synchronize()
        for _ in range(S - T - 8):  # a decode step per free slot, 8 spare
            t0 = time.perf_counter()
            state = step(*state)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof_prefill:
            for _ in range(PROFILED_PREFILLS):
                state = prefill_state()
            torch.cuda.synchronize()
        for _ in range(3):
            state = step(*state)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            for _ in range(PROFILED_STEPS):
                state = step(*state)
            torch.cuda.synchronize()

    def device_events(prof_):
        # device-side events carry no CPU time: their self time is the card's
        return sorted((e for e in prof_.key_averages()
                       if e.self_cpu_time_total == 0 and e.self_device_time_total > 0),
                      key=lambda e: -e.self_device_time_total)

    dev_events = device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3 / PROFILED_STEPS
    step_ms.sort()
    step_med = step_ms[len(step_ms) // 2]
    log(f"phase 4: card {card}")
    log(f"phase 4: main path llama3-8b sym_int4 B={B} prompt bucket {T} "
        f"new tokens {NEW_TOKENS}: generate_ms median={gen_ms[2]:.3f} "
        f"min={gen_ms[0]:.3f} max={gen_ms[-1]:.3f} (n=5); prefill_ms (generate of "
        f"1 token) median={prefill_ms[2]:.3f} min={prefill_ms[0]:.3f} "
        f"max={prefill_ms[-1]:.3f} (n=5); tokens_per_s={B * NEW_TOKENS * 1e3 / gen_ms[2]:.1f}; "
        f"peak_mem_gib={peak_gib:.3f}")
    log(f"phase 4: decode step ms (B={B}, positions {T}..{S - 9}) median={step_med:.3f} "
        f"p80={step_ms[int(0.8 * len(step_ms))]:.3f} max={step_ms[-1]:.3f} "
        f"(n={len(step_ms)}); decode_tokens_per_s={B * 1e3 / step_med:.1f}")
    log(f"phase 4: profiled decode: device busy {busy_ms:.3f} ms per step = "
        f"{busy_ms / step_med:.3f} of the unprofiled median step")
    for e in dev_events[:6]:
        log(f"  {e.self_device_time_total / 1e3 / PROFILED_STEPS:8.3f} ms/step "
            f"{e.count // PROFILED_STEPS:5d} calls/step  {e.key[:90]}")
    pre_events = device_events(prof_prefill)
    log(f"phase 4: profiled prefill: device busy "
        f"{sum(e.self_device_time_total for e in pre_events) / 1e3 / PROFILED_PREFILLS:.3f} "
        f"ms per prefill")
    for e in pre_events[:6]:
        log(f"  {e.self_device_time_total / 1e3 / PROFILED_PREFILLS:8.3f} ms/prefill "
            f"{e.count // PROFILED_PREFILLS:5d} calls/prefill  {e.key[:90]}")

    def per_path(M, names, per_layer):
        """Sum of a row field over one main-path unit: per_layer x the
        four layer projections (+ the lm head at decode)."""
        return [sum(rows[(n, M)][i] * (per_layer if n != "lm_head" else 1)
                    for n in names) for i in range(6)]

    def on_path(window, kern, n_units, calls_per_unit):
        """One kernel's device time per main-path unit in a profiler
        window; fails unless the window holds exactly the expected calls."""
        evs = [e for e in window.key_averages()
               if f"namespace)::{device_fn[kern.name]}" in e.key
               and e.self_device_time_total > 0]
        calls = sum(e.count for e in evs)
        check(calls == n_units * calls_per_unit,
              f"{kern.name}: {calls} profiled calls, expected {n_units * calls_per_unit}")
        return sum(e.self_device_time_total for e in evs) / 1e3 / n_units

    device_fn = {kernels.GEMV.name: "gemv_kernel", kernels.GEMM.name: "gemm_kernel",
                 kernels.FLASH.name: "flash_kernel"}
    layer_names = ["wqkv", "wo", "w_gateup", "w_down"]
    entries = []
    for kern, unit, prof_, n, calls, (iso, plain, lib, _, nbytes, flops) in (
            (kernels.GEMV, f"one decode step at B={B}: {4 * L} layer projections + lm head",
             prof, PROFILED_STEPS, 4 * L + 1, per_path(4, layer_names + ["lm_head"], L)),
            (kernels.GEMM, f"one prefill at M={B * T}: {4 * L} layer projections",
             prof_prefill, PROFILED_PREFILLS, 4 * L, per_path(1024, layer_names, L)),
            (kernels.FLASH, f"one prefill: {L} layers at B={B} T={T} S={S}",
             prof_prefill, PROFILED_PREFILLS, L,
             [L * f_kern, L * f_plain, L * f_lib, 0, L * f_bytes, L * f_flops])):
        bms, by = bound_ms(nbytes, flops)
        entries.append({
            "name": kern.name, "route": "cuda", "source": kern.source,
            "replaces": kern.replaces, "launches": launches[kern.name],
            "max_abs_err": errs[kern.name], "ms": on_path(prof_, kern, n, calls),
            "isolated_ms": iso, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": lib, "per": unit})
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
