#!/usr/bin/env python3
"""Smoke run of bigdl_tpu_torch, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. build every CUDA kernel from csrc/ (one nvcc per source, in parallel)
   and print the card's name and power limit;
2. hold each kernel against its plain PyTorch version at the main paths'
   shapes: the sym_int4 dequant-matmul GEMV (M <= 32) and GEMM (M > 32) at
   every llama3-8b projection, flash attention at the prefill shape with
   ragged left padding, plus a window+softcap case and a head_dim-64 case;
   then the training kernels: the dequant dx at every projection and the
   lm head, the GEMM's LoRA epilogue at wo and w_down (all at M = 1024),
   and the trainable flash forward (+ logsumexp), dQ and dK/dV at B=1
   T=1024 and at a small GQA + left-pad + window case;
3. the generation path: llama3-8b at full width and depth (32 layers) with
   seeded random weights, `optimize_model(..., "sym_int4")`, greedy
   `TorchModel.generate` of 32 tokens for 4 ragged prompts — launch counts
   of every kernel, tokens in the vocabulary, the same tokens on a second
   call, and prefill logits of a 2-layer full-width model against the
   plain versions on the card;
4. generation times: each kernel's device time on the path itself (`ms`,
   from a `torch.profiler` window over two prefills and five decode
   steps); with CUDA events after warm-up and operands cycled through
   copies larger than the L2, each kernel at each path shape
   (`isolated_ms`) beside its plain version (`plain_ms`) and one PyTorch
   call computing the same function (`library_ms`, a yardstick the port
   never calls); the least time the card could take (`bound_ms`, from the
   H100 SXM data sheet); prefill ms, decode ms per token and peak memory;
5. the training path: QLoRA on the same llama3-8b sym_int4 base, rank 8
   on all seven projections, AdamW 1e-4 (optax.adamw's defaults), B=1
   T=1024, five steps after one warm-up — launch counts of every kernel,
   every loss finite, and a 2-layer full-width step's loss and LoRA
   gradients through the kernels against the plain versions on the card;
6. training times, as in 4: each new kernel on the path (a profiler
   window over two steps) and isolated at its path shapes beside its
   plain version, library call and bound; step ms, tokens/s, peak memory
   and the device's busy share of a step.

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
TRAIN_T, RANK, LR = 1024, 8, 1e-4  # bench.py child_train: B=1, T=1024, rank 8
TRAIN_STEPS, PROFILED_TRAIN_STEPS = 5, 2


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

    train_kernel_checks(torch, dev, cfg, shapes, errs, qweight, randn)
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
    want = {k.name: 0 for k in kernels.KERNELS}  # no training kernel runs here
    want.update({kernels.GEMM.name: 4 * L,
                 kernels.GEMV.name: 1 + (NEW_TOKENS - 1) * (4 * L + 1),
                 kernels.FLASH.name: L})
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
    del tm, model

    # ---------------------------------------------------------------- 5
    train_entries = train_phases(torch, dev, cfg, card, errs, qweight, randn)
    log(json.dumps({"kernels": entries + train_entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def train_kernel_checks(torch, dev, cfg, shapes, errs, qweight, randn) -> None:
    """Phase 2's training half: the dequant dx at every projection and the
    lm head, the LoRA epilogue GEMM at wo and w_down (M = TRAIN_T), and
    the trainable flash trio at B=1 T=TRAIN_T and a small GQA + left-pad +
    window case, each against its plain version; the largest errors go to
    `errs`."""
    from bigdl_tpu_torch.ops import kernels

    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_

    def lora_operands(M, O, K):
        return (randn(RANK, K) / RANK, randn(O, RANK) * 0.01,
                torch.full((M, RANK), 2.0, dtype=torch.bfloat16, device=dev))

    for name, (O, K) in shapes.items():
        (data, scales), = qweight(O, K)
        for M in ((33, TRAIN_T) if name == "wqkv" else (TRAIN_T,)):
            gr = randn(M, O)
            dx = kernels.qmatmul_dx(gr, data, scales).float()
            ref = kernels.qmatmul_dx_plain(gr, data, scales).float()
            err = (dx - ref).abs().max().item()
            # f32 sums in another order, one bf16 rounding on each side
            tol = ref.abs().max().item() * 2 ** -7
            errs[kernels.DX.name] = max(errs[kernels.DX.name], err)
            log(f"phase 2: {kernels.DX.name} {name} M={M} O={O} K={K} "
                f"max_abs_err={err:.6g} tol={tol:.6g}")
            check(bool(torch.isfinite(dx).all()) and err <= tol, f"dx {name} M={M}")
        if name in ("wo", "w_down"):
            x = randn(TRAIN_T, K)
            a, b_, gate = lora_operands(TRAIN_T, O, K)
            y = kernels.qmatmul_int4_lora(x, data, scales, a, b_, gate).float()
            ref = kernels.qmatmul_int4_lora_plain(x, data, scales, a, b_, gate).float()
            lift = (ref - kernels.qmatmul_int4_plain(x, data, scales).float()).abs().max().item()
            err = (y - ref).abs().max().item()
            # as the GEMM, plus xa * gate rounded to bf16 on each side
            tol = ref.abs().max().item() * 2 ** -7
            errs[kernels.LORA_GEMM.name] = max(errs[kernels.LORA_GEMM.name], err)
            log(f"phase 2: {kernels.LORA_GEMM.name} {name} M={TRAIN_T} O={O} K={K} "
                f"R={RANK} max_abs_err={err:.6g} tol={tol:.6g} epilogue_max={lift:.6g}")
            check(bool(torch.isfinite(y).all()) and err <= tol and lift > 0,
                  f"lora gemm {name}")

    for label, b, t_, hq, hkv, win, st in (
            ("train", 1, TRAIN_T, Hq, Hkv, None, (0,)),
            ("gqa+pad+window", 2, 160, 8, 2, 48, (0, 37))):
        q, k, v, do = randn(b, t_, hq, D), randn(b, t_, hkv, D), randn(b, t_, hkv, D), randn(b, t_, hq, D)
        start = torch.as_tensor(st, dtype=torch.int32, device=dev)
        out, lse = kernels.flash_train_fwd(q, k, v, start, win)
        rout, rlse = kernels.flash_attention_train_plain(q, k, v, start, win)
        delta = (do.float() * out.float()).sum(-1)
        grads = (kernels.flash_train_dq(q, k, v, start, do, lse, delta, win),
                 *kernels.flash_train_dkv(q, k, v, start, do, lse, delta, win))
        refs = kernels.flash_attention_train_bwd_plain(q, k, v, start, do, lse, delta, win)
        pad = rlse <= -1e29
        # out per element as the inference kernel is held; lse in f32 to
        # 1e-4; dq/dk/dv sum many signed terms: 4 bf16 ULPs of the largest
        # element and 1 % in the Frobenius norm
        out_ok = bool(((out.float() - rout.float()).abs()
                       <= 2 ** -7 * rout.float().abs() + 1e-5).all())
        lse_err = (lse[~pad] - rlse[~pad]).abs().max().item()
        pad_ok = bool((lse[pad] == -1e30).all() and (out[pad.any(-1)] == 0).all())
        out_err = (out.float() - rout.float()).abs().max().item()
        errs[kernels.FLASH_FWD.name] = max(errs[kernels.FLASH_FWD.name], out_err)
        log(f"phase 2: flash train fwd {label} B={b} T={t_} Hq={hq} Hkv={hkv} D={D} "
            f"window={win} start={st} max_abs_err={out_err:.6g} lse_err={lse_err:.3g} "
            f"pad_rows={int(pad.any(-1).sum())} exact_pad={pad_ok}")
        check(bool(torch.isfinite(out).all()) and out_ok and lse_err <= 1e-4 and pad_ok,
              f"flash train fwd {label}")
        for kern, gname, got, ref in ((kernels.FLASH_DQ, "dq", grads[0], refs[0]),
                                      (kernels.FLASH_DKV, "dk", grads[1], refs[1]),
                                      (kernels.FLASH_DKV, "dv", grads[2], refs[2])):
            err = (got.float() - ref.float()).abs().max().item()
            tol = 2 ** -6 * ref.float().abs().max().item()
            frob = ((got.float() - ref.float()).norm() / ref.float().norm()).item()
            errs[kern.name] = max(errs[kern.name], err)
            log(f"phase 2: flash train {gname} {label} max_abs_err={err:.6g} tol={tol:.6g} "
                f"rel_frobenius={frob:.3g}")
            check(bool(torch.isfinite(got).all()) and err <= tol and frob <= 1e-2,
                  f"flash train {gname} {label}")


def train_phases(torch, dev, cfg, card, errs, qweight, randn) -> list:
    """Phases 5 and 6: the QLoRA training path and its times. `errs`
    holds phase 2's kernel-vs-plain errors; `qweight` and `randn` make
    seeded operands on the card. Returns the `kernels` entries of the five
    training kernels."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch import optimize_model
    from bigdl_tpu_torch.models import llama
    from bigdl_tpu_torch.ops import kernels
    from bigdl_tpu_torch.quant import dequantize_blockwise, resolve_qtype
    from bigdl_tpu_torch.train import (adamw, init_lora, make_train_step,
                                       next_token_loss)

    sym_int4 = resolve_qtype("sym_int4")

    L, H, I, V = (cfg.num_hidden_layers, cfg.hidden_size,
                  cfg.intermediate_size, cfg.vocab_size)
    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    M = TRAIN_T  # rows of every projection: B=1 x T
    tokens = torch.as_tensor(np.random.default_rng(0).integers(1, V, (1, TRAIN_T + 1)),
                             dtype=torch.long, device=dev)
    mask = torch.ones((1, TRAIN_T + 1), dtype=torch.float32, device=dev)

    t = time.time()
    model = optimize_model(llama.init_params(cfg, seed=0, device=dev), cfg, "sym_int4")
    lora = init_lora(cfg, seed=1, rank=RANK, device=dev)
    step = make_train_step(cfg, llama.forward, adamw(lora, LR))
    torch.cuda.synchronize()
    log(f"phase 5: llama3-8b {L} layers sym_int4 + rank-{RANK} LoRA on 7 projections "
        f"built in {time.time() - t:.1f} s, {torch.cuda.memory_allocated() / 2**30:.3f} GiB")

    def timed_step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(model, lora, tokens, mask)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, loss.item()

    warm_ms, warm_loss = timed_step()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    runs = [timed_step() for _ in range(TRAIN_STEPS)]
    launches = kernels.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    per_step = {kernels.GEMM.name: 2 * L + 1, kernels.LORA_GEMM.name: 2 * L,
                kernels.FLASH_FWD.name: L, kernels.FLASH_DQ.name: L,
                kernels.FLASH_DKV.name: L,
                # every projection's dx but layer 0's wqkv, whose input
                # needs no gradient, plus the lm head's
                kernels.DX.name: 4 * L,
                kernels.GEMV.name: 0, kernels.FLASH.name: 0}
    want = {k: n * TRAIN_STEPS for k, n in per_step.items()}
    losses = [warm_loss] + [x for _, x in runs]
    log(f"phase 5: launches over {TRAIN_STEPS} steps {launches} expected {want}")
    log(f"phase 5: losses {losses}")
    check(launches == want, "launch counts of the training path")
    check(all(math.isfinite(x) for x in losses), "finite losses")

    # one 2-layer full-width step through the kernels against the same
    # step through the plain versions on the card
    cfg2 = dataclasses.replace(cfg, num_hidden_layers=2)
    m2 = optimize_model(llama.init_params(cfg2, seed=2, device=dev), cfg2, "sym_int4")
    lora2 = init_lora(cfg2, seed=3, rank=RANK, device=dev)
    with torch.no_grad():  # B != 0, so the A gradients are not all 0
        for pair in lora2.layers.values():
            pair["b"].copy_(torch.randn(pair["b"].shape, device=dev,
                                        generator=torch.Generator(device=dev).manual_seed(4)) * 0.01)

    def grads2():
        for prm in lora2.parameters():
            prm.grad = None
        loss = next_token_loss(cfg2, llama.forward, m2, lora2, tokens, mask)
        loss.backward()
        return loss.item(), {n: prm.grad.float() for n, prm in lora2.named_parameters()}

    kern_loss, kern_grads = grads2()
    plain = {"qmatmul_int4": kernels.qmatmul_int4_plain,
             "qmatmul_dx": kernels.qmatmul_dx_plain,
             "qmatmul_int4_lora": kernels.qmatmul_int4_lora_plain,
             "flash_train_fwd": kernels.flash_attention_train_plain,
             "flash_train_dq": kernels.flash_train_dq_plain,
             "flash_train_dkv": kernels.flash_train_dkv_plain}
    with mock.patch.multiple(kernels, **plain):
        plain_loss, plain_grads = grads2()
    # bf16 activations through two layers and back: the loss to 1e-3 of
    # itself, each adapter leaf to 5 % of its largest gradient
    worst = max(((kern_grads[n] - g).abs().max() / g.abs().max()).item()
                for n, g in plain_grads.items())
    log(f"phase 5: 2-layer full-width train step kernel vs plain: loss {kern_loss:.6f} "
        f"vs {plain_loss:.6f}; worst LoRA grad max_abs_err / max|grad| = {worst:.4g} "
        f"(tol 0.05) over {len(plain_grads)} leaves")
    check(abs(kern_loss - plain_loss) <= 1e-3 * abs(plain_loss) and worst <= 0.05,
          "2-layer train step, kernels vs plain")
    del m2, lora2, kern_grads, plain_grads

    # ---------------------------------------------------------------- 6
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for _ in range(PROFILED_TRAIN_STEPS):
            step(model, lora, tokens, mask)
        torch.cuda.synchronize()
    dev_events = sorted((e for e in prof.key_averages()
                         if e.self_cpu_time_total == 0 and e.self_device_time_total > 0),
                        key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3 / PROFILED_TRAIN_STEPS
    step_ms = sorted(ms for ms, _ in runs)
    med = step_ms[len(step_ms) // 2]
    log(f"phase 6: card {card}")
    log(f"phase 6: training path llama3-8b sym_int4 B=1 T={TRAIN_T} rank {RANK}: "
        f"step_ms median={med:.3f} min={step_ms[0]:.3f} max={step_ms[-1]:.3f} "
        f"(n={TRAIN_STEPS}; all {[round(x, 3) for x, _ in runs]}; warm-up {warm_ms:.3f}); "
        f"tokens_per_s={TRAIN_T * 1e3 / med:.1f}; peak_mem_gib={peak_gib:.3f}")
    log(f"phase 6: profiled training: device busy {busy_ms:.3f} ms per step = "
        f"{busy_ms / med:.3f} of the unprofiled median step")
    for e in dev_events[:10]:
        log(f"  {e.self_device_time_total / 1e3 / PROFILED_TRAIN_STEPS:8.3f} ms/step "
            f"{e.count // PROFILED_TRAIN_STEPS:5d} calls/step  {e.key[:90]}")

    def on_path(kern, match):
        evs = [e for e in prof.key_averages()
               if any(m in e.key for m in match) and e.self_device_time_total > 0]
        calls = sum(e.count for e in evs)
        want_calls = per_step[kern.name] * PROFILED_TRAIN_STEPS
        check(calls == want_calls, f"{kern.name}: {calls} profiled calls, expected {want_calls}")
        return sum(e.self_device_time_total for e in evs) / 1e3 / PROFILED_TRAIN_STEPS

    path_ms = {
        kernels.LORA_GEMM.name: on_path(kernels.LORA_GEMM, ("gemm_kernel<true", "gemm_kernel<(bool)1")),
        kernels.DX.name: on_path(kernels.DX, ("namespace)::dx_kernel",)),
        kernels.FLASH_FWD.name: on_path(kernels.FLASH_FWD, ("namespace)::fwd_kernel",)),
        kernels.FLASH_DQ.name: on_path(kernels.FLASH_DQ, ("namespace)::dq_kernel",)),
        kernels.FLASH_DKV.name: on_path(kernels.FLASH_DKV, ("namespace)::dkv_kernel",)),
    }
    del model, lora, step, prof

    # isolated, at each path shape, operands cycled past the L2
    shapes = {"wqkv": (cfg.q_dim + 2 * cfg.kv_dim, H), "wo": (H, cfg.q_dim),
              "w_gateup": (2 * I, H), "w_down": (H, I), "lm_head": (V, H)}
    # dx calls per step: layer 0's wqkv has none
    dx_calls = {"wqkv": L - 1, "wo": L, "w_gateup": L, "w_down": L, "lm_head": 1}
    sums = {k: [0.0] * 6 for k in path_ms}  # iso, plain, lib, nbytes, flops per step

    def add(kname, n, iso, plain_, lib, nbytes, flops):
        for i, val in enumerate((iso, plain_, lib, 0.0, nbytes, flops)):
            sums[kname][i] += n * val

    for name, (O, K) in shapes.items():
        copies = max(1, math.ceil(L2_COPIES_BYTES / (O * K * 0.5625)))
        ws = qweight(O, K, copies)
        dense = [dequantize_blockwise(d_, s_, sym_int4, torch.bfloat16)
                 for d_, s_ in ws[:max(1, copies // 2)]]
        gr = randn(M, O)
        kern = time_ms(torch, lambda d_, s_: kernels.qmatmul_dx(gr, d_, s_), ws)
        plain_ = time_ms(torch, lambda d_, s_: kernels.qmatmul_dx_plain(gr, d_, s_), ws)
        lib = time_ms(torch, lambda w_: torch.matmul(gr, w_), [(w,) for w in dense])
        nbytes = M * O * 2 + O * K // 2 + O * K // 32 * 2 + M * K * 2
        flops = 2.0 * M * O * K
        bms, by = bound_ms(nbytes, flops)
        add(kernels.DX.name, dx_calls[name], kern, plain_, lib, nbytes, flops)
        log(f"phase 6: dx {name} M={M} O={O} K={K} isolated_ms={kern:.5f} "
            f"plain_ms={plain_:.5f} library_ms={lib:.5f} bound_ms={bms:.5f} ({by})")
        if name in ("wo", "w_down"):
            x = randn(M, K)
            a, b_ = randn(RANK, K) / RANK, randn(O, RANK) * 0.01
            gate = torch.full((M, RANK), 2.0, dtype=torch.bfloat16, device=dev)
            kern = time_ms(torch, lambda d_, s_: kernels.qmatmul_int4_lora(
                x, d_, s_, a, b_, gate), ws)
            plain_ = time_ms(torch, lambda d_, s_: kernels.qmatmul_int4_lora_plain(
                x, d_, s_, a, b_, gate), ws)
            lib = time_ms(torch, lambda w_: torch.matmul(x, w_.t()) + torch.matmul(
                torch.matmul(x, a.t()) * 2.0, b_.t()), [(w,) for w in dense])
            nbytes = (M * K * 2 + O * K // 2 + O * K // 32 * 2 + RANK * K * 2
                      + O * RANK * 2 + M * RANK * 2 + M * O * 2)
            flops = 2.0 * M * O * K + 2.0 * M * K * RANK + 2.0 * M * RANK * O
            bms, by = bound_ms(nbytes, flops)
            add(kernels.LORA_GEMM.name, L, kern, plain_, lib, nbytes, flops)
            log(f"phase 6: lora gemm {name} M={M} O={O} K={K} R={RANK} isolated_ms={kern:.5f} "
                f"plain_ms={plain_:.5f} library_ms={lib:.5f} bound_ms={bms:.5f} ({by})")
        del ws, dense

    # flash trio at the training shape, one layer
    T = TRAIN_T
    start = torch.zeros((1,), dtype=torch.int32, device=dev)
    live = T * (T + 1) // 2  # causal (query, key) pairs per head
    io = 2 * T * Hq * D * 2 + 2 * T * Hkv * D * 2  # q, dO and k, v in bf16
    sets = []
    for _ in range(math.ceil(L2_COPIES_BYTES / io)):
        q, k, v, do = randn(1, T, Hq, D), randn(1, T, Hkv, D), randn(1, T, Hkv, D), randn(1, T, Hq, D)
        out, lse = kernels.flash_train_fwd(q, k, v, start)
        sets.append((q, k, v, do, lse, (do.float() * out.float()).sum(-1)))
    fwd_args = [st[:3] for st in sets]
    bwd_args = sets
    rows = {
        kernels.FLASH_FWD.name: (
            time_ms(torch, lambda q, k, v: kernels.flash_train_fwd(q, k, v, start), fwd_args),
            time_ms(torch, lambda q, k, v: kernels.flash_attention_train_plain(q, k, v, start),
                    fwd_args, iters=5),
            io + T * Hq * 4, 4.0 * D * Hq * live),  # q, k, v read; out, lse written
        kernels.FLASH_DQ.name: (
            time_ms(torch, lambda *a: kernels.flash_train_dq(*a[:3], start, *a[3:]), bwd_args),
            time_ms(torch, lambda *a: kernels.flash_train_dq_plain(*a[:3], start, *a[3:]),
                    bwd_args, iters=5),
            # q, k, v, dO, lse, delta read; dq written
            io + 2 * T * Hq * 4 + T * Hq * D * 2, 6.0 * D * Hq * live),
        kernels.FLASH_DKV.name: (
            time_ms(torch, lambda *a: kernels.flash_train_dkv(*a[:3], start, *a[3:]), bwd_args),
            time_ms(torch, lambda *a: kernels.flash_train_dkv_plain(*a[:3], start, *a[3:]),
                    bwd_args, iters=5),
            # q, k, v, dO, lse, delta read; dk, dv written
            io + 2 * T * Hq * 4 + 2 * T * Hkv * D * 2, 8.0 * D * Hq * live),
    }
    # the yardstick: SDPA over GQA-expanded K/V, forward, and forward +
    # backward (dq, dk and dv at once), whose difference is the backward
    sdpa = torch.nn.functional.scaled_dot_product_attention
    G = Hq // Hkv
    exp = [tuple(t_.repeat_interleave(r, dim=2).transpose(1, 2).contiguous().requires_grad_()
                 for t_, r in ((q, 1), (k, G), (v, G))) + (do.transpose(1, 2),)
           for q, k, v, do, _, _ in sets]
    lib_fwd = time_ms(torch, lambda q, k, v, do: sdpa(q, k, v, is_causal=True), exp)
    lib_fb = time_ms(torch, lambda q, k, v, do: torch.autograd.grad(
        sdpa(q, k, v, is_causal=True), (q, k, v), do), exp)
    lib = {kernels.FLASH_FWD.name: lib_fwd, kernels.FLASH_DQ.name: lib_fb - lib_fwd,
           kernels.FLASH_DKV.name: lib_fb - lib_fwd}
    for kname, (kern, plain_, nbytes, flops) in rows.items():
        add(kname, L, kern, plain_, lib[kname], nbytes, flops)
        bms, by = bound_ms(nbytes, flops)
        log(f"phase 6: {kname} B=1 T={T} Hq={Hq} Hkv={Hkv} D={D} per layer isolated_ms={kern:.5f} "
            f"plain_ms={plain_:.5f} library_ms={lib[kname]:.5f} bound_ms={bms:.5f} ({by})")
    log(f"phase 6: SDPA yardstick per layer: forward {lib_fwd:.5f} ms, forward+backward "
        f"{lib_fb:.5f} ms (the backward's time stands as library_ms of both dQ and dK/dV)")
    del sets, exp

    unit = f"one train step: B=1 T={TRAIN_T}, {L} layers, rank {RANK}"
    entries = []
    for kern in (kernels.FLASH_FWD, kernels.LORA_GEMM, kernels.DX, kernels.FLASH_DQ,
                 kernels.FLASH_DKV):
        iso, plain_, lib_, _, nbytes, flops = sums[kern.name]
        bms, by = bound_ms(nbytes, flops)
        entries.append({
            "name": kern.name, "route": "cuda", "source": kern.source,
            "replaces": kern.replaces, "launches": launches[kern.name],
            "max_abs_err": errs[kern.name], "ms": path_ms[kern.name],
            "isolated_ms": iso, "plain_ms": plain_, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_, "per": unit})
    return entries


if __name__ == "__main__":
    sys.exit(main())
