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
   T=1024 and at a small GQA + left-pad + window case; then the serving
   kernels: paged decode attention over bf16 and fp8 pages at the
   engine's decode shape (8 rows, pages of 64, ragged positions up to
   2047 over shuffled pages, an idle row; a window + softcap case) and the
   flash kernel's fp8 arm at the dense fp8 pool's prefill shape;
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
   and the device's busy share of a step;
7. the serving path: `serving.InferenceEngine` over llama3-8b sym_int4
   (32 layers) at `cli serve`'s defaults (8 slots, max_len 2048, pages of
   64) with 16 seeded requests (8 sharing a 1,024-token prefix, one of
   them taking the sub-page copy; 8 independent) through (a) a paged bf16
   pool — prefix hits, no page leaks, 32 paged launches a decode step —
   (b) a dense bf16 pool — no paged launch, first tokens as (a)'s beyond
   near-ties — (c) a paged pool too small for decode growth — preemption,
   tokens equal to an unpreempted run's — (d) a paged fp8 pool and (e) a
   dense fp8 pool (the flash fp8 arm); then 2-layer full-width engines
   through the kernels against the plain versions on the card;
8. serving times: requests/s, tokens/s, TTFT and decode-step quantiles
   and peak memory of (a); a profiled decode step at 8 rows of ~1,100
   live slots over bf16 and fp8 pages (busy share, the paged kernel's
   time on the path); the paged kernel and the flash fp8 arm isolated
   beside their plain versions, an SDPA yardstick and their bounds;
9. the other 15 weight formats (asym_int4, nf4, fp4, sym_int8, asym_int5,
   fp8_e4m3/e5m2, sym_int5, fp6, nf3, q2_k..q6_k): each format's weights
   made on the card (seeded N(0, 0.02^2) through the port's encoder), and
   at every llama3-8b projection and the lm head the GEMV (M = 1, 4, 32),
   the GEMM (33, 1024), the LoRA GEMM (wo, w_down; 1024, R = 8) and dx
   (1024) against their plain versions; then through `optimize_model` at
   32 layers nf4 and q4_k_m (q4_k body, q6_k lm head) generation as phase
   3 (exact launch counts per format, in-vocabulary and repeatable
   tokens) and nf4 QLoRA as phase 5 (five finite steps); then a 2-layer
   full-width model in each of the 15 formats and q4_k_m, prefill logits
   through the kernels against the plain versions;
10. per format: the prefill, decode step and generate ms of the nf4 and
   q4_k_m paths and the nf4 train step, busy shares and peak memory; each
   form isolated at its path shapes (GEMV M=4 over a decode step, GEMM
   M=1024 over a prefill, dx and the LoRA GEMM over a train step) beside
   its plain version, cuBLAS on the weight dequantized beforehand (not
   timed) and its bound.

The whole run takes about 400 s of command time on an H100, the kernel
builds included (the dequant sources build once per qtype, 32 libraries).
It prints one `{"kernels": [...]}` line (the dequant forms carry their
numbers per format under "by_format"), and as its last line
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
    from bigdl_tpu_torch.quant import QTensor
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
    log(f"phase 1: built {len(libs)} libraries from {sorted({s for s, _ in libs})} "
        f"(the dequant sources once per qtype) for sm_90a in {time.time() - t:.1f} s")
    for (stem, qtype), path in libs.items():
        # ptxas per kernel: registers, and spill stores/loads where not 0
        regs, spills = [], 0
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line:
                regs.append(int(line.split("Used ")[1].split(" registers")[0]))
            if "spill" in line:
                spills += sum(int(t) for t in line.split() if t.isdigit())
        log(f"  ptxas {stem}{'[' + qtype + ']' if qtype else ''}: {len(regs)} kernels, "
            f"registers {min(regs, default=0)}-{max(regs, default=0)}, spill bytes {spills}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    card = f"{torch.cuda.get_device_name(0)} ({smi})"

    # ---------------------------------------------------------------- 2
    g = torch.Generator(device=dev).manual_seed(0)

    def qweight(O, K, copies=1):
        """Random-but-valid sym_int4 weights on the card: random codes,
        scales in [1e-3, 0.021)."""
        return [QTensor(torch.randint(0, 256, (O, K // 2), dtype=torch.uint8,
                                      device=dev, generator=g),
                        (torch.rand((O, K // 32), device=dev, generator=g) * 0.02
                         + 1e-3).to(torch.float16), qtype="sym_int4")
                for _ in range(copies)]

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)

    errs = {k.name: 0.0 for k in kernels.KERNELS}
    for name, (O, K) in shapes.items():
        w, = qweight(O, K)
        for M in (1, 4, 32, 33, 1024):
            x = randn(M, K)
            y = kernels.qmatmul(x, w).float()
            ref = kernels.qmatmul_plain(x, w).float()
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
    serving_kernel_checks(torch, dev, cfg, errs, randn)
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
    with mock.patch.object(kernels, "qmatmul", kernels.qmatmul_plain), \
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
        ws = [(w,) for w in qweight(O, K, copies)]
        dense = [w.dequantize(torch.bfloat16) for w, in ws[:max(1, copies // 2)]]
        for M in ((4,) if name == "lm_head" else (4, 1024)):
            x = randn(M, K)
            kern = time_ms(torch, lambda w_: kernels.qmatmul(x, w_), ws)
            plain = time_ms(torch, lambda w_: kernels.qmatmul_plain(x, w_), ws)
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
    # ---------------------------------------------------------------- 7
    serving_entries = serving_phases(torch, dev, cfg, card, errs)
    # ---------------------------------------------------------------- 9
    by_format = format_phases(torch, dev, cfg, card, prompts, tok, st, T, S)
    for e in entries + train_entries:
        if e["name"] in by_format:  # the dequant forms: sym_int4 above, then the others
            e["formats"] = ["sym_int4"] + list(by_format[e["name"]])
            e["by_format"] = by_format[e["name"]]
    log(json.dumps({"kernels": entries + train_entries + serving_entries}))
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
        w, = qweight(O, K)
        for M in ((33, TRAIN_T) if name == "wqkv" else (TRAIN_T,)):
            gr = randn(M, O)
            dx = kernels.qmatmul_dx(gr, w).float()
            ref = kernels.qmatmul_dx_plain(gr, w).float()
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
            y = kernels.qmatmul_lora(x, w, a, b_, gate).float()
            ref = kernels.qmatmul_lora_plain(x, w, a, b_, gate).float()
            lift = (ref - kernels.qmatmul_plain(x, w).float()).abs().max().item()
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
    from bigdl_tpu_torch.train import (adamw, init_lora, make_train_step,
                                       next_token_loss)

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
                kernels.GEMV.name: 0, kernels.FLASH.name: 0,
                kernels.PAGED.name: 0, kernels.PAGED_FP8.name: 0,
                kernels.FLASH_FP8.name: 0}
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
    plain = {"qmatmul": kernels.qmatmul_plain,
             "qmatmul_dx": kernels.qmatmul_dx_plain,
             "qmatmul_lora": kernels.qmatmul_lora_plain,
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
        ws = [(w,) for w in qweight(O, K, copies)]
        dense = [w.dequantize(torch.bfloat16) for w, in ws[:max(1, copies // 2)]]
        gr = randn(M, O)
        kern = time_ms(torch, lambda w_: kernels.qmatmul_dx(gr, w_), ws)
        plain_ = time_ms(torch, lambda w_: kernels.qmatmul_dx_plain(gr, w_), ws)
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
            kern = time_ms(torch, lambda w_: kernels.qmatmul_lora(x, w_, a, b_, gate), ws)
            plain_ = time_ms(torch, lambda w_: kernels.qmatmul_lora_plain(x, w_, a, b_, gate), ws)
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


# ---------------------------------------------------------------------------
# serving: phase 2's checks of the serving kernels, phases 7 and 8
# ---------------------------------------------------------------------------

SLOTS, MAX_LEN, PAGE = 8, 2048, 64  # `cli serve`'s defaults, pages of 64
SERVE_NEW, PREFIX_LEN = 64, 1024
INDEP_LENS = (100, 1500, 420, 880, 260, 1210, 640, 1030)
FP8_DENSE_LEN, FP8_DENSE_NEW = 1000, 16  # engine (e): 4 requests
STEADY_LEN, PROFILED_DECODES = 1100, 5  # the decode-step profile: 8 rows
# The dense pool prefills through flash over a left-padded bucket, the
# paged pool through the masked plain attention, which rounds the softmax
# weights to bf16. Through 32 layers of bf16 activations that moves a
# first-token logprob by up to 0.125 nat (H100, this traffic), and both
# of the top two tokens can move by it: a greedy first token may differ
# only where the top-1/top-2 margin is within 0.25 nat.
MARGIN_TOL = 0.25
# kernels vs plain versions over two full-width layers (phase 7): bf16
# activations through two layers, 0.05 nat per chosen-token logprob. An
# fp8 pool quantizes K/V that already differ by a bf16 rounding, and a
# code that lands one e5m2 step over moves its element by a quarter of
# its value: twice the bound there.
LOGPROB_TOL = {False: 0.05, True: 0.1}  # by quantize_kv


def paged_operands(torch, dev, g, L, Hkv, D, pos, fp8):
    """A pool of L layers holding, per row, pages for slots [0, pos], in
    a shuffled (non-contiguous) order; the rest of each block table and a
    row at pos 0 (idle) point at the scratch page 0. Returns (pool k, v,
    k_scale, v_scale, block tables, pos, start, live slots)."""
    from bigdl_tpu_torch.kvcache import _quantize_heads

    mp = MAX_LEN // PAGE
    need = [p // PAGE + 1 if p > 0 else 0 for p in pos]
    NP = sum(need) + 1
    perm = (torch.randperm(NP - 1, device=dev, generator=g) + 1).tolist()
    bt = torch.zeros((len(pos), mp), dtype=torch.int32)
    for b, n in enumerate(need):
        bt[b, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        perm = perm[n:]
    ks = vs = None
    k = torch.randn((L, NP, PAGE, Hkv, D), device=dev, generator=g)
    v = torch.randn((L, NP, PAGE, Hkv, D), device=dev, generator=g)
    if fp8:
        (k, ks), (v, vs) = _quantize_heads(k, torch.float32), _quantize_heads(v, torch.float32)
    else:
        k, v = k.bfloat16(), v.bfloat16()
    i32 = dict(dtype=torch.int32, device=dev)
    live = sum(p + 1 for p in pos)
    return (k, v, ks, vs, bt.to(dev), torch.tensor(pos, **i32),
            torch.zeros((len(pos),), **i32), live)


def serving_kernel_checks(torch, dev, cfg, errs, randn) -> None:
    """Phase 2's serving half: the paged decode kernel (bf16 and fp8
    pages) at the engine's decode shape — llama3-8b heads, 8 rows, pages
    of 64, ragged positions up to 2047 over shuffled pages, an idle row —
    and a window + softcap case; the flash kernel's fp8 arm at the dense
    fp8 pool's prefill shape and a ragged window + softcap case; each
    against its plain version."""
    from bigdl_tpu_torch.kvcache import _quantize_heads
    from bigdl_tpu_torch.ops import kernels
    from bigdl_tpu_torch.ops.kernels.flash_attention import valid_mask

    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    g = torch.Generator(device=dev).manual_seed(11)
    pos = [2047, 1100, 64, 0, 1500, 5, 700, 1999]  # row 3 idle
    for fp8 in (False, True):
        kern = kernels.PAGED_FP8 if fp8 else kernels.PAGED
        for label, window, cap in (("decode", None, None), ("window+softcap", 300, 30.0)):
            k, v, ks, vs, bt, p, st, _ = paged_operands(torch, dev, g, 2, Hkv, D, pos, fp8)
            q = randn(len(pos), Hq, D)
            y = kernels.paged_attention(q, k, v, bt, 1, p, st, ks, vs, softcap=cap,
                                        window=window).float()
            ref = kernels.paged_attention_plain(q, k, v, bt, 1, p, st, ks, vs,
                                                softcap=cap, window=window).float()
            err = (y - ref).abs().max().item()
            # f32 math on both sides, one bf16 rounding: one bf16 step per
            # element (2^-7 relative) above a floor far below a ULP
            within = bool(((y - ref).abs() <= 2 ** -7 * ref.abs() + 1e-5).all())
            errs[kern.name] = max(errs[kern.name], err)
            log(f"phase 2: {kern.name} {label} B={len(pos)} Hq={Hq} Hkv={Hkv} D={D} "
                f"page={PAGE} pos={pos} window={window} softcap={cap} "
                f"max_abs_err={err:.6g} tol=2^-7*|ref|+1e-5 per element")
            check(bool(torch.isfinite(y).all()) and within, f"{kern.name} {label}")
    for label, b, t_, s_, qoff, st_, win, cap in (
            ("dense fp8 prefill", 1, 1024, 1024, 0, (24,), None, None),
            ("window+softcap", 2, 128, 192, 40, (0, 37), 64, 30.0)):
        q = randn(b, t_, Hq, D)
        k, ks = _quantize_heads(torch.randn((b, s_, Hkv, D), device=dev, generator=g) * 3)
        v, vs = _quantize_heads(torch.randn((b, s_, Hkv, D), device=dev, generator=g))
        start = torch.tensor(st_, dtype=torch.int32, device=dev)
        y = kernels.flash_attention(q, k, v, start=start, q_offset=qoff, window=win,
                                    softcap=cap, k_scale=ks, v_scale=vs).float()
        ref = kernels.flash_attention_plain(q, k, v, start, qoff, win, cap,
                                            k_scale=ks, v_scale=vs).float()
        err = (y - ref).abs().max().item()
        within = bool(((y - ref).abs() <= 2 ** -7 * ref.abs() + 1e-5).all())
        pad_rows = ~valid_mask(start, qoff, t_, s_, win).any(-1)
        zeros_ok = bool((y[pad_rows] == 0).all())
        errs[kernels.FLASH_FP8.name] = max(errs[kernels.FLASH_FP8.name], err)
        log(f"phase 2: {kernels.FLASH_FP8.name} {label} B={b} T={t_} S={s_} "
            f"q_offset={qoff} start={st_} window={win} softcap={cap} max_abs_err={err:.6g} "
            f"tol=2^-7*|ref|+1e-5 per element pad_rows={int(pad_rows.sum())} "
            f"exact_zero={zeros_ok}")
        check(bool(torch.isfinite(y).all()) and within and zeros_ok,
              f"flash fp8 {label}")


def serving_traffic(V: int) -> tuple[list, list]:
    """Phase 7's 16 seeded requests: 8 share a 1,024-token prefix (16 full
    pages) with tails of 5-200 tokens — tail 1 repeats the first 40
    tokens of tail 0 (120 tokens) and diverges, which takes the sub-page
    copy — and 8 independent prompts of 100-1,500 tokens; 64 new tokens
    each, greedy but for two sampled requests (temperature 0.8, top-p
    0.9) and one with repetition penalty 1.1. Returns (shared, independent)
    submit kwargs."""
    import numpy as np

    rng = np.random.default_rng(7)

    def toks(n):
        return rng.integers(1, V, n).tolist()

    prefix = toks(PREFIX_LEN)
    tails = [toks(120)]
    tails.append(tails[0][:40] + toks(30))
    tails += [toks(int(n)) for n in rng.integers(5, 201, 6)]
    shared = [dict(prompt=prefix + t, max_new_tokens=SERVE_NEW) for t in tails]
    indep = [dict(prompt=toks(n), max_new_tokens=SERVE_NEW) for n in INDEP_LENS]
    shared[3]["repetition_penalty"] = 1.1
    for r in (indep[1], indep[4]):
        r.update(do_sample=True, temperature=0.8, top_p=0.9)
    return shared, indep


def serving_phases(torch, dev, cfg, card, errs) -> list:
    """Phases 7 and 8: the serving engine on llama3-8b sym_int4 (32
    layers) at `cli serve`'s defaults, over both pools and both KV
    types, then its times. Returns the `kernels` entries of the paged
    kernel (bf16, fp8 pages) and the flash kernel's fp8 arm."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch import TorchModel, optimize_model
    from bigdl_tpu_torch.models import llama
    from bigdl_tpu_torch.ops import kernels
    from bigdl_tpu_torch.ops.kernels.paged_attention import _decoded as gathered
    from bigdl_tpu_torch.serving import InferenceEngine

    L, V = cfg.num_hidden_layers, cfg.vocab_size
    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    t = time.time()
    tm = TorchModel(cfg, optimize_model(llama.init_params(cfg, seed=0), cfg, "sym_int4"),
                    "sym_int4")
    torch.cuda.synchronize()
    log(f"phase 7: llama3-8b {L} layers sym_int4 built in {time.time() - t:.1f} s")
    shared, indep = serving_traffic(V)
    traffic = shared + indep

    def engine(**kw):
        return InferenceEngine(tm, n_slots=SLOTS, max_len=MAX_LEN, page_size=PAGE, **kw)

    def serve(eng, specs):
        """Submit all, step to idle; (requests, seconds, decode steps)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [eng.submit(**sp) for sp in specs]
        eng.run_until_idle()
        torch.cuda.synchronize()
        return reqs, time.perf_counter() - t0, eng.decode_step_seconds.count

    def finished(reqs, n_new, what):
        ok = all(r.finish_reason == "length" and len(r.out_tokens) == n_new
                 and all(0 <= x < V for x in r.out_tokens)
                 and all(math.isfinite(lp) for lp in r.out_logprobs) for r in reqs)
        check(ok, f"{what}: every request finishes 'length' with {n_new} in-vocabulary "
                  "tokens and finite logprobs")

    def margin(r, i):
        top = sorted(r.out_top_logprobs[i].values(), reverse=True)
        return top[0] - top[1]

    # (a) paged bf16, the main path; phase 8 reads its times -------------
    eng = engine(paged=True, logprobs_top_k=2)
    seen = {"ttft": [], "step": []}  # each observation of two histograms
    for key, hist in (("ttft", eng.ttft), ("step", eng.decode_step_seconds)):
        hist.observe = (lambda h, out: lambda x: (out.append(x), type(h).observe(h, x)))(
            hist, seen[key])
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    reqs_a, sec_a, steps_a = serve(eng, traffic)
    launches_a = kernels.launch_counts()
    peak_a = torch.cuda.max_memory_allocated() / 2**30
    log(f"phase 7 (a) paged bf16: {len(traffic)} requests in {sec_a:.3f} s, {steps_a} decode "
        f"steps, prefix_hits={eng.prefix_hits} prefix_partial_hits={eng.prefix_partial_hits} "
        f"reused={eng.prefix_tokens_reused} page_leaks={eng.page_leaks()} launches {launches_a}")
    finished(reqs_a, SERVE_NEW, "(a)")
    check(eng.prefix_hits >= 7 and eng.prefix_partial_hits >= 1, "(a) prefix hits")
    check(eng.page_leaks() == 0, "(a) page leaks after the drain")
    check(launches_a[kernels.PAGED.name] == L * steps_a,
          f"(a) paged launches = {L} x decode steps")
    check(launches_a[kernels.GEMM.name] > 0 and launches_a[kernels.GEMV.name] > 0,
          "(a) prefill GEMM and decode GEMV launched")
    del eng

    # (b) dense bf16, same requests ------------------------------------------
    kernels.reset_launches()
    eng = engine(logprobs_top_k=2)
    reqs_b, sec_b, steps_b = serve(eng, traffic)
    launches_b = kernels.launch_counts()
    finished(reqs_b, SERVE_NEW, "(b)")
    check(launches_b[kernels.PAGED.name] == launches_b[kernels.PAGED_FP8.name] == 0,
          "(b) no paged launches")
    same, ties, lp_err = [], [], 0.0
    for i, (ra, rb) in enumerate(zip(reqs_a, reqs_b)):
        if traffic[i].get("do_sample"):
            continue
        if ra.out_tokens[0] == rb.out_tokens[0]:
            same.append(i)
            lp_err = max(lp_err, abs(ra.out_logprobs[0] - rb.out_logprobs[0]))
        else:
            ties.append((i, round(margin(rb, 0), 5)))
            # the two tokens' logprobs in each pool, where both have them
            ta, tb = ra.out_tokens[0], rb.out_tokens[0]
            log(f"  request {i}: (a) {ra.out_top_logprobs[0]} (b) {rb.out_top_logprobs[0]} "
                f"tokens {ta} / {tb}")
    log(f"phase 7 (b) dense bf16: {sec_b:.3f} s, {steps_b} decode steps, first tokens equal "
        f"to (a) for greedy requests {same} (max first-token logprob diff {lp_err:.5f}), "
        f"differing (request, (b)'s top-1/top-2 margin) {ties}, tol {MARGIN_TOL}; "
        f"(b)'s first-token margins {[round(margin(r, 0), 4) for r in reqs_b]}")
    for i, m in ties:
        check(m <= MARGIN_TOL, f"(b) request {i}: first token differs from (a) at margin {m}")
    del eng

    # (c) preemption: a pool too small for decode growth ---------------------
    greedy = [dict(prompt=sp["prompt"], max_new_tokens=SERVE_NEW) for sp in indep]
    eng = engine(paged=True, logprobs_top_k=2)
    ref_c, _, _ = serve(eng, greedy)
    del eng
    # admission takes ceil(bucket / 64) pages a prompt, the bucket being
    # the prompt rounded up to 16; two spare pages cannot hold the growth
    adm = sum(-(-(-(-n // 16) * 16) // PAGE) for n in INDEP_LENS)
    n_pages = adm + 3
    eng = engine(paged=True, n_pages=n_pages)
    reqs_c, sec_c, _ = serve(eng, greedy)
    finished(reqs_c, SERVE_NEW, "(c)")
    ties = []
    for i, (rr, rc) in enumerate(zip(ref_c, reqs_c)):
        diff = [j for j, (x, y) in enumerate(zip(rr.out_tokens, rc.out_tokens)) if x != y]
        if diff:
            ties.append((i, diff[0], round(margin(rr, diff[0]), 5)))
            check(margin(rr, diff[0]) <= MARGIN_TOL, f"(c) request {i} differs at token {diff[0]}")
    log(f"phase 7 (c) paged bf16, n_pages={n_pages} ({adm} pages at admission + 2 spare + "
        f"scratch): {sec_c:.3f} s, preemptions={eng.preemptions} "
        f"resumes={eng.preemption_resumes} page_leaks={eng.page_leaks()}, tokens equal to "
        f"the default pool's for {len(greedy) - len(ties)}/{len(greedy)}, near-ties {ties}")
    check(eng.preemptions >= 1 and eng.page_leaks() == 0, "(c) preemption and page leaks")
    del eng

    # (d) paged fp8 ----------------------------------------------------------
    kernels.reset_launches()
    eng = engine(paged=True, quantize_kv=True)
    reqs_d, sec_d, steps_d = serve(eng, shared)
    launches_d = kernels.launch_counts()
    finished(reqs_d, SERVE_NEW, "(d)")
    log(f"phase 7 (d) paged fp8: {len(shared)} requests in {sec_d:.3f} s, {steps_d} decode "
        f"steps, prefix_hits={eng.prefix_hits} page_leaks={eng.page_leaks()} "
        f"launches {launches_d}")
    check(launches_d[kernels.PAGED_FP8.name] == L * steps_d
          and launches_d[kernels.PAGED.name] == 0, f"(d) paged fp8 launches = {L} x steps")
    check(eng.page_leaks() == 0, "(d) page leaks")
    del eng

    # (e) dense fp8: prefill through the flash kernel's fp8 arm ---------------
    rng = np.random.default_rng(8)
    fp8_specs = [dict(prompt=rng.integers(1, V, FP8_DENSE_LEN).tolist(),
                      max_new_tokens=FP8_DENSE_NEW) for _ in range(4)]
    kernels.reset_launches()
    eng = engine(quantize_kv=True)
    for sp in fp8_specs:
        eng.submit(**sp)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof_e:  # the admission step: 4 prefills
        eng.step()
        torch.cuda.synchronize()
    eng.run_until_idle()
    launches_e = kernels.launch_counts()
    log(f"phase 7 (e) dense fp8: 4 requests of {FP8_DENSE_LEN} tokens, launches {launches_e}")
    check(launches_e[kernels.FLASH_FP8.name] == 4 * L > 0, "(e) flash fp8 launches")
    del eng

    # 2 layers at full width: kernels on, then every kernel's plain version
    cfg2 = dataclasses.replace(cfg, num_hidden_layers=2)
    tm2 = TorchModel(cfg2, optimize_model(llama.init_params(cfg2, seed=5), cfg2, "sym_int4"),
                     "sym_int4")
    plain = {"qmatmul": kernels.qmatmul_plain,
             "flash_attention": kernels.flash_attention_plain,
             "paged_attention": kernels.paged_attention_plain}
    for kw in (dict(paged=True), dict(paged=True, quantize_kv=True), dict(quantize_kv=True)):
        def run2():
            e2 = InferenceEngine(tm2, n_slots=SLOTS, max_len=MAX_LEN, page_size=PAGE, **kw)
            rs = [e2.submit(**sp) for sp in shared[:4]]
            e2.run_until_idle()
            check(e2.page_leaks() == 0, f"2-layer {kw} page leaks")
            return [r.out_logprobs for r in rs], [r.out_tokens for r in rs]
        lk, tk = run2()
        with mock.patch.multiple(kernels, **plain):
            lp_, tp_ = run2()
        worst = 0.0
        for a, b_, ta, tb in zip(lk, lp_, tk, tp_):
            n = next((j for j, (x, y) in enumerate(zip(ta, tb)) if x != y), len(ta)) + 1
            worst = max(worst, max(abs(x - y) for x, y in zip(a[:n], b_[:n])))
        tol = LOGPROB_TOL[kw.get("quantize_kv", False)]
        log(f"phase 7: 2-layer full-width engine {kw}: chosen-token logprobs kernels vs "
            f"plain max_abs_err={worst:.5f} nat (tol {tol}, up to the first "
            f"differing token)")
        check(worst <= tol, f"2-layer engine {kw} kernels vs plain")
    del tm2

    # ---------------------------------------------------------------- 8
    # engine (a)'s run: throughput, TTFT, decode step, peak memory
    ntok = sum(len(r.out_tokens) for r in reqs_a)

    def q(xs, f):
        xs = sorted(xs)
        return xs[min(int(f * len(xs)), len(xs) - 1)] * 1e3

    log(f"phase 8: card {card}")
    log(f"phase 8: engine (a) paged bf16, {len(reqs_a)} requests, {SLOTS} slots: "
        f"{sec_a:.3f} s = {len(reqs_a) / sec_a:.3f} requests/s, {ntok} tokens = "
        f"{ntok / sec_a:.1f} generated tokens/s; TTFT ms median={q(seen['ttft'], .5):.3f} "
        f"p90={q(seen['ttft'], .9):.3f}; decode step ms median={q(seen['step'], .5):.3f} "
        f"p90={q(seen['step'], .9):.3f} (n={steps_a}); peak_mem_gib={peak_a:.3f}")

    def device_events(prof_):
        return [e for e in prof_.key_averages()
                if e.self_cpu_time_total == 0 and e.self_device_time_total > 0]

    def kernel_ms(prof_, names, want_calls, n_units):
        evs = [e for e in prof_.key_averages() if any(n in e.key for n in names)
               and e.self_device_time_total > 0]
        calls = sum(e.count for e in evs)
        check(calls == want_calls, f"{names[0]}: {calls} profiled calls, expected {want_calls}")
        return sum(e.self_device_time_total for e in evs) / 1e3 / n_units

    # the decode step at 8 rows of ~1,100 live slots, bf16 and fp8 pages
    entries = []
    rng = np.random.default_rng(9)
    steady = [rng.integers(1, V, STEADY_LEN + 13 * i).tolist() for i in range(SLOTS)]
    for fp8, kern, launches in ((False, kernels.PAGED, launches_a[kernels.PAGED.name]),
                                (True, kernels.PAGED_FP8, launches_d[kernels.PAGED_FP8.name])):
        eng = engine(paged=True, quantize_kv=fp8)
        for p_ in steady:
            eng.submit(p_, max_new_tokens=SERVE_NEW)
        for _ in range(4):
            eng.step()
        host = []
        for _ in range(10):
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        pos = list(eng._slot_pos)
        with profile(activities=acts) as prof:
            for _ in range(PROFILED_DECODES):
                eng.step()
            torch.cuda.synchronize()
        del eng
        busy = sum(e.self_device_time_total for e in device_events(prof)) / 1e3 / PROFILED_DECODES
        med = sorted(host)[len(host) // 2]
        flag = "true" if fp8 else "false"
        path = kernel_ms(prof, (f"paged_kernel<128, {flag}>", f"paged_kernel<128, (bool){int(fp8)}>"),
                         L * PROFILED_DECODES, PROFILED_DECODES)
        log(f"phase 8: decode step, {'fp8' if fp8 else 'bf16'} pages, 8 rows at pos {pos}: "
            f"host median {med:.3f} ms (n=10), device busy {busy:.3f} ms = {busy / med:.3f} "
            f"of the step; {kern.name} {path:.3f} ms a step on the path")
        for e in sorted(device_events(prof), key=lambda e: -e.self_device_time_total)[:6]:
            log(f"  {e.self_device_time_total / 1e3 / PROFILED_DECODES:8.3f} ms/step "
                f"{e.count // PROFILED_DECODES:5d} calls/step  {e.key[:90]}")

        # isolated, at these positions, layers cycled (each has its own pages)
        g = torch.Generator(device=dev).manual_seed(12)
        k, v, ks, vs, bt, p_t, st, live = paged_operands(torch, dev, g, L, Hkv, D, pos, fp8)
        qv = torch.randn((SLOTS, Hq, D), device=dev, generator=g).bfloat16()
        layers = [(layer,) for layer in range(L)]
        iso = time_ms(torch, lambda layer: kernels.paged_attention(
            qv, k, v, bt, layer, p_t, st, ks, vs), layers, iters=64)
        pl_ = time_ms(torch, lambda layer: kernels.paged_attention_plain(
            qv, k, v, bt, layer, p_t, st, ks, vs), layers, iters=8)
        # the yardstick: SDPA over views gathered (and decoded) beforehand,
        # GQA-expanded, masked to each row's live slots; the gather is not timed
        G = Hq // Hkv
        mask = (torch.arange(MAX_LEN, device=dev)[None, :] <= p_t[:, None].long())[:, None, None]
        views = []
        for layer in (0, 1):
            kd, vd = (gathered(x, sc, layer, bt.long()).bfloat16().repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
                      for x, sc in ((k, ks), (v, vs)))
            views.append((qv[:, :, None], kd, vd))
        lib = time_ms(torch, lambda q_, k_, v_: torch.nn.functional.scaled_dot_product_attention(
            q_, k_, v_, attn_mask=mask), views)
        del k, v, ks, vs, views
        per_slot = Hkv * D * (1 if fp8 else 2) * 2 + (Hkv * 4 * 2 if fp8 else 0)
        nbytes = live * per_slot + SLOTS * Hq * D * (4 + 2) + bt.numel() * 4 + SLOTS * 8
        flops = 4.0 * D * Hq * live
        bms, by = bound_ms(nbytes, flops)
        log(f"phase 8: {kern.name} per layer, 8 rows, {live} live slots: isolated_ms={iso:.5f} "
            f"plain_ms={pl_:.5f} library_ms={lib:.5f} (SDPA over a pre-gathered dense view, "
            f"gather not timed) bound_ms={bms:.5f} ({by}, {nbytes / 1e6:.2f} MB)")
        entries.append({
            "name": kern.name, "route": "cuda", "source": kern.source,
            "replaces": kern.replaces, "launches": launches,
            "max_abs_err": errs[kern.name], "ms": path, "isolated_ms": L * iso,
            "plain_ms": L * pl_, "bound_ms": L * bms, "bound_by": by, "library_ms": L * lib,
            "per": f"one decode step: {L} layers, 8 rows, {live} live slots"})

    # the flash fp8 arm at (e)'s prefill shape: B=1, bucket 1024, 24 pad slots
    T = -(-FP8_DENSE_LEN // 64) * 64
    st = torch.tensor([T - FP8_DENSE_LEN], dtype=torch.int32, device=dev)
    path = kernel_ms(prof_e, ("flash_kernel<128, true>", "flash_kernel<128, (bool)1>"),
                     4 * L, 4)
    from bigdl_tpu_torch.kvcache import _quantize_heads
    from bigdl_tpu_torch.ops.kernels.flash_attention import valid_mask

    g = torch.Generator(device=dev).manual_seed(13)
    io = T * Hq * D * 2 * 2 + 2 * T * Hkv * (D + 2)
    sets = []
    for _ in range(math.ceil(L2_COPIES_BYTES / io)):
        (kq, ksc), (vq, vsc) = (_quantize_heads(torch.randn((1, T, Hkv, D), device=dev,
                                                            generator=g)) for _ in range(2))
        sets.append((torch.randn((1, T, Hq, D), device=dev, generator=g).bfloat16(),
                     kq, vq, ksc, vsc))
    iso = time_ms(torch, lambda q_, k_, v_, a, b_: kernels.flash_attention(
        q_, k_, v_, start=st, k_scale=a, v_scale=b_), sets)
    pl_ = time_ms(torch, lambda q_, k_, v_, a, b_: kernels.flash_attention_plain(
        q_, k_, v_, st, k_scale=a, v_scale=b_), sets, iters=5)
    mask = valid_mask(st, 0, T, T)
    G = Hq // Hkv
    deq = [(q_.transpose(1, 2), *((x.float() * s_.float()[..., None]).bfloat16()
                                  .repeat_interleave(G, dim=2).transpose(1, 2)
                                  for x, s_ in ((k_, a), (v_, b_))))
           for q_, k_, v_, a, b_ in sets[:4]]
    lib = time_ms(torch, lambda q_, k_, v_: torch.nn.functional.scaled_dot_product_attention(
        q_, k_, v_, attn_mask=mask[:, None]), deq)
    del sets, deq
    live = int(mask.sum())
    nbytes, flops = io + 4, 4.0 * D * Hq * live
    bms, by = bound_ms(nbytes, flops)
    log(f"phase 8: {kernels.FLASH_FP8.name} per layer B=1 T=S={T} start={T - FP8_DENSE_LEN} "
        f"{live} live pairs: isolated_ms={iso:.5f} plain_ms={pl_:.5f} library_ms={lib:.5f} "
        f"(SDPA over K/V dequantized beforehand, not timed) bound_ms={bms:.5f} ({by}); "
        f"on the path {path:.3f} ms a prefill")
    entries.append({
        "name": kernels.FLASH_FP8.name, "route": "cuda", "source": kernels.FLASH_FP8.source,
        "replaces": kernels.FLASH_FP8.replaces, "launches": launches_e[kernels.FLASH_FP8.name],
        "max_abs_err": errs[kernels.FLASH_FP8.name], "ms": path, "isolated_ms": L * iso,
        "plain_ms": L * pl_, "bound_ms": L * bms, "bound_by": by, "library_ms": L * lib,
        "per": f"one dense fp8 prefill: {L} layers, B=1 T=S={T}"})
    return entries


# ---------------------------------------------------------------------------
# the other 15 weight formats: phases 9 and 10
# ---------------------------------------------------------------------------

FORMATS = ("asym_int4", "nf4", "fp4", "sym_int8", "asym_int5", "fp8_e4m3", "fp8_e5m2",
           "sym_int5", "fp6", "nf3", "q2_k", "q3_k", "q4_k", "q5_k", "q6_k")
FORMAT_PATHS = ("nf4", "q4_k_m")  # generation at full depth (q4_k body, q6_k head)
PLAIN_ITERS = 5  # timed calls of a plain version or library call (kernels: 20)


def qweight_of(torch, dev, qtype, O, K, seed):
    """Random-but-valid [O, K] fields of `qtype` made on the card: seeded
    N(0, 0.02^2) weights through the port's encoder (quant/numerics.py)."""
    from bigdl_tpu_torch.quant import quantize

    g = torch.Generator(device=dev).manual_seed(seed)
    return quantize(torch.randn((O, K), device=dev, generator=g) * 0.02, qtype)


def weight_bytes(w) -> int:
    return sum(t.numel() * t.element_size() for t in w.fields().values())


def format_phases(torch, dev, cfg, card, prompts, tok, st, T, S) -> dict:
    """Phases 9 and 10: every form of the 15 other formats against its
    plain version at every llama3-8b shape, nf4 and q4_k_m generation and
    nf4 QLoRA at full depth, 2-layer full-width models in every format,
    then each form's times per format. Returns {kernel name: {qtype:
    numbers}} for the `kernels` line."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch import TorchModel, optimize_model
    from bigdl_tpu_torch.kvcache import init_cache
    from bigdl_tpu_torch.models import llama
    from bigdl_tpu_torch.ops import kernels
    from bigdl_tpu_torch.quant.qtypes import split_mixed_qtype
    from bigdl_tpu_torch.train import adamw, init_lora, make_train_step

    L, H, I, V = (cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size,
                  cfg.vocab_size)
    Hkv, D = cfg.num_key_value_heads, cfg.head_dim_
    shapes = {"wqkv": (cfg.q_dim + 2 * cfg.kv_dim, H), "wo": (H, cfg.q_dim),
              "w_gateup": (2 * I, H), "w_down": (H, I), "lm_head": (V, H)}
    forms = (kernels.GEMV, kernels.GEMM, kernels.LORA_GEMM, kernels.DX)
    out = {k.name: {q: {"launches": 0, "max_abs_err": 0.0, "ms": None} for q in FORMATS}
           for k in forms}
    g = torch.Generator(device=dev).manual_seed(20)

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)

    def held(kern, qtype, got, ref, what):
        """got against the plain version's ref: finite, within 2 bf16 ULPs
        of the largest output (f32 sums in another order, one bf16
        rounding on each side)."""
        got, ref = got.float(), ref.float()
        err = (got - ref).abs().max().item()
        tol = ref.abs().max().item() * 2 ** -7
        check(bool(torch.isfinite(got).all()) and err <= tol,
              f"{kern.name} {qtype} {what}: max_abs_err {err} > tol {tol}")
        row = out[kern.name][qtype]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        return err, tol

    # ---------------------------------------------------------------- 9
    t0 = time.time()
    for qi, qtype in enumerate(FORMATS):
        for si, (name, (O, K)) in enumerate(shapes.items()):
            w = qweight_of(torch, dev, qtype, O, K, 100 * qi + si)
            worst = []
            for M in (1, 4, 32, 33, 1024):
                x = randn(M, K)
                kern = kernels.GEMV if M <= kernels.GEMV_MAX_ROWS else kernels.GEMM
                worst.append(held(kern, qtype, kernels.qmatmul(x, w), kernels.qmatmul_plain(x, w),
                                  f"{name} M={M}"))
            if name in ("wo", "w_down"):
                x, a, b_ = randn(TRAIN_T, K), randn(RANK, K) / RANK, randn(O, RANK) * 0.01
                gate = torch.full((TRAIN_T, RANK), 2.0, dtype=torch.bfloat16, device=dev)
                worst.append(held(kernels.LORA_GEMM, qtype, kernels.qmatmul_lora(x, w, a, b_, gate),
                                  kernels.qmatmul_lora_plain(x, w, a, b_, gate), f"{name} lora"))
            gr = randn(TRAIN_T, O)
            worst.append(held(kernels.DX, qtype, kernels.qmatmul_dx(gr, w),
                              kernels.qmatmul_dx_plain(gr, w), f"{name} dx"))
            log(f"phase 9: {qtype} {name} O={O} K={K} ({weight_bytes(w) / (O * K):.6g} B/weight): "
                f"GEMV M=1,4,32, GEMM M=33,1024{', LoRA GEMM M=1024 R=8' if name in ('wo', 'w_down') else ''}"
                f", dx M=1024: max_abs_err/tol {' '.join(f'{e:.3g}/{t_:.3g}' for e, t_ in worst)}")
            del w
    torch.cuda.synchronize()
    log(f"phase 9: every form of {len(FORMATS)} formats within 2 bf16 ULPs of its plain "
        f"version at every llama3-8b shape ({time.time() - t0:.1f} s)")

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def busy_ms(prof_, n):
        return sum(e.self_device_time_total for e in prof_.key_averages()
                   if e.self_cpu_time_total == 0 and e.self_device_time_total > 0) / 1e3 / n

    def kernel_path_ms(prof_, fn, n):
        return sum(e.self_device_time_total for e in prof_.key_averages()
                   if f"namespace)::{fn}" in e.key and e.self_device_time_total > 0) / 1e3 / n

    def wall_ms(fn):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t1) * 1e3

    # full depth: nf4 and q4_k_m generation
    for qtype in FORMAT_PATHS:
        body, head = split_mixed_qtype(qtype)
        head = head or body
        t0 = time.time()
        tm = TorchModel(cfg, optimize_model(llama.init_params(cfg, seed=0), cfg, qtype), qtype)
        torch.cuda.synchronize()
        log(f"phase 9: llama3-8b {L} layers {qtype} (body {body}, lm head {head}) built in "
            f"{time.time() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.3f} GiB on the card")
        kernels.reset_launches()
        out1 = tm.generate(prompts, max_new_tokens=NEW_TOKENS)
        torch.cuda.synchronize()
        launches, by_fmt = kernels.launch_counts(), kernels.format_launch_counts()
        want = {k.name: 0 for k in kernels.KERNELS}
        want.update({kernels.GEMM.name: 4 * L, kernels.FLASH.name: L,
                     kernels.GEMV.name: (NEW_TOKENS - 1) * 4 * L + NEW_TOKENS})
        want_fmt = {kernels.GEMM.name: {body: 4 * L}, kernels.LORA_GEMM.name: {},
                    kernels.DX.name: {}, kernels.GEMV.name: {body: (NEW_TOKENS - 1) * 4 * L}}
        want_fmt[kernels.GEMV.name][head] = want_fmt[kernels.GEMV.name].get(head, 0) + NEW_TOKENS
        log(f"phase 9: {qtype} launches {launches} by format {by_fmt}; expected {want} {want_fmt}")
        check(launches == want and by_fmt == want_fmt, f"{qtype} launch counts")
        check(out1.shape == (B, NEW_TOKENS) and bool(((out1 >= 0) & (out1 < V)).all()),
              f"{qtype} tokens in the vocabulary")
        out2 = tm.generate(prompts, max_new_tokens=NEW_TOKENS)
        check(bool((out1 == out2).all()), f"{qtype} identical tokens on a second call")
        for k in (kernels.GEMV, kernels.GEMM):
            for q, n in by_fmt[k.name].items():
                if q in out[k.name]:
                    out[k.name][q]["launches"] += n

        gen = sorted(wall_ms(lambda: tm.generate(prompts, NEW_TOKENS)) for _ in range(3))
        pre = sorted(wall_ms(lambda: tm.generate(prompts, 1)) for _ in range(3))
        torch.cuda.reset_peak_memory_stats()
        tm.generate(prompts, NEW_TOKENS)
        peak = torch.cuda.max_memory_allocated() / 2**30

        def prefill_state():
            cache = dataclasses.replace(init_cache(L, B, S, Hkv, D, device=dev), start=st)
            logits, cache = llama.forward(cfg, tm.params, tok, cache, "prefill",
                                          last_logits_only=True)
            return cache, logits[:, -1].argmax(-1)

        def step(cache, cur):
            logits, cache = llama.forward(cfg, tm.params, cur[:, None], cache, "decode")
            return cache, logits[:, -1].argmax(-1)

        with torch.inference_mode():
            state = prefill_state()
            steps = []
            for _ in range(24):
                t1 = time.perf_counter()
                state = step(*state)
                torch.cuda.synchronize()
                steps.append((time.perf_counter() - t1) * 1e3)
            with profile(activities=acts) as prof_pre:
                for _ in range(PROFILED_PREFILLS):
                    state = prefill_state()
                torch.cuda.synchronize()
            with profile(activities=acts) as prof_dec:
                for _ in range(PROFILED_STEPS):
                    state = step(*state)
                torch.cuda.synchronize()
        steps.sort()
        med = steps[len(steps) // 2]
        dec_busy, pre_busy = busy_ms(prof_dec, PROFILED_STEPS), busy_ms(prof_pre, PROFILED_PREFILLS)
        gemv_ms = kernel_path_ms(prof_dec, "gemv_kernel", PROFILED_STEPS)
        gemm_ms = kernel_path_ms(prof_pre, "gemm_kernel", PROFILED_PREFILLS)
        if body in out[kernels.GEMM.name]:
            out[kernels.GEMM.name][body]["ms"] = gemm_ms
        if body == head and body in out[kernels.GEMV.name]:
            out[kernels.GEMV.name][body]["ms"] = gemv_ms
        log(f"phase 10: card {card}")
        log(f"phase 10: {qtype} llama3-8b B={B} bucket {T}: generate_ms of {NEW_TOKENS} tokens "
            f"median={gen[1]:.3f} (n=3, {[round(x, 3) for x in gen]}); prefill_ms (generate of 1 "
            f"token) median={pre[1]:.3f} ({[round(x, 3) for x in pre]}); decode step ms "
            f"median={med:.3f} max={steps[-1]:.3f} (n={len(steps)}); peak_mem_gib={peak:.3f}")
        log(f"phase 10: {qtype} profiled: decode step device busy {dec_busy:.3f} ms = "
            f"{dec_busy / med:.3f} of the median step, GEMV {gemv_ms:.3f} ms of it "
            f"({4 * L} {body} + 1 {head} calls); prefill device busy {pre_busy:.3f} ms = "
            f"{pre_busy / pre[1]:.3f} of the 1-token generate, GEMM {gemm_ms:.3f} ms of it")
        del tm, state

    # full depth: QLoRA over an nf4 base
    t0 = time.time()
    model = optimize_model(llama.init_params(cfg, seed=0, device=dev), cfg, "nf4")
    lora = init_lora(cfg, seed=1, rank=RANK, device=dev)
    step_fn = make_train_step(cfg, llama.forward, adamw(lora, LR))
    tokens = torch.as_tensor(np.random.default_rng(0).integers(1, V, (1, TRAIN_T + 1)),
                             dtype=torch.long, device=dev)
    mask = torch.ones((1, TRAIN_T + 1), dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    log(f"phase 9: llama3-8b {L} layers nf4 + rank-{RANK} LoRA built in {time.time() - t0:.1f} s")

    def timed_step():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss = step_fn(model, lora, tokens, mask)
        torch.cuda.synchronize()
        return (time.perf_counter() - t1) * 1e3, loss.item()

    warm = timed_step()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    runs = [timed_step() for _ in range(TRAIN_STEPS)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches, by_fmt = kernels.launch_counts(), kernels.format_launch_counts()
    per_step = {kernels.GEMM.name: 2 * L + 1, kernels.LORA_GEMM.name: 2 * L,
                kernels.DX.name: 4 * L, kernels.FLASH_FWD.name: L,
                kernels.FLASH_DQ.name: L, kernels.FLASH_DKV.name: L}
    want = {k.name: per_step.get(k.name, 0) * TRAIN_STEPS for k in kernels.KERNELS}
    want_fmt = {k.name: ({"nf4": want[k.name]} if want[k.name] else {}) for k in forms}
    losses = [warm[1]] + [x for _, x in runs]
    log(f"phase 9: nf4 QLoRA launches over {TRAIN_STEPS} steps {launches} by format {by_fmt}; "
        f"losses {losses}")
    check(launches == want and by_fmt == want_fmt, "nf4 QLoRA launch counts")
    check(all(math.isfinite(x) for x in losses), "nf4 QLoRA finite losses")
    for k in forms:
        out[k.name]["nf4"]["launches"] += by_fmt[k.name].get("nf4", 0)
    with profile(activities=acts) as prof:
        for _ in range(PROFILED_TRAIN_STEPS):
            step_fn(model, lora, tokens, mask)
        torch.cuda.synchronize()
    step_ms = sorted(x for x, _ in runs)
    med = step_ms[len(step_ms) // 2]
    tbusy = busy_ms(prof, PROFILED_TRAIN_STEPS)
    out[kernels.DX.name]["nf4"]["ms"] = kernel_path_ms(prof, "dx_kernel", PROFILED_TRAIN_STEPS)
    out[kernels.LORA_GEMM.name]["nf4"]["ms"] = sum(
        e.self_device_time_total for e in prof.key_averages()
        if ("gemm_kernel<true" in e.key or "gemm_kernel<(bool)1" in e.key)
        and e.self_device_time_total > 0) / 1e3 / PROFILED_TRAIN_STEPS
    log(f"phase 10: nf4 QLoRA B=1 T={TRAIN_T} rank {RANK}: step_ms median={med:.3f} "
        f"({[round(x, 3) for x in step_ms]}; warm-up {warm[0]:.3f}); tokens_per_s="
        f"{TRAIN_T * 1e3 / med:.1f}; peak_mem_gib={peak:.3f}; device busy {tbusy:.3f} ms = "
        f"{tbusy / med:.3f} of the median step; dx {out[kernels.DX.name]['nf4']['ms']:.3f} ms, "
        f"LoRA GEMM {out[kernels.LORA_GEMM.name]['nf4']['ms']:.3f} ms of it")
    del model, lora, step_fn, prof

    # 2 layers at full width, every format and q4_k_m: kernels vs plain
    cfg2 = dataclasses.replace(cfg, num_hidden_layers=2)
    for qtype in FORMATS + ("q4_k_m",):
        m2 = optimize_model(llama.init_params(cfg2, seed=1), cfg2, qtype)

        def logits2():
            cache = dataclasses.replace(init_cache(2, B, S, Hkv, D, device=dev), start=st)
            with torch.inference_mode():
                return llama.forward(cfg2, m2, tok, cache, "prefill",
                                     last_logits_only=True)[0][:, -1].float()

        kernels.reset_launches()
        kern = logits2()
        launched = kernels.format_launch_counts()
        with mock.patch.object(kernels, "qmatmul", kernels.qmatmul_plain), \
                mock.patch.object(kernels, "flash_attention", kernels.flash_attention_plain):
            plain = logits2()
        err = (kern - plain).abs().max().item()
        tol = 0.02 * plain.abs().max().item()  # phase 3's tolerance
        same = bool((kern.argmax(-1) == plain.argmax(-1)).all())
        log(f"phase 9: 2-layer full-width {qtype} prefill logits kernels vs plain: "
            f"max_abs_err={err:.6g} tol={tol:.6g} same_top1={same} launches {launched}")
        check(bool(torch.isfinite(kern).all()) and err <= tol, f"2-layer {qtype} logits")
        for k in (kernels.GEMV, kernels.GEMM):
            for q, n in launched[k.name].items():
                if q in out[k.name]:
                    out[k.name][q]["launches"] += n
        del m2

    # ---------------------------------------------------------------- 10
    # each form per format, isolated at the path shapes, operands cycled
    # past the L2; summed over one decode step (GEMV, M=B: 4 layer
    # projections x L + the lm head), one prefill (GEMM, M=1024: 4 x L),
    # one train step (dx at M=1024: every projection x L but layer 0's
    # wqkv, + the lm head; LoRA GEMM: wo and w_down x L)
    dx_calls = {"wqkv": L - 1, "wo": L, "w_gateup": L, "w_down": L, "lm_head": 1}
    t0 = time.time()
    for qi, qtype in enumerate(FORMATS):
        sums = {k.name: [0.0] * 5 for k in forms}  # iso, plain, lib, nbytes, flops

        def add(kern, n, *vals):
            for i_, v_ in enumerate(vals):
                sums[kern.name][i_] += n * v_

        for si, (name, (O, K)) in enumerate(shapes.items()):
            w = qweight_of(torch, dev, qtype, O, K, 1000 + 100 * qi + si)
            wb = weight_bytes(w)
            copies = max(1, math.ceil(L2_COPIES_BYTES / wb))
            ws = [(w,)] + [(type(w)(qtype=w.qtype, **{f: t.clone() for f, t in w.fields().items()}),)
                           for _ in range(copies - 1)]
            dense = [(w_.dequantize(torch.bfloat16),) for w_, in ws[:max(1, copies // 2)]]
            n_layer = 1 if name == "lm_head" else L
            for M, kern in ((B, kernels.GEMV), (TRAIN_T, kernels.GEMM)):
                if kern is kernels.GEMM and name == "lm_head":
                    continue  # prefill keeps the last position only: the lm head runs the GEMV
                x = randn(M, K)
                add(kern, n_layer,
                    time_ms(torch, lambda w_: kernels.qmatmul(x, w_), ws),
                    time_ms(torch, lambda w_: kernels.qmatmul_plain(x, w_), ws, iters=PLAIN_ITERS),
                    time_ms(torch, lambda d_: torch.matmul(x, d_.t()), dense, iters=PLAIN_ITERS),
                    M * K * 2 + wb + M * O * 2, 2.0 * M * O * K)
            gr = randn(TRAIN_T, O)
            add(kernels.DX, dx_calls[name],
                time_ms(torch, lambda w_: kernels.qmatmul_dx(gr, w_), ws),
                time_ms(torch, lambda w_: kernels.qmatmul_dx_plain(gr, w_), ws, iters=PLAIN_ITERS),
                time_ms(torch, lambda d_: torch.matmul(gr, d_), dense, iters=PLAIN_ITERS),
                TRAIN_T * O * 2 + wb + TRAIN_T * K * 2, 2.0 * TRAIN_T * O * K)
            if name in ("wo", "w_down"):
                x, a, b_ = randn(TRAIN_T, K), randn(RANK, K) / RANK, randn(O, RANK) * 0.01
                gate = torch.full((TRAIN_T, RANK), 2.0, dtype=torch.bfloat16, device=dev)
                add(kernels.LORA_GEMM, L,
                    time_ms(torch, lambda w_: kernels.qmatmul_lora(x, w_, a, b_, gate), ws),
                    time_ms(torch, lambda w_: kernels.qmatmul_lora_plain(x, w_, a, b_, gate), ws,
                            iters=PLAIN_ITERS),
                    time_ms(torch, lambda d_: torch.matmul(x, d_.t()) + torch.matmul(
                        torch.matmul(x, a.t()) * 2.0, b_.t()), dense, iters=PLAIN_ITERS),
                    TRAIN_T * K * 2 + wb + RANK * K * 2 + O * RANK * 2 + TRAIN_T * RANK * 2
                    + TRAIN_T * O * 2,
                    2.0 * TRAIN_T * O * K + 2.0 * TRAIN_T * K * RANK + 2.0 * TRAIN_T * RANK * O)
            del w, ws, dense
        for kern, unit in ((kernels.GEMV, f"decode step M={B}"), (kernels.GEMM, f"prefill M={TRAIN_T}"),
                           (kernels.DX, f"train step M={TRAIN_T}"),
                           (kernels.LORA_GEMM, f"train step M={TRAIN_T} R={RANK}")):
            iso, plain_, lib, nbytes, flops = sums[kern.name]
            bms, by = bound_ms(nbytes, flops)
            out[kern.name][qtype].update(isolated_ms=iso, plain_ms=plain_, library_ms=lib,
                                         bound_ms=bms, bound_by=by, per=unit)
            log(f"phase 10: {kern.name} {qtype} per {unit}: isolated_ms={iso:.5f} "
                f"plain_ms={plain_:.5f} library_ms={lib:.5f} bound_ms={bms:.5f} ({by})")
    log(f"phase 10: per-format times taken in {time.time() - t0:.1f} s")
    return out


if __name__ == "__main__":
    sys.exit(main())
