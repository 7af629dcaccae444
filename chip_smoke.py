#!/usr/bin/env python3
"""Smoke run of bigdl_tpu_torch, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. build every CUDA kernel from csrc/ (one nvcc per source, in parallel),
   print each library's registers and spills, and for the tensor-core
   flash kernels (the training forward, dQ and dK/dV: `fwd_kernel`,
   `dq_kernel`, `dkv_kernel`; the prefill kernel's bf16 and fp8 arms:
   `flash_kernel`) and the dequant GEMM and dx of every format
   (`gemm_kernel`, `dx_kernel`, csrc/qtile.cuh) their registers, spill
   bytes (0 for the flash kernels and for the paths' formats sym_int4,
   nf4, q4_k and q6_k, or the run fails) and the HMMA/HGMMA instructions
   in their SASS (where cuobjdump is present); the same for the dW kernels
   (`dw_tma_kernel`, wgmma, and `dw_kernel`, mma.sync, for shapes TMA
   cannot read) and the paged decode kernel (`paged_split_kernel`): a
   spill there fails the run, and so does a `dw_tma_kernel` without HGMMA
   in its SASS; print the card's name and power limit;
2. hold each kernel against its plain PyTorch version at the main paths'
   shapes: the sym_int4 dequant-matmul GEMV (M <= 32) and GEMM (M > 32) at
   every llama3-8b projection; the GEMM, LoRA GEMM and dx at ragged M (33,
   255, 257, 1000, 4096) with O = 200, each launched twice (bit-equal) and
   with every third LoRA gate row zero (those rows bit-equal to the
   GEMM's); flash attention at the prefill shape with
   ragged left padding, plus a window+softcap case, a head_dim-64 case, a
   head_dim-256 case and a T=17 case at q_offset 100 whose window edge
   falls inside a key tile;
   then the training kernels: the dequant dx at every projection and the
   lm head, the GEMM's LoRA epilogue at wo and w_down (all at M = 1024),
   and the trainable flash forward (+ logsumexp), dQ and dK/dV at B=1
   T=1024, at a small GQA + left-pad + window case and at a head_dim-64
   case whose 8 q heads share one kv head (a cluster of 8) and whose pad
   covers a whole key tile (dQ of rows and dK/dV of keys before start
   exactly 0, and second dQ and dK/dV launches bit-equal to the first);
   then the serving
   kernels: paged decode attention over bf16 and fp8 pages at the
   engine's decode shape (8 rows, pages of 64, ragged positions up to
   2047 over shuffled pages, an idle row; a window + softcap case) and at
   the edges of its split over slots (chunk edges at page boundaries and
   inside pages of 96, a window that skips whole chunks, one-slot rows and
   rows without a valid slot, which must be exactly 0), each launched
   twice (bit-equal), and the
   flash kernel's fp8 arm at the dense fp8 pool's prefill shape, a window
   + softcap case, a case whose scales are all f16 subnormals (K/V of
   absmax < 1) and a head_dim-256 case; then the
   adapter kernels: the LoRA GEMV at wo and w_down (M = 1, 8, 32; R = 4,
   16, 128 and the widest R the eligibility rule admits; block-diagonal
   gates with a zero row, whose output must equal the plain GEMV's bits,
   and dense gates) and the LoRA GEMM at M = 1024, R = 32, 64, 128; then
   the weight gradient dW = g^T x at every unfused llama3-8b weight and
   the lm head (M = 1024), at M = 1, 33, 512 with O = 384, K = 320 and at
   M = 1, 63, 65, 1000 over aligned O and K (128 x 256 tiles with ragged
   edges), O and K not multiples of 8 and a base off 16 bytes, bf16 and
   f32 outputs, each launched twice (bit-equal), printing which of the two
   kernels (`dw_variant`) each case ran;
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
   plain version, library call and bound (the flash trio's library call,
   SDPA's forward and its backward alone, read as profiled device time,
   printed beside CUDA events around the calls); step ms, tokens/s, peak
   memory and the device's busy share of a step;
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
   time on the path: `paged_split_kernel`, one launch a layer, its
   partials merged by its own last block); the paged kernel and the flash
   fp8 arm isolated
   beside their plain versions, an SDPA yardstick and their bounds;
9. the other 15 weight formats (asym_int4, nf4, fp4, sym_int8, asym_int5,
   fp8_e4m3/e5m2, sym_int5, fp6, nf3, q2_k..q6_k): each format's weights
   made on the card (seeded N(0, 0.02^2) through the port's encoder), and
   at every llama3-8b projection and the lm head the GEMV (M = 1, 4, 32),
   the GEMM (33, 1024), the LoRA GEMM (wo, w_down; 1024, R = 8) and dx
   (1024) and the LoRA GEMV (wo, w_down; M = 8, R = 128) against their
   plain versions, and phase 2's ragged-M, relaunch and zero-gate checks of
   the GEMM, LoRA GEMM and dx; then through `optimize_model` at
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
   timed) and its bound;
11. serving with adapters: engine (f), the paged bf16 pool of phase 7 with
   an `AdapterRegistry` of four seeded adapters (ranks 4, 8, 16, 32, alpha
   2 rank, all seven projections, saved with `save_adapter` and loaded by
   the registry), over phase 7's 16 requests (4 base, 3 for each adapter;
   tenants share the prefix, so each namespace misses the others' pages;
   one sub-page copy leaves a 30-token adapter prefill, the GEMV form):
   page_leaks() == 0 with the pager's pages, the LoRA GEMV launched in
   every decode step with an adapter row (at wo and w_down where the
   eligibility rule takes 8 x the bucket's columns) and in no base-only
   step, base requests' greedy tokens as engine (a)'s beyond near-ties,
   greedy tokens repeatable on a second run; then (g), the dense pool with
   adapters gathered from host RAM, and a 2-layer full-width adapter
   engine through the kernels against the plain versions, under phase
   11's tenant assignment and a round-robin one (a rank-32 row in both
   waves), each with the logprob shift of every kernel family swapped
   alone for its plain version, in bf16 ULPs of the largest logit;
12. adapter serving times: requests/s, tokens/s, TTFT and decode-step
   quantiles and peak memory of (f) beside (a); a profiled decode step
   with 8 adapter rows (R = 128: busy share, the LoRA GEMV's time on the
   path); the LoRA GEMV isolated at M = 8, R = 128 beside its plain
   version, cuBLAS on the weight dequantized beforehand plus two
   torch.matmul (a yardstick the port never calls) and its bound;
13. the other training paths: on phase 5's base a DPO step (finite loss
   and aux) and one QLoRA step under remat=True and under
   fused_backward=False against the plain step (phase 5's tolerance;
   remat's peak memory lower; no dx launch without the fused backward);
   then the full fine-tune of llama3-8b in bf16 (full width and depth,
   the unfused layout, weights from a seed) with GaLore (rank 128, gap
   200, scale 0.25, lr 1e-3) at B=1 T=1024: a projector-refresh step,
   then five steps — 7 dW launches a layer and the lm head's, one of each
   flash-train kernel a layer, finite losses; a LISA step (2 active
   layers, SGD): the frozen layers bit-unchanged, the active ones moved;
   a 2-layer full-width step's loss and every weight gradient through the
   kernels against the plain versions on the card;
14. full fine-tune times: step ms (median of 5), tokens/s, the refresh
   step's ms, peak memory and the busy share of a step; the dW kernel's
   and the training flash kernels' device time on the path (a profiler
   window over two steps; every dW launch of the path is the wgmma
   `dw_tma_kernel`), and the dW kernel isolated at each path shape beside
   its plain version, cuBLAS g^T x (a yardstick the port never calls) and
   its bound.

The whole run takes about 460-510 s of command time on an H100 (the
host's speed moves it), the kernel builds included (the dequant sources
build once per qtype: 36 libraries in 80-90 s).
It prints one `{"kernels": [...]}` line (the dequant forms carry their
numbers per format under "by_format"), and as its last line
`{"ok": true, "device": {...}}`. Without a CUDA card, or without the
package beside it, it exits non-zero before printing either.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
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
PATH_FORMATS = ("sym_int4", "nf4", "q4_k", "q6_k")  # generation, training, q4_k_m
RAGGED_M = (33, 255, 257, 1000, 4096)
# the GEMM's launch (x in its steps' order, then the GEMM) and the LoRA
# GEMM's (its first pass, then the same two) in a profiler's kernel names
GEMM_EVENT = re.compile(r"namespace\)::(gemm|x_order)_kernel<([^<>]*, )?(false|\(bool\)0)>")
LORA_GEMM_EVENT = re.compile(r"lora_xa_tc_kernel|namespace\)::(gemm|x_order)_kernel<([^<>]*, )?(true|\(bool\)1)>")


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def device_kernels(prof) -> list:
    """The device events of a profiler window, largest first: events with
    device time and no CPU time (the card's own), less the optimizer's
    step annotation (`Optimizer.step#<class>.step`), a range over the
    kernels it encloses rather than a kernel of its own."""
    return sorted((e for e in prof.key_averages()
                   if e.self_cpu_time_total == 0 and e.self_device_time_total > 0
                   and not e.key.startswith("Optimizer.")),
                  key=lambda e: -e.self_device_time_total)


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


def ptxas_resources(report: str) -> dict:
    """{mangled kernel: [registers, spill bytes (stores + loads)]} from an
    nvcc -Xptxas -v report."""
    res, name = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "Function properties for" in line:
            name = line.split("Function properties for")[1].strip()
        elif name and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            res.setdefault(name, [0, 0])[1] = nums[1] + nums[2]  # after the stack frame
        elif name and "Used" in line and "registers" in line:
            res.setdefault(name, [0, 0])[0] = int(line.split("Used ")[1].split(" registers")[0])
    return res


def sass_mma_counts(lib: Path, ops=("HMMA", "HGMMA")) -> dict:
    """{mangled kernel: instructions in its SASS naming one of `ops` (the
    tensor cores' HMMA and HGMMA)} of one library, {} where cuobjdump is
    missing."""
    import shutil

    sass = {}
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if Path(tool).exists():
        fn = None
        for line in subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                                   text=True).stdout.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                sass[fn] = 0
            elif fn and any(op in line for op in ops):
                sass[fn] += 1
    return sass


def tc_kernel_report(lib: Path, names, label: str = "", sass=None) -> int:
    """Phase 1's lines for the tensor-core kernels `names` of one library:
    registers and spill bytes per instantiation from its ptxas report, and
    the HMMA/HGMMA instructions in each one's SASS where cuobjdump is
    present (`sass`: sass_mma_counts(lib), computed here when None).
    Returns the spill bytes of them all."""
    res = ptxas_resources(lib.with_suffix(".log").read_text())
    sass = sass_mma_counts(lib) if sass is None else sass
    spills = 0
    for mangled, (regs, spill) in sorted(res.items()):
        kname = next((n for n in names if n + "I" in mangled), None)
        if kname is None:
            continue
        # template arguments: Li128 -> 128, Lb1 -> true, Lb0 -> false
        targs = [{"Lb0": "false", "Lb1": "true", "f": "float"}.get(a, a[2:])
                 for a in mangled.split(kname + "I")[1].split("EE")[0].split("E")]
        hmma = sass.get(mangled, "not read (no cuobjdump)") if sass else "not read (no cuobjdump)"
        log(f"  ptxas {label}{kname}<{', '.join(targs)}>: registers {regs}, spill bytes {spill}, "
            f"HMMA/HGMMA in SASS {hmma}")
        spills += spill
    return spills


def device_ms(torch, fn, args_list, iters: int = 20) -> float:
    """Device time per call: the self device time of every kernel in a
    torch.profiler window over `iters` calls after 3 warm-up calls,
    cycling through `args_list` as time_ms does. Unlike CUDA events around
    the calls, it does not count the card waiting for the host."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(3):
        fn(*args_list[i % len(args_list)])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in device_kernels(prof)) / 1e3 / iters


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def tile_text(t) -> str:
    """A launch's tile (ops/kernels/qtile.py) for the timing lines."""
    return (f"tile {t.bm}x{t.bn} stages={t.stages} threads={t.threads} blocks={t.blocks} "
            f"waves={t.waves:.2f}")


def dequant_edge_checks(torch, dev, qtype, errs, w, randn) -> None:
    """The tensor-core GEMM, LoRA GEMM and dx over `w` (O = 200: an O edge
    inside a 128-wide tile, K = 2048) at ragged M (RAGGED_M): each within 2
    bf16 ULPs of the largest output of its plain version (f32 sums in
    another order, one rounding on each side), a second launch bit-equal
    to the first (no atomics), and rows whose LoRA gate is zero bit-equal
    to the GEMM's (the LoRA steps add exactly 0 after the same K walk).
    The largest errors go to `errs`."""
    from bigdl_tpu_torch.ops import kernels

    O, K = w.data.shape[0], 2048
    lines = []
    for M in RAGGED_M:
        x, gr = randn(M, K), randn(M, O)
        a, b_ = randn(RANK, K) / RANK, randn(O, RANK) * 0.1
        gate = torch.full((M, RANK), 2.0, dtype=torch.bfloat16, device=dev)
        gate[::3] = 0  # every third row a base row
        y = kernels.qmatmul(x, w)
        yl = kernels.qmatmul_lora(x, w, a, b_, gate)
        dx = kernels.qmatmul_dx(gr, w)
        for kern, got, ref in ((kernels.GEMM, y, kernels.qmatmul_plain(x, w)),
                               (kernels.LORA_GEMM, yl, kernels.qmatmul_lora_plain(x, w, a, b_, gate)),
                               (kernels.DX, dx, kernels.qmatmul_dx_plain(gr, w))):
            got, ref = got.float(), ref.float()
            err = (got - ref).abs().max().item()
            tol = ref.abs().max().item() * 2 ** -7
            errs[kern.name] = max(errs.get(kern.name, 0.0), err)
            check(bool(torch.isfinite(got).all()) and err <= tol,
                  f"{kern.name} {qtype} M={M} O={O}: max_abs_err {err} > tol {tol}")
            lines.append(f"{kern.name} M={M} {err:.3g}/{tol:.3g}")
        same = (torch.equal(y, kernels.qmatmul(x, w)) and torch.equal(dx, kernels.qmatmul_dx(gr, w))
                and torch.equal(yl, kernels.qmatmul_lora(x, w, a, b_, gate)))
        base = torch.equal(yl[::3], y[::3])
        check(same and base, f"{qtype} M={M}: second launches bit-equal {same}, "
                             f"zero-gate LoRA rows = GEMM bits {base}")
    log(f"phase {2 if qtype == 'sym_int4' else 9}: {qtype} GEMM, LoRA GEMM (R={RANK}, every third "
        f"gate row 0) and dx at ragged M, O={O} K={K}: max_abs_err/tol {'; '.join(lines)}; "
        f"second launches bit-equal, zero-gate rows = GEMM bits")


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
    from bigdl_tpu_torch.ops.kernels.qtile import gemm_tile
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
        res = ptxas_resources(path.with_suffix(".log").read_text())
        regs = [r for r, _ in res.values() if r]  # entries; device functions report none
        log(f"  ptxas {stem}{'[' + qtype + ']' if qtype else ''}: {len(regs)} kernels, "
            f"registers {min(regs, default=0)}-{max(regs, default=0)}, spill bytes "
            f"{sum(sp for _, sp in res.values())}")
    spills = tc_kernel_report(libs[("flash_backward", None)], ("fwd_kernel", "dq_kernel", "dkv_kernel"))
    spills += tc_kernel_report(libs[("flash_attention", None)], ("flash_kernel",))
    check(spills == 0, "a tensor-core flash kernel spills")
    # the dW kernels and the paged decode kernel: no spill; HGMMA (wgmma)
    # in the TMA-fed dW kernel
    spills = tc_kernel_report(libs[("dw_matmul", None)], ("dw_tma_kernel", "dw_kernel"))
    spills += tc_kernel_report(libs[("paged_attention", None)], ("paged_split_kernel",))
    check(spills == 0, "a dW or paged decode kernel spills")
    hgmma = {k: n for k, n in sass_mma_counts(libs[("dw_matmul", None)], ("HGMMA",)).items()
             if "dw_tma_kernel" in k}
    log(f"  dw_tma_kernel HGMMA in SASS: {sorted(hgmma.values()) if hgmma else 'not read (no cuobjdump)'}")
    check(all(n > 0 for n in hgmma.values()), "dw_tma_kernel: no HGMMA in its SASS")
    # the dequant GEMM and dx of every format (csrc/qtile.cuh), SASS read in
    # parallel; a spill in the paths' formats fails the run
    from concurrent.futures import ThreadPoolExecutor

    dequant = sorted(k for k in libs if k[0] in ("qmatmul", "qbackward"))
    with ThreadPoolExecutor(max_workers=8) as pool:
        sass = dict(zip(dequant, pool.map(lambda k: sass_mma_counts(libs[k]), dequant)))
    path_spills = 0
    for stem, qtype in dequant:
        sp = tc_kernel_report(libs[(stem, qtype)], ("gemm_kernel",) if stem == "qmatmul" else ("dx_kernel",),
                              label=f"[{qtype}] ", sass=sass[(stem, qtype)])
        path_spills += sp if qtype in PATH_FORMATS else 0
    check(path_spills == 0, f"a dequant GEMM or dx kernel of {PATH_FORMATS} spills")
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
    dequant_edge_checks(torch, dev, "sym_int4", errs, qweight(200, 2048)[0], randn)
    flash_cases = [("prefill", B, T, S, Hq, Hkv, D, 0, None, None),
                   ("window+softcap", 2, 128, 192, Hq, Hkv, D, 40, 64, 30.0),
                   ("head_dim 64", 2, 96, 128, 8, 2, 64, 0, None, None),
                   ("head_dim 256", 2, 70, 96, 4, 1, 256, 0, None, None),
                   ("T=17, q_offset, window across a key tile", 2, 17, 192, Hq, Hkv, D, 100, 50, None)]
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
    adapter_kernel_checks(torch, dev, shapes, errs, qweight, randn)
    dw_kernel_checks(torch, cfg, errs, randn)
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
                f"plain_ms={plain:.5f} library_ms={lib:.5f} bound_ms={bms:.5f} ({by})"
                + (f" {tile_text(gemm_tile(M, O, K, 'sym_int4'))}" if M > kernels.GEMV_MAX_ROWS else ""))
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

    dev_events = device_kernels(prof)
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
    pre_events = device_kernels(prof_prefill)
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
        window (the GEMM's: its x_order pass and the GEMM, two device
        kernels a launch); fails unless the window holds exactly the
        expected calls."""
        parts = 2 if kern is kernels.GEMM else 1
        evs = [e for e in window.key_averages()
               if device_fn[kern.name].search(e.key) and e.self_device_time_total > 0]
        calls = sum(e.count for e in evs)
        check(calls == n_units * calls_per_unit * parts,
              f"{kern.name}: {calls} profiled calls, expected {n_units * calls_per_unit * parts}")
        return sum(e.self_device_time_total for e in evs) / 1e3 / n_units

    device_fn = {kernels.GEMV.name: re.compile(r"namespace\)::gemv_kernel"), kernels.GEMM.name: GEMM_EVENT,
                 kernels.FLASH.name: re.compile(r"namespace\)::flash_kernel")}
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
    serving_entries, served = serving_phases(torch, dev, cfg, card, errs)
    # --------------------------------------------------------------- 11
    adapter_entries = adapter_phases(torch, dev, cfg, card, errs, served)
    del served
    # ---------------------------------------------------------------- 9
    by_format = format_phases(torch, dev, cfg, card, prompts, tok, st, T, S)
    # --------------------------------------------------------------- 13
    ft_entries = full_ft_phases(torch, dev, cfg, card, errs, randn)
    for e in entries + train_entries + adapter_entries:
        if e["name"] in by_format:  # the dequant forms: sym_int4 above, then the others
            e["formats"] = ["sym_int4"] + list(by_format[e["name"]])
            e["by_format"] = by_format[e["name"]]
    log(json.dumps({"kernels": entries + train_entries + serving_entries + adapter_entries
                    + ft_entries}))
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

    for label, b, t_, hq, hkv, D, win, st in (
            ("train", 1, TRAIN_T, Hq, Hkv, D, None, (0,)),
            ("gqa+pad+window", 2, 160, 8, 2, D, 48, (0, 37)),
            # a cluster of 8 q heads; row 1's pad covers the whole key tile 0
            ("G=8+pad covers a key tile", 2, 130, 8, 1, 64, 64, (0, 70))):
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
        # keys before start[b] are attended by no query, and queries before
        # it attend no key: their gradients are exactly 0; and no atomics:
        # a second launch gives the same bits
        zero_ok = all(bool((grads[1][i, :s0] == 0).all() and (grads[2][i, :s0] == 0).all())
                      for i, s0 in enumerate(st))
        dq_zero_ok = all(bool((grads[0][i, :s0] == 0).all()) for i, s0 in enumerate(st))
        dk2, dv2 = kernels.flash_train_dkv(q, k, v, start, do, lse, delta, win)
        same = torch.equal(dk2, grads[1]) and torch.equal(dv2, grads[2])
        dq_same = torch.equal(kernels.flash_train_dq(q, k, v, start, do, lse, delta, win), grads[0])
        log(f"phase 2: flash train dk/dv {label} keys before start exactly 0: {zero_ok}; "
            f"two launches bit-equal: {same}")
        log(f"phase 2: flash train dq {label} rows before start exactly 0: {dq_zero_ok}; "
            f"two launches bit-equal: {dq_same}")
        check(zero_ok and same, f"flash train dk/dv {label}: zeros before start, bit-equal relaunch")
        check(dq_zero_ok and dq_same, f"flash train dq {label}: zeros before start, bit-equal relaunch")


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
    from bigdl_tpu_torch.ops.kernels.qtile import dx_tile, gemm_tile
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
                kernels.FLASH_FP8.name: 0, kernels.LORA_GEMV.name: 0,
                kernels.DW.name: 0}
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
    dev_events = device_kernels(prof)
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

    def on_path(kern, match, parts=1):
        """Device time a step of the kernel's device functions (`parts` of
        them a launch: the LoRA GEMM's first pass, x_order and its GEMM)."""
        evs = [e for e in prof.key_averages()
               if match.search(e.key) and e.self_device_time_total > 0]
        calls = sum(e.count for e in evs)
        want_calls = per_step[kern.name] * PROFILED_TRAIN_STEPS * parts
        check(calls == want_calls, f"{kern.name}: {calls} profiled calls, expected {want_calls}")
        return sum(e.self_device_time_total for e in evs) / 1e3 / PROFILED_TRAIN_STEPS

    path_ms = {
        kernels.LORA_GEMM.name: on_path(kernels.LORA_GEMM, LORA_GEMM_EVENT, parts=3),
        kernels.DX.name: on_path(kernels.DX, re.compile(r"namespace\)::dx_kernel")),
        kernels.FLASH_FWD.name: on_path(kernels.FLASH_FWD, re.compile(r"namespace\)::fwd_kernel")),
        kernels.FLASH_DQ.name: on_path(kernels.FLASH_DQ, re.compile(r"namespace\)::dq_kernel")),
        kernels.FLASH_DKV.name: on_path(kernels.FLASH_DKV, re.compile(r"namespace\)::dkv_kernel")),
    }
    del lora, step, prof
    qlora_variant_checks(torch, dev, cfg, model, tokens, mask)
    del model

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
            f"plain_ms={plain_:.5f} library_ms={lib:.5f} bound_ms={bms:.5f} ({by}) "
            f"{tile_text(dx_tile(M, O, K, 'sym_int4'))}")
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
                f"plain_ms={plain_:.5f} library_ms={lib:.5f} bound_ms={bms:.5f} ({by}) "
                f"{tile_text(gemm_tile(M, O, K, 'sym_int4'))}")
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
    sdpa_ms = sdpa_train_yardstick(torch, [st_[:4] for st_ in sets], Hq // Hkv)
    lib_fwd, lib_bwd = sdpa_ms["fwd_device_ms"], sdpa_ms["bwd_device_ms"]
    lib = {kernels.FLASH_FWD.name: lib_fwd, kernels.FLASH_DQ.name: lib_bwd,
           kernels.FLASH_DKV.name: lib_bwd}
    for kname, (kern, plain_, nbytes, flops) in rows.items():
        add(kname, L, kern, plain_, lib[kname], nbytes, flops)
        bms, by = bound_ms(nbytes, flops)
        log(f"phase 6: {kname} B=1 T={T} Hq={Hq} Hkv={Hkv} D={D} per layer isolated_ms={kern:.5f} "
            f"plain_ms={plain_:.5f} library_ms={lib[kname]:.5f} bound_ms={bms:.5f} ({by})")
    log(f"phase 6: SDPA yardstick per layer, profiled device time (library_ms): forward "
        f"{lib_fwd:.5f} ms, backward {lib_bwd:.5f} ms (dq, dk and dv at once: library_ms of both "
        f"dQ and dK/dV); CUDA events around the calls: forward {sdpa_ms['fwd_event_ms']:.5f}, "
        f"backward {sdpa_ms['bwd_event_ms']:.5f}")
    del sets

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


def sdpa_train_yardstick(torch, sets, G: int) -> dict:
    """SDPA at the training flash kernels' shapes, a yardstick the port
    never calls: its forward, and its backward alone (dq, dk and dv at
    once, over a graph the forward built beforehand), each as profiled
    device time (`device_ms`, which host load cannot move) and as CUDA
    events around the calls. `sets`: (q, k, v, dO) in the model's layout,
    K/V GQA-expanded here; copies cycled past the L2."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    exp = [tuple(t_.repeat_interleave(r, dim=2).transpose(1, 2).contiguous().requires_grad_()
                 for t_, r in ((q, 1), (k, G), (v, G))) + (do.transpose(1, 2),)
           for q, k, v, do in sets]
    res = {"fwd_event_ms": time_ms(torch, lambda q, k, v, do: sdpa(q, k, v, is_causal=True), exp),
           "fwd_device_ms": device_ms(torch, lambda q, k, v, do: sdpa(q, k, v, is_causal=True), exp)}
    graphs = [(sdpa(q, k, v, is_causal=True), q, k, v, do) for q, k, v, do in exp]

    def bwd(o, q, k, v, do):
        return torch.autograd.grad(o, (q, k, v), do, retain_graph=True)

    res["bwd_event_ms"] = time_ms(torch, bwd, graphs)
    res["bwd_device_ms"] = device_ms(torch, bwd, graphs)
    return res


def qlora_variant_checks(torch, dev, cfg, model, tokens, mask) -> None:
    """Phase 13's QLoRA half, on phase 5's llama3-8b sym_int4 base at
    B=1 T=TRAIN_T: a DPO step (finite loss and aux), and one step under
    remat=True and under fused_backward=False against the plain step —
    the loss and the LoRA gradients with phase 5's kernels-vs-plain
    tolerance (1e-3 of the loss, 5 % of each leaf's largest gradient);
    remat's peak memory below the plain step's; no dx kernel launch under
    fused_backward=False."""
    import numpy as np

    from bigdl_tpu_torch.models import llama
    from bigdl_tpu_torch.ops import kernels
    from bigdl_tpu_torch.train import adamw, init_lora, make_dpo_step, make_train_step

    def adapters(seed):
        lo = init_lora(cfg, seed=seed, rank=RANK, device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        with torch.no_grad():  # B != 0: the policy is not the reference
            for pair in lo.layers.values():
                pair["b"].copy_(torch.randn(pair["b"].shape, device=dev, generator=gen) * 0.01)
        return lo

    lora = adapters(20)
    rejected = torch.as_tensor(np.random.default_rng(21).integers(1, cfg.vocab_size, tokens.shape),
                               dtype=torch.long, device=dev)
    rejected[:, :TRAIN_T // 2] = tokens[:, :TRAIN_T // 2]  # a shared prompt
    cmask = mask.clone()
    cmask[:, :TRAIN_T // 2] = 0.0  # only the completions count
    t0 = time.perf_counter()
    loss, aux = make_dpo_step(cfg, llama.forward, adamw(lora, LR), beta=0.1)(
        model, lora, tokens, cmask, rejected, cmask)
    vals = {"loss": loss.item(), **{k: v.item() for k, v in aux.items()}}
    log(f"phase 13: DPO step on the llama3-8b sym_int4 base (B=1, T={TRAIN_T}, prompt "
        f"{TRAIN_T // 2} shared, beta 0.1, rank {RANK}) in {(time.perf_counter() - t0) * 1e3:.1f} ms: "
        + ", ".join(f"{k}={v:.6g}" for k, v in vals.items()))
    check(all(math.isfinite(v) for v in vals.values()), "DPO step: finite loss and aux")
    del lora

    def step_grads(**kw):
        lo = adapters(22)
        step = make_train_step(cfg, llama.forward, torch.optim.SGD(lo.parameters(), lr=0.0), **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        loss_ = step(model, lo, tokens, mask).item()
        torch.cuda.synchronize()
        return (loss_, {n: p_.grad.float() for n, p_ in lo.named_parameters()},
                torch.cuda.max_memory_allocated() / 2**30, kernels.launch_counts())

    base_loss, base_grads, base_peak, base_launch = step_grads()
    for label, kw in (("remat=True", {"remat": True}),
                      ("fused_backward=False", {"fused_backward": False})):
        loss_, grads, peak, launch = step_grads(**kw)
        worst = max(((grads[n] - g_).abs().max() / g_.abs().max()).item()
                    for n, g_ in base_grads.items())
        log(f"phase 13: QLoRA step {label} vs the plain step: loss {loss_:.6f} vs {base_loss:.6f}; "
            f"worst LoRA grad max_abs_err / max|grad| = {worst:.4g} (tol 0.05); peak "
            f"{peak:.3f} GiB vs {base_peak:.3f}; GEMM launches {launch[kernels.GEMM.name]} vs "
            f"{base_launch[kernels.GEMM.name]}, dx {launch[kernels.DX.name]} vs "
            f"{base_launch[kernels.DX.name]}")
        check(abs(loss_ - base_loss) <= 1e-3 * abs(base_loss) and worst <= 0.05,
              f"QLoRA step {label} against the plain step")
        if kw.get("remat"):
            check(peak < base_peak, "remat=True lowers the step's peak memory")
        else:
            check(launch[kernels.DX.name] == 0 and base_launch[kernels.DX.name] > 0,
                  "fused_backward=False launches no dx kernel")


# the full fine-tune (phases 13 and 14): GaLore's published LLaMA settings
# (rank 128, projector refresh every 200 steps, scale 0.25), no weight
# decay, lr 1e-3; LISA with 2 active layers, one SGD step at lr 1 (a check
# of the masking: at bf16 a smaller step rounds away at most elements)
FT_RANK, FT_GAP, FT_SCALE, FT_LR = 128, 200, 0.25, 1e-3
LISA_ACTIVE, LISA_LR = 2, 1.0


def dw_shapes(cfg) -> dict:
    """{(O, K): dW calls per full fine-tune step} over the unfused
    projections of every layer and the lm head."""
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    calls: dict = {}
    for O, K in ((cfg.q_dim, H), (cfg.kv_dim, H), (cfg.kv_dim, H), (H, cfg.q_dim),
                 (I, H), (I, H), (H, I)):
        calls[(O, K)] = calls.get((O, K), 0) + L
    calls[(cfg.vocab_size, H)] = calls.get((cfg.vocab_size, H), 0) + 1
    return calls


# dW's ragged cases (M, O, K, g's base 2 bytes off 16): 128 x 256 tiles
# with ragged edges, O and K not multiples of 8, a misaligned base — the
# last two take the mma.sync kernel
DW_EDGE_CASES = [(M, O, K, skew) for O, K, skew in ((384, 320, False), (200, 136, False),
                                                    (385, 321, False), (384, 320, True))
                 for M in (1, 63, 65, 1000)]


def dw_kernel_checks(torch, cfg, errs, randn) -> None:
    """Phase 2's dW half: dW = g^T x against its plain version at every
    unfused llama3-8b weight at M = TRAIN_T, at tests/test_qbackward.py's
    shapes (M = 1, 33, 512; O = 384, K = 320) and at DW_EDGE_CASES, bf16
    and f32 outputs: f32 sums in another order and one rounding on each
    side, within 2 bf16 ULPs of each shape's largest output; a second
    launch gives the same bits (no atomics, no split of M). Each line names
    the kernel the case ran (`dw_variant`)."""
    from bigdl_tpu_torch.ops import kernels
    from bigdl_tpu_torch.ops.kernels.dw_matmul import dw_variant

    cases = ([(TRAIN_T, O, K, False) for O, K in dw_shapes(cfg)]
             + [(M, 384, 320, False) for M in (1, 33, 512)] + DW_EDGE_CASES)
    for M, O, K, skew in cases:
        g_, x_ = randn(M, O), randn(M, K)
        if skew:  # the same values from a base 2 bytes past a 16-byte boundary
            g_ = torch.empty(M * O + 1, dtype=g_.dtype, device=g_.device)[1:].view(M, O).copy_(g_)
        variant = dw_variant(O, K, g_.data_ptr(), x_.data_ptr())
        for out_dtype in (torch.bfloat16, torch.float32):
            dw = kernels.dw_matmul(g_, x_, out_dtype)
            same = torch.equal(dw, kernels.dw_matmul(g_, x_, out_dtype))
            dw = dw.float()
            ref = kernels.dw_matmul_plain(g_, x_, out_dtype).float()
            err = (dw - ref).abs().max().item()
            tol = ref.abs().max().item() * 2 ** -7
            errs[kernels.DW.name] = max(errs[kernels.DW.name], err)
            log(f"phase 2: {kernels.DW.name} [{variant}] M={M} O={O} K={K} base_skew={skew} out "
                f"{str(out_dtype)[6:]} max_abs_err={err:.6g} tol={tol:.6g} relaunch bit-equal {same}")
            check(bool(torch.isfinite(dw).all()) and err <= tol and same,
                  f"dw_matmul [{variant}] M={M} O={O} K={K} skew={skew}")
        del g_, x_, dw, ref


def full_ft_phases(torch, dev, cfg, card, errs, randn) -> list:
    """Phases 13 and 14: the full fine-tune of llama3-8b in bf16 (full
    width and depth, init_params' unfused layout, weights from a seed)
    with GaLore at B=1 T=TRAIN_T — one projector-refresh step, then
    TRAIN_STEPS steps whose launches must be 7 dW a layer and the lm
    head's and one of each flash-train kernel a layer; a LISA step; a
    2-layer full-width step through the kernels against the plain
    versions; then the times. Returns the dW kernel's `kernels` entry."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.models import llama
    from bigdl_tpu_torch.ops import kernels
    from bigdl_tpu_torch.train import (GaLore, make_full_train_step, next_token_loss,
                                       sample_lisa_mask)

    L, V = cfg.num_hidden_layers, cfg.vocab_size
    M = TRAIN_T
    tokens = torch.as_tensor(np.random.default_rng(0).integers(1, V, (1, TRAIN_T + 1)),
                             dtype=torch.long, device=dev)
    mask = torch.ones((1, TRAIN_T + 1), dtype=torch.float32, device=dev)
    torch.cuda.empty_cache()
    t = time.time()
    model = llama.init_params(cfg, seed=0, device=dev)
    params = llama.make_trainable(model)
    n_params = sum(p_.numel() for p_ in params)
    opt = GaLore(params, lr=FT_LR, rank=FT_RANK, update_proj_gap=FT_GAP, scale=FT_SCALE)
    step = make_full_train_step(cfg, llama.forward, opt)
    torch.cuda.synchronize()
    log(f"phase 13: llama3-8b {L} layers bf16, unfused, {n_params / 1e9:.3f} G parameters built "
        f"in {time.time() - t:.1f} s, {torch.cuda.memory_allocated() / 2**30:.3f} GiB; GaLore "
        f"rank {FT_RANK}, gap {FT_GAP}, scale {FT_SCALE}, lr {FT_LR}, weight decay 0")

    def timed_step(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss_ = step(model, tokens, mask, *a)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, loss_.item()

    wq0 = model.layers[0].proj["wq"].weight.detach().clone()
    torch.cuda.reset_peak_memory_stats()
    refresh_ms, refresh_loss = timed_step()
    refresh_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    runs = [timed_step() for _ in range(TRAIN_STEPS)]
    launches = kernels.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    per_step = {kernels.DW.name: 7 * L + 1, kernels.FLASH_FWD.name: L,
                kernels.FLASH_DQ.name: L, kernels.FLASH_DKV.name: L}
    want = {k.name: per_step.get(k.name, 0) * TRAIN_STEPS for k in kernels.KERNELS}
    losses = [refresh_loss] + [x for _, x in runs]
    moved = (model.layers[0].proj["wq"].weight != wq0).float().mean().item()
    log(f"phase 13: launches over {TRAIN_STEPS} steps after the refresh {launches} expected {want}")
    log(f"phase 13: losses {losses}; layer 0 wq elements changed in bf16 over "
        f"{TRAIN_STEPS + 1} steps: {moved:.4f}")
    check(launches == want, "launch counts of the full fine-tune")
    check(all(math.isfinite(x) for x in losses), "full fine-tune: finite losses")
    del wq0

    # ---------------------------------------------------------------- 14
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for _ in range(PROFILED_TRAIN_STEPS):
            step(model, tokens, mask)
        torch.cuda.synchronize()
    dev_events = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3 / PROFILED_TRAIN_STEPS
    # every dW launch of the path runs the wgmma kernel (every weight's O
    # and K are multiples of 8)
    dw_evs = [e for e in dev_events if "dw_tma_kernel<" in e.key]
    dw_calls = sum(e.count for e in dw_evs)
    check(dw_calls == per_step[kernels.DW.name] * PROFILED_TRAIN_STEPS
          and not any("dw_kernel<" in e.key for e in dev_events),
          f"{kernels.DW.name}: {dw_calls} profiled dw_tma_kernel calls, expected "
          f"{per_step[kernels.DW.name] * PROFILED_TRAIN_STEPS} and no dw_kernel")
    dw_path = sum(e.self_device_time_total for e in dw_evs) / 1e3 / PROFILED_TRAIN_STEPS
    flash_path = {}  # the training flash kernels' device time a step
    for kern, fn in ((kernels.FLASH_FWD, "fwd_kernel"), (kernels.FLASH_DQ, "dq_kernel"),
                     (kernels.FLASH_DKV, "dkv_kernel")):
        evs = [e for e in dev_events if f"namespace)::{fn}" in e.key]
        calls = sum(e.count for e in evs)
        check(calls == per_step[kern.name] * PROFILED_TRAIN_STEPS,
              f"{kern.name}: {calls} profiled calls in the full fine-tune, expected "
              f"{per_step[kern.name] * PROFILED_TRAIN_STEPS}")
        flash_path[kern.name] = round(sum(e.self_device_time_total for e in evs) / 1e3
                                      / PROFILED_TRAIN_STEPS, 3)
    step_ms = sorted(ms for ms, _ in runs)
    med = step_ms[len(step_ms) // 2]
    log(f"phase 14: card {card}")
    log(f"phase 14: full fine-tune llama3-8b bf16 GaLore B=1 T={TRAIN_T}: step_ms median={med:.3f} "
        f"min={step_ms[0]:.3f} max={step_ms[-1]:.3f} (n={TRAIN_STEPS}; all "
        f"{[round(x, 3) for x, _ in runs]}); projector-refresh step {refresh_ms:.3f} ms; "
        f"tokens_per_s={TRAIN_T * 1e3 / med:.1f}; peak_mem_gib={peak_gib:.3f} (refresh step "
        f"{refresh_peak:.3f})")
    log(f"phase 14: profiled full fine-tune: device busy {busy_ms:.3f} ms per step = "
        f"{busy_ms / med:.3f} of the unprofiled median step; {kernels.DW.name} {dw_path:.3f} ms "
        f"a step on the path; the training flash kernels' ms a step on the path {flash_path}")
    for e in dev_events[:12]:
        log(f"  {e.self_device_time_total / 1e3 / PROFILED_TRAIN_STEPS:8.3f} ms/step "
            f"{e.count // PROFILED_TRAIN_STEPS:5d} calls/step  {e.key[:90]}")
    del prof, dev_events

    # LISA: a fresh SGD over the same weights, 2 layers drawn active
    del opt, step
    for p_ in params:
        p_.grad = None
    torch.cuda.empty_cache()
    lmask = sample_lisa_mask(torch.Generator(device=dev).manual_seed(0), L, LISA_ACTIVE)
    active = [i for i in range(L) if lmask[i] > 0]
    snap = {i: [p_.detach().to("cpu", copy=True) for p_ in model.layers[i].parameters()]
            for i in range(L)}
    step = make_full_train_step(cfg, llama.forward, torch.optim.SGD(params, lr=LISA_LR))
    lisa_ms, lisa_loss = timed_step(lmask)
    frozen_same = all(torch.equal(p_.detach().cpu(), s_) for i in range(L) if i not in active
                      for p_, s_ in zip(model.layers[i].parameters(), snap[i]))
    changed = {i: sum(int((p_.detach().cpu() != s_).sum()) for p_, s_ in
                      zip(model.layers[i].parameters(), snap[i])) for i in active}
    log(f"phase 13: LISA step (SGD lr {LISA_LR}, active layers {active}) in {lisa_ms:.1f} ms, "
        f"loss {lisa_loss:.6f}: the {L - len(active)} frozen layers bit-unchanged {frozen_same}; "
        f"elements changed in the active layers {changed}")
    check(math.isfinite(lisa_loss) and frozen_same and all(n > 0 for n in changed.values()),
          "LISA: frozen layers unchanged, active layers trained")
    del snap, step, model, params
    torch.cuda.empty_cache()

    # 2 layers at full width: every weight gradient through the kernels
    # against the plain versions on the card
    cfg2 = dataclasses.replace(cfg, num_hidden_layers=2)
    m2 = llama.init_params(cfg2, seed=2, device=dev)
    p2 = llama.make_trainable(m2)
    plain = {"dw_matmul": kernels.dw_matmul_plain,
             "flash_train_fwd": kernels.flash_attention_train_plain,
             "flash_train_dq": kernels.flash_train_dq_plain,
             "flash_train_dkv": kernels.flash_train_dkv_plain}

    def grads2():
        for p_ in p2:
            p_.grad = None
        loss_ = next_token_loss(cfg2, llama.forward, m2, None, tokens, mask)
        loss_.backward()
        return loss_.item(), [p_.grad.clone() for p_ in p2]

    kern_loss, kern_grads = grads2()
    with mock.patch.multiple(kernels, **plain):
        plain_loss, plain_grads = grads2()
    worst = max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                for a, b in zip(kern_grads, plain_grads))
    log(f"phase 13: 2-layer full-width full fine-tune step kernels vs plain: loss "
        f"{kern_loss:.6f} vs {plain_loss:.6f}; worst weight grad max_abs_err / max|grad| = "
        f"{worst:.4g} (tol 0.05) over {len(plain_grads)} leaves")
    check(abs(kern_loss - plain_loss) <= 1e-3 * abs(plain_loss) and worst <= 0.05,
          "2-layer full fine-tune step, kernels vs plain")
    del m2, p2, kern_grads, plain_grads
    torch.cuda.empty_cache()

    # dW isolated at each path shape, operands cycled past the L2
    sums = [0.0] * 5  # iso, plain, lib, bytes, flops per step
    for (O, K), n in dw_shapes(cfg).items():
        copies = max(1, math.ceil(L2_COPIES_BYTES / (M * (O + K) * 2)))
        sets = [(randn(M, O), randn(M, K)) for _ in range(copies)]
        kern = time_ms(torch, lambda g_, x_: kernels.dw_matmul(g_, x_), sets)
        plain_ = time_ms(torch, lambda g_, x_: kernels.dw_matmul_plain(g_, x_), sets,
                         iters=PLAIN_ITERS)
        lib = time_ms(torch, lambda g_, x_: torch.matmul(g_.t(), x_), sets)
        nbytes, flops = M * (O + K) * 2 + O * K * 2, 2.0 * M * O * K
        bms1, by1 = bound_ms(nbytes, flops)
        for i, val in enumerate((kern, plain_, lib, nbytes, flops)):
            sums[i] += n * val
        log(f"phase 14: {kernels.DW.name} M={M} O={O} K={K} ({n} a step) isolated_ms={kern:.5f} "
            f"plain_ms={plain_:.5f} library_ms={lib:.5f} (cuBLAS g^T x) bound_ms={bms1:.5f} ({by1}); "
            f"{flops / kern / 1e9:.1f} TFLOP/s")
        del sets
    bms, by = bound_ms(sums[3], sums[4])
    return [{
        "name": kernels.DW.name, "route": "cuda", "source": kernels.DW.source,
        "replaces": kernels.DW.replaces, "launches": launches[kernels.DW.name],
        "max_abs_err": errs[kernels.DW.name], "ms": dw_path, "isolated_ms": sums[0],
        "plain_ms": sums[1], "bound_ms": bms, "bound_by": by, "library_ms": sums[2],
        "per": f"one full fine-tune step: B=1 T={TRAIN_T}, {L} layers x 7 unfused "
               "projections + the lm head"}]


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
# first-token logprob by 0.125-0.16 nat (H100, this traffic), and both
# of the top two tokens can move by it: a greedy first token may differ
# only where the top-1/top-2 margin is within 0.25 nat. The bound is
# measured, not derived (PERF.md, open questions).
MARGIN_TOL = 0.25
# kernels vs plain versions over two full-width layers (phase 7): bf16
# activations through two layers, 0.05 nat per chosen-token logprob. An
# fp8 pool quantizes K/V that already differ by a bf16 rounding, and a
# code that lands one e5m2 step over moves its element by a quarter of
# its value: twice the bound there.
LOGPROB_TOL = {False: 0.05, True: 0.1}  # by quantize_kv


def paged_operands(torch, dev, g, L, Hkv, D, pos, fp8, page=PAGE, mp=MAX_LEN // PAGE):
    """A pool of L layers holding, per row, pages for slots [0, pos], in
    a shuffled (non-contiguous) order; the rest of each block table and a
    row at pos 0 (idle) point at the scratch page 0. Returns (pool k, v,
    k_scale, v_scale, block tables, pos, start, live slots)."""
    from bigdl_tpu_torch.kvcache import _quantize_heads

    need = [p // page + 1 if p > 0 else 0 for p in pos]
    NP = sum(need) + 1
    perm = (torch.randperm(NP - 1, device=dev, generator=g) + 1).tolist()
    bt = torch.zeros((len(pos), mp), dtype=torch.int32)
    for b, n in enumerate(need):
        bt[b, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        perm = perm[n:]
    ks = vs = None
    k = torch.randn((L, NP, page, Hkv, D), device=dev, generator=g)
    v = torch.randn((L, NP, page, Hkv, D), device=dev, generator=g)
    if fp8:
        (k, ks), (v, vs) = _quantize_heads(k, torch.float32), _quantize_heads(v, torch.float32)
    else:
        k, v = k.bfloat16(), v.bfloat16()
    i32 = dict(dtype=torch.int32, device=dev)
    live = sum(p + 1 for p in pos)
    return (k, v, ks, vs, bt.to(dev), torch.tensor(pos, **i32),
            torch.zeros((len(pos),), **i32), live)


# phase 2's paged cases: label, page, max pages, pos, start, window,
# softcap. At 8 rows of 2048 slots the kernel cuts chunks of 256 (edges on
# page boundaries); 2 rows of 22 pages of 96 take chunks of 64, whose
# edges fall inside pages.
PAGED_CHECK_CASES = [
    ("decode", PAGE, MAX_LEN // PAGE, (2047, 1100, 64, 0, 1500, 5, 700, 1999), (0,) * 8, None, None),
    ("window+softcap", PAGE, MAX_LEN // PAGE, (2047, 1100, 64, 0, 1500, 5, 700, 1999), (0,) * 8, 300, 30.0),
    ("chunk edges at pages", PAGE, MAX_LEN // PAGE, (255, 256, 511, 512, 767, 1023, 1024, 300),
     (0, 0, 0, 0, 0, 0, 1, 256), None, None),
    ("chunk edges in pages of 96", 96, 22, (2111, 700), (0, 64), None, None),
    ("a window skipping chunks", PAGE, MAX_LEN // PAGE, (2047, 1999, 1300, 900, 520, 256, 255, 64),
     (0,) * 8, 300, 30.0),
    ("one slot; no slot", PAGE, MAX_LEN // PAGE, (700, 5, 1000, 64, 0, 2047, 300, 1),
     (700, 6, 0, 64, 0, 2047, 0, 2), None, None),
]


def serving_kernel_checks(torch, dev, cfg, errs, randn) -> None:
    """Phase 2's serving half: the paged decode kernel (bf16 and fp8
    pages) at PAGED_CHECK_CASES — the engine's decode shape (llama3-8b
    heads, 8 rows, pages of 64, ragged positions up to 2047 over shuffled
    pages, an idle row), a window + softcap case and the edges of its
    split over slots — each launched twice (bit-equal), rows without a
    valid slot exactly 0; the flash kernel's fp8 arm at the dense fp8
    pool's prefill shape and a ragged window + softcap case; each against
    its plain version."""
    from bigdl_tpu_torch.kvcache import _quantize_heads
    from bigdl_tpu_torch.ops import kernels
    from bigdl_tpu_torch.ops.kernels.flash_attention import valid_mask
    from bigdl_tpu_torch.ops.kernels.paged_attention import split_chunk

    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    g = torch.Generator(device=dev).manual_seed(11)
    for fp8 in (False, True):
        kern = kernels.PAGED_FP8 if fp8 else kernels.PAGED
        for label, page, mp, pos, start, window, cap in PAGED_CHECK_CASES:
            k, v, ks, vs, bt, p, _, _ = paged_operands(torch, dev, g, 2, Hkv, D, pos, fp8, page, mp)
            st = torch.tensor(start, dtype=torch.int32, device=dev)
            q = randn(len(pos), Hq, D)
            y = kernels.paged_attention(q, k, v, bt, 1, p, st, ks, vs, softcap=cap, window=window)
            same = torch.equal(y, kernels.paged_attention(q, k, v, bt, 1, p, st, ks, vs, softcap=cap,
                                                          window=window))
            y = y.float()
            ref = kernels.paged_attention_plain(q, k, v, bt, 1, p, st, ks, vs,
                                                softcap=cap, window=window).float()
            err = (y - ref).abs().max().item()
            # f32 math on both sides, one bf16 rounding: one bf16 step per
            # element (2^-7 relative) above a floor far below a ULP
            within = bool(((y - ref).abs() <= 2 ** -7 * ref.abs() + 1e-5).all())
            empty = [b for b in range(len(pos)) if start[b] > min(pos[b], mp * page - 1)]
            zero = all(bool((y[b] == 0).all()) for b in empty)
            errs[kern.name] = max(errs[kern.name], err)
            log(f"phase 2: {kern.name} {label} B={len(pos)} Hq={Hq} Hkv={Hkv} D={D} "
                f"page={page} pos={pos} start={start} window={window} softcap={cap} "
                f"chunk={split_chunk(len(pos), Hkv, mp * page)} max_abs_err={err:.6g} "
                f"tol=2^-7*|ref|+1e-5 per element; rows {empty} without a slot exactly 0 {zero}; "
                f"relaunch bit-equal {same}")
            check(bool(torch.isfinite(y).all()) and within and zero and same, f"{kern.name} {label}")
    for label, b, t_, s_, hq, hkv, d, qoff, st_, win, cap, amp in (
            ("dense fp8 prefill", 1, 1024, 1024, Hq, Hkv, D, 0, (24,), None, None, 3.0),
            ("window+softcap", 2, 128, 192, Hq, Hkv, D, 40, (0, 37), 64, 30.0, 3.0),
            # absmax < 1: every scale is an f16 subnormal
            ("subnormal scales", 2, 30, 96, Hq, Hkv, D, 20, (0, 9), None, None, 0.2),
            ("head_dim 256", 2, 70, 96, 4, 1, 256, 0, (0, 37), None, None, 3.0)):
        q = randn(b, t_, hq, d)
        k, ks = _quantize_heads(torch.randn((b, s_, hkv, d), device=dev, generator=g) * amp)
        v, vs = _quantize_heads(torch.randn((b, s_, hkv, d), device=dev, generator=g) * amp / 3)
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
        log(f"phase 2: {kernels.FLASH_FP8.name} {label} B={b} T={t_} S={s_} Hq={hq} Hkv={hkv} D={d} "
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
    kernel (bf16, fp8 pages) and the flash kernel's fp8 arm, and what
    phases 11-12 compare with: the model, the traffic and engine (a)'s
    requests and times."""
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

    summary_a = (f"{sec_a:.3f} s = {len(reqs_a) / sec_a:.3f} requests/s, {ntok} tokens = "
                 f"{ntok / sec_a:.1f} generated tokens/s; TTFT ms median={q(seen['ttft'], .5):.3f} "
                 f"p90={q(seen['ttft'], .9):.3f}; decode step ms median="
                 f"{q(seen['step'], .5):.3f} p90={q(seen['step'], .9):.3f} (n={steps_a}); "
                 f"peak_mem_gib={peak_a:.3f}")
    log(f"phase 8: card {card}")
    log(f"phase 8: engine (a) paged bf16, {len(reqs_a)} requests, {SLOTS} slots: {summary_a}")

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
        busy = sum(e.self_device_time_total for e in device_kernels(prof)) / 1e3 / PROFILED_DECODES
        med = sorted(host)[len(host) // 2]
        flag = "true" if fp8 else "false"
        path = kernel_ms(prof, (f"paged_split_kernel<128, {flag}, ",
                                f"paged_split_kernel<128, (bool){int(fp8)}, "),
                         L * PROFILED_DECODES, PROFILED_DECODES)
        log(f"phase 8: decode step, {'fp8' if fp8 else 'bf16'} pages, 8 rows at pos {pos}: "
            f"host median {med:.3f} ms (n=10), device busy {busy:.3f} ms = {busy / med:.3f} "
            f"of the step; {kern.name} {path:.3f} ms a step on the path")
        for e in device_kernels(prof)[:6]:
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
    return entries, {"tm": tm, "traffic": traffic, "reqs_a": reqs_a, "summary_a": summary_a}


# ---------------------------------------------------------------------------
# serving with adapters: phase 2's checks of the LoRA GEMV, phases 11 and 12
# ---------------------------------------------------------------------------

ADAPTER_RANKS = (4, 8, 16, 32)  # alpha = 2 rank, all seven projections
# phase 7's 16 requests with their tenants: 4 base requests, 3 for each
# adapter. Requests 0 and 1 share one, so request 1's sub-page copy leaves
# a 30-token prefill (the LoRA GEMV form) in its namespace. The rank-32
# adapter serves only the first wave (the 8 sharing the prefix): its steps
# run at bucket 32 (R = 256: wo fused, w_down past the eligibility edge),
# the second wave's at bucket 16 or less (both fused).
ADAPTER_OF = ("r8", "r8", None, "r32", "r32", None, "r32", "r4",  # the 8 sharing the prefix
              None, "r16", "r16", None, "r8", "r16", "r4", "r4")  # the 8 independent
STEADY_ADAPTERS = ("r4", "r8", "r16") * 3  # the profiled step: bucket 16, R = 128
# A second case for the 2-layer adapter engine check: a tenant assignment
# with a rank-32 row in both waves, so that every decode step runs at
# bucket 32 (round-robin over base and the four adapters: 4 base
# requests, 3 for each adapter) — the case under which this check once
# read two bf16 ULPs (PERF.md)
ADAPTER_OF_ROUND_ROBIN = (None, "r4", "r8", "r16", "r32") * 3 + (None,)


def logprob_shift(lp_a, lp_b, tok_a, tok_b) -> float:
    """Largest chosen-token logprob difference of two runs of the same
    requests, each request up to and including its first differing
    token."""
    worst = 0.0
    for a, b, ta, tb in zip(lp_a, lp_b, tok_a, tok_b):
        n = next((j for j, (x, y) in enumerate(zip(ta, tb)) if x != y), len(ta)) + 1
        worst = max(worst, max(abs(x - y) for x, y in zip(a[:n], b[:n])))
    return worst


def attribute_logprob_shift(kernels, plain, run, assignment, lp_k, tok_k) -> list:
    """[(kernel family, shift)]: the run with one family's kernels swapped
    for their plain versions (the others' kernels kept) against the run
    through every kernel — which family's summation order moves the
    engine's logprobs. `plain` maps each kernel entry point to its plain
    version; the families are the base dequant matmul (GEMV and GEMM), the
    LoRA epilogue (LoRA GEMV and GEMM), prefill attention and paged decode
    attention."""
    families = {"base matmul (qmatmul)": ("qmatmul",), "LoRA epilogue (qmatmul_lora)":
                ("qmatmul_lora",), "prefill attention (flash)": ("flash_attention",),
                "decode attention (paged)": ("paged_attention",)}
    out = []
    for family, names in families.items():
        with mock.patch.multiple(kernels, **{n: plain[n] for n in names}):
            lp, tok = run(assignment)
        out.append((family, logprob_shift(lp_k, lp, tok_k, tok)))
    return out


def lora_gate(torch, dev, M, R, kind):
    """A LoRA gate [M, R] bf16: "dense", a scale in every column; "block",
    the serving decode's form (row m holds its own scale in its R // M
    group columns, zero elsewhere) with the last row all zero at M > 1."""
    if kind == "dense":
        return torch.full((M, R), 2.0, dtype=torch.bfloat16, device=dev)
    gate = torch.zeros((M, R), dtype=torch.bfloat16, device=dev)
    width = max(R // M, 1)
    for m in range(max(M - 1, 1)):
        c = (m * width) % R
        gate[m, c:c + width] = 0.5 + 0.5 * (m % 4)
    return gate


def lora_gemv_library(torch, x, dense_w, a, b, gate):
    """The yardstick the port never calls: cuBLAS on the weight dequantized
    beforehand plus two torch.matmul for the epilogue."""
    xg = (torch.matmul(x, a.t()) * gate).to(torch.bfloat16)
    return torch.matmul(x, dense_w.t()) + torch.matmul(xg, b.t())


def lora_gemv_cost(M, O, K, R, w_bytes):
    """(bytes, operations) of one LoRA matmul: every input read once (x,
    the packed weight, A_cat, B_cat, the gate), the output written once."""
    nbytes = M * K * 2 + w_bytes + R * K * 2 + O * R * 2 + M * R * 2 + M * O * 2
    return nbytes, 2.0 * M * O * K + 2.0 * M * K * R + 2.0 * M * R * O


def adapter_kernel_checks(torch, dev, shapes, errs, qweight, randn) -> None:
    """Phase 2's adapter half: the LoRA GEMV (sym_int4) at wo and w_down —
    M = 1, 8, 32; R = 4, 16, 128 and the widest R `lora_fused_ok` admits
    at that K; a block-diagonal gate with an all-zero row, whose output
    must equal the plain GEMV kernel's bits, and a dense gate — and the
    LoRA GEMM at M = 1024 with R = 32, 64, 128, each against its plain
    version within 2 bf16 ULPs of the largest output."""
    from bigdl_tpu_torch.ops import kernels

    for name in ("wo", "w_down"):
        O, K = shapes[name]
        w, = qweight(O, K)
        rmax = max(r for r in range(1, 1024) if kernels.lora_fused_ok(r, K))
        for M in (1, 8, 32):
            x = randn(M, K)
            base = kernels.qmatmul(x, w)
            worst = []
            for R in (4, 16, 128, rmax):
                a, b_ = randn(R, K) / R, randn(O, R) * 0.02
                for kind in ("block", "dense"):
                    gate = lora_gate(torch, dev, M, R, kind)
                    y = kernels.qmatmul_lora(x, w, a, b_, gate)
                    ref = kernels.qmatmul_lora_plain(x, w, a, b_, gate).float()
                    err = (y.float() - ref).abs().max().item()
                    tol = ref.abs().max().item() * 2 ** -7
                    base_row = kind == "block" and M > 1
                    same = bool(torch.equal(y[-1], base[-1])) if base_row else True
                    errs[kernels.LORA_GEMV.name] = max(errs[kernels.LORA_GEMV.name], err)
                    worst.append(f"R={R} {kind} {err:.3g}/{tol:.3g}")
                    check(bool(torch.isfinite(y).all()) and err <= tol and same,
                          f"lora gemv {name} M={M} R={R} {kind} (zero row bit-equal: {same})")
            log(f"phase 2: {kernels.LORA_GEMV.name} {name} M={M} O={O} K={K} (widest R "
                f"{rmax}) max_abs_err/tol {', '.join(worst)}; zero-gate rows equal the "
                f"plain GEMV kernel's bits")
        x = randn(TRAIN_T, K)
        for R in (32, 64, 128):
            a, b_ = randn(R, K) / R, randn(O, R) * 0.02
            gate = lora_gate(torch, dev, TRAIN_T, R, "dense")
            y = kernels.qmatmul_lora(x, w, a, b_, gate).float()
            ref = kernels.qmatmul_lora_plain(x, w, a, b_, gate).float()
            err = (y - ref).abs().max().item()
            tol = ref.abs().max().item() * 2 ** -7
            errs[kernels.LORA_GEMM.name] = max(errs[kernels.LORA_GEMM.name], err)
            log(f"phase 2: {kernels.LORA_GEMM.name} {name} M={TRAIN_T} O={O} K={K} R={R} "
                f"max_abs_err={err:.6g} tol={tol:.6g}")
            check(bool(torch.isfinite(y).all()) and err <= tol, f"lora gemm {name} R={R}")


def make_adapters(torch, dev, cfg, root, seed=30) -> float:
    """Four seeded adapters on all seven projections saved under `root`
    (r4, r8, r16, r32): A ~ N(0, 1) / rank, B ~ N(0, 0.02^2), alpha =
    2 rank. Returns their bytes in MB."""
    from bigdl_tpu_torch.serving.adapters import lora_nbytes, save_adapter
    from bigdl_tpu_torch.train import init_lora

    root.mkdir(parents=True, exist_ok=True)
    mb = 0.0
    for r in ADAPTER_RANKS:
        lo = init_lora(cfg, seed=seed + r, rank=r, alpha=2.0 * r, device=dev)
        with torch.no_grad():
            g = torch.Generator(device=dev).manual_seed(seed + 100 + r)
            for t in lo.layers.values():
                t["b"].normal_(0.0, 0.02, generator=g)
        save_adapter(str(root / f"r{r}.npz"), lo)
        mb += lora_nbytes(lo) / 1e6
    return mb


def adapter_phases(torch, dev, cfg, card, errs, served) -> list:
    """Phases 11 and 12: engine (f), the paged bf16 pool with four
    adapters (ranks 4-32) over phase 7's traffic, then its times. Returns
    the `kernels` entry of the LoRA GEMV."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch import TorchModel, optimize_model
    from bigdl_tpu_torch.models import llama
    from bigdl_tpu_torch.ops import kernels
    from bigdl_tpu_torch.serving import InferenceEngine
    from bigdl_tpu_torch.serving.adapters import AdapterRegistry, rank_bucket

    L, V = cfg.num_hidden_layers, cfg.vocab_size
    K_WO, K_DOWN = cfg.q_dim, cfg.intermediate_size
    tm, traffic, reqs_a = served["tm"], served["traffic"], served["reqs_a"]
    root = Path(__file__).resolve().parent / "build" / "adapters"
    t0 = time.time()
    mb = make_adapters(torch, dev, cfg, root / "full")
    log(f"phase 11: adapters r4 r8 r16 r32 (alpha 2 rank, 7 projections x {L} layers, "
        f"{mb:.1f} MB) made and saved in {time.time() - t0:.1f} s")
    specs = [dict(sp, adapter=a) for sp, a in zip(traffic, ADAPTER_OF)]

    def engine(model, where, **kw):
        return InferenceEngine(model, n_slots=SLOTS, max_len=MAX_LEN, page_size=PAGE,
                               adapters=AdapterRegistry(dir=str(where)), **kw)

    def lora_gemv_per_step(rb):
        """LoRA GEMV launches a decode step makes at bucket rb (0: no
        adapter row): wo and w_down, each where `lora_fused_ok` takes
        SLOTS x rb columns."""
        return 0 if rb == 0 else L * (kernels.lora_fused_ok(SLOTS * rb, K_WO)
                                      + kernels.lora_fused_ok(SLOTS * rb, K_DOWN))

    def watch(eng):
        """Per decode step (the batch's bucket, LoRA GEMV launches), and per
        paged prefill (tail tokens, adapter or not, LoRA GEMV launches)."""
        steps, prefills = [], []
        real_decode, real_prefill = eng._decode, eng._paged_prefill

        def decode():
            rows = [e for i, e in enumerate(eng._slot_adapter) if e is not None and eng.active[i]]
            n0 = kernels.LORA_GEMV.launches
            out = real_decode()
            steps.append((rank_bucket(max(e.rank for e in rows)) if rows else 0,
                          kernels.LORA_GEMV.launches - n0))
            return out

        def prefill(row, pos0, tail, lora=None):
            n0 = kernels.LORA_GEMV.launches
            out = real_prefill(row, pos0, tail, lora)
            prefills.append((len(tail), lora is not None, kernels.LORA_GEMV.launches - n0))
            return out

        eng._decode, eng._paged_prefill = decode, prefill
        return steps, prefills

    def serve(eng):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        reqs = [eng.submit(**sp) for sp in specs]
        eng.run_until_idle()
        torch.cuda.synchronize()
        return reqs, time.perf_counter() - t1

    def finished(reqs, what):
        ok = all(r.finish_reason == "length" and len(r.out_tokens) == SERVE_NEW
                 and all(0 <= x < V for x in r.out_tokens)
                 and all(math.isfinite(lp) for lp in r.out_logprobs) for r in reqs)
        check(ok, f"{what}: every request finishes 'length' with {SERVE_NEW} in-vocabulary "
                  "tokens and finite logprobs")

    def margin(r, i):
        top = sorted(r.out_top_logprobs[i].values(), reverse=True)
        return top[0] - top[1]

    greedy = [i for i, sp in enumerate(specs) if not sp.get("do_sample")]

    # (f) paged bf16 with adapters, the main path; phase 12 reads its times
    eng = engine(tm, root / "full", paged=True, logprobs_top_k=2)
    seen = {"ttft": [], "step": []}
    for key, hist in (("ttft", eng.ttft), ("step", eng.decode_step_seconds)):
        hist.observe = (lambda h, out: lambda x: (out.append(x), type(h).observe(h, x)))(
            hist, seen[key])
    steps_f, prefills_f = watch(eng)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    reqs_f, sec_f = serve(eng)
    launches_f = kernels.launch_counts()
    peak_f = torch.cuda.max_memory_allocated() / 2**30
    store_gib = eng._adapter_store.buf.numel() * 2 / 2**30
    finished(reqs_f, "(f)")
    buckets = sorted({rb for rb, _ in steps_f})
    wrong = [(i, rb, n) for i, (rb, n) in enumerate(steps_f) if n != lora_gemv_per_step(rb)]
    short = [(n, k) for n, has, k in prefills_f if has and n <= kernels.GEMV_MAX_ROWS]
    log(f"phase 11 (f) paged bf16 + adapters: {len(specs)} requests in {sec_f:.3f} s, "
        f"{len(steps_f)} decode steps at buckets {buckets} (LoRA GEMV launches per step "
        f"{ {rb: lora_gemv_per_step(rb) for rb in buckets} }), prefix_hits={eng.prefix_hits} "
        f"prefix_partial_hits={eng.prefix_partial_hits}, adapter page_ins="
        f"{eng._pager.page_ins} pages_resident={eng._pager.pages_resident}, page_leaks="
        f"{eng.page_leaks()}, adapter prefills at <= {kernels.GEMV_MAX_ROWS} tokens "
        f"(tokens, LoRA GEMV launches) {short}; launches {launches_f}")
    check(eng.page_leaks() == 0, "(f) page leaks, the pager's pages counted")
    check(not wrong, f"(f) LoRA GEMV launches per decode step (step, bucket, launches) {wrong[:5]}")
    check(any(rb > 0 for rb in buckets), "(f) decode steps with adapter rows")
    check(bool(short) and all(k == 2 * L for _, k in short),
          "(f) a short adapter prefill through the LoRA GEMV")
    check(eng.prefix_partial_hits >= 1, "(f) the sub-page copy in an adapter namespace")
    check(all(launches_f[k.name] > 0 for k in (kernels.GEMV, kernels.GEMM, kernels.LORA_GEMV,
                                               kernels.LORA_GEMM, kernels.PAGED)),
          "(f) GEMV, GEMM, LoRA GEMV, LoRA GEMM and paged launches")
    check(launches_f[kernels.PAGED.name] == L * len(steps_f), "(f) paged launches")
    ties = []
    for i in greedy:
        if ADAPTER_OF[i] is not None:
            continue
        ra, rf = reqs_a[i], reqs_f[i]
        diff = next((j for j, (x, y) in enumerate(zip(ra.out_tokens, rf.out_tokens)) if x != y), None)
        if diff is not None:
            ties.append((i, diff, round(margin(ra, diff), 5)))
            check(margin(ra, diff) <= MARGIN_TOL, f"(f) base request {i} differs from (a) "
                                                  f"at token {diff}")
    log(f"phase 11 (f): base requests {[i for i in greedy if ADAPTER_OF[i] is None]} equal "
        f"engine (a)'s tokens but at near-ties (request, token, (a)'s margin) {ties}, "
        f"tol {MARGIN_TOL}")
    stats_f = eng.adapters.stats()
    # base requests alone afterwards: their steps launch the plain GEMV only
    n_steps, gemv0 = len(steps_f), kernels.GEMV.launches
    eng.submit(traffic[2]["prompt"], max_new_tokens=4)
    eng.submit(traffic[11]["prompt"], max_new_tokens=4)
    eng.run_until_idle()
    base_steps = steps_f[n_steps:]
    log(f"phase 11 (f): a base-only burst afterwards: (bucket, LoRA GEMV launches) per decode "
        f"step {base_steps}, GEMV launches {kernels.GEMV.launches - gemv0}")
    check(bool(base_steps) and all(x == (0, 0) for x in base_steps)
          and kernels.GEMV.launches - gemv0 >= len(base_steps) * (4 * L + 1),
          "(f) base-only steps take the plain GEMV, no LoRA GEMV")
    check(eng.page_leaks() == 0, "(f) page leaks after the base-only burst")
    del eng

    # the same traffic again: adapter requests' greedy tokens repeat
    eng = engine(tm, root / "full", paged=True)
    reqs_f2, sec_f2 = serve(eng)
    finished(reqs_f2, "(f) again")
    check(all(reqs_f[i].out_tokens == reqs_f2[i].out_tokens for i in greedy),
          "(f) greedy tokens repeat on a second run")
    check(eng.page_leaks() == 0, "(f) again: page leaks")
    del eng
    log(f"phase 11 (f) again: {sec_f2:.3f} s, greedy tokens identical; registry {stats_f}")

    # (g) dense bf16 with adapters (gathered from host RAM)
    kernels.reset_launches()
    eng = engine(tm, root / "full", logprobs_top_k=2)
    reqs_g, sec_g = serve(eng)
    launches_g = kernels.launch_counts()
    finished(reqs_g, "(g)")
    check(launches_g[kernels.PAGED.name] == 0 and launches_g[kernels.LORA_GEMV.name] > 0,
          "(g) LoRA GEMV and no paged launches")
    ties = []
    for i in greedy:
        if reqs_f[i].out_tokens[0] != reqs_g[i].out_tokens[0]:
            ties.append((i, round(margin(reqs_g[i], 0), 5)))
            check(margin(reqs_g[i], 0) <= MARGIN_TOL, f"(g) request {i} first token")
    log(f"phase 11 (g) dense bf16 + adapters: {sec_g:.3f} s, first tokens equal to (f)'s but at "
        f"near-ties {ties}; launches {launches_g}")
    del eng

    # 2 layers at full width: kernels on, then every kernel's plain version
    cfg2 = dataclasses.replace(cfg, num_hidden_layers=2)
    tm2 = TorchModel(cfg2, optimize_model(llama.init_params(cfg2, seed=5), cfg2, "sym_int4"),
                     "sym_int4")
    make_adapters(torch, dev, cfg2, root / "two_layers")
    plain = {"qmatmul": kernels.qmatmul_plain, "qmatmul_lora": kernels.qmatmul_lora_plain,
             "flash_attention": kernels.flash_attention_plain,
             "paged_attention": kernels.paged_attention_plain}

    def run2(assignment):
        e2 = engine(tm2, root / "two_layers", paged=True)
        rs = [e2.submit(**dict(sp, adapter=a)) for sp, a in zip(traffic[:8], assignment)]
        e2.run_until_idle()
        check(e2.page_leaks() == 0, "2-layer adapter engine page leaks")
        return [r.out_logprobs for r in rs], [r.out_tokens for r in rs]

    # one bf16 ULP of the largest logit of a 2-layer prefill
    with torch.inference_mode():
        top = llama.forward(cfg2, tm2.params, torch.as_tensor(
            [traffic[0]["prompt"]], device=dev), None)[0].abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    for case, assignment in (("phase 11's", ADAPTER_OF), ("round-robin", ADAPTER_OF_ROUND_ROBIN)):
        kernels.reset_launches()
        lk, tk = run2(assignment)
        check(kernels.LORA_GEMV.launches > 0, "2-layer adapter engine: LoRA GEMV launches")
        with mock.patch.multiple(kernels, **plain):
            lp_, tp_ = run2(assignment)
        worst = logprob_shift(lk, lp_, tk, tp_)
        log(f"phase 11: 2-layer full-width adapter engine, {case} assignment "
            f"{assignment[:8]}: chosen-token logprobs kernels vs plain max_abs_err="
            f"{worst:.5f} nat = {worst / ulp:.2f} bf16 ULPs of the largest logit "
            f"({top:.3f}) (tol {LOGPROB_TOL[False]}, up to the first differing token)")
        for family, shift in attribute_logprob_shift(kernels, plain, run2, assignment, lk, tk):
            log(f"phase 11:   {family} alone to its plain version: {shift:.5f} nat = "
                f"{shift / ulp:.2f} ULPs")
        check(worst <= LOGPROB_TOL[False], f"2-layer adapter engine kernels vs plain, "
              f"{case} assignment")
    del tm2

    # ---------------------------------------------------------------- 12
    ntok = sum(len(r.out_tokens) for r in reqs_f)

    def q(xs, f):
        xs = sorted(xs)
        return xs[min(int(f * len(xs)), len(xs) - 1)] * 1e3

    log(f"phase 12: card {card}")
    log(f"phase 12: engine (f) paged bf16 + adapters, {len(reqs_f)} requests, {SLOTS} slots: "
        f"{sec_f:.3f} s = {len(reqs_f) / sec_f:.3f} requests/s, {ntok} tokens = "
        f"{ntok / sec_f:.1f} generated tokens/s; TTFT ms median={q(seen['ttft'], .5):.3f} "
        f"p90={q(seen['ttft'], .9):.3f}; decode step ms median={q(seen['step'], .5):.3f} "
        f"p90={q(seen['step'], .9):.3f} (n={len(steps_f)}); peak_mem_gib={peak_f:.3f} "
        f"(the adapter page store {store_gib:.3f} GiB of it); second run {sec_f2:.3f} s")
    log(f"phase 12: engine (a) paged bf16, the same traffic without adapters: {served['summary_a']}")

    # a decode step with 8 adapter rows (bucket 16: R = 128 at wo and w_down)
    rng = np.random.default_rng(9)
    steady = [rng.integers(1, V, STEADY_LEN + 13 * i).tolist() for i in range(SLOTS)]
    eng = engine(tm, root / "full", paged=True)
    for p_, a_ in zip(steady, STEADY_ADAPTERS):
        eng.submit(p_, max_new_tokens=SERVE_NEW, adapter=a_)
    for _ in range(4):
        eng.step()
    host = []
    for _ in range(10):
        t1 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t1) * 1e3)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for _ in range(PROFILED_DECODES):
            eng.step()
        torch.cuda.synchronize()
    R = SLOTS * rank_bucket(max(ADAPTER_RANKS[:3]))
    del eng
    dev_events = device_kernels(prof)
    busy = sum(e.self_device_time_total for e in dev_events) / 1e3 / PROFILED_DECODES
    med = sorted(host)[len(host) // 2]
    gemv_evs = [e for e in dev_events if ("gemv_kernel<8, 4, true>" in e.key
                                          or "gemv_kernel<8, 4, (bool)1>" in e.key)]
    xa_evs = [e for e in dev_events if "lora_xa_small_kernel<8, 4>" in e.key]
    calls = sum(e.count for e in gemv_evs)
    check(calls == 2 * L * PROFILED_DECODES and sum(e.count for e in xa_evs) == calls,
          f"LoRA GEMV: {calls} profiled calls, expected {2 * L * PROFILED_DECODES}")
    path = sum(e.self_device_time_total for e in gemv_evs + xa_evs) / 1e3 / PROFILED_DECODES
    xa_path = sum(e.self_device_time_total for e in xa_evs) / 1e3 / PROFILED_DECODES
    log(f"phase 12: decode step, 8 adapter rows (R={R}), bf16 pages: host median {med:.3f} ms "
        f"(n=10), device busy {busy:.3f} ms = {busy / med:.3f} of the step; "
        f"{kernels.LORA_GEMV.name} {path:.3f} ms a step on the path (its first pass "
        f"{xa_path:.3f} ms)")
    for e in dev_events[:8]:
        log(f"  {e.self_device_time_total / 1e3 / PROFILED_DECODES:8.3f} ms/step "
            f"{e.count // PROFILED_DECODES:5d} calls/step  {e.key[:90]}")

    # the LoRA GEMV isolated at M = 8, R = 128, wo and w_down, operands
    # cycled past the L2; per decode step: L x (wo + w_down)
    from bigdl_tpu_torch.quant import quantize

    g = torch.Generator(device=dev).manual_seed(14)
    iso = plain_ = lib = nbytes = flops = 0.0
    for O, K in ((cfg.hidden_size, K_WO), (cfg.hidden_size, K_DOWN)):
        w = quantize(torch.randn((O, K), device=dev, generator=g) * 0.02, "sym_int4")
        wb = sum(t.numel() * t.element_size() for t in w.fields().values())
        x = torch.randn((SLOTS, K), device=dev, generator=g).bfloat16()
        gate = lora_gate(torch, dev, SLOTS, R, "block")
        copies = max(1, math.ceil(L2_COPIES_BYTES / (wb + R * (K + O) * 2)))
        sets = [(type(w)(qtype=w.qtype, **{f: t.clone() for f, t in w.fields().items()}),
                 (torch.randn((R, K), device=dev, generator=g) / 16).bfloat16(),
                 (torch.randn((O, R), device=dev, generator=g) * 0.02).bfloat16())
                for _ in range(copies)]
        dense = [(w_.dequantize(torch.bfloat16), a_, b_) for w_, a_, b_ in sets[:max(1, copies // 2)]]
        k_ms = time_ms(torch, lambda w_, a_, b_: kernels.qmatmul_lora(x, w_, a_, b_, gate), sets)
        p_ms = time_ms(torch, lambda w_, a_, b_: kernels.qmatmul_lora_plain(x, w_, a_, b_, gate),
                       sets, iters=PLAIN_ITERS)
        l_ms = time_ms(torch, lambda d_, a_, b_: lora_gemv_library(torch, x, d_, a_, b_, gate),
                       dense, iters=PLAIN_ITERS)
        nb, fl = lora_gemv_cost(SLOTS, O, K, R, wb)
        bms1, by1 = bound_ms(nb, fl)
        log(f"phase 12: {kernels.LORA_GEMV.name} M={SLOTS} O={O} K={K} R={R}: isolated_ms="
            f"{k_ms:.5f} plain_ms={p_ms:.5f} library_ms={l_ms:.5f} (cuBLAS on the weight "
            f"dequantized beforehand + two torch.matmul) bound_ms={bms1:.5f} ({by1})")
        iso, plain_, lib = iso + L * k_ms, plain_ + L * p_ms, lib + L * l_ms
        nbytes, flops = nbytes + L * nb, flops + L * fl
        del sets, dense
    bms, by = bound_ms(nbytes, flops)
    return [{
        "name": kernels.LORA_GEMV.name, "route": "cuda", "source": kernels.LORA_GEMV.source,
        "replaces": kernels.LORA_GEMV.replaces, "launches": launches_f[kernels.LORA_GEMV.name],
        "max_abs_err": errs[kernels.LORA_GEMV.name], "ms": path, "isolated_ms": iso,
        "plain_ms": plain_, "bound_ms": bms, "bound_by": by, "library_ms": lib,
        "per": f"one adapter decode step: {SLOTS} rows, R={R}, wo + w_down x {L} layers"}]


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
    forms = (kernels.GEMV, kernels.GEMM, kernels.LORA_GEMM, kernels.DX, kernels.LORA_GEMV)
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
        edge_errs = {}
        dequant_edge_checks(torch, dev, qtype, edge_errs, qweight_of(torch, dev, qtype, 200, 2048, 50 + qi),
                            randn)
        for k in (kernels.GEMM, kernels.LORA_GEMM, kernels.DX):
            row = out[k.name][qtype]
            row["max_abs_err"] = max(row["max_abs_err"], edge_errs[k.name])
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
                # the LoRA GEMV at a serving decode step: 8 rows, R = 128
                x, a, b_ = randn(SLOTS, K), randn(128, K) / 16, randn(O, 128) * 0.02
                gate = lora_gate(torch, dev, SLOTS, 128, "block")
                worst.append(held(kernels.LORA_GEMV, qtype, kernels.qmatmul_lora(x, w, a, b_, gate),
                                  kernels.qmatmul_lora_plain(x, w, a, b_, gate), f"{name} lora gemv"))
            gr = randn(TRAIN_T, O)
            worst.append(held(kernels.DX, qtype, kernels.qmatmul_dx(gr, w),
                              kernels.qmatmul_dx_plain(gr, w), f"{name} dx"))
            log(f"phase 9: {qtype} {name} O={O} K={K} ({weight_bytes(w) / (O * K):.6g} B/weight): "
                f"GEMV M=1,4,32, GEMM M=33,1024{', LoRA GEMM M=1024 R=8, LoRA GEMV M=8 R=128' if name in ('wo', 'w_down') else ''}"
                f", dx M=1024: max_abs_err/tol {' '.join(f'{e:.3g}/{t_:.3g}' for e, t_ in worst)}")
            del w
    torch.cuda.synchronize()
    log(f"phase 9: every form of {len(FORMATS)} formats within 2 bf16 ULPs of its plain "
        f"version at every llama3-8b shape ({time.time() - t0:.1f} s)")

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def busy_ms(prof_, n):
        return sum(e.self_device_time_total for e in device_kernels(prof_)) / 1e3 / n

    def kernel_path_ms(prof_, fn, n):
        pat = fn if isinstance(fn, re.Pattern) else re.compile(rf"namespace\)::{fn}")
        return sum(e.self_device_time_total for e in prof_.key_averages()
                   if pat.search(e.key) and e.self_device_time_total > 0) / 1e3 / n

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
                    kernels.DX.name: {}, kernels.GEMV.name: {body: (NEW_TOKENS - 1) * 4 * L},
                    kernels.LORA_GEMV.name: {}}
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
        gemm_ms = kernel_path_ms(prof_pre, GEMM_EVENT, PROFILED_PREFILLS)
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
    out[kernels.LORA_GEMM.name]["nf4"]["ms"] = kernel_path_ms(prof, LORA_GEMM_EVENT, PROFILED_TRAIN_STEPS)
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
                x, gate = randn(SLOTS, K), lora_gate(torch, dev, SLOTS, 128, "block")
                a, b_ = randn(128, K) / 16, randn(O, 128) * 0.02
                add(kernels.LORA_GEMV, L,
                    time_ms(torch, lambda w_: kernels.qmatmul_lora(x, w_, a, b_, gate), ws),
                    time_ms(torch, lambda w_: kernels.qmatmul_lora_plain(x, w_, a, b_, gate), ws,
                            iters=PLAIN_ITERS),
                    time_ms(torch, lambda d_: lora_gemv_library(torch, x, d_, a, b_, gate), dense,
                            iters=PLAIN_ITERS),
                    *lora_gemv_cost(SLOTS, O, K, 128, wb))
            del w, ws, dense
        for kern, unit in ((kernels.GEMV, f"decode step M={B}"), (kernels.GEMM, f"prefill M={TRAIN_T}"),
                           (kernels.DX, f"train step M={TRAIN_T}"),
                           (kernels.LORA_GEMM, f"train step M={TRAIN_T} R={RANK}"),
                           (kernels.LORA_GEMV, f"adapter decode step M={SLOTS} R=128: "
                                               f"wo + w_down x {L}")):
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
