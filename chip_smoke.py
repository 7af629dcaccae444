#!/usr/bin/env python3
"""Smoke run of bigdl_tpu_torch, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py

Phases (a failed check is reported where it fails and the run goes on,
so that one run shows every failure, then exits non-zero before printing
the result lines; an exception ends the run at once; nothing is caught):

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
   in its SASS; then the decode GEMV of every format (`gemv_kernel`, both
   arms, and the LoRA GEMV's first pass `lora_xa_split_kernel`): a spill
   or a kernel without HMMA in its SASS in sym_int4, nf4, q4_k or q6_k
   fails the run; print the card's name and power limit;
2. hold each kernel against its plain PyTorch version at the main paths'
   shapes: the sym_int4 dequant-matmul GEMV (M = 1, 3, 4, 8, 17, 32: every
   n-tile count) and GEMM (M = 33, 1024) at every llama3-8b projection and
   the lm head, and there the LoRA GEMV at R = 128 with the serving
   decode's gate (its last row zero: that row must equal the GEMV's bits),
   both launched twice (bit-equal); the GEMM, LoRA GEMM and dx at ragged M (33,
   255, 257, 1000, 4096) with O = 200, each launched twice (bit-equal) and
   with every third LoRA gate row zero (those rows bit-equal to the
   GEMM's); flash attention at the prefill shape with
   ragged left padding, plus a window+softcap case, a head_dim-64 case, a
   head_dim-256 case, phi3-mini's head_dim 96 and a T=17 case at q_offset 100 whose window edge
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
   kernels (`dw_variant`) each case ran; then the sums' rounding: at wo,
   w_down and w_gateup (M = 1024, sym_int4) the bf16 outputs of the GEMM,
   dx and the LoRA GEMM that differ from the exactly rounded value (f64
   sums on the card), beside their plain versions' count: a kernel with
   more than twice as many fails the run;
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
   its bound;
15. phi3-mini's head_dim 96: a 2-layer phi3-mini at full width (hidden
   3072, 32 heads of 96 over 32 kv heads), sym_int4, weights from a seed:
   prefill logits through the flash kernel (D run at 128, zero-padded),
   a paged engine's decode steps through the paged kernel's D = 96
   instantiation (chosen-token logprobs) and one QLoRA step (B=1 T=256)
   through the flash backward (loss and LoRA gradients), each against the
   plain versions on the card under phases 3, 7 and 5's bounds, and each
   of those kernels launched (flash a layer, paged a layer and decode
   step, each flash-train kernel a layer);
16. checkpoints from disk (run after phase 4): (a) a llama3-8b sym_int4
   model at full width and 8 of its 32 layers (seed 0; 12 until phase 22
   joined the script, phase 3's model until phase 19 did) saved with `save_low_bit`
   (the artifact's GB, the save's seconds and its device-to-host part),
   loaded with `AutoModelForCausalLM.load_low_bit` under verify="fast"
   and "full" (seconds, GB/s), `verify_low_bit` ok, and its own greedy
   tokens and launch counts from the loaded model; (b) an HF checkpoint
   of Meta-Llama-3-8B's published config.json at 4 layers (bf16 N(0,
   0.02^2) weights from a seed, two shards and an index, ~3.9 GB, written
   with the script's own safetensors writer) ingested with
   `from_pretrained` in sym_int4 and q4_k_m: one layer's bytes from the
   card's encoder against the CPU encoder's (equal in sym_int4; q4_k's
   differing bytes printed), prefill logits through the kernels against
   the plain versions (phase 3's bound), in-vocabulary tokens the same on
   a second call and after a save and load; the ingest's seconds, read
   GB/s, quantize ms a layer and peak device memory. Both directories are
   deleted; a temporary directory without room fails the phase.
17. the llama flags (after phase 15): (a) gemma2-9b at full width
   (hidden 3584, 16 q heads of 256 over 8, vocab 256,000 tied to the
   embedding, alternating windows of 4096, softcaps 50/30, (1 + w) norms,
   gelu-tanh) and 14 of its 42 layers (the full depth until phase 19
   joined the script), sym_int4, weights from a seed
   (norm weights 0: the unit scale under (1 + w)),
   through `TorchModel.generate` at phase 3's shapes: launches (GEMM
   4 x 14, GEMV 31 x 4 x 14: the tied head is a dense product; no flash
   launch: JAX's rule sends alternating windows to the plain attention),
   in-vocabulary and repeatable tokens, prefill ms, decode step median
   and p80, busy share, peak memory; (b) the paged engine on it with
   phase 7's traffic: 14 paged launches a decode step with each layer's
   window, the softcap and the scale, no page leaks, requests/s, TTFT
   and decode-step quantiles; (c) windows that bite: a 4,500-token
   prompt and 8 decode steps through 2-layer full-width mistral-7b
   (flash prefill with its window) and gemma2-9b, over a dense cache, a
   paged pool and a paged engine (max-len 4,608), kernels against the
   plain versions (logits: phase 3's bound; the engine's chosen-token
   logprobs: phase 7's) and each layer's window on the paged kernel; (d) 2-layer qwen2-7b's fused q/k/v bias through prefill and
   decode, and a QLoRA step (B=1 T=1024, rank 8, seven projections) of
   qwen2-7b, mistral-7b (flash training with its window) and gemma2-9b
   (plain attention) against the plain versions (phase 5's bound); (e)
   Llama-3.1's rope scaling on a 2-layer llama3-8b prefill at T=1024
   against plain; (f) HF checkpoints of gemma2-9b's and qwen2-7b's
   preset values at 4 layers (bf16 from a seed, two shards) ingested in
   sym_int4: every quantized byte as `params_from_numpy` +
   `optimize_model` give them from the same tensors, in-vocabulary and
   repeatable tokens, and gemma2's `save_low_bit` -> `load_low_bit`
   keeping them bit for bit.
18. generation's KV-cache policies and the embedding variants (after
   phase 16, on phase 16's 8-layer model; phase 3's 32-layer one until
   phase 19 joined the script): (a) SnapKV, four seeded
   prompts of 3,000, 2,400, 1,500 and 700 tokens compressed to 1,024
   slots (window 32, pool 7), 32 greedy tokens: launches (flash a layer at the
   prefill, GEMM at the 16,384-row prefill, GEMV at each step), the
   compressed cache's length, pos, start and rope_base by the formula,
   in-vocabulary and repeatable tokens, prefill ms, decode-step median
   and p80 and peak memory beside plain generate's; again over the fp8
   cache (the flash kernel's fp8 arm); (b) attention-sink streaming,
   four 200-token prompts, window 256, sink 4, 160 tokens: launches, at
   least three evictions, 256 slots throughout, repeatable tokens, the
   same peak memory at half the tokens, decode-step times; (c) a
   `ChatSession` with streaming (4, 512) over four turns of 150, 90, 200
   and 40 tokens, 48 greedy tokens a turn: each turn's launches (one
   flash a layer, GEMM or GEMV by its bucket), the cache at 512 slots,
   replies repeated by a fresh session, each turn's prefill ms and
   decode-step median; (d) the embedding table in host RAM, as a memmap
   of a .npy file and in sym_int4: host tables' logits and tokens
   bit-equal to the dense table's, the low-bit table's logits bit-equal
   to a dense table of its dequantized rows, the device memory each
   saves and its decode step; (e) two full-width layers against the
   plain versions under phase 3's bound: SnapKV's first decode (the
   kept slots by the selection rule: a slot kept by one run only lies
   within 2 dv of the keep boundary, dv the layer's largest vote
   difference), streaming's decode after an eviction, and chat turn 3's
   logits against the plain versions and the kernels' one-shot prefill.
19. self-speculative and prompt-lookup decoding (after phase 18, on
   phase 16 (a)'s 8-layer model and a bf16 one of the same seed; phase
   3's 32-layer model until phase 20 joined the script): (b) a
   512-token prompt (64 seeded tokens, 8 times), 64 greedy tokens under
   BIGDL_TPU_PERFORMANCE_MODE: the switch to prompt lookup, launches (the
   GEMV at M = 4, flash at T = 4 a round), the teacher-forced rule, ms a
   token beside plain generate's; (d) engine (f)'s four adapters over
   phase 7's 8 prefix-sharing requests (32 tokens), speculative with the
   model as its own draft: the LoRA GEMV at 32 rows, base rows accepting
   K-1 every round but on near-ties, tokens as the plain adapter engine's
   by the margin rule; (a) `generate_speculative` of one 256-token prompt,
   64 greedy tokens, draft_k 4, against the sym_int4 self-draft (adaptive
   off and on) and a perfect draft (the target's weights, twice): launches
   (a flash kernel a layer at T = 4 a verify, the draft's GEMV a step), the
   teacher-forced rule, the perfect draft's K-1 a round but on near-ties,
   repeatable tokens, a sampled run in the support and repeatable under
   its seed; rounds, acceptance and ms a token beside plain generate of
   the target and of the draft; (c) the paged engine with
   speculative=True, adaptive_draft=True on the bf16 target over phase
   7's traffic with 4 sampled and 2 penalized requests and one whose
   window ends flush with max_len: launches, no page leak, greedy rows
   (penalized where asked) by the teacher-forced rule on the verify's
   route within phase 7's 0.25 nat, sampled rows in the support;
   requests/s, TTFT and decode-step quantiles beside the
   non-speculative engine; (e) two
   full-width layers' verify logits at T = 2, 3, 4 (B = 1) and T = 4 over
   8 rows (the GEMV at M = 32) at q_offset 301 against the plain versions
   under phase 3's bound.
20. mixture of experts, ALiBi and logn (after phase 17; the experts run
   as JAX runs them, each expert tensor dequantized, then einsums): (a)
   mixtral-8x7b at full width (hidden 4096, 32 q heads over 8, 8 experts
   of 14336, top-2 renormalized, vocab 32000, rope theta 1e6) and 16 of
   its 32 layers in sym_int4, built layer by layer (`init_params(low_bit=)`:
   the build's peak below the dense model's size), through `generate` at
   phase 3's shapes: launches (GEMM 2 x 16, GEMV 1 + 31 x (2 x 16 + 1),
   flash 16: wqkv and wo), in-vocabulary and repeatable tokens, prefill
   ms, the routing rule (each row against a one-shot forward: at the
   first layer where the chosen experts differ, only near-ties, router
   logits within ROUTER_TOL; without a difference, the tokens within
   0.25 nat of its maximum), the decode step's host-set ms and profiled
   busy ms, the MoE block's
   share of it (one layer isolated: the experts' dequantize, then the rest),
   peak memory; a 2-layer prefill through the kernels against the plain
   versions, and the capacity dispatch at capacity factor E / k against the
   dense one (phase 3's bound); (b) the paged engine on it at phase 8's
   settings over 4 prefix-sharing and 4 independent requests of phase 7
   (32 tokens): requests/s, TTFT and decode-step quantiles, 16 paged
   launches a decode step, no page leaks, the same tokens from a second
   run (a rounding that flips a token's experts moves it by a whole
   expert on this random model, so the engine's tokens are not held to
   `generate`'s: (a)'s routing rule shows why); (c) 2 layers of qwen2-moe at
   Qwen1.5-MoE-A2.7B's width (60 experts of 1408, top-4, a shared expert
   of 5632, vocab 151936): the auto rule's capacity dispatch, prefill and
   a decode step through the kernels against the plain versions; (d) 2
   layers of baichuan-13b's width (40 heads of 128: ALiBi slopes past 32,
   vocab 64000) through `generate` and the paged engine: no flash or
   paged launch (JAX's rule), GEMM and GEMV by their exact counts, the
   engine's decode step beside mixtral's, logits against the plain
   versions; (e) 2 layers of Qwen-7B's width with logn (train length
   2048) over two 3,000-token prompts: a flash launch a layer, the q it
   takes equal to logn_attn=False's times the logn factor bit for bit,
   logits against the plain versions and moved by logn.
21. the rest of the llama flags (after phase 20): (a) gemma-3-27b
   (google/gemma-3-27b-it's published text_config: hidden 5376, 32 q
   heads over 16 of 128, scale 168^-0.5, windows of 1024 on 5 layers of
   each 6, rope 1e6 x8 on the global layers and 1e4 on the local ones,
   vocab 262,208 tied) at full width and GEMMA3_LAYERS of its 62 layers
   in sym_int4, built layer by layer, through `generate` at phase 3's
   shapes: launches (GEMM 4 x L, GEMV 31 x 4 x L, no flash: windows that
   are not uniform take the plain attention, JAX's rule) and the same
   counts in profiled windows, in-vocabulary and repeatable tokens,
   prefill ms, the decode step's host-set and busy ms, peak memory; 2
   layers (one local, one global) over a 1,500-token prompt past the
   window against the plain versions; (b) the paged engine on it over 4
   prefix-sharing and 4 independent requests of phase 7 (32 tokens):
   requests/s, TTFT and decode-step quantiles, L paged launches a decode
   step with each layer's window and the scale, no page leaks, the same
   tokens from a second run, and `generate`'s tokens by the margin rule;
   (c) 2 layers of phi-2 (head_dim 80, partial rope, lm head bias),
   phixtral-4x2_8, starcoder2-15b (a 4,500-token prompt past its 4,096
   window), c4ai-command-r-v01 (interleaved rope, logit scale), gpt2-xl
   (learned positions), bloom-7b1 (ALiBi, embedding layernorm) and
   MiniCPM-2B (its scales) at their published widths: prefill and 2
   decode steps through the kernels against the plain versions, greedy
   tokens by the margin rule, flash launches by the dispatch rule; the
   paged kernel at D = 80 against its plain version (bf16 and fp8 pages,
   relaunch bit-equal) and phi-2's paged engine against the plain one by
   the margin rule; (d) a 2-layer HF checkpoint at gemma-3-27b's width
   under a multimodal checkpoint's `language_model.model.` names, its
   ingested bytes equal to `params_from_numpy` + `optimize_model`'s.
22. the serving engine's control plane (after phases 11-12, on phase 7's
   model and pool settings, bf16 pages): (a) phase 7's 16 requests with
   `prefill_chunk_tokens=256`: finish reasons and greedy tokens as engine
   (a)'s by the margin rule, `prefill_chunks` and the GEMM and GEMV
   launches equal to the counts derived on the host from the chunk plan,
   paged launches L a decode step, no page leaks; (b) the decode stall: 7
   requests of 100-420 tokens decode 64 tokens, and 4 steps after all
   decode a 1,900-token prompt arrives, monolithic and in chunks of 256
   and 64: at most one chunk a step, every row emits at every step of the
   admission, the rows' tokens agree by the margin rule; printed: the
   admission's longest and median host-set step, the profiled device
   time of a step holding the prefill or a chunk, the long request's
   TTFT; (c) on a manual clock: `max_queue`'s exact "queue_full" sheds, a
   `queue_deadline_s` shed at the step its clock passes, a `deadline_s`
   "timeout" with partial output, `begin_drain`'s "draining" shed while
   accepted work finishes, `drain()` True, no page leaks; (d) a journal in
   a temporary directory: `crash_before_done` raises FaultError out of
   `step()`, a successor replays the unfinished requests with tokens as an
   uninterrupted run's, a third engine after drain and close replays
   nothing; `nan_logits` finishes exactly one request "error", the others
   as a clean run's; an `alloc_page` storm preempts, every request
   finishes whole, no leaks; (e) 8 traced requests with a request log:
   `validate_nesting` empty, `summarize_trace` counts 8, 8 records with
   good CRCs, no metric drift; the decode step's host-set median and
   device time with tracing off and on.

Every phase ends with one line, `phase N: done in X s, F failed
checks`. The whole run takes about 900-1100 s of command time on an
H100 (the host's speed moves it; phase 16 ~110-140 s of it, phase 18
~100-130 s, phase 19 ~110-135 s, phase 20 ~90-150 s, phase 21 ~40-60
s), the kernel builds included (the
dequant sources build once per qtype: 36 libraries in 50-90 s).
It prints one `{"kernels": [...]}` line (the dequant forms carry their
numbers per format under "by_format"), and as its last line
`{"ok": true, "device": {...}}`. Without a CUDA card, or without the
package beside it, it exits non-zero before printing either.
"""

from __future__ import annotations

import collections
import contextlib
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
# phases 16 (a), 18 and 19: 8 of llama3-8b's 32 layers, full width (16
# until phase 21 joined the script: a run on a slow host read ~1245 s; 12
# until phase 22 did: a run on a slow host read 1058.6 s)
HALF_LAYERS = 8
RAGGED_M = (33, 255, 257, 1000, 4096)
GEMV_CHECK_M, GEMV_R = (1, 3, 4, 8, 17, 32), 128  # the GEMV's row counts (n-tiles 1, 2, 4), adapter width
# the GEMM's launch (x in its steps' order, then the GEMM) and the LoRA
# GEMM's (its first pass, then the same two) in a profiler's kernel names
GEMM_EVENT = re.compile(r"namespace\)::(gemm|x_order)_kernel<([^<>]*, )?(false|\(bool\)0)>")
LORA_GEMM_EVENT = re.compile(r"lora_xa_tc_kernel|namespace\)::(gemm|x_order)_kernel<([^<>]*, )?(true|\(bool\)1)>")
# the LoRA GEMV at 8 rows (one n-tile): its GEMV launch in a profile
LORA_GEMV_EVENT = re.compile(r"namespace\)::gemv_kernel<1, (true|\(bool\)1)>")


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def device_kernels(prof) -> list:
    """The device events of a profiler window, largest first: events with
    device time and no CPU time (the card's own), less the annotations
    that span the kernels they enclose rather than being kernels: the
    optimizer's step (`Optimizer.step#<class>.step`) and a scheduled
    window's steps (`ProfilerStep#<n>`, `profiled_steps`)."""
    return sorted((e for e in prof.key_averages()
                   if e.self_cpu_time_total == 0 and e.self_device_time_total > 0
                   and not e.key.startswith(("Optimizer.", "ProfilerStep"))),
                  key=lambda e: -e.self_device_time_total)


def profiled_steps(torch, run, n: int, expect: dict, label: str):
    """A torch.profiler window over n calls of `run`, synchronised, after
    one warm-up call traced and discarded (the profiler's schedule). The
    caller checks its device calls; `expect` maps a kernel's name to (a
    compiled pattern of its device functions' names, the calls the window
    must hold). Windows without a warm-up call lost one training forward
    at their start: PR 13 run B's phase 6 (63 of 64 training forwards and
    381 of 384 LoRA GEMM kernels) and PR 15 run A's phase 14 (63 of 64
    training forwards, twice in a row), while the wrappers counted every
    launch. A window whose counts still differ is printed with the
    matching names and profiled once more."""
    from torch.profiler import ProfilerActivity, profile, schedule

    want = {name: calls for name, (_, calls) in expect.items()}
    for attempt in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=n, repeat=1)) as prof:
            for _ in range(n + 1):
                run()
                torch.cuda.synchronize()
                prof.step()
        events = prof.key_averages()  # slow on a long window: once
        got = {name: sum(e.count for e in events
                         if pat.search(e.key) and e.self_device_time_total > 0)
               for name, (pat, _) in expect.items()}
        if got == want:
            break
        log(f"{label}: the profiler recorded {got} device calls, expected {want}"
            + ("; profiling the window again" if attempt == 0 else ""))
        for name, (pat, _) in expect.items():
            log(f"  {name}: " + "; ".join(f"{e.count} x {e.key[:120]}" for e in events
                                          if pat.search(e.key)))
    return prof


@contextlib.contextmanager
def warm_profile(activities):
    """torch.profiler.profile(activities) over the block, its tracing
    warmed up first: 32 small kernels traced and discarded (the profiler's
    schedule), then the block recorded. Windows without a warm-up have
    lost a kernel record at their start while the wrappers counted every
    launch (PR 13 run B: phase 6; PR 15 run A: phase 14; PR 15 run E:
    phase 8, 159 of 160 paged decode kernels)."""
    import torch
    from torch.profiler import profile, schedule

    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        x = torch.zeros(256, device="cuda" if torch.cuda.is_available() else "cpu")  # CPU: rehearsals
        for _ in range(32):
            x.add_(1)
        torch.cuda.synchronize()
        prof.step()
        yield prof


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
    from torch.profiler import ProfilerActivity

    for i in range(3):
        fn(*args_list[i % len(args_list)])
    torch.cuda.synchronize()
    with warm_profile([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in device_kernels(prof)) / 1e3 / iters


# the checks that failed: each is reported where it fails and the run goes
# on, so that one run shows every failure; main() then exits 1 before the
# result lines (an exception still ends the run at once)
FAILED: list = []


def check(ok: bool, what: str) -> None:
    if not ok:
        log(f"chip_smoke: FAILED: {what}")
        FAILED.append(what)


# the phase running now: its number, start time and the failures before it
PHASE: dict = {}


def begin_phase(n) -> None:
    """Close the running phase with its line `phase N: done in X s, F
    failed checks`, then start phase n (None: close only)."""
    if PHASE:
        log(f"phase {PHASE['n']}: done in {time.time() - PHASE['t']:.1f} s, "
            f"{len(FAILED) - PHASE['failed']} failed checks")
    PHASE.clear()
    if n is not None:
        PHASE.update(n=n, t=time.time(), failed=len(FAILED))


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
    from torch.profiler import ProfilerActivity

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
    begin_phase(1)
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
    # the decode GEMV (plain and LoRA arms) and the LoRA GEMV's first pass:
    # on the tensor cores (HMMA in the SASS) and unspilled in the paths' formats
    gemv_spills, no_hmma = 0, []
    for qtype in sorted(q for s_, q in dequant if s_ == "qmatmul"):
        sp = tc_kernel_report(libs[("qmatmul", qtype)], ("gemv_kernel", "lora_xa_split_kernel"),
                              label=f"[{qtype}] ", sass=sass[("qmatmul", qtype)])
        if qtype in PATH_FORMATS:
            gemv_spills += sp
            no_hmma += [(qtype, k) for k, n in sass[("qmatmul", qtype)].items()
                        if ("gemv_kernel" in k or "lora_xa_split_kernel" in k) and n == 0]
    check(gemv_spills == 0, f"a GEMV kernel of {PATH_FORMATS} spills")
    check(not no_hmma, f"GEMV kernels without HMMA in their SASS: {no_hmma}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    card = f"{torch.cuda.get_device_name(0)} ({smi})"

    # ---------------------------------------------------------------- 2
    begin_phase(2)
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
        a_l, b_l = randn(GEMV_R, K) / 16, randn(O, GEMV_R) * 0.02
        for M in GEMV_CHECK_M + (33, 1024):
            x = randn(M, K)
            y = kernels.qmatmul(x, w)
            ref = kernels.qmatmul_plain(x, w).float()
            err = (y.float() - ref).abs().max().item()
            # f32 sums in another order, then one bf16 rounding on each
            # side: within 2 bf16 ULPs of the largest output
            tol = ref.abs().max().item() * 2 ** -7
            gemv = M <= kernels.GEMV_MAX_ROWS
            kname = (kernels.GEMV if gemv else kernels.GEMM).name
            errs[kname] = max(errs[kname], err)
            line = f"phase 2: {kname} {name} M={M} O={O} K={K} max_abs_err={err:.6g} tol={tol:.6g}"
            check(bool(torch.isfinite(y).all()) and err <= tol, f"{kname} {name} M={M}")
            if gemv:
                # the LoRA GEMV at R = 128 with the serving decode's gate (its
                # last row all zero at M > 1: that row is the GEMV's bits);
                # both launched twice (the same bits: no atomics)
                gate = lora_gate(torch, dev, M, GEMV_R, "block")
                yl = kernels.qmatmul_lora(x, w, a_l, b_l, gate)
                refl = kernels.qmatmul_lora_plain(x, w, a_l, b_l, gate).float()
                errl = (yl.float() - refl).abs().max().item()
                toll = refl.abs().max().item() * 2 ** -7
                errs[kernels.LORA_GEMV.name] = max(errs[kernels.LORA_GEMV.name], errl)
                same = (torch.equal(y, kernels.qmatmul(x, w))
                        and torch.equal(yl, kernels.qmatmul_lora(x, w, a_l, b_l, gate)))
                base = M == 1 or torch.equal(yl[-1], y[-1])
                line += (f"; {kernels.LORA_GEMV.name} R={GEMV_R} max_abs_err={errl:.6g} tol={toll:.6g}, "
                         f"relaunches bit-equal {same}, zero-gate row = GEMV bits {base}")
                check(bool(torch.isfinite(yl).all()) and errl <= toll and same and base,
                      f"{kernels.LORA_GEMV.name} {name} M={M}: relaunch {same}, zero-gate row {base}")
            log(line)
    dequant_edge_checks(torch, dev, "sym_int4", errs, qweight(200, 2048)[0], randn)
    flash_cases = [("prefill", B, T, S, Hq, Hkv, D, 0, None, None),
                   ("window+softcap", 2, 128, 192, Hq, Hkv, D, 40, 64, 30.0),
                   ("head_dim 64", 2, 96, 128, 8, 2, 64, 0, None, None),
                   ("head_dim 256", 2, 70, 96, 4, 1, 256, 0, None, None),
                   ("head_dim 96 (phi3-mini's, run at 128)", 2, 96, 128, 32, 32, 96, 0, None, None),
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
    # the sums' rounding: each kernel's bf16 outputs off the exactly rounded
    # value, at most twice as many as its plain version's (f32 sums)
    for (form, name), (k, p, n) in misrounding_counts(torch, dev, "sym_int4", shapes).items():
        log(f"phase 2: misrounded {form} {name} M={MISROUND_M} sym_int4: kernel {k}, plain {p} of {n}")
        check(k <= 2 * p, f"{form} {name}: {k} outputs off the exactly rounded value, plain {p}")
    torch.cuda.synchronize()

    # ---------------------------------------------------------------- 3
    begin_phase(3)
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
    begin_phase(4)
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
        box = [state]  # the windows' calls carry the state on

        def prefill_call():
            box[0] = prefill_state()

        def step_call():
            box[0] = step(*box[0])

        prof_prefill = profiled_steps(
            torch, prefill_call, PROFILED_PREFILLS,
            {kernels.GEMM.name: (GEMM_EVENT, 2 * 4 * L * PROFILED_PREFILLS),
             kernels.FLASH.name: (re.compile(r"namespace\)::flash_kernel"), L * PROFILED_PREFILLS)},
            "phase 4 prefill")
        for _ in range(3):
            step_call()
        torch.cuda.synchronize()
        prof = profiled_steps(
            torch, step_call, PROFILED_STEPS,
            {kernels.GEMV.name: (re.compile(r"namespace\)::gemv_kernel"),
                                 (4 * L + 1) * PROFILED_STEPS)}, "phase 4 decode")

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
    # phases 16 (a), 18 and 19 run a llama3-8b of HALF_LAYERS (full width,
    # seed 0), to keep the run inside its limit
    cfg_half = dataclasses.replace(cfg, num_hidden_layers=HALF_LAYERS)
    tm_half = TorchModel(cfg_half, optimize_model(llama.init_params(cfg_half, seed=0), cfg_half,
                                                  "sym_int4"), "sym_int4")
    kernels.reset_launches()
    out_half = tm_half.generate(prompts, max_new_tokens=NEW_TOKENS)
    want_half = {k.name: 0 for k in kernels.KERNELS}
    want_half.update({kernels.GEMM.name: 4 * HALF_LAYERS,
                      kernels.GEMV.name: 1 + (NEW_TOKENS - 1) * (4 * HALF_LAYERS + 1),
                      kernels.FLASH.name: HALF_LAYERS})
    check(kernels.launch_counts() == want_half, "launch counts of the HALF_LAYERS model")
    # --------------------------------------------------------------- 16
    begin_phase(16)
    checkpoint_phases(torch, dev, tm_half, prompts, out_half, want_half)
    # --------------------------------------------------------------- 18
    begin_phase(18)
    cache_policy_phases(torch, dev, card, tm_half, prompts, tok, st, out_half)
    # --------------------------------------------------------------- 19
    begin_phase(19)
    del tm, model
    torch.cuda.empty_cache()
    decode_phases(torch, dev, card, tm_half)
    del tm_half
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 5
    begin_phase(5)
    train_entries = train_phases(torch, dev, cfg, card, errs, qweight, randn)
    # ---------------------------------------------------------------- 7
    begin_phase(7)
    serving_entries, served = serving_phases(torch, dev, cfg, card, errs)
    # --------------------------------------------------------------- 11
    begin_phase(11)
    adapter_entries = adapter_phases(torch, dev, cfg, card, errs, served)
    # --------------------------------------------------------------- 22
    begin_phase(22)
    serving_control_phases(torch, dev, card, served["tm"], served["traffic"], served["reqs_a"])
    del served
    # ---------------------------------------------------------------- 9
    begin_phase(9)
    by_format = format_phases(torch, dev, cfg, card, prompts, tok, st, T, S)
    # --------------------------------------------------------------- 13
    begin_phase(13)
    ft_entries = full_ft_phases(torch, dev, cfg, card, errs, randn)
    # --------------------------------------------------------------- 15
    begin_phase(15)
    phi3_phases(torch, dev, errs)
    # --------------------------------------------------------------- 17
    begin_phase(17)
    flags_phases(torch, dev, card, prompt_tokens, starts)
    torch.cuda.empty_cache()
    # --------------------------------------------------------------- 20
    begin_phase(20)
    moe_phases(torch, dev, card)
    # --------------------------------------------------------------- 21
    begin_phase(21)
    layer_shape_phases(torch, dev, card)
    begin_phase(None)
    for e in entries + train_entries + adapter_entries:
        if e["name"] in by_format:  # the dequant forms: sym_int4 above, then the others
            e["formats"] = ["sym_int4"] + list(by_format[e["name"]])
            e["by_format"] = by_format[e["name"]]
    if FAILED:
        log(f"chip_smoke: {len(FAILED)} check(s) failed: {FAILED}")
        return 1
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
    begin_phase(6)
    # each kernel's device functions: the LoRA GEMM's first pass, x_order
    # and its GEMM are three a launch
    matches = [(kernels.LORA_GEMM, LORA_GEMM_EVENT, 3),
               (kernels.DX, re.compile(r"namespace\)::dx_kernel"), 1),
               (kernels.FLASH_FWD, re.compile(r"namespace\)::fwd_kernel"), 1),
               (kernels.FLASH_DQ, re.compile(r"namespace\)::dq_kernel"), 1),
               (kernels.FLASH_DKV, re.compile(r"namespace\)::dkv_kernel"), 1)]
    prof = profiled_steps(torch, lambda: step(model, lora, tokens, mask), PROFILED_TRAIN_STEPS,
                          {k.name: (m, per_step[k.name] * PROFILED_TRAIN_STEPS * parts)
                           for k, m, parts in matches}, "phase 6")
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

    path_ms = {k.name: on_path(k, m, parts) for k, m, parts in matches}
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
    begin_phase(14)
    prof = profiled_steps(
        torch, lambda: step(model, tokens, mask), PROFILED_TRAIN_STEPS,
        {kernels.DW.name: (re.compile(r"dw_tma_kernel<"),
                           per_step[kernels.DW.name] * PROFILED_TRAIN_STEPS),
         **{k.name: (re.compile(f"namespace\\)::{fn}"), per_step[k.name] * PROFILED_TRAIN_STEPS)
            for k, fn in ((kernels.FLASH_FWD, "fwd_kernel"), (kernels.FLASH_DQ, "dq_kernel"),
                          (kernels.FLASH_DKV, "dkv_kernel"))}}, "phase 14")
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
    from torch.profiler import ProfilerActivity

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
    fp8_flash = re.compile(r"flash_kernel<128, (true|\(bool\)1)>")
    with warm_profile(acts) as prof_e:  # the admission step: 4 prefills
        eng.step()
        torch.cuda.synchronize()
    eng.run_until_idle()
    launches_e = kernels.launch_counts()
    got = sum(e.count for e in prof_e.key_averages()
              if fp8_flash.search(e.key) and e.self_device_time_total > 0)
    if got != 4 * L:
        # a window short of a kernel record (the profiler's, not the
        # wrappers': `profiled_steps`): profile another admission once
        log(f"phase 7 (e): the profiler recorded {got} fp8 flash calls, expected {4 * L}; "
            "profiling the admission again")
        again = engine(quantize_kv=True)
        for sp in fp8_specs:
            again.submit(**sp)
        with warm_profile(acts) as prof_e:
            again.step()
            torch.cuda.synchronize()
        del again
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
    begin_phase(8)
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
        flag = "true" if fp8 else "false"
        prof = profiled_steps(
            torch, eng.step, PROFILED_DECODES,
            {kern.name: (re.compile(rf"paged_split_kernel<128, ({flag}|\(bool\){int(fp8)}), "),
                         L * PROFILED_DECODES)}, f"phase 8 {'fp8' if fp8 else 'bf16'} pages")
        del eng
        busy = sum(e.self_device_time_total for e in device_kernels(prof)) / 1e3 / PROFILED_DECODES
        med = sorted(host)[len(host) // 2]
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
    from torch.profiler import ProfilerActivity

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
    begin_phase(12)
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
    prof = profiled_steps(torch, eng.step, PROFILED_DECODES,
                          {kernels.LORA_GEMV.name: (LORA_GEMV_EVENT, 2 * L * PROFILED_DECODES)},
                          "phase 12 adapter decode step")
    R = SLOTS * rank_bucket(max(ADAPTER_RANKS[:3]))
    del eng
    dev_events = device_kernels(prof)
    busy = sum(e.self_device_time_total for e in dev_events) / 1e3 / PROFILED_DECODES
    med = sorted(host)[len(host) // 2]
    gemv_evs = [e for e in dev_events if LORA_GEMV_EVENT.search(e.key)]
    xa_evs = [e for e in dev_events if "lora_xa_split_kernel<1>" in e.key]
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
# serving's control plane: phase 22
# ---------------------------------------------------------------------------

CHUNK, CHUNK_SMALL = 256, 64  # (a) and (b)'s chunks; (b) runs both
# (b): 7 independent requests decode 64 tokens each; 4 steps after all 7
# decode, a 1,900-token prompt arrives
STALL_LENS, STALL_NEW = (100, 150, 200, 260, 310, 370, 420), 64
STALL_LONG, STALL_LONG_NEW = 1900, 16
CONTROL_LEN, CONTROL_NEW = 64, 8  # (c) and (d)'s requests: 64 tokens, 8 new (16 in (d))
# A chunked prefill takes other routes than the monolithic one: a last
# chunk of up to 32 rows runs the GEMV where the whole tail ran the GEMM,
# and the rows' sums go in other orders. Through 32 layers that moved
# chosen-token logprobs by up to 0.126 nat on the H100 (PERF.md, phase
# 22; past LOGPROB_TOL's 0.05 for one route), as the dense and paged pools'
# routes move first tokens by 0.125-0.16 (phase 7): (a) and (b) hold
# chunked against monolithic by the cross-route bound, MARGIN_TOL.


def margin_rule(ref, got, what: str, tol_lp: float = LOGPROB_TOL[False]) -> float:
    """`got`'s greedy tokens against `ref`'s (which carries its top two
    logprobs): equal up to the first difference, which must sit where
    ref's top-1/top-2 margin is within MARGIN_TOL, and chosen-token
    logprobs within tol_lp up to there. Returns the largest logprob
    difference."""
    n = min(len(ref.out_tokens), len(got.out_tokens))
    diff = next((i for i in range(n) if ref.out_tokens[i] != got.out_tokens[i]), None)
    upto = n if diff is None else diff
    worst = max((abs(a - b) for a, b in zip(ref.out_logprobs[:upto], got.out_logprobs[:upto])),
                default=0.0)
    check(worst <= tol_lp, f"{what}: chosen-token logprobs differ by {worst} > {tol_lp}")
    if diff is not None:
        top = sorted(ref.out_top_logprobs[diff].values(), reverse=True)
        check(top[0] - top[1] <= MARGIN_TOL, f"{what}: token {diff} differs at margin "
                                             f"{top[0] - top[1]} > {MARGIN_TOL}")
    return worst


def prefill_launches(cfg, n: int, qtype: str = "sym_int4") -> tuple[int, int]:
    """(GEMM, GEMV) launches of one prefill call of n rows: each of the 4
    projections a layer takes the GEMV where `kernels.qmatmul` does (n <=
    GEMV_MAX_ROWS and a GEMV tile holds the rows), else the GEMM; the lm
    head's last row takes the GEMV."""
    from bigdl_tpu_torch.ops.kernels import GEMV_MAX_ROWS
    from bigdl_tpu_torch.ops.kernels.qtile import gemv_tile

    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    shapes = ((cfg.q_dim + 2 * cfg.kv_dim, H), (H, cfg.q_dim), (2 * I, H), (H, I))
    gemv = sum(1 for O, K in shapes if n <= GEMV_MAX_ROWS and gemv_tile(n, O, K, qtype) is not None)
    return L * (4 - gemv), L * gemv + 1


def record_prefills(eng) -> list:
    """Wrap the engine's paged prefill: each call appends (the request's
    key, its prompt length, pos0, rows). A chunk plan's calls share its
    rid; a monolithic prefill is a call of its own."""
    calls = []
    orig = eng._paged_prefill

    def rec(row, pos0, tail, lora=None):
        st = eng._prefilling
        key = st.req.rid if st is not None else ("whole", len(calls))
        total = len(st.req.prompt) if st is not None else pos0 + len(tail)
        calls.append((key, total, pos0, len(tail)))
        return orig(row, pos0, tail, lora)
    eng._paged_prefill = rec
    return calls


def chunk_plan(calls, chunk: int) -> tuple[int, list]:
    """From the recorded calls, the chunk count the plan gives on the host
    (each request: one call when its uncached tail fits a chunk, else
    ceil(tail / chunk)) and the requests whose calls differ from it."""
    plans = collections.OrderedDict()
    for key, total, pos0, n in calls:
        plans.setdefault(key, (total, pos0, []))[2].append(n)
    want, bad = 0, []
    for key, (total, pos0, got) in plans.items():
        tail = total - pos0
        k = max(1, -(-tail // chunk))
        sizes = [chunk] * (k - 1) + [tail - chunk * (k - 1)]
        want += k
        if got != sizes:
            bad.append((key, got, sizes))
    return want, bad


def serving_control_phases(torch, dev, card, tm, traffic, reqs_a=None) -> None:
    """Phase 22: the serving engine's control plane on phase 7's model
    (llama3-8b sym_int4, 32 layers unless the caller cut them) at `cli
    serve`'s defaults, bf16 pages: (a) chunked prefill over phase 7's
    traffic against engine (a)'s monolithic tokens (`reqs_a`: made here
    when None), its chunk and launch counts against the host's plan; (b)
    the decode stall a long prompt causes, monolithic and chunked; (c)
    overload control and the drain on a manual clock; (d) the journal's
    crash and replay, NaN logits and a page-allocation storm; (e)
    tracing, the request log and the metrics exposition."""
    import tempfile

    import numpy as np
    from torch.profiler import ProfilerActivity

    from bigdl_tpu_torch.obs.tracing import (RequestLog, TraceRecorder, summarize_trace,
                                             validate_nesting)
    from bigdl_tpu_torch.ops import kernels
    from bigdl_tpu_torch.serving import InferenceEngine
    from bigdl_tpu_torch.serving.faults import FaultError, FaultInjector
    from bigdl_tpu_torch.serving.journal import split_crc_line
    from bigdl_tpu_torch.serving.metrics import Metrics, metric_drift

    cfg = tm.config
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    # device activity only: reducing a CPU trace of a chunk step took ~4 s
    # of the window the TTFT spans (PERF.md, phase 22)
    acts = [ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU]  # CPU: rehearsals
    log(f"phase 22: card {card}")

    def engine(**kw):
        return InferenceEngine(tm, n_slots=SLOTS, max_len=MAX_LEN, page_size=PAGE, paged=True, **kw)

    # (a) chunked prefill over phase 7's traffic ---------------------------
    t0 = time.time()
    if reqs_a is None:
        ref_eng = engine(logprobs_top_k=2)
        reqs_a = [ref_eng.submit(**sp) for sp in traffic]
        ref_eng.run_until_idle()
        del ref_eng
        torch.cuda.empty_cache()
    eng = engine(prefill_chunk_tokens=CHUNK)
    calls = record_prefills(eng)
    kernels.reset_launches()
    reqs = [eng.submit(**sp) for sp in traffic]
    eng.run_until_idle()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    steps = eng.decode_step_seconds.count
    want_chunks, bad = chunk_plan(calls, CHUNK)
    want_gemm = sum(prefill_launches(cfg, n)[0] for *_, n in calls)
    want_gemv = sum(prefill_launches(cfg, n)[1] for *_, n in calls) + steps * (4 * L + 1)
    worst = 0.0
    for i, (ra, rc) in enumerate(zip(reqs_a, reqs)):
        check(rc.finish_reason == ra.finish_reason,
              f"(a) request {i}: finish reason {rc.finish_reason} against {ra.finish_reason}")
        if not traffic[i].get("do_sample"):
            worst = max(worst, margin_rule(ra, rc, f"(a) request {i}", MARGIN_TOL))
    log(f"phase 22 (a) chunked prefill ({CHUNK} tokens): {len(reqs)} requests in "
        f"{time.time() - t0:.3f} s, {steps} decode steps, prefill_chunks={eng.prefill_chunks} "
        f"(the plan on the host: {want_chunks}; {len(calls)} calls, sizes off the plan: {bad}), "
        f"prefix_hits={eng.prefix_hits} partial={eng.prefix_partial_hits} "
        f"page_leaks={eng.page_leaks()}; launches {launches}, GEMM/GEMV from the plan "
        f"{want_gemm}/{want_gemv}; greedy tokens as engine (a)'s by the margin rule, largest "
        f"logprob difference {worst:.5f}")
    check(eng.prefill_chunks == want_chunks and not bad, "(a) prefill_chunks = the host's plan")
    check(launches[kernels.GEMM.name] == want_gemm and launches[kernels.GEMV.name] == want_gemv,
          "(a) GEMM and GEMV launches = the plan's")
    check(launches[kernels.PAGED.name] == L * steps, "(a) paged launches = L x decode steps")
    check(eng.page_leaks() == 0, "(a) page leaks")
    del eng
    torch.cuda.empty_cache()

    # (b) the decode stall: a long prompt arrives beside 7 decoding rows --
    rng = np.random.default_rng(22)
    short = [rng.integers(1, V, n).tolist() for n in STALL_LENS]
    long_prompt = rng.integers(1, V, STALL_LONG).tolist()
    stall = {}
    for chunk in (None, CHUNK, CHUNK_SMALL):
        eng = engine(logprobs_top_k=2, prefill_chunk_tokens=chunk)
        rows = [eng.submit(p, max_new_tokens=STALL_NEW) for p in short]
        while not all(r.out_tokens for r in rows):
            eng.step()
        for _ in range(4):
            eng.step()
        longr = eng.submit(long_prompt, max_new_tokens=STALL_LONG_NEW)
        host, busy, per_step, emits, overhead = [], None, [], True, 0.0
        i = 0
        while longr.first_token_ts is None:
            before = ([len(r.out_tokens) for r in rows], eng.prefill_chunks)
            # the device time of the step holding the prefill (monolithic)
            # or the second chunk; the profiler's own setup and teardown
            # before the first token are taken out of the TTFT
            t_in = time.perf_counter()
            with (warm_profile(acts) if i == (0 if chunk is None else 1)
                  else contextlib.nullcontext()) as prof:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                eng.step()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                host.append((t2 - t1) * 1e3)
            if prof is not None:
                busy = sum(e.self_device_time_total for e in device_kernels(prof)) / 1e3
                after = time.perf_counter() - t2  # teardown: before the first token?
                overhead += (t1 - t_in) + after * (longr.first_token_ts is None)
            per_step.append(eng.prefill_chunks - before[1])
            emits &= all(len(r.out_tokens) == n + 1 for r, n in zip(rows, before[0]) if not r.done)
            i += 1
        eng.run_until_idle()
        host.sort()
        ttft = (longr.first_token_ts - longr.submit_ts - overhead) * 1e3
        stall[chunk] = rows
        log(f"phase 22 (b) {'monolithic' if chunk is None else f'chunk {chunk}'}: the "
            f"{STALL_LONG}-token prompt prefilled over {i} steps, chunks a step {per_step}; "
            f"host-set step during the admission: longest {host[-1]:.3f} ms, median "
            f"{host[len(host) // 2]:.3f} ms (n={len(host)}); profiled device time of a step "
            f"holding {'the prefill' if chunk is None else 'a chunk'} {busy:.3f} ms; the long "
            f"request's TTFT {ttft:.3f} ms (the profiler's {overhead * 1e3:.1f} ms out); each "
            f"row emitted every step {emits}; page_leaks={eng.page_leaks()}")
        if chunk is not None:
            check(max(per_step) <= 1, f"(b) chunk {chunk}: at most one chunk a step")
            check(emits, f"(b) chunk {chunk}: each decoding row emits every step of the admission")
        check(eng.page_leaks() == 0 and longr.finish_reason == "length", f"(b) chunk {chunk}")
        del eng
        torch.cuda.empty_cache()
    worst = 0.0
    for chunk in (CHUNK, CHUNK_SMALL):
        for j, (ref, got) in enumerate(zip(stall[None], stall[chunk])):
            worst = max(worst, margin_rule(ref, got, f"(b) chunk {chunk} row {j}", MARGIN_TOL))
    log(f"phase 22 (b): the 7 rows' tokens agree across the three engines by the margin rule "
        f"(largest logprob difference {worst:.5f})")

    # (c) overload control and the drain, on a manual clock ----------------
    clock = [1000.0]
    eng = engine(max_queue=4, clock=lambda: clock[0])

    def sub(**kw):
        return eng.submit(rng.integers(1, V, CONTROL_LEN).tolist(), **{
            "max_new_tokens": CONTROL_NEW, **kw})

    def tick(n=1):
        for _ in range(n):
            eng.step()
            clock[0] += 0.1
    first = [sub() for _ in range(4)]
    tick()
    second = [sub() for _ in range(6)]  # 4 queued, 2 over the bound
    full = [r for r in second if r.shed_kind == "queue_full"]
    tick()
    timed = sub(max_new_tokens=64, deadline_s=1.0)  # waits for a slot, then runs out
    late = [sub(queue_deadline_s=0.45) for _ in range(2)]  # no slot frees before step 5
    shed_at = None
    for k in range(12):
        tick()
        if shed_at is None and all(r.shed_kind == "queue_deadline" for r in late):
            shed_at = k
    eng.begin_drain()
    drained = sub()
    ok_drain = eng.drain()
    tok_timed = len(timed.out_tokens)
    log(f"phase 22 (c) overload: queue_full sheds {len(full)} (want 2), queue_deadline sheds "
        f"at step {shed_at} after submit (its clock passes 0.45 s at step 5), timeout "
        f"{timed.finish_reason} after {tok_timed} tokens ({timed.error}), draining shed "
        f"{drained.shed_kind}, drain() {ok_drain}, requests_shed={eng.requests_shed} "
        f"request_timeouts={eng.request_timeouts} finish_reasons={dict(eng.finish_reasons)} "
        f"page_leaks={eng.page_leaks()}")
    check(len(full) == 2 and all(r.finish_reason == "shed" for r in full), "(c) queue_full sheds")
    check(shed_at == 5, "(c) the queue-deadline shed at the step its clock passes")
    check(timed.finish_reason == "timeout" and 0 < tok_timed < 64, "(c) deadline_s timeout")
    check(drained.shed_kind == "draining" and ok_drain and eng.idle(), "(c) the drain")
    check(all(r.finish_reason == "length" and len(r.out_tokens) == CONTROL_NEW
              for r in first + [r for r in second if r not in full]), "(c) accepted work finishes")
    check(eng.requests_shed == 5 and eng.request_timeouts == 1 and eng.page_leaks() == 0,
          "(c) counters and page leaks")
    del eng
    torch.cuda.empty_cache()

    # (d) the journal's crash and replay; NaN logits; a page storm --------
    prompts = [rng.integers(1, V, n).tolist() for n in (100, 230, 310, 420)]
    clean_eng = engine(logprobs_top_k=2)
    clean = [clean_eng.submit(p, max_new_tokens=16) for p in prompts]
    clean_eng.run_until_idle()
    del clean_eng
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        jpath = str(Path(tmp) / "journal.jsonl")
        eng = engine(journal=jpath, faults=FaultInjector(0).arm("crash_before_done", times=1))
        for p in prompts:
            eng.submit(p, max_new_tokens=16)
        crashed = None
        for k in range(200):
            try:
                if not eng.step():
                    break
            except FaultError as e:
                crashed = (k, str(e))
                break
        check(crashed is not None, "(d) crash_before_done: FaultError left step()")
        del eng  # the process dies: no tombstone, no cleanup
        torch.cuda.empty_cache()
        succ = engine(journal=jpath)
        rec = succ.recovered_requests
        succ.run_until_idle()
        by_prompt = {tuple(r.prompt): r for r in rec}
        for i, p in enumerate(prompts):
            check(tuple(p) in by_prompt, f"(d) request {i} replayed")
            if tuple(p) in by_prompt:
                margin_rule(clean[i], by_prompt[tuple(p)], f"(d) replayed request {i}")
        check(succ.drain(), "(d) the successor drains")
        succ.close()
        del succ
        torch.cuda.empty_cache()
        third = engine(journal=jpath)
        log(f"phase 22 (d) journal: crash at step {crashed}; the successor replayed "
            f"{len(rec)} requests (rids {[r.rid for r in rec]}), tokens as the uninterrupted "
            f"run's by the margin rule; after drain and close a third engine replays "
            f"{len(third.recovered_requests)}")
        check(len(rec) == len(prompts) and third.recovered_requests == [], "(d) replay counts")
        del third
        torch.cuda.empty_cache()
    inj = FaultInjector(0)
    eng = engine(faults=inj)
    reqs = [eng.submit(p, max_new_tokens=16) for p in prompts]
    eng.step()
    victim = int(np.nonzero(eng.active)[0][0])
    inj.arm("nan_logits", times=1, slots=[victim])
    eng.run_until_idle()
    errors = [i for i, r in enumerate(reqs) if r.finish_reason == "error"]
    for i, r in enumerate(reqs):
        if i not in errors:
            margin_rule(clean[i], r, f"(d) nan_logits, request {i}")
    log(f"phase 22 (d) nan_logits on slot {victim}: requests finishing 'error' {errors} "
        f"({reqs[errors[0]].error if errors else None}), the others as the clean run's")
    check(len(errors) == 1, "(d) nan_logits quarantines exactly one request")
    check(eng.page_leaks() == 0, "(d) nan_logits page leaks")
    del eng
    torch.cuda.empty_cache()
    inj = FaultInjector(0)
    eng = engine(faults=inj)
    reqs = [eng.submit(p, max_new_tokens=16) for p in prompts]
    eng.step()
    inj.arm("alloc_page", times=3)  # the next decode page growth preempts 3 victims
    eng.run_until_idle()
    for i, r in enumerate(reqs):
        margin_rule(clean[i], r, f"(d) alloc_page storm, request {i}")
    log(f"phase 22 (d) alloc_page storm: preemptions={eng.preemptions} "
        f"resumes={eng.preemption_resumes} finish {[r.finish_reason for r in reqs]} "
        f"page_leaks={eng.page_leaks()}")
    check(eng.preemptions > 0 and all(r.finish_reason == "length" and len(r.out_tokens) == 16
                                      for r in reqs) and eng.page_leaks() == 0,
          "(d) the storm preempts, every request finishes whole, no leak")
    del eng
    torch.cuda.empty_cache()

    # (e) tracing, the request log, the metrics exposition -----------------
    with tempfile.TemporaryDirectory() as tmp:
        tr = TraceRecorder()
        lpath = str(Path(tmp) / "requests.jsonl")
        eng = engine(tracer=tr, request_log=lpath)
        reqs = [eng.submit(**sp) for sp in traffic[:8]]
        eng.run_until_idle()
        eng.close()
        events = tr.events()
        summary = summarize_trace(events)
        nreq = sum(summary["requests"]["finish_reasons"].values())
        recs = RequestLog.read(lpath)
        crc_ok = all(split_crc_line(x.strip())[1] is True for x in open(lpath) if x.strip())
        drift = metric_drift(Metrics(eng).render(), eng)
        log(f"phase 22 (e) tracing: {len(events)} events, nesting faults "
            f"{len(validate_nesting(events))}, summarize_trace: {nreq} requests "
            f"{summary['requests']['finish_reasons']}, spans "
            f"{ {k: v['count'] for k, v in summary['spans'].items()} }; request log "
            f"{len(recs)} records, crc {crc_ok}; metric drift {drift}")
        check(validate_nesting(events) == [] and nreq == 8, "(e) nesting and the summary")
        check(len(recs) == 8 and crc_ok, "(e) the request log")
        check(drift == ([], []), "(e) metric drift")
        del eng
        torch.cuda.empty_cache()
    # the decode step with tracing off and on, 8 rows of ~1,100 live slots
    steady = [rng.integers(1, V, STEADY_LEN + 13 * i).tolist() for i in range(SLOTS)]
    tr = TraceRecorder(enabled=False)
    eng = engine(tracer=tr)
    for p in steady:
        eng.submit(p, max_new_tokens=SERVE_NEW)
    for _ in range(4):
        eng.step()
    for enabled in (False, True):
        tr.enabled = enabled
        host = []
        for _ in range(8):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t1) * 1e3)
        with warm_profile(acts) as prof:
            for _ in range(2):
                eng.step()
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in device_kernels(prof)) / 1e3 / 2
        log(f"phase 22 (e) decode step, tracing {'on' if enabled else 'off'}: host-set median "
            f"{sorted(host)[4]:.3f} ms (n=8), profiled device time {busy:.3f} ms")
    del eng
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phi3-mini: head_dim 96 through the attention kernels (phase 15)
# ---------------------------------------------------------------------------

PHI3_LAYERS, PHI3_PROMPTS, PHI3_NEW = 2, (200, 150, 97, 17), 16


def phi3_phases(torch, dev, errs) -> None:
    """Phase 15: a 2-layer phi3-mini at full width (hidden 3072, 32 heads
    of 96 over 32 kv heads, intermediate 8192, vocab 32064), sym_int4,
    weights from a seed. Its head_dim runs the flash kernels at 128 (zero-
    padded) and the paged kernel's D = 96 instantiation. Against the plain
    versions on the card: prefill logits through `flash_attention`; the
    chosen-token logprobs of a paged engine's decode steps through
    `paged_attention`; one QLoRA step's loss and LoRA gradients through
    the flash backward. Each of those kernels must have launched."""
    import numpy as np

    from bigdl_tpu_torch import PRESETS, TorchModel, optimize_model
    from bigdl_tpu_torch.generate import pad_prompts
    from bigdl_tpu_torch.kvcache import init_cache
    from bigdl_tpu_torch.models import llama
    from bigdl_tpu_torch.ops import kernels
    from bigdl_tpu_torch.serving import InferenceEngine
    from bigdl_tpu_torch.train import init_lora, next_token_loss

    cfg = dataclasses.replace(PRESETS["phi3-mini"], num_hidden_layers=PHI3_LAYERS)
    L, V, Hkv, D = cfg.num_hidden_layers, cfg.vocab_size, cfg.num_key_value_heads, cfg.head_dim_
    check(D == 96, f"phi3-mini head_dim {D}")
    t0 = time.time()
    model = optimize_model(llama.init_params(cfg, seed=40, device=dev), cfg, "sym_int4")
    torch.cuda.synchronize()
    rng = np.random.default_rng(41)
    prompts = [rng.integers(1, V, n).tolist() for n in PHI3_PROMPTS]
    tokens, starts = pad_prompts(prompts, 0)
    tok = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    st = torch.as_tensor(starts, device=dev)
    T = tok.shape[1]

    # prefill through the flash kernel (D = 96 run at 128)
    def prefill_logits():
        cache = dataclasses.replace(init_cache(L, len(prompts), T + 8, Hkv, D, device=dev), start=st)
        with torch.inference_mode():
            return llama.forward(cfg, model, tok, cache, "prefill", last_logits_only=True)[0][:, -1]

    kernels.reset_launches()
    kern_logits = prefill_logits()
    torch.cuda.synchronize()
    flash_n = kernels.FLASH.launches
    with mock.patch.object(kernels, "qmatmul", kernels.qmatmul_plain), \
            mock.patch.object(kernels, "flash_attention", kernels.flash_attention_plain):
        plain_logits = prefill_logits()
    lerr = (kern_logits - plain_logits).abs().max().item()
    ltol = 0.02 * plain_logits.abs().max().item()  # phase 3's bound
    log(f"phase 15: phi3-mini {L} layers (full width, D={D}) sym_int4 built and prefilled in "
        f"{time.time() - t0:.1f} s: prefill logits kernels vs plain max_abs_err={lerr:.6g} "
        f"tol={ltol:.6g}, flash launches {flash_n}")
    check(bool(torch.isfinite(kern_logits).all()) and lerr <= ltol and flash_n == L,
          "phi3-mini prefill logits through the flash kernel")

    # decode steps of a paged engine through the paged kernel (D = 96)
    tm = TorchModel(cfg, model, "sym_int4", device=dev)
    specs = [dict(prompt=p_, max_new_tokens=PHI3_NEW) for p_ in prompts]

    def serve():
        eng = InferenceEngine(tm, n_slots=4, max_len=512, page_size=PAGE, paged=True)
        rs = [eng.submit(**sp) for sp in specs]
        eng.run_until_idle()
        check(eng.page_leaks() == 0, "phi3-mini engine page leaks")
        return [r.out_logprobs for r in rs], [r.out_tokens for r in rs], eng.decode_step_seconds.count

    kernels.reset_launches()
    lk, tk, steps = serve()
    launches = kernels.launch_counts()
    with mock.patch.multiple(kernels, qmatmul=kernels.qmatmul_plain,
                             flash_attention=kernels.flash_attention_plain,
                             paged_attention=kernels.paged_attention_plain):
        lp_, tp_, _ = serve()
    worst = 0.0
    for a, b_, ta, tb in zip(lk, lp_, tk, tp_):
        n = next((j for j, (x, y) in enumerate(zip(ta, tb)) if x != y), len(ta)) + 1
        worst = max(worst, max(abs(x - y) for x, y in zip(a[:n], b_[:n])))
    log(f"phase 15: phi3-mini paged engine, {len(specs)} requests x {PHI3_NEW} tokens, {steps} "
        f"decode steps: chosen-token logprobs kernels vs plain max_abs_err={worst:.5f} nat "
        f"(tol {LOGPROB_TOL[False]}, up to the first differing token); launches {launches}")
    check(launches[kernels.PAGED.name] == L * steps > 0 and launches[kernels.GEMV.name] > 0,
          "phi3-mini engine: paged launches = layers x decode steps, GEMV launched")
    check(worst <= LOGPROB_TOL[False], "phi3-mini paged engine kernels vs plain")
    del tm

    # one QLoRA step through the flash backward (D = 96 run at 128)
    lora = init_lora(cfg, seed=42, rank=RANK, device=dev)
    with torch.no_grad():  # B != 0, so the A gradients are not all 0
        for pair in lora.layers.values():
            pair["b"].copy_(torch.randn(pair["b"].shape, device=dev,
                                        generator=torch.Generator(device=dev).manual_seed(43)) * 0.01)
    ttok = torch.as_tensor(rng.integers(1, V, (1, 256)), dtype=torch.long, device=dev)
    mask = torch.ones(ttok.shape, device=dev)

    def grads():
        for prm in lora.parameters():
            prm.grad = None
        loss = next_token_loss(cfg, llama.forward, model, lora, ttok, mask)
        loss.backward()
        return loss.item(), {n: prm.grad.float() for n, prm in lora.named_parameters()}

    kernels.reset_launches()
    kern_loss, kern_grads = grads()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    plain = {"qmatmul": kernels.qmatmul_plain, "qmatmul_dx": kernels.qmatmul_dx_plain,
             "qmatmul_lora": kernels.qmatmul_lora_plain,
             "flash_train_fwd": kernels.flash_attention_train_plain,
             "flash_train_dq": kernels.flash_train_dq_plain,
             "flash_train_dkv": kernels.flash_train_dkv_plain}
    with mock.patch.multiple(kernels, **plain):
        plain_loss, plain_grads = grads()
    worst = max(((kern_grads[n] - g).abs().max() / g.abs().max()).item()
                for n, g in plain_grads.items())
    log(f"phase 15: phi3-mini QLoRA step (B=1 T=256, rank {RANK}) kernels vs plain: loss "
        f"{kern_loss:.6f} vs {plain_loss:.6f}; worst LoRA grad max_abs_err / max|grad| = "
        f"{worst:.4g} (tol 0.05, phase 5's); launches {launches}")
    check(all(launches[k.name] == L for k in (kernels.FLASH_FWD, kernels.FLASH_DQ, kernels.FLASH_DKV)),
          "phi3-mini QLoRA step: one launch of each flash-train kernel a layer")
    check(abs(kern_loss - plain_loss) <= 1e-3 * abs(plain_loss) and worst <= 0.05,
          "phi3-mini QLoRA step, kernels vs plain")
    del model, lora, kern_grads, plain_grads


# ---------------------------------------------------------------------------
# the other 15 weight formats: phases 9 and 10
# ---------------------------------------------------------------------------

# checkpoints from disk (phase 16): the script's own safetensors writer
# and an HF checkpoint of llama3-8b's published config.json values
ST_DTYPES = {"bfloat16": "BF16", "float16": "F16", "float32": "F32", "float64": "F64",
             "int8": "I8", "int16": "I16", "int32": "I32", "int64": "I64", "uint8": "U8"}
LLAMA3_8B_HF = {  # Meta-Llama-3-8B config.json, but for num_hidden_layers
    "architectures": ["LlamaForCausalLM"], "model_type": "llama", "vocab_size": 128256,
    "hidden_size": 4096, "intermediate_size": 14336, "num_hidden_layers": 4,
    "num_attention_heads": 32, "num_key_value_heads": 8, "rope_theta": 500000.0,
    "rms_norm_eps": 1e-05, "max_position_embeddings": 8192, "tie_word_embeddings": False,
    "rope_scaling": None, "hidden_act": "silu", "attention_bias": False, "mlp_bias": False,
    "bos_token_id": 128000, "eos_token_id": 128001, "torch_dtype": "bfloat16",
}


def write_safetensors(path, entries) -> int:
    """A safetensors file from `entries`, [(name, dtype, shape, make)]:
    the 8-byte header length, the JSON header (padded with spaces to 8
    bytes), then each tensor's little-endian bytes in order, `make()`
    called for one tensor at a time (a CPU tensor). Returns the bytes
    written."""
    import torch

    header, off = {}, 0
    for name, dtype, shape, _ in entries:
        n = math.prod(shape) * dtype.itemsize
        header[name] = {"dtype": ST_DTYPES[str(dtype).split(".")[-1]], "shape": list(shape),
                        "data_offsets": [off, off + n]}
        off += n
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for name, dtype, shape, make in entries:
            t = make()
            assert t.dtype == dtype and tuple(t.shape) == tuple(shape), name
            f.write(t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return 8 + len(head) + off


def hf_llama_entries(torch, hf: dict, seed: int, dev, prefix: str = ""):
    """An HF llama-shaped checkpoint's tensors as write_safetensors
    entries, per shard (two: the embedding and the first half of the
    layers, then the rest, the final norm and the lm head): bf16 N(0,
    0.02^2) matrices from a seed, made on `dev`, and unit norms (zero
    weights under gemma's (1 + w), the same unit scale). The flags' tensors
    follow each layer's llama ones: q/k/v (and o) biases where the config
    has them (qwen2's q/k/v always), gemma2's and gemma3's pre/post
    feed-forward norms, qwen3's and gemma3's q/k norms; a tied head
    (gemma's default) writes no lm_head. A multimodal config's fields come
    from its text_config; `prefix` goes before every name (gemma3's
    multimodal checkpoints: "language_model.")."""
    hf = {**hf, **hf.get("text_config", {})}
    H, I, V = hf["hidden_size"], hf["intermediate_size"], hf["vocab_size"]
    mt = hf["model_type"]
    L = hf["num_hidden_layers"]
    D = hf.get("head_dim") or hf["hidden_size"] // hf["num_attention_heads"]
    QD, KD = hf["num_attention_heads"] * D, hf["num_key_value_heads"] * D
    gemma = mt.startswith("gemma")
    g = torch.Generator(device=dev).manual_seed(seed)

    def mat(shape):
        return lambda: (torch.randn(shape, device=dev, generator=g) * 0.02).to(torch.bfloat16).cpu()

    def ones(n):
        if gemma:
            return lambda: torch.zeros(n, dtype=torch.bfloat16)
        return lambda: torch.ones(n, dtype=torch.bfloat16)

    def layer(i):
        p = f"model.layers.{i}."
        parts = [
            ("input_layernorm.weight", (H,), ones(H)),
            ("post_attention_layernorm.weight", (H,), ones(H)),
            ("self_attn.q_proj.weight", (QD, H), mat((QD, H))),
            ("self_attn.k_proj.weight", (KD, H), mat((KD, H))),
            ("self_attn.v_proj.weight", (KD, H), mat((KD, H))),
            ("self_attn.o_proj.weight", (H, QD), mat((H, QD))),
            ("mlp.gate_proj.weight", (I, H), mat((I, H))),
            ("mlp.up_proj.weight", (I, H), mat((I, H))),
            ("mlp.down_proj.weight", (H, I), mat((H, I)))]
        if hf.get("attention_bias", mt == "qwen2"):
            parts += [(f"self_attn.{n}_proj.bias", (r,), mat((r,)))
                      for n, r in (("q", QD), ("k", KD), ("v", KD))]
        if mt.startswith(("gemma2", "gemma3")):
            parts += [(n, (H,), ones(H)) for n in ("pre_feedforward_layernorm.weight",
                                                   "post_feedforward_layernorm.weight")]
        if mt == "qwen3":
            parts += [(f"self_attn.{n}_norm.weight", (D,), lambda: torch.ones(D, dtype=torch.bfloat16))
                      for n in ("q", "k")]
        if mt.startswith("gemma3"):
            parts += [(f"self_attn.{n}_norm.weight", (D,), ones(D)) for n in ("q", "k")]
        return [(prefix + p + n, torch.bfloat16, shape, fn) for n, shape, fn in parts]

    first = [(prefix + "model.embed_tokens.weight", torch.bfloat16, (V, H), mat((V, H)))]
    second = []
    for i in range(L):
        (first if i < L // 2 else second).extend(layer(i))
    second.append((prefix + "model.norm.weight", torch.bfloat16, (H,), ones(H)))
    if not hf.get("tie_word_embeddings", gemma):
        second.append((prefix + "lm_head.weight", torch.bfloat16, (V, H), mat((V, H))))
    return [first, second]


def write_hf_checkpoint(torch, root, hf: dict, seed: int, dev, prefix: str = "") -> int:
    """config.json, two safetensors shards and their index under `root`
    (tensor names after `prefix`); returns the bytes of the shards."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    (root / "config.json").write_text(json.dumps(hf, indent=1))
    weight_map, total = {}, 0
    shards = hf_llama_entries(torch, hf, seed, dev, prefix)
    for k, entries in enumerate(shards):
        name = f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"
        total += write_safetensors(root / name, entries)
        weight_map.update({e[0]: name for e in entries})
    (root / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {"total_size": total}, "weight_map": weight_map}, indent=1))
    return total


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def checkpoint_phases(torch, dev, tm, prompts, want_tokens, want_launches, hf=LLAMA3_8B_HF) -> None:
    """Phase 16: checkpoints from disk to the card. (a) `tm` (in the run,
    an 8-layer llama3-8b sym_int4 model) saved as the low-bit artifact,
    loaded back (verify fast and full), verified, and generating its
    tokens `want_tokens` with its launches `want_launches`; (b) an HF checkpoint of llama3-8b's published
    config at 4 layers, written with the script's safetensors writer,
    ingested in sym_int4 and q4_k_m and checked. Each directory is
    deleted after its half. (On the CPU, at a narrowed `hf`, this
    rehearses the phase: only the launch checks fail there.)"""
    import shutil
    import tempfile

    from bigdl_tpu_torch import AutoModelForCausalLM, verify_low_bit
    from bigdl_tpu_torch.convert import hf as hf_mod
    from bigdl_tpu_torch.convert import low_bit as low_bit_mod
    from bigdl_tpu_torch.ops import kernels
    from bigdl_tpu_torch.quant import quantize

    t_phase = time.time()
    tmp = Path(tempfile.gettempdir())

    def room(need: int, what: str) -> bool:
        free = shutil.disk_usage(tmp).free
        log(f"phase 16: {what} needs {need / 1e9:.3f} GB under {tmp}, {free / 1e9:.3f} GB free")
        check(free >= need, f"phase 16: {need / 1e9:.3f} GB of space for {what} under {tmp}")
        return free >= need

    def synced(fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            run.seconds += time.time() - t0
            return out
        run.seconds = 0.0
        return run

    def model_bytes(m):
        return sum(t.numel() * t.element_size() for t in list(m.parameters()) + list(m.buffers()))

    # (a) the artifact at full width and depth
    need = int(model_bytes(tm.params) * 1.05)
    if room(need, "the llama3-8b artifact"):
        root = Path(tempfile.mkdtemp(prefix="bigdl_low_bit_", dir=tmp))
        try:
            d2h = synced(low_bit_mod.params_to_numpy)
            t0 = time.time()
            with mock.patch.object(low_bit_mod, "params_to_numpy", d2h):
                tm.save_low_bit(str(root / "llama3-8b"))
            save_s = time.time() - t0
            gb = dir_bytes(root / "llama3-8b") / 1e9
            log(f"phase 16 (a): save_low_bit of llama3-8b sym_int4 ({len(tm.params.layers)} layers): "
                f"{gb:.3f} GB in {save_s:.3f} s, of which device-to-host and stacking {d2h.seconds:.3f} s")
            for verify in ("fast", "full"):
                torch.cuda.synchronize()
                t0 = time.time()
                loaded = AutoModelForCausalLM.load_low_bit(str(root / "llama3-8b"), verify=verify,
                                                           device=dev)
                torch.cuda.synchronize()
                sec = time.time() - t0
                log(f"phase 16 (a): load_low_bit verify={verify}: {sec:.3f} s, {gb / sec:.3f} GB/s")
                check(loaded.salvage_report is None, f"load_low_bit verify={verify}: a salvage report")
                if verify == "full":
                    break
                del loaded
            t0 = time.time()
            rep = verify_low_bit(str(root / "llama3-8b"))
            log(f"phase 16 (a): verify_low_bit ok={rep.ok} ({len(rep.rows)} tensors) in "
                f"{time.time() - t0:.3f} s")
            check(rep.ok, "verify_low_bit of the saved artifact")
            kernels.reset_launches()
            out = loaded.generate(prompts, max_new_tokens=NEW_TOKENS)
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
            same = bool((out == want_tokens).all())
            log(f"phase 16 (a): loaded model's greedy tokens equal phase 3's: {same}; launches "
                f"{launches} (phase 3's {want_launches})")
            check(same, "phase 16 (a): the loaded model's tokens are phase 3's")
            check(launches == want_launches, "phase 16 (a): launch counts of the loaded model")
            del loaded
        finally:
            shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()

    # (b) HF ingest at full width, 4 layers
    H, I, V, L = hf["hidden_size"], hf["intermediate_size"], hf["vocab_size"], hf["num_hidden_layers"]
    QD = H
    KD = hf["num_key_value_heads"] * H // hf["num_attention_heads"]
    layer_elems = (QD + 2 * KD) * H + H * QD + 3 * I * H
    ckpt_bytes = 2 * (2 * V * H + L * (layer_elems + 2 * H) + H)
    if not room(int(ckpt_bytes * 1.8), "the HF checkpoint and an artifact of its model"):
        return
    root = Path(tempfile.mkdtemp(prefix="bigdl_hf_", dir=tmp))
    try:
        t0 = time.time()
        total = write_hf_checkpoint(torch, root / "hf", hf, 16, dev)
        log(f"phase 16 (b): wrote an HF checkpoint of {hf['model_type']} config.json values at "
            f"{L} layers: {total / 1e9:.3f} GB in two shards in {time.time() - t0:.3f} s")
        get = hf_mod.open_checkpoint(str(root / "hf"))
        for qtype in ("sym_int4", "q4_k_m"):
            quant = synced(quantize)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            torch.cuda.synchronize()
            t0 = time.time()
            with mock.patch.object(hf_mod, "quantize", quant):
                m = AutoModelForCausalLM.from_pretrained(str(root / "hf"), load_in_low_bit=qtype,
                                                         device=dev)
            torch.cuda.synchronize()
            sec = time.time() - t0
            peak = torch.cuda.max_memory_allocated() - base
            mb = model_bytes(m.params)
            log(f"phase 16 (b) {qtype}: ingest {sec:.3f} s, read {total / 1e9 / sec:.3f} GB/s, quantize "
                f"{quant.seconds * 1e3 / L:.3f} ms a layer ({quant.seconds:.3f} s with the lm head); peak "
                f"device memory {peak / 2**30:.3f} GiB against the model's {mb / 2**30:.3f} GiB + one f32 "
                f"layer {4 * layer_elems / 2**30:.3f} GiB = {(mb + 4 * layer_elems) / 2**30:.3f} GiB")
            # the card's encoder against the CPU's on one layer's f32 weights
            w32 = get("model.layers.1.mlp.down_proj.weight").float()
            body = "sym_int4" if qtype == "sym_int4" else "q4_k"
            ref = quantize(w32, body)
            got = m.params.layers[1].proj["w_down"].w
            diff = sum(int((getattr(got, f).cpu().view(torch.uint8) != v.view(torch.uint8)).sum())
                       for f, v in ref.fields().items())
            dq = (got.dequantize(torch.float32).cpu() - ref.dequantize(torch.float32)).abs().max().item()
            log(f"phase 16 (b) {qtype}: layer 1 w_down {body} from the card's encoder against the CPU's: "
                f"{diff} bytes differ, largest dequantized difference {dq:.6g}")
            if qtype == "sym_int4":
                check(diff == 0, "phase 16 (b): the card's sym_int4 bytes equal the CPU encoder's")
            logits_checks(torch, dev, m, prompts, f"phase 16 (b) {qtype}")
            out1 = m.generate(prompts, max_new_tokens=NEW_TOKENS)
            out2 = m.generate(prompts, max_new_tokens=NEW_TOKENS)
            ok = bool(((out1 >= 0) & (out1 < V)).all()) and out1.shape == (len(prompts), NEW_TOKENS)
            check(ok and bool((out1 == out2).all()), f"phase 16 (b) {qtype}: tokens in the vocabulary, "
                                                     "the same on a second call")
            m.save_low_bit(str(root / qtype))
            back = AutoModelForCausalLM.load_low_bit(str(root / qtype), verify="full", device=dev)
            same = bool((back.generate(prompts, max_new_tokens=NEW_TOKENS) == out1).all())
            log(f"phase 16 (b) {qtype}: greedy tokens (row 0) {out1[0].tolist()}; second call "
                f"identical {bool((out1 == out2).all())}; after save_low_bit and load_low_bit identical {same}")
            check(same, f"phase 16 (b) {qtype}: save and load of the ingested model change its tokens")
            del m, back
            shutil.rmtree(root / qtype, ignore_errors=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"phase 16: {time.time() - t_phase:.1f} s")


def logits_checks(torch, dev, tm, prompts, label) -> None:
    """Prefill logits of `tm` through the kernels against the plain
    versions on the card, within phase 3's bound (2 % of the largest)."""
    from bigdl_tpu_torch.generate import pad_prompts
    from bigdl_tpu_torch.kvcache import init_cache
    from bigdl_tpu_torch.models import llama
    from bigdl_tpu_torch.ops import kernels
    from bigdl_tpu_torch.utils import cache_len_for

    cfg = tm.config
    tokens, starts = pad_prompts(prompts, 0)
    tok = torch.as_tensor(tokens, dtype=torch.long, device=dev)

    def run():
        cache = dataclasses.replace(
            init_cache(cfg.num_hidden_layers, len(prompts), cache_len_for(tokens.shape[1], 1),
                       cfg.num_key_value_heads, cfg.head_dim_, device=dev),
            start=torch.as_tensor(starts, device=dev))
        with torch.inference_mode():
            return llama.forward(cfg, tm.params, tok, cache, "prefill", last_logits_only=True)[0][:, -1]

    kern = run()
    with mock.patch.object(kernels, "qmatmul", kernels.qmatmul_plain), \
            mock.patch.object(kernels, "flash_attention", kernels.flash_attention_plain):
        plain = run()
    err = (kern - plain).abs().max().item()
    tol = 0.02 * plain.abs().max().item()
    log(f"{label}: prefill logits kernel vs plain max_abs_err={err:.6g} tol={tol:.6g}")
    check(bool(torch.isfinite(kern).all()) and err <= tol, f"{label}: prefill logits")


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


MISROUND_SHAPES, MISROUND_M = ("wo", "w_down", "w_gateup"), 1024


def misrounding_counts(torch, dev, qtype, shapes, seed=3) -> dict:
    """{(form, shape): (kernel, plain, outputs)} at wo, w_down and w_gateup,
    M = 1024: the bf16 outputs of the GEMM, dx and the LoRA GEMM (R = 8)
    and of their plain versions (f32 sums in torch.matmul) that differ
    from the exactly rounded value (f64 sums on the card). The LoRA GEMM's
    exact value takes xg = bf16(f32(x A^T) * gate) from f64 sums, as the
    kernel's first pass rounds it."""
    from bigdl_tpu_torch.ops import kernels

    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)

    def bf(t):
        return t.float().to(torch.bfloat16)

    out = {}
    for name in MISROUND_SHAPES:
        O, K = shapes[name]
        w = qweight_of(torch, dev, qtype, O, K, 5)
        wd = w.dequantize(torch.bfloat16).double()
        x, gr = randn(MISROUND_M, K), randn(MISROUND_M, O)
        a, b = randn(RANK, K) / RANK, randn(O, RANK) * 0.01
        gate = torch.full((MISROUND_M, RANK), 2.0, dtype=torch.bfloat16, device=dev)
        xg = ((x.double() @ a.double().t()).float() * gate.float()).to(torch.bfloat16)
        cases = {
            "gemm": (kernels.qmatmul(x, w), kernels.qmatmul_plain(x, w), bf(x.double() @ wd.t())),
            "dx": (kernels.qmatmul_dx(gr, w), kernels.qmatmul_dx_plain(gr, w), bf(gr.double() @ wd)),
            "lora_gemm": (kernels.qmatmul_lora(x, w, a, b, gate), kernels.qmatmul_lora_plain(x, w, a, b, gate),
                          bf(x.double() @ wd.t() + xg.double() @ b.double().t())),
        }
        for form, (k, p, e) in cases.items():
            out[(form, name)] = (int((k != e).sum()), int((p != e).sum()), e.numel())
        del w, wd, cases
    return out


def format_phases(torch, dev, cfg, card, prompts, tok, st, T, S) -> dict:
    """Phases 9 and 10: every form of the 15 other formats against its
    plain version at every llama3-8b shape, nf4 and q4_k_m generation and
    nf4 QLoRA at full depth, 2-layer full-width models in every format,
    then each form's times per format. Returns {kernel name: {qtype:
    numbers}} for the `kernels` line."""
    import numpy as np
    from torch.profiler import ProfilerActivity

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
            with warm_profile(acts) as prof_pre:
                for _ in range(PROFILED_PREFILLS):
                    state = prefill_state()
                torch.cuda.synchronize()
            with warm_profile(acts) as prof_dec:
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
    with warm_profile(acts) as prof:
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
    begin_phase(10)
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


# ---------------------------------------------------------------------------
# the llama flags (phase 17)
# ---------------------------------------------------------------------------

LONG_PROMPT, LONG_DECODE = 4500, 8  # past the 4096 window of mistral and gemma2
FLAGS_LAYERS = 2  # the kernels-vs-plain checks' depth, at full width
# (a) and (b)'s gemma2-9b depth: a third of its 42 layers (both window
# kinds alternate from layer 0) since phase 19 joined the script, to keep
# the whole run inside its time limit; full width
GEMMA2_LAYERS = 14
LLAMA31_ROPE = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                "high_freq_factor": 4.0, "original_max_position_embeddings": 8192}
# HF config.json values of the port's gemma2-9b and qwen2-7b presets, cut
# to 4 layers (from_hf_config must give the preset back)
GEMMA2_9B_HF = {
    "architectures": ["Gemma2ForCausalLM"], "model_type": "gemma2", "vocab_size": 256000,
    "hidden_size": 3584, "intermediate_size": 14336, "num_hidden_layers": 4,
    "num_attention_heads": 16, "num_key_value_heads": 8, "head_dim": 256,
    "rms_norm_eps": 1e-05, "rope_theta": 10000.0, "max_position_embeddings": 4096,
    "sliding_window": 4096, "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
    "query_pre_attn_scalar": 224, "hidden_activation": "gelu_pytorch_tanh",
    "tie_word_embeddings": True, "torch_dtype": "bfloat16",
}
QWEN2_7B_HF = {
    "architectures": ["Qwen2ForCausalLM"], "model_type": "qwen2", "vocab_size": 152064,
    "hidden_size": 3584, "intermediate_size": 18944, "num_hidden_layers": 4,
    "num_attention_heads": 28, "num_key_value_heads": 4, "rms_norm_eps": 1e-05,
    "rope_theta": 1000000.0, "max_position_embeddings": 4096, "tie_word_embeddings": False,
    "hidden_act": "silu", "torch_dtype": "bfloat16",
}


def plain_kernels(kernels) -> dict:
    """Every kernel entry point of the paths mapped to its plain version
    (for mock.patch.multiple)."""
    return {"qmatmul": kernels.qmatmul_plain, "qmatmul_dx": kernels.qmatmul_dx_plain,
            "qmatmul_lora": kernels.qmatmul_lora_plain,
            "flash_attention": kernels.flash_attention_plain,
            "paged_attention": kernels.paged_attention_plain,
            "flash_train_fwd": kernels.flash_attention_train_plain,
            "flash_train_dq": kernels.flash_train_dq_plain,
            "flash_train_dkv": kernels.flash_train_dkv_plain}


def routes_text(llama, cfg, *call) -> str:
    """Which kernel the layers reach (`llama.attention_route`), with
    their window: each route, its layer count and first layers."""
    by = {}
    for layer in range(cfg.num_hidden_layers):
        r = llama.attention_route(cfg, layer, *call)
        by.setdefault(f"{r.kernel}(w={r.window})" if r.window else r.kernel, []).append(layer)
    return ", ".join(f"{k} on {len(v)} layers ({', '.join(map(str, v[:3]))}"
                     f"{', ...' if len(v) > 3 else ''})" for k, v in by.items())


def unit_norms(torch, model) -> None:
    """Zero every norm weight of a (1 + w) model in place: the unit scale
    llama's ones give. init_params sets them to 1, as JAX's does, which
    doubles each of gemma2's four norms a layer and saturates the capped
    logits of a random model."""
    with torch.no_grad():
        for name, prm in model.named_parameters():
            if name.endswith("norm"):
                prm.zero_()


def flags_phases(torch, dev, card, prompt_tokens, starts, presets=None) -> None:
    """Phase 17: the llama flags on the card. (a) gemma2-9b at full width
    (GEMMA2_LAYERS of its 42 layers) in sym_int4 through `TorchModel.generate` at
    phase 3's shapes, its launches and times; (b) the serving engine on it
    with phase 7's traffic; (c) windows that bite: a 4,500-token prompt
    and 8 decode steps through 2-layer mistral-7b and gemma2-9b, dense
    cache and paged pool, kernels against the plain versions; (d)
    qwen2-7b's biases (prefill and decode logits) and a QLoRA step of
    qwen2-7b, mistral-7b and gemma2-9b, kernels against plain; (e)
    Llama-3.1's rope scaling on a 2-layer llama3-8b prefill; (f) HF
    checkpoints of gemma2 and qwen2 at 4 layers ingested in sym_int4: the
    bytes of `params_from_numpy` + `optimize_model` over the same
    tensors, greedy tokens, and gemma2's artifact round trip. `presets`
    replaces PRESETS (a CPU rehearsal at narrow widths)."""
    import shutil
    import tempfile

    import numpy as np
    from torch.profiler import ProfilerActivity

    from bigdl_tpu_torch import (PRESETS, AutoModelForCausalLM, ModelConfig, TorchModel,
                                 optimize_model)
    from bigdl_tpu_torch.convert import hf as hf_mod
    from bigdl_tpu_torch.convert import params_from_numpy
    from bigdl_tpu_torch.generate import pad_prompts
    from bigdl_tpu_torch.kvcache import init_cache
    from bigdl_tpu_torch.kvpaged import init_paged
    from bigdl_tpu_torch.models import llama
    from bigdl_tpu_torch.ops import kernels
    from bigdl_tpu_torch.ops.rope import make_inv_freq_scaled
    from bigdl_tpu_torch.quant import ARRAY_FIELDS
    from bigdl_tpu_torch.serving import InferenceEngine
    from bigdl_tpu_torch.train import init_lora, next_token_loss

    presets = presets or PRESETS
    t_phase = time.time()
    plain = plain_kernels(kernels)

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def q(xs, f):
        xs = sorted(xs)
        return xs[min(int(f * len(xs)), len(xs) - 1)]

    # (a) gemma2-9b at full width through generate ---------------------
    cfg = presets["gemma2-9b"]
    cfg = dataclasses.replace(cfg, num_hidden_layers=min(GEMMA2_LAYERS, cfg.num_hidden_layers))
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    t = time.time()
    dense = llama.init_params(cfg, seed=50, device=dev)
    unit_norms(torch, dense)
    tm = TorchModel(cfg, optimize_model(dense, cfg, "sym_int4"), "sym_int4", device=dev)
    del dense
    torch.cuda.synchronize()
    log(f"phase 17 (a): gemma2-9b {L} layers sym_int4 built in {time.time() - t:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB on the card; tied head dense "
        f"{tm.params.lm_head is None}; routes: prefill {routes_text(llama, cfg, 'dense', 'prefill', 2)}"
        f"; paged decode {routes_text(llama, cfg, 'paged', 'decode', 1, True)}")
    prompts = [list(row[s0:]) for row, s0 in zip(prompt_tokens, starts)]
    prompts = [[x % V for x in p_] for p_ in prompts]
    kernels.reset_launches()
    out1 = tm.generate(prompts, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    want = {k.name: 0 for k in kernels.KERNELS}
    want.update({kernels.GEMM.name: 4 * L, kernels.GEMV.name: (NEW_TOKENS - 1) * 4 * L})
    log(f"phase 17 (a): launches {launches} expected {want} (no lm head launch: the tied "
        "head is the dense embedding; no flash launch: alternating windows)")
    check(launches == want, "phase 17 (a): gemma2-9b launch counts")
    check(out1.shape == (len(prompts), NEW_TOKENS) and bool(((out1 >= 0) & (out1 < V)).all()),
          "phase 17 (a): tokens in the vocabulary")
    out2 = tm.generate(prompts, max_new_tokens=NEW_TOKENS)
    check(bool((out1 == out2).all()), "phase 17 (a): identical tokens on a second call")
    prefill_ms = sorted(wall_ms(lambda: tm.generate(prompts, 1)) for _ in range(3))
    gen_ms = sorted(wall_ms(lambda: tm.generate(prompts, NEW_TOKENS)) for _ in range(3))
    torch.cuda.reset_peak_memory_stats()
    tm.generate(prompts, NEW_TOKENS)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    tokens, st = pad_prompts(prompts, 0)
    T = tokens.shape[1]
    S = T + NEW_TOKENS + 8
    tok = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    stt = torch.as_tensor(st, device=dev)
    Hkv, D = cfg.num_key_value_heads, cfg.head_dim_
    with torch.inference_mode():
        cache = dataclasses.replace(init_cache(L, len(prompts), S, Hkv, D, device=dev), start=stt)
        logits, cache = llama.forward(cfg, tm.params, tok, cache, "prefill", last_logits_only=True)
        cur = logits[:, -1].argmax(-1)
        step_ms = []
        for i in range(NEW_TOKENS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = llama.forward(cfg, tm.params, cur[:, None], cache, "decode")
            cur = logits[:, -1].argmax(-1)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if i == NEW_TOKENS - PROFILED_STEPS - 1:
                break
        with warm_profile([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED_STEPS):
                logits, cache = llama.forward(cfg, tm.params, cur[:, None], cache, "decode")
                cur = logits[:, -1].argmax(-1)
            torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in device_kernels(prof)) / 1e3 / PROFILED_STEPS
    med = q(step_ms, 0.5)
    log(f"phase 17 (a): card {card}")
    log(f"phase 17 (a): gemma2-9b sym_int4 B={len(prompts)} prompt bucket {T} new tokens "
        f"{NEW_TOKENS}: prefill_ms (generate of 1 token) median={prefill_ms[1]:.3f} "
        f"min={prefill_ms[0]:.3f} max={prefill_ms[-1]:.3f} (n=3); generate_ms median="
        f"{gen_ms[1]:.3f} (n=3); decode step ms median={med:.3f} p80={q(step_ms, 0.8):.3f} "
        f"(n={len(step_ms)}); profiled decode: device busy {busy:.3f} ms per step = "
        f"{busy / med:.3f} of the median step; peak_mem_gib={peak_gib:.3f}")
    for e in device_kernels(prof)[:5]:
        log(f"  {e.self_device_time_total / 1e3 / PROFILED_STEPS:8.3f} ms/step "
            f"{e.count // PROFILED_STEPS:5d} calls/step  {e.key[:90]}")
    del cache, logits

    # (b) the serving engine on gemma2-9b: phase 7's traffic ------------
    shared, indep = serving_traffic(V)
    traffic = shared + indep
    eng = InferenceEngine(tm, n_slots=SLOTS, max_len=MAX_LEN, page_size=PAGE, paged=True)
    seen = {"ttft": [], "step": []}
    for key, hist in (("ttft", eng.ttft), ("step", eng.decode_step_seconds)):
        hist.observe = (lambda h, out: lambda x: (out.append(x), type(h).observe(h, x)))(
            hist, seen[key])
    calls = []
    real_paged = kernels.paged_attention

    def recorded(q_, k_pages, v_pages, block_tables, layer, *a, **kw):
        calls.append((layer, kw.get("window"), kw.get("softcap"), kw.get("scale")))
        return real_paged(q_, k_pages, v_pages, block_tables, layer, *a, **kw)

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with mock.patch.object(kernels, "paged_attention", recorded):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [eng.submit(**sp) for sp in traffic]
        eng.run_until_idle()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    steps = eng.decode_step_seconds.count
    launches = kernels.launch_counts()
    peak_b = torch.cuda.max_memory_allocated() / 2**30
    ntok = sum(len(r.out_tokens) for r in reqs)
    want_calls = {(layer, cfg.sliding_window if cfg.layer_is_sliding(layer) else None,
                   cfg.attn_logit_softcap, cfg.attn_scale) for layer in range(L)}
    log(f"phase 17 (b): gemma2-9b engine paged bf16, {len(reqs)} requests, {SLOTS} slots: "
        f"{sec:.3f} s = {len(reqs) / sec:.3f} requests/s, {ntok / sec:.1f} generated tokens/s; "
        f"TTFT ms median={q(seen['ttft'], .5) * 1e3:.3f} p90={q(seen['ttft'], .9) * 1e3:.3f}; "
        f"decode step ms median={q(seen['step'], .5) * 1e3:.3f} p90={q(seen['step'], .9) * 1e3:.3f} "
        f"(n={steps}); peak_mem_gib={peak_b:.3f}; page_leaks={eng.page_leaks()}; "
        f"paged launches {launches[kernels.PAGED.name]}; (layer, window, softcap, scale) "
        f"passed {sorted(set(calls), key=lambda c: c[0])[:2]}...")
    check(all(r.finish_reason == "length" and len(r.out_tokens) == SERVE_NEW
              and all(0 <= x < V for x in r.out_tokens) for r in reqs),
          "phase 17 (b): every request finishes with its tokens in the vocabulary")
    check(eng.page_leaks() == 0, "phase 17 (b): page leaks after the drain")
    check(launches[kernels.PAGED.name] == L * steps == len(calls) and steps > 0,
          f"phase 17 (b): {L} paged launches a decode step")
    check(set(calls) == want_calls, "phase 17 (b): each layer's window, the softcap and the "
                                     "scale passed to the paged kernel")
    del eng, reqs, tm
    torch.cuda.empty_cache()

    def kv_logits(cfg_, model, toks, n_decode, start=None):
        """Dense-cache prefill last logits, then n_decode greedy decode
        steps: [n_decode + 1, B, V] float32."""
        B_, T_ = toks.shape
        cache = init_cache(cfg_.num_hidden_layers, B_, T_ + n_decode,
                           cfg_.num_key_value_heads, cfg_.head_dim_, device=dev)
        if start is not None:
            cache = dataclasses.replace(cache, start=start)
        out = []
        with torch.inference_mode():
            logits, cache = llama.forward(cfg_, model, toks, cache, "prefill",
                                          last_logits_only=True)
            out.append(logits[:, -1])
            for _ in range(n_decode):
                logits, cache = llama.forward(cfg_, model, out[-1].argmax(-1)[:, None], cache,
                                              "decode")
                out.append(logits[:, -1])
        return torch.stack(out)

    def paged_logits(cfg_, model, toks, n_decode):
        """kv_logits over a one-row paged pool (pages of PAGE in reverse
        order, page 0 the scratch): the prefill through the plain
        attention (per-row positions), each decode step through the paged
        kernel."""
        T_ = toks.shape[1]
        mp = -(-(T_ + n_decode) // PAGE)
        cache = init_paged(cfg_.num_hidden_layers, mp + 1, PAGE, cfg_.num_key_value_heads,
                           cfg_.head_dim_, 1, mp, device=dev)
        cache.block_tables[0] = torch.arange(mp, 0, -1, dtype=torch.int32, device=dev)
        out = []
        with torch.inference_mode():
            logits, cache = llama.forward(cfg_, model, toks, cache, "prefill",
                                          last_logits_only=True)
            out.append(logits[:, -1])
            for _ in range(n_decode):
                logits, cache = llama.forward(cfg_, model, out[-1].argmax(-1)[:, None], cache,
                                              "decode")
                out.append(logits[:, -1])
        return torch.stack(out)

    def held(label, kern, pl, extra=""):
        err = (kern - pl).abs().max().item()
        tol = 0.02 * pl.abs().max().item()  # phase 3's bound
        log(f"phase 17 {label}: logits kernels vs plain max_abs_err={err:.6g} tol={tol:.6g}{extra}")
        check(bool(torch.isfinite(kern).all()) and err <= tol, f"phase 17 {label}: kernels vs plain")

    def small(name, seed, **kw):
        cfg_ = dataclasses.replace(presets[name], num_hidden_layers=FLAGS_LAYERS, **kw)
        dense_ = llama.init_params(cfg_, seed=seed, device=dev)
        if cfg_.rms_norm_offset:
            unit_norms(torch, dense_)
        return cfg_, optimize_model(dense_, cfg_, "sym_int4")

    rng = np.random.default_rng(51)

    # (c) windows that bite: dense cache and paged pool -----------------
    for name in ("mistral-7b", "gemma2-9b"):
        cfg_, model = small(name, 52)
        Lc = cfg_.num_hidden_layers
        long_prompt = rng.integers(1, cfg_.vocab_size, LONG_PROMPT).tolist()
        toks = torch.as_tensor([long_prompt], dtype=torch.long, device=dev)
        kernels.reset_launches()
        kern = kv_logits(cfg_, model, toks, LONG_DECODE)
        torch.cuda.synchronize()
        dense_launches = kernels.launch_counts()
        with mock.patch.multiple(kernels, **plain):
            pl = kv_logits(cfg_, model, toks, LONG_DECODE)
        flash_want = Lc if llama.attention_route(cfg_, 0, "dense", "prefill", LONG_PROMPT).kernel == "flash" else 0
        held(f"(c) {name} dense cache, prompt {LONG_PROMPT} + {LONG_DECODE} decode steps", kern, pl,
             f"; flash launches {dense_launches[kernels.FLASH.name]} (expected {flash_want}); "
             f"routes: prefill {routes_text(llama, cfg_, 'dense', 'prefill', LONG_PROMPT)}")
        check(dense_launches[kernels.FLASH.name] == flash_want, f"phase 17 (c) {name}: flash launches")
        kernels.reset_launches()
        kern = paged_logits(cfg_, model, toks, LONG_DECODE)
        torch.cuda.synchronize()
        n_paged = kernels.PAGED.launches
        with mock.patch.multiple(kernels, **plain):
            pl = paged_logits(cfg_, model, toks, LONG_DECODE)
        held(f"(c) {name} paged pool, prompt {LONG_PROMPT} + {LONG_DECODE} decode steps", kern, pl,
             f"; paged launches {n_paged}; routes: decode "
             f"{routes_text(llama, cfg_, 'paged', 'decode', 1, True)}")
        check(n_paged == Lc * LONG_DECODE, f"phase 17 (c) {name}: paged launches of the pool's decode")
        tmc = TorchModel(cfg_, model, "sym_int4", device=dev)
        paged_calls = []

        def serve():
            eng_ = InferenceEngine(tmc, n_slots=1, max_len=LONG_PROMPT + 108, page_size=PAGE,
                                   paged=True)
            r_ = eng_.submit(prompt=long_prompt, max_new_tokens=LONG_DECODE + 1)
            eng_.run_until_idle()
            check(eng_.page_leaks() == 0, f"phase 17 (c) {name}: page leaks")
            return r_.out_logprobs, r_.out_tokens, eng_.decode_step_seconds.count

        def recorded_c(q_, k_pages, v_pages, block_tables, layer, *a, **kw):
            paged_calls.append((layer, kw.get("window")))
            return real_paged(q_, k_pages, v_pages, block_tables, layer, *a, **kw)

        kernels.reset_launches()
        with mock.patch.object(kernels, "paged_attention", recorded_c):
            lk, tk, steps_c = serve()
        n_paged = kernels.PAGED.launches
        with mock.patch.multiple(kernels, **plain):
            lp_, tp_, _ = serve()
        n = next((j for j, (x, y) in enumerate(zip(tk, tp_)) if x != y), len(tk)) + 1
        worst = max(abs(x - y) for x, y in zip(lk[:n], lp_[:n]))
        windows = sorted(set(paged_calls))
        log(f"phase 17 (c) {name} paged engine (max-len {LONG_PROMPT + 108}): {steps_c} decode steps, "
            f"paged launches {n_paged}, (layer, window) passed {windows}; chosen-token logprobs "
            f"kernels vs plain max_abs_err={worst:.5f} nat (tol {LOGPROB_TOL[False]})")
        check(n_paged == Lc * steps_c > 0, f"phase 17 (c) {name}: paged launches = layers x steps")
        check(windows == [(layer, cfg_.sliding_window if cfg_.layer_is_sliding(layer) else None)
                          for layer in range(Lc)], f"phase 17 (c) {name}: each layer's window passed")
        check(worst <= LOGPROB_TOL[False], f"phase 17 (c) {name}: paged engine kernels vs plain")
        del model, tmc, kern, pl
        torch.cuda.empty_cache()

    # (d) qwen2-7b's biases; QLoRA of three families ----------------------
    cfg_, model = small("qwen2-7b", 53)
    check("wqkv" in model.layers[0].proj and model.layers[0].proj["wqkv"].bias is not None,
          "phase 17 (d): qwen2's q/k/v biases fused into bqkv")
    toks = torch.as_tensor(pad_prompts(prompts, 0)[0], dtype=torch.long, device=dev) % cfg_.vocab_size
    kern = kv_logits(cfg_, model, toks, 4, stt)
    with mock.patch.multiple(kernels, **plain):
        pl = kv_logits(cfg_, model, toks, 4, stt)
    held("(d) qwen2-7b prefill + 4 decode steps (bqkv)", kern, pl)
    del model
    for name, seed in (("qwen2-7b", 54), ("mistral-7b", 55), ("gemma2-9b", 56)):
        cfg_, model = small(name, seed)
        lora = init_lora(cfg_, seed=seed, rank=RANK, device=dev)
        with torch.no_grad():  # B != 0, so the A gradients are not all 0
            for pair in lora.layers.values():
                pair["b"].copy_(torch.randn(pair["b"].shape, device=dev,
                                            generator=torch.Generator(device=dev).manual_seed(seed))
                                * 0.01)
        ttok = torch.as_tensor(rng.integers(1, cfg_.vocab_size, (1, TRAIN_T)), dtype=torch.long,
                               device=dev)
        mask = torch.ones(ttok.shape, device=dev)

        def grads():
            for prm in lora.parameters():
                prm.grad = None
            loss = next_token_loss(cfg_, llama.forward, model, lora, ttok, mask)
            loss.backward()
            return loss.item(), {n_: prm.grad.float() for n_, prm in lora.named_parameters()}

        kernels.reset_launches()
        kern_loss, kern_grads = grads()
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        with mock.patch.multiple(kernels, **plain):
            plain_loss, plain_grads = grads()
        worst = max(((kern_grads[n_] - g_).abs().max() / g_.abs().max()).item()
                    for n_, g_ in plain_grads.items())
        route = llama.attention_route(cfg_, 0, "none", "prefill", TRAIN_T).kernel
        ft = FLAGS_LAYERS if route == "flash_train" else 0
        log(f"phase 17 (d) {name} QLoRA step (B=1 T={TRAIN_T}, rank {RANK}, 7 projections, "
            f"{FLAGS_LAYERS} layers) kernels vs plain: loss {kern_loss:.6f} vs {plain_loss:.6f}; worst "
            f"LoRA grad max_abs_err / max|grad| = {worst:.4g} (tol 0.05, phase 5's); attention "
            f"{route}; launches {launches}")
        check(all(launches[k.name] == ft for k in (kernels.FLASH_FWD, kernels.FLASH_DQ,
                                                   kernels.FLASH_DKV))
              and launches[kernels.LORA_GEMM.name] > 0 and launches[kernels.DX.name] > 0,
              f"phase 17 (d) {name}: the QLoRA step's launches ({route})")
        check(abs(kern_loss - plain_loss) <= 1e-3 * abs(plain_loss) and worst <= 0.05,
              f"phase 17 (d) {name}: QLoRA step kernels vs plain")
        del model, lora, kern_grads, plain_grads
        torch.cuda.empty_cache()

    # (e) Llama-3.1's rope scaling --------------------------------------
    cfg_, model = small("llama3-8b", 57, rope_scaling=LLAMA31_ROPE)
    inv_scaled, _ = make_inv_freq_scaled(cfg_.rotary_dim, cfg_.rope_theta,
                                         cfg_.rope_scaling_dict, device=dev)
    inv_plain, _ = make_inv_freq_scaled(cfg_.rotary_dim, cfg_.rope_theta, None, device=dev)
    toks = torch.as_tensor(rng.integers(1, cfg_.vocab_size, (1, TRAIN_T)), dtype=torch.long,
                           device=dev)
    kernels.reset_launches()
    kern = kv_logits(cfg_, model, toks, 0)
    flash_n = kernels.FLASH.launches
    with mock.patch.multiple(kernels, **plain):
        pl = kv_logits(cfg_, model, toks, 0)
    n_scaled = int((inv_scaled != inv_plain).sum())
    held(f"(e) llama3-8b with Llama-3.1's rope_scaling, prefill T={TRAIN_T}", kern, pl,
         f"; {n_scaled} of {inv_plain.numel()} frequencies scaled; flash launches {flash_n}")
    check(n_scaled > 0 and flash_n == FLAGS_LAYERS, "phase 17 (e): scaled frequencies, flash launched")
    del model

    # (f) HF checkpoints of gemma2 and qwen2 ------------------------------
    tmp = Path(tempfile.gettempdir())
    root = Path(tempfile.mkdtemp(prefix="bigdl_hf_flags_", dir=tmp))
    try:
        for hf, preset in ((GEMMA2_9B_HF, "gemma2-9b"), (QWEN2_7B_HF, "qwen2-7b")):
            name = hf["model_type"]
            hf = dict(hf, vocab_size=presets[preset].vocab_size,
                      hidden_size=presets[preset].hidden_size,
                      intermediate_size=presets[preset].intermediate_size,
                      num_attention_heads=presets[preset].num_attention_heads,
                      num_key_value_heads=presets[preset].num_key_value_heads,
                      **({"head_dim": presets[preset].head_dim} if "head_dim" in hf else {}))
            want_cfg = dataclasses.replace(presets[preset], num_hidden_layers=hf["num_hidden_layers"])
            check(ModelConfig.from_hf_config(hf) == want_cfg,
                  f"phase 17 (f) {name}: config.json translates to the preset")
            t0 = time.time()
            total = write_hf_checkpoint(torch, root / name, hf, 58, dev)
            torch.cuda.synchronize()
            t1 = time.time()
            m = AutoModelForCausalLM.from_pretrained(str(root / name), load_in_low_bit="sym_int4",
                                                     device=dev)
            torch.cuda.synchronize()
            ingest_s = time.time() - t1
            # the same tensors through params_from_numpy and optimize_model
            get = hf_mod.open_checkpoint(str(root / name))
            Lf = m.config.num_hidden_layers
            per = [hf_mod.layer_tensors(m.config, i, get) for i in range(Lf)]
            arrays = {f"layers.{k}": torch.stack([d[k] for d in per]) for k in per[0]}
            arrays.update(hf_mod.top_tensors(m.config, get))
            ref = optimize_model(params_from_numpy(arrays, {}, m.config, device=dev), m.config,
                                 "sym_int4")
            del per, arrays
            diff = 0
            pairs = [(a.proj[k], b.proj[k]) for a, b in zip(m.params.layers, ref.layers) for k in a.proj]
            if m.params.lm_head is not None:
                pairs.append((m.params.lm_head, ref.lm_head))
            for a, b in pairs:
                for f in ARRAY_FIELDS + ("bias",):
                    x, y = getattr(a, f, None), getattr(b, f, None)
                    if (x is None) != (y is None):
                        diff += 1
                    elif x is not None:
                        diff += int((x.detach().reshape(-1).view(torch.uint8)
                                     != y.detach().reshape(-1).view(torch.uint8)).sum())
            dense_same = all(torch.equal(getattr(a, n_), getattr(b, n_))
                             for a, b in zip(m.params.layers, ref.layers)
                             for n_ in ("attn_norm", "mlp_norm", "post_attn_norm", "post_mlp_norm")
                             if getattr(a, n_) is not None) and torch.equal(m.params.embed, ref.embed)
            del ref
            out1 = m.generate(prompts, max_new_tokens=NEW_TOKENS)
            out2 = m.generate(prompts, max_new_tokens=NEW_TOKENS)
            ok = bool(((out1 >= 0) & (out1 < m.config.vocab_size)).all())
            log(f"phase 17 (f) {name}: {hf['num_hidden_layers']}-layer HF checkpoint {total / 1e9:.3f} GB "
                f"written in {t1 - t0:.3f} s, ingested in sym_int4 in {ingest_s:.3f} s; bytes differing "
                f"from params_from_numpy + optimize_model over the same tensors: {diff}; dense leaves "
                f"equal {dense_same}; greedy tokens (row 0) {out1[0].tolist()[:8]}..., second call "
                f"identical {bool((out1 == out2).all())}")
            check(diff == 0 and dense_same, f"phase 17 (f) {name}: the ingest's bytes")
            check(ok and bool((out1 == out2).all()), f"phase 17 (f) {name}: tokens in the vocabulary, "
                                                     "the same on a second call")
            if name == "gemma2":
                m.save_low_bit(str(root / "gemma2-art"))
                back = AutoModelForCausalLM.load_low_bit(str(root / "gemma2-art"), verify="full",
                                                         device=dev)
                same = bool((back.generate(prompts, max_new_tokens=NEW_TOKENS) == out1).all())
                log(f"phase 17 (f) gemma2: save_low_bit -> load_low_bit, greedy tokens identical {same}")
                check(same, "phase 17 (f) gemma2: the artifact round trip keeps the tokens")
                del back
            del m
            shutil.rmtree(root / name, ignore_errors=True)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"phase 17: {time.time() - t_phase:.1f} s")



# ---------------------------------------------------------------------------
# phase 18: generation's KV-cache policies and the embedding variants
# ---------------------------------------------------------------------------

SNAP_LENS, SNAP_BUDGET, SNAP_WINDOW, SNAP_POOL = (3000, 2400, 1500, 700), 1024, 32, 7
STREAM_LEN, STREAM_WINDOW, STREAM_SINK, STREAM_NEW = 200, 256, 4, 160
CHAT_TURNS, CHAT_SINK, CHAT_WINDOW, CHAT_NEW = (150, 90, 200, 40), 4, 512, 48
POLICY_LAYERS = 2  # the kernels-vs-plain checks' depth, at full width


def plain_patches(kernels) -> dict:
    """The generation path's kernels swapped for their plain versions."""
    return {"qmatmul": kernels.qmatmul_plain, "flash_attention": kernels.flash_attention_plain}


def quantiles(xs) -> str:
    xs = sorted(xs)
    if not xs:
        return "none"
    return (f"median={xs[len(xs) // 2]:.3f} p80={xs[int(0.8 * len(xs))]:.3f} "
            f"max={xs[-1]:.3f} (n={len(xs)})")


def selection_rule(torch, kvcache, c_a, obs_a, c_b, obs_b, window, keep_k):
    """SnapKV's kept slots of two runs over the same prompts (caches c_a,
    c_b before compression, observation queries obs_a, obs_b): per layer
    the slots kept by one run only, each required to have a vote of run b
    within 2 dv of b's keep_k-th largest vote, dv the layer's largest
    vote difference (an order statistic moves by at most dv). Returns
    ([differing slots per layer], [B] bool: rows that agree everywhere,
    whether the rule held)."""
    prefix = kvcache.snapkv_prefix(c_b.start, c_b.pos, window, c_b.max_len)
    B = prefix.shape[0]
    agree = torch.ones(B, dtype=torch.bool, device=prefix.device)
    counts, held = [], True
    for layer in range(c_b.k.shape[0]):
        ks = [None if c.k_scale is None else c.k_scale[layer] for c in (c_a, c_b)]
        va = kvcache.snapkv_votes(c_a.k[layer], ks[0], obs_a[layer], prefix, SNAP_POOL)
        vb = kvcache.snapkv_votes(c_b.k[layer], ks[1], obs_b[layer], prefix, SNAP_POOL)
        ia, ib = (kvcache.snapkv_select(v, prefix, keep_k) for v in (va, vb))
        kept_a = torch.zeros_like(va, dtype=torch.bool).scatter_(-1, ia, True) & prefix[:, None]
        kept_b = torch.zeros_like(vb, dtype=torch.bool).scatter_(-1, ib, True) & prefix[:, None]
        diff = kept_a ^ kept_b  # [B, Hkv, S]
        pm = prefix[:, None, :].expand(va.shape)
        dv = (va - vb).abs()[pm].max().item() if bool(pm.any()) else 0.0
        kth = torch.sort(vb, dim=-1, descending=True).values[..., keep_k - 1:keep_k]
        gap = (vb - kth).abs()[diff]
        held &= bool((gap <= 2 * dv).all())
        counts.append(int(diff.sum()))
        agree &= ~diff.any(-1).any(-1)
    return counts, agree, held


def cache_policy_phases(torch, dev, card, tm, prompts, tok, st, want_tokens,
                        snap_lens=SNAP_LENS, budget=SNAP_BUDGET, stream_len=STREAM_LEN,
                        stream_window=STREAM_WINDOW, stream_new=STREAM_NEW,
                        chat_turns=CHAT_TURNS, chat_window=CHAT_WINDOW, chat_new=CHAT_NEW) -> None:
    """Phase 18, on `tm` (in the run, phase 16's 8-layer model; its
    prompts, padded tokens `tok` and starts `st`, and its greedy tokens
    `want_tokens`): (a) SnapKV,
    (b) attention-sink streaming, (c) a chat session, (d) the embedding
    variants, (e) two full-width layers of (a)-(c) against the plain
    versions. (On the CPU, with shorter lengths and a narrow model, this
    rehearses the phase: only the launch checks fail there.)"""
    import shutil
    import tempfile

    import numpy as np
    from torch.profiler import ProfilerActivity

    from bigdl_tpu_torch import kvcache, optimize_model, streaming
    from bigdl_tpu_torch.chat import ChatSession
    from bigdl_tpu_torch.embedding import HostEmbedding, quantize_embedding
    from bigdl_tpu_torch.generate import pad_prompts
    from bigdl_tpu_torch.models import llama
    from bigdl_tpu_torch.ops import kernels
    from bigdl_tpu_torch.utils import cache_len_for

    cfg = tm.config
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    Hkv, D = cfg.num_key_value_heads, cfg.head_dim_
    G = kernels.GEMV_MAX_ROWS

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def peak_gib(fn):
        """(fn(), its peak device memory above what was allocated before,
        GiB)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        return out, (torch.cuda.max_memory_allocated() - base) / 2**30

    def in_vocab(out, shape):
        return out.shape == shape and bool(((out >= 0) & (out < V)).all())

    def gen_launches(prefill_rows, steps, flash):
        """A generate's launches: the prefill's 4 L projections (GEMM above
        the GEMV's rows), its lm head on the last position (GEMV), then
        4 L + 1 GEMV a decode step; one `flash` a layer at the prefill."""
        want = {k.name: 0 for k in kernels.KERNELS}
        want[kernels.GEMM.name if prefill_rows > G else kernels.GEMV.name] += 4 * L
        want[kernels.GEMV.name] += 1 + steps * (4 * L + 1)
        want[flash.name] = L
        return want

    # ------------------------------------------------------------ (a) SnapKV
    t_a = time.time()
    snap_prompts = [list(np.random.default_rng(40 + i).integers(0, V, n))
                    for i, n in enumerate(snap_lens)]
    snap_tok, snap_start = pad_prompts(snap_prompts, 0)
    Ta = snap_tok.shape[1]
    keep_k = budget - SNAP_WINDOW
    obs_start = Ta - SNAP_WINDOW
    avail = np.maximum(obs_start - snap_start, 0)
    want_start = keep_k - np.minimum(avail, keep_k) + np.maximum(snap_start - obs_start, 0)
    want_rope = Ta - snap_start
    for fp8 in (False, True):
        label = f"phase 18 (a){' fp8' if fp8 else ''}"
        captured = []
        real = kvcache.compress

        def spy(*a, **kw):
            captured.append(real(*a, **kw))
            return captured[-1]

        kernels.reset_launches()
        with mock.patch.object(kvcache, "compress", spy):
            out1, peak = peak_gib(lambda: tm.generate(snap_prompts, NEW_TOKENS, compress_kv=budget,
                                                      compress_window=SNAP_WINDOW, quantize_kv=fp8))
        launches = kernels.launch_counts()
        want = gen_launches(len(snap_prompts) * Ta, NEW_TOKENS - 1,
                            kernels.FLASH_FP8 if fp8 else kernels.FLASH)
        log(f"{label}: SnapKV budget {budget} window {SNAP_WINDOW} pool {SNAP_POOL}, prompts "
            f"{list(snap_lens)} in a bucket of {Ta}: launches {launches} expected {want}")
        check(launches == want, f"{label}: launch counts")
        c = captured[0] if captured else None
        ok = (c is not None and c.max_len == cache_len_for(budget, NEW_TOKENS) and c.pos == budget
              and c.quantized == fp8
              and np.array_equal(c.start.cpu().numpy(), want_start)
              and np.array_equal(c.rope_base.cpu().numpy(), want_rope))
        log(f"{label}: compressed cache length {None if c is None else c.max_len} (want "
            f"{cache_len_for(budget, NEW_TOKENS)}), pos {None if c is None else c.pos}, start "
            f"{None if c is None else c.start.tolist()} (want {want_start.tolist()}), rope_base "
            f"{None if c is None else c.rope_base.tolist()} (want {want_rope.tolist()})")
        check(ok, f"{label}: the compressed cache's length, pos, start and rope_base")
        del captured, c
        out2 = tm.generate(snap_prompts, NEW_TOKENS, compress_kv=budget,
                           compress_window=SNAP_WINDOW, quantize_kv=fp8)
        same = bool((out1 == out2).all())
        log(f"{label}: greedy tokens (row 3) {out1[3].tolist()[:12]}...; second call identical {same}")
        check(in_vocab(out1, (len(snap_prompts), NEW_TOKENS)) and same,
              f"{label}: tokens in the vocabulary, the same on a second call")
        n = 1 if fp8 else 3  # the fp8 arm's times once
        pre = sorted(wall_ms(lambda: tm.generate(snap_prompts, 1, compress_kv=budget,
                                                 compress_window=SNAP_WINDOW, quantize_kv=fp8))
                     for _ in range(n))
        pre_plain = sorted(wall_ms(lambda: tm.generate(snap_prompts, 1, quantize_kv=fp8))
                           for _ in range(n))
        _, peak_plain = peak_gib(lambda: tm.generate(snap_prompts, NEW_TOKENS, quantize_kv=fp8))
        log(f"{label}: prefill_ms (generate of 1 token) SnapKV median={pre[n // 2]:.3f} (n={n}), "
            f"plain median={pre_plain[n // 2]:.3f}; peak memory above the model SnapKV {peak:.3f} "
            f"GiB, plain {peak_plain:.3f} GiB")
        if fp8:
            continue

        def snap_state(compress):
            cache = dataclasses.replace(
                kvcache.init_cache(L, len(snap_prompts), cache_len_for(Ta, NEW_TOKENS), Hkv, D,
                                   device=dev), start=torch.as_tensor(snap_start, device=dev))
            logits, cache, obs = llama.forward(
                cfg, tm.params, torch.as_tensor(snap_tok, dtype=torch.long, device=dev), cache,
                "prefill", last_logits_only=True, collect_obs=SNAP_WINDOW)
            if compress:
                cache = kvcache.compress(cache, obs, budget, cache_len_for(budget, NEW_TOKENS),
                                         window=SNAP_WINDOW, kernel=SNAP_POOL)
            return cache, logits[:, -1].argmax(-1)

        def step(state):
            logits, cache = llama.forward(cfg, tm.params, state[1][:, None], state[0], "decode")
            return cache, logits[:, -1].argmax(-1)

        with torch.inference_mode():
            steps, busy = {}, {}
            for compress in (True, False):
                state = snap_state(compress)
                steps[compress] = []
                for _ in range(NEW_TOKENS - 8):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state = step(state)
                    torch.cuda.synchronize()
                    steps[compress].append((time.perf_counter() - t0) * 1e3)
                with warm_profile([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    state = step(state)
                    torch.cuda.synchronize()
                busy[compress] = sum(e.self_device_time_total for e in device_kernels(prof)) / 1e3
                del state
        log(f"{label}: decode step ms over the compressed cache ({cache_len_for(budget, NEW_TOKENS)} "
            f"slots) {quantiles(steps[True])}, device busy {busy[True]:.3f} of a profiled step; "
            f"over the plain cache ({cache_len_for(Ta, NEW_TOKENS)} slots) {quantiles(steps[False])}, "
            f"device busy {busy[False]:.3f}")
    torch.cuda.empty_cache()
    log(f"phase 18 (a): {time.time() - t_a:.1f} s")

    # --------------------------------------------------------- (b) streaming
    t_b = time.time()
    stream_prompts = [list(np.random.default_rng(60 + i).integers(0, V, stream_len))
                      for i in range(4)]
    shifts = []
    real_shift = streaming.make_sink_shift

    def spy_shift(*a, **kw):
        inner = real_shift(*a, **kw)

        def shift(cache):
            out = inner(cache)
            shifts.append((cache.max_len, cache.pos, out.pos))
            return out
        return shift

    kernels.reset_launches()
    with mock.patch.object(streaming, "make_sink_shift", spy_shift):
        out1, peak = peak_gib(lambda: tm.generate(stream_prompts, stream_new,
                                                  streaming_window=stream_window,
                                                  streaming_sink=STREAM_SINK))
    launches = kernels.launch_counts()
    want = gen_launches(4 * stream_len, stream_new - 1, kernels.FLASH)
    evictions = sum(1 for _, a, b in shifts if b < a)
    lens = sorted({n for n, _, _ in shifts})
    log(f"phase 18 (b): streaming window {stream_window} sink {STREAM_SINK} chunk "
        f"{streaming.default_chunk(stream_window, STREAM_SINK)}, 4 prompts of {stream_len}, "
        f"{stream_new} new tokens: launches {launches} expected {want}; {evictions} evictions; "
        f"cache lengths seen {lens}")
    check(launches == want, "phase 18 (b): launch counts")
    check(evictions >= 3 and lens == [stream_window], "phase 18 (b): at least three evictions, "
          f"the cache {stream_window} slots throughout")
    out2 = tm.generate(stream_prompts, stream_new, streaming_window=stream_window,
                       streaming_sink=STREAM_SINK)
    same = bool((out1 == out2).all())
    check(in_vocab(out1, (4, stream_new)) and same,
          "phase 18 (b): tokens in the vocabulary, the same on a second call")
    half = stream_new // 2  # past the first eviction already
    _, peak2 = peak_gib(lambda: tm.generate(stream_prompts, half, streaming_window=stream_window,
                                            streaming_sink=STREAM_SINK))
    log(f"phase 18 (b): greedy tokens (row 0) {out1[0].tolist()[-12:]} (the last 12); second call "
        f"identical {same}; peak memory above the model at {half} tokens {peak2:.4f} GiB, "
        f"at {stream_new} {peak:.4f} GiB")
    check(peak <= peak2 + 8 / 1024, "phase 18 (b): peak memory grows with the tokens")
    shift = streaming.make_sink_shift(cfg, stream_window, STREAM_SINK,
                                      streaming.default_chunk(stream_window, STREAM_SINK))
    with torch.inference_mode():
        cache = kvcache.init_cache(L, 4, stream_window, Hkv, D, device=dev)
        logits, cache = llama.forward(cfg, tm.params, torch.as_tensor(stream_prompts, device=dev),
                                      cache)
        cur, steps, evict_steps = logits[:, -1].argmax(-1), [], []
        for _ in range(stream_window - stream_len + 3 * streaming.default_chunk(
                stream_window, STREAM_SINK)):  # through three evictions
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            full = cache.pos >= stream_window
            cache = shift(cache)
            logits, cache = llama.forward(cfg, tm.params, cur[:, None], cache, "decode")
            cur = logits[:, -1].argmax(-1)
            torch.cuda.synchronize()
            (evict_steps if full else steps).append((time.perf_counter() - t0) * 1e3)
        del cache, logits
    log(f"phase 18 (b): decode step ms without an eviction {quantiles(steps)}; with one "
        f"{quantiles(evict_steps)}")
    torch.cuda.empty_cache()
    log(f"phase 18 (b): {time.time() - t_b:.1f} s")

    # -------------------------------------------------------------- (c) chat
    t_c = time.time()
    turns = [list(np.random.default_rng(80 + i).integers(0, V, n)) for i, n in enumerate(chat_turns)]
    real_forward = llama.forward
    buckets = []

    def spy_forward(*a, **kw):
        if kw.get("mode", a[4] if len(a) > 4 else "prefill") == "prefill":
            buckets.append(a[2].shape[1])
        return real_forward(*a, **kw)

    def run_chat(record):
        sess = ChatSession(tm, streaming=(CHAT_SINK, chat_window))
        replies = []
        for i, turn in enumerate(turns):
            buckets.clear()
            kernels.reset_launches()
            times, t0 = [], time.perf_counter()
            reply = []
            with mock.patch.object(llama, "forward", spy_forward):
                for t in sess.send_stream(turn, max_new_tokens=chat_new):
                    times.append((time.perf_counter() - t0) * 1e3)
                    reply.append(t)
                    t0 = time.perf_counter()
            torch.cuda.synchronize()
            replies.append(reply)
            if not record:
                continue
            b = buckets[0]
            want = {k.name: 0 for k in kernels.KERNELS}
            want[kernels.GEMM.name if b > G else kernels.GEMV.name] += 4 * L + 1
            want[kernels.GEMV.name] += chat_new * (4 * L + 1)
            want[kernels.FLASH.name] = L
            launches = kernels.launch_counts()
            log(f"phase 18 (c): turn {i + 1}: {len(turn)} tokens, prefill bucket {b}, pos after "
                f"{sess.pos} (window {chat_window}); prefill_ms (to the first token) {times[0]:.3f}; "
                f"decode step ms {quantiles(times[1:])}; launches {launches} expected {want}")
            check(launches == want, f"phase 18 (c): turn {i + 1} launch counts")
            check(sess.pos <= chat_window and sess.cache.max_len == chat_window,
                  f"phase 18 (c): turn {i + 1} the cache stays {chat_window} slots")
        return replies

    first = run_chat(True)
    again = run_chat(False)
    total = sum(chat_turns) + len(chat_turns) * chat_new
    ok = all(len(r) == chat_new and all(0 <= t < V for t in r) for r in first)
    log(f"phase 18 (c): {total} tokens over {len(turns)} turns through a {chat_window}-slot window; "
        f"reply 3 {first[2][:12]}...; a fresh session's replies identical {first == again}")
    check(ok and first == again, "phase 18 (c): replies in the vocabulary, the same from a fresh session")
    check(total > chat_window, "phase 18 (c): the conversation outgrows the window")
    torch.cuda.empty_cache()
    log(f"phase 18 (c): {time.time() - t_c:.1f} s")

    # -------------------------------------------------------- (d) embeddings
    t_d = time.time()
    S = cache_len_for(tok.shape[1], NEW_TOKENS)

    def prefill_logits():
        cache = dataclasses.replace(kvcache.init_cache(L, len(prompts), S, Hkv, D, device=dev),
                                    start=st)
        with torch.inference_mode():
            return llama.forward(cfg, tm.params, tok, cache, "prefill",
                                 last_logits_only=True)[0][:, -1]

    def decode_steps(n=16):
        with torch.inference_mode():
            cache = dataclasses.replace(kvcache.init_cache(L, len(prompts), S, Hkv, D, device=dev),
                                        start=st)
            logits, cache = llama.forward(cfg, tm.params, tok, cache, "prefill",
                                          last_logits_only=True)
            cur, out = logits[:, -1].argmax(-1), []
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = llama.forward(cfg, tm.params, cur[:, None], cache, "decode")
                cur = logits[:, -1].argmax(-1)
                torch.cuda.synchronize()
                out.append((time.perf_counter() - t0) * 1e3)
        return out

    ref_logits = prefill_logits()
    ref_steps = decode_steps()
    torch.cuda.synchronize()
    with_dense = torch.cuda.memory_allocated()
    # the dense table leaves the card while the variants run
    dense = tm.params.embed.detach().cpu()
    host_table = dense.float().numpy()
    tmp = Path(tempfile.mkdtemp(prefix="bigdl_embed_"))
    try:
        np.save(tmp / "embed.npy", host_table)
        variants = (("host RAM", lambda: HostEmbedding(host_table)),
                    ("memmap", lambda: HostEmbedding.from_file(str(tmp / "embed.npy"))),
                    ("sym_int4", lambda: quantize_embedding(dense.to(dev), "sym_int4")))
        for name, make in variants:
            table = make()
            tm.params.set_embed(table)
            tm.params.to(dev)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            saved = (with_dense - torch.cuda.memory_allocated()) / 1e9
            logits = prefill_logits()
            out1 = tm.generate(prompts, NEW_TOKENS)
            out2 = tm.generate(prompts, NEW_TOKENS)
            err = (logits - ref_logits).abs().max().item()
            steps = decode_steps()
            where = ("host" if isinstance(tm.params.embed, HostEmbedding)
                     else str(tm.params.embed.data.device))
            log(f"phase 18 (d) {name}: table on {where}; device memory saved {saved:.3f} GB; prefill "
                f"logits max_abs_err against the dense table {err:.6g} (max|logit| "
                f"{ref_logits.abs().max().item():.6g}); tokens equal the dense table's "
                f"{bool((out1 == want_tokens).all())}, second call identical "
                f"{bool((out1 == out2).all())}; decode step ms {quantiles(steps)} (dense "
                f"{quantiles(ref_steps)})")
            if name == "sym_int4":
                # the gathered rows dequantize to the bits of the whole table's
                tm.params.set_embed(table.dequantize(torch.bfloat16))
                same = torch.equal(prefill_logits(), logits)
                rel = ((logits - ref_logits).abs().mean() / ref_logits.abs().mean()).item()
                log(f"phase 18 (d) sym_int4: mean |logit error| / mean |logit| against the dense "
                    f"table {rel:.4g}; logits bit-equal to a dense table of its dequantized rows {same}")
                check(bool(torch.isfinite(logits).all()) and in_vocab(out1, want_tokens.shape)
                      and bool((out1 == out2).all()) and same,
                      "phase 18 (d) sym_int4: finite logits equal to its dequantized table's, tokens "
                      "in the vocabulary and repeatable")
            else:
                check(torch.equal(logits, ref_logits) and bool((out1 == want_tokens).all())
                      and where == "host",
                      f"phase 18 (d) {name}: prefill logits and tokens bit-equal to the dense table's")
            del table
    finally:
        tm.params.set_embed(dense.to(dev))
        shutil.rmtree(tmp, ignore_errors=True)
        del host_table, dense
    torch.cuda.empty_cache()
    log(f"phase 18 (d): {time.time() - t_d:.1f} s")

    # ----------------------------------- (e) two full-width layers vs plain
    t_e = time.time()
    cfg2 = dataclasses.replace(cfg, num_hidden_layers=POLICY_LAYERS)
    m2 = optimize_model(llama.init_params(cfg2, seed=2, device=dev), cfg2, "sym_int4")
    bound = 0.02  # phase 3's: 2 % of the largest logit
    plain = plain_patches(kernels)

    def fwd(*a, **kw):
        with torch.inference_mode():
            return llama.forward(cfg2, m2, *a, **kw)

    def within(got, ref, what):
        err = (got - ref).abs().max().item()
        tol = bound * ref.abs().max().item()
        log(f"phase 18 (e): {what}: max_abs_err={err:.6g} tol={tol:.6g}")
        check(bool(torch.isfinite(got).all()) and err <= tol, f"phase 18 (e): {what}")

    # SnapKV: prefill and compress, kernels and plain; the first decode
    def snap_prefill():
        cache = dataclasses.replace(
            kvcache.init_cache(POLICY_LAYERS, len(snap_prompts), cache_len_for(Ta, NEW_TOKENS), Hkv,
                               D, device=dev), start=torch.as_tensor(snap_start, device=dev))
        logits, cache, obs = fwd(torch.as_tensor(snap_tok, dtype=torch.long, device=dev), cache,
                                 "prefill", last_logits_only=True, collect_obs=SNAP_WINDOW)
        comp = kvcache.compress(cache, obs, budget, cache_len_for(budget, NEW_TOKENS),
                                window=SNAP_WINDOW, kernel=SNAP_POOL)
        return cache, obs, comp, logits[:, -1]

    c_k, obs_k, comp_k, pre_k = snap_prefill()
    with mock.patch.multiple(kernels, **plain):
        c_p, obs_p, comp_p, pre_p = snap_prefill()
    counts, agree, held = selection_rule(torch, kvcache, c_k, obs_k, c_p, obs_p, SNAP_WINDOW, keep_k)
    del c_k, c_p, obs_k, obs_p
    log(f"phase 18 (e): SnapKV kept slots differing kernels vs plain per layer {counts} "
        f"(of {len(snap_prompts)} rows x {Hkv} heads x {keep_k}); rows agreeing {agree.tolist()}; "
        f"the selection rule (2 dv of the boundary) held {held}")
    check(held, "phase 18 (e): SnapKV's selection rule, kernels vs plain")
    nxt = pre_p.argmax(-1)[:, None]
    d_kk, _ = fwd(nxt, dataclasses.replace(comp_k, k=comp_k.k.clone(), v=comp_k.v.clone()), "decode")
    d_kp, _ = fwd(nxt, dataclasses.replace(comp_p, k=comp_p.k.clone(), v=comp_p.v.clone()), "decode")
    with mock.patch.multiple(kernels, **plain):
        d_pp, _ = fwd(nxt, comp_p, "decode")
    within(d_kp[:, -1], d_pp[:, -1], "SnapKV first decode logits over one compressed cache")
    if bool(agree.any()):
        within(d_kk[agree, -1], d_pp[agree, -1],
               f"SnapKV first decode logits, rows {agree.nonzero().flatten().tolist()} whose "
               "selections agree, each run over its own cache")
    del comp_k, comp_p, d_kk, d_kp, d_pp

    # streaming: decode logits along one token path, after an eviction
    def stream_run(path=None):
        shift2 = streaming.make_sink_shift(cfg2, stream_window, STREAM_SINK,
                                           streaming.default_chunk(stream_window, STREAM_SINK))
        cache = kvcache.init_cache(POLICY_LAYERS, 4, stream_window, Hkv, D, device=dev)
        logits, cache = fwd(torch.as_tensor(stream_prompts, device=dev), cache)
        out, toks, evicted = [], [], None
        cur = logits[:, -1].argmax(-1)
        for i in range(stream_window - stream_len + 8):
            if cache.pos >= stream_window and evicted is None:
                evicted = i
            cache = shift2(cache)
            cur = cur if path is None else path[i]
            toks.append(cur)
            logits, cache = fwd(cur[:, None], cache, "decode")
            out.append(logits[:, -1])
            cur = logits[:, -1].argmax(-1)
        return torch.stack(out, 1), toks, evicted

    s_k, path, evicted = stream_run()
    with mock.patch.multiple(kernels, **plain):
        s_p, _, _ = stream_run(path)
    within(s_k[:, evicted:], s_p[:, evicted:],
           f"streaming decode logits after the eviction at step {evicted}")

    # chat: turn 3's prefill logits (no window), against the plain
    # versions along the same transcript and the kernels' one-shot prefill
    class Recording(ChatSession):
        def _prefill(self, ids):
            self.prefill_logits = super()._prefill(ids)
            return self.prefill_logits

    tm2 = type(tm)(cfg2, m2, "sym_int4", device=dev)
    sess = Recording(tm2, max_len=2048)
    replies = [sess.send(t, max_new_tokens=chat_new) for t in turns[:2]]
    sess.send(turns[2], max_new_tokens=1)
    chat_k = sess.prefill_logits
    with mock.patch.multiple(kernels, **plain):
        ps = ChatSession(tm2, max_len=2048)
        for t, r in zip(turns[:2], replies):
            ps._prefill(t)
            for x in r:
                ps._decode(x)
        chat_p = ps._prefill(turns[2])
    transcript = turns[0] + replies[0] + turns[1] + replies[1] + turns[2]
    one_tok, one_start = pad_prompts([transcript], 0)
    cache = kvcache.init_cache(POLICY_LAYERS, 1, one_tok.shape[1], Hkv, D, device=dev)
    one_k = fwd(torch.as_tensor(one_tok, dtype=torch.long, device=dev),
                dataclasses.replace(cache, start=torch.as_tensor(one_start, device=dev)),
                "prefill", last_logits_only=True)[0][0, -1]
    within(chat_k, chat_p, f"chat turn 3 ({len(transcript)} tokens) against the plain versions")
    within(chat_k, one_k, "chat turn 3 against the kernels' one-shot prefill of the transcript")
    del m2, tm2, sess, ps
    torch.cuda.empty_cache()
    log(f"phase 18 (e): {time.time() - t_e:.1f} s")



# ---------------------------------------------------------------------------
# phase 19: self-speculative and prompt-lookup decoding
# ---------------------------------------------------------------------------

SPEC_PROMPT, SPEC_NEW, SPEC_K = 256, 64, 4  # (a): one seeded prompt, draft_k 4
SPEC_SAMPLED_NEW = 16  # (a)'s sampled runs
LOOKUP_PERIOD, LOOKUP_REPEATS, LOOKUP_NEW = 64, 8, 64  # (b): 64 seeded tokens, 8 times
SPEC_SERVE_REQS, SPEC_ADAPTER_NEW = 8, 32  # (d): the 8 requests sharing the prefix, one wave
SPEC_VERIFY_T, SPEC_OFFSET = (2, 3, 4), 301  # (e): verify rows; q_offset off the tile
# phase 3's bound: a token's teacher-forced logit within 2 % of the largest
# |logit| of its position's maximum (the kernels against plain, 2 layers).
# generate's verify and a one-shot forward take the same route (flash) and
# stay inside it. The engine's verify (per-row positions: the plain
# attention, 8 rows at T = K) and a one-shot forward on that route differ
# by up to 0.19 nat over 32 layers (engine (c) on an H100), above that
# bound (~0.14 nat): the engine's rows are held to phase 7's 0.25 nat.
TF_TOL = 0.02


def spec_traffic(V: int) -> list:
    """Phase 7's 16 requests for the speculative engine: 4 sample
    (temperature 0.8, top-p 0.9: phase 7's requests 9 and 12, and 5 and
    14), 2 carry repetition penalty 1.1 (phase 7's request 3, and 10),
    and request 15's prompt is max_len - 64 tokens, so that its decode
    window ends flush with max_len."""
    import numpy as np

    shared, indep = serving_traffic(V)
    for r in (shared[5], indep[6]):
        r.update(do_sample=True, temperature=0.8, top_p=0.9)
    indep[2]["repetition_penalty"] = 1.1
    indep[7] = dict(prompt=np.random.default_rng(19).integers(1, V, MAX_LEN - SERVE_NEW).tolist(),
                    max_new_tokens=SERVE_NEW)
    return shared + indep


def teacher_forced(torch, cfg, params, prompt, out, per_row=False, lora=None, penalty=1.0):
    """The target's logits [N, V] (f32) for each of the N emitted tokens
    `out`: one forward over prompt + out[:-1] through the kernels, row i
    predicting out[i], over a dense cache on the attention route of the
    run it checks: one position for the batch (generate's verify: the
    flash kernel), or per-row positions (the engine's verify: the plain
    attention). Across the two routes the logits of a 32-layer model
    differ by up to ~0.25 nat (phase 7's MARGIN_TOL), more than TF_TOL.
    `lora` is the request's adapter tree; with a repetition `penalty`
    row i is penalized over the prompt and out[:i], as the engine's
    sampler sees them."""
    from bigdl_tpu_torch.generate import apply_repetition_penalty
    from bigdl_tpu_torch.kvcache import init_cache
    from bigdl_tpu_torch.models import llama
    from bigdl_tpu_torch.utils import round_up

    seq = [int(x) for x in list(prompt) + list(out[:-1])]
    dev = params.final_norm.device
    cache = init_cache(cfg.num_hidden_layers, 1, round_up(len(seq), 64),
                       cfg.num_key_value_heads, cfg.head_dim_, device=dev)
    if per_row:
        cache = dataclasses.replace(cache, pos=torch.zeros((1,), dtype=torch.int32, device=dev))
    with torch.inference_mode():
        logits, _ = llama.forward(cfg, params, torch.tensor([seq], device=dev), cache, "prefill",
                                  lora=lora)
    tf = logits[0, len(prompt) - 1:]
    if penalty != 1.0:
        seen = torch.zeros(tf.shape, dtype=torch.bool, device=dev)
        seen[:, torch.tensor([int(x) for x in prompt], device=dev)] = True
        for i, x in enumerate(out[:-1]):
            seen[i + 1:, int(x)] = True
        tf = apply_repetition_penalty(tf, seen, penalty)
    return tf


def tf_rule(torch, tf, toks, bound=None) -> tuple:
    """The teacher-forced rule over logits tf [N, V] and tokens [N]: each
    token's logit below its position's maximum (gaps [N]), against the
    bound (default TF_TOL x the largest |logit|). Returns (gaps, bound,
    held)."""
    t = torch.tensor([int(x) for x in toks], device=tf.device)
    gaps = tf.max(-1).values - tf.gather(-1, t[:, None])[:, 0]
    bound = TF_TOL * tf.abs().max().item() if bound is None else bound
    return gaps, bound, bool((gaps <= bound).all())


def in_support(torch, tf, toks, temperature, top_p, bound) -> bool:
    """Sampled tokens inside the top-p support at `temperature` of the
    teacher-forced logits, or within the bound of its edge."""
    t = torch.tensor([int(x) for x in toks], device=tf.device)
    z = tf / temperature
    sz = torch.sort(z, dim=-1, descending=True).values
    p = torch.softmax(sz, dim=-1)
    last = ((torch.cumsum(p, dim=-1) - p) < top_p).sum(-1) - 1
    edge = sz.gather(-1, last[:, None])[:, 0]
    return bool((z.gather(-1, t[:, None])[:, 0] >= edge - bound / temperature).all())


def rejections(rounds, n_out, K):
    """(out index, the rejected draft, the emitted token) of every round of
    a speculative run whose acceptance stopped short of its cap, where the
    rejected position lies inside the emitted tokens."""
    out, e = [], 1
    for drafts, choice, n_acc in rounds:
        if n_acc < min(K, len(drafts)) - 1 and e + n_acc < n_out:
            out.append((e + n_acc, drafts[n_acc], choice[n_acc]))
        e += n_acc + 1
    return out


def decode_phases(torch, dev, card, tm, spec_new=SPEC_NEW, spec_prompt=SPEC_PROMPT,
                  lookup_period=LOOKUP_PERIOD, lookup_new=LOOKUP_NEW, serve_new=SERVE_NEW,
                  bf16=None) -> None:
    """Phase 19, after phase 18, on phase 16 (a)'s sym_int4 model `tm` and
    a bf16 model of the same seed (`bf16`, built here unless given): (b)
    prompt lookup through BIGDL_TPU_PERFORMANCE_MODE, (d) the adapter
    engine speculative with a perfect draft, (a) self-speculative
    generate_speculative against the sym_int4 self-draft, (c) the engine
    with speculative=True, adaptive_draft=True on the paged pool, (e) two
    full-width layers' verify against the plain versions. (On the CPU,
    with a narrow model and short lengths, this rehearses the phase: only
    the launch checks fail there.)"""
    import numpy as np

    from bigdl_tpu_torch import TorchModel, decode, optimize_model
    from bigdl_tpu_torch.kvcache import init_cache
    from bigdl_tpu_torch.models import llama
    from bigdl_tpu_torch.ops import kernels
    from bigdl_tpu_torch.serving import InferenceEngine
    from bigdl_tpu_torch.serving.adapters import AdapterRegistry

    cfg = tm.config
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    K = SPEC_K

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    @contextlib.contextmanager
    def flash_rows():
        """The query rows of every flash kernel call in the block."""
        rows, real = [], kernels.flash_attention

        def spy(q, *a, **kw):
            rows.append(q.shape[1])
            return real(q, *a, **kw)

        with mock.patch.object(kernels, "flash_attention", spy):
            yield rows

    def tf_check(label, params, prompt, toks):
        """The teacher-forced rule for one run; returns the logits."""
        tf = teacher_forced(torch, cfg, params, prompt, toks)
        gaps, bound, held = tf_rule(torch, tf, toks)
        off = int((gaps > 0).sum())
        log(f"{label}: teacher-forced rule: {off} of {len(toks)} tokens off their position's "
            f"argmax, largest gap {gaps.max().item():.5f} (bound {bound:.5f})")
        check(held, f"{label}: a token's logit lies more than the bound below its position's maximum")
        return tf, bound

    # ------------------------------------------------- (b) prompt lookup
    t_b = time.time()
    period = np.random.default_rng(50).integers(1, V, lookup_period).tolist()
    lprompt = period * LOOKUP_REPEATS
    stats, real_lookup = {}, decode.lookup_generate

    def lookup_spy(*a, **kw):
        kw["stats"] = stats
        return real_lookup(*a, **kw)

    kernels.reset_launches()
    with mock.patch.dict("os.environ", {"BIGDL_TPU_PERFORMANCE_MODE": "1"}), \
            mock.patch.object(decode, "lookup_generate", lookup_spy), flash_rows() as rows:
        look, look_ms = wall_ms(lambda: tm.generate([lprompt], lookup_new))
    launches = kernels.launch_counts()
    n_r = stats.get("n_rounds", 0)
    want = {k.name: 0 for k in kernels.KERNELS}
    want.update({kernels.GEMM.name: 4 * L, kernels.GEMV.name: 1 + n_r * (4 * L + 1),
                 kernels.FLASH.name: L * (1 + n_r)})
    log(f"phase 19 (b): BIGDL_TPU_PERFORMANCE_MODE, a {len(lprompt)}-token prompt ({lookup_period} "
        f"seeded tokens x {LOOKUP_REPEATS}), {lookup_new} new tokens: switched to prompt lookup "
        f"{bool(stats)}; {n_r} rounds, {stats.get('n_matched', 0)} candidates accepted "
        f"(rounds with a candidate {sum(c is not None for c, _, _ in stats.get('rounds', []))}); "
        f"launches {launches} expected {want}; flash calls at T={K}: {rows.count(K)}")
    check(bool(stats), "(b) the performance-mode switch to prompt lookup")
    check(launches == want and rows.count(K) == L * n_r, "(b) launch counts")
    tf_check("phase 19 (b)", tm.params, lprompt, look[0].tolist())
    plain, plain_ms = wall_ms(lambda: tm.generate([lprompt], lookup_new))
    log(f"phase 19 (b): card {card}; prompt lookup {look_ms / lookup_new:.3f} ms a token "
        f"(generate {look_ms:.1f} ms), plain generate {plain_ms / lookup_new:.3f} ms a token "
        f"({plain_ms:.1f} ms); tokens equal plain's {bool((look == plain).all())}; "
        f"{time.time() - t_b:.1f} s")

    # ------------------------------------------- (d) adapter engine, spec
    t_d = time.time()
    root = Path(__file__).resolve().parent / "build" / "adapters"
    make_adapters(torch, dev, cfg, root / "spec")
    shared, _ = serving_traffic(V)
    d_new = min(serve_new, SPEC_ADAPTER_NEW)
    specs = [dict(sp, max_new_tokens=d_new, adapter=a)
             for sp, a in zip(shared[:SPEC_SERVE_REQS], ADAPTER_OF)]

    def adapter_engine(**kw):
        return InferenceEngine(tm, n_slots=SLOTS, max_len=MAX_LEN, page_size=PAGE, paged=True,
                               adapters=AdapterRegistry(dir=str(root / "spec")), **kw)

    def serve(eng, traffic):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [eng.submit(**sp) for sp in traffic]
        eng.run_until_idle()
        torch.cuda.synchronize()
        return reqs, time.perf_counter() - t0

    def watch_rounds(eng):
        """Per round: (K, each active slot's request and its emitted count
        before the round — None for an idle slot —, drafts, choice, n_acc)
        on the host."""
        log_, real = [], eng._spec_decode

        def spy(k):
            rows = [(s.req, len(s.req.out_tokens)) if eng.active[i] else None
                    for i, s in enumerate(eng._slots)]
            out = real(k)
            choice, _, n_acc, drafts = out
            log_.append((k, rows, drafts.tolist(), choice.tolist(), n_acc.tolist()))
            return out

        eng._spec_decode = spy
        return log_

    def slot_rate(eng, rounds):
        """Tokens a round over the pool, and a slot's tokens a round."""
        slot_rounds = sum(sum(r is not None for r in rows) for _, rows, _, _, _ in rounds)
        return (f"{eng.spec_emitted / max(eng.spec_rounds, 1):.3f} tokens a round over the "
                f"pool, {eng.spec_emitted / max(slot_rounds, 1):.3f} a slot")

    def margin_rule(refs, reqs, rows):
        """Each request's first divergence from the reference engine's
        tokens: (request, token, the reference's top-1/top-2 margin)."""
        ties = []
        for i in rows:
            a, b = refs[i].out_tokens, reqs[i].out_tokens
            j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
            if j is not None:
                top = sorted(refs[i].out_top_logprobs[j].values(), reverse=True)
                ties.append((i, j, round(top[0] - top[1], 5)))
        return ties

    base_eng = adapter_engine(logprobs_top_k=2)
    base_reqs, base_s = serve(base_eng, specs)
    eng = adapter_engine(speculative=True, draft_params=tm.params, draft_k=K)
    rounds_d = watch_rounds(eng)
    lora_rows, real_lora = [], kernels.qmatmul_lora

    def lora_spy(x, *a):
        lora_rows.append(x.reshape(-1, x.shape[-1]).shape[0])
        return real_lora(x, *a)

    with mock.patch.object(kernels, "qmatmul_lora", lora_spy):
        reqs_d, sec_d = serve(eng, specs)
    ok = all(r.finish_reason == "length" and len(r.out_tokens) == d_new for r in reqs_d)
    check(ok and eng.page_leaks() == 0, "(d) every request's budget, no page leaked")
    # every request's tokens against the plain adapter engine's by the
    # margin rule: a first divergence only on a near-tie of its logprobs
    ties = margin_rule(base_reqs, reqs_d, range(len(specs)))
    check(all(m <= MARGIN_TOL for _, _, m in ties), "(d) a request differs from the plain "
                                                    "adapter engine beyond a near-tie")
    # the base rows (the draft is their target) by the teacher-forced rule
    # on the verify's route
    tfs, worst = {}, 0.0
    for i, sp in enumerate(specs):
        if sp["adapter"] is None and not sp.get("repetition_penalty"):
            tfs[i] = teacher_forced(torch, cfg, tm.params, sp["prompt"], reqs_d[i].out_tokens,
                                    per_row=True)
            gaps, _, held = tf_rule(torch, tfs[i], reqs_d[i].out_tokens, MARGIN_TOL)
            worst = max(worst, gaps.max().item())
            check(held, f"(d) base request {i}: teacher-forced rule")
    # full acceptance: each base row's rounds accept K-1 unless the rejected
    # draft sits on a near-tie of the base model's teacher-forced logits
    base_rows = sorted(tfs)
    short, near = 0, []
    index = {id(r): i for i, r in enumerate(reqs_d)}
    full = {i: [0, 0] for i in range(len(specs))}  # per request: full rounds, rounds
    for k, rows, drafts, choice, n_acc in rounds_d:
        for slot, row in enumerate(rows):
            if row is None:
                continue
            i, before = index[id(row[0])], row[1]
            n = n_acc[slot]
            full[i][1] += 1
            full[i][0] += n == k - 1
            if i in base_rows and n < k - 1 and before + n < d_new:
                tf = tfs[i]
                gap = (tf[before + n].max() - tf[before + n, drafts[slot][n]]).item()
                near.append((i, before + n, round(gap, 5)))
                short += gap > MARGIN_TOL
    acc = {i: f"{f}/{n}" for i, (f, n) in full.items()}
    log(f"phase 19 (d): adapter engine (f)'s four adapters, {len(specs)} requests "
        f"(adapters {[sp['adapter'] for sp in specs]}), the model as its own draft, draft_k {K}: "
        f"{eng.spec_rounds} rounds, {slot_rate(eng, rounds_d)}; full-acceptance rounds per "
        f"request {acc}; base rows {base_rows}' rejections "
        f"(request, token, the rejected draft's teacher-forced gap) {near}; LoRA GEMV calls at "
        f"{SLOTS * K} rows {lora_rows.count(SLOTS * K)} (row counts {sorted(set(lora_rows))}); "
        f"base rows by the teacher-forced rule: largest gap {worst:.5f} (bound {MARGIN_TOL}); "
        f"against the plain adapter engine (paged kernel decode), first divergences "
        f"(request, token, its top-1/top-2 margin) {ties} (tol {MARGIN_TOL}); "
        f"{sec_d:.3f} s against {base_s:.3f} s; page_leaks={eng.page_leaks()}; "
        f"{time.time() - t_d:.1f} s")
    check(lora_rows.count(SLOTS * K) > 0, f"(d) the LoRA GEMV at {SLOTS * K} rows")
    check(short == 0, "(d) a base row's rejection off a near-tie: the perfect draft must "
                      "accept K-1 every round")
    del eng, base_eng, tfs
    torch.cuda.empty_cache()

    # ------------------------------------------- (a) generate_speculative
    t_a = time.time()
    if bf16 is None:
        bf16 = TorchModel(cfg, optimize_model(llama.init_params(cfg, seed=0, device=dev), cfg,
                                              "bf16"), "bf16", device=dev)
    draft, draft_s = wall_ms(bf16.self_draft_params)
    check(bf16.self_draft_params() is draft, "(a) the self-draft is cached")
    sprompt = np.random.default_rng(51).integers(1, V, spec_prompt).tolist()
    runs = {}
    for label, kw in (("adaptive off", dict(adaptive=False)),
                      ("adaptive on", dict(adaptive=True)),
                      ("perfect draft", dict(adaptive=False, draft_params=bf16.params)),
                      ("perfect draft, again", dict(adaptive=False, draft_params=bf16.params))):
        st = {}
        kernels.reset_launches()
        with flash_rows() as rows:
            out, ms = wall_ms(lambda: bf16.generate_speculative(
                [sprompt], max_new_tokens=spec_new, draft_k=K, stats=st, **kw))
        launches = kernels.launch_counts()
        runs[label] = (out, ms, st)
        quant = "draft_params" not in kw
        want = {k.name: 0 for k in kernels.KERNELS}
        want[kernels.FLASH.name] = L * (2 + st["n_rounds"])
        if quant:  # the sym_int4 draft: its prefill, lm head and decode steps
            want[kernels.GEMM.name] = 4 * L
            want[kernels.GEMV.name] = 1 + st["n_drafted"] * (4 * L + 1)
        acc = st["n_matched"] / max(st["n_rounds"] * (K - 1), 1)
        log(f"phase 19 (a) {label}: {st['n_rounds']} rounds, {st['n_drafted']} drafted, "
            f"{st['n_matched']} accepted (acceptance {acc:.3f} of K-1 a round, "
            f"{spec_new / st['n_rounds']:.3f} tokens a round), {ms / spec_new:.3f} ms a token; "
            f"launches {launches} expected {want}; flash calls at T={K}: {rows.count(K)}")
        check(launches == want and rows.count(K) == L * st["n_rounds"], f"(a) {label}: launch counts")
        check(out.shape == (1, spec_new) and bool(((out >= 0) & (out < V)).all()),
              f"(a) {label}: tokens in the vocabulary")
    out_a = runs["adaptive off"][0]
    check(bool((runs["perfect draft"][0] == runs["perfect draft, again"][0]).all()),
          "(a) the tokens repeat on a second run")
    for label in ("adaptive off", "adaptive on", "perfect draft"):
        tf, bound = tf_check(f"phase 19 (a) {label}", bf16.params, sprompt, runs[label][0][0].tolist())
    # the perfect draft: K-1 accepted every round, but where the rejected
    # draft sits on a near-tie of the target's teacher-forced logits
    out_p, _, st_p = runs["perfect draft"]
    rej = rejections(st_p["rounds"], spec_new, K)
    gaps = [(i, round((tf[i].max() - tf[i, d]).item(), 5)) for i, d, _ in rej]
    log(f"phase 19 (a) perfect draft: {sum(n == K - 1 for _, _, n in st_p['rounds'])} of "
        f"{st_p['n_rounds']} rounds accept K-1; rejections (token, the rejected draft's "
        f"teacher-forced gap) {gaps} (bound {bound:.5f})")
    check(all(g <= bound for _, g in gaps), "(a) a perfect-draft rejection off a near-tie")
    samp = []
    for _ in range(2):
        samp.append(bf16.generate_speculative([sprompt], max_new_tokens=SPEC_SAMPLED_NEW, draft_k=K,
                                              do_sample=True, temperature=0.8, top_p=0.9, seed=5))
    tf = teacher_forced(torch, cfg, bf16.params, sprompt, samp[0][0].tolist())
    sup = in_support(torch, tf, samp[0][0].tolist(), 0.8, 0.9, TF_TOL * tf.abs().max().item())
    log(f"phase 19 (a) sampled (temperature 0.8, top-p 0.9, seed 5): {samp[0][0].tolist()}; "
        f"in the support {sup}; repeated under the seed {bool((samp[0] == samp[1]).all())}")
    check(sup and bool((samp[0] == samp[1]).all()), "(a) sampled tokens in the support and repeatable")
    plain_t, t_ms = wall_ms(lambda: bf16.generate([sprompt], spec_new))
    dm = TorchModel(cfg, draft, "sym_int4", device=dev)
    _, d_ms = wall_ms(lambda: dm.generate([sprompt], spec_new))
    same = int((plain_t == out_a).sum())
    log(f"phase 19 (a): card {card}; llama3-8b bf16 target, sym_int4 self-draft (built in "
        f"{draft_s / 1e3:.1f} s), one {spec_prompt}-token prompt, {spec_new} greedy tokens, draft_k "
        f"{K}: ms a token speculative {runs['adaptive off'][1] / spec_new:.3f} (adaptive off), "
        f"{runs['adaptive on'][1] / spec_new:.3f} (on), perfect draft "
        f"{runs['perfect draft'][1] / spec_new:.3f}; plain generate of the target "
        f"{t_ms / spec_new:.3f}, of the draft {d_ms / spec_new:.3f}; speculative tokens equal "
        f"plain's at {same} of {spec_new}; {time.time() - t_a:.1f} s")
    del dm, tf, samp

    # ------------------------------------- (c) the engine, speculative
    t_c = time.time()
    traffic = [dict(sp, max_new_tokens=serve_new) for sp in spec_traffic(V)]
    ref = InferenceEngine(bf16, n_slots=SLOTS, max_len=MAX_LEN, page_size=PAGE, paged=True,
                          logprobs_top_k=2)
    hist = {}

    def record(eng, tag):
        for key, h in (("ttft", eng.ttft), ("step", eng.decode_step_seconds)):
            hist[(tag, key)] = []
            h.observe = (lambda h_, o: lambda x: (o.append(x * 1e3), type(h_).observe(h_, x)))(
                h, hist[(tag, key)])

    record(ref, "plain")
    ref_reqs, ref_s = serve(ref, traffic)
    del ref
    torch.cuda.empty_cache()
    eng = InferenceEngine(bf16, n_slots=SLOTS, max_len=MAX_LEN, page_size=PAGE, paged=True,
                          speculative=True, adaptive_draft=True)
    record(eng, "spec")
    rounds_c = watch_rounds(eng)
    real_admit, admits = eng._admit_draft, []

    def admit_spy(slot, prompt, limit):
        admits.append(len(prompt))
        return real_admit(slot, prompt, limit)

    eng._admit_draft = admit_spy
    kernels.reset_launches()
    reqs_c, sec_c = serve(eng, traffic)
    launches = kernels.launch_counts()
    ks = [r[0] for r in rounds_c]
    want = {k.name: 0 for k in kernels.KERNELS}
    want.update({kernels.GEMM.name: 4 * L * len(admits), kernels.FLASH.name: L * len(admits),
                 kernels.GEMV.name: len(admits) + sum(ks) * (4 * L + 1)})
    ok = all(r.finish_reason == "length" and len(r.out_tokens) == serve_new
             and all(math.isfinite(lp) for lp in r.out_logprobs) for r in reqs_c)
    check(ok, f"(c) every request finishes 'length' with {serve_new} tokens and finite logprobs")
    check(eng.page_leaks() == 0, "(c) page leaks")
    check(launches == want, "(c) launch counts: the draft's prefills and decode steps; the "
                            "target's verify (per-row positions) takes the plain attention")
    greedy = [i for i, sp in enumerate(traffic) if not sp.get("do_sample")]
    worst, off, over3, sup_ok = 0.0, 0, 0, True
    for i, sp in enumerate(traffic):
        tf = teacher_forced(torch, cfg, bf16.params, sp["prompt"], reqs_c[i].out_tokens,
                            per_row=True, penalty=sp.get("repetition_penalty", 1.0))
        if i in greedy:
            gaps, _, held = tf_rule(torch, tf, reqs_c[i].out_tokens, MARGIN_TOL)
            worst = max(worst, gaps.max().item())
            off += int((gaps > 0).sum())
            over3 += int((gaps > TF_TOL * tf.abs().max().item()).sum())
            check(held, f"(c) request {i}: teacher-forced rule")
        else:
            sup_ok &= in_support(torch, tf, reqs_c[i].out_tokens, sp["temperature"], sp["top_p"],
                                 TF_TOL * tf.abs().max().item())
        del tf
    check(sup_ok, "(c) sampled rows in the support")
    ties = margin_rule(ref_reqs, reqs_c, greedy)
    flush = reqs_c[-1]
    log(f"phase 19 (c): engine paged, bf16 target, sym_int4 self-draft, speculative adaptive "
        f"(ladder {eng._k_ladder}, rounds at K {dict(collections.Counter(ks))}, last K "
        f"{eng._cur_k}): {eng.spec_rounds} rounds, {eng.spec_emitted} tokens, "
        f"{slot_rate(eng, rounds_c)}; {len(admits)} draft "
        f"admissions; launches {launches} expected {want}; page_leaks={eng.page_leaks()}; "
        f"greedy rows {greedy} (penalized where asked) by the teacher-forced rule: {off} tokens "
        f"off their argmax, {over3} beyond phase 3's bound, largest gap {worst:.5f} (bound "
        f"{MARGIN_TOL}); sampled rows in the support "
        f"{sup_ok}; against the plain engine (paged kernel decode), first divergences "
        f"(request, token, its top-1/top-2 margin) {ties}; request 15 (window flush with "
        f"max_len, {len(flush.prompt)} + "
        f"{serve_new}) {flush.finish_reason} with {len(flush.out_tokens)} tokens")
    for tag, sec in (("speculative", sec_c), ("plain", ref_s)):
        h = "spec" if tag == "speculative" else "plain"
        log(f"phase 19 (c) {tag}: {len(traffic)} requests in {sec:.3f} s = "
            f"{len(traffic) / sec:.3f} requests/s, {len(traffic) * serve_new / sec:.1f} tokens/s; "
            f"TTFT ms {quantiles(hist[(h, 'ttft')])}; decode step (a round when speculative) ms "
            f"{quantiles(hist[(h, 'step')])}")
    log(f"phase 19 (c): card {card}; {time.time() - t_c:.1f} s")
    del eng, bf16, draft
    torch.cuda.empty_cache()

    # ---------------------------- (e) two full-width layers, kernels vs plain
    t_e = time.time()
    cfg2 = dataclasses.replace(cfg, num_hidden_layers=POLICY_LAYERS)
    m2 = optimize_model(llama.init_params(cfg2, seed=19, device=dev), cfg2, "sym_int4")
    rng = np.random.default_rng(52)

    def verify_logits(B, T, plain):
        """Prefill B rows of SPEC_OFFSET tokens, then a verify of T rows at
        q_offset = SPEC_OFFSET; its [B, T, V] logits."""
        toks = torch.as_tensor(rng.integers(1, V, (B, SPEC_OFFSET + T)), device=dev)
        cache = init_cache(POLICY_LAYERS, B, SPEC_OFFSET + 64, cfg.num_key_value_heads,
                           cfg.head_dim_, device=dev)
        patches = (mock.patch.multiple(kernels, **plain_patches(kernels)) if plain
                   else contextlib.nullcontext())
        with patches, torch.inference_mode():
            _, cache = llama.forward(cfg2, m2, toks[:, :SPEC_OFFSET], cache, "prefill")
            return llama.forward(cfg2, m2, toks[:, SPEC_OFFSET:], cache, "prefill")[0]

    lines = []
    for B, T in [(1, t) for t in SPEC_VERIFY_T] + [(SLOTS, K)]:
        state = rng.bit_generator.state
        n0 = (kernels.GEMV.launches, kernels.FLASH.launches)
        got = verify_logits(B, T, False)
        n1 = (kernels.GEMV.launches, kernels.FLASH.launches)
        rng.bit_generator.state = state
        ref_l = verify_logits(B, T, True)
        err = (got - ref_l).abs().max().item()
        tol = TF_TOL * ref_l.abs().max().item()
        # the prefill (B x 301 rows) takes the GEMM, the verify's projections
        # and lm head at M = B T rows the GEMV; one flash a layer each
        gemv = n1[0] - n0[0]
        lines.append(f"B={B} T={T} (M={B * T}) max_abs_err={err:.6g} tol={tol:.6g} "
                     f"verify GEMV launches {gemv}")
        check(bool(torch.isfinite(got).all()) and err <= tol, f"(e) verify B={B} T={T}: logits")
        check(gemv == 4 * POLICY_LAYERS + 1 and n1[1] - n0[1] == 2 * POLICY_LAYERS,
              f"(e) verify B={B} T={T}: GEMV at M={B * T} and flash launches")
    log(f"phase 19 (e): 2-layer full-width verify at q_offset {SPEC_OFFSET} against the plain "
        f"versions: {'; '.join(lines)}; {time.time() - t_e:.1f} s")
    del m2
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 20: mixture of experts, ALiBi and logn
# ---------------------------------------------------------------------------

MOE_LAYERS = 16  # mixtral-8x7b's depth here: half of its 32 layers, full width
MOE_SERVE_REQS = 4  # engine (b): 4 prefix-sharing and 4 independent requests of phase 7
# Qwen1.5-MoE-A2.7B's published config.json (the port's translation of it),
# baichuan-13b's and Qwen-7B's widths; 2 layers each
QWEN2_MOE_A27B = dict(model_type="qwen2_moe", vocab_size=151936, hidden_size=2048,
                      intermediate_size=5632, num_hidden_layers=2, num_attention_heads=16,
                      num_key_value_heads=16, attention_bias=True, rope_theta=1e6,
                      max_position_embeddings=8192, num_experts=60, num_experts_per_tok=4,
                      moe_intermediate_size=1408, shared_expert_intermediate_size=5632)
BAICHUAN_13B = dict(model_type="baichuan", vocab_size=64000, hidden_size=5120,
                    intermediate_size=13696, num_hidden_layers=2, num_attention_heads=40,
                    num_key_value_heads=40, rms_norm_eps=1e-6, max_position_embeddings=4096,
                    alibi=True)
QWEN_7B = dict(model_type="qwen", vocab_size=151936, hidden_size=4096, intermediate_size=11008,
               num_hidden_layers=2, num_attention_heads=32, num_key_value_heads=32,
               rms_norm_eps=1e-6, max_position_embeddings=8192, attention_bias=True,
               logn_attn=True, logn_train_len=2048)
LOGN_PROMPT = 3000  # (e): past logn_train_len


# Two runs of one MoE model on different routes (generate's steps, a
# one-shot forward) choose other experts for a token where its router
# logits' k-th and (k+1)-th values lie within this much of each other
# (bf16 roundings of its input); a flip moves the token by a whole expert.
ROUTER_TOL = 0.05  # 4x the largest seen on the H100 (0.0122, PERF.md)


@contextlib.contextmanager
def routes_recorded(torch, llama):
    """`llama._moe_router` recording every call's chosen experts (sorted,
    [B, T, k]) and the gap between its k-th and (k+1)-th router logits
    ([B, T]), in call order (layer by layer, forward by forward)."""
    real, calls = llama._moe_router, []

    def recorded(config, xc, p):
        topv, topi = real(config, xc, p)
        top = torch.matmul(xc.float(), p["router"].to(xc.dtype).float().t()).sort(
            -1, descending=True).values
        k = config.num_experts_per_tok
        calls.append((topi.sort(-1).values, top[..., k - 1] - top[..., k]))
        return topv, topi

    with mock.patch.object(llama, "_moe_router", recorded):
        yield calls


def routing_rule(torch, cfg, params, prompts, out, gen_calls) -> None:
    """The issue of near-ties in the router, settled token by token:
    each row of a `generate` run (routes `gen_calls`: the prefill's L
    calls, then L a decode step) against a one-shot forward of prompt +
    out[:-1] on the generate route (`teacher_forced`), expert choices
    compared at every layer and position. Where no choice differs, every
    token lies within MARGIN_TOL of the one-shot forward's maximum (the
    dense models' cross-route rule); where some do, at the first layer
    with a difference every differing token is a near-tie (k-th and
    (k+1)-th router logits within ROUTER_TOL in either run): before that
    layer the runs differ by roundings only."""
    from bigdl_tpu_torch.models import llama

    L = cfg.num_hidden_layers
    T = gen_calls[0][0].shape[1]
    rows = []
    for b, (p_, o_) in enumerate(zip(prompts, out)):
        with routes_recorded(torch, llama) as tf_calls:
            tf = teacher_forced(torch, cfg, params, p_, o_)
        gaps = tf_rule(torch, tf, o_, bound=MARGIN_TOL)[0]
        first, tie_gaps, n_diff = None, [], 0
        for layer in range(L):
            steps = [gen_calls[layer]] + [gen_calls[L * s + layer] for s in range(1, len(o_))]
            g_e = torch.cat([steps[0][0][b, T - len(p_):]] + [c[0][b] for c in steps[1:]])
            g_gap = torch.cat([steps[0][1][b, T - len(p_):]] + [c[1][b] for c in steps[1:]])
            t_e, t_gap = tf_calls[layer][0][0], tf_calls[layer][1][0]
            differ = (g_e != t_e).any(-1)
            n_diff += int(differ.sum())
            if first is None and bool(differ.any()):
                first = layer
                tie_gaps = torch.minimum(g_gap, t_gap)[differ].tolist()
        held = (all(g <= ROUTER_TOL for g in tie_gaps) if first is not None
                else bool((gaps <= MARGIN_TOL).all()))
        rows.append((b, n_diff, first, round(max(tie_gaps, default=0.0), 4),
                     round(gaps.max().item(), 4)))
        check(held, f"phase 20 (a): row {b}: the routing rule ({rows[-1]})")
    log(f"phase 20 (a): generate against a one-shot forward, expert choices at {L} layers x "
        f"every position (row, tokens x layers choosing other experts, first such layer, the "
        f"largest router-logit gap among that layer's differing tokens, bound {ROUTER_TOL}; the "
        f"row's largest teacher-forced gap, bound {MARGIN_TOL} where no choice differs): {rows}")


def moe_configs():
    """Phase 20's four configurations, full width: mixtral-8x7b at
    MOE_LAYERS of its 32 layers, and 2 layers of the others."""
    from bigdl_tpu_torch import PRESETS, ModelConfig

    return {"mixtral": dataclasses.replace(PRESETS["mixtral-8x7b"], num_hidden_layers=MOE_LAYERS),
            "qwen2_moe": ModelConfig(**QWEN2_MOE_A27B), "baichuan": ModelConfig(**BAICHUAN_13B),
            "qwen": ModelConfig(**QWEN_7B)}


# the model-level helpers of phases 20 and 21: wall times, a dense cache's
# logits through the kernels against the plain versions, the paged engine


def wall_ms(torch, fn) -> float:
    """fn's wall time in ms, the card synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def quantile(xs, f):
    xs = sorted(xs)
    return xs[min(int(f * len(xs)), len(xs) - 1)]


def ragged_prompts(V):
    """Phase 3's B = 4 ragged prompts, seeded, in [0, V)."""
    import numpy as np

    return [list(np.random.default_rng(i).integers(0, V, n)) for i, n in enumerate(PROMPT_LENS)]


def dense_logits(torch, dev, cfg, model, toks, start, n_decode=0, feed=None):
    """Prefill last logits over a dense cache, then n_decode decode steps
    fed `feed` [B, n_decode] (greedy when None): ([n_decode + 1, B, V]
    float32, the tokens fed or None)."""
    from bigdl_tpu_torch.kvcache import init_cache
    from bigdl_tpu_torch.models import llama

    cache = dataclasses.replace(
        init_cache(cfg.num_hidden_layers, toks.shape[0], toks.shape[1] + n_decode + 8,
                   cfg.num_key_value_heads, cfg.head_dim_, device=dev), start=start)
    out, fed = [], []
    with torch.inference_mode():
        logits, cache = llama.forward(cfg, model, toks, cache, "prefill", last_logits_only=True)
        out.append(logits[:, -1])
        for i in range(n_decode):
            fed.append(out[-1].argmax(-1) if feed is None else feed[:, i])
            logits, cache = llama.forward(cfg, model, fed[-1][:, None], cache, "decode")
            out.append(logits[:, -1])
    return torch.stack(out), (torch.stack(fed, 1) if fed else None)


def logits_vs_plain(torch, dev, phase, label, cfg, model, toks, start, n_decode=0, margin=False):
    """Logits through the kernels against the plain versions fed the same
    tokens, phase 3's bound (2 % of the largest plain logit); with
    `margin`, the greedy tokens by the margin rule too (a differing token
    only where the plain run's top-1/top-2 margin is within MARGIN_TOL).
    Returns the kernels' logits."""
    from bigdl_tpu_torch.ops import kernels

    kern, fed = dense_logits(torch, dev, cfg, model, toks, start, n_decode)
    with mock.patch.multiple(kernels, **plain_kernels(kernels)):
        ref, _ = dense_logits(torch, dev, cfg, model, toks, start, n_decode, feed=fed)
    err, tol = (kern - ref).abs().max().item(), 0.02 * ref.abs().max().item()
    line = (f"phase {phase} {label}: logits through the kernels vs plain: max_abs_err={err:.6g} "
            f"tol={tol:.6g}")
    ties = []
    if margin:
        top = ref.topk(2, dim=-1).values
        differ = kern.argmax(-1) != ref.argmax(-1)
        ties = (top[..., 0] - top[..., 1])[differ].tolist()
        line += (f"; greedy tokens differing at {len(ties)} of {differ.numel()} (plain margins "
                 f"{[round(m, 4) for m in ties]}, tol {MARGIN_TOL})")
    log(line)
    check(bool(torch.isfinite(kern).all()) and err <= tol,
          f"phase {phase} {label}: kernels vs plain")
    check(all(m <= MARGIN_TOL for m in ties), f"phase {phase} {label}: greedy tokens by the "
                                              "margin rule")
    return kern


def serve_paged(torch, phase, tm, specs, logprobs_top_k=0, record=None):
    """The paged engine at phase 8's settings over `specs`, every request
    to its budget and no page leaked: (requests, seconds, decode steps,
    TTFT and decode-step observations); `record` collects each paged
    launch's (layer, window, scale)."""
    from bigdl_tpu_torch.ops import kernels
    from bigdl_tpu_torch.serving import InferenceEngine

    eng = InferenceEngine(tm, n_slots=SLOTS, max_len=MAX_LEN, page_size=PAGE, paged=True,
                          logprobs_top_k=logprobs_top_k)
    seen = {"ttft": [], "step": []}
    for key, hist in (("ttft", eng.ttft), ("step", eng.decode_step_seconds)):
        hist.observe = (lambda h, out: lambda x: (out.append(x), type(h).observe(h, x)))(
            hist, seen[key])
    real = kernels.paged_attention

    def recorded(q_, k_pages, v_pages, block_tables, layer, *a, **kw_):
        record.append((layer, kw_.get("window"), kw_.get("scale")))
        return real(q_, k_pages, v_pages, block_tables, layer, *a, **kw_)

    with (mock.patch.object(kernels, "paged_attention", recorded) if record is not None
          else contextlib.nullcontext()):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [eng.submit(**sp) for sp in specs]
        eng.run_until_idle()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    check(eng.page_leaks() == 0, f"phase {phase}: the engine's page leaks after the drain")
    check(all(r.finish_reason == "length" and len(r.out_tokens) == sp["max_new_tokens"]
              for r, sp in zip(reqs, specs)), f"phase {phase}: every request finishes with its "
                                              "budget")
    return reqs, sec, eng.decode_step_seconds.count, seen


def serve_text(reqs, sec, steps, seen):
    ntok = sum(len(r.out_tokens) for r in reqs)
    return (f"{len(reqs)} requests, {SLOTS} slots, pages of {PAGE}: {sec:.3f} s = "
            f"{len(reqs) / sec:.3f} requests/s, {ntok / sec:.1f} generated tokens/s; TTFT ms "
            f"median={quantile(seen['ttft'], .5) * 1e3:.3f} "
            f"p90={quantile(seen['ttft'], .9) * 1e3:.3f}; decode step ms "
            f"median={quantile(seen['step'], .5) * 1e3:.3f} "
            f"p90={quantile(seen['step'], .9) * 1e3:.3f} (n={steps})")


def moe_phases(torch, dev, card, configs=None, logn_prompt=LOGN_PROMPT) -> None:
    """Phase 20: (a) mixtral-8x7b through `generate` (launches, tokens,
    times, the experts' share of a decode step, peak memory; 2 layers
    against the plain versions, dense against ragged); (b) the paged
    engine on it; (c) 2-layer qwen2-moe (ragged, shared expert) against
    the plain versions; (d) 2-layer baichuan-13b (ALiBi: no attention
    kernel) through generate and the engine; (e) 2-layer Qwen-7B with
    logn past its training length through the flash kernel. `configs`
    replaces `moe_configs()` (a CPU rehearsal at narrow widths)."""
    import numpy as np

    from bigdl_tpu_torch import TorchModel, optimize_model
    from bigdl_tpu_torch.generate import pad_prompts
    from bigdl_tpu_torch.kvcache import init_cache
    from bigdl_tpu_torch.models import llama
    from bigdl_tpu_torch.ops import kernels

    configs = configs or moe_configs()

    def build(cfg, seed):
        """`init_params(low_bit=)`: each layer quantized as it is made."""
        return optimize_model(llama.init_params(cfg, seed=seed, device=dev, low_bit="sym_int4"), cfg)

    def last_logits(cfg, model, toks, start, n_decode=0):
        return dense_logits(torch, dev, cfg, model, toks, start, n_decode)[0]

    def vs_plain(label, cfg, model, toks, start, n_decode=0):
        return logits_vs_plain(torch, dev, 20, label, cfg, model, toks, start, n_decode)

    def serve(tm, specs):
        return serve_paged(torch, 20, tm, specs)

    # (a) mixtral-8x7b through generate ---------------------------------
    cfg = configs["mixtral"]
    L, V, H = cfg.num_hidden_layers, cfg.vocab_size, cfg.hidden_size
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    EI = cfg.moe_intermediate_size or cfg.intermediate_size
    per_layer = 2 * H * (cfg.q_dim + cfg.kv_dim) + 3 * E * EI * H + E * H + 2 * H
    dense_gib = (L * per_layer + 2 * V * H + H) * 2 / 2**30  # every weight in bf16
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    model = build(cfg, 0)
    tm = TorchModel(cfg, model, "sym_int4", device=dev)
    torch.cuda.synchronize()
    build_s = time.time() - t
    model_gib = torch.cuda.memory_allocated() / 2**30 - base_gib
    build_peak = torch.cuda.max_memory_allocated() / 2**30 - base_gib
    log(f"phase 20 (a): card {card}")
    log(f"phase 20 (a): mixtral-8x7b {L} of 32 layers (hidden {H}, {E} experts of "
        f"{EI}, top-{k}) sym_int4 built layer by "
        f"layer in {build_s:.1f} s: {model_gib:.3f} GiB on the card, peak during the build "
        f"{build_peak:.3f} GiB (the dense bf16 model would be {dense_gib:.3f} GiB); dispatch "
        f"{llama.resolve_moe_dispatch(cfg)}")
    check(build_peak < dense_gib, "phase 20 (a): the build never holds the dense model")
    prompts = ragged_prompts(V)
    kernels.reset_launches()
    with routes_recorded(torch, llama) as gen_routes:
        out1 = tm.generate(prompts, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    want = {kn.name: 0 for kn in kernels.KERNELS}
    want.update({kernels.GEMM.name: 2 * L, kernels.GEMV.name: 1 + (NEW_TOKENS - 1) * (2 * L + 1),
                 kernels.FLASH.name: L})
    log(f"phase 20 (a): launches {launches} expected {want} (the attention's wqkv and wo; the "
        "experts are dequantized, then einsums, as JAX computes them)")
    check(launches == want, "phase 20 (a): mixtral launch counts")
    check(out1.shape == (len(prompts), NEW_TOKENS) and bool(((out1 >= 0) & (out1 < V)).all()),
          "phase 20 (a): tokens in the vocabulary")
    torch.cuda.reset_peak_memory_stats()
    out2 = tm.generate(prompts, max_new_tokens=NEW_TOKENS)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(bool((out1 == out2).all()), "phase 20 (a): identical tokens on a second call")
    routing_rule(torch, cfg, tm.params, prompts, out1, gen_routes)
    prefill_ms = sorted(wall_ms(torch, lambda: tm.generate(prompts, 1)) for _ in range(3))
    tokens, st = pad_prompts(prompts, 0)
    tok = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    stt = torch.as_tensor(st, device=dev)
    Hkv, D = cfg.num_key_value_heads, cfg.head_dim_
    n_steps = 8
    with torch.inference_mode():
        cache = dataclasses.replace(
            init_cache(L, len(prompts), tokens.shape[1] + n_steps + 16, Hkv, D, device=dev),
            start=stt)
        logits, cache = llama.forward(cfg, tm.params, tok, cache, "prefill", last_logits_only=True)
        box = [cache, logits[:, -1].argmax(-1)]

        def step():
            lg, box[0] = llama.forward(cfg, tm.params, box[1][:, None], box[0], "decode")
            box[1] = lg[:, -1].argmax(-1)

        step_ms = [wall_ms(torch, step) for _ in range(n_steps)]
        prof = profiled_steps(torch, step, 3, {kernels.GEMV.name: (
            re.compile(r"namespace\)::gemv_kernel"), (2 * L + 1) * 3)}, "phase 20 (a) decode")
        # one layer's MoE block at the decode step's shape, isolated: the
        # experts' dequantize alone, then the whole block
        x = torch.randn(len(prompts), 1, H, device=dev).to(torch.bfloat16)
        leaves = tm.params.layers[0].moe.leaves()
        deq_ms = device_ms(torch, lambda: [llama._deq(leaves[n], torch.bfloat16)
                                           for n in llama.MOE_EXPERTS], [()], iters=5)
        moe_ms = device_ms(torch, lambda: llama._moe_mlp(cfg, x, leaves, torch.bfloat16), [()],
                           iters=5)
    del cache, logits, box
    busy = sum(e.self_device_time_total for e in device_kernels(prof)) / 1e3 / 3 or math.nan
    med = quantile(step_ms, 0.5)
    log(f"phase 20 (a): mixtral-8x7b {L} layers sym_int4 B={len(prompts)} prompt bucket "
        f"{tokens.shape[1]}: prefill_ms (generate of 1 token) median={prefill_ms[1]:.3f} "
        f"min={prefill_ms[0]:.3f} max={prefill_ms[-1]:.3f} (n=3); decode step ms (host-set) "
        f"median={med:.3f} max={max(step_ms):.3f} (n={n_steps}); profiled decode: device busy "
        f"{busy:.3f} ms per step = {busy / med:.3f} of the median step; peak_mem_gib={peak_gib:.3f}")
    log(f"phase 20 (a): the MoE block at B={len(prompts)}, one token, isolated (device time): "
        f"{moe_ms:.3f} ms a layer, of it the experts' dequantize {deq_ms:.3f} ms (3 x {E} x "
        f"{EI} x {H}); x {L} layers = "
        f"{L * moe_ms:.3f} ms = {L * moe_ms / busy:.3f} of the busy step (dequantize "
        f"{L * deq_ms / busy:.3f}, the einsums and routing {L * (moe_ms - deq_ms) / busy:.3f}, "
        f"the rest {1 - L * moe_ms / busy:.3f})")
    for e in device_kernels(prof)[:6]:
        log(f"  {e.self_device_time_total / 1e3 / 3:8.3f} ms/step {e.count // 3:5d} calls/step  "
            f"{e.key[:90]}")

    cfg2 = dataclasses.replace(cfg, num_hidden_layers=FLAGS_LAYERS)
    m2 = build(cfg2, 1)
    kern = vs_plain("(a) 2-layer prefill", cfg2, m2, tok, stt)
    cap = E / k  # C >= N: nothing overflows
    rg = last_logits(dataclasses.replace(cfg2, moe_dispatch="ragged", moe_capacity_factor=cap),
                     m2, tok, stt)
    err, tol = (rg - kern).abs().max().item(), 0.02 * kern.abs().max().item()
    log(f"phase 20 (a): 2-layer ragged dispatch (capacity factor {cap}: nothing dropped) vs "
        f"dense: max_abs_err={err:.6g} tol={tol:.6g}")
    check(err <= tol, "phase 20 (a): ragged against dense")
    del m2, kern, rg

    # (b) the paged engine on mixtral -----------------------------------
    shared, indep = serving_traffic(V)
    specs = [dict(prompt=sp["prompt"], max_new_tokens=NEW_TOKENS)
             for sp in shared[:MOE_SERVE_REQS] + indep[:MOE_SERVE_REQS]]
    kernels.reset_launches()
    reqs, sec, steps, seen = serve(tm, specs)
    paged_n = kernels.launch_counts()[kernels.PAGED.name]
    moe_step = quantile(seen["step"], .5) * 1e3
    log(f"phase 20 (b): mixtral engine paged bf16, {serve_text(reqs, sec, steps, seen)}; paged "
        f"launches {paged_n} ({L} a decode step)")
    check(paged_n == L * steps and steps > 0, f"phase 20 (b): {L} paged launches a decode step")
    again = serve(tm, specs)[0]
    check(all(a.out_tokens == b.out_tokens for a, b in zip(reqs, again)),
          "phase 20 (b): identical tokens on a second run")
    del reqs, again, tm, model
    torch.cuda.empty_cache()

    # (c) qwen2-moe: the capacity dispatch and the shared expert --------
    cfg = configs["qwen2_moe"]
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    t = time.time()
    model = build(cfg, 2)
    torch.cuda.synchronize()
    log(f"phase 20 (c): qwen2-moe (Qwen1.5-MoE-A2.7B's width: {cfg.num_experts} experts of "
        f"{cfg.moe_intermediate_size}, top-{cfg.num_experts_per_tok}, shared expert "
        f"{cfg.shared_expert_intermediate_size}) {L} layers built in {time.time() - t:.1f} s; "
        f"dispatch {llama.resolve_moe_dispatch(cfg)} (auto), capacity "
        f"{math.ceil(tok.numel() * cfg.num_experts_per_tok * cfg.moe_capacity_factor / cfg.num_experts)}"
        " slots an expert at the prefill")
    check(llama.resolve_moe_dispatch(cfg) == "ragged", "phase 20 (c): the auto rule picks ragged")
    qtok = torch.remainder(tok, V)
    kernels.reset_launches()
    vs_plain("(c) prefill and a decode step", cfg, model, qtok, stt, n_decode=1)
    got = kernels.launch_counts()
    check((got[kernels.GEMM.name], got[kernels.GEMV.name], got[kernels.FLASH.name])
          == (2 * L, 1 + 2 * L + 1, L), f"phase 20 (c): launches {got}")
    del model
    torch.cuda.empty_cache()

    # (d) ALiBi: baichuan-13b's width -----------------------------------
    cfg = configs["baichuan"]
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    tm = TorchModel(cfg, build(cfg, 3), "sym_int4", device=dev)
    aprompts = [[x % V for x in p_] for p_ in prompts]
    kernels.reset_launches()
    out = tm.generate(aprompts, NEW_TOKENS)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    want = {kn.name: 0 for kn in kernels.KERNELS}
    want.update({kernels.GEMM.name: 4 * L, kernels.GEMV.name: 1 + (NEW_TOKENS - 1) * (4 * L + 1)})
    log(f"phase 20 (d): baichuan-13b width ({cfg.num_attention_heads} heads: ALiBi slopes past 32 "
        f"interpolated) {L} layers: generate launches {launches} expected {want} (no flash: "
        f"JAX's rule); routes prefill {routes_text(llama, cfg, 'dense', 'prefill', 2)}, paged "
        f"decode {routes_text(llama, cfg, 'paged', 'decode', 1, True)}")
    check(launches == want, "phase 20 (d): ALiBi generate launch counts")
    check(bool((out == tm.generate(aprompts, NEW_TOKENS)).all()),
          "phase 20 (d): identical tokens on a second call")
    atraffic = [dict(prompt=[x % V for x in sp["prompt"]], max_new_tokens=NEW_TOKENS)
                for sp in indep[:MOE_SERVE_REQS]]  # no prefix hit: one prefill each
    kernels.reset_launches()
    reqs, sec, steps, seen = serve(tm, atraffic)
    launches = kernels.launch_counts()
    want = {kn.name: 0 for kn in kernels.KERNELS}
    want.update({kernels.GEMM.name: 4 * L * len(atraffic),
                 kernels.GEMV.name: len(atraffic) + steps * (4 * L + 1)})
    log(f"phase 20 (d): ALiBi engine paged bf16 (the plain attention over kvpaged.read_layer's "
        f"gather of max_len {MAX_LEN} slots), {serve_text(reqs, sec, steps, seen)} (mixtral's "
        f"{moe_step:.3f}); launches {launches} expected {want}")
    check(launches == want, "phase 20 (d): ALiBi engine launch counts")
    bt, bs = pad_prompts(aprompts, 0)
    vs_plain("(d) ALiBi prefill and a decode step", cfg, tm.params,
             torch.as_tensor(bt, dtype=torch.long, device=dev), torch.as_tensor(bs, device=dev),
             n_decode=1)
    del tm, reqs
    torch.cuda.empty_cache()

    # (e) logn past logn_train_len: Qwen-7B's width ---------------------
    cfg = configs["qwen"]
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    model = build(cfg, 4)
    ltok = torch.as_tensor(np.random.default_rng(20).integers(0, V, (2, logn_prompt)),
                           dtype=torch.long, device=dev)
    lst = torch.zeros(2, dtype=torch.int32, device=dev)
    seen_q = []
    real_flash = kernels.flash_attention

    def recorded(q_, *a, **kw):
        seen_q.append(q_.clone())
        return real_flash(q_, *a, **kw)

    with mock.patch.object(kernels, "flash_attention", recorded):
        kernels.reset_launches()
        on = last_logits(cfg, model, ltok, lst)
        flash_n = kernels.FLASH.launches
        off_cfg = dataclasses.replace(cfg, logn_attn=False)
        off = last_logits(off_cfg, model, ltok, lst)
    vs_plain(f"(e) logn prefill of {logn_prompt} tokens", cfg, model, ltok, lst)
    pos = torch.arange(logn_prompt, device=dev, dtype=torch.float32)
    factor = torch.clamp(torch.log(pos + 1) / torch.log(torch.tensor(
        float(cfg.logn_train_len), device=dev)), min=1.0).to(torch.bfloat16)[None, :, None, None]
    q_on, q_off = seen_q[0], seen_q[L]  # layer 0 of each run
    inside = cfg.logn_train_len - 1
    scaled = (torch.equal(q_on[:, :inside], q_off[:, :inside])
              and torch.equal(q_on, q_off * factor))
    diff = (on - off).abs().max().item()
    log(f"phase 20 (e): Qwen-7B width, {L} layers, logn_train_len {cfg.logn_train_len}, "
        f"B=2 T={logn_prompt}: flash launches {flash_n} (a layer); the flash kernel's q is "
        f"logn_attn=False's times max(1, log(p + 1) / log({cfg.logn_train_len})) bit for bit "
        f"({scaled}; factor {factor.max().item():.4f} at the last position); last logits with "
        f"logn vs without: max_abs_diff={diff:.6g}")
    check(flash_n == L, "phase 20 (e): a flash launch a layer")
    check(scaled, "phase 20 (e): the flash kernel takes the scaled q")
    check(diff > 0, "phase 20 (e): logn moves the logits past logn_train_len")
    del model, seen_q
    torch.cuda.empty_cache()



# ---------------------------------------------------------------------------
# phase 21: the rest of the llama flags (gemma3, the layer shapes, phixtral)
# ---------------------------------------------------------------------------

# google/gemma-3-27b-it's published config.json, its text_config (the
# vision tower's fields left out)
GEMMA3_27B_HF = {
    "architectures": ["Gemma3ForConditionalGeneration"], "model_type": "gemma3",
    "text_config": {
        "model_type": "gemma3_text", "vocab_size": 262208, "hidden_size": 5376,
        "intermediate_size": 21504, "num_hidden_layers": 62, "num_attention_heads": 32,
        "num_key_value_heads": 16, "head_dim": 128, "query_pre_attn_scalar": 168,
        "sliding_window": 1024, "sliding_window_pattern": 6, "rope_theta": 1000000.0,
        "rope_scaling": {"rope_type": "linear", "factor": 8.0},
        "rope_local_base_freq": 10000.0, "rms_norm_eps": 1e-06,
        "max_position_embeddings": 131072, "hidden_activation": "gelu_pytorch_tanh",
        "final_logit_softcapping": None, "attn_logit_softcapping": None,
        "torch_dtype": "bfloat16"},
}
# (a) and (b): 12 of gemma-3-27b's 62 layers (2 cycles of 5 local layers
# and 1 global), full width: at 62 the whole run read ~965 s on one H100
# host, at 48 ~1245 s on a slower one (PERF.md)
GEMMA3_LAYERS = 12
GEMMA3_LONG = 1500  # (a)'s 2-layer check: past the 1,024 window
# the published config.json values of each layer shape (the port's
# translation of it, cut to FLAGS_LAYERS layers after the translation, so
# that MiniCPM's residual scale keeps its 40 layers' 1.4 / sqrt(40))
LAYER_SHAPES_HF = {
    "phi-2": {"model_type": "phi", "vocab_size": 51200, "hidden_size": 2560,
              "intermediate_size": 10240, "num_hidden_layers": 32, "num_attention_heads": 32,
              "num_key_value_heads": 32, "partial_rotary_factor": 0.4, "layer_norm_eps": 1e-05,
              "hidden_act": "gelu_new", "max_position_embeddings": 2048, "rope_theta": 10000.0,
              "qk_layernorm": False, "tie_word_embeddings": False},
    "phixtral-4x2_8": {"model_type": "phi-msft", "vocab_size": 51200, "n_embd": 2560, "n_head": 32,
                       "n_layer": 32, "n_inner": None, "n_positions": 2048, "rotary_dim": 32,
                       "num_local_experts": 4, "num_experts_per_tok": 2,
                       "activation_function": "gelu_new", "layer_norm_epsilon": 1e-05,
                       "tie_word_embeddings": False},
    "starcoder2-15b": {"model_type": "starcoder2", "vocab_size": 49152, "hidden_size": 6144,
                       "intermediate_size": 24576, "num_hidden_layers": 40,
                       "num_attention_heads": 48, "num_key_value_heads": 4, "sliding_window": 4096,
                       "rope_theta": 100000, "max_position_embeddings": 16384, "use_bias": True,
                       "norm_epsilon": 1e-05, "hidden_act": "gelu_pytorch_tanh"},
    "c4ai-command-r-v01": {"model_type": "cohere", "vocab_size": 256000, "hidden_size": 8192,
                           "intermediate_size": 22528, "num_hidden_layers": 40,
                           "num_attention_heads": 64, "num_key_value_heads": 64,
                           "layer_norm_eps": 1e-05, "logit_scale": 0.0625, "rope_theta": 8000000.0,
                           "max_position_embeddings": 8192, "use_qk_norm": False,
                           "tie_word_embeddings": True, "hidden_act": "silu"},
    "gpt2-xl": {"model_type": "gpt2", "vocab_size": 50257, "n_embd": 1600, "n_layer": 48,
                "n_head": 25, "n_positions": 1024, "activation_function": "gelu_new",
                "layer_norm_epsilon": 1e-05},
    "bloom-7b1": {"model_type": "bloom", "vocab_size": 250880, "hidden_size": 4096, "n_layer": 30,
                  "n_head": 32, "layer_norm_epsilon": 1e-05},
    "MiniCPM-2B": {"model_type": "minicpm", "vocab_size": 122753, "hidden_size": 2304,
                   "intermediate_size": 5760, "num_hidden_layers": 40, "num_attention_heads": 36,
                   "num_key_value_heads": 36, "rms_norm_eps": 1e-05, "rope_theta": 10000.0,
                   "max_position_embeddings": 4096, "scale_emb": 12, "scale_depth": 1.4,
                   "dim_model_base": 256, "tie_word_embeddings": True, "hidden_act": "silu"},
}
SHAPES_DECODE = 2  # (c): greedy decode steps after each prefill
SHAPES_SERVE_REQS = 4  # (b), (c): 4 prefix-sharing and 4 independent requests of phase 7


def layer_shape_configs():
    """Phase 21's configurations: gemma-3-27b at GEMMA3_LAYERS of its 62
    layers, and each layer shape at FLAGS_LAYERS layers of its width."""
    from bigdl_tpu_torch import ModelConfig

    out = {"gemma3": dataclasses.replace(ModelConfig.from_hf_config(GEMMA3_27B_HF),
                                         num_hidden_layers=GEMMA3_LAYERS)}
    out.update({name: dataclasses.replace(ModelConfig.from_hf_config(hf),
                                          num_hidden_layers=FLAGS_LAYERS)
                for name, hf in LAYER_SHAPES_HF.items()})
    return out


def layer_shape_phases(torch, dev, card, configs=None, long_prompt=GEMMA3_LONG,
                       hf=GEMMA3_27B_HF) -> None:
    """Phase 21: (a) gemma-3-27b at full width through `generate`
    (launches, tokens, times, peak memory; 2 layers against the plain
    versions past the window); (b) the paged engine on it (each layer's
    window and scale on the paged kernel, its tokens as `generate`'s by
    the margin rule); (c) each layer shape at 2 layers against the plain
    versions, and phi-2's paged engine at head_dim 80; (d) gemma3's HF
    ingest under a multimodal checkpoint's names. `configs` replaces
    `layer_shape_configs()` and `hf` the checkpoint's config (a CPU
    rehearsal at narrow widths)."""
    import shutil
    import tempfile

    import numpy as np

    from bigdl_tpu_torch import AutoModelForCausalLM, TorchModel, optimize_model
    from bigdl_tpu_torch.convert import hf as hf_mod
    from bigdl_tpu_torch.convert import params_from_numpy
    from bigdl_tpu_torch.generate import pad_prompts
    from bigdl_tpu_torch.kvcache import init_cache
    from bigdl_tpu_torch.models import llama
    from bigdl_tpu_torch.ops import kernels
    from bigdl_tpu_torch.ops.kernels.paged_attention import split_chunk
    from bigdl_tpu_torch.ops.kernels.qtile import gemv_tile
    from bigdl_tpu_torch.quant import ARRAY_FIELDS

    configs = configs or layer_shape_configs()
    plain = plain_kernels(kernels)
    t_phase = time.time()

    def build(cfg, seed):
        """`init_params(low_bit=)` (each layer quantized as it is made), a
        (1 + w) model's norms at the unit scale, then fused."""
        model = llama.init_params(cfg, seed=seed, device=dev, low_bit="sym_int4")
        if cfg.rms_norm_offset:
            unit_norms(torch, model)
        return optimize_model(model, cfg)

    def vs_plain(label, cfg, model, toks, start, n_decode=SHAPES_DECODE):
        return logits_vs_plain(torch, dev, 21, label, cfg, model, toks, start, n_decode,
                               margin=True)

    def serve(tm, specs, record=None):
        return serve_paged(torch, 21, tm, specs, logprobs_top_k=2, record=record)

    def margin_rule(label, reqs, other):
        """Each request's tokens as `other`'s ([tokens] a request), or a
        first difference where the request's own top-1/top-2 logprob
        margin is within MARGIN_TOL."""
        ties = []
        for i, (r, o) in enumerate(zip(reqs, other)):
            d = next((j for j, (x, y) in enumerate(zip(r.out_tokens, o)) if x != int(y)), None)
            if d is not None:
                top = sorted(r.out_top_logprobs[d].values(), reverse=True)
                ties.append((i, d, round(top[0] - top[1], 4)))
        log(f"phase 21 {label}: requests differing (request, first token, margin) {ties}, "
            f"tol {MARGIN_TOL}")
        check(all(m <= MARGIN_TOL for _, _, m in ties), f"phase 21 {label}: the margin rule")

    def paged_vs_plain(label, cfg, seed, windows=(None,)):
        """The paged kernel (bf16 and fp8 pages) against its plain version
        at the model's heads, head_dim and attention scale, at the engine's
        decode shape (8 rows of up to 2,048 slots), with each of `windows`:
        each element within 2^-7 |ref| + 1e-5, relaunched bit-equal."""
        Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
        scale = cfg.attn_scale
        g = torch.Generator(device=dev).manual_seed(seed)
        pos = (2047, 1100, 64, 0, 1500, 5, 700, 1999)
        for fp8 in (False, True):
            kern = kernels.PAGED_FP8 if fp8 else kernels.PAGED
            k, v, ks, vs, bt, p, _, _ = paged_operands(torch, dev, g, 2, Hkv, D, pos, fp8)
            st_ = torch.zeros(len(pos), dtype=torch.int32, device=dev)
            qv = torch.randn((len(pos), Hq, D), device=dev, generator=g).bfloat16()
            for window in windows:
                kw = dict(scale=scale, window=window)
                before = kern.launches
                y = kernels.paged_attention(qv, k, v, bt, 1, p, st_, ks, vs, **kw)
                same = torch.equal(y, kernels.paged_attention(qv, k, v, bt, 1, p, st_, ks, vs, **kw))
                launched = kern.launches - before
                y = y.float()
                ref = kernels.paged_attention_plain(qv, k, v, bt, 1, p, st_, ks, vs, **kw).float()
                err = (y - ref).abs().max().item()
                within = bool(((y - ref).abs() <= 2 ** -7 * ref.abs() + 1e-5).all())
                log(f"phase 21 {label}: {kern.name} B={len(pos)} Hq={Hq} Hkv={Hkv} D={D} "
                    f"scale={'D^-0.5' if scale is None else f'{scale:.6g}'} window={window} pos={pos} "
                    f"chunk={split_chunk(len(pos), Hkv, MAX_LEN)} max_abs_err={err:.6g} "
                    f"tol=2^-7*|ref|+1e-5 per element; launches {launched}; relaunch bit-equal "
                    f"{same}")
                check(launched == 2 and bool(torch.isfinite(y).all()) and within and same,
                      f"phase 21 {label}: {kern.name} at D={D} window={window}")

    def phi_engine(cfg, model, seed):
        """phi-2's head_dim 80: the paged kernel's D = 80 instantiation
        against its plain version, then phase 7's 8 requests of NEW_TOKENS
        through the paged engine on the kernels and on the plain versions:
        paged launches = layers x decode steps, the kernels' tokens as the
        plain engine's by the margin rule."""
        D = cfg.head_dim_
        paged_vs_plain("(c) phi-2", cfg, seed)
        shared_, indep_ = serving_traffic(cfg.vocab_size)
        specs_ = [dict(prompt=sp["prompt"], max_new_tokens=NEW_TOKENS)
                  for sp in shared_[:SHAPES_SERVE_REQS] + indep_[:SHAPES_SERVE_REQS]]
        tm_ = TorchModel(cfg, model, "sym_int4", device=dev)
        kernels.reset_launches()
        kreqs, sec_, steps_, seen_ = serve(tm_, specs_)
        paged_ = kernels.PAGED.launches
        log(f"phase 21 (c) phi-2: engine paged bf16 (head_dim {D}), "
            f"{serve_text(kreqs, sec_, steps_, seen_)}; paged launches {paged_}")
        check(paged_ == cfg.num_hidden_layers * steps_ and steps_ > 0,
              "phase 21 (c) phi-2: paged launches = layers x decode steps")
        with mock.patch.multiple(kernels, **plain):
            preqs = serve(tm_, specs_)[0]
        margin_rule("(c) phi-2's engine, kernels against the plain versions", preqs,
                    [r.out_tokens for r in kreqs])

    # (a) gemma-3-27b through generate --------------------------------------
    cfg = configs["gemma3"]
    L, V, H = cfg.num_hidden_layers, cfg.vocab_size, cfg.hidden_size
    per_layer = H * (cfg.q_dim + cfg.kv_dim) * 2 + 3 * cfg.intermediate_size * H
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    model = build(cfg, 60)
    tm = TorchModel(cfg, model, "sym_int4", device=dev)
    torch.cuda.synchronize()
    build_s = time.time() - t
    model_gib = torch.cuda.memory_allocated() / 2**30 - base_gib
    build_peak = torch.cuda.max_memory_allocated() / 2**30 - base_gib
    log(f"phase 21 (a): card {card}")
    log(f"phase 21 (a): gemma-3-27b {L} of 62 layers (hidden {H}, {cfg.num_attention_heads} q heads "
        f"over {cfg.num_key_value_heads}, head_dim {cfg.head_dim_}, scale {cfg.attn_scale:.6g}, "
        f"window {cfg.sliding_window} on {sum(cfg.layer_is_sliding(i) for i in range(L))} layers, "
        f"rope {cfg.rope_theta:g} x{cfg.rope_scaling_dict['factor']:g} global, "
        f"{cfg.rope_local_theta:g} local; {per_layer * L / 1e9:.3f} G layer weights, vocab {V} tied) "
        f"sym_int4 built layer by layer in {build_s:.1f} s: {model_gib:.3f} GiB on the card, peak "
        f"during the build {build_peak:.3f} GiB; routes: prefill "
        f"{routes_text(llama, cfg, 'dense', 'prefill', 2)}; paged decode "
        f"{routes_text(llama, cfg, 'paged', 'decode', 1, True)}")
    prompts = [[x % V for x in p_] for p_ in ragged_prompts(V)]
    kernels.reset_launches()
    out1 = tm.generate(prompts, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    want = {k.name: 0 for k in kernels.KERNELS}
    want.update({kernels.GEMM.name: 4 * L, kernels.GEMV.name: (NEW_TOKENS - 1) * 4 * L})
    log(f"phase 21 (a): launches {launches} expected {want} (no lm head launch: the tied head "
        "is the dense embedding; no flash launch: windows that are not uniform, JAX's rule)")
    check(launches == want, "phase 21 (a): gemma3 launch counts")
    check(out1.shape == (len(prompts), NEW_TOKENS) and bool(((out1 >= 0) & (out1 < V)).all()),
          "phase 21 (a): tokens in the vocabulary")
    torch.cuda.reset_peak_memory_stats()
    out2 = tm.generate(prompts, max_new_tokens=NEW_TOKENS)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(bool((out1 == out2).all()), "phase 21 (a): identical tokens on a second call")
    prefill_ms = sorted(wall_ms(torch, lambda: tm.generate(prompts, 1)) for _ in range(3))
    tokens, st = pad_prompts(prompts, 0)
    tok = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    stt = torch.as_tensor(st, device=dev)
    Hkv, D = cfg.num_key_value_heads, cfg.head_dim_
    n_steps = 8

    def new_cache():
        return dataclasses.replace(init_cache(L, len(prompts), tokens.shape[1] + 2 * n_steps + 16,
                                              Hkv, D, device=dev), start=stt)

    with torch.inference_mode():
        prof_pre = profiled_steps(torch, lambda: llama.forward(
            cfg, tm.params, tok, new_cache(), "prefill", last_logits_only=True), 1, {
                kernels.GEMM.name: (GEMM_EVENT, 2 * 4 * L),
                kernels.FLASH.name: (re.compile(r"namespace\)::flash_kernel"), 0)},
            "phase 21 (a) prefill")
        logits, cache = llama.forward(cfg, tm.params, tok, new_cache(), "prefill",
                                      last_logits_only=True)
        box = [cache, logits[:, -1].argmax(-1)]

        def step():
            lg, box[0] = llama.forward(cfg, tm.params, box[1][:, None], box[0], "decode")
            box[1] = lg[:, -1].argmax(-1)

        step_ms = [wall_ms(torch, step) for _ in range(n_steps)]
        prof = profiled_steps(torch, step, 3, {kernels.GEMV.name: (
            re.compile(r"namespace\)::gemv_kernel"), 4 * L * 3)}, "phase 21 (a) decode")
    del cache, logits, box
    # the windows' device kernels, read once (key_averages is slow on a
    # window over many layers)
    pre_k, dec_k = device_kernels(prof_pre), device_kernels(prof)
    gemm_n = sum(e.count for e in pre_k if GEMM_EVENT.search(e.key))
    gemv_n = sum(e.count for e in dec_k if re.search(r"namespace\)::gemv_kernel", e.key))
    flash_n = sum(e.count for e in pre_k if "flash_kernel" in e.key)
    pre_busy = sum(e.self_device_time_total for e in pre_k) / 1e3
    busy = sum(e.self_device_time_total for e in dec_k) / 1e3 / 3 or math.nan
    med = quantile(step_ms, 0.5)
    log(f"phase 21 (a): profiled windows: a prefill's GEMM device kernels {gemm_n} (x_order + "
        f"gemm, 2 x 4 x {L}), flash {flash_n}; 3 decode steps' GEMV kernels {gemv_n} (4 x {L} a "
        "step)")
    check(gemm_n == 2 * 4 * L and flash_n == 0 and gemv_n == 4 * L * 3,
          "phase 21 (a): profiled launch counts")
    log(f"phase 21 (a): gemma-3-27b {L} layers sym_int4 B={len(prompts)} prompt bucket "
        f"{tokens.shape[1]}: prefill_ms (generate of 1 token) median={prefill_ms[1]:.3f} "
        f"min={prefill_ms[0]:.3f} max={prefill_ms[-1]:.3f} (n=3), profiled prefill device busy "
        f"{pre_busy:.3f} ms; decode step ms (host-set) median={med:.3f} max={max(step_ms):.3f} "
        f"(n={n_steps}); profiled decode: device busy {busy:.3f} ms per step = {busy / med:.3f} of "
        f"the median step; peak_mem_gib={peak_gib:.3f}")
    for e in dec_k[:5]:
        log(f"  {e.self_device_time_total / 1e3 / 3:8.3f} ms/step {e.count // 3:5d} calls/step  "
            f"{e.key[:90]}")
    # the GEMV and the GEMM at the decode step's 4 rows and a paged
    # prefill's 30-row tail (past what the GEMV's shared memory holds at
    # w_down's K) on layer 0's own weights, against plain
    g = torch.Generator(device=dev).manual_seed(65)
    for name_, M in (("w_gateup", 4), ("w_down", 4), ("w_down", 30)):
        w = tm.params.layers[0].proj[name_].w
        O_, K_ = w.shape
        x = torch.randn((M, K_), device=dev, generator=g).bfloat16()
        kern = kernels.GEMV if gemv_tile(M, O_, K_, w.qtype) else kernels.GEMM
        before = kern.launches
        y = kernels.qmatmul(x, w)
        launched = kern.launches - before
        same = torch.equal(y, kernels.qmatmul(x, w))
        ref = kernels.qmatmul_plain(x, w).float()
        err = (y.float() - ref).abs().max().item()
        # f32 sums in another order, then one bf16 rounding on each side:
        # within 2 bf16 ULPs of the largest output (phase 2's bound)
        tol = ref.abs().max().item() * 2 ** -7
        log(f"phase 21 (a): {kern.name} {name_} M={M} O={O_} K={K_} max_abs_err={err:.6g} "
            f"tol={tol:.6g}; launches {launched}; relaunch bit-equal {same}")
        check(launched == 1 and bool(torch.isfinite(y).all()) and err <= tol and same
              and (kern is kernels.GEMV) == (M == 4),
              f"phase 21 (a): {kern.name} {name_} M={M} against plain")
    log(f"phase 21 (a): {time.time() - t_phase:.1f} s into the phase")
    # 2 layers, one local (layer 0) and one global (layer 1: HF's
    # layer_types form), a prompt past the window: both tables and the
    # window bite
    cfg2 = dataclasses.replace(cfg, num_hidden_layers=FLAGS_LAYERS, sliding_layers=(True, False))
    m2 = build(cfg2, 61)
    ltok = torch.as_tensor(np.random.default_rng(62).integers(1, V, (1, long_prompt)),
                           dtype=torch.long, device=dev)
    vs_plain(f"(a) 2 layers (local, global), a {long_prompt}-token prompt", cfg2, m2, ltok,
             torch.zeros(1, dtype=torch.int32, device=dev))
    del m2
    log(f"phase 21 (a): {time.time() - t_phase:.1f} s into the phase")

    # (b) the paged engine on gemma-3-27b --------------------------------
    paged_vs_plain("(b) gemma-3-27b", cfg, 64, windows=(cfg.sliding_window, None))
    shared, indep = serving_traffic(V)
    specs = [dict(prompt=sp["prompt"], max_new_tokens=NEW_TOKENS)
             for sp in shared[:SHAPES_SERVE_REQS] + indep[:SHAPES_SERVE_REQS]]
    calls = []
    kernels.reset_launches()
    reqs, sec, steps, seen = serve(tm, specs, record=calls)
    paged_n = kernels.launch_counts()[kernels.PAGED.name]
    want_calls = {(layer, cfg.sliding_window if cfg.layer_is_sliding(layer) else None,
                   cfg.attn_scale) for layer in range(L)}
    log(f"phase 21 (b): gemma-3-27b engine paged bf16, {serve_text(reqs, sec, steps, seen)}; "
        f"paged launches {paged_n} ({L} a decode step); (layer, window, scale) passed "
        f"{sorted(set(calls))[:6]}...")
    check(paged_n == L * steps == len(calls) and steps > 0,
          f"phase 21 (b): {L} paged launches a decode step")
    check(set(calls) == want_calls, "phase 21 (b): each layer's window and the scale on the "
                                    "paged kernel")
    again = serve(tm, specs)[0]
    check(all(a.out_tokens == b.out_tokens for a, b in zip(reqs, again)),
          "phase 21 (b): identical tokens on a second run")
    gen = tm.generate([sp["prompt"] for sp in specs], max_new_tokens=NEW_TOKENS)
    margin_rule("(b) the engine against generate", reqs, gen.tolist())
    del reqs, again, tm, model, gen
    torch.cuda.empty_cache()
    log(f"phase 21 (b): {time.time() - t_phase:.1f} s into the phase")

    # (c) the layer shapes at 2 layers ----------------------------------------
    for seed, name in enumerate((n for n in configs if n != "gemma3"), 70):
        cfg = configs[name]
        V = cfg.vocab_size
        t = time.time()
        model = build(cfg, seed)
        torch.cuda.synchronize()
        long = cfg.sliding_window is not None  # starcoder2: a prompt past its window
        if long:
            toks = torch.as_tensor(np.random.default_rng(seed).integers(
                1, V, (1, LONG_PROMPT)), dtype=torch.long, device=dev)
            start = torch.zeros(1, dtype=torch.int32, device=dev)
        else:
            toks, start = torch.remainder(tok, V), stt
        route = llama.attention_route(cfg, 0, "dense", "prefill", toks.shape[1])
        kernels.reset_launches()
        vs_plain(f"(c) {name} ({cfg.model_type}: D={cfg.head_dim_}, rotary {cfg.rotary_dim}"
                 f"{' interleaved' if cfg.rope_interleaved else ''}, built in "
                 f"{time.time() - t:.1f} s) prompt {tuple(toks.shape)} + {SHAPES_DECODE} decode steps",
                 cfg, model, toks, start)
        launches = kernels.launch_counts()
        flash_want = FLAGS_LAYERS if route.kernel == "flash" else 0
        log(f"phase 21 (c) {name}: launches {launches}; flash expected {flash_want} (prefill "
            f"route {route.kernel}, window {route.window})")
        check(launches[kernels.FLASH.name] == flash_want, f"phase 21 (c) {name}: flash launches")
        if name == "phi-2":
            phi_engine(cfg, model, seed)
        del model
        torch.cuda.empty_cache()
    log(f"phase 21 (c): {time.time() - t_phase:.1f} s into the phase")

    # (d) gemma3's HF ingest under a multimodal checkpoint's names ---------
    tmp = Path(tempfile.gettempdir())
    root = Path(tempfile.mkdtemp(prefix="bigdl_hf_gemma3_", dir=tmp))
    try:
        hf2 = dict(hf, text_config=dict(hf["text_config"], num_hidden_layers=FLAGS_LAYERS))
        t0 = time.time()
        total = write_hf_checkpoint(torch, root, hf2, 63, dev, prefix="language_model.")
        torch.cuda.synchronize()
        t1 = time.time()
        m = AutoModelForCausalLM.from_pretrained(str(root), load_in_low_bit="sym_int4", device=dev)
        torch.cuda.synchronize()
        ingest_s = time.time() - t1
        get = hf_mod.open_checkpoint(str(root))
        Lf = m.config.num_hidden_layers
        per = [hf_mod.layer_tensors(m.config, i, get) for i in range(Lf)]
        arrays = {f"layers.{k}": torch.stack([d[k] for d in per]) for k in per[0]}
        arrays.update(hf_mod.top_tensors(m.config, get))
        ref = optimize_model(params_from_numpy(arrays, {}, m.config, device=dev), m.config,
                             "sym_int4")
        del per, arrays
        diff = 0
        for a, b in [(a.proj[k], b.proj[k]) for a, b in zip(m.params.layers, ref.layers)
                     for k in a.proj]:
            for f in ARRAY_FIELDS + ("bias",):
                x, y = getattr(a, f, None), getattr(b, f, None)
                if (x is None) != (y is None):
                    diff += 1
                elif x is not None:
                    diff += int((x.detach().reshape(-1).view(torch.uint8)
                                 != y.detach().reshape(-1).view(torch.uint8)).sum())
        dense_same = all(torch.equal(getattr(a, n_), getattr(b, n_))
                         for a, b in zip(m.params.layers, ref.layers)
                         for n_ in ("attn_norm", "mlp_norm") + llama.OPTIONAL_NORMS
                         if getattr(a, n_) is not None) and torch.equal(m.params.embed, ref.embed)
        names = json.loads((root / "model.safetensors.index.json").read_text())["weight_map"]
        prefix = next(n for n in names if ".layers." in n).split("layers.")[0]
        log(f"phase 21 (d): gemma3 {Lf}-layer HF checkpoint at gemma-3-27b's width under "
            f"{prefix!r} names, {total / 1e9:.3f} GB written in {t1 - t0:.3f} s, "
            f"ingested in sym_int4 in {ingest_s:.3f} s; config {m.config.model_type}, sliding "
            f"{[m.config.layer_is_sliding(i) for i in range(Lf)]}, local rope "
            f"{m.config.rope_local_theta:g}; bytes differing from params_from_numpy + optimize_model "
            f"over the same tensors: {diff}; dense leaves equal {dense_same}")
        check(m.config.rope_local_theta == 1e4 and m.config.qk_norm,
              "phase 21 (d): the config's local rope and q/k norms")
        check(diff == 0 and dense_same, "phase 21 (d): the ingest's bytes")
        del m, ref
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"phase 21: {time.time() - t_phase:.1f} s")


if __name__ == "__main__":
    sys.exit(main())
