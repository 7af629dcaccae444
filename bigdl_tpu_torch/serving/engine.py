"""Slot-based continuous-batching inference engine (port of
bigdl_tpu/serving/engine.py).

- a fixed pool of `n_slots` decode slots shares one KV pool with per-row
  write positions: a dense `kvcache.KVCache` [L, slots, max_len, ...], or
  with `paged=True` a `kvpaged.PagedKVCache` whose pages are allocated on
  demand, refcounted, shared between prompts through the radix prefix
  cache (`serving/radix.py`, full pages and a sub-page copy) and swapped
  to host RAM when decode growth runs the pool dry (preemption);
- a request joins mid-flight: the dense pool prefills it on a 1-row cache
  (the flash kernel) and copies that row in; the paged pool prefills its
  uncached tail straight into its pages;
- one `step()` admits what fits and advances every active slot one token
  (a paged decode reads its pages in place through the paged-attention
  kernel); idle slots compute masked garbage into scratch (page 0, or
  their own dense row);
- sampling parameters, the repetition penalty and the EOS id are per
  request; `quantize_kv` stores either pool as float8_e5m2 with scales;
- with `adapters=` (a `serving.adapters.AdapterRegistry`) a request may
  name a LoRA adapter: its prefill carries the adapter's own tree, and a
  decode step one batched tree over every slot (zero rows and a 0 scale
  for base rows; rank padded to the batch's bucket), which the wo and
  w_down projections fold into the LoRA GEMV. A step with no adapter row
  runs the base path unchanged. Prefix pages are cached per adapter
  namespace, and over a paged pool the adapters' weights page into the
  same `PagePool` as KV (`AdapterPager`), paged out before any request is
  preempted;
- with `speculative=True` a step is a speculative round: a draft model
  (the target's sym_int4 self-draft unless `draft_params` is given) runs
  K greedy decode steps over a second, always dense, pool; one target
  forward over [cur, d0..d_{K-2}] verifies every slot (with the slots'
  adapters); greedy rows accept the drafts that match the target's
  argmax, sampled rows by rejection sampling (`decode.rejection_accept`),
  penalty rows accept none; both pools roll back per row to pos + n_acc
  + 1. The pools keep a physical reserve of draft_k - 1 slots past
  max_len, so a verify of a request whose window ends flush with max_len
  has room for every write. `adaptive_draft` steers K along a ladder
  (draft_k, halved down to 2) from the acceptance rate;
- with `prefill_chunk_tokens` (paged only) a prompt's uncached tail
  prefills in chunks, at most one chunk a step: the slot is held but not
  decoded until its last chunk lands, so a long prompt stalls the running
  batch by one chunk, not one prompt. A decoding slot that needs pages
  takes them from a chunk plan first (the plan restarts later);
- overload control: `max_queue` sheds submits over the bound
  ("queue_full"), `queue_deadline_s` sheds requests that waited too long
  ("queue_deadline"), `deadline_s` finishes a request past its budget
  "timeout" with its partial output; `begin_drain`/`drain` shed new
  submits ("draining") while accepted work finishes;
- `journal=` appends every accepted request to a crash-recovery journal
  (`serving/journal.py`, the JAX package's file format) and tombstones
  its finish; an engine attached to a journal replays the unfinished
  tail first (`recovered_requests`), and `close()` compacts it;
- `faults=` (`serving/faults.py`) fires the JAX engine's injection
  points: `alloc_page`, `slow_step`, `nan_logits`, `crash_before_done`
  and the adapter pager's page-in stall;
- `tracer=` (`obs/tracing.TraceRecorder`) records each request's
  lifecycle (submit, queued, prefill, decode windows of
  `trace_decode_every` tokens, swap-out and preempted, finish) and the
  engine's decode steps; `request_log=` writes one derived-timings
  record per finished request. Every timestamp, deadline and histogram
  reads the one `clock` (default `time.time`, wall-clock stamps as the
  JAX engine's).

What changes from JAX: the pools are written in place where JAX donates
buffers; `jax.random` keys become one `torch.Generator`; the all-default
penalty and all-greedy sampling guards are host `if`s on the host-side
per-slot arrays, so they cost no device sync; the paged prefill runs only
the prompt's real tokens (JAX right-pads them to a bucket for a static
shape — the page plan still uses that bucket, so the same admissions get
the same physical pages, and the pad writes JAX makes land past `pos`,
where nothing reads them; a chunk runs its n real tokens, where JAX pads
it to a 16-token bucket). The block table goes to the card only when it
changed. A speculative round brings its acceptance counts to the host
with its tokens, as the plain step does its tokens.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import queue
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from bigdl_tpu_torch import kvcache, kvpaged
from bigdl_tpu_torch.decode.speculative import rejection_accept
from bigdl_tpu_torch.generate import (GenerationConfig, apply_repetition_penalty,
                                      filter_logits_per_row, sample_token_per_row,
                                      seen_from_prompt)
from bigdl_tpu_torch.models import llama
from bigdl_tpu_torch.serving.adapters import AdapterError, AdapterPager, rank_bucket
from bigdl_tpu_torch.serving.faults import NULL_INJECTOR, FaultError
from bigdl_tpu_torch.serving.metrics import FAST_BUCKETS, Histogram
from bigdl_tpu_torch.serving.radix import RadixPrefixCache
from bigdl_tpu_torch.train.qlora import _target_dims
from bigdl_tpu_torch.utils import round_up

@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 64
    # per-request sampling (None = the engine's default)
    do_sample: Optional[bool] = None
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    repetition_penalty: Optional[float] = None
    eos_token_id: Optional[int] = None
    # the LoRA adapter this request decodes with (None = the shared base)
    adapter: Optional[str] = None
    # filled by the engine
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    # chosen-token logprob per emitted token (log softmax of the model's
    # pre-filtering distribution, after the repetition penalty)
    out_logprobs: list[float] = dataclasses.field(default_factory=list)
    # with logprobs_top_k=N: per emitted token, the N most likely
    # {token_id: logprob} alternatives
    out_top_logprobs: list[dict] = dataclasses.field(default_factory=list)
    done: bool = False
    finish_reason: str = ""  # "stop" (EOS or cancel) | "length" (budget) |
    # "invalid" (rejected at submit) | "error" | "shed" (queue bound, queue
    # deadline or drain: retryable) | "timeout" (deadline_s expired)
    error: Optional[str] = None
    # which admission limit shed the request ("queue_full" |
    # "queue_deadline" | "draining"), for a caller's retry choice
    shed_kind: Optional[str] = None
    stream: Optional[queue.SimpleQueue] = None  # receives (token | None=end)
    # overload controls (None = the engine's default): the longest wait for
    # a slot, and the whole budget from submit
    queue_deadline_s: Optional[float] = None
    deadline_s: Optional[float] = None
    submit_ts: float = 0.0
    admit_ts: Optional[float] = None  # first admission (before prefill)
    preemptions: int = 0  # times swapped to host RAM
    first_token_ts: Optional[float] = None
    last_token_ts: Optional[float] = None
    preempt_ts: Optional[float] = None  # set while parked in host RAM
    preempted_s: float = 0.0  # total seconds parked


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    remaining: int = 0
    eos: Optional[int] = None  # resolved per-request EOS id
    seq: int = 0  # admission order — the preemption victim policy's age
    # pos at the last swap-in; -1 = never preempted. A slot that cannot
    # extend AND has emitted nothing since its resume proves the pool
    # cannot support it (self-preempting again would livelock).
    resumed_pos: int = -1
    # the decode-window trace span: tokens since the last "decode" span
    # and the window's start
    t_win: float = 0.0
    n_win: int = 0


@dataclasses.dataclass
class _Preempted:
    """A request parked in host RAM: the KV blob plus the slot-side
    sampling and progress state, everything to resume bit-exactly."""

    req: Request
    cur: int  # last emitted token (next decode input)
    remaining: int
    eos: Optional[int]
    pos: int  # tokens written (prompt + emitted)
    start: int  # dense left-pad offset (0 for paged)
    seq: int  # original admission age
    temp: float
    topk: int
    topp: float
    dosample: bool
    penalty: float
    seen: Any  # [V] bool row (repetition-penalty state), on the CPU
    blob: Any  # kvpaged.HostKVPages | dense (k, v, ks, vs) tuple
    n_pages: int = 0  # paged: pages to reallocate on resume


@dataclasses.dataclass
class _PrefillState:
    """A request mid-chunked-prefill: it holds its slot and its whole page
    table, but stays inactive (no decode) and the engine's block-table row
    stays on the scratch page until the last chunk lands, so the idle
    slot's garbage decode writes never reach its half-filled (possibly
    shared) pages. Chunks write through `row`."""

    req: Request
    slot: int
    row: np.ndarray  # the slot's real block-table row
    written: int  # prompt tokens whose KV is in the pool (hits, copy included)
    path: list  # the matched radix nodes, for the last chunk's registration
    chunk: int  # tokens a chunk


class InferenceEngine:
    """model: a TorchModel (api.py) of the llama family. Sampling
    parameters, the repetition penalty and EOS are per request; the
    engine's GenerationConfig gives the defaults. Thread-safe entry
    points: `submit`, `cancel`, `preempt`, `begin_drain`; everything else
    runs on the thread that calls `step()`."""

    # cache-aware admission: oldest entries scored per pop
    _ADMIT_SCAN_WINDOW = 64

    def __init__(self, model, n_slots: int = 8, max_len: int = 1024,
                 gen: Optional[GenerationConfig] = None, seed: int = 0,
                 paged: bool = False, page_size: int = 64,
                 n_pages: Optional[int] = None, speculative: bool = False,
                 draft_params=None, draft_k: int = 4, adaptive_draft: bool = False,
                 truncate_prompts: bool = False, logprobs_top_k: int = 0,
                 quantize_kv: bool = False, prefill_chunk_tokens: Optional[int] = None,
                 journal: Optional[str] = None, max_queue: Optional[int] = None,
                 queue_deadline_s: Optional[float] = None,
                 deadline_s: Optional[float] = None, preemption: bool = True,
                 preemption_policy: str = "youngest", faults=None, adapters=None,
                 tracer=None, request_log: Optional[str] = None,
                 trace_decode_every: int = 8, clock: Callable[[], float] = time.time):
        # the clock and the observability sinks first: submit() and the
        # journal's replay at the end of __init__ stamp times and record
        # finishes
        self._clock = clock
        self.tracer = tracer
        self.trace_decode_every = max(int(trace_decode_every), 1)
        self._request_log = None
        if request_log is not None:
            from bigdl_tpu_torch.obs.tracing import RequestLog

            self._request_log = RequestLog(request_log)
        self._t_start = clock()
        self._journal = None  # attached at the end of __init__
        self.recovered_requests: list[Request] = []
        # JAX's refusals, before any pool is allocated
        if logprobs_top_k and speculative:
            raise NotImplementedError(
                "logprobs_top_k is not wired through the speculative verify round "
                "yet; use speculative=False")
        if prefill_chunk_tokens is not None:
            if not paged:
                raise ValueError("prefill_chunk_tokens requires paged=True (chunks "
                                 "write straight into the shared page pool)")
            if prefill_chunk_tokens < 1:
                raise ValueError(f"prefill_chunk_tokens must be >= 1, got "
                                 f"{prefill_chunk_tokens}")
            if speculative:
                # the draft's admission prefill is monolithic: it would break
                # the one-chunk stall bound
                raise NotImplementedError(
                    "prefill_chunk_tokens is not wired through the speculative "
                    "draft admission yet; use speculative=False or monolithic prefill")
        if speculative and draft_k < 2:
            # K-1 drafts are verifiable: K=1 would pay a draft forward whose
            # token can never be accepted
            raise ValueError(f"draft_k must be >= 2, got {draft_k}")
        if adaptive_draft and not speculative:
            raise ValueError("adaptive_draft steers the speculative draft length — pass "
                             "speculative=True to enable it")
        if preemption_policy not in ("youngest", "oldest"):
            raise ValueError(f"preemption_policy must be 'youngest' or "
                             f"'oldest', got {preemption_policy!r}")
        llama.check_supported(model.config)
        self.model = model
        self.config = model.config
        self.device = model.device
        self.n_slots = n_slots
        self.max_len = max_len
        self.gen = gen or GenerationConfig()
        self.paged = paged
        self.quantize_kv = quantize_kv
        self.page_size = page_size
        self.speculative = speculative
        self.adaptive_draft = adaptive_draft
        # the physical reserve past max_len (JAX's): a verify writes K
        # tokens at pos..pos+K-1 before its rollback, so a request whose
        # window ends flush with max_len writes up to K - 1 slots past it;
        # without the reserve a paged row finds no logical page for them
        # and finishes "length" short of its budget, and a dense row drops
        # them
        self._reserve = draft_k - 1 if speculative else 0
        self.max_pages_per_row = -(-(max_len + self._reserve) // page_size)
        # +1: physical page 0 is the scratch sink, so the default pool
        # still covers every slot at full logical length
        self.n_pages = n_pages or n_slots * self.max_pages_per_row + 1
        self.truncate_prompts = truncate_prompts
        self.logprobs_top_k = logprobs_top_k
        self.preemption = preemption
        self.preemption_policy = preemption_policy
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.prefill_chunks = 0  # prefill calls: a chunk each, a monolithic prefill 1
        # the one request mid-chunked-prefill, if any (engine thread only)
        self._prefilling: Optional[_PrefillState] = None
        self.max_queue = max_queue
        self.queue_deadline_s = queue_deadline_s
        self.deadline_s = deadline_s
        self._faults = faults if faults is not None else NULL_INJECTOR
        # the drain latch: new submits shed "draining" while accepted work runs
        self._draining = False
        # set while fail_all cleans up: crash points must not fire again
        # inside its _finish calls
        self._cleanup = False
        # makes max_queue's check-then-put exact across handler threads
        self._admission_lock = threading.Lock()
        # one deadline-bearing submit arms the per-step queue sweep
        self._deadlines_seen = queue_deadline_s is not None or deadline_s is not None
        if paged:
            # one hold per slot block-table entry + one per cached radix node
            self._pool = kvpaged.PagePool(self.n_pages)
            self.radix = RadixPrefixCache(page_size, self._pool)
            self._slot_pages: list[list[int]] = [[] for _ in range(n_slots)]
            self._slot_written: list[int] = [0] * n_slots  # logical slots covered
            self.prefix_hits = 0
            self.prefix_partial_hits = 0  # sub-page copies
            self.prefix_tokens_reused = 0
            self.prefix_evictions = 0
            self._bt_host = np.zeros((n_slots, self.max_pages_per_row), np.int32)
            self._bt_dirty = True
            self._slot_pos = [0] * n_slots  # host mirror of cache.pos
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._queue: "queue.Queue[Request]" = queue.Queue()
        self._slots = [_Slot() for _ in range(n_slots)]
        self._rid = itertools.count(1)
        self.cache = self._make_pool()
        self.cur = torch.zeros((n_slots,), dtype=torch.long, device=self.device)
        self.active = np.zeros((n_slots,), bool)  # host-side mask
        g = self.gen
        self._temp = np.full((n_slots,), g.temperature, np.float32)
        self._topk = np.full((n_slots,), g.top_k or 0, np.int32)
        self._topp = np.full((n_slots,), g.top_p if g.top_p is not None else 1.0,
                             np.float32)
        self._dosample = np.full((n_slots,), g.do_sample, bool)
        self._penalty = np.full((n_slots,), 1.0, np.float32)
        # per-slot seen-token masks for the repetition penalty
        self.seen = torch.zeros((n_slots, self.config.vocab_size),
                                dtype=torch.bool, device=self.device)
        self._waiting: Optional[Request] = None  # paged out-of-pages retry
        # rid -> Request whose client went away: freed at the next step
        self._cancelled: dict[int, Request] = {}
        self._stat_lock = threading.Lock()  # counters bumped off the engine thread
        self._inflight = 0  # accepted-but-unfinished requests (under _stat_lock)
        self.finish_reasons: "collections.defaultdict[str, int]" = \
            collections.defaultdict(int)
        # preempted requests parked in host RAM, FIFO: the resume order
        self._preempted: "collections.deque[_Preempted]" = collections.deque()
        self._preempt_requested: set[int] = set()
        self._seq = itertools.count(1)
        self.preemptions = 0
        self.preemption_resumes = 0
        self.requests_completed = 0
        self.requests_shed = 0  # under _stat_lock
        self.request_timeouts = 0  # under _stat_lock
        self.journal_corrupt_lines = 0  # set at the journal's attach
        self.queue_wait = Histogram()
        self.ttft = Histogram()  # submit -> first emitted token
        self.itl = Histogram(buckets=FAST_BUCKETS)  # inter-token gap
        self.prefill_seconds = Histogram(buckets=FAST_BUCKETS)
        self.decode_step_seconds = Histogram(buckets=FAST_BUCKETS)
        self.resume_wait = Histogram()

        # multi-tenant LoRA: rid -> AdapterEntry, one registry reference per
        # in-flight request that resolved an adapter (held across preemption
        # and the paged out-of-pages retry, released at its terminal finish)
        self.adapters = adapters
        self._adapter_refs: dict[int, Any] = {}
        self._slot_adapter: list[Optional[Any]] = [None] * n_slots
        # the decode step's batched tree, rebuilt when a slot's adapter changes
        self._blora: Optional[dict] = None
        self._blora_dirty = True
        # unified paging: adapter leaves in pages of the KV pool
        self._pager = None
        if adapters is not None and paged:
            self._adapter_store = kvpaged.AdapterPageStore(
                self.n_pages, kvpaged.kv_page_nbytes(self.cache), device=self.device)
            self._pager = AdapterPager(self._adapter_store, self._pool, self._alloc_page,
                                       faults=faults)

        # speculative decoding: the draft's own pool, always dense (the
        # draft needs its whole context, and a dense row keeps the per-row
        # rollback a subtraction in both pools); K moves along a ladder
        # under adaptive_draft
        self.dcache = None
        self._draft_params = draft_params
        self.spec_rounds = 0  # verify rounds run
        self.spec_emitted = 0  # tokens those rounds emitted
        if speculative:
            if draft_params is None:
                self._draft_params = model.self_draft_params()
            self.dcache = self._make_pool(force_dense=True)
            ks = {draft_k}
            k = draft_k
            while adaptive_draft and k > 2:
                k = max(2, k // 2)
                ks.add(k)
            self._k_ladder = sorted(ks)
            self._cur_k = draft_k
            self._accept_ema: Optional[float] = None

        # the crash-recovery journal: attaching replays the previous
        # process's unfinished tail, with the rid counter seeded past every
        # journaled rid (a fresh rid's tombstone must never cancel an old
        # pending entry)
        if journal is not None:
            from bigdl_tpu_torch.serving.journal import RequestJournal, replay

            stats: dict = {}
            entries, max_rid = RequestJournal.scan(journal, stats=stats)
            self.journal_corrupt_lines = stats.get("corrupt_lines", 0)
            # compact to the pending tail before the append handle opens;
            # the rid counter seeds from the max before compaction
            RequestJournal.compact(journal, entries=entries)
            self._rid = itertools.count(max_rid + 1)
            self._journal = RequestJournal(journal)
            # replay bypasses max_queue: every entry was accepted once, and a
            # shed here would erase its only record
            bound, self.max_queue = self.max_queue, None
            try:
                self.recovered_requests = replay(self, entries)
            finally:
                self.max_queue = bound

    def _make_pool(self, force_dense: bool = False):
        """The shared KV pool, per-row positions from the start (idle
        rows park at 0), with the speculative reserve past max_len;
        force_dense: the draft pool, dense whatever the target's."""
        cfg = self.config
        L, Hkv, D = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim_
        if self.paged and not force_dense:
            return kvpaged.init_paged(L, self.n_pages, self.page_size, Hkv, D,
                                      self.n_slots, self.max_pages_per_row,
                                      quantize_kv=self.quantize_kv,
                                      device=self.device)
        cache = kvcache.init_cache(L, self.n_slots, self.max_len + self._reserve, Hkv, D,
                                   quantize_kv=self.quantize_kv, device=self.device)
        return dataclasses.replace(cache, pos=torch.zeros(
            (self.n_slots,), dtype=torch.int32, device=self.device))

    # ---- device pieces ----------------------------------------------------

    def _prefill(self, tokens: np.ndarray, pad: int, lora=None, params=None):
        """One request's prefill on its own 1-row, scalar-pos cache (the
        flash kernel; its fp8 arm for an fp8 pool), with the request's
        adapter tree if any, through `params` (default: the target's).
        Returns ([1, V] last logits, the 1-row cache)."""
        cfg = self.config
        cache = kvcache.init_cache(
            cfg.num_hidden_layers, 1, tokens.shape[1], cfg.num_key_value_heads,
            cfg.head_dim_, quantize_kv=self.quantize_kv, device=self.device)
        cache = dataclasses.replace(cache, start=torch.tensor(
            [pad], dtype=torch.int32, device=self.device))
        logits, cache = llama.forward(
            cfg, self.model.params if params is None else params,
            torch.as_tensor(tokens, device=self.device).long(),
            cache, mode="prefill", last_logits_only=True, lora=lora)
        return logits[:, -1], cache

    def _paged_prefill(self, row: np.ndarray, pos0: int, tail: list[int], lora=None):
        """Prefill ONE slot's uncached tail straight into the shared page
        pool through the slot's block-table row (no mini-cache, no insert
        copy), with the request's adapter tree if any; returns the last
        token's [1, V] logits."""
        cache = dataclasses.replace(
            self.cache,
            block_tables=torch.as_tensor(row[None], device=self.device),
            pos=torch.tensor([pos0], dtype=torch.int32, device=self.device),
            start=torch.zeros((1,), dtype=torch.int32, device=self.device))
        logits, _ = llama.forward(
            self.config, self.model.params,
            torch.tensor([tail], dtype=torch.long, device=self.device), cache,
            mode="prefill", last_logits_only=True, lora=lora)
        return logits[:, -1]

    def _decode(self):
        """One token for every slot: (next ids [B], chosen-token logprobs
        [B], top alternatives or None), cache and seen updated in place."""
        logits, self.cache = llama.forward(
            self.config, self.model.params, self.cur[:, None], self.cache,
            mode="decode", lora=self._gather_blora())
        step = logits[:, -1]
        dev = self.device
        # all-default batches skip the [slots, V] rewrite (a host check)
        if np.any(self._penalty != 1.0):
            step = apply_repetition_penalty(
                step, self.seen, torch.as_tensor(self._penalty, device=dev))
        nxt = sample_token_per_row(
            step, self._gen, torch.as_tensor(self._temp, device=dev),
            torch.as_tensor(self._topk, device=dev),
            torch.as_tensor(self._topp, device=dev), self._dosample)
        # chosen-token logprob without a [B, V] log-softmax
        lse = torch.logsumexp(step, dim=-1)
        lp = step.gather(-1, nxt[:, None])[:, 0] - lse
        top = None
        if self.logprobs_top_k:
            tv, ti = torch.topk(step, self.logprobs_top_k, dim=-1)
            top = (ti, tv - lse[:, None])
        self.seen[torch.arange(self.n_slots, device=dev), nxt] = True
        return nxt, lp, top

    def _spec_decode(self, K: int):
        """One speculative round for the whole slot pool (JAX's
        `_spec_decode_impl`): K greedy draft steps over the draft pool,
        one verify forward of the target over [cur, d0..d_{K-2}] with the
        slots' adapters, then per-row acceptance — greedy rows by argmax
        match (the tokens of plain serving), sampled rows by rejection
        sampling (the output law of plain sampling), penalty rows accept
        none and take the penalty sampler's token at position 0. Both
        pools roll back to pos + n_acc + 1; slots above hold stale drafts,
        masked and overwritten next round. Acceptance caps at K-1: the
        draft pool holds KV for cur, d0..d_{K-2} only. Returns (choice
        [B, K], each emitted token's target logprob [B, K], n_acc [B], the
        drafts [B, K]); slot b emits choice[b, :n_acc[b] + 1]."""
        cfg, dev = self.config, self.device
        tok, drafts = self.cur, []
        for _ in range(K):
            logits, self.dcache = llama.forward(cfg, self._draft_params, tok[:, None],
                                                self.dcache, mode="decode")
            tok = torch.argmax(logits[:, -1], dim=-1)
            drafts.append(tok)
        drafts = torch.stack(drafts, dim=1)  # [B, K]
        verify_in = torch.cat([self.cur[:, None], drafts[:, :K - 1]], dim=1)
        tlogits, self.cache = llama.forward(cfg, self.model.params, verify_in, self.cache,
                                            mode="prefill", lora=self._gather_blora())
        tlogits = tlogits.float()
        greedy = torch.argmax(tlogits, dim=-1)  # [B, K]
        pen1 = self._penalty == 1.0
        row_greedy, row_sampled = ~self._dosample & pen1, self._dosample & pen1
        temp, topk, topp = (torch.as_tensor(a, device=dev)
                            for a in (self._temp, self._topk, self._topp))
        if row_sampled.any():
            probs = torch.softmax(filter_logits_per_row(tlogits, temp, topk, topp), dim=-1)
            n_acc, extra = rejection_accept(
                probs, drafts, greedy, torch.as_tensor(row_greedy, device=dev),
                torch.as_tensor(row_sampled, device=dev), generator=self._gen)
            del probs
        else:  # all-greedy pools skip the [B, K, V] sorts (a host check)
            acc = (drafts[:, :K - 1] == greedy[:, :K - 1]) & torch.as_tensor(
                row_greedy, device=dev)[:, None]
            n_acc = torch.cumprod(acc.long(), dim=1).sum(dim=1)
            extra = torch.gather(greedy, 1, n_acc[:, None])[:, 0]
        step0 = None
        if not pen1.all():
            step0 = apply_repetition_penalty(tlogits[:, 0], self.seen,
                                             torch.as_tensor(self._penalty, device=dev))
            samp0 = sample_token_per_row(step0, self._gen, temp, topk, topp, self._dosample)
            extra = torch.where(torch.as_tensor(pen1, device=dev), extra, samp0)
        pos = torch.arange(K, device=dev)[None, :]
        choice = torch.where(pos < n_acc[:, None], drafts,
                             torch.where(pos == n_acc[:, None], extra[:, None], greedy))
        # each emitted token's logprob without a [B, K, V] log-softmax
        lp = torch.gather(tlogits, -1, choice[..., None])[..., 0] - torch.logsumexp(tlogits, -1)
        if step0 is not None:
            # penalty rows drew position 0 from the penalized distribution
            lp0 = (torch.gather(step0, -1, choice[:, :1])[:, 0]
                   - torch.logsumexp(step0, dim=-1))
            lp[:, 0] = torch.where(torch.as_tensor(pen1, device=dev), lp[:, 0], lp0)
        back = (n_acc + 1 - K).to(torch.int32)
        self.cache = dataclasses.replace(self.cache, pos=self.cache.pos + back)
        self.dcache = dataclasses.replace(self.dcache, pos=self.dcache.pos + back)
        self.cur = extra
        # penalty rows emit exactly `extra`; the others do not read `seen`
        self.seen[torch.arange(self.n_slots, device=dev), extra] = True
        return choice, lp, n_acc, drafts

    # ---- host API ---------------------------------------------------------

    def submit(self, prompt: list[int], max_new_tokens: int = 64,
               stream: Optional[queue.SimpleQueue] = None,
               do_sample: Optional[bool] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None, top_p: Optional[float] = None,
               repetition_penalty: Optional[float] = None,
               eos_token_id: Optional[int] = None,
               queue_deadline_s: Optional[float] = None,
               deadline_s: Optional[float] = None,
               adapter: Optional[str] = None) -> Request:
        """Queue a request (thread-safe). An invalid one (empty prompt,
        ids outside the vocabulary, an adapter on an engine without a
        registry, a prompt over the slot capacity without truncate_prompts)
        finishes "invalid" at once; a submit while draining or over
        `max_queue` is shed before it is journaled."""
        if repetition_penalty is not None and repetition_penalty <= 0:
            raise ValueError(f"repetition_penalty must be > 0, got {repetition_penalty}")
        if top_k is not None:
            # <= 0 disables; more than the vocabulary caps
            top_k = None if top_k <= 0 else min(top_k, self.config.vocab_size)
        # the decode window must fit the cache beside a minimal prompt bucket
        max_new_tokens = max(1, min(max_new_tokens, self.max_len - 16))
        req = Request(
            rid=next(self._rid), prompt=list(prompt),
            max_new_tokens=max_new_tokens, stream=stream, do_sample=do_sample,
            temperature=temperature, top_k=top_k, top_p=top_p,
            repetition_penalty=repetition_penalty, eos_token_id=eos_token_id,
            adapter=adapter,
            queue_deadline_s=(queue_deadline_s if queue_deadline_s is not None
                              else self.queue_deadline_s),
            deadline_s=deadline_s if deadline_s is not None else self.deadline_s,
            submit_ts=self._clock())
        tr = self.tracer
        if tr is not None and tr.enabled:
            tr.instant("submit", ts=req.submit_ts, tid=req.rid, cat="request",
                       rid=req.rid, prompt_tokens=len(req.prompt))
        if req.queue_deadline_s is not None or req.deadline_s is not None:
            self._deadlines_seen = True  # a plain bool store, read next step
        error = None
        limit = self.max_len - max_new_tokens
        bad = [t for t in req.prompt if not 0 <= t < self.config.vocab_size]
        if not req.prompt:
            error = "empty prompt — nothing to generate"
        elif bad:
            error = (f"prompt token id {bad[0]} outside [0, "
                     f"{self.config.vocab_size}) — wrong tokenizer for this model?")
        elif adapter is not None and self.adapters is None:
            # serving the base instead would be the wrong model for the tenant
            error = (f"request names adapter {adapter!r} but this engine has no "
                     "adapter registry (construct it with adapters=)")
        elif len(req.prompt) > limit and not self.truncate_prompts:
            error = (f"prompt ({len(req.prompt)} tokens) exceeds the slot capacity "
                     f"({limit} = max_len {self.max_len} - max_new_tokens "
                     f"{max_new_tokens}); shorten the prompt, raise max_len, or "
                     "construct the engine with truncate_prompts=True to keep "
                     "the prompt tail")
        if error is not None:
            req.error, req.finish_reason, req.done = error, "invalid", True
            self._note_finish(req, req.submit_ts)
            if stream is not None:
                stream.put(None)
            return req
        if self._draining:
            # shed before the journal append: a drained request was never
            # accepted, and its entry would resurrect it at the next start
            self._shed_request(req, "draining", "server is draining for shutdown; "
                               "retry against a fresh instance", journaled=False)
            return req
        if self.max_queue is None:
            self._accept(req)
            return req
        shed_qsize = None
        with self._admission_lock:
            qsize = self._queue.qsize()
            if qsize >= self.max_queue:
                # decided under the lock, checked before the journal append;
                # the rejection's own work runs after the release
                shed_qsize = qsize
            else:
                self._accept(req)
        if shed_qsize is not None:
            self._shed_request(req, "queue_full", f"queue full: {shed_qsize} waiting >= "
                               f"max_queue {self.max_queue}; retry later", journaled=False)
        return req

    def _accept(self, req: Request) -> None:
        """Take a submit in: its in-flight charge, its journal entry, the
        queue."""
        with self._stat_lock:
            self._inflight += 1
        if self._journal is not None:
            self._journal.record_submit(req)
        self._queue.put(req)

    def _slot_sampling(self, req: Request) -> tuple[float, int, float, bool]:
        """A request's sampling parameters against the engine defaults."""
        g = self.gen
        temp = req.temperature if req.temperature is not None else g.temperature
        topk = req.top_k if req.top_k is not None else (g.top_k or 0)
        topp = req.top_p if req.top_p is not None else (
            g.top_p if g.top_p is not None else 1.0)
        dosample = req.do_sample if req.do_sample is not None else g.do_sample
        return float(temp), int(topk or 0), float(topp), bool(dosample)

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self._slots):
            if s.req is None:
                return i
        return None

    # ---- paged page management -------------------------------------------

    def _alloc_page(self) -> Optional[int]:
        """A free page: the free list, then LRU radix leaves, then the page-
        out of holder-free adapters (their host copies survive). Eviction
        only drops pages no slot holds; preemption comes after all three
        (`_alloc_page_preempting`). The `alloc_page` fault point returns
        None as if the pool were dry."""
        if self._faults.fire("alloc_page") is not None:
            return None
        pg = self._pool.alloc()
        while pg is None and self.radix.evict_one():
            self.prefix_evictions += 1
            pg = self._pool.alloc()
        while pg is None and self._pager is not None and self._pager.evict_one():
            pg = self._pool.alloc()
        return pg

    def _release_slot_pages(self, slot: int) -> None:
        for pg in self._slot_pages[slot]:
            self._pool.decref(pg)  # frees on 0; cached nodes keep theirs
        self._slot_pages[slot] = []
        self._slot_written[slot] = 0
        self._slot_pos[slot] = 0
        # the idle slot's garbage decode writes go to the scratch page
        self._bt_host[slot, :] = 0
        self._bt_dirty = True
        self.cache.pos[slot] = 0

    def _admit_paged(self, req: Request, slot: int) -> bool:
        """Reuse the longest cached prompt prefix from the radix tree
        (full pages by descent, a mid-page divergence by copying the
        cached page), allocate fresh pages for the rest, prefill the tail:
        at once, or as a chunk plan that `step()` advances one chunk at a
        time (prefill_chunk_tokens). False = not enough pages; retry later."""
        page = self.page_size
        limit = self.max_len - req.max_new_tokens
        if len(req.prompt) > limit:
            req.prompt = req.prompt[-limit:]
        prompt = req.prompt

        # in the request's adapter namespace: pages prefilled under an
        # adapter carry its K/V, so tenants never share pages
        path = self.radix.match(prompt, ns=req.adapter)
        shared = [nd.page for nd in path]
        n_hit = len(shared)
        lp = n_hit * page
        tail = prompt[lp:]
        head_node = path[-1] if path else self.radix.root_for(req.adapter)

        # sub-page sharing: the matched node's child agreeing with the
        # tail for t_copy tokens is copied instead of re-prefilled; the
        # last real token always prefills (its logits seed generation)
        t_copy, src_node = 0, None
        if len(tail) > 1:
            m, child = self.radix.match_partial(head_node, tail)
            t_copy = min(m, len(tail) - 1)
            src_node = child if t_copy > 0 else None
            if src_node is None:
                t_copy = 0
        src_page = src_node.page if src_node is not None else None

        def plan(cut):
            # the prefill bucket (16-token quantum) and the fresh pages it needs
            b = min(round_up(max(len(prompt) - lp - cut, 16), 16),
                    self.max_len - lp - cut)
            return b, -(-(lp + cut + b) // page) - n_hit

        bucket0, need0 = plan(0)
        if src_page is not None:
            bucket, need = plan(t_copy)
            # a copy that shrinks neither the bucket nor the pages is skipped
            if bucket >= bucket0 and need >= need0:
                t_copy, src_page, src_node = 0, None, None
                bucket, need = bucket0, need0
        else:
            t_copy = 0
            bucket, need = bucket0, need0
        lp_eff = lp + t_copy
        tail2 = prompt[lp_eff:]
        if need > self.n_pages - 1:  # can never be satisfied (page 0 is scratch)
            self._fail_request(req, (
                f"prompt needs {need} pages but the pool only has "
                f"{self.n_pages - 1}; raise n_pages or shorten the prompt"))
            return True  # consumed (failed), keep admitting others
        # hold the shared pages and the copy source BEFORE allocating, so
        # radix eviction cannot take this request's own prefix
        for pg in shared:
            self._pool.incref(pg)
        if src_page is not None:
            self._pool.incref(src_page)
        fresh: list[int] = []
        for _ in range(need):
            pg = self._alloc_page()
            if pg is None:  # out of pages: roll back, retry next step
                for q in fresh + shared:
                    self._pool.decref(q)
                if src_page is not None:
                    self._pool.decref(src_page)
                return False
            fresh.append(pg)
        self._mark_admitted(req)
        if n_hit:
            self.prefix_hits += 1

        table = shared + fresh
        self._slot_pages[slot] = table
        # page-aligned coverage: decode extends in whole pages
        self._slot_written[slot] = len(table) * page
        row = np.zeros((self.max_pages_per_row,), np.int32)
        row[: len(table)] = table

        if src_page is not None:
            # the whole source page is copied; slots past t_copy are
            # overwritten by the tail prefill or masked by pos
            kvpaged.copy_page(self.cache, src_page, fresh[0])
            self._pool.decref(src_page)
            self.prefix_partial_hits += 1
            self.prefix_tokens_reused += t_copy
            self.radix.touch(src_node)

        chunk = self.prefill_chunk_tokens
        if chunk is not None and len(tail2) > chunk:
            # the slot is held (req set, inactive, its engine block-table row
            # on the scratch page); step() runs one chunk a call
            self._slots[slot] = _Slot(req=req, seq=next(self._seq))
            self._prefilling = _PrefillState(req=req, slot=slot, row=row, written=lp_eff,
                                             path=path, chunk=chunk)
            return True

        self._bt_host[slot] = row
        self._bt_dirty = True
        self.prefill_chunks += 1
        logits_last = self._paged_prefill(row, lp_eff, tail2, self._prefill_lora(req))
        self.cache.pos[slot] = len(prompt)
        self.cache.start[slot] = 0
        self._slot_pos[slot] = len(prompt)
        self._register_prefix(prompt, path, table, ns=req.adapter)
        if self.speculative:
            # a prefix hit saves the target's prefill only: the draft
            # prefills its whole context into its dense pool
            self._admit_draft(slot, prompt, limit)
        self._activate(slot, req, logits_last)
        return True

    def _advance_prefill(self) -> None:
        """Run at most one chunk of the in-flight chunked prefill. The last
        chunk installs the real block-table row, registers the radix nodes
        and activates the slot (its first token closes the TTFT)."""
        st = self._prefilling
        if st is None:
            return
        prompt = st.req.prompt
        rem = len(prompt) - st.written
        n = min(st.chunk, rem)
        self.prefill_chunks += 1
        logits_last = self._paged_prefill(st.row, st.written,
                                          prompt[st.written: st.written + n],
                                          self._prefill_lora(st.req))
        st.written += n
        if n < rem:
            return
        slot = st.slot
        self._prefilling = None
        self._bt_host[slot] = st.row
        self._bt_dirty = True
        self.cache.pos[slot] = len(prompt)
        self.cache.start[slot] = 0
        self._slot_pos[slot] = len(prompt)
        self._register_prefix(prompt, st.path, self._slot_pages[slot], ns=st.req.adapter)
        self._activate(slot, st.req, logits_last)

    def _admit_draft(self, slot: int, prompt: list[int], limit: int) -> None:
        """Prefill the draft pool's row of a newly admitted or resumed
        request, left-padded to its bucket — one definition for every
        admission path (dense, paged, a prefix hit, a resume)."""
        bucket = min(round_up(max(len(prompt), 16), 64), limit)
        dprompt = prompt[-bucket:]
        tokens = np.full((1, bucket), self.gen.pad_token_id, np.int32)
        tokens[0, bucket - len(dprompt):] = dprompt
        pad = bucket - len(dprompt)
        _, dpcache = self._prefill(tokens, pad, params=self._draft_params)
        kvcache.insert_row(self.dcache, dpcache, slot, pad)

    def _register_prefix(self, prompt: list[int], path: list,
                         table: list[int], ns=None) -> None:
        """Register the prompt's fully covered pages past the matched run
        as radix nodes (the cache takes its own page reference), under the
        adapter namespace `ns`. An existing edge keeps its page; our
        duplicate frees at release."""
        page = self.page_size
        node = path[-1] if path else self.radix.root_for(ns)
        for i in range(len(path), len(prompt) // page):
            key = tuple(prompt[i * page: (i + 1) * page])
            nxt = node.children.get(key)
            if nxt is None:
                nxt = self.radix.insert(node, key, table[i])
            node = nxt

    def _ensure_decode_pages(self, need_tokens: int = 1) -> None:
        """Before a decode step, every active slot whose next `need_tokens`
        writes (a speculative verify writes K before its rollback) would
        run past its allocation gets pages; a dry pool preempts a victim
        (policy order) to host RAM. "length" remains only for the logical
        capacity or a pool that provably cannot support the request."""
        for i in np.nonzero(self.active)[0]:
            slot = int(i)
            while (self.active[slot]
                   and self._slot_pos[slot] + need_tokens > self._slot_written[slot]):
                idx = len(self._slot_pages[slot])
                if idx >= self.max_pages_per_row:  # logical capacity hit
                    self._finish(slot, "length")
                    break
                pg = self._alloc_page_preempting(slot)
                if pg is None:
                    if self.active[slot]:  # not self-preempted: stuck
                        self._finish(slot, "length")
                    break
                self._slot_pages[slot].append(pg)
                self._slot_written[slot] += self.page_size
                self._bt_host[slot, idx] = pg
                self._bt_dirty = True

    # ---- preemption (host-RAM KV swap) ------------------------------------

    def _alloc_page_preempting(self, slot: int) -> Optional[int]:
        """_alloc_page, escalating to preemption: swap victims out until a
        page frees. With no other victim the slot preempts itself — only
        if it progressed since its last resume (else it would livelock)."""
        while True:
            pg = self._alloc_page()
            if pg is not None or not self.preemption:
                return pg
            victim = self._pick_victim(exclude=slot)
            if victim is not None:
                self._preempt_slot(victim)
                continue
            if self._abort_prefill_for_pages():
                continue  # the chunk plan gave its pages back
            s = self._slots[slot]
            if s.resumed_pos < 0 or self._slot_pos[slot] > s.resumed_pos:
                self._preempt_slot(slot)  # the caller sees the slot inactive
            return None

    def _abort_prefill_for_pages(self) -> bool:
        """A chunk plan yields its pages to a decoding slot that needs
        them: it has no decode state yet, so its slot is released and its
        request goes back to the queue's front, to prefill again later from
        what the cache still holds. Nothing was emitted, so the output is
        unchanged; admit_ts stays that of the first admission."""
        st = self._prefilling
        if st is None:
            return False
        self._free_slot_state(st.slot)  # releases the pages and the plan
        with self._queue.mutex:
            self._queue.queue.appendleft(st.req)
        return True

    def _pick_victim(self, exclude: int) -> Optional[int]:
        """youngest = most recently (re)admitted: least progress lost, and
        the oldest request is never chosen while another is active, so it
        always completes and frees its pages. A slot mid-chunked-prefill is
        inactive: it has no decode state to swap and is never a victim."""
        cands = [(s.seq, i) for i, s in enumerate(self._slots)
                 if s.req is not None and i != exclude and self.active[i]]
        if not cands:
            return None
        pick = max(cands) if self.preemption_policy == "youngest" else min(cands)
        return pick[1]

    @torch.inference_mode()
    def _preempt_slot(self, slot: int) -> None:
        """Swap a slot's KV to host RAM and park its request with the
        tokens generated so far; the slot frees without finishing it."""
        s = self._slots[slot]
        req = s.req
        now = self._clock()
        self._flush_decode_window(slot, now)
        if self.paged:
            pos = self._slot_pos[slot]
            n_keep = -(-pos // self.page_size)  # pages holding real KV
            blob = kvpaged.swap_out_pages(self.cache, self._slot_pages[slot][:n_keep])
            start = 0
        else:
            pos = int(self.cache.pos[slot])
            start = int(self.cache.start[slot])
            # only the live region travels, in 64-slot steps
            n = min(round_up(max(pos, 1), 64), self.cache.max_len)
            blob = kvcache.swap_out_row(self.cache, slot, n)
            n_keep = 0
        entry = _Preempted(
            req=req, cur=int(self.cur[slot]), remaining=s.remaining, eos=s.eos,
            pos=pos, start=start, seq=s.seq, temp=float(self._temp[slot]),
            topk=int(self._topk[slot]), topp=float(self._topp[slot]),
            dosample=bool(self._dosample[slot]),
            penalty=float(self._penalty[slot]), seen=self.seen[slot].cpu(),
            blob=blob, n_pages=n_keep)
        req.preemptions += 1
        self.preemptions += 1
        req.preempt_ts = now  # the "preempted" span and resume_wait close on it
        tr = self.tracer
        if tr is not None and tr.enabled:
            tr.instant("swap_out", ts=now, tid=req.rid, cat="request", rid=req.rid,
                       pos=pos, pages=n_keep)
        self._preempted.append(entry)
        self._free_slot_state(slot)
        if not self.paged:
            self.cache.pos[slot] = 0

    def _resume_preempted(self, entry: _Preempted, slot: int) -> bool:
        """Swap a parked request back into `slot` (fresh pages / any free
        row). False = the pool cannot hold the restore yet."""
        req = entry.req
        if self.paged:
            fresh: list[int] = []
            for _ in range(entry.n_pages):
                pg = self._alloc_page()
                if pg is None:  # roll back; retry when pages free up
                    for q in fresh:
                        self._pool.decref(q)
                    return False
                fresh.append(pg)
            self._slot_pages[slot] = fresh
            self._slot_written[slot] = entry.n_pages * self.page_size
            row = np.zeros((self.max_pages_per_row,), np.int32)
            row[: entry.n_pages] = fresh
            self._bt_host[slot] = row
            self._bt_dirty = True
            kvpaged.swap_in_pages(self.cache, entry.blob, fresh)
            self.cache.pos[slot] = entry.pos
            self.cache.start[slot] = 0
            self._slot_pos[slot] = entry.pos
        else:
            k, v, ks, vs = entry.blob
            kvcache.swap_in_row(self.cache, k, v, ks, vs, slot, entry.pos,
                                entry.start)
        self.cur[slot] = entry.cur
        self.seen[slot] = entry.seen.to(self.device)
        # the parked request kept its adapter reference; re-point the slot
        self._set_slot_adapter(slot, req)
        if self.speculative:
            # the draft pool was not swapped (drafts only move the
            # acceptance rate): rebuild its row from the whole context
            self._admit_draft(slot, req.prompt + req.out_tokens,
                              self.max_len - req.max_new_tokens)
        self._temp[slot], self._topk[slot] = entry.temp, entry.topk
        self._topp[slot], self._dosample[slot] = entry.topp, entry.dosample
        self._penalty[slot] = entry.penalty
        self._slots[slot] = _Slot(req=req, remaining=entry.remaining,
                                  eos=entry.eos, seq=entry.seq,
                                  resumed_pos=entry.pos)
        self.active[slot] = True
        now = self._clock()
        if req.preempt_ts is not None:
            parked = max(now - req.preempt_ts, 0.0)
            self.resume_wait.observe(parked)
            req.preempted_s += parked
            tr = self.tracer
            if tr is not None and tr.enabled:
                tr.complete("preempted", req.preempt_ts, parked, tid=req.rid, cat="request",
                            rid=req.rid, pages=entry.n_pages)
            req.preempt_ts = None
        if req.last_token_ts is not None:
            req.last_token_ts = now  # the stall is in resume_wait, not itl
        self.preemption_resumes += 1
        return True

    def preempt(self, req: Request) -> None:
        """Thread-safe operator preemption: park the request's KV in host
        RAM at the next step and requeue it. A request not decoding in a
        slot has nothing to swap; the marker is dropped for it."""
        self._preempt_requested.add(req.rid)

    def _reap_preempt_requests(self) -> None:
        if not self._preempt_requested:
            return
        pending, self._preempt_requested = self._preempt_requested, set()
        for i, s in enumerate(self._slots):
            if s.req is not None and s.req.rid in pending and self.active[i]:
                self._preempt_slot(i)

    # ---- multi-tenant LoRA adapters ---------------------------------------

    def _resolve_adapter(self, req: Request) -> bool:
        """Acquire the request's adapter at admission (load and verify
        through the registry) and take the request's one reference, paged
        into the device pool where it fits. False: the adapter is missing,
        corrupt or does not fit this model; that request finishes "error"
        and the caller admits the next one. An injected page-in stall fails
        that request only."""
        if req.rid in self._adapter_refs:  # an out-of-pages retry: held already
            if self._pager is not None:  # its pages may have been paged out
                try:
                    self._pager.ensure(self._adapter_refs[req.rid], req.rid)
                except AdapterError:
                    pass  # best effort: the gather reads the host copy
            return True
        try:
            entry = self.adapters.acquire(req.adapter)
        except AdapterError as e:
            self._fail_request(req, str(e))
            return False
        try:
            self._check_adapter_dims(entry)
        except AdapterError as e:
            self.adapters.reject(entry)  # counted, and dropped from residency
            self._fail_request(req, str(e))
            return False
        self._adapter_refs[req.rid] = entry
        if self._pager is not None:
            # False (the pool stayed dry) is no error: the decode step
            # gathers this adapter from host RAM; paging never preempts KV
            try:
                self._pager.ensure(entry, req.rid)
            except AdapterError as e:
                # the page-in stall: release the reference just taken, so the
                # registry's counts stay exact, and fail this request
                del self._adapter_refs[req.rid]
                self.adapters.release(entry)
                self._fail_request(req, str(e))
                return False
        return True

    def _check_adapter_dims(self, entry) -> None:
        """An adapter trained on another base fails at admission, with its
        shapes, not deep inside a projection."""
        L = self.config.num_hidden_layers
        for t in entry.targets:
            try:
                out_d, in_d = _target_dims(self.config, t)
            except KeyError:
                raise AdapterError(entry.name, "rank_mismatch",
                                   f"unknown lora target {t!r} for this model family") from None
            a, b = entry.layers[t]["a"], entry.layers[t]["b"]
            if (tuple(a.shape) != (L, entry.rank, in_d)
                    or tuple(b.shape) != (L, out_d, entry.rank)):
                raise AdapterError(
                    entry.name, "rank_mismatch",
                    f"target {t}: a{tuple(a.shape)} / b{tuple(b.shape)} do not fit this "
                    f"model's [L={L}, r={entry.rank}, in={in_d}] / [L, out={out_d}, r] — "
                    "adapter trained on a different base?")

    def _set_slot_adapter(self, slot: int, req: Request) -> None:
        """Point the slot at the request's adapter entry (or None); the
        batched tree is rebuilt only when the assignment changed."""
        if self.adapters is None:
            return
        entry = self._adapter_refs.get(req.rid)
        if self._slot_adapter[slot] is not entry:
            self._slot_adapter[slot] = entry
            self._blora_dirty = True

    def _prefill_lora(self, req: Request) -> Optional[dict]:
        """The request's own rank-bucketed adapter tree on the engine's
        device, or None for the base."""
        entry = self._adapter_refs.get(req.rid)
        return None if entry is None else entry.tree(device=self.device)

    def _gather_blora(self) -> Optional[dict]:
        """The decode step's batched tree: per target an [L, B, rb, in] A
        stack and an [L, B, out, rb] B stack over every slot (zeros and a
        0 scale for rows without the adapter or the target), rb the bucket
        of the batch's largest rank; None when no active slot carries an
        adapter (the base path). Rebuilt only when the slot assignment
        changed. Adapters resident in the page pool are read from their
        pages on the device, the rest copied from host RAM; both hold the
        same bf16 values."""
        if self.adapters is None:
            return None
        if not self._blora_dirty:
            return self._blora
        self._blora_dirty = False
        entries = self._slot_adapter
        live = [e for e in entries if e is not None]
        if not live:
            self._blora = None
            return None
        B, L, dev = self.n_slots, self.config.num_hidden_layers, self.device
        rb = rank_bucket(max(e.rank for e in live))
        paged = {}
        if self._pager is not None:
            for e in live:
                if e.name not in paged:
                    lv = self._pager.leaves(e.name)
                    if lv is not None:
                        paged[e.name] = lv
        layers = {}
        for t in sorted({t for e in live for t in e.targets}):
            ref = next(e.layers[t] for e in live if t in e.layers)
            in_d, out_d = ref["a"].shape[-1], ref["b"].shape[-2]
            a = torch.zeros((L, B, rb, in_d), dtype=torch.bfloat16, device=dev)
            b = torch.zeros((L, B, out_d, rb), dtype=torch.bfloat16, device=dev)
            for i, e in enumerate(entries):
                if e is None or t not in e.layers:
                    continue
                src = paged[e.name][t] if e.name in paged else e.layers[t]
                a[:, i, :e.rank] = src["a"].to(device=dev, dtype=torch.bfloat16)
                b[:, i, :, :e.rank] = src["b"].to(device=dev, dtype=torch.bfloat16)
            layers[t] = {"a": a, "b": b}
        scale = torch.tensor([0.0 if e is None else e.scale for e in entries],
                             dtype=torch.float32, device=dev)
        self._blora = {"layers": layers, "scale": scale}
        return self._blora

    # ---- admission and finishing ------------------------------------------

    def _pop_request(self) -> Optional[Request]:
        if self._waiting is not None:
            req, self._waiting = self._waiting, None
            return req
        if self.paged:
            return self._pop_deepest_match()
        try:
            return self._queue.get_nowait()
        except queue.Empty:
            return None

    def _pop_deepest_match(self) -> Optional[Request]:
        """Cache-aware admission: among the oldest queued requests, admit
        the one with the deepest radix prefix match first (ties keep FIFO
        order); the probe does not touch the LRU."""
        with self._queue.mutex:
            q = self._queue.queue
            if not q:
                return None
            if len(q) > 1 and self.radix.n_nodes:
                n = min(len(q), self._ADMIT_SCAN_WINDOW)
                best_i, best_d = 0, self.radix.match_len(q[0].prompt, ns=q[0].adapter)
                for i in range(1, n):
                    d = self.radix.match_len(q[i].prompt, ns=q[i].adapter)
                    if d > best_d:
                        best_i, best_d = i, d
                if best_i:
                    req = q[best_i]
                    del q[best_i]
                    return req
            return q.popleft()

    def _fail_request(self, req: Request, msg: str) -> None:
        """Terminal failure for a request not (or no longer) in a slot."""
        self._finish_detached(req, "error", error=msg)

    def _shed_request(self, req: Request, kind: str, msg: str,
                      journaled: bool = True) -> None:
        """Overload rejection: explicit, fast, retryable."""
        req.shed_kind = kind
        self._finish_detached(req, "shed", error=msg, journaled=journaled)
        self._bump("requests_shed")

    def _finish_detached(self, req: Request, reason: str, error: Optional[str] = None,
                         journaled: bool = True) -> None:
        """Terminal state for a request not in a slot (queued / parked),
        with _finish's journal and stream discipline. journaled=False: a
        request shed at submit, never accepted (no journal entry, no
        in-flight charge)."""
        if journaled:
            with self._stat_lock:
                self._inflight -= 1
        if error is not None:
            req.error = error
        req.finish_reason = reason
        req.done = True
        self._note_finish(req, self._clock())
        if journaled and self._journal is not None:
            self._journal.record_done(req.rid)
        if req.stream is not None:
            req.stream.put(None)

    def _note_finish(self, req: Request, now: float) -> None:
        """Terminal accounting shared by every finish path: the per-reason
        count, the trace events and the request log's record (handler
        threads reach it for rejected submits, hence the lock)."""
        reason = req.finish_reason or "?"
        with self._stat_lock:
            self.finish_reasons[reason] += 1
        entry = self._adapter_refs.pop(req.rid, None)
        if entry is not None:
            # the request's one adapter hold ends with it (every finish path
            # comes here); its device pages become page-out candidates
            self.adapters.release(entry)
            if self._pager is not None:
                self._pager.drop_holder(req.rid)
        tr = self.tracer
        if req.preempt_ts is not None:  # died while parked: close the stretch
            parked = max(now - req.preempt_ts, 0.0)
            req.preempted_s += parked
            if tr is not None and tr.enabled:
                tr.complete("preempted", req.preempt_ts, parked, tid=req.rid, cat="request",
                            rid=req.rid, outcome=reason)
            req.preempt_ts = None
        if tr is not None and tr.enabled:
            if req.admit_ts is None and reason != "invalid":
                # died waiting: its queued span shows the wait
                tr.complete("queued", req.submit_ts, now - req.submit_ts, tid=req.rid,
                            cat="request", rid=req.rid, outcome=reason)
            args = {"rid": req.rid, "finish_reason": reason, "tokens": len(req.out_tokens)}
            if req.first_token_ts is not None:
                args["ttft_s"] = round(req.first_token_ts - req.submit_ts, 6)
            if req.admit_ts is not None:
                args["queue_wait_s"] = round(req.admit_ts - req.submit_ts, 6)
            if req.preempted_s:
                args["preempted_s"] = round(req.preempted_s, 6)
            tr.instant("finish", ts=now, tid=req.rid, cat="request", **args)
        if self._request_log is not None:
            self._request_log.write(self._request_record(req, now))

    def _request_record(self, req: Request, now: float) -> dict:
        """The request log's record: every timing the TTFT, inter-token and
        queue-wait dashboards derive, under one rid."""
        rec = {"ts": round(now, 6), "rid": req.rid, "finish_reason": req.finish_reason,
               "prompt_tokens": len(req.prompt), "output_tokens": len(req.out_tokens)}
        if req.admit_ts is not None:
            rec["queue_wait_s"] = round(req.admit_ts - req.submit_ts, 6)
        if req.first_token_ts is not None:
            rec["ttft_s"] = round(req.first_token_ts - req.submit_ts, 6)
            n = len(req.out_tokens)
            if n > 1 and req.last_token_ts is not None:
                # time per output token over the decode stretch, parked
                # time taken out (it is reported on its own)
                decoding = max(req.last_token_ts - req.first_token_ts - req.preempted_s, 0.0)
                rec["tpot_s"] = round(decoding / (n - 1), 6)
        if req.preemptions:
            rec["preemptions"] = req.preemptions
            rec["preempted_s"] = round(req.preempted_s, 6)
        if req.shed_kind is not None:
            rec["shed_kind"] = req.shed_kind
        if req.error:
            rec["error"] = req.error
        return rec

    @staticmethod
    def _expired(req: Request, now: float) -> Optional[str]:
        """The deadline a request has blown, if any."""
        if req.deadline_s is not None and now - req.submit_ts > req.deadline_s:
            return "deadline_s"
        if (req.admit_ts is None and req.queue_deadline_s is not None
                and now - req.submit_ts > req.queue_deadline_s):
            return "queue_deadline_s"
        return None

    def _mark_admitted(self, req: Request) -> None:
        """Stamp the first admission: queue_wait measures pure waiting, and
        the "queued" span ends where the prefill span starts."""
        if req.admit_ts is not None:
            return
        req.admit_ts = self._clock()
        self.queue_wait.observe(req.admit_ts - req.submit_ts)
        tr = self.tracer
        if tr is not None and tr.enabled:
            tr.complete("queued", req.submit_ts, req.admit_ts - req.submit_ts, tid=req.rid,
                        cat="request", rid=req.rid)

    def _activate(self, slot: int, req: Request, logits_last: torch.Tensor) -> None:
        """After prefill: sample the first token, arm the slot's sampling
        parameters, emit. logits_last: [1, V]."""
        temp, topk, topp, dosample = self._slot_sampling(req)
        penalty = (req.repetition_penalty if req.repetition_penalty is not None
                   else self.gen.repetition_penalty)
        dev, V = self.device, self.config.vocab_size
        if penalty != 1.0:
            row = seen_from_prompt(
                torch.tensor([req.prompt], device=dev),
                torch.zeros((1,), dtype=torch.int32, device=dev), V)[0]
            logits_last = apply_repetition_penalty(logits_last, row[None], penalty)
        else:
            row = torch.zeros((V,), dtype=torch.bool, device=dev)
        first = int(sample_token_per_row(
            logits_last, self._gen,
            torch.tensor([temp], dtype=torch.float32, device=dev),
            torch.tensor([topk], dtype=torch.int32, device=dev),
            torch.tensor([topp], dtype=torch.float32, device=dev),
            np.asarray([dosample]))[0])
        self.cur[slot] = first
        eos = (req.eos_token_id if req.eos_token_id is not None
               else self.gen.eos_token_id)
        self._slots[slot] = _Slot(req=req, remaining=req.max_new_tokens - 1,
                                  eos=eos, seq=next(self._seq))
        self._temp[slot], self._topk[slot] = temp, topk
        self._topp[slot], self._dosample[slot] = topp, dosample
        self._penalty[slot] = penalty
        self.seen[slot] = row
        self.seen[slot, first] = True
        self._set_slot_adapter(slot, req)
        self.active[slot] = True
        row_lp = torch.log_softmax(logits_last.float().reshape(-1), dim=-1)
        first_lp = float(row_lp[first])
        first_top = None
        if self.logprobs_top_k:
            tv, ti = torch.topk(row_lp, self.logprobs_top_k)
            first_top = {int(t): float(lv) for t, lv in zip(ti.tolist(), tv.tolist())}
        # the prefill phase closes here (the first token's sample synced),
        # before the first emit: the request's track stays nested
        now = self._clock()
        if req.admit_ts is not None:
            self.prefill_seconds.observe(now - req.admit_ts)
            tr = self.tracer
            if tr is not None and tr.enabled:
                tr.complete("prefill", req.admit_ts, now - req.admit_ts, tid=req.rid,
                            cat="request", rid=req.rid, prompt_tokens=len(req.prompt))
        self._emit(slot, first, first_lp, first_top)

    def _admit_dense(self, req: Request, slot: int) -> None:
        self._mark_admitted(req)
        # decode writes land at [bucket, bucket + max_new_tokens): keep
        # that window inside the row, tail-truncating over-long prompts
        limit = self.max_len - req.max_new_tokens
        bucket = min(round_up(max(len(req.prompt), 16), 64), limit)
        if len(req.prompt) > bucket:
            req.prompt = req.prompt[-bucket:]
        tokens = np.full((1, bucket), self.gen.pad_token_id, np.int32)
        tokens[0, bucket - len(req.prompt):] = req.prompt
        pad = bucket - len(req.prompt)
        self.prefill_chunks += 1  # a monolithic prefill is one chunk
        logits_last, pcache = self._prefill(tokens, pad, self._prefill_lora(req))
        kvcache.insert_row(self.cache, pcache, slot, pad)
        if self.speculative:
            self._admit_draft(slot, req.prompt, limit)
        self._activate(slot, req, logits_last)

    def _admit(self) -> None:
        while True:
            slot = self._free_slot()
            if slot is None:
                return
            # preempted requests resume first, in preemption order
            if self._preempted:
                # dead entries at any depth went in _sweep_preempted
                entry = self._preempted[0]
                if self._resume_preempted(entry, slot):
                    self._preempted.popleft()
                    continue
                if not self.active.any() and self._prefilling is None:
                    # nothing left to free pages (a chunk plan will activate
                    # and free its own): the restore can never fit
                    self._preempted.popleft()
                    self._fail_request(entry.req, (
                        f"cannot resume preempted request: restoring "
                        f"{entry.n_pages} pages exceeds the free pool; "
                        "raise n_pages"))
                    continue
                return  # wait for pages before admitting anything newer
            if self._prefilling is not None:
                # one prefill at a time: the queue waits for the plan to land
                return
            req = self._pop_request()
            if req is None:
                return
            if req.rid in self._cancelled:  # cancelled while queued
                self._cancelled.pop(req.rid, None)
                self._finish_detached(req, "stop")
                continue
            now = self._clock()
            which = self._expired(req, now)
            if which is not None:
                self._expire_queued(req, which, now)
                continue
            if req.adapter is not None and not self._resolve_adapter(req):
                continue  # that request errors; the batch keeps serving
            if self.paged:
                if not self._admit_paged(req, slot):
                    self._waiting = req  # pool full: retry after frees
                    return
            else:
                self._admit_dense(req, slot)

    def _emit(self, slot: int, token: int, logprob: Optional[float] = None,
              top_logprobs: Optional[dict] = None) -> None:
        s = self._slots[slot]
        if s.eos is not None and token == s.eos:
            # the EOS id ends the stream but is not generated text
            self._finish(slot, "stop")
            return
        req = s.req
        now = self._clock()
        prev = req.last_token_ts
        if req.first_token_ts is None:
            req.first_token_ts = now
            self.ttft.observe(now - req.submit_ts)
            prev = now
        else:
            self.itl.observe(now - prev)
        req.last_token_ts = now
        tr = self.tracer
        if tr is not None and tr.enabled:
            # one "decode" span a trace_decode_every tokens, each opening
            # where the last closed
            if s.n_win == 0:
                s.t_win = prev
            s.n_win += 1
            if s.n_win >= self.trace_decode_every:
                tr.complete("decode", s.t_win, now - s.t_win, tid=req.rid, cat="request",
                            rid=req.rid, tokens=s.n_win)
                s.n_win = 0
        req.out_tokens.append(token)
        if logprob is not None:
            req.out_logprobs.append(logprob)
        if top_logprobs is not None:
            req.out_top_logprobs.append(top_logprobs)
        if req.stream is not None:
            req.stream.put(token)
        if s.remaining <= 0:
            self._finish(slot, "length")

    def _flush_decode_window(self, slot: int, now: float) -> None:
        """Close the slot's partial decode-window span (a finish or a
        preemption must not drop its tail tokens' span)."""
        s = self._slots[slot]
        tr = self.tracer
        if tr is not None and tr.enabled and s.n_win > 0 and s.req is not None:
            tr.complete("decode", s.t_win, now - s.t_win, tid=s.req.rid, cat="request",
                        rid=s.req.rid, tokens=s.n_win)
        s.n_win = 0

    def _finish(self, slot: int, reason: str = "stop", counted: bool = True) -> None:
        s = self._slots[slot]
        now = self._clock()
        self._flush_decode_window(slot, now)
        s.req.finish_reason = reason
        s.req.done = True
        # before the crash point: a crash here leaves the request terminal,
        # so its in-flight charge and its accounting are already settled
        with self._stat_lock:
            self._inflight -= 1
        self._note_finish(s.req, now)
        if counted and reason in ("stop", "length"):
            self.requests_completed += 1  # cancelled requests are not counted
        if not self._cleanup and self._faults.fire("crash_before_done") is not None:
            # a process death in the journal's at-least-once window: the
            # request completed, its tombstone was never written
            raise FaultError(f"injected crash before journal tombstone (rid {s.req.rid})")
        if self._journal is not None:
            self._journal.record_done(s.req.rid)
        if s.req.stream is not None:
            s.req.stream.put(None)
        self._free_slot_state(slot)

    def _free_slot_state(self, slot: int) -> None:
        """Release a slot's engine-side state (sampling rows, pages)
        without touching the request's terminal fields."""
        if self._prefilling is not None and self._prefilling.slot == slot:
            # died mid-chunked-prefill: every finish path comes here, so no
            # chunk ever runs for a freed slot
            self._prefilling = None
        self._slots[slot] = _Slot()
        self.active[slot] = False
        if self._slot_adapter[slot] is not None:
            # the row leaves the batched tree; a parked request keeps its
            # registry reference in _adapter_refs
            self._slot_adapter[slot] = None
            self._blora_dirty = True
        self._dosample[slot] = False  # idle rows decode deterministic garbage
        self._penalty[slot] = 1.0
        self.seen[slot] = False
        if self.paged:
            self._release_slot_pages(slot)

    def _reset_state(self) -> None:
        """Rebuild the pool after a failed decode so the engine can keep
        serving new requests."""
        self.cache = self._make_pool()
        if self.speculative:
            self.dcache = self._make_pool(force_dense=True)
        self.cur.zero_()
        self.seen.zero_()
        self._penalty[:] = 1.0
        self.active[:] = False
        self._preempted.clear()
        self._prefilling = None  # a half-run chunk plan died with the pool
        self._slot_adapter = [None] * self.n_slots
        self._blora, self._blora_dirty = None, True
        if self.paged:
            self._pool = kvpaged.PagePool(self.n_pages)
            self.radix = RadixPrefixCache(self.page_size, self._pool)
            if self._pager is not None:
                # resident adapters held the dead pool's pages; the next
                # admission pages them in again from the host copies
                self._pager.reset(self._pool)
            self._slot_pages = [[] for _ in range(self.n_slots)]
            self._slot_written = [0] * self.n_slots
            self._slot_pos = [0] * self.n_slots
            self._bt_host[:] = 0
            self._bt_dirty = True

    def cancel(self, req: Request) -> None:
        """Thread-safe: stop generating for a request whose consumer is
        gone. Its slot frees at the engine thread's next step."""
        if req.done:
            return
        self._cancelled[req.rid] = req

    def _reap_cancelled(self) -> None:
        for rid, q in list(self._cancelled.items()):
            if q.done:  # lost the race with a normal finish
                self._cancelled.pop(rid, None)
        for i, s in enumerate(self._slots):
            if s.req is not None and s.req.rid in self._cancelled:
                self._cancelled.pop(s.req.rid, None)
                self._finish(i, "stop", counted=False)

    def _inject_nan(self, lps: np.ndarray) -> np.ndarray:
        """The `nan_logits` fault point, on the plain and the speculative
        step: the victim rows' host logprobs become NaN, as if the model
        had produced non-finite logits for them."""
        f = self._faults.fire("nan_logits")
        if f is None:
            return lps
        lps = lps.copy()
        victims = f.get("slots")
        if victims is None:
            act = np.nonzero(self.active)[0]
            victims = [int(act[0])] if act.size else []
        for v in victims:
            lps[v] = np.nan
        return lps

    def _bump(self, counter: str) -> None:
        """Increment an overload counter (handler threads and the engine
        thread both bump them)."""
        with self._stat_lock:
            setattr(self, counter, getattr(self, counter) + 1)

    def _expire_queued(self, req: Request, which: str, now: float) -> None:
        """A request that expired before admission: a queue deadline sheds
        it, the whole deadline times it out."""
        if which == "queue_deadline_s":
            self._shed_request(req, "queue_deadline", (
                f"queue deadline: waited {now - req.submit_ts:.2f}s > "
                f"queue_deadline_s={req.queue_deadline_s}"))
        else:
            self._finish_detached(req, "timeout", error=f"deadline_s={req.deadline_s} "
                                  "exceeded before admission")
            self._bump("request_timeouts")

    def _sweep_preempted(self) -> None:
        """Drop parked requests that were cancelled or whose deadline
        expired, at any depth of the deque."""
        if not self._preempted:
            return
        now = self._clock()
        keep: "collections.deque[_Preempted]" = collections.deque()
        for entry in self._preempted:
            req = entry.req
            if req.rid in self._cancelled:
                self._cancelled.pop(req.rid, None)
                self._finish_detached(req, "stop")
                continue
            if self._expired(req, now) is not None:
                self._finish_detached(req, "timeout", error=f"deadline_s={req.deadline_s} "
                                      "exceeded while preempted")
                self._bump("request_timeouts")
                continue
            keep.append(entry)
        self._preempted = keep

    def _sweep_queue(self) -> None:
        """Drop requests that died while waiting (expired deadlines,
        cancelled clients) even when no slot frees: they stop counting
        against max_queue at the next step."""
        if not self._deadlines_seen and not self._cancelled:
            return
        now = self._clock()
        # the paged out-of-pages retry waits like a queue entry
        if self._waiting is not None:
            req = self._waiting
            if req.rid in self._cancelled:
                self._waiting = None
                self._cancelled.pop(req.rid, None)
                self._finish_detached(req, "stop")
            else:
                which = self._expired(req, now)
                if which is not None:
                    self._waiting = None
                    self._expire_queued(req, which, now)
        if self._queue.empty():
            return
        expired: list[tuple[Request, str]] = []
        cancelled: list[Request] = []
        with self._queue.mutex:  # one pass over the deque under its own lock
            q = self._queue.queue
            keep = []
            for r in q:
                which = self._expired(r, now)
                if r.rid in self._cancelled:
                    cancelled.append(r)
                elif which is not None:
                    expired.append((r, which))
                else:
                    keep.append(r)
            if expired or cancelled:
                q.clear()
                q.extend(keep)
        for req in cancelled:  # journal and stream work outside the lock
            self._cancelled.pop(req.rid, None)
            self._finish_detached(req, "stop")
        for req, which in expired:
            self._expire_queued(req, which, now)

    def _reap_deadlines(self) -> None:
        """Finish in-flight requests past their whole budget "timeout",
        with their partial output."""
        now = self._clock()
        for i, s in enumerate(self._slots):
            if s.req is None or s.req.deadline_s is None:
                continue
            if s.req.rid in self._cancelled:
                continue  # the cancel reaper frees it; counted once
            if now - s.req.submit_ts > s.req.deadline_s:
                s.req.error = (f"deadline_s={s.req.deadline_s} exceeded after "
                               f"{len(s.req.out_tokens)} tokens")
                self._finish(i, "timeout")
                self._bump("request_timeouts")

    @torch.inference_mode()
    def fail_all(self, msg: str) -> None:
        """Mark every in-flight, parked and queued request failed (the
        decode-failure path; streams get their end marker). Crash points
        do not fire during the cleanup."""
        self._cleanup = True
        try:
            for i, s in enumerate(self._slots):
                if s.req is None:
                    continue
                if s.req.done:
                    # crashed inside _finish (crash_before_done): the request
                    # completed; free the slot, keep its terminal state and
                    # write no tombstone, so a successor replays it
                    if s.req.stream is not None:
                        s.req.stream.put(None)
                    self._free_slot_state(i)
                    continue
                s.req.error = msg
                self._finish(i, "error")
            if self._waiting is not None:
                req, self._waiting = self._waiting, None
                self._fail_request(req, msg)
            while self._preempted:
                self._fail_request(self._preempted.popleft().req, msg)
            while True:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                self._fail_request(req, msg)
            self.active[:] = False
        finally:
            self._cleanup = False

    @torch.inference_mode()
    def step(self) -> bool:
        """Admit queued requests, run at most one prefill chunk, advance
        every active slot one token. Returns True while work remains."""
        f = self._faults.fire("slow_step")
        if f is not None:  # an injected device stall
            time.sleep(float(f.get("seconds", 0.05)))
        self._reap_cancelled()
        self._reap_preempt_requests()
        self._reap_deadlines()
        self._sweep_preempted()
        self._sweep_queue()
        self._admit()
        self._advance_prefill()
        if self.paged:
            # the current ladder K: after a downshift a round writes fewer
            self._ensure_decode_pages(self._cur_k if self.speculative else 1)
            if self._bt_dirty:
                self.cache.block_tables.copy_(torch.from_numpy(self._bt_host))
                self._bt_dirty = False
        if not self.active.any():
            return (not self._queue.empty() or self._waiting is not None
                    or bool(self._preempted) or self._prefilling is not None)
        if self.speculative:
            return self._step_speculative()
        t0 = self._clock()
        try:
            nxt, lps, top = self._decode()
        except Exception:
            # the pool may be half written: fail what is in flight, rebuild
            self.fail_all("decode step failed")
            self._reset_state()
            raise
        self.cur = nxt
        toks = nxt.tolist()
        lps_h = self._inject_nan(lps.cpu().numpy())
        tops_h = None if top is None else (top[0].tolist(), top[1].tolist())
        # the host copies above synchronize: the step's device work is done
        self._note_decode_step(t0)
        for i in np.nonzero(self.active)[0]:
            i = int(i)
            s = self._slots[i]
            if not np.isfinite(lps_h[i]):
                # quarantine the one poisoned slot; per-row decode leaves
                # the others untouched
                s.req.error = ("non-finite logits in decode step; request "
                               "quarantined (other slots unaffected)")
                self._finish(i, "error")
                continue
            s.remaining -= 1
            if self.paged:
                self._slot_pos[i] += 1
            alt = None
            if tops_h is not None:
                alt = {int(t): float(lv) for t, lv in zip(tops_h[0][i], tops_h[1][i])}
            self._emit(i, int(toks[i]), float(lps_h[i]), alt)
        return True

    def _note_decode_step(self, t0: float) -> None:
        """A decode step's histogram, and its span and occupancy counter on
        the engine track (tid 0)."""
        t1 = self._clock()
        self.decode_step_seconds.observe(t1 - t0)
        tr = self.tracer
        if tr is not None and tr.enabled:
            busy = int(self.active.sum())
            tr.complete("decode_step", t0, t1 - t0, tid=0, cat="engine", occupancy=busy,
                        slots=self.n_slots, queue_depth=self._queue.qsize())
            tr.counter("batch", ts=t1, occupancy=busy, queued=self._queue.qsize(),
                       preempted=len(self._preempted))

    def _step_speculative(self) -> bool:
        """A draft-K-then-verify round: each live slot emits 1..K tokens
        (its accepted drafts and the target's token after them)."""
        t0 = self._clock()
        try:
            choice, lp, n_acc, _ = self._spec_decode(self._cur_k)
        except Exception:
            self.fail_all("speculative decode step failed")
            self._reset_state()
            raise
        choice_h = choice.tolist()
        lp_h = self._inject_nan(lp.cpu().numpy())
        n_acc_h = n_acc.cpu().numpy()
        # the host copies above synchronize: the round's device work is done
        self._note_decode_step(t0)
        self.spec_rounds += 1
        if self.adaptive_draft:
            self._adapt_draft_k(n_acc_h[self.active])
        for i in np.nonzero(self.active)[0]:
            i = int(i)
            s = self._slots[i]
            n = int(n_acc_h[i])
            if not np.all(np.isfinite(lp_h[i, :n + 1])):
                # the plain step's quarantine: one poisoned row must not
                # take the batch down
                s.req.error = ("non-finite logits in speculative verify; request "
                               "quarantined (other slots unaffected)")
                self._finish(i, "error")
                continue
            if self.paged:  # the host mirror of the rolled-back position
                self._slot_pos[i] += n + 1
            for t in range(n + 1):
                s.remaining -= 1
                self.spec_emitted += 1
                self._emit(i, int(choice_h[i][t]), float(lp_h[i, t]))
                if not self.active[i]:  # EOS or the budget, mid-round
                    break
        return True

    def _adapt_draft_k(self, n_acc: np.ndarray) -> None:
        """Steer K along the ladder from an EMA of the rounds' acceptance
        fraction: below 0.35 down a rung, above 0.75 up one. The tokens do
        not change (speculative decoding is exact at any K); only the
        draft's share of the work does."""
        if n_acc.size == 0:
            return
        frac = float(np.mean(n_acc)) / max(self._cur_k - 1, 1)
        self._accept_ema = (frac if self._accept_ema is None
                            else 0.7 * self._accept_ema + 0.3 * frac)
        idx = self._k_ladder.index(self._cur_k)
        if self._accept_ema < 0.35 and idx > 0:
            self._cur_k = self._k_ladder[idx - 1]
            self._accept_ema = None  # measure again at the new K
        elif self._accept_ema > 0.75 and idx < len(self._k_ladder) - 1:
            self._cur_k = self._k_ladder[idx + 1]
            self._accept_ema = None

    def run_until_idle(self, max_steps: int = 100000) -> None:
        for _ in range(max_steps):
            if not self.step():
                return

    def begin_drain(self) -> None:
        """Stop admitting (new submits shed "draining") while accepted work
        keeps stepping. Thread-safe."""
        self._draining = True

    def idle(self) -> bool:
        """No accepted-but-unfinished work remains (an in-flight count,
        so a request mid-admission is not missed)."""
        with self._stat_lock:
            return self._inflight == 0

    def drain(self, timeout_s: Optional[float] = None) -> bool:
        """begin_drain, then step to completion from the calling thread.
        True when drained; False at the timeout, the unfinished requests
        left pending (a journaled engine replays them at its next start)."""
        self.begin_drain()
        deadline = None if timeout_s is None else self._clock() + timeout_s
        while not self.idle():
            if deadline is not None and self._clock() > deadline:
                return False
            self.step()
        return True

    def close(self) -> None:
        """Close the request log; flush, compact and detach the journal.
        Only after the stepping thread has stopped: compaction replaces the
        file under any live append handle. After a clean drain the journal
        holds nothing, so the next start replays nothing. Idempotent."""
        if self._request_log is not None:
            self._request_log.close()
        if self._journal is None:
            return
        from bigdl_tpu_torch.serving.journal import RequestJournal

        path = self._journal.path
        self._journal.close()
        self._journal = None
        RequestJournal.compact(path)

    def uptime_seconds(self) -> float:
        """Engine age in its own clock's seconds."""
        return max(self._clock() - self._t_start, 0.0)

    def page_leaks(self) -> int:
        """Pages whose refcount disagrees with their holders (slot block
        tables + radix nodes), plus any page neither free nor held. 0 is
        the invariant."""
        if not self.paged:
            return 0
        held = [0] * self.n_pages
        for pages in self._slot_pages:
            for pg in pages:
                held[pg] += 1
        for node in self.radix.nodes():
            held[node.page] += 1
        if self._pager is not None:
            for pg in self._pager.held_pages():
                held[pg] += 1
        return sum(1 for pg in range(1, self.n_pages)
                   if self._pool.ref[pg] != held[pg])

    def kv_utilization(self) -> float:
        """Fraction of the KV pool holding live state: allocated pages
        over the allocatable pool (paged; page 0 is scratch), or written
        positions over the row capacity (dense, a host-side estimate)."""
        if self.paged:
            cap = self.n_pages - 1
            return (cap - self._pool.n_free) / max(cap, 1)
        used = sum(min(len(s.req.prompt) + len(s.req.out_tokens), self.max_len)
                   for i, s in enumerate(self._slots)
                   if s.req is not None and self.active[i])
        return used / max(self.n_slots * self.max_len, 1)
