"""Generation: prefill, then a decode loop (port of bigdl_tpu/generate.py).

The JAX package compiles prefill and the whole decode loop into one XLA
program (`lax.while_loop`); here the loop is Python over eager launches
and sampling draws from an explicit `torch.Generator`. Prompts are
left-padded to a power-of-two bucket, as in JAX. The per-row sampler and
the repetition penalty (`sample_token_per_row`, `apply_repetition_penalty`)
serve the serving engine as well. Two cache policies ride on the loop:
SnapKV compresses the prompt's cache after the prefill
(`kvcache.compress`), and attention-sink streaming evicts the oldest
non-sink slots before a decode step that finds the cache full
(`streaming.make_sink_shift`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch import kvcache
from bigdl_tpu_torch.models import llama
from bigdl_tpu_torch.models.config import ModelConfig
from bigdl_tpu_torch.utils import cache_len_for


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 32
    do_sample: bool = False
    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    repetition_penalty: float = 1.0  # HF semantics: >1 discourages repeats
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0


def apply_repetition_penalty(logits: torch.Tensor, seen: torch.Tensor,
                             penalty) -> torch.Tensor:
    """HF RepetitionPenaltyLogitsProcessor semantics: the logits of seen
    tokens ([B, V] bool) divide by the penalty where positive and multiply
    where negative. `penalty` is a float or a [B] tensor."""
    p = torch.as_tensor(penalty, dtype=logits.dtype, device=logits.device)
    if p.dim() == 1:
        p = p[:, None]
    penalized = torch.where(logits < 0, logits * p, logits / p)
    return torch.where(seen, penalized, logits)


def seen_from_prompt(tokens: torch.Tensor, start: torch.Tensor,
                     vocab: int) -> torch.Tensor:
    """[B, V] bool presence mask over the real (non-pad) prompt tokens."""
    B, T = tokens.shape
    real = torch.arange(T, device=tokens.device)[None, :] >= start[:, None]
    idx = torch.where(real, tokens.long(), vocab)  # pads land in the overflow bin
    seen = torch.zeros((B, vocab + 1), dtype=torch.bool, device=tokens.device)
    seen.scatter_(1, idx, True)
    return seen[:, :vocab]


def filter_logits_per_row(logits: torch.Tensor, temperature: torch.Tensor,
                          top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Temperature, top-k (<= 0 disables), then top-p (>= 1 disables) over
    the top-k-filtered distribution, with per-row [B] parameters over
    logits [B, ..., V] (the middle axes broadcast: a speculative verify
    passes [B, K, V]); returns scaled logits with -inf outside the
    support, whose softmax is the sampling distribution."""
    V = logits.shape[-1]
    exp = (slice(None),) + (None,) * (logits.dim() - 1)
    lt = logits / torch.clamp(temperature, min=1e-5)[exp]
    sorted_desc = torch.sort(lt, dim=-1, descending=True).values
    kidx = torch.clamp(top_k.long() - 1, 0, V - 1)[exp].expand(lt.shape[:-1] + (1,))
    kth = torch.gather(sorted_desc, -1, kidx)
    neg_inf = torch.full_like(lt, float("-inf"))
    lt_k = torch.where((top_k > 0)[exp] & (lt < kth), neg_inf, lt)
    sorted_k = torch.sort(lt_k, dim=-1, descending=True).values
    probs = torch.softmax(sorted_k, dim=-1)
    cum = torch.cumsum(probs, dim=-1) - probs
    cutoff_idx = torch.sum(cum < top_p[exp], dim=-1, keepdim=True) - 1
    cutoff = torch.gather(sorted_k, -1, torch.clamp(cutoff_idx, 0, V - 1))
    return torch.where((top_p < 1.0)[exp] & (lt_k < cutoff), neg_inf, lt_k)


def sample_token_per_row(logits: torch.Tensor, generator: Optional[torch.Generator],
                         temperature: torch.Tensor, top_k: torch.Tensor,
                         top_p: torch.Tensor, do_sample: np.ndarray) -> torch.Tensor:
    """Per-row sampling, every row with its own temperature / top-k /
    top-p ([B] tensors on the logits' device): rows with do_sample False
    (a host [B] bool array) take the argmax, the others one draw from
    their filtered distribution. An all-greedy batch — the serving
    engine's common case — skips the full-vocabulary sorts; the host
    array decides that without a device sync."""
    greedy = torch.argmax(logits, dim=-1)
    if not np.any(do_sample):
        return greedy
    probs = torch.softmax(filter_logits_per_row(logits, temperature, top_k, top_p), -1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    rows = torch.as_tensor(np.asarray(do_sample, bool), device=logits.device)
    return torch.where(rows, sampled, greedy)


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                 gen: GenerationConfig) -> torch.Tensor:
    """logits [B, V] float32 -> [B] int64 token ids: argmax when greedy,
    else temperature, top-k, then top-p (over the top-k-filtered
    distribution) and one draw from `generator`."""
    if not gen.do_sample:
        return torch.argmax(logits, dim=-1)
    logits = logits / max(gen.temperature, 1e-5)
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    if gen.top_k is not None:
        kth = torch.topk(logits, gen.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg_inf, logits)
    if gen.top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1) - probs
        cutoff_idx = torch.sum(cum < gen.top_p, dim=-1, keepdim=True) - 1
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, neg_inf, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def pad_prompts(prompts: Sequence[Sequence[int]], pad_id: int,
                bucket: Optional[int] = None) -> tuple[np.ndarray, np.ndarray]:
    """Left-pad a ragged batch to a power-of-two bucket (at least 16).
    Returns (tokens [B, T], start [B]); start[b] is the row's pad count,
    so every row's last prompt token sits at index T-1."""
    maxlen = max(len(p) for p in prompts)
    if bucket is None:
        bucket = 16
        while bucket < maxlen:
            bucket *= 2
    if bucket < maxlen:
        raise ValueError(f"bucket {bucket} shorter than the longest prompt {maxlen}")
    tokens = np.full((len(prompts), bucket), pad_id, np.int32)
    start = np.zeros((len(prompts),), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, bucket - len(p):] = np.asarray(p, np.int32)
        start[i] = bucket - len(p)
    return tokens, start


@torch.inference_mode()
def generate_tokens(config: ModelConfig, params, tokens: torch.Tensor,
                    start: torch.Tensor, generator: Optional[torch.Generator],
                    gen: GenerationConfig, cache_len: int,
                    last_logits: bool = True,
                    quantize_kv: bool = False, compress_budget: int = 0,
                    compress_window: int = 32, compress_kernel: int = 7,
                    streaming: Optional[tuple] = None) -> torch.Tensor:
    """Prefill + decode loop. tokens [B, T] left-padded, start [B] int32,
    both on the model's device. Returns [B, max_new_tokens] generated ids
    (pad_token_id after a row's EOS); stops early once every row hit EOS.
    With a repetition penalty the prompt's real tokens and every emitted
    id (the pad after EOS too, as in JAX) count as seen. `quantize_kv`
    keeps the KV cache as float8_e5m2 codes with f16 scales.

    compress_budget > 0: SnapKV compresses the prompt's cache to that many
    slots after the prefill (observation window `compress_window`, pooling
    `compress_kernel`) and the decode runs on a cache of
    cache_len_for(budget, max_new_tokens) slots. streaming = (sink, window)
    or (sink, window, chunk): the cache is `window` slots (cache_len) and
    the oldest `chunk` non-sink slots go before each decode step that
    finds it full, so max_new_tokens may exceed it.
    """
    B, T = tokens.shape
    shift = None
    if streaming is not None:
        from bigdl_tpu_torch.streaming import default_chunk, make_sink_shift

        sink, window = streaming[:2]
        chunk = streaming[2] if len(streaming) > 2 else default_chunk(window, sink)
        if cache_len != window or cache_len <= T:
            raise ValueError(f"streaming: cache_len {cache_len} must be the window "
                             f"{window} and exceed the prompt {T}")
        if quantize_kv or compress_budget:
            raise ValueError("streaming takes neither quantize_kv nor compress_budget")
        shift = make_sink_shift(config, window, sink, chunk)
    elif cache_len < T + gen.max_new_tokens:
        raise ValueError(f"cache_len {cache_len} < {T} + {gen.max_new_tokens}")
    if compress_budget and compress_budget <= compress_window:
        raise ValueError(f"compress_budget {compress_budget} must exceed the window "
                         f"{compress_window}")
    cache = kvcache.init_cache(
        config.num_hidden_layers, B, cache_len, config.num_key_value_heads,
        config.head_dim_, quantize_kv=quantize_kv, device=tokens.device)
    cache = dataclasses.replace(cache, start=start)
    tokens = tokens.long()
    use_rep = gen.repetition_penalty != 1.0
    seen = seen_from_prompt(tokens, start, config.vocab_size) if use_rep else None
    rows = torch.arange(B, device=tokens.device)

    def next_token(logits):
        if use_rep:
            logits = apply_repetition_penalty(logits, seen, gen.repetition_penalty)
        return sample_token(logits, generator, gen)

    if compress_budget:
        logits, cache, obs = llama.forward(config, params, tokens, cache, mode="prefill",
                                           last_logits_only=last_logits,
                                           collect_obs=compress_window)
        cache = kvcache.compress(cache, obs, compress_budget,
                                 cache_len_for(compress_budget, gen.max_new_tokens),
                                 window=compress_window, kernel=compress_kernel)
        del obs
    else:
        logits, cache = llama.forward(config, params, tokens, cache,
                                      mode="prefill", last_logits_only=last_logits)
    cur = next_token(logits[:, -1])
    out = torch.full((B, gen.max_new_tokens), gen.pad_token_id,
                     dtype=torch.long, device=tokens.device)
    out[:, 0] = cur
    eos = gen.eos_token_id
    done = cur == eos if eos is not None else None
    for i in range(1, gen.max_new_tokens):
        if done is not None and bool(done.all()):
            break
        if use_rep:
            seen[rows, cur] = True
        if shift is not None:
            cache = shift(cache)
        logits, cache = llama.forward(config, params, cur[:, None], cache,
                                      mode="decode")
        cur = next_token(logits[:, -1])
        if done is not None:
            cur = torch.where(done, torch.full_like(cur, gen.pad_token_id), cur)
            done = done | (cur == eos)
        out[:, i] = cur
    return out
