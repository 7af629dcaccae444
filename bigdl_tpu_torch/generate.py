"""Generation: prefill, then a decode loop (port of bigdl_tpu/generate.py).

The JAX package compiles prefill and the whole decode loop into one XLA
program (`lax.while_loop`); here the loop is Python over eager launches
and sampling draws from an explicit `torch.Generator`. Prompts are
left-padded to a power-of-two bucket, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch import kvcache
from bigdl_tpu_torch.models import llama
from bigdl_tpu_torch.models.config import ModelConfig


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
                    last_logits: bool = True) -> torch.Tensor:
    """Prefill + decode loop. tokens [B, T] left-padded, start [B] int32,
    both on the model's device. Returns [B, max_new_tokens] generated ids
    (pad_token_id after a row's EOS); stops early once every row hit EOS.
    """
    if gen.repetition_penalty != 1.0:
        raise NotImplementedError(
            "repetition_penalty: ROADMAP queue 1, the repetition penalty is "
            "still to be ported")
    B, T = tokens.shape
    if cache_len < T + gen.max_new_tokens:
        raise ValueError(f"cache_len {cache_len} < {T} + {gen.max_new_tokens}")
    cache = kvcache.init_cache(
        config.num_hidden_layers, B, cache_len, config.num_key_value_heads,
        config.head_dim_, device=tokens.device)
    cache = dataclasses.replace(cache, start=start)
    tokens = tokens.long()

    logits, cache = llama.forward(config, params, tokens, cache,
                                  mode="prefill", last_logits_only=last_logits)
    cur = sample_token(logits[:, -1], generator, gen)
    out = torch.full((B, gen.max_new_tokens), gen.pad_token_id,
                     dtype=torch.long, device=tokens.device)
    out[:, 0] = cur
    eos = gen.eos_token_id
    done = cur == eos if eos is not None else None
    for i in range(1, gen.max_new_tokens):
        if done is not None and bool(done.all()):
            break
        logits, cache = llama.forward(config, params, cur[:, None], cache,
                                      mode="decode")
        cur = sample_token(logits[:, -1], generator, gen)
        if done is not None:
            cur = torch.where(done, torch.full_like(cur, gen.pad_token_id), cur)
            done = done | (cur == eos)
        out[:, i] = cur
    return out
