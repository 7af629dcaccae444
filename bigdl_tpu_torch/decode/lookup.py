"""Prompt-lookup (n-gram) decoding (port of bigdl_tpu/decode/lookup.py).

The reference's `PromptLookupCandidateGenerator` and `lookup_generate`
(ipex-llm lookup.py:145-457): the candidates are the tokens that
followed the most recent earlier occurrence of the history's trailing
n-gram (longest n first), which pays off where the output quotes the
input (summaries, RAG); one target forward verifies them, with no draft
model. The JAX package matches n-grams with a vectorized compare inside
its while_loop; here the history is a host array (each round brings the
target's choices to the host anyway) and the same search runs in numpy.
Acceptance and the crop are `decode.speculative`'s (cap K-1, crop = pos
reset), and emitted tokens are the target's choices, so greedy tokens
are plain greedy generation's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch.decode.speculative import _init_cache, mask_after_eos, model_device
from bigdl_tpu_torch.generate import GenerationConfig, pad_prompts, sample_token
from bigdl_tpu_torch.models import llama
from bigdl_tpu_torch.models.config import ModelConfig
from bigdl_tpu_torch.utils import cache_len_for, flags


def _find_candidate(hist: np.ndarray, hist_len: int, row_start: int, n: int,
                    k: int) -> Optional[np.ndarray]:
    """The k tokens after the most recent earlier occurrence of the
    trailing n-gram of hist[:hist_len], or None. An occurrence starts at
    a real token (>= row_start), is not the trailing n-gram itself, and
    has a continuation inside the history."""
    last = hist[hist_len - n:hist_len]
    for p in range(hist_len - n - 1, row_start - 1, -1):
        if np.array_equal(hist[p:p + n], last):
            return hist[p + n:p + n + k]
    return None


@torch.inference_mode()
def lookup_tokens(config: ModelConfig, params, tokens: torch.Tensor, start: torch.Tensor,
                  generator: Optional[torch.Generator], gen: GenerationConfig,
                  cache_len: int, lookahead: int = 4, max_ngram: int = 3,
                  quantize_kv: bool = False, rounds: Optional[list] = None
                  ) -> tuple[torch.Tensor, int, int]:
    """tokens [1, T] left-padded, start [1], on the model's device.
    Returns (out [1, max_new_tokens], n_rounds, n_matched). A round with
    no n-gram match verifies zero candidates and emits the bonus token
    only (a plain decode step at T = K). `rounds`, where given, gets one
    (candidates or None, target choices, n_acc) a round."""
    B, T = tokens.shape
    if B != 1:
        raise ValueError("lookup decoding is batch-1 (as the reference)")
    K = lookahead
    if K < 2:
        raise ValueError(f"lookahead must be >= 2, got {K}")
    max_new = gen.max_new_tokens
    if cache_len < T + max_new + K + 1:
        raise ValueError(f"cache_len {cache_len} < {T} + {max_new} + {K} + 1")
    tokens = tokens.long()
    cache = _init_cache(config, B, cache_len, start, quantize_kv)
    logits, cache = llama.forward(config, params, tokens, cache, mode="prefill",
                                  last_logits_only=flags.last_lm_head_default())
    cur = sample_token(logits[:, -1], generator, gen)
    del logits
    row_start = int(start[0])
    # the history: the padded prompt, then every emitted token
    hist = np.zeros((T + max_new + K + 1,), np.int64)
    hist[:T] = tokens[0].tolist()
    out = [int(cur[0])]
    hist[T] = out[0]
    hist_len = T + 1
    eos = gen.eos_token_id
    done = eos is not None and out[0] == eos
    n_rounds = n_matched = 0
    dev = tokens.device
    while len(out) < max_new and not done:
        cand = None
        for n in range(max_ngram, 0, -1):  # the longest n-gram that matches
            cand = _find_candidate(hist, hist_len, row_start, n, K - 1)
            if cand is not None:
                break
        drafts = np.zeros((K - 1,), np.int64) if cand is None else cand
        verify_in = torch.cat([cur[:, None], torch.as_tensor(drafts, device=dev)[None]], dim=1)
        tlogits, cache = llama.forward(config, params, verify_in, cache, mode="prefill")
        choice = torch.stack([sample_token(tlogits[:, i], generator, gen)
                              for i in range(K)], dim=1)  # [1, K]
        del tlogits
        ch = choice[0].tolist()
        n_acc = 0
        if cand is not None:
            while n_acc < K - 1 and int(drafts[n_acc]) == ch[n_acc]:
                n_acc += 1
        emitted = ch[:n_acc + 1]
        out += emitted
        if rounds is not None:
            rounds.append((None if cand is None else [int(x) for x in cand], ch, n_acc))
        hist[hist_len:hist_len + n_acc + 1] = emitted
        hist_len += n_acc + 1
        cur = choice[:, n_acc]
        cache = dataclasses.replace(cache, pos=cache.pos - K + n_acc + 1)
        if eos is not None and eos in emitted:
            done = True
        n_rounds += 1
        n_matched += n_acc
    out = out[:max_new] + [gen.pad_token_id] * (max_new - min(len(out), max_new))
    return torch.tensor([out], dtype=torch.long, device=dev), n_rounds, n_matched


def lookup_generate(config: ModelConfig, params, prompts, max_new_tokens: int = 32,
                    lookahead: int = 4, max_ngram: int = 3, do_sample: bool = False,
                    temperature: float = 1.0, top_k: Optional[int] = None,
                    top_p: Optional[float] = None, eos_token_id: Optional[int] = None,
                    pad_token_id: int = 0, seed: int = 0, quantize_kv: bool = False,
                    stats: Optional[dict] = None) -> np.ndarray:
    """The host entry point of `lookup_generate` (lookup.py:274) on the
    model's device: returns [1, max_new_tokens] ids, pad after EOS.
    `stats`, where given, gets n_rounds, n_matched and `rounds`
    (lookup_tokens')."""
    tokens, start = pad_prompts(prompts, pad_token_id)
    gen = GenerationConfig(max_new_tokens=max_new_tokens, do_sample=do_sample,
                           temperature=temperature, top_k=top_k, top_p=top_p,
                           eos_token_id=eos_token_id, pad_token_id=pad_token_id)
    dev = model_device(params)
    generator = torch.Generator(device=dev).manual_seed(seed) if do_sample else None
    rounds = None if stats is None else []
    out, n_rounds, n_matched = lookup_tokens(
        config, params, torch.as_tensor(tokens, device=dev), torch.as_tensor(start, device=dev),
        generator, gen, cache_len=cache_len_for(tokens.shape[1], max_new_tokens + lookahead + 1),
        lookahead=lookahead, max_ngram=max_ngram, quantize_kv=quantize_kv, rounds=rounds)
    if stats is not None:
        stats.update(n_rounds=n_rounds, n_matched=n_matched, rounds=rounds)
    return mask_after_eos(out.cpu().numpy().astype(np.int32), eos_token_id, pad_token_id)
