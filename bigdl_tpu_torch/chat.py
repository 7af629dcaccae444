"""Incremental multi-turn chat sessions (port of bigdl_tpu/chat.py).

A ChatSession keeps one row's KV cache alive across turns: each `send`
prefills only the new tokens, right-padded to a power-of-two bucket (at
least 16), then decodes token by token. The padded queries' K/V land in
slots [pos + n, pos + bucket), which the causal mask hides and later writes
overwrite; pos then moves back to the last real token + 1.

With `streaming=(sink, window[, chunk])` the cache is a fixed attention-sink
window (`streaming.py`): before each prefill the session evicts whole
chunks, then the exact remainder, until the bucket fits (the exact turn
length where the bucket itself cannot), and before each decode step the
full-cache shift applies, so the conversation runs in constant memory.

Incremental prefill gives the same cache contents and rope positions as a
prefill of the whole transcript, but on the card not the same bits: a
turn's flash prefill at q_offset = pos sums in another order than a
one-shot prefill's tiles. Replies agree with a one-shot `generate` to the
logits' rounding, and token for token where the top-1/top-2 margin clears
it.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch import kvcache
from bigdl_tpu_torch.generate import GenerationConfig, sample_token
from bigdl_tpu_torch.models import llama

_MIN_BUCKET = 16


def _bucket(n: int) -> int:
    b = _MIN_BUCKET
    while b < n:
        b *= 2
    return b


class ChatSession:
    def __init__(self, model, max_len: int = 2048, streaming: Optional[tuple] = None,
                 compute_dtype=torch.bfloat16):
        """model: a TorchModel; the cache lives on its device."""
        self.model = model
        self.config = model.config
        self._dtype = compute_dtype
        self._shift = None
        self._evicts: Optional[dict] = None  # evict size -> fn; None: bounded session
        self._sink = self._chunk = 0
        if streaming is not None:
            from bigdl_tpu_torch.streaming import default_chunk, make_sink_shift

            sink, window = streaming[:2]
            chunk = streaming[2] if len(streaming) > 2 else default_chunk(window, sink)
            max_len = window
            self._sink, self._chunk = sink, chunk
            self._evicts = {}
            self._shift = make_sink_shift(self.config, window, sink, chunk)
        self.max_len = max_len
        self.reset()

    @property
    def pos(self) -> int:
        return self.cache.pos

    def reset(self) -> None:
        """Drop the conversation."""
        self.cache = kvcache.init_cache(
            self.config.num_hidden_layers, 1, self.max_len,
            self.config.num_key_value_heads, self.config.head_dim_,
            device=self.model.device)

    def _evict_by(self, m: int):
        """The m-slot evict, one per distinct m (the chunk, or an exact
        remainder smaller than it)."""
        if m not in self._evicts:
            from bigdl_tpu_torch.streaming import make_evict

            self._evicts[m] = make_evict(self.config, self.max_len, self._sink, m)
        return self._evicts[m]

    def _make_room(self, n: int) -> None:
        if self.pos + n <= self.max_len:
            return
        if self._evicts is None:
            raise ValueError(
                f"conversation ({self.pos} + {n} new tokens) exceeds "
                f"max_len={self.max_len}; start the session with "
                "streaming=(sink, window) for unbounded chats")
        if self._sink + n > self.max_len:
            raise ValueError(
                f"a single turn of {n} tokens cannot fit the streaming "
                f"window ({self.max_len}, sink {self._sink})")
        while self.pos + n > self.max_len:
            avail = self.pos - self._sink  # evictable non-sink tokens
            need = self.pos + n - self.max_len
            m = min(self._chunk if need >= self._chunk else need, avail)
            self.cache = self._evict_by(m)(self.cache)

    @torch.inference_mode()
    def _prefill(self, ids: Sequence[int]) -> torch.Tensor:
        """Append `ids` to the cache; returns the last real token's logits
        [V] (float32). The turn runs at its bucket's length, or at its own
        where the bucket cannot fit the window."""
        n = len(ids)
        b = _bucket(n)
        if self._evicts is None:
            self._make_room(n)
        else:
            self._make_room(b if self._sink + b <= self.max_len else n)
        if self.pos + b > self.max_len:
            b = n
        padded = np.zeros((1, b), np.int64)
        padded[0, :n] = np.asarray(ids, np.int64)
        pos0 = self.pos
        logits, cache = llama.forward(
            self.config, self.model.params,
            torch.as_tensor(padded, device=self.model.device), self.cache,
            mode="prefill", compute_dtype=self._dtype, last_logits_only=False)
        self.cache = dataclasses.replace(cache, pos=pos0 + n)
        return logits[0, n - 1]

    @torch.inference_mode()
    def _decode(self, tok: int) -> torch.Tensor:
        logits, self.cache = llama.forward(
            self.config, self.model.params,
            torch.tensor([[tok]], device=self.model.device), self.cache,
            mode="decode", compute_dtype=self._dtype)
        return logits[0, -1]

    def send_stream(self, ids: Sequence[int], max_new_tokens: int = 128,
                    eos_token_id: Optional[int] = None, temperature: float = 0.0,
                    top_k: Optional[int] = None, top_p: Optional[float] = None,
                    seed: int = 0) -> Iterator[int]:
        """Prefill this turn's tokens, then yield the reply's ids one by one
        (greedy at temperature 0, else sampled from a torch.Generator seeded
        with seed + the turn's first position). Every yielded id enters the
        cache, an EOS too, so the next send needs only the next message."""
        if len(ids) == 0:
            raise ValueError("empty turn")
        bad = next((t for t in ids if not 0 <= t < self.config.vocab_size), None)
        if bad is not None:
            raise ValueError(
                f"token id {bad} outside [0, {self.config.vocab_size}) — "
                "wrong tokenizer for this model?")
        gen = GenerationConfig(do_sample=temperature > 0,
                               temperature=max(temperature, 1e-5), top_k=top_k, top_p=top_p)
        generator = None
        if gen.do_sample:
            generator = torch.Generator(device=self.model.device).manual_seed(seed + self.pos)

        def pick(lg):
            return int(sample_token(lg[None].float(), generator, gen)[0])

        tok = pick(self._prefill(ids))
        for _ in range(max_new_tokens):
            if self._shift is not None:
                self.cache = self._shift(self.cache)
            elif self.pos >= self.max_len:
                raise ValueError(
                    f"conversation exceeds max_len={self.max_len}; use "
                    "streaming=(sink, window) for unbounded chats")
            yield tok
            # the decode step commits tok's K/V, an EOS too: the next turn's
            # context must hold the whole transcript
            lg = self._decode(tok)
            if eos_token_id is not None and tok == eos_token_id:
                return
            tok = pick(lg)

    def send(self, ids: Sequence[int], max_new_tokens: int = 128,
             eos_token_id: Optional[int] = None, **kw) -> list[int]:
        return list(self.send_stream(ids, max_new_tokens, eos_token_id, **kw))
