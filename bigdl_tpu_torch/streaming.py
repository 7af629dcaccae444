"""Attention-sink streaming: unbounded generation in a fixed cache (port
of bigdl_tpu/streaming.py, StreamingLLM's start_size/recent_size window).

The cache of `window` slots keeps the first `sink` tokens (the attention
sinks) and a rolling region of the most recent ones. Once it is full the
oldest `chunk` non-sink slots go at once: the recent region moves left by
`chunk`. Keys are stored rotated, so the moved keys are re-based by the
exact `-chunk`-step inverse rotation (rotate(k, p - c) == rotate(rotate(k,
p), -c)), with the attention scale of yarn/longrope left out (the stored
keys already carry it), in the model's convention: over the first
`rotary_dim` lanes only under partial rotary, in even/odd pairs under
`rope_interleaved`. Positions therefore never pass `window`. An
ALiBi model stores its keys unrotated (its positions are a bias over
slot distances), so its moved keys are copied as they are.

The rotation runs in float32 and rounds back to the cache's dtype once per
eviction, as the JAX package's does: a key that survives the recent region
is rounded ceil((window - sink) / chunk) times; the default chunk,
(window - sink + 7) // 8, keeps that at 8 or fewer. The port's cache is
written in place: an eviction moves the recent region within the tensors
it already has, so the memory stays that of the window.
"""

from __future__ import annotations

import dataclasses

import torch

from bigdl_tpu_torch.models.config import ModelConfig
from bigdl_tpu_torch.ops.rope import make_inv_freq_scaled, rope_cos_sin, rotate


def default_chunk(window: int, sink: int) -> int:
    return max(1, (window - sink + 7) // 8)


def validate_streaming(config: ModelConfig, window: int, sink: int, chunk: int = 1) -> None:
    if not 0 < sink < window:
        raise ValueError(f"need 0 < sink ({sink}) < window ({window})")
    if not 0 < chunk <= window - sink:
        raise ValueError(f"need 0 < chunk ({chunk}) <= window - sink ({window - sink})")
    if config.learned_positions:
        raise NotImplementedError(
            "streaming sinks need relative positions; learned absolute "
            "position embeddings (gpt2-style) cannot be re-based")
    if config.sliding_window:
        raise NotImplementedError(
            "sliding-window attention already bounds the KV span; combining "
            "it with sink eviction is not supported")
    if config.mrope_section or config.rope_local_theta is not None:
        raise NotImplementedError("streaming sinks support standard 1-D rope only")


def make_evict(config: ModelConfig, window: int, sink: int, chunk: int = 1):
    """fn(cache) -> cache that evicts the oldest `chunk` non-sink slots
    whatever the cache's fill: the recent region moves left by `chunk`,
    its keys re-rotated by -chunk steps, the freed tail zeroed, pos down
    by `chunk`. Used behind the full-cache test of `make_sink_shift` and
    by ChatSession's room-making before a turn's prefill. Under ALiBi the
    keys move without re-rotation."""
    validate_streaming(config, window, sink, chunk)
    use_rope = not config.alibi

    def evict(cache):
        if cache.k_scale is not None:
            raise NotImplementedError(
                "streaming sinks over an fp8-quantized cache would need a "
                "dequant-rotate-requant pass; use quantize_kv=False")
        if cache.rope_base is not None:
            raise NotImplementedError("streaming sinks after SnapKV compression are unsupported")
        if isinstance(cache.pos, torch.Tensor):
            raise NotImplementedError(
                "streaming sinks run on the aligned generate path (one pos for "
                "all rows), not the serving engine's per-row pool")
        S = cache.max_len
        if use_rope:
            inv_freq, _ = make_inv_freq_scaled(config.rotary_dim, config.rope_theta,
                                               config.rope_scaling_dict, seq_len=window,
                                               device=cache.k.device)
            # the -chunk-step inverse rotation; attention scale 1
            cos, sin = rope_cos_sin(torch.full((1,), -chunk, dtype=torch.int32,
                                               device=cache.k.device), inv_freq,
                                    interleaved=config.rope_interleaved)
            moved = rotate(cache.k[:, :, sink + chunk:], cos[0], sin[0],
                           config.rope_interleaved)
        else:
            moved = cache.k[:, :, sink + chunk:].clone()
        cache.k[:, :, sink:S - chunk] = moved
        cache.v[:, :, sink:S - chunk] = cache.v[:, :, sink + chunk:].clone()
        cache.k[:, :, S - chunk:] = 0
        cache.v[:, :, S - chunk:] = 0
        return dataclasses.replace(cache, pos=cache.pos - chunk)

    return evict


def make_sink_shift(config: ModelConfig, window: int, sink: int, chunk: int = 1):
    """fn(cache) -> cache that evicts the oldest `chunk` non-sink slots
    when the cache is full (pos >= window), else returns it as it is."""
    evict = make_evict(config, window, sink, chunk)

    def shift(cache):
        return evict(cache) if cache.pos >= window else cache

    return shift
