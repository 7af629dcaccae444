"""Dense KV cache (port of bigdl_tpu/kvcache.py for the bf16 layout).

The cache is preallocated at `max_len` slots: k, v [L, B, S, Hkv, D].
Batch rows are left-padded; `start[b]` is the first valid slot of row b.
`pos` is the next write slot, one Python int for the whole batch (rows
aligned — the generate path). Unlike the JAX cache, which is immutable
and rebuilt by every write, `update_layer` writes into the tensors in
place: the cache is the largest activation on the card and a copy per
layer per step would double its traffic. fp8 KV (`quantize_kv`) raises
until ported.
"""

from __future__ import annotations

import dataclasses

import torch

from bigdl_tpu_torch.utils import resolve_device


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # [L, B, S, Hkv, D]
    v: torch.Tensor
    pos: int  # next write slot (rows aligned)
    start: torch.Tensor  # [B] int32: first valid slot per row (left padding)

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    def next_positions(self, t: int) -> torch.Tensor:
        """[B, T] rope positions of the next t tokens: slot s of row b has
        position max(s - start[b], 0), so left-padded rows number their
        real tokens from 0 and decode continues them."""
        step = torch.arange(t, dtype=torch.int32, device=self.start.device)
        return torch.clamp(self.pos + step[None, :] - self.start[:, None], min=0)


def init_cache(n_layers: int, batch: int, max_len: int, n_kv_heads: int,
               head_dim: int, dtype=torch.bfloat16,
               quantize_kv: bool = False, device=None) -> KVCache:
    if quantize_kv:
        raise NotImplementedError(
            "quantize_kv (fp8 KV cache): ROADMAP queue 1, the fp8 KV cache "
            "and the flash kernel's fp8 variant are still to be ported")
    device = resolve_device(device)
    shape = (n_layers, batch, max_len, n_kv_heads, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=0,
        start=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def update_layer(cache: KVCache, layer: int, k_new: torch.Tensor,
                 v_new: torch.Tensor) -> KVCache:
    """Write k_new/v_new [B, T, Hkv, D] into layer `layer` at slots
    [pos, pos + T), in place. Does not advance pos (`advance` does, once
    per forward)."""
    T = k_new.shape[1]
    if cache.pos + T > cache.max_len:
        raise ValueError(f"KV cache full: pos {cache.pos} + {T} > {cache.max_len}")
    cache.k[layer, :, cache.pos:cache.pos + T] = k_new.to(cache.k.dtype)
    cache.v[layer, :, cache.pos:cache.pos + T] = v_new.to(cache.v.dtype)
    return cache


def read_layer(cache: KVCache, layer: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Full [B, S, Hkv, D] k/v of one layer (views into the cache)."""
    return cache.k[layer], cache.v[layer]


def advance(cache: KVCache, n: int) -> KVCache:
    return dataclasses.replace(cache, pos=cache.pos + n)
