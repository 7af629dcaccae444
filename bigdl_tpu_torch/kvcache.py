"""Dense KV cache (port of bigdl_tpu/kvcache.py: the bf16 and fp8 layouts,
the per-row positions of the serving engine, row insert and swap).

The cache is preallocated at `max_len` slots: k, v [L, B, S, Hkv, D].
Batch rows are left-padded; `start[b]` is the first valid slot of row b.
`pos` is the next write slot: one Python int for the whole batch (rows
aligned — the generate path), or an int32 [B] tensor (per-row positions —
the serving engine's continuous batching, where decode writes scatter row
by row). Unlike the JAX cache, which is immutable and rebuilt by every
write, `update_layer`, `insert_row` and `swap_in_row` write into the
tensors in place: the cache is the largest activation on the card and a
copy per layer per step would double its traffic.

With `quantize_kv` k/v hold float8_e5m2 codes with one float16 scale per
(slot, head) vector (`_quantize_heads`); `read_layer` dequantizes,
`read_layer_raw` hands codes and scales to the flash kernel's fp8 arm.

SnapKV (`compress`): after a prefill, the last `window` queries of every
layer score the earlier keys; the scores, summed over the window and the
query group and average-pooled, keep the `budget - window` best prefix
slots of each kv head beside the window itself, compacted into a fresh
cache. Keys are stored rotated, so compacted slots no longer give rope
positions: `rope_base` carries each row's true next position.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.utils import resolve_device

_FP8_MAX = 57344.0  # float8_e5m2 finite max
_NEG_INF = -1e30
FP8 = torch.float8_e5m2


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # [L, B, S, Hkv, D] bf16 or float8_e5m2 codes
    v: torch.Tensor
    pos: Union[int, torch.Tensor]  # next write slot: int, or int32 [B]
    start: torch.Tensor  # [B] int32: first valid slot per row (left padding)
    k_scale: Optional[torch.Tensor] = None  # [L, B, S, Hkv] f16 when fp8
    v_scale: Optional[torch.Tensor] = None
    # [B] int32 rope position of the token written at slot `pos` where it
    # differs from pos - start: after SnapKV compression. None: derived
    rope_base: Optional[torch.Tensor] = None

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def next_positions(self, t: int) -> torch.Tensor:
        """[B, T] rope positions of the next t tokens: rope_base[b] + t
        after compression, else slot s of row b has position
        max(s - start[b], 0), so left-padded rows number their real tokens
        from 0 and decode continues them."""
        if self.rope_base is not None:
            step = torch.arange(t, dtype=torch.int32, device=self.rope_base.device)
            return self.rope_base[:, None] + step[None, :]
        return next_positions(self.pos, self.start, t)


def next_positions(pos, start: torch.Tensor, t: int) -> torch.Tensor:
    step = torch.arange(t, dtype=torch.int32, device=start.device)[None, :]
    pos = pos[:, None] if isinstance(pos, torch.Tensor) else pos
    return torch.clamp(pos + step - start[:, None], min=0)


def init_cache(n_layers: int, batch: int, max_len: int, n_kv_heads: int,
               head_dim: int, dtype=torch.bfloat16,
               quantize_kv: bool = False, device=None) -> KVCache:
    device = resolve_device(device)
    shape = (n_layers, batch, max_len, n_kv_heads, head_dim)
    ks = vs = None
    if quantize_kv:
        dtype = FP8
        ks = torch.zeros(shape[:-1], dtype=torch.float16, device=device)
        vs = torch.zeros(shape[:-1], dtype=torch.float16, device=device)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=0,
        start=torch.zeros((batch,), dtype=torch.int32, device=device),
        k_scale=ks, v_scale=vs,
    )


def _quantize_heads(x: torch.Tensor, scale_dtype=torch.float16
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., H, D] -> (float8_e5m2 codes, [..., H] scales): per-vector
    absmax / 57344. The paged pool asks for f32 scales."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / _FP8_MAX
    inv = torch.where(scale == 0, torch.zeros_like(scale),
                      1.0 / torch.where(scale == 0, torch.ones_like(scale), scale))
    return (xf * inv[..., None]).to(FP8), scale.to(scale_dtype)


def as_bits(t: torch.Tensor) -> torch.Tensor:
    """fp8 codes as their uint8 view (indexed copies work on bytes; the
    kernels take the codes as uint8), any other tensor as it is."""
    return t.view(torch.uint8) if t.dtype == FP8 else t


def _scatter_rows(buf: torch.Tensor, layer: int, pos: torch.Tensor,
                  val: torch.Tensor) -> None:
    """buf[layer, b, pos[b] + t] = val[b, t], in place; a write past the
    row's end is dropped (JAX's mode="drop"). T == 1 (decode) clamps the
    slot and writes the old value back where the write is dropped — no
    host sync; T > 1 selects the writes that land."""
    B, T = val.shape[:2]
    S = buf.shape[2]
    rows = torch.arange(B, device=buf.device)[:, None].expand(B, T)
    cols = pos.long()[:, None] + torch.arange(T, device=buf.device)[None, :]
    ok = cols < S
    buf, val = as_bits(buf), as_bits(val.to(buf.dtype))
    if T == 1:
        cols = torch.clamp(cols, max=S - 1)
        old = buf[layer, rows, cols]
        keep = ok.reshape(ok.shape + (1,) * (val.dim() - 2))
        buf[layer, rows, cols] = torch.where(keep, val, old)
    else:
        buf[layer, rows[ok], cols[ok]] = val[ok]


def update_layer(cache, layer: int, k_new: torch.Tensor,
                 v_new: torch.Tensor):
    """Write k_new/v_new [B, T, Hkv, D] into layer `layer` at pos, in
    place (quantizing for an fp8 cache). Does not advance pos (`advance`
    does, once per forward). A paged cache writes through its block
    table (kvpaged.update_layer)."""
    from bigdl_tpu_torch import kvpaged

    if isinstance(cache, kvpaged.PagedKVCache):
        return kvpaged.update_layer(cache, layer, k_new, v_new)
    writes = [(cache.k, k_new), (cache.v, v_new)]
    if cache.quantized:
        (kq, ks), (vq, vs) = _quantize_heads(k_new), _quantize_heads(v_new)
        writes = [(cache.k, kq), (cache.v, vq), (cache.k_scale, ks),
                  (cache.v_scale, vs)]
    if isinstance(cache.pos, torch.Tensor):
        for buf, val in writes:
            _scatter_rows(buf, layer, cache.pos, val)
        return cache
    T = k_new.shape[1]
    if cache.pos + T > cache.max_len:
        raise ValueError(f"KV cache full: pos {cache.pos} + {T} > {cache.max_len}")
    for buf, val in writes:
        buf[layer, :, cache.pos:cache.pos + T] = val.to(buf.dtype)
    return cache


def read_layer(cache, layer: int, dtype=torch.bfloat16
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full [B, S, Hkv, D] k/v of one layer: views into a bf16 cache, or
    dequantized to `dtype` (code * scale in f32) from an fp8 one. A paged
    cache gathers its rows' pages (kvpaged.read_layer)."""
    from bigdl_tpu_torch import kvpaged

    if isinstance(cache, kvpaged.PagedKVCache):
        return kvpaged.read_layer(cache, layer, dtype)
    k, v = cache.k[layer], cache.v[layer]
    if not cache.quantized:
        return k, v
    k = k.float() * cache.k_scale[layer].float()[..., None]
    v = v.float() * cache.v_scale[layer].float()[..., None]
    return k.to(dtype), v.to(dtype)


def read_layer_raw(cache: KVCache, layer: int):
    """One layer's k/v without dequantization: ([B, S, Hkv, D] codes,
    [B, S, Hkv] f16 scales or None) — the flash kernel dequantizes fp8
    tiles itself, so the cache never exists as a dense bf16 copy."""
    if not cache.quantized:
        return cache.k[layer], cache.v[layer], None, None
    return (cache.k[layer], cache.v[layer], cache.k_scale[layer],
            cache.v_scale[layer])


def advance(cache, n: int):
    """The cache with pos (and rope_base, where set) moved on by n."""
    rope_base = getattr(cache, "rope_base", None)
    if rope_base is None:
        return dataclasses.replace(cache, pos=cache.pos + n)
    return dataclasses.replace(cache, pos=cache.pos + n, rope_base=rope_base + n)


def insert_row(cache: KVCache, pcache: KVCache, slot: int, pad: int) -> KVCache:
    """Copy a 1-row prefill cache into row `slot` of a per-row-pos pool,
    in place: k/v (and fp8 scales) land at slots [0, bucket); the row's
    pos/start become (bucket, pad)."""
    bucket = pcache.k.shape[2]
    cache.k[:, slot, :bucket] = pcache.k[:, 0]
    cache.v[:, slot, :bucket] = pcache.v[:, 0]
    if cache.quantized:
        cache.k_scale[:, slot, :bucket] = pcache.k_scale[:, 0]
        cache.v_scale[:, slot, :bucket] = pcache.v_scale[:, 0]
    cache.pos[slot] = bucket
    cache.start[slot] = pad
    return cache


def swap_out_row(cache: KVCache, slot: int, n: Optional[int] = None):
    """Copy one pool row's first `n` slots (every layer; None = the whole
    row) to host RAM — the dense half of serving preemption. Returns
    (k, v, k_scale | None, v_scale | None) CPU tensors in the cache's
    dtypes: byte-preserving, so swap-in and decode are bit-exact."""
    n = cache.max_len if n is None else n
    out = [cache.k[:, slot, :n].cpu(), cache.v[:, slot, :n].cpu(), None, None]
    if cache.quantized:
        out[2] = cache.k_scale[:, slot, :n].cpu()
        out[3] = cache.v_scale[:, slot, :n].cpu()
    return tuple(out)


def swap_in_row(cache: KVCache, k, v, k_scale, v_scale, slot: int, pos: int,
                start: int) -> KVCache:
    """Write a swapped-out row back into the first k.shape[1] slots of row
    `slot` (any free row; the stale tail is masked as insert_row leaves
    it) and restore its pos/start, in place."""
    n = k.shape[1]
    cache.k[:, slot, :n] = k.to(cache.k.device)
    cache.v[:, slot, :n] = v.to(cache.v.device)
    if cache.quantized:
        cache.k_scale[:, slot, :n] = k_scale.to(cache.k_scale.device)
        cache.v_scale[:, slot, :n] = v_scale.to(cache.v_scale.device)
    cache.pos[slot] = pos
    cache.start[slot] = start
    return cache


# ---------------------------------------------------------------------------
# SnapKV compression (port of bigdl_tpu/kvcache.py:291-427)
# ---------------------------------------------------------------------------

def _avg_pool_1d(x: torch.Tensor, kernel: int) -> torch.Tensor:
    """Mean pool with 'same' padding over the last axis (zeros beyond the
    ends count in the mean, as JAX's reduce_window sum / kernel)."""
    if kernel <= 1:
        return x
    pad = kernel // 2
    windows = F.pad(x, (pad, kernel - 1 - pad)).unfold(-1, kernel, 1)
    return windows.sum(-1) / kernel


def snapkv_select(vote: torch.Tensor, prefix: torch.Tensor, keep_k: int) -> torch.Tensor:
    """The slots [B, Hkv, keep_k] SnapKV keeps from pooled votes [B, Hkv,
    S]: the keep_k largest (equal votes lower slot first: XLA's TopK order,
    which torch.topk does not promise), in slot order after the picks off
    the prefix (`prefix` [B, S] bool), which go first, left of the new
    start (a stable sort keeps their order too, as JAX's argsort does)."""
    idx = torch.sort(vote, dim=-1, descending=True, stable=True).indices[..., :keep_k]
    valid = torch.gather(prefix[:, None, :].expand(vote.shape), -1, idx)
    perm = torch.argsort(torch.where(valid, idx, -1), dim=-1, stable=True)
    return torch.gather(idx, -1, perm)


def snapkv_prefix(start: torch.Tensor, pos: int, window: int, S: int) -> torch.Tensor:
    """[B, S] bool: the slots SnapKV scores, each row's valid slots before
    the observation window [pos - window, pos)."""
    sj = torch.arange(S, device=start.device)
    return (sj[None, :] >= start.to(torch.long)[:, None]) & (sj[None, :] < pos - window)


def snapkv_votes(k: torch.Tensor, k_scale: Optional[torch.Tensor], q_obs: torch.Tensor,
                 prefix: torch.Tensor, kernel: int) -> torch.Tensor:
    """One layer's pooled votes [B, Hkv, S] (f32): the softmax scores of
    the observation queries q_obs [B, W, Hq, D] over the prefix slots
    (`prefix` [B, S] bool) of k [B, S, Hkv, D] (fp8 codes dequantized with
    k_scale), summed over the window and the query group, average-pooled
    over `kernel` slots; -1e30 off the prefix."""
    B, S, Hkv, D = k.shape
    W, Hq = q_obs.shape[1], q_obs.shape[2]
    kf = k.float()
    if k_scale is not None:
        kf = kf * k_scale.float()[..., None]
    qg = q_obs.float().reshape(B, W, Hkv, Hq // Hkv, D)
    scores = torch.einsum("bwhgd,bshd->bhgws", qg, kf) * (1.0 / D ** 0.5)
    del kf
    pm = prefix[:, None, None, None, :]
    scores = scores.masked_fill(~pm, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).masked_fill(~pm, 0.0)
    del scores
    vote = _avg_pool_1d(probs.sum(dim=(2, 3)), kernel)
    return vote.masked_fill(~prefix[:, None, :], _NEG_INF)


def compress(cache: KVCache, q_obs: torch.Tensor, budget: int, out_len: int,
             window: int = 32, kernel: int = 7) -> KVCache:
    """SnapKV: keep, per kv head, the `budget - window` prefix slots with
    the largest pooled votes (`snapkv_votes`) in their order, then the
    `window` observation slots, compacted into a fresh cache of `out_len`
    slots (budget plus decode room). q_obs [L, B, W, Hq, D] holds each
    layer's last W rotated queries (`models.llama.forward(collect_obs=W)`).
    Works a layer at a time, so the f32 scores stay at 1/L of the cache;
    an fp8 cache keeps its codes and scales (the votes dequantize). Slots
    picked past a row's prefix go left of the new `start`, which masks
    them. Returns a cache with pos = budget, start = keep_k - kept +
    (pad slots inside the window) and rope_base = the row's next
    position."""
    L, B, S, Hkv, D = cache.k.shape
    W = q_obs.shape[2]
    keep_k = budget - W
    if keep_k <= 0:
        raise ValueError(f"budget {budget} must exceed the observation window {W}")
    if isinstance(cache.pos, torch.Tensor):
        raise ValueError("compress expects an aligned cache (one pos for all rows)")
    P = cache.pos
    start = cache.start.to(torch.long)
    obs_start = P - W
    prefix = snapkv_prefix(cache.start, P, W, S)

    fields = [cache.k, cache.v] + ([cache.k_scale, cache.v_scale] if cache.quantized else [])
    out = [torch.zeros((L, B, out_len) + f.shape[3:], dtype=f.dtype, device=f.device)
           for f in fields]
    for layer in range(L):
        vote = snapkv_votes(cache.k[layer], cache.k_scale[layer] if cache.quantized else None,
                            q_obs[layer], prefix, kernel)
        idx = snapkv_select(vote, prefix, keep_k)  # [B, Hkv, keep_k]
        for src, dst in zip(fields, out):
            x = as_bits(src[layer])  # [B, S, Hkv, *feat]
            xt = x.movedim(2, 1)  # [B, Hkv, S, *feat]
            ix = idx.reshape(idx.shape + (1,) * (xt.dim() - 3)).expand(
                idx.shape + xt.shape[3:])
            sel = torch.gather(xt, 2, ix).movedim(1, 2)  # [B, keep_k, Hkv, *feat]
            d = as_bits(dst[layer])
            d[:, :keep_k] = sel
            d[:, keep_k:budget] = x[:, obs_start:P]
    avail = torch.clamp(obs_start - start, min=0)
    kept = torch.clamp(avail, max=keep_k)
    pad_in_obs = torch.clamp(start - obs_start, min=0)
    new = KVCache(k=out[0], v=out[1], pos=budget,
                  start=(keep_k - kept + pad_in_obs).to(torch.int32),
                  rope_base=torch.clamp(P - start, min=0).to(torch.int32))
    if cache.quantized:
        new.k_scale, new.v_scale = out[2], out[3]
    return new
