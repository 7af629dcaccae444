"""Paged KV cache: block tables over a shared physical page pool (port of
bigdl_tpu/kvpaged.py).

- `k`/`v` [L, n_pages, page_size, Hkv, D]: one physical pool, bf16 or
  float8_e5m2 codes with f32 [L, n_pages, page_size, Hkv] scales;
- `block_tables` [B, max_pages] int32 map each row's logical page to a
  physical page (entries past a row's allocation may hold anything:
  attention masks slots past `pos`, and the engine allocates before it
  writes);
- writes scatter through the table, in place; decode attention reads the
  pages where they lie (`ops.kernels.paged_attention`), and `read_layer`
  gathers a dense [B, S, Hkv, D] view for the other cached calls (the
  engine's paged prefill).

Pages are allocated on demand and refcounted (`PagePool`); physical page
0 is the scratch sink that idle slots write into. The host-RAM swap
(`swap_out_pages` / `swap_in_pages`) backs serving preemption.
`AdapterPageStore` frames LoRA adapter weights in pages drawn from the same
`PagePool` (the serving engine's unified adapter paging).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from bigdl_tpu_torch.kvcache import FP8, _quantize_heads, as_bits, next_positions
from bigdl_tpu_torch.utils import resolve_device


@dataclasses.dataclass
class PagedKVCache:
    k: torch.Tensor  # [L, n_pages, page_size, Hkv, D] bf16 or float8_e5m2
    v: torch.Tensor
    block_tables: torch.Tensor  # [B, max_pages] int32 physical page ids
    pos: torch.Tensor  # [B] int32 next logical slot per row
    start: torch.Tensor  # [B] int32 first valid slot (left padding)
    k_scale: Optional[torch.Tensor] = None  # [L, n_pages, page_size, Hkv] f32
    v_scale: Optional[torch.Tensor] = None

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def max_len(self) -> int:  # logical capacity per row
        return self.block_tables.shape[1] * self.page_size

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def next_positions(self, t: int) -> torch.Tensor:
        return next_positions(self.pos, self.start, t)


def init_paged(n_layers: int, n_pages: int, page_size: int, n_kv_heads: int,
               head_dim: int, batch: int, max_pages_per_row: int,
               dtype=torch.bfloat16, quantize_kv: bool = False,
               device=None) -> PagedKVCache:
    device = resolve_device(device)
    shape = (n_layers, n_pages, page_size, n_kv_heads, head_dim)
    ks = vs = None
    if quantize_kv:
        dtype = FP8
        ks = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
        vs = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
    zeros_i32 = dict(dtype=torch.int32, device=device)
    return PagedKVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        block_tables=torch.zeros((batch, max_pages_per_row), **zeros_i32),
        pos=torch.zeros((batch,), **zeros_i32),
        start=torch.zeros((batch,), **zeros_i32),
        k_scale=ks, v_scale=vs,
    )


# ---------------------------------------------------------------------------
# Host-side page accounting (serving/engine.py + serving/radix.py)
# ---------------------------------------------------------------------------


class PagePool:
    """Refcounted free-list accounting for the physical pages of a
    PagedKVCache. Physical page 0 is the reserved scratch sink and is
    never allocatable. Every holder of a page carries exactly one
    reference — each slot block-table entry, and each radix prefix-cache
    node — and a page returns to the free list exactly when its count
    reaches 0. The free list pops from its end, as the JAX pool does, so
    the same admissions get the same physical pages."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self.free = list(range(1, n_pages))  # page 0 = scratch
        self.ref = [0] * n_pages

    def alloc(self) -> Optional[int]:
        """A free page with its first reference, or None when dry."""
        if not self.free:
            return None
        pg = self.free.pop()
        self.ref[pg] = 1
        return pg

    def incref(self, pg: int) -> None:
        self.ref[pg] += 1

    def decref(self, pg: int) -> int:
        """Drop one hold; a count reaching 0 frees the page. A negative
        count (a double release) raises at the faulty site."""
        n = self.ref[pg] = self.ref[pg] - 1
        if n < 0:
            raise AssertionError(f"page {pg} refcount went negative")
        if n == 0:
            self.free.append(pg)
        return n

    @property
    def n_free(self) -> int:
        return len(self.free)


def kv_page_nbytes(cache: PagedKVCache) -> int:
    """Bytes of one physical page across every layer (K + V + fp8 scales)."""
    L, _, page, Hkv, D = cache.k.shape
    n = 2 * L * page * Hkv * D * cache.k.element_size()
    if cache.quantized:
        n += 2 * L * page * Hkv * cache.k_scale.element_size()
    return n


class AdapterPageStore:
    """Device residency for LoRA adapter weights, page-framed so that its
    page ids come from the same `PagePool` as KV: every adapter page here
    is one KV page the radix cache and the slots cannot hold, one device
    budget. One flat bf16 buffer `buf` [n_pages, page_elems], page_elems
    the bf16 count whose bytes match one KV page (`kv_page_nbytes`) — as
    the JAX store, a second buffer the size of the KV pool. Ownership
    (holds, LRU, eviction) lives in `serving.adapters.AdapterPager`."""

    def __init__(self, n_pages: int, page_nbytes: int, device=None):
        self.page_elems = max(page_nbytes // 2, 1)
        self.buf = torch.zeros((n_pages, self.page_elems), dtype=torch.bfloat16,
                               device=resolve_device(device))

    def n_for(self, n_elems: int) -> int:
        """Pages needed to hold `n_elems` bf16 elements."""
        return -(-int(n_elems) // self.page_elems)

    def write(self, pages, flat: torch.Tensor) -> None:
        """Scatter a flat vector (rounded to bf16, zero-padded to the page
        frame) into physical pages `pages`, in place."""
        n = len(pages) * self.page_elems
        v = torch.zeros((n,), dtype=torch.bfloat16, device=self.buf.device)
        v[: flat.numel()] = flat.reshape(-1).to(device=self.buf.device, dtype=torch.bfloat16)
        ids = torch.as_tensor(list(pages), dtype=torch.long, device=self.buf.device)
        self.buf.index_copy_(0, ids, v.view(len(pages), self.page_elems))

    def read(self, pages, n_elems: int) -> torch.Tensor:
        """The leading `n_elems` of the pages' flat vector, on the device."""
        ids = torch.as_tensor(list(pages), dtype=torch.long, device=self.buf.device)
        return self.buf.index_select(0, ids).reshape(-1)[:n_elems]


# ---------------------------------------------------------------------------
# Host-RAM page swap (serving preemption)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HostKVPages:
    """A preempted request's KV pages parked in host RAM (all layers,
    page-granular), byte-preserving: decode after the swap-in into any
    physical pages is bit-exact with the uninterrupted run."""

    k: torch.Tensor  # [L, n, page, Hkv, D] in the pool dtype, on the CPU
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None  # [L, n, page, Hkv] when fp8
    v_scale: Optional[torch.Tensor] = None

    @property
    def n_pages(self) -> int:
        return self.k.shape[1]

    @property
    def nbytes(self) -> int:
        ts = [self.k, self.v] + ([self.k_scale, self.v_scale]
                                 if self.k_scale is not None else [])
        return sum(t.numel() * t.element_size() for t in ts)


def _pool_tensors(cache: PagedKVCache) -> list[torch.Tensor]:
    ts = [cache.k, cache.v]
    if cache.quantized:
        ts += [cache.k_scale, cache.v_scale]
    return ts


def swap_out_pages(cache: PagedKVCache, pages) -> HostKVPages:
    """Copy the listed physical pages' KV (every layer) to host RAM."""
    ids = torch.as_tensor(list(pages), dtype=torch.long, device=cache.k.device)
    return HostKVPages(*[as_bits(t).index_select(1, ids).cpu().view(t.dtype)
                         for t in _pool_tensors(cache)])


def swap_in_pages(cache: PagedKVCache, blob: HostKVPages, pages) -> PagedKVCache:
    """Write a host blob's pages back into physical pages `pages` (need
    not be those it came from), in place."""
    ids = torch.as_tensor(list(pages), dtype=torch.long, device=cache.k.device)
    srcs = [blob.k, blob.v] + ([blob.k_scale, blob.v_scale]
                               if cache.quantized else [])
    for dst, src in zip(_pool_tensors(cache), srcs):
        as_bits(dst).index_copy_(1, ids, as_bits(src).to(dst.device))
    return cache


def copy_page(cache: PagedKVCache, src: int, dst: int) -> PagedKVCache:
    """Duplicate one physical page's KV (all layers) into another, in
    place — the engine's sub-page prefix-sharing copy."""
    for t in _pool_tensors(cache):
        t[:, dst] = t[:, src]
    return cache


def _slots(cache: PagedKVCache, T: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(physical page, offset) [B, T] of each row's next T logical slots.
    A slot past the block table lands on the scratch page 0 (the JAX pool
    drops such a write; no engine path makes one)."""
    page = cache.page_size
    s = cache.pos.long()[:, None] + torch.arange(T, device=cache.pos.device)[None, :]
    pg = s // page
    mp = cache.block_tables.shape[1]
    phys = torch.gather(cache.block_tables.long(), 1, pg.clamp(max=mp - 1))
    return torch.where(pg < mp, phys, torch.zeros_like(phys)), s % page


def update_layer(cache: PagedKVCache, layer: int, k_new: torch.Tensor,
                 v_new: torch.Tensor) -> PagedKVCache:
    """Write k_new/v_new [B, T, Hkv, D] at each row's pos through the
    block table, in place. Does not advance pos."""
    phys, off = _slots(cache, k_new.shape[1])
    if cache.quantized:
        (kq, ks), (vq, vs) = (_quantize_heads(k_new, torch.float32),
                              _quantize_heads(v_new, torch.float32))
        writes = [(cache.k, kq), (cache.v, vq), (cache.k_scale, ks),
                  (cache.v_scale, vs)]
    else:
        writes = [(cache.k, k_new), (cache.v, v_new)]
    for buf, val in writes:
        as_bits(buf)[layer, phys, off] = as_bits(val.to(buf.dtype))
    return cache


def read_layer(cache: PagedKVCache, layer: int, dtype=torch.bfloat16
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather one layer's pages into the dense [B, S, Hkv, D] view,
    dequantizing fp8 pages (code * scale in f32)."""
    bt = cache.block_tables.long()
    B, mp = bt.shape
    k, v = as_bits(cache.k[layer])[bt], as_bits(cache.v[layer])[bt]
    k, v = k.view(cache.k.dtype), v.view(cache.v.dtype)
    if cache.quantized:
        k = k.float() * cache.k_scale[layer][bt][..., None]
        v = v.float() * cache.v_scale[layer][bt][..., None]
    S = mp * cache.page_size
    return (k.reshape(B, S, *k.shape[3:]).to(dtype),
            v.reshape(B, S, *v.shape[3:]).to(dtype))
