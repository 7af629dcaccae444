"""One-token decode attention over a paged KV pool: wrapper, plain version,
launch counts.

Port of bigdl_tpu/ops/pallas/paged_attention.py (`paged_decode_attention`,
`_kernel`), bf16 pages and float8_e5m2 pages with f32 per-(slot, head)
scales. The CUDA source is `csrc/paged_attention.cu`; its header note
says what bounds it on the card and what the design does about it.

Layout is the JAX package's: q [B, Hq, D] (the current token's queries);
k, v [L, NP, page, Hkv, D] — the whole pool, the layer picked by `layer`;
block_tables [B, max_pages] int32; pos [B] the slot holding the current
token, start [B] the first valid slot. Slot j of row b is attended iff
start[b] <= j <= pos[b] (and j > pos[b] - window with a sliding window);
a row with no valid slot comes out exactly 0. Returns [B, Hq, D] bf16.

The kernel splits each row's live slots into chunks, one block each
(flash-decoding); `split_chunk` picks the chunk size from the launch's
shape and `split_plan` is the cut the kernel makes on the card, in plain
Python for the tests. The partials and the per-(row, kv head) ticket
counters live in a workspace the wrapper keeps per device and stream.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from bigdl_tpu_torch.kvcache import FP8, as_bits
from bigdl_tpu_torch.ops.kernels._build import Kernel, sm_count, workspace
from bigdl_tpu_torch.ops.kernels.qtile import SMS

_REPLACES = "bigdl_tpu/ops/pallas/paged_attention.py:42"
# (q, k, v, block_tables, pos, start, out, part_o, part_ml, tickets, B,
#  Hq, Hkv, D, NP, page, max_pages, layer, window, softcap, chunk, nmax,
#  q_f32, scale)
PAGED = Kernel("paged_attention_bf16", "paged_attention", "ppppppppppiiiiiiiiifiiif",
               replaces=_REPLACES)
# the same with (k_scale, v_scale) after v
PAGED_FP8 = Kernel("paged_attention_fp8", "paged_attention", "ppppppppppppiiiiiiiiifiiif",
                   replaces=_REPLACES)

_NEG_INF = -1e30
# phi-2's 80 and phi3-mini's 96 are instantiations of their own: padding
# the pool each step would move every live slot's bytes again
_HEAD_DIMS = (64, 80, 96, 128, 256)
_MAX_GROUP = 16  # query heads per kv head: 4 warps, up to 4 heads each

SPLIT_TILE = 32  # slots a stage of the kernel's ring (csrc/paged_attention.cu kTile)
SPLIT_CHUNKS = (256, 128, 64)  # chunk sizes, largest first: multiples of the tile


def split_chunk(B: int, Hkv: int, cap: int, sms: int = SMS) -> int:
    """Slots a block of the kernel takes: the largest of SPLIT_CHUNKS at
    which a pool of `cap` slots a row (max_pages * page) gives at least
    three blocks an SM over B rows and Hkv kv heads, else the smallest.
    Rows hold fewer live slots than their capacity, so three blocks an SM
    over the capacity leave two waves at two thirds full: at the serving
    engine's decode shape (8 rows, 8 kv heads, 2048 slots) 256, and ~320
    blocks at ~1,160 live slots a row."""
    for c in SPLIT_CHUNKS:
        if B * Hkv * -(-cap // c) >= 3 * sms:
            return c
    return SPLIT_CHUNKS[-1]


def max_chunks(cap: int, chunk: int, window: Optional[int] = None) -> int:
    """The most chunks a row of `cap` slots can be cut into (the grid's
    chunk axis): a window of w slots spans at most (w - 1) // chunk + 2."""
    n = -(-cap // chunk)
    return min(n, (window - 1) // chunk + 2) if window else n


def live_range(pos: int, start: int, cap: int, window: Optional[int] = None) -> tuple[int, int]:
    """A row's attended slots [lo, hi], as the kernel computes them (lo >
    hi: none)."""
    hi = min(pos, cap - 1)
    lo = max(start, 0)
    if window:
        lo = max(lo, pos - window + 1)
    return lo, hi


def split_plan(lo: int, hi: int, chunk: int) -> list[tuple[int, int]]:
    """The kernel's cut of live slots [lo, hi] into chunks aligned to
    multiples of `chunk`: [(first slot, last slot)] in chunk order; none
    for an empty range."""
    if lo > hi:
        return []
    return [(max(lo, c * chunk), min(hi, (c + 1) * chunk - 1))
            for c in range(lo // chunk, hi // chunk + 1)]


def _decoded(pool: torch.Tensor, scale: Optional[torch.Tensor], layer: int,
             bt: torch.Tensor) -> torch.Tensor:
    """Row b's pages of one layer as f32 [B, max_pages * page, Hkv, D]:
    bf16 values, or fp8 codes times their f32 scales."""
    x = as_bits(pool[layer])[bt].view(pool.dtype).float()
    if scale is not None:
        x = x * scale[layer][bt].float()[..., None]
    B, mp, page = x.shape[:3]
    return x.reshape(B, mp * page, *x.shape[3:])


def paged_attention_plain(q, k_pages, v_pages, block_tables, layer: int, pos,
                          start, k_scale=None, v_scale=None,
                          scale: Optional[float] = None,
                          softcap: Optional[float] = None,
                          window: Optional[int] = None) -> torch.Tensor:
    """The kernel's function in plain torch, all math in f32: gather the
    rows' pages (decoding fp8), scores (q * scale) . k, optional tanh
    softcap, -1e30 at masked slots, softmax weights exactly 0 there, rows
    without a valid slot give 0."""
    B, Hq, D = q.shape
    Hkv = k_pages.shape[3]
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    bt = block_tables.long()
    k = _decoded(k_pages, k_scale, layer, bt)
    v = _decoded(v_pages, v_scale, layer, bt)
    qf = (q.float() * scale).reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bshd->bhgs", qf, k)
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    j = torch.arange(k.shape[1], device=q.device)[None, :]
    p_, st = pos.long()[:, None], start.long()[:, None]
    valid = (j >= st) & (j <= p_)
    if window is not None:
        valid = valid & (j > p_ - window)
    valid = valid[:, None, None]
    s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgs,bshd->bhgd", p, v)
    o = o / torch.where(l == 0, torch.ones_like(l), l)
    return o.reshape(B, Hq, D).to(torch.bfloat16)


def _check(q, k_pages, v_pages, block_tables, pos, start, k_scale, v_scale) -> None:
    B, Hq, D = q.shape
    if (k_pages.dim() != 5 or k_pages.shape != v_pages.shape
            or k_pages.shape[4] != D):
        raise ValueError(f"paged_attention: q {tuple(q.shape)}, pool "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)} do not match")
    Hkv = k_pages.shape[3]
    if Hq % Hkv or Hq // Hkv > _MAX_GROUP:
        raise NotImplementedError(f"paged_attention: Hq={Hq} over Hkv={Hkv} (the "
                                  f"kernel takes groups of 1..{_MAX_GROUP} heads; "
                                  "others: ROADMAP queue 2 item 1)")
    if D not in _HEAD_DIMS:
        raise NotImplementedError(f"paged_attention: head_dim {D} (the kernel "
                                  f"takes {_HEAD_DIMS}; others: ROADMAP queue 2 item 1)")
    want = FP8 if k_scale is not None else torch.bfloat16
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != want:
            raise TypeError(f"paged_attention: {name} must be {want}, got {t.dtype}")
    tensors = [("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
               ("block_tables", block_tables), ("pos", pos), ("start", start)]
    if k_scale is not None:
        if v_scale is None:
            raise ValueError("paged_attention: k_scale without v_scale")
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            if s.dtype != torch.float32 or s.shape != k_pages.shape[:4]:
                raise ValueError(f"paged_attention: {name} must be f32 "
                                 f"{tuple(k_pages.shape[:4])}")
            tensors.append((name, s))
    for name, t in tensors:
        # the pages are read 16 bytes at a time
        align = 16 if name in ("k_pages", "v_pages") else 4
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"paged_attention: {name} must be a contiguous, "
                             f"{align}-byte aligned tensor on {q.device}")
    for name, t, shape in (("block_tables", block_tables, (B, block_tables.shape[-1])),
                           ("pos", pos, (B,)), ("start", start, (B,))):
        if t.dtype != torch.int32 or t.shape != shape:
            raise ValueError(f"paged_attention: {name} must be int32 {shape}")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                    block_tables: torch.Tensor, layer: int, pos: torch.Tensor,
                    start: torch.Tensor, k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None,
                    softcap: Optional[float] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Decode attention of q [B, Hq, D] over each row's pages, read in
    place; returns [B, Hq, D] bf16. fp8 pages come with k_scale/v_scale."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, block_tables, layer,
                                     pos, start, k_scale, v_scale, scale,
                                     softcap, window)
    if q.device.type != "cuda":
        raise NotImplementedError(f"paged_attention: no kernel for {q.device}")
    _check(q, k_pages, v_pages, block_tables, pos, start, k_scale, v_scale)
    B, Hq, D = q.shape
    L, NP, page, Hkv, _ = k_pages.shape
    if not 0 <= layer < L:
        raise ValueError(f"paged_attention: layer {layer} outside [0, {L})")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    # the kernel scales the query in f32 as it loads it, as JAX does
    qs = q if q.dtype in (torch.bfloat16, torch.float32) else q.float()
    out = torch.empty((B, Hq, D), dtype=torch.bfloat16, device=q.device)
    if not out.numel():
        return out
    mp = block_tables.shape[1]
    chunk = split_chunk(B, Hkv, mp * page, sm_count(q.device.index or 0))
    nmax = max_chunks(mp * page, chunk, window)
    G = Hq // Hkv
    floats = B * Hkv * nmax * G * (D + 2)
    buf, tickets = workspace(q.device, 4 * floats, B * Hkv)
    part = buf[:4 * floats].view(torch.float32)
    part_o, part_ml = part[:B * Hkv * nmax * G * D], part[B * Hkv * nmax * G * D:]
    tail = (B, Hq, Hkv, D, NP, page, mp, int(layer), int(window or 0),
            float(softcap or 0.0), chunk, nmax, int(qs.dtype == torch.float32), float(scale))
    if k_scale is None:
        PAGED(qs, k_pages, v_pages, block_tables, pos, start, out, part_o, part_ml,
              tickets, *tail, device=q.device)
    else:
        PAGED_FP8(qs, as_bits(k_pages), as_bits(v_pages), k_scale, v_scale,
                  block_tables, pos, start, out, part_o, part_ml, tickets, *tail,
                  device=q.device)
    return out
