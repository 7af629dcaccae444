"""Causal prefill flash attention: wrapper, plain version, launch count.

Port of bigdl_tpu/ops/pallas/flash_attention.py (`flash_attention`,
`_flash`, `_kernel`), both arms: a bf16 KV cache, and float8_e5m2 codes
with one f16 scale per (slot, head) (`k_scale`/`v_scale`, the dense fp8
pool), converted tile by tile in the kernel. The CUDA source is
`csrc/flash_attention.cu`; its header note says what bounds it on the
card and what the design does about it.

Layout is the JAX package's: q [B, T, Hq, D]; k, v [B, S, Hkv, D] (the
KV-cache layout); out [B, T, Hq, D]. Query t of row b sits at cache slot
q_offset + t and attends slot j iff start[b] <= j <= q_offset + t (and
j > q_offset + t - window with a sliding window). Rows with no valid slot
(left padding) come out exactly 0.

The kernel is built for head_dim 64, 128 and 256. Any other D <= 256
that is a multiple of 16 (phi3-mini's 96, tiny-llama's 16) runs it at the
next of those widths: q, k and v are zero-padded there and the output is
sliced back, as the JAX package pads D to 128 lanes. The softmax scale
stays the true D's (the callers pass it); zero columns add nothing to
the scores. The padding costs a copy of q, k and v at the padded width
and of the output back: at phi3-mini's prefill of B=4 T=256 over S=320
slots (32 heads, D = 96 run at 128), 29.4 MB written and 22.0 MB read a
layer for q, k and v, and 6.3 MB more each way for the output, against
the 28.3 MB the kernel moves at D = 96.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from bigdl_tpu_torch.kvcache import FP8, as_bits
from bigdl_tpu_torch.ops.kernels._build import Kernel

# (q, k, v, start, out, B, T, S, Hq, Hkv, D, q_offset, scale, window, softcap)
FLASH = Kernel("flash_attention_bf16", "flash_attention", "pppppiiiiiiifif",
               replaces="bigdl_tpu/ops/pallas/flash_attention.py:49")
# the fp8 arm: (k_scale, v_scale) after v
FLASH_FP8 = Kernel("flash_attention_fp8", "flash_attention", "pppppppiiiiiiifif",
                   replaces="bigdl_tpu/ops/pallas/flash_attention.py:65")

_NEG_INF = -1e30
_HEAD_DIMS = (64, 128, 256)  # the widths the kernel is built for


def kernel_head_dim(D: int, dims: tuple = _HEAD_DIMS, who: str = "flash_attention") -> int:
    """The width the kernel runs a head_dim D at: D itself, or the next
    of `dims` for a D that is a multiple of 16 (zero-padded); raises
    NotImplementedError for a head_dim no kernel takes."""
    if D % 16 == 0 and 0 < D <= dims[-1]:
        return next(d for d in dims if d >= D)
    raise NotImplementedError(f"{who}: head_dim {D} (the kernel takes multiples of 16 up "
                              f"to {dims[-1]}; others: ROADMAP queue 2 item 1)")


def pad_head_dim(t: torch.Tensor, Dk: int) -> torch.Tensor:
    """t [..., D] zero-padded to [..., Dk] (fp8 codes through their bytes:
    code 0 is 0.0)."""
    D = t.shape[-1]
    if D == Dk:
        return t
    if t.dtype in (torch.float8_e5m2, torch.float8_e4m3fn):
        return torch.nn.functional.pad(t.view(torch.uint8), (0, Dk - D)).view(t.dtype)
    return torch.nn.functional.pad(t, (0, Dk - D))


def valid_mask(start: torch.Tensor, q_offset: int, T: int, S: int,
               window: Optional[int] = None) -> torch.Tensor:
    """[B, T, S] bool: query t of row b may attend cache slot j."""
    dev = start.device
    rows = q_offset + torch.arange(T, device=dev)[:, None]
    cols = torch.arange(S, device=dev)[None, :]
    ok = (cols <= rows)[None] & (cols[None] >= start.to(torch.long)[:, None, None])
    if window is not None:
        ok = ok & (cols > rows - window)[None]
    return ok


def flash_attention_plain(q, k, v, start, q_offset: int = 0,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          scale: Optional[float] = None,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain torch, all math in f32: fp8 K/V
    decoded as code * scale, scores (q * scale) . k, optional tanh
    softcap, -1e30 at masked slots, softmax weights exactly 0 there, rows
    without a valid slot give 0."""
    B, T, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    k, v = k.float(), v.float()
    if k_scale is not None:
        k = k * k_scale.float()[..., None]
        v = v * v_scale.float()[..., None]
    qf = (q.float() * scale).reshape(B, T, Hkv, G, D)
    s = torch.einsum("bthgd,bshd->bhgts", qf, k)
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    valid = valid_mask(start, q_offset, T, S, window)[:, None, None]
    s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgts,bshd->bhgtd", p, v)
    o = o / torch.where(l == 0, torch.ones_like(l), l)
    return o.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, D).to(q.dtype)


def _check(q, k, v, start, k_scale=None, v_scale=None) -> None:
    B, T, Hq, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if Hq % k.shape[2]:
        raise ValueError(f"flash_attention: Hq={Hq} is not a multiple of "
                         f"Hkv={k.shape[2]}")
    kernel_head_dim(D)
    kv_dtype = torch.bfloat16 if k_scale is None else FP8
    for name, t, want in (("q", q, torch.bfloat16), ("k", k, kv_dtype),
                          ("v", v, kv_dtype)):
        if t.dtype != want:
            raise TypeError(f"flash_attention: {name} must be {want}, got {t.dtype}")
        # the kernel loads q, k and v tiles 16 bytes at a time
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"tensor on {q.device} at a 16-byte aligned address")
    if k_scale is not None:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if (t is None or t.dtype != torch.float16 or t.shape != k.shape[:3]
                    or t.device != q.device or not t.is_contiguous()):
                raise ValueError(f"flash_attention: {name} must be a contiguous "
                                 f"float16 {tuple(k.shape[:3])} tensor on {q.device}")
    if (start.dtype != torch.int32 or start.shape != (B,)
            or start.device != q.device or not start.is_contiguous()):
        raise ValueError("flash_attention: start must be a contiguous int32 "
                         f"[B] tensor on {q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    start: Optional[torch.Tensor] = None, q_offset: int = 0,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal attention of q over a left-padded KV cache; returns
    [B, T, Hq, D] in q.dtype. `q_offset` is the cache slot of q[:, 0].
    With k_scale/v_scale, k/v are float8_e5m2 codes of the dense fp8
    cache and the scales its [B, S, Hkv] float16 per-vector scales."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("flash_attention: k_scale and v_scale go together")
    if k_scale is not None and k.dtype != FP8:
        raise NotImplementedError(
            f"flash_attention over {k.dtype} K/V codes: ROADMAP queue 2 "
            "item 5, only the KV cache's float8_e5m2 layout is ported")
    B, T, Hq, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if start is None:
        start = torch.zeros((B,), dtype=torch.int32, device=q.device)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, start, q_offset, window,
                                     softcap, scale, k_scale, v_scale)
    if q.device.type != "cuda":
        raise NotImplementedError(f"flash_attention: no kernel for {q.device}")
    _check(q, k, v, start, k_scale, v_scale)
    if not q.numel():
        return torch.empty_like(q)
    Dk = kernel_head_dim(D)
    q, k, v = (pad_head_dim(t, Dk) for t in (q, k, v))
    out = torch.empty_like(q)
    tail = (out, B, T, k.shape[1], Hq, k.shape[2], Dk, int(q_offset),
            float(scale), int(window or 0), float(softcap or 0.0))
    if k_scale is None:
        FLASH(q, k, v, start, *tail, device=q.device)
    else:
        FLASH_FP8(q, as_bits(k), as_bits(v), k_scale, v_scale, start, *tail,
                  device=q.device)
    return out if Dk == D else out[..., :D].contiguous()
