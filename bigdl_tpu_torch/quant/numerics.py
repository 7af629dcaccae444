"""Blockwise quantize/dequantize numerics in torch (port of
bigdl_tpu/quant/numerics.py).

The storage layout is the JAX package's, bit for bit: 4-bit codes pack
two per uint8 along the contraction axis in half-split order — element j
in the low nibble of byte j, element j + K/2 in its high nibble — and
block scales are float16. sym_int4 is the one format this slice covers;
every other format raises `NotImplementedError` naming its ROADMAP item.

Byte equality with the JAX encoder rests on three tie-breaks: the block
maximum keeps the FIRST element of largest magnitude (`torch.argmax`
returns the first), the inverse scale is `1 / d` multiplied in (never a
division per element), and rounding is half-to-even (`torch.round`).
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.quant.qtypes import QTypeSpec

_OTHER_FORMATS = ("ROADMAP queue 1: the other 15 weight formats are "
                  "still to be ported")


def _blocked(x: torch.Tensor, block_size: int) -> torch.Tensor:
    k = x.shape[-1]
    if k % block_size != 0:
        raise ValueError(
            f"last dim {k} not divisible by block_size {block_size}; "
            "pad the weight before quantizing"
        )
    return x.reshape(*x.shape[:-1], k // block_size, block_size)


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """[..., K] uint8 codes in [0,16) -> [..., K//2] packed uint8,
    half-split: byte j = element j (low nibble) | element j + K/2 (high)."""
    k = codes.shape[-1]
    lo = codes[..., : k // 2]
    hi = codes[..., k // 2:]
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """[..., K//2] packed uint8 -> [..., K] uint8 codes (element order)."""
    return torch.cat([packed & 0xF, packed >> 4], dim=-1)


def _signed_absmax(xb: torch.Tensor) -> torch.Tensor:
    """Per-block value with the largest magnitude, keeping its sign
    (ggml Q4_0); ties go to the first such element."""
    idx = torch.argmax(xb.abs(), dim=-1, keepdim=True)
    return torch.gather(xb, -1, idx)[..., 0]


def _safe_inv(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d == 0, torch.zeros_like(d),
                       1.0 / torch.where(d == 0, torch.ones_like(d), d))


def quantize_blockwise(x: torch.Tensor, spec: QTypeSpec) -> dict:
    """Quantize x along its last axis: dict(data=[..., K/2] uint8,
    scales=[..., K/block] float16) for sym_int4."""
    if spec.name != "sym_int4":
        raise NotImplementedError(f"quantize {spec.name}: {_OTHER_FORMATS}")
    x = x.to(torch.float32)
    xb = _blocked(x, spec.block_size)
    d = _signed_absmax(xb) / -8.0
    q = torch.clamp(torch.round(xb * _safe_inv(d)[..., None]) + 8.0, 0, 15)
    data = pack_nibbles(q.reshape(x.shape).to(torch.uint8))
    return dict(data=data, scales=d.to(torch.float16))


def dequantize_blockwise(data: torch.Tensor, scales: torch.Tensor,
                         spec: QTypeSpec,
                         dtype=torch.float32) -> torch.Tensor:
    """Inverse of quantize_blockwise: (code - 8) * scale in float32, then
    cast to `dtype`; returns [..., K]."""
    if spec.name != "sym_int4":
        raise NotImplementedError(f"dequantize {spec.name}: {_OTHER_FORMATS}")
    vals = unpack_nibbles(data).to(torch.float32) - 8.0
    y = _blocked(vals, spec.block_size) * scales.to(torch.float32)[..., None]
    return y.reshape(vals.shape).to(dtype)
