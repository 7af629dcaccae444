"""Blockwise quantize/dequantize numerics in torch (port of
bigdl_tpu/quant/numerics.py, with the k-quant encoders of
bigdl_tpu/quant/kquants.py + kq_planar.py folded in).

The storage layout is the JAX package's, bit for bit, for all 16 formats:

- 4-bit codes pack two per uint8 along the contraction axis in half-split
  order (element j in the low nibble of byte j, element j + K/2 in its
  high nibble); `pack_planes` is the multi-split generalization (fp6 =
  4+2 bit planes, sym_int5 and q5_k 4+1, nf3 2+1, q2_k one 2-bit plane);
- int8 codes (sym_int8, asym_int5, the centered q3_k/q6_k codes) are
  int8; fp8 codes are torch's float8_e4m3fn / float8_e5m2;
- single-level scales and mins are float16 per block; the planar
  k-quants hold f16 super-scales d (and dmin) per 256 elements in
  `scales` (`mins`) and integer sub-scales per 16 or 32 elements in
  `sub_scales` (`sub_mins`): uint8 for q2/q4/q5_k, int8 for q3/q6_k.

Byte equality with the JAX encoders rests on these tie-breaks:

- a signed block maximum keeps the FIRST element of largest magnitude
  (`torch.argmax` returns the first);
- inverse scales are `1 / d` multiplied in, never a division per element;
- rounding is half-to-even (`torch.round`, as np.round and jnp.round);
- the codebook encode is a left-sided `searchsorted` over float32
  midpoints computed by the same numpy expression as JAX's;
- the k-quant encoders (JAX: numpy on the host, llama.cpp's block codec,
  then a planar repack) run here in torch on the weight's own device and
  write the planar fields directly, with every float32 operation in
  kquants.py's order: the codes come from the f32 super-scale d, while
  the stored scale is f16(d); a sub-block minimum is clamped to <= 0 as
  np.minimum does it (-0.0 becomes +0.0).

f32 -> fp8 conversion is torch's `.to(float8_*)`: round to nearest even,
as XLA's convert, on every value the encoder produces (the tests hold the
bytes equal).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from bigdl_tpu_torch.quant.qtypes import QTypeSpec, resolve_qtype

_FP8_MAX = {"fp8_e4m3": 448.0, "fp8_e5m2": 57344.0}
FP8_DTYPE = {"fp8_e4m3": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2}
QK_K = 256


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


def pack_planes(codes: torch.Tensor, planes: tuple) -> torch.Tensor:
    """[..., K] uint8 codes -> concatenated bit planes (uint8). A b-bit
    plane over K elements is K*b/8 bytes where byte j carries elements
    j + m*(K*b/8) at bit offset b*m; `planes` lists the planes' widths,
    low bits of the code first."""
    k = codes.shape[-1]
    codes = codes.to(torch.uint8)
    shift = 0
    outs = []
    for bits in planes:
        s = 8 // bits
        q = k // s
        sub = (codes >> shift) & ((1 << bits) - 1)
        acc = sub[..., :q].clone()
        for m in range(1, s):
            acc |= sub[..., m * q:(m + 1) * q] << (bits * m)
        outs.append(acc)
        shift += bits
    return torch.cat(outs, dim=-1)


def unpack_planes(data: torch.Tensor, planes: tuple, k: int) -> torch.Tensor:
    """Inverse of pack_planes: concatenated planes -> [..., K] uint8."""
    off = 0
    shift = 0
    code = None
    for bits in planes:
        s = 8 // bits
        q = k // s
        plane = data[..., off:off + q]
        part = torch.cat([(plane >> (bits * m)) & ((1 << bits) - 1)
                          for m in range(s)], dim=-1) << shift
        code = part if code is None else code | part
        off += q
        shift += bits
    return code


def _signed_absmax(xb: torch.Tensor) -> torch.Tensor:
    """Per-block value with the largest magnitude, keeping its sign
    (ggml Q4_0); ties go to the first such element."""
    idx = torch.argmax(xb.abs(), dim=-1, keepdim=True)
    return torch.gather(xb, -1, idx)[..., 0]


def _div(t: torch.Tensor, c: float) -> torch.Tensor:
    """t / c, rounded as an IEEE division on every device (numpy's): CUDA
    divides a tensor by a Python number as a product with its reciprocal,
    which can differ in the last bit, so the divisor goes as a tensor."""
    return t / torch.tensor(c, dtype=t.dtype, device=t.device)


def _safe_inv(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d == 0, torch.zeros_like(d),
                       1.0 / torch.where(d == 0, torch.ones_like(d), d))


@functools.lru_cache(maxsize=None)
def _codebook_tables(qtype_name: str):
    """(sorted-order permutation, decision boundaries) as numpy, by the
    JAX package's expression."""
    cb = resolve_qtype(qtype_name).codebook
    order = np.argsort(cb)
    sorted_cb = cb[order]
    boundaries = (sorted_cb[1:] + sorted_cb[:-1]) / 2.0
    return order.astype(np.int64), boundaries


def _store_codes(codes: torch.Tensor, spec: QTypeSpec) -> torch.Tensor:
    if spec.storage == "packed_u8":
        return pack_nibbles(codes.to(torch.uint8))
    if spec.storage == "packed_planes":
        return pack_planes(codes.to(torch.uint8), spec.planes)
    return codes.to(torch.int8)


def quantize_blockwise(x: torch.Tensor, spec: QTypeSpec) -> dict:
    """Quantize x along its last axis. Returns the QTensor array fields:
    data/scales, + mins for asymmetric single-level formats, + the
    planar k-quants' mins/sub_scales/sub_mins."""
    x = x.to(torch.float32)
    name = spec.name

    if spec.superblock:
        return _KQUANT_ENCODERS[name](x)

    xb = _blocked(x, spec.block_size)

    if spec.storage.startswith("fp8"):
        scale = _div(xb.abs().amax(-1), _FP8_MAX[name])
        q = (xb * _safe_inv(scale)[..., None]).to(FP8_DTYPE[name])
        return dict(data=q.reshape(x.shape), scales=scale.to(torch.float16))

    if spec.codebook is not None:
        order, boundaries = _codebook_tables(name)
        cb_max = float(np.max(np.abs(spec.codebook)))
        scale = _div(xb.abs().amax(-1), cb_max)
        xn = (xb * _safe_inv(scale)[..., None]).contiguous()
        idx = torch.searchsorted(torch.from_numpy(boundaries).to(x.device), xn)
        codes = torch.from_numpy(order).to(x.device)[idx].reshape(x.shape)
        return dict(data=_store_codes(codes, spec),
                    scales=scale.to(torch.float16))

    if name in ("sym_int4", "sym_int5"):
        n = 8.0 if name == "sym_int4" else 16.0
        d = _div(_signed_absmax(xb), -n)
        q = torch.clamp(torch.round(xb * _safe_inv(d)[..., None]) + n,
                        0, 2 * n - 1)
        return dict(data=_store_codes(q.reshape(x.shape), spec),
                    scales=d.to(torch.float16))

    if name in ("asym_int4", "asym_int5"):
        qmax = 15.0 if name == "asym_int4" else 31.0
        mins = xb.amin(-1)
        d = _div(xb.amax(-1) - mins, qmax)
        q = torch.clamp(torch.round((xb - mins[..., None]) * _safe_inv(d)[..., None]),
                        0, qmax)
        return dict(data=_store_codes(q.reshape(x.shape), spec),
                    scales=d.to(torch.float16), mins=mins.to(torch.float16))

    if name == "sym_int8":
        d = _div(xb.abs().amax(-1), 127.0)
        q = torch.clamp(torch.round(xb * _safe_inv(d)[..., None]), -127, 127)
        return dict(data=q.reshape(x.shape).to(torch.int8),
                    scales=d.to(torch.float16))

    raise ValueError(f"quantize: qtype {name} is not a quantized format")


# ---------------------------------------------------------------------------
# k-quants: two-level scales, encoded straight to the planar fields
# ---------------------------------------------------------------------------

def _superblocks(x: torch.Tensor, sub: int) -> torch.Tensor:
    """[..., K] -> [n, 256 // sub, sub] (K % 256 == 0)."""
    if x.shape[-1] % QK_K:
        raise ValueError(f"k-quant: last dim {x.shape[-1]} is not a multiple of {QK_K}")
    return x.reshape(-1, QK_K // sub, sub)


def _two_level_sym(x: torch.Tensor, qmax: int, sub_max: int) -> dict:
    """q6_k (qmax 32, sub_max 127) and q3_k (4, 31): signed-absmax
    sub-scales s = smax / -qmax, super-scale d = max|s| / sub_max,
    integer sc = round(s / d), codes round(x / (d * sc))."""
    lead, k = x.shape[:-1], x.shape[-1]
    xb = _superblocks(x, 16)
    s = _div(_signed_absmax(xb), -float(qmax))
    d = _div(s.abs().amax(-1), float(sub_max))
    sc = torch.clamp(torch.round(s * _safe_inv(d)[:, None]),
                     -128 if sub_max == 127 else -32, sub_max)
    eff = d[:, None] * sc
    q = torch.clamp(torch.round(xb * _safe_inv(eff)[..., None]), -qmax, qmax - 1)
    return dict(data=q.reshape(*lead, k).to(torch.int8),
                scales=d.to(torch.float16).reshape(*lead, k // QK_K),
                sub_scales=sc.to(torch.int8).reshape(*lead, k // 16))


def _two_level_asym(x: torch.Tensor, sub: int, qmax: int, spec: QTypeSpec,
                    sub_max: int = 63) -> dict:
    """q2_k (sub 16, qmax 3, sub_max 15), q4_k (32, 15) and q5_k (32,
    31): per-sub-block (scale, min) quantized to sub_max-code integers
    under the super-scales d and dmin (kquants._two_level_asym_scales)."""
    lead, k = x.shape[:-1], x.shape[-1]
    xb = _superblocks(x, sub)
    lo = xb.amin(-1)
    mins = torch.where(lo < 0, lo, torch.zeros_like(lo))  # np.minimum(lo, 0.0)
    scales = _div(xb.amax(-1) - mins, float(qmax))
    d = _div(scales.amax(-1), float(sub_max))
    dmin = _div((-mins).amax(-1), float(sub_max))
    sc = torch.clamp(torch.round(scales * _safe_inv(d)[:, None]), 0, sub_max)
    mn = torch.clamp(torch.round(-mins * _safe_inv(dmin)[:, None]), 0, sub_max)
    eff_s = d[:, None] * sc
    eff_m = dmin[:, None] * mn
    q = torch.clamp(torch.round((xb + eff_m[..., None]) * _safe_inv(eff_s)[..., None]),
                    0, qmax)
    return dict(data=_store_codes(q.reshape(*lead, k), spec),
                scales=d.to(torch.float16).reshape(*lead, k // QK_K),
                mins=dmin.to(torch.float16).reshape(*lead, k // QK_K),
                sub_scales=sc.to(torch.uint8).reshape(*lead, k // sub),
                sub_mins=mn.to(torch.uint8).reshape(*lead, k // sub))


_KQUANT_ENCODERS = {
    "q2_k": lambda x: _two_level_asym(x, 16, 3, resolve_qtype("q2_k"), sub_max=15),
    "q3_k": lambda x: _two_level_sym(x, 4, 31),
    "q4_k": lambda x: _two_level_asym(x, 32, 15, resolve_qtype("q4_k")),
    "q5_k": lambda x: _two_level_asym(x, 32, 31, resolve_qtype("q5_k")),
    "q6_k": lambda x: _two_level_sym(x, 32, 127),
}


def kq_effective_scales(scales: torch.Tensor,
                        sub_scales: torch.Tensor) -> torch.Tensor:
    """Per-sub-block f32 effective scale d*sc of a planar k-quant (exact:
    an f16 times an integer of at most 8 bits fits f32)."""
    reps = sub_scales.shape[-1] // scales.shape[-1]
    return (torch.repeat_interleave(scales.to(torch.float32), reps, dim=-1)
            * sub_scales.to(torch.float32))


def codes_of(data: torch.Tensor, spec: QTypeSpec) -> torch.Tensor:
    """The stored codes in element order ([..., K]): nibbles and planes
    unpacked, int8 and fp8 codes as they are."""
    if spec.storage == "packed_u8":
        return unpack_nibbles(data)
    if spec.storage == "packed_planes":
        return unpack_planes(data, spec.planes, data.shape[-1] * 8 // spec.bits)
    return data


def dequantize_blockwise(data: torch.Tensor, scales: torch.Tensor,
                         mins: torch.Tensor | None, spec: QTypeSpec,
                         dtype=torch.float32,
                         sub_scales: torch.Tensor | None = None,
                         sub_mins: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse of quantize_blockwise in JAX's f32 arithmetic, then cast to
    `dtype`; returns [..., K]. Single-level: w = v * d (+ m); planar
    k-quants: w = (d * sc) * v (- dmin * mn)."""
    name = spec.name
    codes = codes_of(data, spec)
    if spec.superblock:
        vb = _blocked(codes.to(torch.float32), spec.block_size)
        y = vb * kq_effective_scales(scales, sub_scales)[..., None]
        if spec.asymmetric:
            y = y - kq_effective_scales(mins, sub_mins)[..., None]
        return y.reshape(codes.shape).to(dtype)

    if spec.codebook is not None:
        cb = torch.from_numpy(spec.codebook).to(codes.device)
        vals = cb[codes.long() & ((1 << max(spec.bits, 4)) - 1)]
    elif name == "sym_int4":
        vals = codes.to(torch.float32) - 8.0
    elif name == "sym_int5":
        vals = codes.to(torch.float32) - 16.0
    else:  # asym_int4/5 (the mins carry the offset), sym_int8, fp8
        vals = codes.to(torch.float32)
    y = _blocked(vals, spec.block_size) * scales.to(torch.float32)[..., None]
    if mins is not None:
        y = y + mins.to(torch.float32)[..., None]
    return y.reshape(vals.shape).to(dtype)
