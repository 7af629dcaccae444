"""Quantization type registry: the port's copy of the JAX package's
registry (bigdl_tpu/quant/qtypes.py), kept byte for byte in its data so
one stored artifact means the same format in both packages.

Mirrors the reference's qtype enumeration (`ggml/quantize.py:28-57` in
/root/reference: sym_int4, asym_int4, sym_int8, nf4, fp4, fp8_e4m3,
fp8_e5m2, fp16, bf16, k-quants, ...), re-designed for TPU storage:

- 4-bit codes are nibble-packed two-per-uint8 along the contraction axis
  (XLA/Pallas unpack with shifts; HBM footprint = 0.5 byte/weight + scales).
- int8 codes are stored as int8.
- fp8 codes are stored as native XLA float8 dtypes (TPU v5 supports them).
- Scales (and mins for asymmetric types) are float16 per block, matching
  the reference's ggml half-precision `d`/`m` fields.

Each qtype is described by a `QTypeSpec`; numerics live in
`bigdl_tpu_torch.quant.numerics`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# 16-entry NormalFloat4 codebook (QLoRA paper / bitsandbytes); the reference
# consumes the same table inside its native kernels for qtype "nf4".
NF4_CODEBOOK = np.array(
    [
        -1.0,
        -0.6961928009986877,
        -0.5250730514526367,
        -0.39491748809814453,
        -0.28444138169288635,
        -0.18477343022823334,
        -0.09105003625154495,
        0.0,
        0.07958029955625534,
        0.16093020141124725,
        0.24611230194568634,
        0.33791524171829224,
        0.44070982933044434,
        0.5626170039176941,
        0.7229568362236023,
        1.0,
    ],
    dtype=np.float32,
)

# 8-entry NormalFloat3 codebook: quantiles of N(0,1) normalized to [-1, 1],
# with 0 included (same construction as nf4 with 3 bits).
NF3_CODEBOOK = np.array(
    [-1.0, -0.5350227355957031, -0.2469314038753510, 0.0,
     0.1833375245332718, 0.3819939494132996, 0.6229856610298157, 1.0],
    dtype=np.float32,
)

# FP4 (e2m1) magnitudes; sign bit is the top bit of the 4-bit code.
FP4_MAGNITUDES = np.array([0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0], dtype=np.float32)

# Signed 16-entry fp4 codebook indexed by the raw 4-bit code.
FP4_CODEBOOK = np.concatenate([FP4_MAGNITUDES, -FP4_MAGNITUDES]).astype(np.float32)

# FP6 (e2m3) magnitudes: 1 sign bit, 2 exponent bits, 3 mantissa bits.
# Values: for exp e in {0 (subnormal),1,2,3}: subnormals m/8*0.25? We use the
# standard e2m3 value set with bias 1: subnormal = m * 2**-3 * 2**0? To keep a
# simple monotone codebook we enumerate all 32 magnitudes below.
def _fp6_e2m3_magnitudes() -> np.ndarray:
    vals = []
    for e in range(4):
        for m in range(8):
            if e == 0:
                vals.append(m / 8.0 * 0.5)  # subnormals, scale 2**(1-bias)=0.5
            else:
                vals.append((1.0 + m / 8.0) * (2.0 ** (e - 1)) * 0.5)
    return np.array(vals, dtype=np.float32)


FP6_MAGNITUDES = _fp6_e2m3_magnitudes()
FP6_CODEBOOK = np.concatenate([FP6_MAGNITUDES, -FP6_MAGNITUDES]).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class QTypeSpec:
    name: str
    bits: int
    block_size: int  # elements sharing one scale along the contraction axis
    asymmetric: bool = False  # stores per-block mins in addition to scales
    codebook: np.ndarray | None = None  # LUT types (nf4/nf3/fp4/fp6)
    storage: str = "packed_u8"  # packed_u8 | packed_planes | int8 |
    # fp8_e4m3 | fp8_e5m2 | dense. packed_u8 = nibble pairs (half-split);
    # packed_planes = the multi-split generalization (see `planes`);
    # dense == not quantized (fp16/bf16 passthrough kept as plain arrays)
    block_bytes: int = 0  # ggml import/export codec: bytes per super-block
    # packed_planes: bit widths of the stored planes, low bits first
    # (e.g. fp6 = (4, 2): a half-split nibble plane + a quarter-split
    # 2-bit plane). A b-bit plane over K elements is K*b/8 bytes where
    # byte j carries elements j + m*(K*b/8) at bit offset b*m — the
    # multi-split generalization of pack_nibbles' half-split trick, so
    # both XLA and the Pallas GEMV unpack it with static shifts of
    # contiguous slices. Planes are concatenated along the last axis of
    # `data` in declaration order.
    planes: tuple = ()
    # two-level (super-block) scale factorization: the contraction axis
    # must be a multiple of this at encode time, and QTensor carries
    # per-super-block f16 scales (d, dmin) in scales/mins plus integer
    # sub-scales in sub_scales/sub_mins. 0 = single-level scales.
    superblock: int = 0

    @property
    def is_dense(self) -> bool:
        return self.storage == "dense"


_REGISTRY: dict[str, QTypeSpec] = {}


def _register(spec: QTypeSpec) -> QTypeSpec:
    _REGISTRY[spec.name] = spec
    return spec


# ggml Q4_0-compatible: block 32, signed scale from the max-|x| element.
SYM_INT4 = _register(QTypeSpec("sym_int4", bits=4, block_size=32))
# ggml Q4_1-compatible: block 32, scale + min.
ASYM_INT4 = _register(QTypeSpec("asym_int4", bits=4, block_size=32, asymmetric=True))
# ggml Q5_0-compatible numerics; codes 0..31 stored as a half-split
# nibble plane + an eighth-split 1-bit plane (5 bits/weight in HBM — the
# fused GEMV reads both planes in-kernel; was int8 codes until round 6).
SYM_INT5 = _register(QTypeSpec(
    "sym_int5", bits=5, block_size=32, storage="packed_planes", planes=(4, 1)
))
ASYM_INT5 = _register(
    QTypeSpec("asym_int5", bits=5, block_size=32, asymmetric=True, storage="int8")
)
# ggml Q8_0-compatible: block 32, absmax/127.
SYM_INT8 = _register(QTypeSpec("sym_int8", bits=8, block_size=32, storage="int8"))
NF4 = _register(QTypeSpec("nf4", bits=4, block_size=64, codebook=NF4_CODEBOOK))
NF3 = _register(QTypeSpec(
    "nf3", bits=3, block_size=64, codebook=NF3_CODEBOOK,
    storage="packed_planes", planes=(2, 1),
))
FP4 = _register(QTypeSpec("fp4", bits=4, block_size=64, codebook=FP4_CODEBOOK))
FP6 = _register(QTypeSpec(
    "fp6", bits=6, block_size=64, codebook=FP6_CODEBOOK,
    storage="packed_planes", planes=(4, 2),
))
FP8_E4M3 = _register(QTypeSpec("fp8_e4m3", bits=8, block_size=128, storage="fp8_e4m3"))
FP8_E5M2 = _register(QTypeSpec("fp8_e5m2", bits=8, block_size=128, storage="fp8_e5m2"))
# k-quants: 256-element super-blocks with two-level scales (ggml q4_K =
# 4.5 bit/weight, q6_K = 6.5625). llama.cpp's interleaved byte layout is
# a CPU-SIMD artifact; on TPU, EVERY k-quant lives in a PLANAR layout
# the Pallas fused GEMV can read (packed code planes + factored
# super-scales — see quant/kq_planar.py), with the exact byte-level
# repack done once at the GGUF / encoder boundary:
#   q2_k — quarter-split 2-bit plane, 4-bit sc/mn per 16 elements;
#   q3_k — int8 centered codes + int8 sc per 16 (exactly q6_k's planar
#          structure, so it shares the q6_k fused kernel);
#   q4_k/q5_k — half-split nibbles (+ eighth-split 1-bit plane for
#          q5_k), 6-bit sc/mn per 32;
#   q6_k — int8 centered codes + int8 sc per 16.
# KQUANT_LAYOUT is the single source of truth for the on-disk byte
# layouts: name -> (block_bytes, byte offset of the fp16 super-scale d).
# Consumed by quant/kquants.py (codecs), quant/kq_planar.py (repack),
# quant/numerics.py (encode) and convert/gguf.py (_BLOCK sizes).
KQUANT_LAYOUT = {
    "q2_k": (84, 80),
    "q3_k": (110, 108),
    "q4_k": (144, 0),
    "q5_k": (176, 0),
    "q6_k": (210, 208),
}
# q2_k planar: data = quarter-split packed 2-bit codes [.., K/4]
# (codes 0..3), scales/mins = d/dmin f16 [.., K/256], sub_scales/
# sub_mins = 4-bit sc/mn u8 [.., K/16];
# w = (d*sc)*q - (dmin*mn) per 16-element sub-block. 2.625 bit/weight.
Q2_K = _register(QTypeSpec(
    "q2_k", bits=2, block_size=16, storage="packed_planes", planes=(2,),
    block_bytes=84, asymmetric=True, superblock=256,
))
# q3_k planar: data = int8 centered codes (q-4 in [-4,3]) [.., K],
# scales = d f16 [.., K/256], sub_scales = int8 sc [.., K/16];
# w = (d*sc)*q per 16-element sub-block — structurally IDENTICAL to
# planar q6_k, so it shares q6_k's fused GEMV kernel. int8 code planes
# trade 3.35 -> 8.56 bit/weight for Mosaic lane alignment at every K
# (same tradeoff as q6_k below).
Q3_K = _register(QTypeSpec(
    "q3_k", bits=3, block_size=16, storage="int8", block_bytes=110,
    superblock=256,
))
# q4_k planar: data = half-split packed nibbles [.., K/2] (codes 0..15),
# scales = d f16 [.., K/256], mins = dmin f16 [.., K/256], sub_scales =
# 6-bit sc u8 [.., K/32], sub_mins = 6-bit mn u8 [.., K/32];
# w = (d*sc)*q - (dmin*mn), per 32-element sub-block. 4.625 bit/weight.
Q4_K = _register(QTypeSpec(
    "q4_k", bits=4, block_size=32, storage="packed_u8", block_bytes=144,
    asymmetric=True, superblock=256,
))
# q5_k planar: data = half-split packed nibbles [.., K/2] ++ eighth-
# split 1-bit plane [.., K/8] (codes 0..31), scales/mins = d/dmin f16
# [.., K/256], sub_scales/sub_mins = 6-bit sc/mn u8 [.., K/32];
# w = (d*sc)*q - (dmin*mn) per 32-element sub-block. 5.625 bit/weight.
Q5_K = _register(QTypeSpec(
    "q5_k", bits=5, block_size=32, storage="packed_planes", planes=(4, 1),
    block_bytes=176, asymmetric=True, superblock=256,
))
# q6_k planar: data = int8 codes (q-32) [.., K], scales = d f16
# [.., K/256], sub_scales = int8 sc [.., K/16]; w = (d*sc)*q per
# 16-element sub-block. 8.56 bit/weight (vs ggml's packed 6.56 — int8
# code planes keep Mosaic lane alignment for every K; a 4+2-bit packed
# plane needs K%1024 alignment llama2's 11008 lacks).
Q6_K = _register(QTypeSpec(
    "q6_k", bits=6, block_size=16, storage="int8", block_bytes=210,
    superblock=256,
))
FP16 = _register(QTypeSpec("fp16", bits=16, block_size=1, storage="dense"))
BF16 = _register(QTypeSpec("bf16", bits=16, block_size=1, storage="dense"))

for _name, (_bb, _d_off) in KQUANT_LAYOUT.items():
    assert _REGISTRY[_name].block_bytes == _bb, (
        f"{_name}: QTypeSpec.block_bytes != KQUANT_LAYOUT"
    )

# Aliases matching the reference's user-facing spellings
# (transformers/model.py: load_in_low_bit values).
_ALIASES = {
    "int4": "sym_int4",
    "q4_0": "sym_int4",
    "q4_1": "asym_int4",
    "q5_0": "sym_int5",
    "q5_1": "asym_int5",
    "int8": "sym_int8",
    "q8_0": "sym_int8",
    "fp8": "fp8_e5m2",  # reference maps plain "fp8" to e5m2 on most devices
    # the reference's *_rtn variants (ggml/quantize.py:53-55) skip its
    # MSE scale search; our blockwise quantizer IS round-to-nearest, so
    # they resolve to the base formats (the searched variant is
    # quant/imatrix.quantize_with_weights)
    "sym_int4_rtn": "sym_int4",
    "asym_int4_rtn": "asym_int4",
    "sym_int8_rtn": "sym_int8",
    "woq_int4": "sym_int4",
}


# mixed qtypes: body format + higher-precision lm head (reference
# gguf_mixed_qtype, ggml/quantize.py:60-61: *_s/*_m variants keep the
# output layer at q6_k)
MIXED_QTYPES = {
    "q2_k_s": ("q2_k", "q4_k"),
    "q3_k_s": ("q3_k", "q6_k"),
    "q3_k_m": ("q3_k", "q6_k"),
    "q4_k_s": ("q4_k", "q6_k"),
    "q4_k_m": ("q4_k", "q6_k"),
    "q5_k_s": ("q5_k", "q6_k"),
    "q5_k_m": ("q5_k", "q6_k"),
}


def split_mixed_qtype(name: str) -> tuple[str, "str | None"]:
    """(body_qtype, lm_head_qtype|None) — resolves the mixed aliases so
    every quantization entry point (optimize_model, quantize_params,
    from_gguf, from_pretrained) accepts them uniformly."""
    key = name.lower()
    if key in MIXED_QTYPES:
        return MIXED_QTYPES[key]
    return name, None


def qtype_registry() -> dict[str, QTypeSpec]:
    return dict(_REGISTRY)


def resolve_qtype(name: str) -> QTypeSpec:
    key = name.lower()
    key = _ALIASES.get(key, key)
    if key not in _REGISTRY:
        raise ValueError(
            f"unknown qtype {name!r}; known: {sorted(_REGISTRY) + sorted(_ALIASES)}"
        )
    return _REGISTRY[key]
