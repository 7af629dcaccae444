// Device-side decode shared by the port's kernels: the sym_int4 weight arm
// of bigdl_tpu/ops/pallas/qdecode.py (decode_chunk with
// DecodeSpec(planes=(4,), value=("offset", 8), block=32)) used by the
// dequant matmuls, and the fp8 KV arm (decode_kv) used by the paged and
// flash attention kernels.
//
// Storage (quant/numerics.py pack_nibbles, half-split): row o of a
// [O, K] weight is K/2 bytes; byte j carries element j in its low nibble
// and element j + K/2 in its high nibble. scales[o, e / 32] (float16)
// scales element e. Because K % 64 == 0, K/2 starts on a block boundary,
// so the 16 low elements of a 16-byte group share one scale and the 16
// high elements share another.
//
// Rounding follows the reference: (code - 8) * scale in f32, rounded to
// bf16 BEFORE the dot (qdecode.py decode_chunk's .astype(bfloat16)).
#pragma once

#include "common.cuh"

// An float8_e5m2 KV code (the low byte of `code`) as f32: e5m2 is the high
// byte of an IEEE f16 (1 sign, 5 exponent, 2 mantissa bits), so code << 8
// is that f16 exactly, subnormals, infinities and NaN included — the
// counterpart of qdecode.decode_kv's fp8 arms, exact on every code. The
// caller multiplies by the (slot, head) scale.
__device__ __forceinline__ float e5m2_to_float(uint32_t code) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>((code & 0xffu) << 8)));
}

// (code - 8) * scale rounded to bf16, returned as its 16 bits.
__device__ __forceinline__ uint32_t sym_int4_bits(uint32_t code, float scale) {
  return static_cast<uint32_t>(
      __bfloat16_as_ushort(__float2bfloat16((static_cast<float>(code) - 8.0f) * scale)));
}

// Decodes 16 packed bytes (one uint4) into 16 low-half and 16 high-half
// bf16 weights, two per 32-bit word in element order: lo[i] holds elements
// 2i (low bits) and 2i + 1 of the low half, hi[i] the same of the high half.
__device__ __forceinline__ void decode_sym_int4_16(uint4 packed, float s_lo, float s_hi,
                                                   uint32_t lo[8], uint32_t hi[8]) {
  const uint32_t words[4] = {packed.x, packed.y, packed.z, packed.w};
#pragma unroll
  for (int w = 0; w < 4; ++w) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const uint32_t b0 = (words[w] >> (16 * p)) & 0xffu;
      const uint32_t b1 = (words[w] >> (16 * p + 8)) & 0xffu;
      lo[2 * w + p] = sym_int4_bits(b0 & 0xfu, s_lo) | (sym_int4_bits(b1 & 0xfu, s_lo) << 16);
      hi[2 * w + p] = sym_int4_bits(b0 >> 4, s_hi) | (sym_int4_bits(b1 >> 4, s_hi) << 16);
    }
  }
}
