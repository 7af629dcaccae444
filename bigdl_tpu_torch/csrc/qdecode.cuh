// Device-side decode shared by the port's kernels: every weight arm of
// bigdl_tpu/ops/pallas/qdecode.py (`decode_chunk` over a `DecodeSpec`),
// used by the dequant matmuls (qmatmul.cu) and the dequant dx
// (qbackward.cu), and the fp8 KV arm (`decode_kv`) used by the paged and
// flash attention kernels.
//
// A weight format is a `QFormat` traits type (the counterpart of
// `spec_for`'s DecodeSpec), one `QF_<qtype>` alias per qtype at the end
// of this file. Three axes, as in the reference:
//
// * how codes are STORED (quant/numerics.py pack_planes): one or two bit
//   planes, low bits first. A b-bit plane over K elements is K*b/8 bytes;
//   byte j carries elements j + t*(K*b/8) at bit offset b*t, t < 8/b.
//   Byte codes (int8, or fp8 bits) are one 8-bit plane: 8/8 = 1 split.
//   With S the finest split of the format's planes (2 for nibbles, 4 for
//   fp6 and q2_k, 8 for sym_int5, nf3 and q5_k, 1 for bytes) and Q = K/S,
//   element e = u*Q + j (u < S, j < Q) sits in plane p's byte
//   (u % (S/s_p))*Q + j at bit offset b_p*(u / (S/s_p)), s_p = 8/b_p.
//   So the 16 elements u*Q + j .. +15 (a "group", j % 16 == 0) come from
//   one 16-byte piece per plane, and the S groups of one j share pieces:
//   a kernel that loads the pieces of a j once and decodes all S groups
//   from registers reads every plane byte exactly once.
// * how codes become VALUES: code - offset (sym_int4 8, sym_int5 16;
//   int8 codes are signed), a 16- or 8-entry codebook (nf4, fp4, nf3:
//   the kernel stages `qlut<F>()` in shared memory), fp6 e2m3 and fp8
//   e4m3fn/e5m2 from their bit fields, exact on every finite code.
// * how values are SCALED: single-level f16 block scales, w = v*d (+ m
//   for asymmetric formats); planar k-quants w = (d*sc)*v (- dmin*mn)
//   with f16 super-scales d/dmin per 256 elements and integer sub-scales
//   per 16 or 32 (uint8, or int8 for q3_k/q6_k). A group never straddles
//   a block (blocks are >= 16 elements and groups are 16-aligned).
//
// Rounding follows the reference: each product and sum in f32 (`__fmul_rn`
// / `__fadd_rn`, so nvcc contracts nothing into an FMA), one rounding to
// bf16 before the dot (decode_chunk's .astype(bfloat16)). Where a format
// has a min term the product v*a is exact in f32 (v has at most 5
// significant bits, a at most 17), so the sum rounds once, as JAX's does.
// f16 scales decode with __half2float, subnormals exactly.
#pragma once

#include <type_traits>
#include <utility>

#include "common.cuh"

// Calls fn(std::integral_constant<int, I>) for I = B .. E-1, unrolled at
// compile time (so plane indices and shifts are constants).
template <int B, int E, class Fn>
__device__ __forceinline__ void static_for(Fn&& fn) {
  if constexpr (B < E) {
    fn(std::integral_constant<int, B>{});
    static_for<B + 1, E>(fn);
  }
}

// An float8_e5m2 code (the low byte of `code`) as f32: e5m2 is the high
// byte of an IEEE f16 (1 sign, 5 exponent, 2 mantissa bits), so code << 8
// is that f16 exactly, subnormals, infinities and NaN included — the
// counterpart of qdecode.decode_kv's fp8 arms, exact on every code. The
// caller multiplies by the scale.
__device__ __forceinline__ float e5m2_to_float(uint32_t code) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>((code & 0xffu) << 8)));
}

// An float8_e4m3fn code as f32 from its bit fields (qdecode.fp8_bits_to_f32
// with 4 exponent bits, bias 7): exact on every finite code; the encoder
// never stores the NaN codes.
__device__ __forceinline__ float e4m3_to_float(uint32_t code) {
  const uint32_t e = (code >> 3) & 15u, m = code & 7u;
  const float v = e == 0 ? static_cast<float>(m) * 0x1p-9f : __uint_as_float(((e + 120u) << 23) | (m << 20));
  return (code & 0x80u) ? -v : v;
}

// fp6 e2m3 (FP6_CODEBOOK's arithmetic form, qdecode decode_values "e2m3"):
// 1 sign, 2 exponent, 3 mantissa bits, magnitude m/16 (e = 0) or
// (8 + m) * 2^(e-1) / 16. Exact.
__device__ __forceinline__ float e2m3_to_float(uint32_t code) {
  const uint32_t e = (code >> 3) & 3u, m = code & 7u;
  const uint32_t mag = e == 0 ? m : (8u + m) << (e - 1);
  const float v = static_cast<float>(mag) * 0.0625f;
  return (code & 0x20u) ? -v : v;
}

enum class QValue { kOffset, kNF4, kFP4, kNF3, kE2M3, kE4M3, kE5M2 };

// The codebooks of quant/qtypes.py as exact float32 values.
__constant__ float kQLutNF4[16] = {
    -0x1.0p+0f, -0x1.647362p-1f, -0x1.0cd66p-1f, -0x1.94654p-2f,
    -0x1.23449ap-2f, -0x1.7a6a7ep-3f, -0x1.74f0e2p-4f, 0x0.0p+0f,
    0x1.45f5fep-4f, 0x1.4995c6p-3f, 0x1.f809bap-3f, 0x1.5a0674p-2f,
    0x1.c3497p-2f, 0x1.200f56p-1f, 0x1.722766p-1f, 0x1.0p+0f};
__constant__ float kQLutFP4[16] = {
    0x0.0p+0f, 0x1.0p-1f, 0x1.0p+0f, 0x1.8p+0f, 0x1.0p+1f, 0x1.8p+1f, 0x1.0p+2f, 0x1.8p+2f,
    -0x0.0p+0f, -0x1.0p-1f, -0x1.0p+0f, -0x1.8p+0f, -0x1.0p+1f, -0x1.8p+1f, -0x1.0p+2f, -0x1.8p+2f};
__constant__ float kQLutNF3[16] = {
    -0x1.0p+0f, -0x1.11ee8p-1f, -0x1.f9b72cp-3f, 0x0.0p+0f,
    0x1.7779aap-3f, 0x1.87296cp-2f, 0x1.3ef7fap-1f, 0x1.0p+0f,
    0, 0, 0, 0, 0, 0, 0, 0};

// The weight fields of one [O, K] QTensor (null where the format has none).
struct QFields {
  const uint8_t* data;        // [O, K*bits/8] planes, or [O, K] byte codes
  const __half* scales;       // [O, K/block] f16, or k-quants' d [O, K/256]
  const __half* mins;         // [O, K/block] f16, or k-quants' dmin [O, K/256]
  const uint8_t* sub_scales;  // k-quants: [O, K/block] uint8 or int8
  const uint8_t* sub_mins;    // k-quants: [O, K/block] uint8
};

template <int B0, int B1, bool Signed, QValue V, int Offset, int Block, int Super, bool Mins,
          bool SubSigned>
struct QFormat {
  static constexpr int kBits0 = B0;  // width of plane 0 (8: byte codes)
  static constexpr int kBits1 = B1;  // width of plane 1, 0 if none
  static constexpr int kBits = B0 + B1;
  static constexpr int kS0 = 8 / B0;
  static constexpr int kS1 = B1 ? 8 / B1 : 1;
  static constexpr int kS = kS0 > kS1 ? kS0 : kS1;  // finest split
  static constexpr int kN0 = kS / kS0;              // plane-0 pieces of one j
  static constexpr int kN1 = B1 ? kS / kS1 : 0;     // plane-1 pieces of one j
  static constexpr int kPieces = kN0 + kN1;
  static constexpr bool kSigned = Signed;  // int8 codes
  static constexpr QValue kValue = V;
  static constexpr int kOffset = Offset;
  static constexpr int kBlock = Block;  // scale block, or k-quant sub-block
  static constexpr int kSuper = Super;  // 256 for k-quants, else 0
  static constexpr bool kMins = Mins;
  static constexpr bool kSubSigned = SubSigned;
  static constexpr bool kLut = V == QValue::kNF4 || V == QValue::kFP4 || V == QValue::kNF3;
};

// The codebook a LUT format's kernel stages in shared memory (16 floats).
template <class F>
__device__ __forceinline__ const float* qlut() {
  if constexpr (F::kValue == QValue::kNF4) return kQLutNF4;
  else if constexpr (F::kValue == QValue::kFP4) return kQLutFP4;
  else return kQLutNF3;
}

template <class F>
__device__ __forceinline__ float qvalue(uint32_t code, const float* lut) {
  if constexpr (F::kLut) return lut[code];
  else if constexpr (F::kValue == QValue::kE2M3) return e2m3_to_float(code);
  else if constexpr (F::kValue == QValue::kE4M3) return e4m3_to_float(code);
  else if constexpr (F::kValue == QValue::kE5M2) return e5m2_to_float(code);
  else if constexpr (F::kSigned) return static_cast<float>(static_cast<int>(static_cast<int8_t>(code)));
  else return static_cast<float>(static_cast<int>(code) - F::kOffset);
}

__device__ __forceinline__ float half_bits_to_float(uint32_t bits) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(bits & 0xffffu)));
}

// The scale fields of one group as stored (loaded with __ldg ahead of the
// decode that needs them, and converted only where the group is decoded,
// once per group): single-level formats the f16 scale and min bits;
// k-quants d | sub-scale << 16 and dmin | sub-min << 16. w = v*a() (+ b()).
template <class F>
struct QScale {
  uint32_t s = 0, m = 0;

  // The group starting at element e of row o (zeros stay where !ok).
  __device__ __forceinline__ void load(const QFields& w, size_t o, int K, int e, bool ok) {
    if (!ok) return;
    const unsigned ue = static_cast<unsigned>(e);
    if constexpr (F::kSuper) {
      const size_t is = o * (K / F::kSuper) + ue / F::kSuper;
      const size_t ib = o * (K / F::kBlock) + ue / F::kBlock;
      s = __ldg(reinterpret_cast<const unsigned short*>(w.scales) + is) |
          (static_cast<uint32_t>(__ldg(w.sub_scales + ib)) << 16);
      if constexpr (F::kMins)
        m = __ldg(reinterpret_cast<const unsigned short*>(w.mins) + is) |
            (static_cast<uint32_t>(__ldg(w.sub_mins + ib)) << 16);
    } else {
      const size_t i = o * (K / F::kBlock) + ue / F::kBlock;
      s = __ldg(reinterpret_cast<const unsigned short*>(w.scales) + i);
      if constexpr (F::kMins) m = __ldg(reinterpret_cast<const unsigned short*>(w.mins) + i);
    }
  }

  __device__ __forceinline__ float a() const {
    const float d = half_bits_to_float(s);
    if constexpr (F::kSuper) {
      const uint32_t sc = s >> 16;
      return __fmul_rn(d, F::kSubSigned ? static_cast<float>(static_cast<int8_t>(static_cast<uint8_t>(sc)))
                                        : static_cast<float>(sc));
    } else {
      return d;
    }
  }

  __device__ __forceinline__ float b() const {
    if constexpr (!F::kMins) return 0.0f;
    else if constexpr (F::kSuper) return -__fmul_rn(half_bits_to_float(m), static_cast<float>(m >> 16));
    else return half_bits_to_float(m);
  }
};

// Plane p's piece index and bit offset for group u of a j.
template <class F, int U>
struct QPiece {
  static constexpr int kIdx0 = U % F::kN0;
  static constexpr int kShift0 = F::kBits0 * (U / F::kN0);
  static constexpr int kIdx1 = F::kN0 + (F::kN1 ? U % F::kN1 : 0);
  static constexpr int kShift1 = F::kN1 ? F::kBits1 * (U / F::kN1) : 0;
};

// Byte offset, within a row, of plane p's piece r for the j position j.
template <class F>
__device__ __forceinline__ size_t qpiece_offset(int K, int p, int r, int j) {
  const int Q = K / F::kS;
  return (p ? static_cast<size_t>(K) * F::kBits0 / 8 : 0) + static_cast<size_t>(r) * Q + j;
}

// Loads the kPieces 16-byte pieces of row `row` (the row's first byte)
// for the 16 j positions starting at j; zeros when !valid.
template <class F>
__device__ __forceinline__ void qload_pieces(const uint8_t* row, int K, int j, bool valid,
                                             uint4 (&pc)[F::kPieces]) {
#pragma unroll
  for (int r = 0; r < F::kPieces; ++r) {
    const int p = r < F::kN0 ? 0 : 1;
    const int rr = r < F::kN0 ? r : r - F::kN0;
    pc[r] = valid ? __ldg(reinterpret_cast<const uint4*>(row + qpiece_offset<F>(K, p, rr, j)))
                  : make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ uint32_t qbyte(const uint4& v, int i) {
  const uint32_t wd = i < 4 ? v.x : i < 8 ? v.y : i < 12 ? v.z : v.w;
  return (wd >> (8 * (i & 3))) & 0xffu;
}

// Decodes group U (16 elements) from a j's pieces into 16 bf16 weights,
// two per 32-bit word in element order, w = bf16(v*a (+ b)).
template <class F, int U>
__device__ __forceinline__ void qdecode16(const uint4 (&pc)[F::kPieces], float a, float b,
                                          const float* lut, uint32_t out[8]) {
  using P = QPiece<F, U>;
  constexpr uint32_t kMask0 = F::kBits0 == 8 ? 0xffu : (1u << F::kBits0) - 1u;
#pragma unroll
  for (int i = 0; i < 16; i += 2) {
    uint32_t bits[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t c = (qbyte(pc[P::kIdx0], i + h) >> P::kShift0) & kMask0;
      if constexpr (F::kN1) c |= ((qbyte(pc[P::kIdx1], i + h) >> P::kShift1) & ((1u << F::kBits1) - 1u)) << F::kBits0;
      const float v = qvalue<F>(c, lut);
      const float wv = F::kMins ? __fadd_rn(__fmul_rn(v, a), b) : __fmul_rn(v, a);
      bits[h] = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(wv)));
    }
    out[i >> 1] = bits[0] | (bits[1] << 16);
  }
}

// The decode of the tensor-core kernels (qtile.cuh): the same bits as
// qvalue and qdecode16 in fewer instructions. A 32-bit word of a plane
// holds one code field of 4 consecutive elements, one a byte: one shift
// and one mask take all 4 fields (and the second plane's, shifted above
// the first's), so each element costs one byte permute (PRMT) to reach
// its float. Offset and int8 codes become floats by the magic-number
// trick: the permute writes the code under 0x4B, so the word is the f32
// 2^23 + c, and one exact subtraction removes 2^23 and the offset (an
// int8 code c is (c ^ 0x80) - 128, the xor taken a word at a time). The
// other value kinds take the code from the permute and go through qvalue.
template <class F>
__device__ __forceinline__ float qvalue_tc(uint32_t word, int h, const float* lut) {
  if constexpr (F::kValue == QValue::kOffset)
    return __fsub_rn(__uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440u | h)),
                     static_cast<float>(8388608 + (F::kSigned ? 128 : F::kOffset)));
  else
    return qvalue<F>(__byte_perm(word, 0u, 0x4440u | h), lut);
}

// qdecode16 for the tensor-core kernels: per element qvalue_tc and v*a
// (+ b) in f32 with two roundings, then one cvt.rn.bf16x2.f32 for each
// pair (the same round-to-nearest-even as two __float2bfloat16_rn). a and
// b come converted once per group.
template <class F, int U>
__device__ __forceinline__ void qdecode16_tc(const uint4 (&pc)[F::kPieces], float a, float b,
                                             const float* lut, uint32_t (&out)[8]) {
  using P = QPiece<F, U>;
  constexpr uint32_t kFields0 = F::kBits0 == 8 ? 0xffffffffu : ((1u << F::kBits0) - 1u) * 0x01010101u;
  constexpr uint32_t kFields1 = F::kN1 ? ((1u << F::kBits1) - 1u) * 0x01010101u : 0u;
  const uint4& p0 = pc[P::kIdx0];
  const uint4& p1 = pc[P::kIdx1 < F::kPieces ? P::kIdx1 : 0];
  const uint32_t w0[4] = {p0.x, p0.y, p0.z, p0.w};
  const uint32_t w1[4] = {p1.x, p1.y, p1.z, p1.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t t = (w0[k] >> P::kShift0) & kFields0;
    if constexpr (F::kN1) t |= ((w1[k] >> P::kShift1) & kFields1) << F::kBits0;
    if constexpr (F::kSigned) t ^= 0x80808080u;
    float f[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float v = qvalue_tc<F>(t, h, lut);
      f[h] = F::kMins ? __fadd_rn(__fmul_rn(v, a), b) : __fmul_rn(v, a);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * h], f[2 * h + 1]);
      out[2 * k + h] = *reinterpret_cast<const uint32_t*>(&p);
    }
  }
}

// clang-format off
//                                  planes  signed value            off block super mins   sub-signed
using QF_sym_int4  = QFormat<4, 0, false, QValue::kOffset,  8, 32,  0,   false, false>;
using QF_asym_int4 = QFormat<4, 0, false, QValue::kOffset,  0, 32,  0,   true,  false>;
using QF_nf4       = QFormat<4, 0, false, QValue::kNF4,     0, 64,  0,   false, false>;
using QF_fp4       = QFormat<4, 0, false, QValue::kFP4,     0, 64,  0,   false, false>;
using QF_sym_int8  = QFormat<8, 0, true,  QValue::kOffset,  0, 32,  0,   false, false>;
using QF_asym_int5 = QFormat<8, 0, true,  QValue::kOffset,  0, 32,  0,   true,  false>;
using QF_fp8_e4m3  = QFormat<8, 0, false, QValue::kE4M3,    0, 128, 0,   false, false>;
using QF_fp8_e5m2  = QFormat<8, 0, false, QValue::kE5M2,    0, 128, 0,   false, false>;
using QF_sym_int5  = QFormat<4, 1, false, QValue::kOffset, 16, 32,  0,   false, false>;
using QF_fp6       = QFormat<4, 2, false, QValue::kE2M3,    0, 64,  0,   false, false>;
using QF_nf3       = QFormat<2, 1, false, QValue::kNF3,     0, 64,  0,   false, false>;
using QF_q2_k      = QFormat<2, 0, false, QValue::kOffset,  0, 16,  256, true,  false>;
using QF_q3_k      = QFormat<8, 0, true,  QValue::kOffset,  0, 16,  256, false, true>;
using QF_q4_k      = QFormat<4, 0, false, QValue::kOffset,  0, 32,  256, true,  false>;
using QF_q5_k      = QFormat<4, 1, false, QValue::kOffset,  0, 32,  256, true,  false>;
using QF_q6_k      = QFormat<8, 0, true,  QValue::kOffset,  0, 16,  256, false, true>;
// clang-format on
