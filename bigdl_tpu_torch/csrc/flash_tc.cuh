// Building blocks of the tensor-core flash kernels: the training forward
// and dQ (flash_backward.cu) and the prefill kernel (flash_attention.cu).
//
// A block owns kTile = 64 query rows; each warp 16 of them (a row group).
// Key tiles of kTile slots stream through shared memory, rows D + 8
// elements apart (an odd number of 16-byte pieces, so ldmatrix is free of
// bank conflicts). Products run as mma.sync m16n8k16 (bf16 operands, f32
// sums; common.cuh). A warp's 16 x 64 score tile is eight n tiles of
// accumulator fragments: element e of n tile n sits at row g + 8 (e >> 1)
// and key 8 n + 2 q + (e & 1), g = lane / 4, q = lane % 4.
#pragma once

#include "common.cuh"

namespace {

constexpr int kTile = 64;        // query rows of a block, keys of a tile
constexpr int kTcThreads = 128;  // four warps of 16 rows
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Query t, at cache slot `row`, attends key slot j (the training kernels
// pass row = t).
__device__ __forceinline__ bool attends(int t, int row, int j, int T, int S, int st, int window) {
  return t < T && j < S && j >= st && j <= row && (window <= 0 || j > row - window);
}

// Every (query, key) pair of the query tile t0.. (slots row0..) and the
// key tile j0.. attends: the tile needs no mask.
__device__ __forceinline__ bool whole_tile(int t0, int row0, int j0, int T, int S, int st, int window) {
  return j0 >= st && j0 + kTile - 1 <= row0 && t0 + kTile <= T && j0 + kTile <= S &&
         (window <= 0 || j0 > row0 + kTile - 1 - window);
}

// Live key tiles of the query rows at slots row_lo .. row_hi: returns their
// count and sets *j_lo to the first one's slot (a multiple of kTile). Tiles
// above the diagonal, before start or outside the window are not walked.
__device__ __forceinline__ int live_tiles(int row_lo, int row_hi, int S, int st, int window, int* j_lo) {
  const int j_hi = min(S, row_hi + 1);
  int lo = st;
  if (window > 0) lo = max(lo, row_lo - window + 1);
  *j_lo = max(lo, 0) / kTile * kTile;
  return j_hi > *j_lo ? (j_hi - *j_lo + kTile - 1) / kTile : 0;
}

// Rows r0 .. r0 + kTile - 1 of head h of a [B, R, H, D] bf16 tensor into a
// [kTile][D + 8] shared tile by cp.async (16 bytes a piece); rows past R
// load as zeros.
template <int D, int kThreads = kTcThreads>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, int b, int r0, int R, int H,
                                          int h) {
  constexpr int kLd = D + 8;
  constexpr int kPieces = D / 8;
#pragma unroll
  for (int i = 0; i < kTile * kPieces / kThreads; ++i) {
    const int e = static_cast<int>(threadIdx.x) + i * kThreads;
    const int r = e / kPieces;
    const int c = (e % kPieces) * 8;
    const int row = r0 + r;
    const bool ok = row < R;
    const bf16* p = ok ? src + ((static_cast<size_t>(b) * R + row) * H + h) * D + c : src;
    cp_async16(dst + r * kLd + c, p, ok ? 16 : 0);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (a, b) as bf16 hi + lo: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A fragments (ldmatrix) of the 16 x 16 block kk of a warp's 16 rows
// (`rows`: its first row in a [.][D + 8] shared tile).
template <int D>
__device__ __forceinline__ void row_frag(uint32_t (&a)[4], const bf16* rows, int kk, int lane) {
  ldmatrix_x4(a, rows + (lane & 15) * (D + 8) + kk * 16 + (lane >> 4) * 8);
}

// s = A . K^T for a warp's 16 rows and the 64 keys of `kt`, over D: A's
// fragments `a` held in registers.
template <int D>
__device__ __forceinline__ void key_dots(float (&s)[8][4], const uint32_t (&a)[D / 16][4], const bf16* kt,
                                         int lane) {
  constexpr int kLd = D + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t kb[4];
      ldmatrix_x4(kb, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd + kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * np], a[kk], kb[0], kb[1]);
      mma_bf16(s[2 * np + 1], a[kk], kb[2], kb[3]);
    }
  }
}

// The same with A's 16 rows read from shared memory (`rows`, as row_frag)
// one k step at a time, for kernels that cannot hold them in registers.
template <int D>
__device__ __forceinline__ void key_dots(float (&s)[8][4], const bf16* rows, const bf16* kt, int lane) {
  constexpr int kLd = D + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    row_frag<D>(a, rows, kk, lane);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t kb[4];
      ldmatrix_x4(kb, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd + kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * np], a, kb[0], kb[1]);
      mma_bf16(s[2 * np + 1], a, kb[2], kb[3]);
    }
  }
}

// One key tile of the online softmax in the log2 domain. `s` holds the
// tile's scores times log2(e), masked ones exactly kNegInf, and leaves as
// P = exp2(s - m) with m the new row max; l (this lane's share of each row
// sum) and the accumulator o are rescaled to it. A row with no valid key
// yet keeps l = 0 and o = 0: exp2(kNegInf) = 0.
template <int kN>
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], float (&m)[2], float (&l)[2], float (&o)[kN][4]) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
  }
  float mu[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float mn = fmaxf(m[i], quad_max(mx[i]));
    mu[i] = mn == kNegInf ? 0.0f : mn;
    const float alpha = exp2f(m[i] - mu[i]);
    m[i] = mn;
    l[i] *= alpha;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      o[n][2 * i] *= alpha;
      o[n][2 * i + 1] *= alpha;
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[n][e] - mu[e >> 1]);
      s[n][e] = p;
      l[e >> 1] += p;
    }
  }
}

// o (16 rows x kN * 8 dims from dim d0) += P . V over the tile's 64 keys,
// V [key][dim] in `vt` (rows D + 8 apart). P, the 16 x 64 accumulator
// fragments, goes in as the A operand straight from the registers, as a
// bf16 hi part plus a bf16 lo part (P - hi) in two products into one f32
// sum: P rounded once to bf16 would err by ~2^-9 of a row's typical
// output, more than one bf16 step of the outputs near 0. V comes through
// ldmatrix.trans.
template <int D, int kN>
__device__ __forceinline__ void pv_tile(float (&o)[kN][4], const float (&p)[8][4], const bf16* vt, int d0,
                                        int lane) {
  constexpr int kLd = D + 8;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    uint32_t ph[4], pl[4];
    split_bf16(p[2 * kc][0], p[2 * kc][1], ph[0], pl[0]);
    split_bf16(p[2 * kc][2], p[2 * kc][3], ph[1], pl[1]);
    split_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1], ph[2], pl[2]);
    split_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3], ph[3], pl[3]);
#pragma unroll
    for (int dn = 0; dn < kN / 2; ++dn) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vt + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd + d0 + dn * 16 + (lane >> 4) * 8);
      mma_bf16(o[2 * dn], ph, vb[0], vb[1]);
      mma_bf16(o[2 * dn], pl, vb[0], vb[1]);
      mma_bf16(o[2 * dn + 1], ph, vb[2], vb[3]);
      mma_bf16(o[2 * dn + 1], pl, vb[2], vb[3]);
    }
  }
}

}  // namespace
