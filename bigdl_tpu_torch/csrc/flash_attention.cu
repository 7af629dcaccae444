// Causal prefill flash attention for Hopper on the tensor cores: bf16 Q,
// bf16 or float8_e5m2 K/V, f32 sums.
//
// Replaces the Pallas kernel bigdl_tpu/ops/pallas/flash_attention.py
// `_kernel` (launched by `_flash`, wrapped by `flash_attention`), both its
// arms: a bf16 KV cache, and an fp8 one whose codes carry one f16 scale per
// (slot, head) (the quantized arm, `_kernel:65-98`). Same contract: q
// [B, T, Hq, D], k/v [B, S, Hkv, D] (the cache layout), out [B, T, Hq, D],
// D 64, 128 or 256; query t of row b sits at cache slot q_offset + t and
// attends slot j iff
//     start[b] <= j <= q_offset + t   and   j > q_offset + t - window (if window > 0),
// scores are (q . k) * scale, optionally tanh(s / softcap) * softcap, the
// softmax is online in f32 with -1e30 for masked slots, and a row with no
// valid slot (a left-pad row) writes exactly 0. It is kept apart from the
// training kernels (flash_backward.cu), as the JAX package keeps them
// apart; the two share the tile helpers of flash_tc.cuh.
//
// What bounds it: at the generation prefill (B = 4, T = 256 over 320
// slots, GQA 4:1, D = 128) reading q, k, v once and writing out once at
// 3.35 TB/s takes longer than its 4 * D flops per live (query, key) pair
// at the bf16 tensor-core peak: bytes. At the dense fp8 pool's prefill
// (T = S = 1024, one row) the operations do. The products run on the
// tensor cores (mma.sync m16n8k16, bf16 operands, f32 sums); what bounds
// the kernel now is mma.sync's rate and the ldmatrix reads that feed it,
// plus the second P.V product that carries P's low part.
//
// Design (the training forward's, flash_backward.cu): one block per (64
// queries, q head, batch row), the last query tiles (the longest causal
// walks) first; four warps of 16 rows. Q's fragments are loaded once
// (ldmatrix); 64-slot K and V tiles stream through a two-stage cp.async
// ring over the live tiles only (tiles above the diagonal, before start[b]
// or outside the window are not walked), and only the tiles a mask cuts
// are masked. S = Q.K^T by mma.sync, scale (and the softcap) applied to S
// in f32, the online softmax on the accumulator fragments, and P.V with P
// as bf16 hi + lo in two products (pv_tile). Query rows and slots take
// q_offset into the live range, the whole-tile test and the mask.
// * D = 256: the output accumulator (128 f32 a thread at 16 rows a warp)
//   does not fit beside S. Eight warps: two per row group, each with half
//   of the output dims; both form the row group's S (from Q's fragments
//   read per k step out of shared memory) and its softmax, bit for bit the
//   same.
// * fp8: every finite e5m2 code is a bf16 value (2 mantissa bits; bf16's
//   exponent range covers e5m2's subnormals), and the scales are per slot,
//   so they factor out of both products:
//       S[t, j] = kscale[j] (q_t . code_j),
//       O[t] = sum_j (P[t, j] vscale[j]) vcode_j.
//   The code bytes come by cp.async (half a bf16 tile's bytes) and are
//   converted once per tile into a bf16 tile in shared memory; the bf16
//   products run on the codes; each S column is multiplied by its kscale
//   in f32, and vscale is folded into P in f32 before the hi/lo split (the
//   row sum takes P itself). code * scale is never formed in bf16 or f16:
//   it has up to 14 significant bits, and the scales (absmax / 57344) are
//   f16 subnormals below an absmax of ~3.5. This is `_kernel`'s decode of
//   code * scale in f32, reassociated; the cache never exists as a dense
//   bf16 copy.
//
// Returns cudaGetLastError() after the launch; 0 means launched.

#include "flash_tc.cuh"

namespace {

// Two float8_e5m2 codes (bits 0-7 and 8-15 of w) as two bf16, exactly:
// e5m2 is the high byte of an IEEE f16, whose value bf16 holds.
__device__ __forceinline__ uint32_t e5m2x2_to_bf16x2(uint32_t w) {
  const uint32_t h2 = ((w & 0xffu) << 8) | ((w & 0xff00u) << 16);
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h2));
  return pack_bf16(f.x, f.y);
}

// Rows r0 .. r0 + kTile - 1 of head h of a [B, R, H, D] tensor of fp8
// codes into a dense [kTile][D] byte tile by cp.async; rows past R load as
// zeros.
template <int D, int kThreads>
__device__ __forceinline__ void load_codes(uint8_t* dst, const uint8_t* __restrict__ src, int b, int r0, int R,
                                           int H, int h) {
  constexpr int kPieces = D / 16;
#pragma unroll
  for (int i = 0; i < kTile * kPieces / kThreads; ++i) {
    const int e = static_cast<int>(threadIdx.x) + i * kThreads;
    const int r = e / kPieces;
    const int c = (e % kPieces) * 16;
    const int row = r0 + r;
    const bool ok = row < R;
    const uint8_t* p = ok ? src + ((static_cast<size_t>(b) * R + row) * H + h) * D + c : src;
    cp_async16(dst + r * D + c, p, ok ? 16 : 0);
  }
}

// A [kTile][D] code tile into a [kTile][D + 8] bf16 tile, 8 codes a piece.
template <int D, int kThreads>
__device__ __forceinline__ void decode_codes(bf16* dst, const uint8_t* src) {
  constexpr int kPieces = D / 8;
#pragma unroll
  for (int i = 0; i < kTile * kPieces / kThreads; ++i) {
    const int e = static_cast<int>(threadIdx.x) + i * kThreads;
    const int r = e / kPieces;
    const int c = (e % kPieces) * 8;
    const uint2 w = *reinterpret_cast<const uint2*>(src + r * D + c);
    uint4 o;
    o.x = e5m2x2_to_bf16x2(w.x);
    o.y = e5m2x2_to_bf16x2(w.x >> 16);
    o.z = e5m2x2_to_bf16x2(w.y);
    o.w = e5m2x2_to_bf16x2(w.y >> 16);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = o;
  }
}

// Warps sharing a row group (each with D / kSplit output dims) and threads
// of a block at head dim D.
template <int D>
struct Split {
  static constexpr int kSplit = D > 128 ? 2 : 1;
  static constexpr int kThreads = kTcThreads * kSplit;
};

template <int D, bool kFp8>
int smem_bytes() {
  const int tile = kTile * (D + 8) * static_cast<int>(sizeof(bf16));
  // Q and two stages of K and V; fp8: Q, one decoded K and V, two stages
  // of their codes and one tile's K and V scales
  return kFp8 ? 3 * tile + 4 * kTile * D + 2 * kTile * static_cast<int>(sizeof(float)) : 5 * tile;
}

template <int D, bool kFp8>
__global__ void __launch_bounds__(Split<D>::kThreads, Split<D>::kSplit == 1 ? 2 : 1)
    flash_kernel(const bf16* __restrict__ q, const void* __restrict__ kraw, const void* __restrict__ vraw,
                 const __half* __restrict__ kscale, const __half* __restrict__ vscale,
                 const int* __restrict__ start, bf16* __restrict__ out, int T, int S, int Hq, int Hkv,
                 int q_offset, float scale, int window, float softcap) {
  constexpr int kSplit = Split<D>::kSplit;
  constexpr int kThreads = Split<D>::kThreads;
  constexpr int kLd = D + 8;
  constexpr int kKs = D / 16;            // k steps of Q.K^T
  constexpr int kNo = D / kSplit / 8;    // n tiles of this warp's output dims
  constexpr bool kQRegs = kSplit == 1;   // Q's fragments held in registers
  constexpr int kStages = kFp8 ? 1 : 2;  // bf16 K/V tiles in shared memory
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);                          // [kTile][kLd]
  bf16* ks = qs + kTile * kLd;                                           // [kStages][kTile][kLd]
  bf16* vs = ks + kStages * kTile * kLd;                                 // [kStages][kTile][kLd]
  uint8_t* codes = reinterpret_cast<uint8_t*>(vs + kStages * kTile * kLd);  // fp8: [2][K, V][kTile][D]
  float* kss = reinterpret_cast<float*>(codes + (kFp8 ? 4 * kTile * D : 0));  // fp8: [kTile] K, [kTile] V scales
  const float* vss = kss + kTile;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int t0 = (gridDim.z - 1 - blockIdx.z) * kTile;  // the longest walks first
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5;
  const int wr = warp & 3;                     // row group: rows t0 + 16 wr ..
  const int d0 = (warp >> 2) * (D / kSplit);  // this warp's first output dim
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;  // fragment row (and row + 8)
  const int qd = lane & 3;   // fragment column pair
  const int st = start[b];
  const int row0 = q_offset + t0;  // cache slot of the block's first query
  int j_lo;
  const int n_tiles = live_tiles(row0, q_offset + min(t0 + kTile, T) - 1, S, st, window, &j_lo);

  auto load_kv = [&](int j0, int stage) {
    if constexpr (kFp8) {
      uint8_t* c = codes + stage * 2 * kTile * D;
      load_codes<D, kThreads>(c, static_cast<const uint8_t*>(kraw), b, j0, S, Hkv, hk);
      load_codes<D, kThreads>(c + kTile * D, static_cast<const uint8_t*>(vraw), b, j0, S, Hkv, hk);
    } else {
      load_tile<D, kThreads>(ks + stage * kTile * kLd, static_cast<const bf16*>(kraw), b, j0, S, Hkv, hk);
      load_tile<D, kThreads>(vs + stage * kTile * kLd, static_cast<const bf16*>(vraw), b, j0, S, Hkv, hk);
    }
  };
  // fp8: one scale of tile j0 a thread, threads 0 .. 63 K's, 64 .. 127 V's
  auto load_scale = [&](int j0) {
    float x = 0.0f;
    if constexpr (kFp8) {
      const int j = j0 + (threadIdx.x & (kTile - 1));
      if (threadIdx.x < 2 * kTile && j < S)
        x = __half2float((threadIdx.x < kTile ? kscale : vscale)[(static_cast<size_t>(b) * S + j) * Hkv + hk]);
    }
    return x;
  };

  load_tile<D, kThreads>(qs, q, b, t0, T, Hq, h);
  cp_async_commit();
  float sc = 0.0f;  // fp8: this thread's scale of the current tile
  if (n_tiles > 0) {
    load_kv(j_lo, 0);
    sc = load_scale(j_lo);
  }
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();
  const bf16* qrows = qs + wr * 16 * kLd;
  uint32_t qa[kQRegs ? kKs : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < kKs; ++kk) row_frag<D>(qa[kk], qrows, kk, lane);
  }

  const float sl2 = scale * kLog2e;
  const int tr = t0 + wr * 16 + gr;  // this thread's rows tr and tr + 8
  float m[2] = {kNegInf, kNegInf};   // running row max of S * scale * log2(e)
  float l[2] = {0.0f, 0.0f};         // this lane's share of the running row sum
  float o[kNo][4];
#pragma unroll
  for (int n = 0; n < kNo; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = j_lo + it * kTile;
    const int cur = it & 1;
    float sn = 0.0f;
    if (it + 1 < n_tiles) {
      load_kv(j0 + kTile, cur ^ 1);
      sn = load_scale(j0 + kTile);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed
    __syncthreads();
    const bf16* kt = ks + (kFp8 ? 0 : cur * kTile * kLd);
    const bf16* vt = vs + (kFp8 ? 0 : cur * kTile * kLd);
    if constexpr (kFp8) {
      const uint8_t* c = codes + cur * 2 * kTile * D;
      decode_codes<D, kThreads>(ks, c);
      decode_codes<D, kThreads>(vs, c + kTile * D);
      if (threadIdx.x < 2 * kTile) kss[threadIdx.x] = sc;
      __syncthreads();
    }

    // S = Q.K^T: 16 rows x 64 slots a warp, times kscale (fp8), scale and
    // the softcap in f32; masked scores exactly kNegInf
    float s[8][4];
    if constexpr (kQRegs) {
      key_dots<D>(s, qa, kt, lane);
    } else {
      key_dots<D>(s, qrows, kt, lane);
    }
    const bool edge = !whole_tile(t0, row0, j0, T, S, st, window);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 ksc = kFp8 ? *reinterpret_cast<const float2*>(kss + n * 8 + 2 * qd) : make_float2(1.0f, 1.0f);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = tr + (e >> 1) * 8;
        float x = s[n][e];
        if constexpr (kFp8) x *= (e & 1) ? ksc.y : ksc.x;
        x = softcap > 0.0f ? tanhf(x * scale / softcap) * softcap * kLog2e : x * sl2;
        if (edge && !attends(t, q_offset + t, j0 + n * 8 + 2 * qd + (e & 1), T, S, st, window)) x = kNegInf;
        s[n][e] = x;
      }
    }
    softmax_tile<kNo>(s, m, l, o);
    if constexpr (kFp8) {  // P vscale, after the row sums took P
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 vsc = *reinterpret_cast<const float2*>(vss + n * 8 + 2 * qd);
        s[n][0] *= vsc.x;
        s[n][1] *= vsc.y;
        s[n][2] *= vsc.x;
        s[n][3] *= vsc.y;
      }
    }
    pv_tile<D, kNo>(o, s, vt, d0, lane);
    __syncthreads();  // this stage is consumed before the next load or decode refills it
    sc = sn;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = quad_sum(l[i]);
    const int t = tr + 8 * i;
    if (t >= T) continue;
    const float div = li == 0.0f ? 1.0f : li;  // no valid slot: o = 0, out = 0
    bf16* row = out + (static_cast<size_t>(b) * T + t) * Hq * D + static_cast<size_t>(h) * D + d0;
#pragma unroll
    for (int n = 0; n < kNo; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + n * 8 + 2 * qd) =
          __floats2bfloat162_rn(o[n][2 * i] / div, o[n][2 * i + 1] / div);
  }
}

template <int D, bool kFp8>
int launch(const bf16* q, const void* k, const void* v, const __half* ks, const __half* vs, const int* start,
           bf16* out, int B, int T, int S, int Hq, int Hkv, int q_offset, float scale, int window, float softcap,
           cudaStream_t stream) {
  const int smem = smem_bytes<D, kFp8>();
  cudaFuncSetAttribute(flash_kernel<D, kFp8>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid(Hq, B, (T + kTile - 1) / kTile);
  flash_kernel<D, kFp8><<<grid, Split<D>::kThreads, smem, stream>>>(q, k, v, ks, vs, start, out, T, S, Hq, Hkv,
                                                                    q_offset, scale, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <bool kFp8>
int dispatch(const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
             const void* start, void* out, int B, int T, int S, int Hq, int Hkv, int D, int q_offset, float scale,
             int window, float softcap, void* stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const __half* ksp = static_cast<const __half*>(k_scale);
  const __half* vsp = static_cast<const __half*>(v_scale);
  const int* sp = static_cast<const int*>(start);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64, kFp8>(qp, k, v, ksp, vsp, sp, op, B, T, S, Hq, Hkv, q_offset, scale, window, softcap, st);
    case 128:
      return launch<128, kFp8>(qp, k, v, ksp, vsp, sp, op, B, T, S, Hq, Hkv, q_offset, scale, window, softcap, st);
    case 256:
      return launch<256, kFp8>(qp, k, v, ksp, vsp, sp, op, B, T, S, Hq, Hkv, q_offset, scale, window, softcap, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// window <= 0: no sliding window; softcap <= 0: no softcap.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, const void* start, void* out,
                                    int B, int T, int S, int Hq, int Hkv, int D, int q_offset, float scale,
                                    int window, float softcap, void* stream) {
  return dispatch<false>(q, k, v, nullptr, nullptr, start, out, B, T, S, Hq, Hkv, D, q_offset, scale, window,
                         softcap, stream);
}

// k/v: float8_e5m2 codes (as bytes); k_scale/v_scale: [B, S, Hkv] f16.
extern "C" int flash_attention_fp8(const void* q, const void* k, const void* v, const void* k_scale,
                                   const void* v_scale, const void* start, void* out, int B, int T, int S, int Hq,
                                   int Hkv, int D, int q_offset, float scale, int window, float softcap,
                                   void* stream) {
  return dispatch<true>(q, k, v, k_scale, v_scale, start, out, B, T, S, Hq, Hkv, D, q_offset, scale, window,
                        softcap, stream);
}
