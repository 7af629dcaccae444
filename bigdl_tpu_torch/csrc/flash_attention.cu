// Causal prefill flash attention for Hopper, bf16 Q, bf16 or float8_e5m2
// K/V, f32 math.
//
// Replaces the Pallas kernel bigdl_tpu/ops/pallas/flash_attention.py
// `_kernel` (launched by `_flash`, wrapped by `flash_attention`), both its
// arms: a bf16 KV cache, and an fp8 one whose codes carry one f16 scale per
// (slot, head) (the quantized arm, `_kernel:65-98`). Same contract: q
// [B, T, Hq, D], k/v [B, S, Hkv, D] (the cache layout), out [B, T, Hq, D];
// query t of row b sits at cache slot q_offset + t and attends slot j iff
//     start[b] <= j <= q_offset + t   and   j > q_offset + t - window (if window > 0),
// scores are (q . k) * scale, optionally tanh(s / softcap) * softcap, the
// softmax is online in f32 with -1e30 for masked slots, and a row with no
// valid slot (a left-pad row) writes exactly 0. An fp8 K/V element is
// decoded to f32 by the shared e5m2 decode (qdecode.cuh) and multiplied by
// its slot's scale before the dot, as `_kernel` decodes each tile through
// qdecode.decode_kv: the cache never exists as a dense bf16 copy.
//
// What bounds it: the function's least time is set by bytes. At the
// llama3-8b prefill (T = 256 over a cache of a few hundred slots, GQA 4:1)
// reading q, k, v once and writing out once at 3.35 TB/s takes longer than
// its ~4 * D flops per live (query, key) pair at the bf16 tensor-core peak.
// What limits this design now is its own arithmetic: it does all math in
// f32 on the CUDA cores, like the TPU kernel, not on the tensor cores. It
// never materializes the
// [T, S] scores: one block per (16 queries, head, batch row) walks the live
// key tiles of 64 slots, K and V tiles staged in shared memory as stored
// (bf16, or fp8 codes with their scales) with an odd word stride so the
// lane-per-key reads are free of bank conflicts. Tiles
// entirely above the diagonal, before start[b] or outside the window are
// skipped; masked slots in them would add exactly nothing. Tensor cores
// (mma/wgmma on bf16 P and V) are later work.
//
// Returns cudaGetLastError() after the launch; 0 means launched.

#include <type_traits>

#include "qdecode.cuh"

namespace {

constexpr int kRowsPerWarp = 4;
constexpr int kWarps = 4;
constexpr int kBQ = kRowsPerWarp * kWarps;  // query rows per block
constexpr int kBK = 64;                     // key slots per tile
constexpr float kNegInf = -1e30f;

// A staged K or V tile: elements as stored, rows an odd number of 32-bit
// words apart.
template <int D, bool kFp8>
struct Tile {
  using T = std::conditional_t<kFp8, uint8_t, bf16>;
  static constexpr int kLd = kFp8 ? D + 4 : D + 2;  // elements per row
  static constexpr int kWords = D * static_cast<int>(sizeof(T)) / 4;  // words per row

  // Elements d and d + 1 (d even) of row r as f32; `s` is the row's scale
  // (fp8 only).
  static __device__ __forceinline__ float2 pair(const T* tile, int r, int d, float s) {
    if constexpr (kFp8) {
      const uint32_t w = *reinterpret_cast<const uint16_t*>(tile + r * kLd + d);
      return make_float2(e5m2_to_float(w) * s, e5m2_to_float(w >> 8) * s);
    } else {
      return bf16x2_to_float2(*reinterpret_cast<const uint32_t*>(tile + r * kLd + d));
    }
  }
};

template <int D, bool kFp8>
__global__ void __launch_bounds__(kWarps * 32)
    flash_kernel(const bf16* __restrict__ q, const void* __restrict__ kraw, const void* __restrict__ vraw,
                 const __half* __restrict__ kscale, const __half* __restrict__ vscale,
                 const int* __restrict__ start, bf16* __restrict__ out, int T, int S, int Hq, int Hkv,
                 int q_offset, float scale, int window, float softcap) {
  using TL = Tile<D, kFp8>;
  using E = typename TL::T;
  constexpr int kLd = TL::kLd;
  constexpr int kPairs = D / 64;  // element pairs of the output row each lane owns
  const E* k = static_cast<const E*>(kraw);
  const E* v = static_cast<const E*>(vraw);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [kBQ][D], pre-scaled
  float* kss = qs + kBQ * D;                       // [kBK] K scales (fp8)
  float* vss = kss + kBK;                          // [kBK] V scales (fp8)
  E* ks = reinterpret_cast<E*>(vss + kBK);         // [kBK][kLd]
  E* vs = ks + kBK * kLd;                          // [kBK][kLd]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int t0 = blockIdx.x * kBQ;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int st = start[b];

  for (int i = tid; i < kBQ * D; i += blockDim.x) {
    const int t = t0 + i / D;
    const int d = i % D;
    qs[i] = t < T ? __bfloat162float(q[(static_cast<size_t>(b) * T + t) * Hq * D + static_cast<size_t>(h) * D + d]) * scale
                  : 0.0f;
  }

  float m_i[kRowsPerWarp], l_i[kRowsPerWarp], acc[kRowsPerWarp][2 * kPairs];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_i[r] = kNegInf;
    l_i[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < 2 * kPairs; ++e) acc[r][e] = 0.0f;
  }

  // live key range of this query tile
  const int row_min = q_offset + t0;
  const int row_max = q_offset + min(t0 + kBQ, T) - 1;
  const int j_hi = min(S, row_max + 1);
  int j_lo = st;
  if (window > 0) j_lo = max(j_lo, row_min - window + 1);
  j_lo = max(j_lo, 0) / kBK * kBK;

  for (int j0 = j_lo; j0 < j_hi; j0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int i = tid; i < kBK * TL::kWords; i += blockDim.x) {
      const int r = i / TL::kWords;
      const int c = i % TL::kWords;
      const int j = j0 + r;
      uint32_t kw = 0u, vw = 0u;
      if (j < S) {
        const size_t off = ((static_cast<size_t>(b) * S + j) * Hkv + hk) * D;
        kw = reinterpret_cast<const uint32_t*>(k + off)[c];
        vw = reinterpret_cast<const uint32_t*>(v + off)[c];
      }
      reinterpret_cast<uint32_t*>(ks + r * kLd)[c] = kw;
      reinterpret_cast<uint32_t*>(vs + r * kLd)[c] = vw;
    }
    if constexpr (kFp8) {
      for (int r = tid; r < kBK; r += blockDim.x) {
        const int j = j0 + r;
        const size_t si = (static_cast<size_t>(b) * S + j) * Hkv + hk;
        kss[r] = j < S ? __half2float(kscale[si]) : 0.0f;
        vss[r] = j < S ? __half2float(vscale[si]) : 0.0f;
      }
    }
    __syncthreads();

    // scores: lane owns key slots j0 + lane and j0 + 32 + lane, for the
    // warp's kRowsPerWarp query rows
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.0f;
    const float* qw = qs + warp * kRowsPerWarp * D;
    const float sk0 = kFp8 ? kss[lane] : 1.0f, sk1 = kFp8 ? kss[lane + 32] : 1.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 2) {
      const float2 k0 = TL::pair(ks, lane, d, sk0);
      const float2 k1 = TL::pair(ks, lane + 32, d, sk1);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float2 qf = *reinterpret_cast<const float2*>(qw + r * D + d);
        s[r][0] = fmaf(qf.y, k0.y, fmaf(qf.x, k0.x, s[r][0]));
        s[r][1] = fmaf(qf.y, k1.y, fmaf(qf.x, k1.x, s[r][1]));
      }
    }

    float p[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int t = t0 + warp * kRowsPerWarp + r;
      const int row = q_offset + t;
      bool valid[2];
      float sc[2];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int j = j0 + lane + 32 * kk;
        valid[kk] = t < T && j < S && j >= st && j <= row && (window <= 0 || j > row - window);
        float x = s[r][kk];
        if (softcap > 0.0f) x = tanhf(x / softcap) * softcap;
        sc[kk] = valid[kk] ? x : kNegInf;
      }
      const float m_new = fmaxf(m_i[r], warp_max(fmaxf(sc[0], sc[1])));
      const float alpha = expf(m_i[r] - m_new);
      p[r][0] = valid[0] ? expf(sc[0] - m_new) : 0.0f;
      p[r][1] = valid[1] ? expf(sc[1] - m_new) : 0.0f;
      l_i[r] = alpha * l_i[r] + warp_sum(p[r][0] + p[r][1]);
      m_i[r] = m_new;
#pragma unroll
      for (int e = 0; e < 2 * kPairs; ++e) acc[r][e] *= alpha;
    }

    // P . V: lane owns output dims 2 * lane + 64 * pp (+1)
#pragma unroll
    for (int jj = 0; jj < kBK; ++jj) {
      const float sv = kFp8 ? vss[jj] : 1.0f;
      float2 vf[kPairs];
#pragma unroll
      for (int pp = 0; pp < kPairs; ++pp) vf[pp] = TL::pair(vs, jj, 2 * lane + 64 * pp, sv);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r][jj >> 5], jj & 31);
#pragma unroll
        for (int pp = 0; pp < kPairs; ++pp) {
          acc[r][2 * pp] = fmaf(pj, vf[pp].x, acc[r][2 * pp]);
          acc[r][2 * pp + 1] = fmaf(pj, vf[pp].y, acc[r][2 * pp + 1]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = t0 + warp * kRowsPerWarp + r;
    if (t >= T) continue;
    const float l = l_i[r] == 0.0f ? 1.0f : l_i[r];
    bf16* orow = out + (static_cast<size_t>(b) * T + t) * Hq * D + static_cast<size_t>(h) * D;
#pragma unroll
    for (int pp = 0; pp < kPairs; ++pp) {
      __nv_bfloat162 o2;
      o2.x = __float2bfloat16(acc[r][2 * pp] / l);
      o2.y = __float2bfloat16(acc[r][2 * pp + 1] / l);
      *reinterpret_cast<__nv_bfloat162*>(orow + 2 * lane + 64 * pp) = o2;
    }
  }
}

template <int D, bool kFp8>
int launch(const bf16* q, const void* k, const void* v, const __half* ks, const __half* vs, const int* start,
           bf16* out, int B, int T, int S, int Hq, int Hkv, int q_offset, float scale, int window, float softcap,
           cudaStream_t stream) {
  using TL = Tile<D, kFp8>;
  const int smem = (kBQ * D + 2 * kBK) * static_cast<int>(sizeof(float)) +
                   2 * kBK * TL::kLd * static_cast<int>(sizeof(typename TL::T));
  cudaFuncSetAttribute(flash_kernel<D, kFp8>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((T + kBQ - 1) / kBQ, Hq, B);
  flash_kernel<D, kFp8><<<grid, kWarps * 32, smem, stream>>>(q, k, v, ks, vs, start, out, T, S, Hq, Hkv,
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
