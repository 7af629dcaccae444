// Causal prefill flash attention for Hopper, bf16 Q/K/V, f32 math.
//
// Replaces the Pallas kernel bigdl_tpu/ops/pallas/flash_attention.py
// `_kernel` (launched by `_flash`, wrapped by `flash_attention`) for a
// bf16 KV cache. Same contract: q [B, T, Hq, D], k/v [B, S, Hkv, D] (the
// cache layout), out [B, T, Hq, D]; query t of row b sits at cache slot
// q_offset + t and attends slot j iff
//     start[b] <= j <= q_offset + t   and   j > q_offset + t - window (if window > 0),
// scores are (q . k) * scale, optionally tanh(s / softcap) * softcap, the
// softmax is online in f32 with -1e30 for masked slots, and a row with no
// valid slot (a left-pad row) writes exactly 0.
//
// What bounds it: the function's least time is set by bytes. At the
// llama3-8b prefill (T = 256 over a cache of a few hundred slots, GQA 4:1)
// reading q, k, v once and writing out once at 3.35 TB/s takes longer than
// its ~4 * D flops per live (query, key) pair at the bf16 tensor-core peak.
// What limits this design now is its own arithmetic: it does all math in
// f32 on the CUDA cores, like the TPU kernel, not on the tensor cores. It
// never materializes the
// [T, S] scores: one block per (16 queries, head, batch row) walks the live
// key tiles of 64 slots, K and V tiles staged in shared memory with an odd
// word stride so the lane-per-key reads are free of bank conflicts. Tiles
// entirely above the diagonal, before start[b] or outside the window are
// skipped; masked slots in them would add exactly nothing. Tensor cores
// (mma/wgmma on bf16 P and V) are later work.
//
// Returns cudaGetLastError() after the launch; 0 means launched.

#include "common.cuh"

namespace {

constexpr int kRowsPerWarp = 4;
constexpr int kWarps = 4;
constexpr int kBQ = kRowsPerWarp * kWarps;  // query rows per block
constexpr int kBK = 64;                     // key slots per tile
constexpr float kNegInf = -1e30f;

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
    flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                 const int* __restrict__ start, bf16* __restrict__ out, int T, int S, int Hq, int Hkv,
                 int q_offset, float scale, int window, float softcap) {
  constexpr int kLd = D + 2;     // bf16 row stride: D/2 + 1 words, odd
  constexpr int kPairs = D / 64;  // bf16 pairs of the output row each lane owns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [kBQ][D], pre-scaled
  bf16* ks = reinterpret_cast<bf16*>(qs + kBQ * D);  // [kBK][kLd]
  bf16* vs = ks + kBK * kLd;                         // [kBK][kLd]

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
    for (int i = tid; i < kBK * (D / 2); i += blockDim.x) {
      const int r = i / (D / 2);
      const int c = i % (D / 2);
      const int j = j0 + r;
      uint32_t kw = 0u, vw = 0u;
      if (j < S) {
        const size_t off = ((static_cast<size_t>(b) * S + j) * Hkv + hk) * D + 2 * c;
        kw = *reinterpret_cast<const uint32_t*>(k + off);
        vw = *reinterpret_cast<const uint32_t*>(v + off);
      }
      *reinterpret_cast<uint32_t*>(ks + r * kLd + 2 * c) = kw;
      *reinterpret_cast<uint32_t*>(vs + r * kLd + 2 * c) = vw;
    }
    __syncthreads();

    // scores: lane owns key slots j0 + lane and j0 + 32 + lane, for the
    // warp's kRowsPerWarp query rows
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.0f;
    const float* qw = qs + warp * kRowsPerWarp * D;
#pragma unroll 4
    for (int d = 0; d < D; d += 2) {
      const float2 k0 = bf16x2_to_float2(*reinterpret_cast<const uint32_t*>(ks + lane * kLd + d));
      const float2 k1 = bf16x2_to_float2(*reinterpret_cast<const uint32_t*>(ks + (lane + 32) * kLd + d));
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
      float2 vf[kPairs];
#pragma unroll
      for (int pp = 0; pp < kPairs; ++pp)
        vf[pp] = bf16x2_to_float2(*reinterpret_cast<const uint32_t*>(vs + jj * kLd + 2 * lane + 64 * pp));
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

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, const int* start, bf16* out, int B, int T, int S,
           int Hq, int Hkv, int q_offset, float scale, int window, float softcap, cudaStream_t stream) {
  const int smem = kBQ * D * static_cast<int>(sizeof(float)) + 2 * kBK * (D + 2) * static_cast<int>(sizeof(bf16));
  cudaFuncSetAttribute(flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((T + kBQ - 1) / kBQ, Hq, B);
  flash_kernel<D><<<grid, kWarps * 32, smem, stream>>>(q, k, v, start, out, T, S, Hq, Hkv, q_offset, scale,
                                                       window, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// window <= 0: no sliding window; softcap <= 0: no softcap.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, const void* start, void* out,
                                    int B, int T, int S, int Hq, int Hkv, int D, int q_offset, float scale,
                                    int window, float softcap, void* stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const int* sp = static_cast<const int*>(start);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(qp, kp, vp, sp, op, B, T, S, Hq, Hkv, q_offset, scale, window, softcap, st);
    case 128: return launch<128>(qp, kp, vp, sp, op, B, T, S, Hq, Hkv, q_offset, scale, window, softcap, st);
    case 256: return launch<256>(qp, kp, vp, sp, op, B, T, S, Hq, Hkv, q_offset, scale, window, softcap, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
