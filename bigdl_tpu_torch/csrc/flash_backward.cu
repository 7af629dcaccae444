// Trainable causal flash attention for Hopper: the forward with per-row
// logsumexp and the two backward kernels, bf16 Q/K/V/dO, f32 math.
//
// Replaces the Pallas kernels of bigdl_tpu/ops/pallas/flash_backward.py
// (wrapped by `flash_attention_trainable`): `_fwd_kernel` (flash_train_fwd),
// `_dq_kernel` (flash_train_dq) and `_dkv_kernel` (flash_train_dkv). It is
// kept apart from flash_attention.cu, the inference kernel, as the JAX
// package keeps its inference kernel apart. Contract: q, dO, out, dq
// [B, T, Hq, D]; k, v, dk, dv [B, S, Hkv, D] (the model's layout); lse and
// delta [B, T, Hq] f32. Query t of row b attends key j iff
//     start[b] <= j <= t   and   j > t - window (if window > 0),
// scores are (q * scale) . k, masked scores -1e30, and a row with no valid
// key (a left-pad row) has out = 0 and lse = -1e30. The backward recomputes
// P = exp(S - lse) per tile (zero where masked) with delta = rowsum(dO * O):
//     dS = P * (dO . V^T - delta),  dQ = scale * dS . K,
//     dK = scale * dS^T . Q (Q unscaled),  dV = P^T . dO.
//
// What bounds it: at the llama3-8b training shape (B = 1, T = 1024, 32 q
// heads over 8 kv heads, D = 128) the function's least time is set by
// operations (4, 6 and 8 * D flops per live (query, key) pair and q head
// against one read of q, k, v, dO), not bytes. What limits this design now
// is that it does all math in f32 on the CUDA cores, as the inference
// kernel does, not on the tensor cores (later work).
//
// Design:
// * forward and dQ: one block per (16 queries, q head, batch row), four
//   warps of four query rows; the block walks only the live key tiles of
//   64 keys (tiles above the diagonal, before start[b] or outside the
//   window are skipped — masked keys there add exactly nothing), K and V
//   tiles staged in shared memory with an odd 32-bit-word row stride so the
//   lane-per-key reads are free of bank conflicts. The online softmax and
//   the output of the forward are those of flash_attention.cu.
// * dK/dV: one block per (32 keys, kv head, batch row), four warps of
//   eight keys. It loops over the group's q heads and every live tile of
//   16 queries (as `_dkv_kernel`'s grid does) and accumulates dK and dV in
//   registers, so the q heads of a GQA group never race: no atomics, and
//   the result is the same from run to run.
//
// Each entry returns cudaGetLastError() after the launch; 0 means launched.

#include "common.cuh"

namespace {

constexpr int kRowsPerWarp = 4;
constexpr int kWarps = 4;
constexpr int kBQ = kRowsPerWarp * kWarps;  // query rows per forward / dQ block
constexpr int kBK = 64;                     // key slots per tile of the forward / dQ walk
constexpr int kKeysPerWarp = 8;
constexpr int kBKV = kKeysPerWarp * kWarps;  // keys per dK/dV block
constexpr int kQT = 16;                      // queries per step of the dK/dV walk
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ bool attends(int t, int j, int T, int S, int st, int window) {
  return t < T && j < S && j >= st && j <= t && (window <= 0 || j > t - window);
}

// First key slot (a multiple of kBK) and end of the live key range of the
// query rows [t0, t0 + kBQ).
__device__ __forceinline__ void live_keys(int t0, int T, int S, int st, int window, int* j_lo, int* j_hi) {
  *j_hi = min(S, min(t0 + kBQ, T));
  int lo = st;
  if (window > 0) lo = max(lo, t0 - window + 1);
  *j_lo = max(lo, 0) / kBK * kBK;
}

// K and V tile [kBK][D + 2] bf16 of key slots j0.. of kv head hk.
template <int D>
__device__ __forceinline__ void stage_kv(const bf16* __restrict__ k, const bf16* __restrict__ v, bf16* ks,
                                         bf16* vs, int b, int j0, int S, int Hkv, int hk) {
  constexpr int kLd = D + 2;
  for (int i = threadIdx.x; i < kBK * (D / 2); i += blockDim.x) {
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
}

// rows [t0, t0 + rows) of head h of a [B, T, H, D] bf16 tensor as f32
// [rows][ld], times mul; rows past T are 0.
template <int D>
__device__ __forceinline__ void stage_rows(const bf16* __restrict__ src, float* dst, int ld, int rows, int b,
                                           int t0, int T, int H, int h, float mul) {
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D;
    const int d = i % D;
    const int t = t0 + r;
    dst[r * ld + d] =
        t < T ? __bfloat162float(src[(static_cast<size_t>(b) * T + t) * H * D + static_cast<size_t>(h) * D + d]) * mul
              : 0.0f;
  }
}

// Scores of the warp's kRowsPerWarp rows (f32 [.][D] in shared memory, q
// rows pre-scaled) against key slots lane and lane + 32 of the staged tile.
template <int D>
__device__ __forceinline__ void row_dots(const float* rows, const bf16* tile, int lane,
                                         float s[kRowsPerWarp][2]) {
  constexpr int kLd = D + 2;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; d += 2) {
    const float2 k0 = bf16x2_to_float2(*reinterpret_cast<const uint32_t*>(tile + lane * kLd + d));
    const float2 k1 = bf16x2_to_float2(*reinterpret_cast<const uint32_t*>(tile + (lane + 32) * kLd + d));
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float2 qf = *reinterpret_cast<const float2*>(rows + r * D + d);
      s[r][0] = fmaf(qf.y, k0.y, fmaf(qf.x, k0.x, s[r][0]));
      s[r][1] = fmaf(qf.y, k1.y, fmaf(qf.x, k1.x, s[r][1]));
    }
  }
}

// acc[r][dims of this lane] += sum over the tile's keys jj of w[r][jj] *
// tile[jj][dims]; lane owns dims 2 * lane + 64 * pp (+1), w[r][kk] is held
// by lane jj & 31 in slot jj >> 5.
template <int D>
__device__ __forceinline__ void weighted_rows(const float w[kRowsPerWarp][2], const bf16* tile, int lane,
                                              float acc[kRowsPerWarp][D / 32]) {
  constexpr int kLd = D + 2;
  constexpr int kPairs = D / 64;
#pragma unroll
  for (int jj = 0; jj < kBK; ++jj) {
    float2 vf[kPairs];
#pragma unroll
    for (int pp = 0; pp < kPairs; ++pp)
      vf[pp] = bf16x2_to_float2(*reinterpret_cast<const uint32_t*>(tile + jj * kLd + 2 * lane + 64 * pp));
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float pj = __shfl_sync(0xffffffffu, w[r][jj >> 5], jj & 31);
#pragma unroll
      for (int pp = 0; pp < kPairs; ++pp) {
        acc[r][2 * pp] = fmaf(pj, vf[pp].x, acc[r][2 * pp]);
        acc[r][2 * pp + 1] = fmaf(pj, vf[pp].y, acc[r][2 * pp + 1]);
      }
    }
  }
}

template <int D>
__device__ __forceinline__ void write_rows(bf16* __restrict__ dst, const float acc[kRowsPerWarp][D / 32],
                                           float mul, int b, int t0, int T, int H, int h, int lane) {
  constexpr int kPairs = D / 64;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = t0 + r;
    if (t >= T) continue;
    bf16* row = dst + (static_cast<size_t>(b) * T + t) * H * D + static_cast<size_t>(h) * D;
#pragma unroll
    for (int pp = 0; pp < kPairs; ++pp) {
      __nv_bfloat162 o2;
      o2.x = __float2bfloat16(acc[r][2 * pp] * mul);
      o2.y = __float2bfloat16(acc[r][2 * pp + 1] * mul);
      *reinterpret_cast<__nv_bfloat162*>(row + 2 * lane + 64 * pp) = o2;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
    fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               const int* __restrict__ start, bf16* __restrict__ out, float* __restrict__ lse, int T, int S,
               int Hq, int Hkv, float scale, int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);    // [kBQ][D], pre-scaled
  bf16* ks = reinterpret_cast<bf16*>(qs + kBQ * D);  // [kBK][D + 2]
  bf16* vs = ks + kBK * (D + 2);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int t0 = blockIdx.x * kBQ;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int st = start[b];
  const int tw = t0 + warp * kRowsPerWarp;  // first row of this warp

  stage_rows<D>(q, qs, D, kBQ, b, t0, T, Hq, h, scale);

  float m_i[kRowsPerWarp], l_i[kRowsPerWarp], acc[kRowsPerWarp][D / 32];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_i[r] = kNegInf;
    l_i[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < D / 32; ++e) acc[r][e] = 0.0f;
  }

  int j_lo, j_hi;
  live_keys(t0, T, S, st, window, &j_lo, &j_hi);
  for (int j0 = j_lo; j0 < j_hi; j0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    stage_kv<D>(k, v, ks, vs, b, j0, S, Hkv, hk);
    __syncthreads();

    float s[kRowsPerWarp][2];
    row_dots<D>(qs + warp * kRowsPerWarp * D, ks, lane, s);
    float p[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      bool valid[2];
      float sc[2];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        valid[kk] = attends(tw + r, j0 + lane + 32 * kk, T, S, st, window);
        sc[kk] = valid[kk] ? s[r][kk] : kNegInf;
      }
      const float m_new = fmaxf(m_i[r], warp_max(fmaxf(sc[0], sc[1])));
      const float alpha = expf(m_i[r] - m_new);
      p[r][0] = valid[0] ? expf(sc[0] - m_new) : 0.0f;
      p[r][1] = valid[1] ? expf(sc[1] - m_new) : 0.0f;
      l_i[r] = alpha * l_i[r] + warp_sum(p[r][0] + p[r][1]);
      m_i[r] = m_new;
#pragma unroll
      for (int e = 0; e < D / 32; ++e) acc[r][e] *= alpha;
    }
    weighted_rows<D>(p, vs, lane, acc);
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = tw + r;
    if (t >= T) continue;
    const float l = l_i[r] == 0.0f ? 1.0f : l_i[r];
#pragma unroll
    for (int e = 0; e < D / 32; ++e) acc[r][e] /= l;
    if (lane == 0)
      lse[(static_cast<size_t>(b) * T + t) * Hq + h] = l_i[r] == 0.0f ? kNegInf : m_i[r] + logf(l);
  }
  write_rows<D>(out, acc, 1.0f, b, tw, T, Hq, h, lane);
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
    dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const int* __restrict__ start, const bf16* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, bf16* __restrict__ dq, int T, int S, int Hq, int Hkv, float scale,
              int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);    // [kBQ][D], pre-scaled
  float* dos = qs + kBQ * D;                         // [kBQ][D]
  bf16* ks = reinterpret_cast<bf16*>(dos + kBQ * D);  // [kBK][D + 2]
  bf16* vs = ks + kBK * (D + 2);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int t0 = blockIdx.x * kBQ;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int st = start[b];
  const int tw = t0 + warp * kRowsPerWarp;

  stage_rows<D>(q, qs, D, kBQ, b, t0, T, Hq, h, scale);
  stage_rows<D>(dout, dos, D, kBQ, b, t0, T, Hq, h, 1.0f);

  float lse_r[kRowsPerWarp], delta_r[kRowsPerWarp], acc[kRowsPerWarp][D / 32];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = min(tw + r, T - 1);
    lse_r[r] = lse[(static_cast<size_t>(b) * T + t) * Hq + h];
    delta_r[r] = delta[(static_cast<size_t>(b) * T + t) * Hq + h];
#pragma unroll
    for (int e = 0; e < D / 32; ++e) acc[r][e] = 0.0f;
  }

  int j_lo, j_hi;
  live_keys(t0, T, S, st, window, &j_lo, &j_hi);
  for (int j0 = j_lo; j0 < j_hi; j0 += kBK) {
    __syncthreads();
    stage_kv<D>(k, v, ks, vs, b, j0, S, Hkv, hk);
    __syncthreads();

    float s[kRowsPerWarp][2], dp[kRowsPerWarp][2];
    row_dots<D>(qs + warp * kRowsPerWarp * D, ks, lane, s);
    row_dots<D>(dos + warp * kRowsPerWarp * D, vs, lane, dp);
    float ds[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const bool valid = attends(tw + r, j0 + lane + 32 * kk, T, S, st, window);
        const float p = valid ? expf(s[r][kk] - lse_r[r]) : 0.0f;
        ds[r][kk] = p * (dp[r][kk] - delta_r[r]);
      }
    }
    weighted_rows<D>(ds, ks, lane, acc);
  }
  write_rows<D>(dq, acc, scale, b, tw, T, Hq, h, lane);
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
    dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               const int* __restrict__ start, const bf16* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int S,
               int Hq, int Hkv, float scale, int window) {
  constexpr int kLd = D + 1;  // f32 row stride: rows 4 apart fall in different banks
  constexpr int kE = D / 32;  // dims per lane: lane + 32 * e
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* kf = reinterpret_cast<float*>(smem_raw);  // [kBKV][kLd]
  float* vf = kf + kBKV * kLd;                     // [kBKV][kLd]
  float* qs = vf + kBKV * kLd;                     // [kQT][kLd], unscaled
  float* dos = qs + kQT * kLd;                     // [kQT][kLd]
  float* lse_s = dos + kQT * kLd;                  // [kQT]
  float* delta_s = lse_s + kQT;                    // [kQT]

  const int b = blockIdx.z;
  const int hk = blockIdx.y;
  const int j0 = blockIdx.x * kBKV;
  const int G = Hq / Hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int st = start[b];
  const int qi = lane & 15;                               // this lane's query of the step
  const int kw = warp * kKeysPerWarp + (lane >> 4) * 4;  // first of this lane's 4 keys

  for (int i = threadIdx.x; i < kBKV * D; i += blockDim.x) {
    const int r = i / D;
    const int d = i % D;
    const int j = j0 + r;
    float kv = 0.0f, vv = 0.0f;
    if (j < S) {
      const size_t off = ((static_cast<size_t>(b) * S + j) * Hkv + hk) * D + d;
      kv = __bfloat162float(k[off]);
      vv = __bfloat162float(v[off]);
    }
    kf[r * kLd + d] = kv;
    vf[r * kLd + d] = vv;
  }

  float acc_k[kKeysPerWarp][kE], acc_v[kKeysPerWarp][kE];
#pragma unroll
  for (int kk = 0; kk < kKeysPerWarp; ++kk)
#pragma unroll
    for (int e = 0; e < kE; ++e) acc_k[kk][e] = acc_v[kk][e] = 0.0f;

  // live queries of this key tile: t >= j >= max(j0, start); with a window
  // t < j + window
  int t_hi = T - 1;
  if (window > 0) t_hi = min(t_hi, j0 + kBKV - 1 + window - 1);
  const int t_lo = max(j0, st);
  const bool live = j0 + kBKV - 1 >= st && j0 < S && t_lo <= t_hi;

  for (int g = 0; live && g < G; ++g) {
    const int h = hk * G + g;
    for (int t0 = t_lo / kQT * kQT; t0 <= t_hi; t0 += kQT) {
      __syncthreads();  // the previous step is consumed (and kf/vf are written)
      stage_rows<D>(q, qs, kLd, kQT, b, t0, T, Hq, h, 1.0f);
      stage_rows<D>(dout, dos, kLd, kQT, b, t0, T, Hq, h, 1.0f);
      const int tq = static_cast<int>(threadIdx.x);
      if (tq < kQT) {
        const int t = min(t0 + tq, T - 1);
        lse_s[tq] = lse[(static_cast<size_t>(b) * T + t) * Hq + h];
        delta_s[tq] = delta[(static_cast<size_t>(b) * T + t) * Hq + h];
      }
      __syncthreads();

      // s and dO . v for (query qi, keys kw..kw+3)
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const float* qrow = qs + qi * kLd;
      const float* drow = dos + qi * kLd;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float qd = qrow[d];
        const float dd = drow[d];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[c] = fmaf(qd, kf[(kw + c) * kLd + d], s[c]);
          dp[c] = fmaf(dd, vf[(kw + c) * kLd + d], dp[c]);
        }
      }
      float p[4], ds[4];
      const int t = t0 + qi;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool valid = attends(t, j0 + kw + c, T, S, st, window);
        p[c] = valid ? expf(s[c] * scale - lse_s[qi]) : 0.0f;
        ds[c] = p[c] * (dp[c] - delta_s[qi]);
      }

      // dV[key] += p . dO rows, dK[key] += ds . q rows; key kk of the warp
      // and query qq are held by lane qq + 16 * (kk / 4), slot kk % 4
#pragma unroll
      for (int kk = 0; kk < kKeysPerWarp; ++kk) {
#pragma unroll 4
        for (int qq = 0; qq < kQT; ++qq) {
          const int src = qq + 16 * (kk >> 2);
          const float pv = __shfl_sync(0xffffffffu, p[kk & 3], src);
          const float dsv = __shfl_sync(0xffffffffu, ds[kk & 3], src);
#pragma unroll
          for (int e = 0; e < kE; ++e) {
            acc_v[kk][e] = fmaf(pv, dos[qq * kLd + lane + 32 * e], acc_v[kk][e]);
            acc_k[kk][e] = fmaf(dsv, qs[qq * kLd + lane + 32 * e], acc_k[kk][e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int kk = 0; kk < kKeysPerWarp; ++kk) {
    const int j = j0 + warp * kKeysPerWarp + kk;
    if (j >= S) continue;
    const size_t off = ((static_cast<size_t>(b) * S + j) * Hkv + hk) * D;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      dk[off + lane + 32 * e] = __float2bfloat16(acc_k[kk][e] * scale);
      dv[off + lane + 32 * e] = __float2bfloat16(acc_v[kk][e]);
    }
  }
}

template <int D>
int smem_fwd() {
  return kBQ * D * static_cast<int>(sizeof(float)) + 2 * kBK * (D + 2) * static_cast<int>(sizeof(bf16));
}

template <int D>
int smem_dq() {
  return 2 * kBQ * D * static_cast<int>(sizeof(float)) + 2 * kBK * (D + 2) * static_cast<int>(sizeof(bf16));
}

template <int D>
int smem_dkv() {
  return ((2 * kBKV + 2 * kQT) * (D + 1) + 2 * kQT) * static_cast<int>(sizeof(float));
}

template <int D>
int launch_fwd(const bf16* q, const bf16* k, const bf16* v, const int* start, bf16* out, float* lse, int B,
               int T, int S, int Hq, int Hkv, float scale, int window, cudaStream_t stream) {
  const int smem = smem_fwd<D>();
  cudaFuncSetAttribute(fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((T + kBQ - 1) / kBQ, Hq, B);
  fwd_kernel<D><<<grid, kWarps * 32, smem, stream>>>(q, k, v, start, out, lse, T, S, Hq, Hkv, scale, window);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const bf16* q, const bf16* k, const bf16* v, const int* start, const bf16* dout, const float* lse,
              const float* delta, bf16* dq, int B, int T, int S, int Hq, int Hkv, float scale, int window,
              cudaStream_t stream) {
  const int smem = smem_dq<D>();
  cudaFuncSetAttribute(dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((T + kBQ - 1) / kBQ, Hq, B);
  dq_kernel<D><<<grid, kWarps * 32, smem, stream>>>(q, k, v, start, dout, lse, delta, dq, T, S, Hq, Hkv, scale,
                                                    window);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const bf16* q, const bf16* k, const bf16* v, const int* start, const bf16* dout,
               const float* lse, const float* delta, bf16* dk, bf16* dv, int B, int T, int S, int Hq, int Hkv,
               float scale, int window, cudaStream_t stream) {
  const int smem = smem_dkv<D>();
  cudaFuncSetAttribute(dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((S + kBKV - 1) / kBKV, Hkv, B);
  dkv_kernel<D><<<grid, kWarps * 32, smem, stream>>>(q, k, v, start, dout, lse, delta, dk, dv, T, S, Hq, Hkv,
                                                     scale, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// window <= 0: no sliding window. D is 64 or 128.
extern "C" int flash_train_fwd_bf16(const void* q, const void* k, const void* v, const void* start, void* out,
                                    void* lse, int B, int T, int S, int Hq, int Hkv, int D, float scale,
                                    int window, void* stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const int* sp = static_cast<const int*>(start);
  bf16* op = static_cast<bf16*>(out);
  float* lp = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_fwd<64>(qp, kp, vp, sp, op, lp, B, T, S, Hq, Hkv, scale, window, st);
    case 128: return launch_fwd<128>(qp, kp, vp, sp, op, lp, B, T, S, Hq, Hkv, scale, window, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_train_dq_bf16(const void* q, const void* k, const void* v, const void* start,
                                   const void* dout, const void* lse, const void* delta, void* dq, int B, int T,
                                   int S, int Hq, int Hkv, int D, float scale, int window, void* stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const int* sp = static_cast<const int*>(start);
  const bf16* dop = static_cast<const bf16*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  bf16* dqp = static_cast<bf16*>(dq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_dq<64>(qp, kp, vp, sp, dop, lp, dl, dqp, B, T, S, Hq, Hkv, scale, window, st);
    case 128: return launch_dq<128>(qp, kp, vp, sp, dop, lp, dl, dqp, B, T, S, Hq, Hkv, scale, window, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_train_dkv_bf16(const void* q, const void* k, const void* v, const void* start,
                                    const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                                    int B, int T, int S, int Hq, int Hkv, int D, float scale, int window,
                                    void* stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const int* sp = static_cast<const int*>(start);
  const bf16* dop = static_cast<const bf16*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  bf16* dkp = static_cast<bf16*>(dk);
  bf16* dvp = static_cast<bf16*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dkv<64>(qp, kp, vp, sp, dop, lp, dl, dkp, dvp, B, T, S, Hq, Hkv, scale, window, st);
    case 128:
      return launch_dkv<128>(qp, kp, vp, sp, dop, lp, dl, dkp, dvp, B, T, S, Hq, Hkv, scale, window, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
