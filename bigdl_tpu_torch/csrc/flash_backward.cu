// Trainable causal flash attention for Hopper: the forward with per-row
// logsumexp and the two backward kernels, bf16 Q/K/V/dO, f32 sums.
//
// Replaces the Pallas kernels of bigdl_tpu/ops/pallas/flash_backward.py
// (wrapped by `flash_attention_trainable`): `_fwd_kernel` (flash_train_fwd),
// `_dq_kernel` (flash_train_dq) and `_dkv_kernel` (flash_train_dkv). It is
// kept apart from flash_attention.cu, the inference kernel, as the JAX
// package keeps its inference kernel apart. Contract: q, dO, out, dq
// [B, T, Hq, D]; k, v, dk, dv [B, S, Hkv, D] (the model's layout); lse and
// delta [B, T, Hq] f32. Query t of row b attends key j iff
//     start[b] <= j <= t   and   j > t - window (if window > 0),
// scores are (q . k) * scale, masked scores -1e30, and a row with no valid
// key (a left-pad row) has out = 0 and lse = -1e30. The backward recomputes
// P = exp(S - lse) per tile (zero where masked) with delta = rowsum(dO * O):
//     dS = P * (dO . V^T - delta),  dQ = scale * dS . K,
//     dK = scale * dS^T . Q (Q unscaled),  dV = P^T . dO.
//
// What bounds it: at the llama3-8b training shape (B = 1, T = 1024, 32 q
// heads over 8 kv heads, D = 128) the function's least time is set by
// operations (4, 6 and 8 * D flops per live (query, key) pair and q head
// against one read of q, k, v, dO), not bytes. The forward and dK/dV run
// their products on the tensor cores (mma.sync m16n8k16, bf16 operands,
// f32 sums); what bounds them now is mma.sync's rate (below wgmma's) and
// the shared-memory reads of ldmatrix that feed it, plus the forward's
// second P.V product (below). dQ still does all its math in f32 on the
// CUDA cores (later work).
//
// Design:
// * forward: one block per (64 queries, q head, batch row), the last query
//   tiles (the longest causal walks) dispatched first; four warps of 16
//   rows. Q's fragments are loaded once (ldmatrix); 64-key K and V tiles
//   stream through a two-stage cp.async ring, so the next tile loads while
//   this one computes. The block walks only the live key tiles (tiles
//   above the diagonal, before start[b] or outside the window are skipped)
//   and masks only the tiles that a mask cuts. S = Q.K^T runs as mma.sync;
//   scale is applied to S in f32 (not to a bf16 q). The online softmax
//   runs on the accumulator fragments (row max and sum across a quad's
//   four lanes). P.V feeds P as the A operand straight from the
//   accumulators, V through ldmatrix.trans, and carries P as a bf16 hi
//   part plus a bf16 lo part (P - hi) in two products into one f32 sum:
//   P rounded once to bf16 would err by ~2^-9 of a row's typical output,
//   more than one bf16 step of the outputs near 0.
// * dK/dV: one block per (64 keys, q head, batch row) from a schedule the
//   wrapper builds per shape (b, key tile, q heads, live query tiles),
//   heaviest first; start[b] is applied here. K and V stay in shared
//   memory; Q, dO, lse and delta tiles of 64 queries stream through a
//   two-stage cp.async ring. Per 16-query chunk each warp (16 keys) forms
//   S^T = K.Q^T and dP^T = V.dO^T by mma.sync, P^T = exp(S^T scale - lse)
//   (exactly 0 where masked) and dS^T = P^T (dP^T - delta) in f32, and
//   accumulates dV += P^T.dO and dK += dS^T.Q in f32 registers with P^T
//   and dS^T as bf16 A operands. The G q heads of a GQA group (up to 8;
//   beyond, a block walks G/8 heads) run as one thread-block cluster: each
//   block leaves its f32 dK/dV tile in its shared memory and, after a
//   cluster barrier, sums a slice of rows over the cluster's tiles in rank
//   order through distributed shared memory and stores it in bf16. No
//   atomics: the same bits from run to run. Keys no query attends get 0.
// * dQ: one block per (16 queries, q head, batch row), four warps of four
//   query rows, f32 on the CUDA cores; the block walks the live key tiles
//   of 64 keys, staged in shared memory with an odd 32-bit-word row stride
//   so the lane-per-key reads are free of bank conflicts.
//
// Each entry returns cudaGetLastError() after the launch; 0 means launched.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// dQ (CUDA cores)
constexpr int kRowsPerWarp = 4;
constexpr int kWarps = 4;
constexpr int kBQ = kRowsPerWarp * kWarps;  // query rows per dQ block
constexpr int kBK = 64;                     // key slots per tile of the dQ walk
// forward and dK/dV (tensor cores): four warps of 16 rows
constexpr int kTile = 64;  // queries of a forward block, keys of a dK/dV block, and each walk's step
constexpr int kTcThreads = 128;
constexpr int kWorkInts = 6;  // a row of the dK/dV schedule (see dkv_kernel)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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


// Rows r0 .. r0 + kTile - 1 of head h of a [B, R, H, D] bf16 tensor into a
// [kTile][D + 8] shared tile by cp.async (16 bytes a piece); rows past R
// load as zeros. The odd 16-byte row stride keeps ldmatrix conflict-free.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, int b, int r0, int R, int H,
                                          int h) {
  constexpr int kLd = D + 8;
  constexpr int kPieces = D / 8;
#pragma unroll
  for (int i = 0; i < kTile * kPieces / kTcThreads; ++i) {
    const int e = static_cast<int>(threadIdx.x) + i * kTcThreads;
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

// Tile pairs where every (query, key) pair attends need no mask.
__device__ __forceinline__ bool whole_tile(int t0, int j0, int T, int S, int st, int window) {
  return j0 >= st && j0 + kTile - 1 <= t0 && t0 + kTile <= T && j0 + kTile <= S &&
         (window <= 0 || j0 > t0 + kTile - 1 - window);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
    fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               const int* __restrict__ start, bf16* __restrict__ out, float* __restrict__ lse, int T, int S,
               int Hq, int Hkv, float scale, int window) {
  constexpr int kLd = D + 8;
  constexpr int kKs = D / 16;  // k steps of Q.K^T
  constexpr int kNd = D / 8;   // n tiles of the output
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kTile][kLd]
  bf16* ks = qs + kTile * kLd;                   // [2][kTile][kLd]
  bf16* vs = ks + 2 * kTile * kLd;               // [2][kTile][kLd]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int t0 = (gridDim.z - 1 - blockIdx.z) * kTile;  // the longest walks first
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;  // fragment row (and row + 8)
  const int qd = lane & 3;   // fragment column pair
  const int st = start[b];

  // live key tiles of rows t0 .. t0 + kTile - 1
  const int j_hi = min(S, min(t0 + kTile, T));
  int lo = st;
  if (window > 0) lo = max(lo, t0 - window + 1);
  const int j_lo = max(lo, 0) / kTile * kTile;
  const int n_tiles = j_hi > j_lo ? (j_hi - j_lo + kTile - 1) / kTile : 0;

  load_tile<D>(qs, q, b, t0, T, Hq, h);
  cp_async_commit();
  if (n_tiles > 0) {
    load_tile<D>(ks, k, b, j_lo, S, Hkv, hk);
    load_tile<D>(vs, v, b, j_lo, S, Hkv, hk);
  }
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();
  uint32_t qa[kKs][4];
#pragma unroll
  for (int kk = 0; kk < kKs; ++kk)
    ldmatrix_x4(qa[kk], qs + (warp * 16 + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8);

  const float sl2 = scale * kLog2e;
  const int r0 = t0 + warp * 16 + gr;     // this thread's rows r0 and r0 + 8
  float m[2] = {kNegInf, kNegInf};        // running row max of S * scale * log2(e)
  float l[2] = {0.0f, 0.0f};              // this lane's share of the running row sum
  float o[kNd][4];
#pragma unroll
  for (int n = 0; n < kNd; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = j_lo + it * kTile;
    const int cur = it & 1;
    if (it + 1 < n_tiles) {
      load_tile<D>(ks + (cur ^ 1) * kTile * kLd, k, b, j0 + kTile, S, Hkv, hk);
      load_tile<D>(vs + (cur ^ 1) * kTile * kLd, v, b, j0 + kTile, S, Hkv, hk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed
    __syncthreads();
    const bf16* kt = ks + cur * kTile * kLd;
    const bf16* vt = vs + cur * kTile * kLd;

    // S = Q.K^T: 16 rows x 64 keys a warp, n tile n = keys 8n ..
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kKs; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        ldmatrix_x4(kb, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qa[kk], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qa[kk], kb[2], kb[3]);
      }
    }

    // online softmax in the log2 domain; masked scores are exactly kNegInf
    const bool edge = !whole_tile(t0, j0, T, S, st, window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sl2;
        if (edge && !attends(r0 + (e >> 1) * 8, j0 + n * 8 + 2 * qd + (e & 1), T, S, st, window)) x = kNegInf;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float mu[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mn = fmaxf(m[i], quad_max(mx[i]));
      // a row with no valid key yet keeps l = 0 and o = 0: exp2(kNegInf) = 0
      mu[i] = mn == kNegInf ? 0.0f : mn;
      const float alpha = exp2f(m[i] - mu[i]);
      m[i] = mn;
      l[i] *= alpha;
#pragma unroll
      for (int n = 0; n < kNd; ++n) {
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

    // o += P.V, P as bf16 hi + lo; A fragments of 16 keys straight from
    // the accumulators of n tiles 2 kc and 2 kc + 1
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kc][0], s[2 * kc][1], ph[0], pl[0]);
      split_bf16(s[2 * kc][2], s[2 * kc][3], ph[1], pl[1]);
      split_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vt + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd + dn * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dn], ph, vb[0], vb[1]);
        mma_bf16(o[2 * dn], pl, vb[0], vb[1]);
        mma_bf16(o[2 * dn + 1], ph, vb[2], vb[3]);
        mma_bf16(o[2 * dn + 1], pl, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this stage is consumed before the next load refills it
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = quad_sum(l[i]);
    const int t = r0 + 8 * i;
    if (t >= T) continue;
    const bool none = li == 0.0f;  // no valid key: out = 0, lse = -1e30
    const float div = none ? 1.0f : li;
    bf16* row = out + (static_cast<size_t>(b) * T + t) * Hq * D + static_cast<size_t>(h) * D;
#pragma unroll
    for (int n = 0; n < kNd; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + n * 8 + 2 * qd) =
          __floats2bfloat162_rn(o[n][2 * i] / div, o[n][2 * i + 1] / div);
    if (qd == 0) lse[(static_cast<size_t>(b) * T + t) * Hq + h] = none ? kNegInf : m[i] * kLn2 + logf(li);
  }
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


// work: one row of kWorkInts ints a block, the wrapper's schedule
// (ops/kernels/flash_backward.py `dkv_schedule`): batch row, key tile,
// first q head, q heads, first and last live query tile (start aside).
// The rows of one cluster share the batch row, key tile and kv head; the
// block of rank r takes the r-th run of q heads of the group.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
    dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               const int* __restrict__ start, const bf16* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
               const int* __restrict__ work, int T, int S, int Hq, int Hkv, float scale, int window) {
  constexpr int kLd = D + 8;
  constexpr int kLdF = D + 8;  // f32 row stride of the reduction tiles
  constexpr int kKs = D / 16;
  constexpr int kNd = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);                  // [kTile][kLd], resident
  bf16* vs = ks + kTile * kLd;                                   // [kTile][kLd], resident
  bf16* ring = vs + kTile * kLd;                                 // [2][q, dO][kTile][kLd]
  float* stats = reinterpret_cast<float*>(ring + 4 * kTile * kLd);  // [2][lse, delta][kTile]
  float* red = reinterpret_cast<float*>(ring);                   // after the walk: [dK, dV][kTile][kLdF]

  cg::cluster_group cluster = cg::this_cluster();
  const int* w = work + static_cast<size_t>(blockIdx.x) * kWorkInts;
  const int b = w[0];
  const int j0 = w[1] * kTile;
  const int h0 = w[2];
  const int nh = w[3];
  const int hk = h0 / (Hq / Hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;
  const int qd = lane & 3;
  const int st = start[b];

  // query rows before start[b] attend nothing; so does every query if the
  // whole key tile lies before it
  const int qt_lo = max(w[4], st / kTile);
  const int n_qt = j0 + kTile - 1 >= st ? max(w[5] - qt_lo + 1, 0) : 0;
  const int n_steps = n_qt * nh;

  auto load_step = [&](int step, int stage) {
    const int h = h0 + step / n_qt;
    const int t0 = (qt_lo + step % n_qt) * kTile;
    bf16* qt = ring + stage * 2 * kTile * kLd;
    load_tile<D>(qt, q, b, t0, T, Hq, h);
    load_tile<D>(qt + kTile * kLd, dout, b, t0, T, Hq, h);
    const int r = threadIdx.x & (kTile - 1);
    const int t = t0 + r;
    const bool ok = t < T;
    const size_t off = (static_cast<size_t>(b) * T + (ok ? t : 0)) * Hq + h;
    float* sp = stats + stage * 2 * kTile + (threadIdx.x < kTile ? 0 : kTile) + r;
    cp_async4(sp, (threadIdx.x < kTile ? lse : delta) + off, ok ? 4 : 0);
  };

  float dka[kNd][4], dva[kNd][4];
#pragma unroll
  for (int n = 0; n < kNd; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.0f;

  if (n_steps > 0) {
    load_tile<D>(ks, k, b, j0, S, Hkv, hk);
    load_tile<D>(vs, v, b, j0, S, Hkv, hk);
    load_step(0, 0);
  }
  cp_async_commit();

  const float sl2 = scale * kLog2e;
  const int jr = j0 + warp * 16 + gr;  // this thread's keys jr and jr + 8
  for (int step = 0; step < n_steps; ++step) {
    const int cur = step & 1;
    if (step + 1 < n_steps) load_step(step + 1, cur ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this step's tiles have landed
    __syncthreads();
    const int t0 = (qt_lo + step % n_qt) * kTile;
    const bf16* qt = ring + cur * 2 * kTile * kLd;
    const bf16* dt = qt + kTile * kLd;
    const float* lse_s = stats + cur * 2 * kTile;
    const float* delta_s = lse_s + kTile;
    const bool edge = !whole_tile(t0, j0, T, S, st, window);

#pragma unroll 1
    for (int c = 0; c < kTile / 16; ++c) {
      // S^T = K.Q^T and dP^T = V.dO^T: this warp's 16 keys x 16 queries
      float sT[2][4], dpT[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[n][e] = dpT[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kKs; ++kk) {
        uint32_t ka[4], va[4], qb[4], db[4];
        const int a_off = (warp * 16 + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8;
        const int b_off = (c * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd + kk * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(ka, ks + a_off);
        ldmatrix_x4(va, vs + a_off);
        ldmatrix_x4(qb, qt + b_off);
        ldmatrix_x4(db, dt + b_off);
        mma_bf16(sT[0], ka, qb[0], qb[1]);
        mma_bf16(sT[1], ka, qb[2], qb[3]);
        mma_bf16(dpT[0], va, db[0], db[1]);
        mma_bf16(dpT[1], va, db[2], db[3]);
      }

      // P^T and dS^T in f32, then as bf16 A fragments (16 keys x 16
      // queries): n tile n holds queries 8n .. of the chunk
      uint32_t pa[4], dsa[4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int cq = c * 16 + n * 8 + 2 * qd;
        const float2 ls = *reinterpret_cast<const float2*>(lse_s + cq);
        const float2 dl = *reinterpret_cast<const float2*>(delta_s + cq);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lv = (e & 1) ? ls.y : ls.x;
          const float dlv = (e & 1) ? dl.y : dl.x;
          float pe = exp2f(sT[n][e] * sl2 - lv * kLog2e);
          if (edge && !attends(t0 + cq + (e & 1), jr + (e >> 1) * 8, T, S, st, window)) pe = 0.0f;
          p[e] = pe;
          ds[e] = pe * (dpT[n][e] - dlv);
        }
        pa[2 * n] = pack_bf16(p[0], p[1]);
        pa[2 * n + 1] = pack_bf16(p[2], p[3]);
        dsa[2 * n] = pack_bf16(ds[0], ds[1]);
        dsa[2 * n + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dV += P^T.dO, dK += dS^T.Q: B fragments through ldmatrix.trans
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t ob[4], qb[4];
        const int off = (c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd + dn * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(ob, dt + off);
        ldmatrix_x4_trans(qb, qt + off);
        mma_bf16(dva[2 * dn], pa, ob[0], ob[1]);
        mma_bf16(dva[2 * dn + 1], pa, ob[2], ob[3]);
        mma_bf16(dka[2 * dn], dsa, qb[0], qb[1]);
        mma_bf16(dka[2 * dn + 1], dsa, qb[2], qb[3]);
      }
    }
    __syncthreads();  // this stage is consumed before the next load refills it
  }

  // the ring is idle: leave this block's f32 tiles there for the cluster
  cp_async_wait<0>();
  __syncthreads();
  float* rk = red;
  float* rv = red + kTile * kLdF;
#pragma unroll
  for (int n = 0; n < kNd; ++n) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int off = (warp * 16 + gr + 8 * i) * kLdF + n * 8 + 2 * qd;
      *reinterpret_cast<float2*>(rk + off) = make_float2(dka[n][2 * i], dka[n][2 * i + 1]);
      *reinterpret_cast<float2*>(rv + off) = make_float2(dva[n][2 * i], dva[n][2 * i + 1]);
    }
  }
  cluster.sync();

  // rank r sums its slice of the 64 rows over the cluster's tiles, in rank
  // order, and stores them
  const int C = static_cast<int>(cluster.num_blocks());
  const int rows = (kTile + C - 1) / C;
  const int r_lo = static_cast<int>(cluster.block_rank()) * rows;
  const int r_hi = min(kTile, r_lo + rows);
  for (int e = threadIdx.x; e < (r_hi - r_lo) * (D / 4); e += kTcThreads) {
    const int r = r_lo + e / (D / 4);
    const int c4 = (e % (D / 4)) * 4;
    float4 sk = make_float4(0.0f, 0.0f, 0.0f, 0.0f), sv = sk;
    for (int g = 0; g < C; ++g) {
      const float4 a = *reinterpret_cast<const float4*>(cluster.map_shared_rank(rk, g) + r * kLdF + c4);
      const float4 u = *reinterpret_cast<const float4*>(cluster.map_shared_rank(rv, g) + r * kLdF + c4);
      sk.x += a.x, sk.y += a.y, sk.z += a.z, sk.w += a.w;
      sv.x += u.x, sv.y += u.y, sv.z += u.z, sv.w += u.w;
    }
    const int j = j0 + r;
    if (j < S) {
      const size_t off = ((static_cast<size_t>(b) * S + j) * Hkv + hk) * D + c4;
      *reinterpret_cast<uint2*>(dk + off) =
          make_uint2(pack_bf16(sk.x * scale, sk.y * scale), pack_bf16(sk.z * scale, sk.w * scale));
      *reinterpret_cast<uint2*>(dv + off) = make_uint2(pack_bf16(sv.x, sv.y), pack_bf16(sv.z, sv.w));
    }
  }
  cluster.sync();  // no block leaves while another reads its tiles
}

template <int D>
int smem_fwd() {  // Q and two stages of K and V
  return 5 * kTile * (D + 8) * static_cast<int>(sizeof(bf16));
}

template <int D>
int smem_dkv() {  // K, V and two stages of Q, dO, lse and delta
  return 6 * kTile * (D + 8) * static_cast<int>(sizeof(bf16)) + 4 * kTile * static_cast<int>(sizeof(float));
}

template <int D>
int smem_dq() {
  return 2 * kBQ * D * static_cast<int>(sizeof(float)) + 2 * kBK * (D + 2) * static_cast<int>(sizeof(bf16));
}

template <int D>
int launch_fwd(const bf16* q, const bf16* k, const bf16* v, const int* start, bf16* out, float* lse, int B,
               int T, int S, int Hq, int Hkv, float scale, int window, cudaStream_t stream) {
  const int smem = smem_fwd<D>();
  cudaFuncSetAttribute(fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid(Hq, B, (T + kTile - 1) / kTile);
  fwd_kernel<D><<<grid, kTcThreads, smem, stream>>>(q, k, v, start, out, lse, T, S, Hq, Hkv, scale, window);
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
               const float* lse, const float* delta, bf16* dk, bf16* dv, const int* work, int n_blocks,
               int cluster, int T, int S, int Hq, int Hkv, float scale, int window, cudaStream_t stream) {
  const int smem = smem_dkv<D>();
  cudaFuncSetAttribute(dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_blocks);
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, dkv_kernel<D>, q, k, v, start, dout, lse, delta, dk, dv, work,
                                             T, S, Hq, Hkv, scale, window);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
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

// work: n_blocks rows of the wrapper's schedule, launched as clusters of
// `cluster` blocks (n_blocks a multiple of it, at most 8).
extern "C" int flash_train_dkv_bf16(const void* q, const void* k, const void* v, const void* start,
                                    const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                                    int B, int T, int S, int Hq, int Hkv, int D, float scale, int window,
                                    const void* work, int n_blocks, int cluster, void* stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const int* sp = static_cast<const int*>(start);
  const bf16* dop = static_cast<const bf16*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  bf16* dkp = static_cast<bf16*>(dk);
  bf16* dvp = static_cast<bf16*>(dv);
  const int* wp = static_cast<const int*>(work);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  (void)B;  // the schedule names each block's batch row
  switch (D) {
    case 64:
      return launch_dkv<64>(qp, kp, vp, sp, dop, lp, dl, dkp, dvp, wp, n_blocks, cluster, T, S, Hq, Hkv, scale,
                            window, st);
    case 128:
      return launch_dkv<128>(qp, kp, vp, sp, dop, lp, dl, dkp, dvp, wp, n_blocks, cluster, T, S, Hq, Hkv, scale,
                             window, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
