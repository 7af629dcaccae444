// Trainable causal flash attention for Hopper: the forward with per-row
// logsumexp and the two backward kernels, bf16 Q/K/V/dO, f32 sums.
//
// Replaces the Pallas kernels of bigdl_tpu/ops/pallas/flash_backward.py
// (wrapped by `flash_attention_trainable`): `_fwd_kernel` (flash_train_fwd),
// `_dq_kernel` (flash_train_dq) and `_dkv_kernel` (flash_train_dkv). It is
// kept apart from flash_attention.cu, the inference kernel, as the JAX
// package keeps its inference kernel apart; the two share the tile
// helpers of flash_tc.cuh. Contract: q, dO, out, dq [B, T, Hq, D]; k, v,
// dk, dv [B, S, Hkv, D] (the model's layout); lse and delta [B, T, Hq]
// f32. Query t of row b attends key j iff
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
// against one read of q, k, v, dO), not bytes. All three kernels run their
// products on the tensor cores (mma.sync m16n8k16, bf16 operands, f32
// sums); what bounds them now is mma.sync's rate (below wgmma's) and the
// shared-memory reads of ldmatrix that feed it, plus the forward's second
// P.V product (flash_tc.cuh's pv_tile).
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
//   four lanes); P.V carries P as bf16 hi + lo (pv_tile).
// * dQ: the forward's Q-major walk. One block per (64 queries, q head,
//   batch row), longest walks first, four warps of 16 rows; Q and dO tiles
//   stay in shared memory and their fragments are read per k step (held
//   in registers with dQ's 64 f32 sums and a tile's S and dP they would
//   pass 255 registers at D = 128); each thread loads its rows' lse and
//   delta once. Per live key tile (two-stage cp.async ring of K and V):
//   S = Q.K^T and dP = dO.V^T by mma.sync, P = exp2(S scale log2(e) -
//   lse log2(e)) (exactly 0 where masked, so a left-pad row, lse = -1e30,
//   gets dQ = 0) and dS = P (dP - delta) in f32 on the fragments, then
//   dQ += dS.K with dS rounded once to bf16 as the A operand straight from
//   the accumulators and K through ldmatrix.trans. The block owns its rows:
//   no atomics, no cross-block sum, the same bits from run to run.
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
//
// Each entry returns cudaGetLastError() after the launch; 0 means launched.

#include <cooperative_groups.h>

#include "flash_tc.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWorkInts = 6;  // a row of the dK/dV schedule (see dkv_kernel)

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
  int j_lo;
  const int n_tiles = live_tiles(t0, min(t0 + kTile, T) - 1, S, st, window, &j_lo);

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
  for (int kk = 0; kk < kKs; ++kk) row_frag<D>(qa[kk], qs + warp * 16 * kLd, kk, lane);

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

    // S = Q.K^T: 16 rows x 64 keys a warp; masked scores exactly kNegInf
    float s[8][4];
    key_dots<D>(s, qa, kt, lane);
    const bool edge = !whole_tile(t0, t0, j0, T, S, st, window);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = r0 + (e >> 1) * 8;
        float x = s[n][e] * sl2;
        if (edge && !attends(t, t, j0 + n * 8 + 2 * qd + (e & 1), T, S, st, window)) x = kNegInf;
        s[n][e] = x;
      }
    }
    softmax_tile<kNd>(s, m, l, o);
    pv_tile<D, kNd>(o, s, vt, 0, lane);
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
__global__ void __launch_bounds__(kTcThreads, 2)
    dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const int* __restrict__ start, const bf16* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, bf16* __restrict__ dq, int T, int S, int Hq, int Hkv, float scale,
              int window) {
  constexpr int kLd = D + 8;
  constexpr int kNd = D / 8;  // n tiles of dQ
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kTile][kLd]
  bf16* dos = qs + kTile * kLd;                  // [kTile][kLd]
  bf16* ks = dos + kTile * kLd;                  // [2][kTile][kLd]
  bf16* vs = ks + 2 * kTile * kLd;               // [2][kTile][kLd]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int t0 = (gridDim.z - 1 - blockIdx.z) * kTile;  // the longest walks first
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;
  const int qd = lane & 3;
  const int st = start[b];
  int j_lo;
  const int n_tiles = live_tiles(t0, min(t0 + kTile, T) - 1, S, st, window, &j_lo);

  load_tile<D>(qs, q, b, t0, T, Hq, h);
  load_tile<D>(dos, dout, b, t0, T, Hq, h);
  if (n_tiles > 0) {
    load_tile<D>(ks, k, b, j_lo, S, Hkv, hk);
    load_tile<D>(vs, v, b, j_lo, S, Hkv, hk);
  }
  cp_async_commit();

  // this thread's rows r0 and r0 + 8: lse in the log2 domain, and delta
  const int r0 = t0 + warp * 16 + gr;
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t off = (static_cast<size_t>(b) * T + min(r0 + 8 * i, T - 1)) * Hq + h;
    lse2[i] = lse[off] * kLog2e;
    dl[i] = delta[off];
  }
  const float sl2 = scale * kLog2e;
  const bf16* qrows = qs + warp * 16 * kLd;
  const bf16* drows = dos + warp * 16 * kLd;
  float acc[kNd][4];
#pragma unroll
  for (int n = 0; n < kNd; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = j_lo + it * kTile;
    const int cur = it & 1;
    if (it + 1 < n_tiles) {
      load_tile<D>(ks + (cur ^ 1) * kTile * kLd, k, b, j0 + kTile, S, Hkv, hk);
      load_tile<D>(vs + (cur ^ 1) * kTile * kLd, v, b, j0 + kTile, S, Hkv, hk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and, first, Q and dO) has landed
    __syncthreads();
    const bf16* kt = ks + cur * kTile * kLd;
    const bf16* vt = vs + cur * kTile * kLd;

    float s[8][4], dp[8][4];
    key_dots<D>(s, qrows, kt, lane);   // S = Q.K^T
    key_dots<D>(dp, drows, vt, lane);  // dP = dO.V^T
    // dS = P (dP - delta) in dp, P exactly 0 where masked
    const bool edge = !whole_tile(t0, t0, j0, T, S, st, window);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = r0 + (e >> 1) * 8;
        float p = exp2f(s[n][e] * sl2 - lse2[e >> 1]);
        if (edge && !attends(t, t, j0 + n * 8 + 2 * qd + (e & 1), T, S, st, window)) p = 0.0f;
        dp[n][e] = p * (dp[n][e] - dl[e >> 1]);
      }
    }

    // dQ += dS.K: dS (bf16) A fragments of 16 keys from the accumulators
    // of n tiles 2 kc and 2 kc + 1, K through ldmatrix.trans
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t da[4];
      da[0] = pack_bf16(dp[2 * kc][0], dp[2 * kc][1]);
      da[1] = pack_bf16(dp[2 * kc][2], dp[2 * kc][3]);
      da[2] = pack_bf16(dp[2 * kc + 1][0], dp[2 * kc + 1][1]);
      da[3] = pack_bf16(dp[2 * kc + 1][2], dp[2 * kc + 1][3]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, kt + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd + dn * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dn], da, kb[0], kb[1]);
        mma_bf16(acc[2 * dn + 1], da, kb[2], kb[3]);
      }
    }
    __syncthreads();  // this stage is consumed before the next load refills it
  }
  cp_async_wait<0>();  // no walk: Q and dO may still be in flight

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = r0 + 8 * i;
    if (t >= T) continue;
    bf16* row = dq + (static_cast<size_t>(b) * T + t) * Hq * D + static_cast<size_t>(h) * D;
#pragma unroll
    for (int n = 0; n < kNd; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + n * 8 + 2 * qd) =
          __floats2bfloat162_rn(acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
  }
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
    const bool edge = !whole_tile(t0, t0, j0, T, S, st, window);

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
          const int t = t0 + cq + (e & 1);
          if (edge && !attends(t, t, jr + (e >> 1) * 8, T, S, st, window)) pe = 0.0f;
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
int smem_dq() {  // Q, dO and two stages of K and V
  return 6 * kTile * (D + 8) * static_cast<int>(sizeof(bf16));
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
  const dim3 grid(Hq, B, (T + kTile - 1) / kTile);
  dq_kernel<D><<<grid, kTcThreads, smem, stream>>>(q, k, v, start, dout, lse, delta, dq, T, S, Hq, Hkv, scale,
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
