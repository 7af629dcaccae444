// Fused dequant-matmul for Hopper, every weight format:
// y[M, O] = x[M, K] . dequant(W)[O, K]^T.
//
// Replaces the Pallas kernel bigdl_tpu/ops/pallas/qmatmul.py `_kernel`
// (launched by `_qmm`, wrapped by `qmatmul` and `qmatmul_lora`), with its
// decode from ops/pallas/qdecode.py `decode_chunk` (qdecode.cuh). This
// source builds once per weight format, `-DBIGDL_QFMT=QF_<qtype>` (the
// build names the library by qtype), into three entries:
//
// * qmatmul_gemv (M <= 32, decode): bound by the bytes of the packed
//   weight (0.39-1.07 B per weight with its scales, by format). A design
//   that decoded and multiplied on the CUDA cores (~14 instructions a
//   weight at M = 4, ~22 at M = 8) sat at 5x its byte bound and lost to
//   cuBLAS on the weight dequantized beforehand. This one (`gemv_kernel`,
//   its note below) multiplies on the tensor cores (mma.sync m16n8k16,
//   the decoded weights as the A fragment in registers), decodes with
//   qdecode16_tc (~4 instructions a weight, whatever M is), streams the
//   packed bytes through per-warp cp.async rings with no barrier in the K
//   walk, and splits K over a cluster where the rows alone would not give
//   every SM two blocks.
// * qmatmul_gemm (M > 32, prefill): bound by operations at large M (at
//   M = 1024 each packed byte feeds >= 2 * 1024 flops, far above the ~295
//   flops a byte where the bf16 tensor cores stop waiting on memory). A
//   single-buffered design lost 4.5x to cuBLAS on the weight dequantized
//   beforehand: each K step loaded, decoded (~10 instructions an element,
//   on the MMA warps), synchronised and multiplied in series, 64 elements
//   deep. This design (qtile.cuh) takes the decode and the loads off the
//   tensor-core warps: decoder warps keep a ring of 3-6 stages of x tiles
//   and packed weight bytes in flight with cp.async and decode each step's
//   128 weight rows once per block, one step ahead, into a ring of two
//   bf16 tiles (qdecode16_tc: the same bits in about half the
//   instructions); one or two warpgroups multiply them with wgmma
//   m64n128k16 from shared memory, each step's products from zero added
//   to f32 sums round to nearest. A block is 128 output columns by 64 or
//   128 rows of x (ops/kernels/qtile.py gemm_tile), the grid walks
//   M fastest so that the blocks of one weight tile run together and share
//   it through the L2. A step is 128 elements of K (64 for the byte
//   formats, qtile::step_depth): the groups of 128/S j positions, all S
//   segments, the column order of the weight's planes, which a
//   contraction does not see; x_order_kernel first writes x in that order, so that each step's
//   x tile is contiguous. The epilogue stores bf16 pairs from the
//   accumulators. No TMA yet.
// * the LoRA arm of `_kernel` (`qmatmul_lora`): y = x . dq(W)^T +
//   bf16((x . A_cat^T) * gate) . B_cat^T for any R adapter columns that
//   the JAX package's `lora_fused_ok` admits (A_cat up to 4 MB). The TPU
//   kernel keeps A_cat resident in VMEM and recomputes x . A_cat^T for
//   every output tile; here A_cat fits no shared memory, and reading it
//   once per output block would multiply its bytes by the block count. So
//   each entry is two launches on one stream: a first pass computes
//   x . A_cat^T once (f32 sums, reading A_cat once), xg = bf16(xa * gate)
//   is rounded once (the reference's point), and the dequant kernel adds
//   xg . B_cat^T to its f32 accumulator before the one bf16 rounding of y,
//   reading B_cat once. A zero gate gives xg = 0 and adds exactly 0,
//   so a base row of a mixed batch gets the plain form's bits.
//   - qmatmul_gemv_lora (M <= 32, serving decode and short prefill
//     tails): the first pass on the tensor cores, split over K into f32
//     partials (`lora_xa_split_kernel`, at least a wave of blocks) that
//     the last block of each adapter tile sums, gates and rounds once
//     (so xg is the one-pass value); then the GEMV, whose last cluster
//     rank runs the adapter columns as a tail of its K walk through the
//     same MMAs.
//   - qmatmul_gemm_lora (M > 32, prefill and training): the first pass on
//     the tensor cores (`lora_xa_tc_kernel`, 16 x 32 tiles of xa, its 4
//     warps splitting the K walk, wmma, each step summed from zero), then the GEMM, whose decoder
//     warps stage kDepth columns of xg and of its B_cat rows a step after
//     the K walk, run through the same MMA warps.
//
// All return cudaGetLastError() after the launch; 0 means launched.

#include <cooperative_groups.h>
#include <mma.h>

#include "qtile.cuh"

#ifndef BIGDL_QFMT
#error "build with -DBIGDL_QFMT=QF_<qtype> (ops/kernels/_build.py does)"
#endif

namespace {

using Fmt = BIGDL_QFMT;
constexpr int kS = Fmt::kS;
namespace cg = cooperative_groups;

// ---------------------------------------------------------------- GEMV
// The decode GEMV (M <= 32) on the tensor cores: mma.sync m16n8k16, the
// decoded weights as the A fragment in registers (16 weight rows), x as the
// B fragment (8 rows of x a n-tile, NT = 1, 2 or 4 n-tiles).
//
// * The contraction's order is free, so a lane's decoded run maps straight
//   onto its fragment slots: lane (g, q) (g = lane / 4, q = lane % 4)
//   decodes the 16 elements of one group (qdecode.cuh: u*Q + j .. + 15,
//   j = j0 + 16 q) of rows g and g + 8 into 8 bf16 pairs each, and k-tile
//   t of the group's 4 takes pairs 2t and 2t + 1 as the slots (2q, 2q + 1)
//   and (2q + 8, 2q + 9) of a0/a2 (row g) and a1/a3 (row g + 8). Its B
//   fragment is the same 16 elements of x's row g (+ 8 n-tile), read from
//   shared memory as two 16-byte vectors: the k-slot 2q + e of a tile
//   means "element 4t + e of group q" for every row and column alike
//   (ops/kernels/qtile.py gemv_k_order mirrors the order).
// * A warp owns 16 weight rows and walks steps of 64 j positions (4 lanes
//   x 16), decoding all S groups of each from the same pieces, so every
//   packed byte is read once. Its packed bytes arrive through a private
//   ring of cp.async stages (4, or 2 for the multi-piece formats) in
//   shared memory: each lane copies exactly the 16-byte pieces it decodes,
//   so a lane's cp.async.wait_group is the only wait — no barrier sits in
//   the K walk. Where a 16-byte piece holds 16 j positions a lane takes
//   two of them a step (the four lanes of a row then read 128 contiguous
//   bytes of its row). The scale fields of a step are read into
//   registers a step ahead of their decode.
// * A block is 8 warps: WR tiles of 16 rows by WK = 8 / WR warps that take
//   the block's steps in turn; x's columns of the block's j positions (all
//   S segments) are staged once in shared memory. Where O / (16 WR) blocks
//   would not give every SM two, the K walk is split over a cluster of KC
//   blocks (each a contiguous range of steps); the partials are summed
//   through shared memory, the warps' in warp order, the cluster's ranks'
//   in rank order over distributed shared memory: no atomics, the same
//   bits on every launch. ops/kernels/qtile.py `gemv_tile` picks WR and KC.
// * The LoRA arm: the first pass (`lora_xa_split_kernel`) splits K over
//   blocks into f32 partials [KS, M, R], and the last block of an adapter
//   tile sums them in order, multiplies by the gate and rounds once to
//   bf16 (xg). The last rank of each cluster stages xg in shared memory
//   and runs the R adapter columns as a tail of its K walk through the
//   same MMAs: xg as x's extra columns, B_cat's rows as extra bf16 weight
//   columns with no decode. A zero gate row adds exact
//   zeros after the same K walk, so it keeps the plain GEMV's bits.
// warps a block: 8, or 16 where a thread holds few registers (the
// formats of two j-blocks a step, one n-tile); gemv_tile picks
constexpr int kGemvMaxWarps = Fmt::kPieces == 1 && kS <= 2 ? 16 : 8;
__host__ __device__ constexpr int gemv_max_warps(int NT) { return NT >= 2 ? 8 : kGemvMaxWarps; }
// j-blocks of 16 a lane takes in a step: where one piece holds 16 j (and
// a j decodes to at most 2 groups, so the scale fields of two blocks fit
// the registers), the four lanes of a row read 128 contiguous bytes of a
// plane's row (lane q the blocks at 16 q and 64 + 16 q, so that their x
// reads stay free of bank conflicts)
constexpr int kJW = Fmt::kPieces == 1 && kS <= 2 ? 2 : 1;
constexpr int kJStep = 64 * kJW;                        // j positions of a warp's step
constexpr int kTailStep = 64;                           // adapter columns of a tail step
constexpr int kGemvStages = Fmt::kPieces == 1 ? 4 : 2;  // ring slots of a warp
constexpr int kLutBytes = 16 * 4;

constexpr int kRingSlot = 2 * kJW * Fmt::kPieces * 32 * 16;  // rows g, g + 8 x j-blocks x pieces x 32 lanes x 16 B
// the partial sums reuse the rings: 8 warps x 16 rows x 8 NT columns f32
// the partial sums reuse the rings: 16 rows x 32 columns f32 a warp at most
static_assert(16 * 32 * 4 <= kGemvStages * kRingSlot, "the partials fit the rings");

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

// Steps of the K walk and of one cluster rank's share.
__host__ __device__ inline int gemv_steps(int K) { return (K / kS + kJStep - 1) / kJStep; }

// Dynamic shared memory of a launch (ops/kernels/qtile.py gemv_smem):
// the codebook, x's columns of a rank's steps (rows 16 bytes apart past
// their width, so the two rows a quarter-warp reads fall in distinct
// banks), xg with the LoRA arm (R > 0), the warps' rings.
inline int gemv_smem(int M, int K, int kc, int R, int warps) {
  const int spb = (gemv_steps(K) + kc - 1) / kc;
  const int xbytes = M * (kS * spb * kJStep * 2 + 16);
  const int gbytes = R > 0 ? M * (round_up(R, kTailStep) * 2 + 16) : 0;
  return kLutBytes + xbytes + gbytes + warps * kGemvStages * kRingSlot;
}

// y[m, o] = x[m] . dq(W)[o] for M <= 8 NT rows of x (the rest read as
// zeros), a block of 16 WR rows, cluster rank blockIdx.x of gridDim.x over
// the steps. With kLora, xg [M, R] (lora_xa_split_kernel) and lb = B_cat
// [O, R] add the adapter tail on the last rank.
template <int NT, bool kLora>
__global__ void __launch_bounds__(32 * gemv_max_warps(NT), 1)
    gemv_kernel(const bf16* __restrict__ x, const QFields w, bf16* __restrict__ out, int M, int K, int O, int WR,
                const bf16* __restrict__ xg, const bf16* __restrict__ lb, int R) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int nthreads = blockDim.x;
  const int WK = (nthreads >> 5) / WR;
  const int wr = warp % WR, wk = warp / WR;
  const int RB = 16 * WR;
  const int kc = blockIdx.x, KC = gridDim.x;
  const int row0 = blockIdx.y * RB + 16 * wr;  // this warp's 16 rows
  const int Q = K / kS;
  const int nsteps = gemv_steps(K);
  const int spb = (nsteps + KC - 1) / KC;
  const int s0 = kc * spb, s1 = min(s0 + spb, nsteps);
  const int jcb = spb * kJStep;  // j positions of the rank's x columns
  const int xstride = kS * jcb * 2 + 16;
  const int Rp = kLora ? round_up(R, kTailStep) : 0;
  const int gstride = Rp * 2 + 16;
  float* lut = reinterpret_cast<float*>(smem);
  unsigned char* xs = smem + kLutBytes;  // [m][u][jcb] bf16
  unsigned char* gs = xs + M * xstride;  // xg [m][Rp] bf16
  unsigned char* rings = gs + (kLora ? M * gstride : 0);
  unsigned char* ring = rings + warp * kGemvStages * kRingSlot;
  const size_t row_bytes = static_cast<size_t>(K) * Fmt::kBits / 8;
  const bool tail = kLora && kc == KC - 1;

  // x's columns of this rank's j positions, every segment, zeros past Q
  const int cpr = kS * jcb / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < M * cpr; i += nthreads) {
    const int m = i / cpr, c = i % cpr;
    const int u = c / (jcb / 8), j = s0 * kJStep + (c % (jcb / 8)) * 8;
    const bool ok = j < Q;
    cp_async16(xs + m * xstride + c * 16, x + (ok ? static_cast<size_t>(m) * K + u * Q + j : 0), ok ? 16 : 0);
  }
  cp_async_commit();

  // this warp's steps: s0 + wk, + WK, ...; step i's pieces into slot i % stages
  const int mine = s0 + wk < s1 ? (s1 - s0 - wk + WK - 1) / WK : 0;
  // lane q's first j of step i (its other block 64 further)
  auto jpos = [&](int i) { return (s0 + wk + i * WK) * kJStep + 16 * q; };
  auto issue = [&](int i) {
    if (i < mine) {
      unsigned char* slot = ring + (i % kGemvStages) * kRingSlot;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = row0 + g + 8 * h;
#pragma unroll
        for (int jw = 0; jw < kJW; ++jw) {
          const int j = jpos(i) + 64 * jw;
          const bool ok = o < O && j < Q;
#pragma unroll
          for (int p = 0; p < Fmt::kPieces; ++p) {
            const size_t off = ok ? static_cast<size_t>(o) * row_bytes +
                                        qpiece_offset<Fmt>(K, p < Fmt::kN0 ? 0 : 1, p < Fmt::kN0 ? p : p - Fmt::kN0, j)
                                  : 0;
            cp_async16(slot + (((h * kJW + jw) * Fmt::kPieces + p) * 32 + lane) * 16, w.data + off, ok ? 16 : 0);
          }
        }
      }
    }
    cp_async_commit();  // one group a step, empty or not: the waits count steps
  };
  for (int i = 0; i < kGemvStages - 1; ++i) issue(i);

  // the scale fields of a step, read into registers a step ahead of their
  // decode (zeros past O and Q)
  auto load_scales = [&](QScale<Fmt> (&sc)[2][kJW][kS], int i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = row0 + g + 8 * h;
#pragma unroll
      for (int jw = 0; jw < kJW; ++jw) {
        const int j = jpos(i) + 64 * jw;
        const bool ok = i < mine && o < O && j < Q;
#pragma unroll
        for (int u = 0; u < kS; ++u) {
          sc[h][jw][u] = QScale<Fmt>{};
          sc[h][jw][u].load(w, o, K, u * Q + j, ok);
        }
      }
    }
  };
  QScale<Fmt> cur[2][kJW][kS], nxt[2][kJW][kS];
  load_scales(cur, 0);

  if constexpr (Fmt::kLut) {
    if (threadIdx.x < 16) lut[threadIdx.x] = qlut<Fmt>()[threadIdx.x];
  }
  if (tail) {  // xg's rows, zeros past R
    const unsigned short* xgu = reinterpret_cast<const unsigned short*>(xg);
    for (int i = threadIdx.x; i < M * Rp; i += nthreads) {
      const int m = i / Rp, r = i % Rp;
      reinterpret_cast<unsigned short*>(gs + m * gstride)[r] = r < R ? __ldg(xgu + static_cast<size_t>(m) * R + r) : 0;
    }
  }
  cp_async_wait<kGemvStages - 1>();  // this thread's x chunks have landed
  __syncthreads();                    // and every thread's, the codebook and xg

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  // the 4 k-tiles of one group: rows g, g + 8 decoded into d0, d1; x's
  // row 8 n + g of the same 16 elements at byte offset `col` of its row.
  // The tensor cores add into their f32 accumulator with the addends
  // aligned to the largest and truncated: chained over K, the running sum
  // sets that alignment and the error grows with it (3-11x as many bf16
  // outputs off the exactly rounded product as the plain version's, by
  // scripts/gemv_sweep.py --misrounding). So each group's 4 MMAs sum from
  // zero and the groups' sums join acc by round-to-nearest adds: about as
  // many misrounded outputs as the plain version's.
  auto mma_group = [&](const uint32_t (&d0)[8], const uint32_t (&d1)[8], const unsigned char* base, int stride,
                       int col) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int m = 8 * n + g;
      uint4 x0 = make_uint4(0u, 0u, 0u, 0u), x1 = x0;
      if (m < M) {
        const uint4* xp = reinterpret_cast<const uint4*>(base + m * stride + col);
        x0 = xp[0];
        x1 = xp[1];
      }
      const uint32_t xw[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const uint32_t a[4] = {d0[2 * t], d1[2 * t], d0[2 * t + 1], d1[2 * t + 1]};
        mma_bf16(c, a, xw[2 * t], xw[2 * t + 1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += c[e];
    }
  };

  for (int i = 0; i < mine; ++i) {
    load_scales(nxt, i + 1);
    cp_async_wait<kGemvStages - 2>();  // this lane's pieces of step i have landed
    issue(i + kGemvStages - 1);        // into the slot step i - 1 left
    const unsigned char* slot = ring + (i % kGemvStages) * kRingSlot;
#pragma unroll
    for (int jw = 0; jw < kJW; ++jw) {
      uint4 pc[2][Fmt::kPieces];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int p = 0; p < Fmt::kPieces; ++p)
          pc[h][p] = *reinterpret_cast<const uint4*>(slot + (((h * kJW + jw) * Fmt::kPieces + p) * 32 + lane) * 16);
      const int j = jpos(i) + 64 * jw;
      const int jl = j - s0 * kJStep;  // j within the rank's x columns
      static_for<0, kS>([&](auto uc) {
        constexpr int U = decltype(uc)::value;
        uint32_t d0[8], d1[8];
        qdecode16_tc<Fmt, U>(pc[0], cur[0][jw][U].a(), cur[0][jw][U].b(), lut, d0);
        qdecode16_tc<Fmt, U>(pc[1], cur[1][jw][U].a(), cur[1][jw][U].b(), lut, d1);
        mma_group(d0, d1, xs, xstride, (U * jcb + jl) * 2);
      });
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int jw = 0; jw < kJW; ++jw)
#pragma unroll
        for (int u = 0; u < kS; ++u) cur[h][jw][u] = nxt[h][jw][u];
  }

  if (tail) {
    // the adapter columns: 64 a step, B_cat's rows as bf16 weights
    const unsigned short* lbu = reinterpret_cast<const unsigned short*>(lb);
    for (int t = wk; t < Rp / kTailStep; t += WK) {
      const int r = t * kTailStep + 16 * q;
      uint32_t d[2][8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = row0 + g + 8 * h;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int c = r + 2 * e;
          const uint32_t lo = o < O && c < R ? __ldg(lbu + static_cast<size_t>(o) * R + c) : 0u;
          const uint32_t hi = o < O && c + 1 < R ? __ldg(lbu + static_cast<size_t>(o) * R + c + 1) : 0u;
          d[h][e] = lo | (hi << 16);
        }
      }
      mma_group(d[0], d[1], gs, gstride, r * 2);
    }
  }

  // the block's partial: red[wk][col][row], summed over wk in warp order
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring
  float* red = reinterpret_cast<float*>(rings);
  constexpr int kCols = 8 * NT;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(wk * kCols + 8 * n + 2 * q + (e & 1)) * RB + 16 * wr + g + 8 * (e >> 1)] = acc[n][e];
  __syncthreads();
  const int o0 = blockIdx.y * RB;
  for (int i = threadIdx.x; i < kCols * RB; i += nthreads) {
    float s = red[i];
    for (int k2 = 1; k2 < WK; ++k2) s += red[k2 * kCols * RB + i];
    const int m = i / RB, o = o0 + i % RB;
    if (KC == 1) {
      if (m < M && o < O) out[static_cast<size_t>(m) * O + o] = __float2bfloat16(s);
    } else {
      red[i] = s;
    }
  }
  if (KC == 1) return;

  // the cluster's ranks in rank order; rank kc writes its RB / KC rows
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int per = RB / KC;
  for (int i = threadIdx.x; i < kCols * per; i += nthreads) {
    const int m = i / per, row = kc * per + i % per, o = o0 + row;
    float s = cluster.map_shared_rank(red, 0)[m * RB + row];
    for (int r = 1; r < KC; ++r) s += cluster.map_shared_rank(red, r)[m * RB + row];
    if (m < M && o < O) out[static_cast<size_t>(m) * O + o] = __float2bfloat16(s);
  }
  cluster.sync();  // no block leaves while another reads its partial
}

// cudaFuncSetAttribute once per instantiation and device: every launch
// stays within the 227 KB the attribute allows.
template <class Kern>
int allow_smem(Kern kern, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64) return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidDevice);
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, qtile::kSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    done[dev] = true;
  }
  return 0;
}

// The grid of ops/kernels/qtile.py gemv_tile: kc cluster ranks along K by
// ceil(O / 16 wr) blocks of rows; stages and smem checked against this
// build's (cudaErrorInvalidValue where they differ).
template <int NT, bool kLora>
int launch_gemv(const bf16* x, const QFields& w, bf16* out, int M, int K, int O, int wr, int kc, int warps,
                int stages, int smem, const bf16* xg, const bf16* lb, int R, cudaStream_t stream) {
  if ((warps != 8 && warps != 16) || warps > gemv_max_warps(NT) || (wr != 1 && wr != 2 && wr != 4 && wr != 8 && wr != 16) ||
      wr > warps || (kc != 1 && kc != 2 && kc != 4 && kc != 8) || stages != kGemvStages ||
      smem != gemv_smem(M, K, kc, kLora ? R : 0, warps) || smem > qtile::kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool done[64] = {};
  const int err = allow_smem(gemv_kernel<NT, kLora>, done);
  if (err != 0) return err;
  const dim3 grid(kc, (O + 16 * wr - 1) / (16 * wr));
  if (kc == 1) {
    gemv_kernel<NT, kLora><<<grid, 32 * warps, smem, stream>>>(x, w, out, M, K, O, wr, xg, lb, R);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, gemv_kernel<NT, kLora>, x, w, out, M, K, O, wr, xg, lb, R);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// The LoRA GEMV's first pass: xg[m, r] = bf16(gate[m, r] * sum_k x[m, k]
// A_cat[r, k]), 16 rows of A_cat a block, the grid (ks, ceil(R / 16))
// splitting K so that it fills the card (ops/kernels/qtile.py
// lora_xa_split). The same fragment mapping as the GEMV: lane (g, q) reads
// 16 consecutive k of A_cat's rows g, g + 8 and of x's row 8 n + g; the 4
// warps take the block's steps of 64 in turn (each step's 4 MMAs summed
// from zero, as the GEMV's groups) and sum in warp order into part[b, m,
// r] (f32). The last block of a row tile to finish (a ticket counter, left
// at zero again) sums the ks partials in split order, multiplies by the
// gate and rounds once: the one-pass value, the same on every launch.
template <int NT>
__global__ void __launch_bounds__(128)
    lora_xa_split_kernel(const bf16* __restrict__ x, const bf16* __restrict__ a, const bf16* __restrict__ gate,
                         float* __restrict__ part, bf16* __restrict__ xg, int* __restrict__ tickets, int M, int K,
                         int R, int kspb) {
  constexpr int kCols = 8 * NT;
  __shared__ float red[4][kCols * 16];
  __shared__ int last;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int r0 = blockIdx.y * 16;
  const int nk = (K + kTailStep - 1) / kTailStep;
  const int s0 = blockIdx.x * kspb, s1 = min(s0 + kspb, nk);
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  auto ld32 = [&](const bf16* row, int k, bool ok, uint32_t (&v)[8]) {
    uint4 p0 = make_uint4(0u, 0u, 0u, 0u), p1 = p0;
    if (ok) {
      p0 = __ldg(reinterpret_cast<const uint4*>(row + k));
      p1 = __ldg(reinterpret_cast<const uint4*>(row + k + 8));
    }
    v[0] = p0.x, v[1] = p0.y, v[2] = p0.z, v[3] = p0.w, v[4] = p1.x, v[5] = p1.y, v[6] = p1.z, v[7] = p1.w;
  };
  for (int s = s0 + warp; s < s1; s += 4) {
    const int k = s * kTailStep + 16 * q;
    uint32_t d0[8], d1[8], xv[NT][8];
    ld32(a + static_cast<size_t>(r0 + g) * K, k, r0 + g < R && k < K, d0);
    ld32(a + static_cast<size_t>(r0 + g + 8) * K, k, r0 + g + 8 < R && k < K, d1);
#pragma unroll
    for (int n = 0; n < NT; ++n) ld32(x + static_cast<size_t>(8 * n + g) * K, k, 8 * n + g < M && k < K, xv[n]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const uint32_t af[4] = {d0[2 * t], d1[2 * t], d0[2 * t + 1], d1[2 * t + 1]};
        mma_bf16(c, af, xv[n][2 * t], xv[n][2 * t + 1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += c[e];
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[warp][(8 * n + 2 * q + (e & 1)) * 16 + g + 8 * (e >> 1)] = acc[n][e];
  __syncthreads();
  for (int i = threadIdx.x; i < kCols * 16; i += 128) {
    const int m = i / 16, r = r0 + i % 16;
    if (m < M && r < R)
      part[(static_cast<size_t>(blockIdx.x) * M + m) * R + r] = ((red[0][i] + red[1][i]) + red[2][i]) + red[3][i];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + blockIdx.y, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < M * 16; i += 128) {
    const int m = i / 16, r = r0 + i % 16;
    if (r < R) {
      float s = __ldcg(part + static_cast<size_t>(m) * R + r);
      for (int t = 1; t < static_cast<int>(gridDim.x); ++t) s += __ldcg(part + (static_cast<size_t>(t) * M + m) * R + r);
      const size_t at = static_cast<size_t>(m) * R + r;
      xg[at] = __float2bfloat16(s * __bfloat162float(gate[at]));
    }
  }
  if (threadIdx.x == 0) tickets[blockIdx.y] = 0;
}

template <int NT>
int launch_gemv_lora(const bf16* x, const QFields& w, const bf16* la, const bf16* lb, const bf16* lg, float* part,
                     bf16* xg, int* tickets, bf16* out, int M, int K, int O, int R, int wr, int kc, int warps,
                     int stages, int smem, int ks, int kspb, cudaStream_t stream) {
  const int nk = (K + kTailStep - 1) / kTailStep;
  if (ks < 1 || kspb < 1 || (ks - 1) * kspb >= nk || ks * kspb < nk) return static_cast<int>(cudaErrorInvalidValue);
  lora_xa_split_kernel<NT><<<dim3(ks, (R + 15) / 16), 128, 0, stream>>>(x, la, lg, part, xg, tickets, M, K, R, kspb);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_gemv<NT, true>(x, w, out, M, K, O, wr, kc, warps, stages, smem, xg, lb, R, stream);
}

using namespace nvcuda;

// The LoRA GEMM's first pass on the tensor cores: a 16 x 32 tile of
// xg = bf16((x . A_cat^T) * gate) per block. Its 4 warps split the K walk
// (warp w takes the 64-wide K steps w, w + 4, ...), each staging its own x
// and A_cat slices in shared memory (rows past M, columns past R and K
// past its end read as zeros); the block then adds the 4 partial tiles.
// Each step's 4 MMAs sum from zero and join the warp's running sum by
// round-to-nearest adds, as the GEMV's groups do: chained over K, the
// tensor cores' truncating adds misrounded 7x as many elements of xg as
// the plain version (451 against 63 off the exactly rounded value over
// chip_smoke phase 11's adapter engine, scripts/engine_rounding.py), and
// one element of xg rounded the other way moves a whole row of y.
// Small tiles and the split keep enough blocks in flight at training's
// R = 8 (M / 16 blocks).
constexpr int kXaBM = 16, kXaBR = 32, kXaKS = 64, kXaLd = kXaKS + 8, kXaWarps = 4;

__global__ void __launch_bounds__(kXaWarps * 32)
    lora_xa_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ a,
                      const bf16* __restrict__ gate, bf16* __restrict__ xg, int M, int K, int R) {
  __shared__ __align__(32) bf16 xs[kXaWarps][kXaBM * kXaLd];
  __shared__ __align__(32) bf16 as[kXaWarps][kXaBR * kXaLd];
  __shared__ __align__(32) float st[kXaWarps][kXaBM * kXaBR];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * kXaBM;
  const int r0 = blockIdx.x * kXaBR;
  constexpr int kVecs = kXaKS / 8;  // 16-byte vectors of a row slice
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
  for (int k0 = warp * kXaKS; k0 < K; k0 += kXaWarps * kXaKS) {
    for (int i = lane; i < (kXaBM + kXaBR) * kVecs; i += 32) {
      const bool is_x = i < kXaBM * kVecs;
      const int j = is_x ? i : i - kXaBM * kVecs;
      const int r = j / kVecs;
      const int k = k0 + (j % kVecs) * 8;
      const int row = (is_x ? m0 : r0) + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row < (is_x ? M : R) && k < K)
        val = __ldg(reinterpret_cast<const uint4*>((is_x ? x : a) + static_cast<size_t>(row) * K + k));
      *reinterpret_cast<uint4*>((is_x ? xs[warp] : as[warp]) + r * kXaLd + (j % kVecs) * 8) = val;
    }
    __syncwarp();
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> step[2];
    wmma::fill_fragment(step[0], 0.0f);
    wmma::fill_fragment(step[1], 0.0f);
#pragma unroll
    for (int kk = 0; kk < kXaKS; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, xs[warp] + kk, kXaLd);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, as[warp] + j * 16 * kXaLd + kk, kXaLd);
        wmma::mma_sync(step[j], fa, fb, step[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < step[j].num_elements; ++i) acc[j].x[i] = __fadd_rn(acc[j].x[i], step[j].x[i]);
    __syncwarp();
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(st[warp] + j * 16, acc[j], kXaBR, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < kXaBM * kXaBR; i += kXaWarps * 32) {
    const int m = m0 + i / kXaBR;
    const int r = r0 + i % kXaBR;
    if (m < M && r < R) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kXaWarps; ++w) s += st[w][i];
      const size_t at = static_cast<size_t>(m) * R + r;
      xg[at] = __float2bfloat16(s * __bfloat162float(gate[at]));
    }
  }
}

// The GEMM's tiles: kWG warpgroups of MMA warps, each 64 rows of x by 128
// weight rows (output columns); W tiles of 128 rows by a step of K, both
// in wgmma's swizzled layout.
constexpr int kDepth = qtile::step_depth<Fmt>();
template <int kWG>
using GemmW = qtile::WTileFor<Fmt, 64 * kWG, 128, kDepth>;
template <int kWG>
using GemmL = qtile::Layout<Fmt, 64 * kWG, 4 * kWG, GemmW<kWG>>;

// x in the order the GEMM's steps read it: step s's column 16 g + i is
// x[m, (g % S) Q + s kDepth/S + (g / S) 16 + i] (the groups of the finest
// plane split, qtile.cuh), so that each step's A tile is kDepth contiguous
// columns a row. Read in place, a step's columns are S runs of kDepth/S
// elements a row, and those half- and quarter-line reads held the A
// loads well below the rate of whole lines. A 16-byte chunk a thread;
// the formats with S = 1 are in order already and skip this pass. kLora
// only names the launch, so that a profile tells the LoRA GEMM's pass
// from the GEMM's.
template <bool kLora>
__global__ void __launch_bounds__(256)
    x_order_kernel(const bf16* __restrict__ x, bf16* __restrict__ xo, int M, int K) {
  const int Q = K / kS;
  const int chunks_per_row = K / 8;
  const size_t chunks = static_cast<size_t>(M) * chunks_per_row;
  for (size_t c = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x; c < chunks;
       c += static_cast<size_t>(gridDim.x) * 256) {
    const size_t m = c / chunks_per_row;
    const int k = static_cast<int>(c % chunks_per_row) * 8;
    const int col = k % kDepth, grp = col / 16;
    const int src = (grp % kS) * Q + (k / kDepth) * (kDepth / kS) + (grp / kS) * 16 + (col & 15);
    *reinterpret_cast<uint4*>(xo + m * K + k) = __ldg(reinterpret_cast<const uint4*>(x + m * K + src));
  }
}

template <bool kLora>
int launch_x_order(const bf16* x, bf16* xo, int M, int K, cudaStream_t stream) {
  const size_t chunks = static_cast<size_t>(M) * (K / 8);
  const int grid = static_cast<int>(chunks / 256 + 1 < 4096 ? chunks / 256 + 1 : 4096);
  x_order_kernel<kLora><<<grid, 256, 0, stream>>>(x, xo, M, K);
  return static_cast<int>(cudaGetLastError());
}

// y[m0 .. m0 + bm, n0 .. n0 + 128] over the whole K walk (qtile.cuh: 4 or
// 8 decoder warps, kWG warpgroups of wgmma). A step's A tile is kDepth
// contiguous columns of xo, x in the steps' order (x_order_kernel).
// With kLora, ceil(R / kDepth) more steps after the K walk carry xg [M, R]
// (bf16(xa * gate), from lora_xa_tc_kernel) as A and B_cat [O, R] as W, so
// the LoRA epilogue runs through the same MMA into the same f32 sums,
// after the same K walk: a zero xg row adds exactly 0.
template <int kWG, bool kLora>
__global__ void __launch_bounds__(GemmL<kWG>::kThreads, 1)
    gemm_kernel(const bf16* __restrict__ xo, const QFields w, bf16* __restrict__ out, int M, int K, int O,
                const bf16* __restrict__ xg, const bf16* __restrict__ lb, int R) {
  using L = GemmL<kWG>;
  using W = GemmW<kWG>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * L::kBM;
  const int n0 = blockIdx.y * W::kRowsN;
  const int Q = K / kS;
  const int wsteps = (Q + W::kJB - 1) / W::kJB;
  const int steps = wsteps + (kLora ? (R + L::kDepth - 1) / L::kDepth : 0);
  constexpr int kCPR = L::kDepth / 8;  // 16-byte chunks of an A row

  if (warp >= L::kMmaWarps) {
    const int ptid = threadIdx.x - 32 * L::kMmaWarps;
    qtile::produce<Fmt, L, W>(
        smem, w, K, O, Q, wsteps, steps, ptid, [&](int s) { return make_int2(n0, s * W::kJB); },
        [&](int s, bf16* as) {
#pragma unroll
          for (int i = 0; i < L::kBM * kCPR / W::kDecThreads; ++i) {
            const int c = ptid + i * W::kDecThreads;
            const int r = c / kCPR, k = s * kDepth + (c % kCPR) * 8;
            const bool ok = m0 + r < M && k < K;
            const size_t off = ok ? static_cast<size_t>(m0 + r) * K + k : 0;
            cp_async16(reinterpret_cast<unsigned char*>(as) + L::a_chunk(r, c % kCPR), xo + off, ok ? 16 : 0);
          }
        },
        [&](int s, bf16* as, bf16* ws) {
          // adapter columns c0 .. c0 + kDepth: xg's rows of the block as A,
          // B_cat's as W, zero past M, O and R
          const int c0 = (s - wsteps) * L::kDepth;
          for (int c = ptid; c < (L::kBM + W::kRowsN) * kCPR; c += W::kDecThreads) {
            const bool is_x = c < L::kBM * kCPR;
            const int cr = is_x ? c : c - L::kBM * kCPR;
            const int r = cr / kCPR, k0 = c0 + (cr % kCPR) * 8;
            const int row = (is_x ? m0 : n0) + r;
            const bool in = row < (is_x ? M : O);
            const unsigned short* src =
                reinterpret_cast<const unsigned short*>(is_x ? xg : lb) + static_cast<size_t>(in ? row : 0) * R;
            uint32_t v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int k = k0 + 2 * e;
              const uint32_t lo = in && k < R ? src[k] : 0u;
              const uint32_t hi = in && k + 1 < R ? src[k + 1] : 0u;
              v[e] = lo | (hi << 16);
            }
            *reinterpret_cast<uint4*>(is_x ? reinterpret_cast<unsigned char*>(as) + L::a_chunk(r, cr % kCPR)
                                           : reinterpret_cast<unsigned char*>(ws) + W::chunk(r, cr % kCPR)) =
                make_uint4(v[0], v[1], v[2], v[3]);
          }
        });
    return;
  }

  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
  qtile::consume_wgmma<L, W, false>(smem, steps, warp, acc);

  // bf16 pairs straight from the accumulators: register 4 j + 2 h + e is
  // row 16 (warp % 4) + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e
  const bool even = (O & 1) == 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = n0 + 8 * j + 2 * (lane & 3);
    if (n >= O) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + (warp >> 2) * 64 + 16 * (warp & 3) + (lane >> 2) + 8 * h;
      if (m < M)
        qtile::store_bf16x2(out + static_cast<size_t>(m) * O + n, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1],
                            even && n + 1 < O, n + 1 < O);
    }
  }
}

template <int kWG, bool kLora>
int launch_gemm(const bf16* xo, const QFields& w, bf16* out, int M, int K, int O, const bf16* xg,
                const bf16* lb, int R, int stages, int smem, cudaStream_t stream) {
  using L = GemmL<kWG>;
  if (stages != L::kStages || smem != L::kBytes) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(gemm_kernel<kWG, kLora>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + L::kBM - 1) / L::kBM, (O + 127) / 128);
  gemm_kernel<kWG, kLora><<<grid, L::kThreads, L::kBytes, stream>>>(xo, w, out, M, K, O, xg, lb, R);
  return static_cast<int>(cudaGetLastError());
}

// x into xo in the steps' order (S > 1; xo is x itself at S = 1), then the
// tile ops/kernels/qtile.py chose: bm rows of x by bn output columns a
// block, (64, 128) or (128, 128)
template <bool kLora>
int launch_gemm_tile(const bf16* x, bf16* xo, const QFields& w, bf16* out, int M, int K, int O,
                     const bf16* xg, const bf16* lb, int R, int bm, int bn, int stages, int smem,
                     cudaStream_t stream) {
  const bf16* xa = x;
  if constexpr (kS > 1) {
    if (xo == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const int err = launch_x_order<kLora>(x, xo, M, K, stream);
    if (err != 0) return err;
    xa = xo;
  }
  if (bm == 64 && bn == 128) return launch_gemm<1, kLora>(xa, w, out, M, K, O, xg, lb, R, stages, smem, stream);
  if (bm == 128 && bn == 128) return launch_gemm<2, kLora>(xa, w, out, M, K, O, xg, lb, R, stages, smem, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

QFields fields(const void* data, const void* scales, const void* mins, const void* sub_scales,
               const void* sub_mins) {
  return QFields{static_cast<const uint8_t*>(data), static_cast<const __half*>(scales),
                 static_cast<const __half*>(mins), static_cast<const uint8_t*>(sub_scales),
                 static_cast<const uint8_t*>(sub_mins)};
}

}  // namespace

// x [M, K] bf16, the weight's fields (null where absent), out [M, O] bf16;
// wr, kc, warps, stages, smem: the tile of ops/kernels/qtile.py gemv_tile
// (checked against this build's; a mismatch returns cudaErrorInvalidValue).
extern "C" int qmatmul_gemv(const void* x, const void* data, const void* scales, const void* mins,
                            const void* sub_scales, const void* sub_mins, void* out, int M, int K, int O, int wr,
                            int kc, int warps, int stages, int smem, void* stream) {
  const bf16* xp = static_cast<const bf16*>(x);
  const QFields w = fields(data, scales, mins, sub_scales, sub_mins);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 8) return launch_gemv<1, false>(xp, w, op, M, K, O, wr, kc, warps, stages, smem, nullptr, nullptr, 0, st);
  if (M <= 16) return launch_gemv<2, false>(xp, w, op, M, K, O, wr, kc, warps, stages, smem, nullptr, nullptr, 0, st);
  if (M <= 32) return launch_gemv<4, false>(xp, w, op, M, K, O, wr, kc, warps, stages, smem, nullptr, nullptr, 0, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// xo: [M, K] bf16 scratch for x in the steps' order (null where S = 1);
// bm, bn, stages, smem: the tile of ops/kernels/qtile.py gemm_tile
// (checked against this build's layout; a mismatch returns
// cudaErrorInvalidValue).
extern "C" int qmatmul_gemm(const void* x, void* xo, const void* data, const void* scales, const void* mins,
                            const void* sub_scales, const void* sub_mins, void* out, int M, int K,
                            int O, int bm, int bn, int stages, int smem, void* stream) {
  return launch_gemm_tile<false>(static_cast<const bf16*>(x), static_cast<bf16*>(xo),
                                 fields(data, scales, mins, sub_scales, sub_mins), static_cast<bf16*>(out), M,
                                 K, O, nullptr, nullptr, 0, bm, bn, stages, smem,
                                 static_cast<cudaStream_t>(stream));
}

// The LoRA forms: a_cat [R, K], b_cat [O, R], gate [M, R], all bf16; out
// [M, O] bf16. M <= 32 rows: part [ks, M, R] f32 scratch for the first
// pass, split in ks blocks of kspb steps of 64 along K (ops/kernels/
// qtile.py lora_xa_split), xg [M, R] bf16 scratch, tickets
// [ceil(R / 16)] int32, zero before the launch and left zero after it;
// the GEMV's tile as qmatmul_gemv's.
extern "C" int qmatmul_gemv_lora(const void* x, const void* data, const void* scales, const void* mins,
                                 const void* sub_scales, const void* sub_mins, const void* a_cat,
                                 const void* b_cat, const void* gate, void* part, void* xg, void* tickets,
                                 void* out, int M, int K, int O, int R, int wr, int kc, int warps, int stages,
                                 int smem, int ks, int kspb, void* stream) {
  const bf16* xp = static_cast<const bf16*>(x);
  const QFields w = fields(data, scales, mins, sub_scales, sub_mins);
  const bf16* la = static_cast<const bf16*>(a_cat);
  const bf16* lb = static_cast<const bf16*>(b_cat);
  const bf16* lg = static_cast<const bf16*>(gate);
  float* pp = static_cast<float*>(part);
  bf16* xgp = static_cast<bf16*>(xg);
  int* tk = static_cast<int*>(tickets);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || M < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 8)
    return launch_gemv_lora<1>(xp, w, la, lb, lg, pp, xgp, tk, op, M, K, O, R, wr, kc, warps, stages, smem, ks, kspb, st);
  if (M <= 16)
    return launch_gemv_lora<2>(xp, w, la, lb, lg, pp, xgp, tk, op, M, K, O, R, wr, kc, warps, stages, smem, ks, kspb, st);
  if (M <= 32)
    return launch_gemv_lora<4>(xp, w, la, lb, lg, pp, xgp, tk, op, M, K, O, R, wr, kc, warps, stages, smem, ks, kspb, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same operands, M > 32 rows; xo, bm, bn, stages, smem as
// qmatmul_gemm's.
extern "C" int qmatmul_gemm_lora(const void* x, void* xo, const void* data, const void* scales,
                                 const void* mins, const void* sub_scales, const void* sub_mins,
                                 const void* a_cat, const void* b_cat, const void* gate, void* xg, void* out,
                                 int M, int K, int O, int R, int bm, int bn, int stages, int smem,
                                 void* stream) {
  if (R < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xp = static_cast<const bf16*>(x);
  bf16* xgp = static_cast<bf16*>(xg);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((R + kXaBR - 1) / kXaBR, (M + kXaBM - 1) / kXaBM);
  lora_xa_tc_kernel<<<grid, kXaWarps * 32, 0, st>>>(xp, static_cast<const bf16*>(a_cat),
                                          static_cast<const bf16*>(gate), xgp, M, K, R);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_gemm_tile<true>(xp, static_cast<bf16*>(xo), fields(data, scales, mins, sub_scales, sub_mins),
                                static_cast<bf16*>(out), M, K, O, xgp, static_cast<const bf16*>(b_cat), R, bm,
                                bn, stages, smem, st);
}
