// Fused dequant dx for Hopper, every weight format:
// dx[M, K] = g[M, O] . dequant(W)[O, K].
//
// Replaces the Pallas kernel bigdl_tpu/ops/pallas/qbackward.py `_dx_kernel`
// (launched by `_dxmm`, wrapped by `qmatmul_dx`): the backward of the frozen
// quantized projection, with the weight decoded by the same rule as the
// forward (qdecode.cuh), g rounded to bf16, f32 sums and one bf16 rounding
// of dx. This source builds once per weight format, `-DBIGDL_QFMT=QF_<qtype>`.
//
// What bounds it: operations. At the training shapes (M = 1024 rows of g)
// each packed weight byte feeds >= 2 * M flops, far above the ~295 flops
// per byte where the H100's bf16 tensor cores stop waiting on memory. A
// single-buffered design lost 4.9x to cuBLAS on the weight dequantized
// beforehand: per step of the O walk its MMA warps loaded g and the
// packed rows, decoded them (~10 instructions an element), synchronised
// and multiplied in series.
//
// Design: the access pattern is the transpose of the forward GEMM's — the
// contraction runs over the weight's O rows — on the same pipeline
// (qtile.cuh). One block owns bm = 64, 128 or 256 rows of g (ops/kernels/
// qtile.py dx_tile) by 128 dx columns: the 8 groups of 128/S j positions
// of the finest plane split in all S segments, so the pieces of every
// plane byte it needs decode once. It walks all of O in steps of 64 weight
// rows (128 for the S = 8 formats): decoder warps keep a ring of 3-6
// stages of g tiles and packed rows in flight with cp.async and decode
// each step once, one step ahead, into a ring of two bf16 W tiles [o][dx
// column]; one or two warpgroups multiply g (K-major) by W (MN-major: its
// rows are the contraction) with wgmma m64n128k16 from shared memory.
// The f32 sums stay in registers across the whole O walk, so no partial
// sums cross blocks: no atomics, and dx is the same from run to run. The
// epilogue stores bf16 pairs from the accumulators into each group's 16
// contiguous dx columns. No TMA yet.
//
// Returns cudaGetLastError() after the launch; 0 means launched.

#include "qtile.cuh"

#ifndef BIGDL_QFMT
#error "build with -DBIGDL_QFMT=QF_<qtype> (ops/kernels/_build.py does)"
#endif

namespace {

using Fmt = BIGDL_QFMT;
constexpr int kS = Fmt::kS;

// dx's tiles: kWG warpgroups of MMA warps, each kChunks m64 pieces of g by
// the block's 128 dx columns; W tiles of a step of weight rows by 128 dx
// columns (wgmma's MN-major B), both in the swizzled layout.
template <int kWG, int kChunks>
using DxW = qtile::WTileFor<Fmt, 64 * kWG * kChunks, (kS == 8 ? 128 : 64), 128>;
template <int kWG, int kChunks>
using DxL = qtile::Layout<Fmt, 64 * kWG * kChunks, 4 * kWG, DxW<kWG, kChunks>>;

template <int kWG, int kChunks>
__global__ void __launch_bounds__(DxL<kWG, kChunks>::kThreads, 1)
    dx_kernel(const bf16* __restrict__ g, const QFields w, bf16* __restrict__ dx, int M, int K, int O) {
  using L = DxL<kWG, kChunks>;
  using W = DxW<kWG, kChunks>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * L::kBM;
  const int j0 = blockIdx.y * W::kJB;
  const int Q = K / kS;
  const int steps = (O + L::kDepth - 1) / L::kDepth;
  constexpr int kCPR = L::kDepth / 8;  // 16-byte chunks of a g row

  if (warp >= L::kMmaWarps) {
    const int ptid = threadIdx.x - 32 * L::kMmaWarps;
    qtile::produce<Fmt, L, W>(
        smem, w, K, O, Q, steps, steps, ptid, [&](int s) { return make_int2(s * L::kDepth, j0); },
        [&](int s, bf16* gs) {
#pragma unroll
          for (int i = 0; i < L::kBM * kCPR / W::kDecThreads; ++i) {
            const int c = ptid + i * W::kDecThreads;
            const int r = c / kCPR;
            const int o = s * L::kDepth + (c % kCPR) * 8;
            const bool ok = m0 + r < M && o < O;  // O % 8 == 0
            const size_t off = ok ? static_cast<size_t>(m0 + r) * O + o : 0;
            cp_async16(reinterpret_cast<unsigned char*>(gs) + L::a_chunk(r, c % kCPR), g + off, ok ? 16 : 0);
          }
        },
        [](int, bf16*, bf16*) {});
    return;
  }

  float acc[kChunks][64];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[c][e] = 0.0f;
  qtile::consume_wgmma<L, W, kChunks, true>(smem, steps, warp, acc);

  // register 4 j + 2 h + e: row 16 (warp % 4) + lane / 4 + 8 h, tile column
  // c = 8 j + 2 (lane % 4) + e, column c % 16 of group c / 16 = jg*S + u:
  // dx column u*Q + j0 + 16 jg + c % 16; a pair never leaves its group
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    const int grp = c >> 4;
    const int jj = j0 + (grp / kS) * 16;
    if (jj >= Q) continue;
    const size_t col = static_cast<size_t>(grp % kS) * Q + jj + (c & 15);
#pragma unroll
    for (int cc = 0; cc < kChunks; ++cc)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + ((warp >> 2) * kChunks + cc) * 64 + 16 * (warp & 3) + (lane >> 2) + 8 * h;
        if (m < M)
          qtile::store_bf16x2(dx + static_cast<size_t>(m) * K + col, acc[cc][4 * j + 2 * h],
                              acc[cc][4 * j + 2 * h + 1], true, true);
      }
  }
}

template <int kWG, int kChunks>
int launch_dx(const bf16* g, const QFields& w, bf16* dx, int M, int K, int O, int stages, int smem,
              cudaStream_t stream) {
  using L = DxL<kWG, kChunks>;
  using W = DxW<kWG, kChunks>;
  if (stages != L::kStages || smem != L::kBytes) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      cudaFuncSetAttribute(dx_kernel<kWG, kChunks>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + L::kBM - 1) / L::kBM, (K / kS + W::kJB - 1) / W::kJB);
  dx_kernel<kWG, kChunks><<<grid, L::kThreads, L::kBytes, stream>>>(g, w, dx, M, K, O);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g [M, O] bf16 (O % 8 == 0), the weight's fields (null where absent), dx
// [M, K] bf16; bm, bn, stages, smem: the tile of ops/kernels/qtile.py
// dx_tile, bm rows of g by bn dx columns, (64, 128), (128, 128) or, below
// S = 8, (256, 128) (checked against this build's layout; a mismatch
// returns cudaErrorInvalidValue).
extern "C" int qmatmul_dx(const void* g, const void* data, const void* scales, const void* mins,
                          const void* sub_scales, const void* sub_mins, void* dx, int M, int K, int O, int bm,
                          int bn, int stages, int smem, void* stream) {
  const QFields w{static_cast<const uint8_t*>(data), static_cast<const __half*>(scales),
                  static_cast<const __half*>(mins), static_cast<const uint8_t*>(sub_scales),
                  static_cast<const uint8_t*>(sub_mins)};
  const bf16* gp = static_cast<const bf16*>(g);
  bf16* dp = static_cast<bf16*>(dx);
  const auto st = static_cast<cudaStream_t>(stream);
  if (bm == 64 && bn == 128) return launch_dx<1, 1>(gp, w, dp, M, K, O, stages, smem, st);
  if (bm == 128 && bn == 128) return launch_dx<1, 2>(gp, w, dp, M, K, O, stages, smem, st);
  if constexpr (kS < 8) {
    if (bm == 256 && bn == 128) return launch_dx<2, 2>(gp, w, dp, M, K, O, stages, smem, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
