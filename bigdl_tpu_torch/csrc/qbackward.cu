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
// per byte where the H100's bf16 tensor cores stop waiting on memory.
//
// Design: the access pattern is the transpose of the forward GEMM's — the
// contraction runs over the weight's O rows. One block owns a 128 x 128
// tile of dx: 128 rows of g and the 8 groups (16 columns each,
// qdecode.cuh) of 128/S j positions of the finest plane split in all S
// segments, so the pieces of every plane byte it needs decode once. It
// walks all of O in steps of 64 rows: g[128 x 64] and the decoded W[64 x
// 128] are staged in shared memory as bf16 and fed to the tensor cores
// through wmma (bf16 in, f32 accumulate), eight warps of 32 x 64 each. The
// f32 sums stay in registers across the whole O walk, so no partial sums
// cross blocks: no atomics, and dx is the same from run to run. No
// cp.async/TMA pipeline and no wgmma yet.
//
// Returns cudaGetLastError() after the launch; 0 means launched.

#include <mma.h>

#include "qdecode.cuh"

#ifndef BIGDL_QFMT
#error "build with -DBIGDL_QFMT=QF_<qtype> (ops/kernels/_build.py does)"
#endif

namespace {

using namespace nvcuda;
using Fmt = BIGDL_QFMT;
constexpr int kS = Fmt::kS;

constexpr int kBM = 128;        // dx rows (rows of g) per block
constexpr int kNG = 8;          // column groups per block
constexpr int kBN = 16 * kNG;   // dx columns per block
constexpr int kJB = kBN / kS;   // j positions per block
constexpr int kBO = 64;         // weight rows per step of the O walk
constexpr int kLdg = kBO + 8;   // bf16 row stride of the g tile (144 B)
constexpr int kLdw = kBN + 8;   // bf16 row stride of the W tile (272 B)
constexpr int kParts = 4;       // threads decoding one weight row of a step
constexpr int kGPT = kNG / kParts;

// 8 warps as 4 (M) x 2 (N); warp column half wn owns groups 4 wn .. 4 wn + 3.
__global__ void __launch_bounds__(256)
    dx_kernel(const bf16* __restrict__ g, const QFields w, bf16* __restrict__ dx, int M, int K, int O) {
  __shared__ __align__(32) bf16 gs[kBM][kLdg];  // [row of g][weight row o]
  __shared__ __align__(32) bf16 ws[kBO][kLdw];  // [weight row o][dx column of the tile]
  __shared__ float lut[16];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 1;
  const int wn = warp & 1;
  const int m0 = blockIdx.y * kBM;
  const int j0 = blockIdx.x * kJB;
  const int Q = K / kS;
  if constexpr (Fmt::kLut) {
    if (tid < 16) lut[tid] = qlut<Fmt>()[tid];
    __syncthreads();
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // One O step's operands in registers: g (4 vectors a thread) and the W
  // share. `fetch` issues all their loads, `put` stores them (W decoded)
  // into shared memory: all loads of a step go out before its first store.
  uint4 gv[kBM * (kBO / 8) / 256];
  QTileFetch<Fmt, kParts, kGPT> wf;
  auto fetch = [&](int o0) {
#pragma unroll
    for (int v = 0; v < kBM * (kBO / 8) / 256; ++v) {
      const int i = tid + v * 256;
      const int m = m0 + i / (kBO / 8);
      const int o = o0 + (i % (kBO / 8)) * 8;
      gv[v] = make_uint4(0u, 0u, 0u, 0u);
      if (m < M && o < O) gv[v] = __ldg(reinterpret_cast<const uint4*>(g + static_cast<size_t>(m) * O + o));
    }
    wf.load(w, tid, kBO, o0, O, K, j0);
  };
  auto put = [&]() {
#pragma unroll
    for (int v = 0; v < kBM * (kBO / 8) / 256; ++v) {
      const int i = tid + v * 256;
      *reinterpret_cast<uint4*>(&gs[i / (kBO / 8)][(i % (kBO / 8)) * 8]) = gv[v];
    }
    wf.store(lut, &ws[0][0], kLdw);
  };

  for (int o0 = 0; o0 < O; o0 += kBO) {
    fetch(o0);
    put();
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBO; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], &gs[wm * 32 + i * 16][kk], kLdg);
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::load_matrix_sync(b[j], &ws[kk][wn * 64 + j * 16], kLdw);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each warp stages one 16x16 f32 fragment (one column group)
  // at a time in the (now idle) g tile, then writes bf16 to the group's
  // 16 contiguous dx columns, the ragged edges masked
  float* stage = reinterpret_cast<float*>(&gs[0][0]) + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int grp = wn * 4 + j;
      const int jj = j0 + (grp / kS) * 16;
      const size_t col = static_cast<size_t>(grp % kS) * Q + jj;
      for (int e = lane; e < 256; e += 32) {
        const int m = m0 + wm * 32 + i * 16 + (e >> 4);
        if (m < M && jj < Q) dx[static_cast<size_t>(m) * K + col + (e & 15)] = __float2bfloat16(stage[e]);
      }
      __syncwarp();
    }
  }
}

}  // namespace

// g [M, O] bf16, the weight's fields (null where absent), dx [M, K] bf16.
extern "C" int qmatmul_dx(const void* g, const void* data, const void* scales, const void* mins,
                          const void* sub_scales, const void* sub_mins, void* dx, int M, int K, int O,
                          void* stream) {
  const QFields w{static_cast<const uint8_t*>(data), static_cast<const __half*>(scales),
                  static_cast<const __half*>(mins), static_cast<const uint8_t*>(sub_scales),
                  static_cast<const uint8_t*>(sub_mins)};
  const dim3 grid((K / kS + kJB - 1) / kJB, (M + kBM - 1) / kBM);
  dx_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(g), w, static_cast<bf16*>(dx), M, K, O);
  return static_cast<int>(cudaGetLastError());
}
