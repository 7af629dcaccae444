// Fused sym_int4 dequant dx for Hopper: dx[M, K] = g[M, O] . dequant(W)[O, K].
//
// Replaces the Pallas kernel bigdl_tpu/ops/pallas/qbackward.py `_dx_kernel`
// (launched by `_dxmm`, wrapped by `qmatmul_dx`) for the sym_int4 format:
// the backward of the frozen quantized projection, with the weight decoded
// by the same rule as the forward (qdecode.cuh: (code - 8) * scale in f32,
// rounded to bf16 before the product), g rounded to bf16, f32 sums and one
// bf16 rounding of dx.
//
// What bounds it: operations. At the training shapes (M = 1024 rows of g)
// each packed weight byte feeds 2 * 2 * M flops, far above the ~295 flops
// per byte where the H100's bf16 tensor cores stop waiting on memory.
//
// Design: the access pattern is the transpose of the forward GEMM's — the
// contraction runs over the weight's O rows. One block owns a 128 x 128
// tile of dx: 128 rows of g and the columns that 64 packed bytes of every
// weight row carry (byte j holds column j in its low nibble and column
// j + K/2 in its high one, so the block owns columns j0..j0+63 and
// K/2 + j0..K/2 + j0 + 63 and decodes each byte once). It walks all of O
// in steps of 64 rows: g[128 x 64] and the decoded W[64 x 128] are staged
// in shared memory as bf16 and fed to the tensor cores through wmma (bf16
// in, f32 accumulate), eight warps of 32 x 64 each. The f32 sums stay in
// registers across the whole O walk, so no partial sums cross blocks: no
// atomics, and dx is the same from run to run. No cp.async/TMA pipeline
// and no wgmma yet (ROADMAP queue 2 item 1).
//
// Returns cudaGetLastError() after the launch; 0 means launched.

#include <mma.h>

#include "qdecode.cuh"

namespace {

using namespace nvcuda;

constexpr int kBM = 128;        // dx rows (rows of g) per block
constexpr int kBJ = 64;         // packed bytes of a weight row per block
constexpr int kBN = 2 * kBJ;    // dx columns per block: both nibble halves
constexpr int kBO = 64;         // weight rows per step of the O walk
constexpr int kLdg = kBO + 8;   // bf16 row stride of the g tile (144 B)
constexpr int kLdw = kBN + 8;   // bf16 row stride of the W tile (272 B)

// 8 warps as 4 (M) x 2 (N); warp column half wn = 0 owns the low-nibble
// columns of the tile, wn = 1 the high-nibble ones.
__global__ void __launch_bounds__(256)
    dx_kernel(const bf16* __restrict__ g, const uint8_t* __restrict__ data,
              const __half* __restrict__ scales, bf16* __restrict__ dx, int M, int K, int O) {
  __shared__ __align__(32) bf16 gs[kBM][kLdg];  // [row of g][weight row o]
  __shared__ __align__(32) bf16 ws[kBO][kLdw];  // [weight row o][dx column of the tile]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 1;
  const int wn = warp & 1;
  const int m0 = blockIdx.y * kBM;
  const int j0 = blockIdx.x * kBJ;
  const int half = K >> 1;
  const int nsb = K >> 5;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int o0 = 0; o0 < O; o0 += kBO) {
    // g tile: 128 rows x 64 bf16 = 1024 16-byte vectors, 4 per thread
    for (int i = tid; i < kBM * (kBO / 8); i += 256) {
      const int r = i / (kBO / 8);
      const int v = i % (kBO / 8);
      const int m = m0 + r;
      const int o = o0 + v * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m < M && o < O) val = __ldg(reinterpret_cast<const uint4*>(g + static_cast<size_t>(m) * O + o));
      *reinterpret_cast<uint4*>(&gs[r][v * 8]) = val;
    }
    // W tile: 64 weight rows x 64 packed bytes, one 16-byte vector per
    // thread, decoded to 16 low-half and 16 high-half bf16 columns
    {
      const int r = tid >> 2;
      const int p = tid & 3;
      const int o = o0 + r;
      const int jb = j0 + p * 16;
      uint4 pk = make_uint4(0u, 0u, 0u, 0u);
      float slo = 0.0f, shi = 0.0f;
      if (o < O && jb < half) {
        pk = __ldg(reinterpret_cast<const uint4*>(data + static_cast<size_t>(o) * half + jb));
        slo = __half2float(scales[static_cast<size_t>(o) * nsb + (jb >> 5)]);
        shi = __half2float(scales[static_cast<size_t>(o) * nsb + ((half + jb) >> 5)]);
      }
      uint32_t lo[8], hi[8];
      decode_sym_int4_16(pk, slo, shi, lo, hi);
      uint4* dlo = reinterpret_cast<uint4*>(&ws[r][p * 16]);
      uint4* dhi = reinterpret_cast<uint4*>(&ws[r][kBJ + p * 16]);
      dlo[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      dlo[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
      dhi[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      dhi[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    }
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

  // epilogue: each warp stages one 16x16 f32 fragment at a time in the
  // (now idle) g tile, then writes bf16 with the ragged edges masked
  float* stage = reinterpret_cast<float*>(&gs[0][0]) + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int m = m0 + wm * 32 + i * 16 + (e >> 4);
        const int jj = j0 + j * 16 + (e & 15);  // packed byte of this column
        const int col = wn * half + jj;
        if (m < M && jj < half) dx[static_cast<size_t>(m) * K + col] = __float2bfloat16(stage[e]);
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" int qmatmul_sym_int4_dx(const void* g, const void* data, const void* scales, void* dx, int M,
                                   int K, int O, void* stream) {
  const dim3 grid((K / 2 + kBJ - 1) / kBJ, (M + kBM - 1) / kBM);
  dx_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(g), static_cast<const uint8_t*>(data), static_cast<const __half*>(scales),
      static_cast<bf16*>(dx), M, K, O);
  return static_cast<int>(cudaGetLastError());
}
