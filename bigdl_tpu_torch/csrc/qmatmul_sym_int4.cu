// Fused sym_int4 dequant-matmul for Hopper: y[M, O] = x[M, K] . dequant(W)[O, K]^T.
//
// Replaces the Pallas kernel bigdl_tpu/ops/pallas/qmatmul.py `_kernel`
// (launched by `_qmm`, wrapped by `qmatmul_int4`) for the sym_int4 format,
// with its decode from ops/pallas/qdecode.py `decode_chunk` (qdecode.cuh).
// The TPU kernel is one body for both shape classes; on this card they are
// two kernels, because what bounds them differs:
//
// * qmatmul_sym_int4_gemv (M <= 32, decode): bound by the bytes of the
//   packed weight (0.5625 B per weight with its scales). Each warp streams
//   whole rows with 16-byte loads, decodes in registers and keeps RPW
//   decoded rows live, so every x value read from shared memory feeds RPW
//   rows; x is staged once per block in shared memory, in K chunks (32 rows
//   of x at K = 14336 would be 917 KB, far above the 227 KB a block gets).
// * qmatmul_sym_int4_gemm (M > 32, prefill): bound by operations at large
//   M. A 128 x 128 output tile per block; each K step decodes a W tile to
//   bf16 in shared memory once and feeds the tensor cores through wmma
//   (bf16 in, f32 accumulate). No cp.async/TMA pipeline and no wgmma yet.
//
// The K walk runs over the packed bytes: byte j feeds element j of the low
// half and element j + K/2 of the high half, so each step multiplies two
// x slices (columns j.. and K/2 + j..) with the two decoded halves, as
// qdecode.walk walks the two nibble planes.
//
// qmatmul_sym_int4_gemm_lora is the GEMM with `_kernel`'s `lora` arm (the
// LoRA epilogue of `qmatmul_lora`): y = x . dq(W)^T + bf16((x . A_cat^T)
// * gate) . B_cat^T for R <= 16 adapter columns. xa = x . A_cat^T is summed
// by the tensor cores from the x tiles the GEMM already stages (A_cat's
// matching K slices ride beside them: 2 x 16 x 32 bf16 per step), so the
// epilogue reads x no second time; after the K walk xa * gate is rounded to
// bf16 and its product with the block's B_cat rows is added to the f32
// tile before the one bf16 rounding of y — the reference's rounding
// points. Launched for M > 32 only (the training shapes).
//
// All return cudaGetLastError() after the launch; 0 means launched.

#include <mma.h>

#include "qdecode.cuh"

namespace {

constexpr int kGemvWarps = 8;
constexpr int kGemvChunk = 512;  // packed bytes of a row per K chunk: 32 lanes x 16 B

// One warp owns RPW output rows; a block owns kGemvWarps * RPW rows. MT is
// the row count of x rounded up to a power of two (rows >= M are zero).
template <int MT, int RPW>
__global__ void __launch_bounds__(kGemvWarps * 32)
    gemv_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ data,
                const __half* __restrict__ scales, bf16* __restrict__ out, int M, int K, int O) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [MT][2][kGemvChunk]: low and high half slices

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int half = K >> 1;  // packed bytes per row
  const int nsb = K >> 5;   // scales per row
  const int row0 = (blockIdx.x * kGemvWarps + warp) * RPW;

  float acc[RPW][MT];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[r][m] = 0.0f;

  for (int c0 = 0; c0 < half; c0 += kGemvChunk) {
    const int cw = min(kGemvChunk, half - c0);  // a multiple of 32: K % 64 == 0
    const int vecs = cw >> 3;                    // 16-byte vectors of x per row slice
    __syncthreads();
    for (int i = threadIdx.x; i < MT * 2 * vecs; i += blockDim.x) {
      const int m = i / (2 * vecs);
      const int h = (i / vecs) & 1;
      const int v = i % vecs;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m < M) val = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(m) * K + h * half + c0 + v * 8);
      *reinterpret_cast<uint4*>(xs + (m * 2 + h) * kGemvChunk + v * 8) = val;
    }
    __syncthreads();

    const int jb = lane * 16;  // this lane's byte offset within the chunk
    if (jb < cw) {
      uint32_t wlo[RPW][8], whi[RPW][8];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int o = row0 + r;
        uint4 pk = make_uint4(0u, 0u, 0u, 0u);
        float slo = 0.0f, shi = 0.0f;
        if (o < O) {
          pk = __ldg(reinterpret_cast<const uint4*>(data + static_cast<size_t>(o) * half + c0 + jb));
          slo = __half2float(scales[static_cast<size_t>(o) * nsb + ((c0 + jb) >> 5)]);
          shi = __half2float(scales[static_cast<size_t>(o) * nsb + ((half + c0 + jb) >> 5)]);
        }
        decode_sym_int4_16(pk, slo, shi, wlo[r], whi[r]);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const uint4* xl = reinterpret_cast<const uint4*>(xs + (m * 2) * kGemvChunk + jb);
        const uint4* xh = reinterpret_cast<const uint4*>(xs + (m * 2 + 1) * kGemvChunk + jb);
        const uint4 l0 = xl[0], l1 = xl[1], h0 = xh[0], h1 = xh[1];
        const uint32_t xlo[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
        const uint32_t xhi[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          float a = acc[r][m];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float2 xa = bf16x2_to_float2(xlo[i]);
            const float2 wa = bf16x2_to_float2(wlo[r][i]);
            a = fmaf(xa.x, wa.x, a);
            a = fmaf(xa.y, wa.y, a);
            const float2 xb = bf16x2_to_float2(xhi[i]);
            const float2 wb = bf16x2_to_float2(whi[r][i]);
            a = fmaf(xb.x, wb.x, a);
            a = fmaf(xb.y, wb.y, a);
          }
          acc[r][m] = a;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int o = row0 + r;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float v = warp_sum(acc[r][m]);
      if (lane == 0 && m < M && o < O) out[static_cast<size_t>(m) * O + o] = __float2bfloat16(v);
    }
  }
}

template <int MT, int RPW>
int launch_gemv(const bf16* x, const uint8_t* data, const __half* scales, bf16* out, int M, int K,
                int O, cudaStream_t stream) {
  const int rows_per_block = kGemvWarps * RPW;
  const int smem = MT * 2 * kGemvChunk * static_cast<int>(sizeof(bf16));
  cudaFuncSetAttribute(gemv_kernel<MT, RPW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((O + rows_per_block - 1) / rows_per_block);
  gemv_kernel<MT, RPW><<<grid, kGemvWarps * 32, smem, stream>>>(x, data, scales, out, M, K, O);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kBM = 128;  // x rows per block tile
constexpr int kBN = 128;  // output columns (weight rows) per block tile
constexpr int kBK = 32;   // packed bytes per K step: 32 elements of each half
constexpr int kLds = kBK + 8;  // bf16 row stride in shared memory (80 B: wmma-legal, 16 B aligned)

constexpr int kLoraR = 16;     // adapter columns of the LoRA epilogue (R <= 16, zero-padded)
constexpr int kLdr = kLoraR + 8;  // bf16 row stride of the epilogue operands (48 B)

using namespace nvcuda;

// 8 warps as 4 (M) x 2 (N); each warp owns a 32 x 64 piece of the tile as
// 2 x 4 wmma 16x16 f32 accumulators. With kLora, warp (wm, wn) also sums
// xa for the 16 x rows wm * 32 + wn * 16.. in one more accumulator.
template <bool kLora>
__global__ void __launch_bounds__(256)
    gemm_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ data,
                const __half* __restrict__ scales, bf16* __restrict__ out, int M, int K, int O,
                const bf16* __restrict__ la, const bf16* __restrict__ lb,
                const bf16* __restrict__ lg, int R) {
  __shared__ __align__(32) bf16 xs[2][kBM][kLds];  // [half][row][k]
  __shared__ __align__(32) bf16 ws[2][kBN][kLds];  // [half][weight row][k]
  // [half][adapter column][k]: A_cat's slices of this K step (LoRA only)
  __shared__ __align__(32) bf16 as[kLora ? 2 : 1][kLora ? kLoraR : 1][kLds];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 1;
  const int wn = warp & 1;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int half = K >> 1;
  const int nsb = K >> 5;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> xa;
  if constexpr (kLora) wmma::fill_fragment(xa, 0.0f);

  for (int j0 = 0; j0 < half; j0 += kBK) {
    // x slices: 2 halves x 128 rows x 32 bf16 = 1024 16-byte vectors
    for (int i = tid; i < 2 * kBM * (kBK / 8); i += 256) {
      const int h = i / (kBM * (kBK / 8));
      const int r = (i / (kBK / 8)) % kBM;
      const int v = i % (kBK / 8);
      const int m = m0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m < M) val = __ldg(reinterpret_cast<const uint4*>(x + static_cast<size_t>(m) * K + h * half + j0 + v * 8));
      *reinterpret_cast<uint4*>(&xs[h][r][v * 8]) = val;
    }
    // weight tile: 128 rows x 32 packed bytes, one 16-byte vector per thread
    {
      const int r = tid >> 1;
      const int p = tid & 1;
      const int o = n0 + r;
      uint4 pk = make_uint4(0u, 0u, 0u, 0u);
      float slo = 0.0f, shi = 0.0f;
      if (o < O) {
        pk = __ldg(reinterpret_cast<const uint4*>(data + static_cast<size_t>(o) * half + j0 + p * 16));
        slo = __half2float(scales[static_cast<size_t>(o) * nsb + (j0 >> 5)]);
        shi = __half2float(scales[static_cast<size_t>(o) * nsb + ((half + j0) >> 5)]);
      }
      uint32_t lo[8], hi[8];
      decode_sym_int4_16(pk, slo, shi, lo, hi);
      uint4* dlo = reinterpret_cast<uint4*>(&ws[0][r][p * 16]);
      uint4* dhi = reinterpret_cast<uint4*>(&ws[1][r][p * 16]);
      dlo[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      dlo[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
      dhi[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      dhi[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    }
    if constexpr (kLora) {
      // A_cat slices: 2 halves x 16 columns x 32 bf16 = 128 16-byte vectors
      if (tid < 2 * kLoraR * (kBK / 8)) {
        const int h = tid / (kLoraR * (kBK / 8));
        const int r = (tid / (kBK / 8)) % kLoraR;
        const int v = tid % (kBK / 8);
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r < R) val = __ldg(reinterpret_cast<const uint4*>(la + static_cast<size_t>(r) * K + h * half + j0 + v * 8));
        *reinterpret_cast<uint4*>(&as[h][r][v * 8]) = val;
      }
    }
    __syncthreads();

    if constexpr (kLora) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
          wmma::load_matrix_sync(a, &xs[h][wm * 32 + wn * 16][kk], kLds);
          wmma::load_matrix_sync(b, &as[h][0][kk], kLds);
          wmma::mma_sync(xa, a, b, xa);
        }
      }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], &xs[h][wm * 32 + i * 16][kk], kLds);
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::load_matrix_sync(b[j], &ws[h][wn * 64 + j * 16][kk], kLds);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  if constexpr (kLora) {
    // LoRA epilogue in the idle tiles: xa [128 x 16] f32 in ws, then
    // bf16(xa * gate) and the block's B_cat rows [128 x 16] in xs
    float* xstage = reinterpret_cast<float*>(&ws[0][0][0]);
    bf16* xab = &xs[0][0][0];
    bf16* bs = xab + kBM * kLdr;
    wmma::store_matrix_sync(xstage + (wm * 32 + wn * 16) * kLoraR, xa, kLoraR, wmma::mem_row_major);
    __syncthreads();
    for (int i = tid; i < kBM * kLoraR; i += 256) {
      const int r = i / kLoraR;
      const int c = i % kLoraR;
      const int m = m0 + r;
      const int o = n0 + r;
      float v = 0.0f;
      if (c < R && m < M) v = xstage[i] * __bfloat162float(lg[static_cast<size_t>(m) * R + c]);
      xab[r * kLdr + c] = __float2bfloat16(v);
      bs[r * kLdr + c] = (c < R && o < O) ? lb[static_cast<size_t>(o) * R + c] : __float2bfloat16(0.0f);
    }
    __syncthreads();
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], xab + (wm * 32 + i * 16) * kLdr, kLdr);
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::load_matrix_sync(b[j], bs + (wn * 64 + j * 16) * kLdr, kLdr);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    __syncthreads();  // the staging below reuses xs
  }

  // epilogue: each warp stages one 16x16 f32 fragment at a time in the
  // (now idle) x tile, then writes bf16 with the ragged edges masked
  float* stage = reinterpret_cast<float*>(&xs[0][0][0]) + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int m = m0 + wm * 32 + i * 16 + (e >> 4);
        const int o = n0 + wn * 64 + j * 16 + (e & 15);
        if (m < M && o < O) out[static_cast<size_t>(m) * O + o] = __float2bfloat16(stage[e]);
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" int qmatmul_sym_int4_gemv(const void* x, const void* data, const void* scales, void* out,
                                     int M, int K, int O, void* stream) {
  const bf16* xp = static_cast<const bf16*>(x);
  const uint8_t* dp = static_cast<const uint8_t*>(data);
  const __half* sp = static_cast<const __half*>(scales);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 1) return launch_gemv<1, 4>(xp, dp, sp, op, M, K, O, st);
  if (M <= 2) return launch_gemv<2, 4>(xp, dp, sp, op, M, K, O, st);
  if (M <= 4) return launch_gemv<4, 4>(xp, dp, sp, op, M, K, O, st);
  if (M <= 8) return launch_gemv<8, 4>(xp, dp, sp, op, M, K, O, st);
  if (M <= 16) return launch_gemv<16, 2>(xp, dp, sp, op, M, K, O, st);
  if (M <= 32) return launch_gemv<32, 1>(xp, dp, sp, op, M, K, O, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int qmatmul_sym_int4_gemm(const void* x, const void* data, const void* scales, void* out,
                                     int M, int K, int O, void* stream) {
  const dim3 grid((O + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_kernel<false><<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(data), static_cast<const __half*>(scales),
      static_cast<bf16*>(out), M, K, O, nullptr, nullptr, nullptr, 0);
  return static_cast<int>(cudaGetLastError());
}

// a_cat [R, K], b_cat [O, R], gate [M, R], all bf16; R <= 16.
extern "C" int qmatmul_sym_int4_gemm_lora(const void* x, const void* data, const void* scales,
                                          const void* a_cat, const void* b_cat, const void* gate,
                                          void* out, int M, int K, int O, int R, void* stream) {
  if (R < 1 || R > kLoraR) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((O + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_kernel<true><<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(data), static_cast<const __half*>(scales),
      static_cast<bf16*>(out), M, K, O, static_cast<const bf16*>(a_cat), static_cast<const bf16*>(b_cat),
      static_cast<const bf16*>(gate), R);
  return static_cast<int>(cudaGetLastError());
}
