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
//   weight (0.39-1.07 B per weight with its scales, by format). Each warp
//   streams whole rows with 16-byte loads and keeps RPW rows live, so
//   every x value read from shared memory feeds RPW rows; x is staged once
//   per block in shared memory in K chunks. The walk runs over the j
//   positions of the format's finest plane split S (qdecode.cuh): a lane
//   loads the pieces of 16 j positions of every plane once, into
//   registers, and decodes the S groups u*Q + j .. +15 from them in turn,
//   each against its x slice, so every weight byte crosses DRAM once, as
//   the byte bound assumes.
// * qmatmul_gemm (M > 32, prefill): bound by operations at large M. A
//   128 x 128 output tile per block; each K step decodes a 128 x KS W tile
//   to bf16 in shared memory once and feeds the tensor cores through wmma
//   (bf16 in, f32 accumulate). KS = max(64, 16 S) elements: the groups of
//   JB = KS/S j positions, all S segments. The order of the tile's columns
//   is the groups' (x is staged in the same order), which a contraction
//   does not see. No cp.async/TMA pipeline and no wgmma yet.
// * qmatmul_gemm_lora: the GEMM with `_kernel`'s `lora` arm (the LoRA
//   epilogue of `qmatmul_lora`): y = x . dq(W)^T + bf16((x . A_cat^T) *
//   gate) . B_cat^T for R <= 16 adapter columns. xa = x . A_cat^T is summed
//   by the tensor cores from the x tiles the GEMM already stages (A_cat's
//   matching K slices ride beside them), so the epilogue reads x no second
//   time; after the K walk xa * gate is rounded to bf16 and its product with
//   the block's B_cat rows is added to the f32 tile before the one bf16
//   rounding of y — the reference's rounding points. M > 32 only (the
//   training shapes).
//
// All return cudaGetLastError() after the launch; 0 means launched.

#include <mma.h>

#include "qdecode.cuh"

#ifndef BIGDL_QFMT
#error "build with -DBIGDL_QFMT=QF_<qtype> (ops/kernels/_build.py does)"
#endif

namespace {

using Fmt = BIGDL_QFMT;
constexpr int kS = Fmt::kS;

constexpr int kGemvWarps = 8;

// j positions of x staged per K chunk: 32 lanes x 16, fewer where MT rows
// of x over S segments would pass 64 KB of shared memory.
template <int MT>
__host__ __device__ constexpr int gemv_chunk() {
  return 32768 / (MT * kS) < 512 ? 32768 / (MT * kS) : 512;
}

// One warp owns RPW output rows; a block owns kGemvWarps * RPW rows. MT is
// the row count of x rounded up to a power of two (rows >= M are zero).
template <int MT, int RPW>
__global__ void __launch_bounds__(kGemvWarps * 32)
    gemv_kernel(const bf16* __restrict__ x, const QFields w, bf16* __restrict__ out, int M, int K,
                int O) {
  constexpr int CJ = gemv_chunk<MT>();
  extern __shared__ __align__(32) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [MT][S][CJ]: x at u*Q + c0 + j
  __shared__ float lut[16];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int Q = K / kS;
  const size_t row_bytes = static_cast<size_t>(K) * Fmt::kBits / 8;
  const int row0 = (blockIdx.x * kGemvWarps + warp) * RPW;
  if constexpr (Fmt::kLut) {
    if (threadIdx.x < 16) lut[threadIdx.x] = qlut<Fmt>()[threadIdx.x];
  }

  float acc[RPW][MT];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[r][m] = 0.0f;

  for (int c0 = 0; c0 < Q; c0 += CJ) {
    const int cw = min(CJ, Q - c0);  // a multiple of 16: K % k_multiple == 0
    const int vecs = cw >> 3;        // 16-byte vectors of x per row slice
    __syncthreads();
    for (int i = threadIdx.x; i < MT * kS * vecs; i += blockDim.x) {
      const int m = i / (kS * vecs);
      const int u = (i / vecs) % kS;
      const int v = i % vecs;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m < M) val = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(m) * K + u * Q + c0 + v * 8);
      *reinterpret_cast<uint4*>(xs + (m * kS + u) * CJ + v * 8) = val;
    }
    __syncthreads();

    const int jb = lane * 16;  // this lane's j offset within the chunk
    if (jb < cw) {
      uint4 pc[RPW][Fmt::kPieces];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int o = row0 + r;
        qload_pieces<Fmt>(w.data + static_cast<size_t>(o) * row_bytes, K, c0 + jb, o < O, pc[r]);
      }
      static_for<0, kS>([&](auto uc) {
        constexpr int U = decltype(uc)::value;
        uint32_t wv[RPW][8];
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          QScale<Fmt> sc;
          sc.load(w, row0 + r, K, U * Q + c0 + jb, row0 + r < O);
          qdecode16<Fmt, U>(pc[r], sc.a(), sc.b(), lut, wv[r]);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const uint4* xp = reinterpret_cast<const uint4*>(xs + (m * kS + U) * CJ + jb);
          const uint4 x0 = xp[0], x1 = xp[1];
          const uint32_t xw[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int r = 0; r < RPW; ++r) {
            float s = acc[r][m];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float2 xa = bf16x2_to_float2(xw[i]);
              const float2 wa = bf16x2_to_float2(wv[r][i]);
              s = fmaf(xa.x, wa.x, s);
              s = fmaf(xa.y, wa.y, s);
            }
            acc[r][m] = s;
          }
        }
      });
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
int launch_gemv(const bf16* x, const QFields& w, bf16* out, int M, int K, int O, cudaStream_t stream) {
  const int rows_per_block = kGemvWarps * RPW;
  const int smem = MT * kS * gemv_chunk<MT>() * static_cast<int>(sizeof(bf16));
  cudaFuncSetAttribute(gemv_kernel<MT, RPW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((O + rows_per_block - 1) / rows_per_block);
  gemv_kernel<MT, RPW><<<grid, kGemvWarps * 32, smem, stream>>>(x, w, out, M, K, O);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kBM = 128;                   // x rows per block tile
constexpr int kBN = 128;                   // output columns (weight rows) per block tile
constexpr int kKS = 16 * kS > 64 ? 16 * kS : 64;  // elements of a row per K step
constexpr int kNG = kKS / 16;              // groups per K step
constexpr int kJB = kKS / kS;              // j positions per K step
constexpr int kLds = kKS + 8;              // bf16 row stride in shared memory (wmma-legal, 16 B aligned)
constexpr int kParts = 2;                  // threads decoding one weight row
constexpr int kGPT = kNG / kParts;         // groups each of them decodes

constexpr int kLoraR = 16;         // adapter columns of the LoRA epilogue (R <= 16, zero-padded)
constexpr int kLdr = kLoraR + 8;   // bf16 row stride of the epilogue operands (48 B)

__host__ __device__ constexpr int gemm_smem(bool lora) {
  return (2 * kBM + (lora ? kLoraR : 0)) * kLds * static_cast<int>(sizeof(bf16));
}

using namespace nvcuda;

// 8 warps as 4 (M) x 2 (N); each warp owns a 32 x 64 piece of the tile as
// 2 x 4 wmma 16x16 f32 accumulators. With kLora, warp (wm, wn) also sums
// xa for the 16 x rows wm * 32 + wn * 16.. in one more accumulator.
template <bool kLora>
__global__ void __launch_bounds__(256)
    gemm_kernel(const bf16* __restrict__ x, const QFields w, bf16* __restrict__ out, int M, int K,
                int O, const bf16* __restrict__ la, const bf16* __restrict__ lb,
                const bf16* __restrict__ lg, int R) {
  extern __shared__ __align__(32) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [kBM][kLds]: x in the groups' column order
  bf16* ws = xs + kBM * kLds;                    // [kBN][kLds]: decoded weight rows
  bf16* as = ws + kBN * kLds;                    // [kLoraR][kLds]: A_cat (LoRA only)
  __shared__ float lut[16];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 1;
  const int wn = warp & 1;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
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
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> xa;
  if constexpr (kLora) wmma::fill_fragment(xa, 0.0f);

  // vector i of row r of an x-like operand `src` (row stride K) for the
  // step at j0, in the groups' order (2 16-byte vectors a group); zero
  // outside the operand
  auto stage_load = [&](const bf16* src, int rows_valid, int r, int i, int j0) {
    const int g = i >> 1, h = i & 1;
    const int jj = j0 + (g / kS) * 16;
    const int u = g % kS;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid && jj < Q)
      val = __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * K + u * Q + jj + h * 8));
    return val;
  };

  // One K step's operands in registers: x (kNG vectors a thread), the W
  // share and A_cat's slices (LoRA). `fetch` issues all their loads, `put`
  // stores them (W decoded) into shared memory: all loads of a step go out
  // before its first store.
  uint4 xv[kNG];
  uint4 av = make_uint4(0u, 0u, 0u, 0u);
  QTileFetch<Fmt, kParts, kGPT> wf;
  auto fetch = [&](int j0) {
#pragma unroll
    for (int v = 0; v < kNG; ++v) {
      const int i = tid + v * 256;
      xv[v] = stage_load(x + static_cast<size_t>(m0) * K, M - m0, i / (kNG * 2), i % (kNG * 2), j0);
    }
    wf.load(w, tid, kBN, n0, O, K, j0);
    if constexpr (kLora) {
      if (tid < kLoraR * kNG * 2) av = stage_load(la, R, tid / (kNG * 2), tid % (kNG * 2), j0);
    }
  };
  auto put = [&]() {
#pragma unroll
    for (int v = 0; v < kNG; ++v) {
      const int i = tid + v * 256;
      *reinterpret_cast<uint4*>(xs + (i / (kNG * 2)) * kLds + (i % (kNG * 2)) * 8) = xv[v];
    }
    wf.store(lut, ws, kLds);
    if constexpr (kLora) {
      if (tid < kLoraR * kNG * 2)
        *reinterpret_cast<uint4*>(as + (tid / (kNG * 2)) * kLds + (tid % (kNG * 2)) * 8) = av;
    }
  };

  for (int j0 = 0; j0 < Q; j0 += kJB) {
    fetch(j0);
    put();
    __syncthreads();

    if constexpr (kLora) {
#pragma unroll
      for (int kk = 0; kk < kKS; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, xs + (wm * 32 + wn * 16) * kLds + kk, kLds);
        wmma::load_matrix_sync(b, as + kk, kLds);
        wmma::mma_sync(xa, a, b, xa);
      }
    }

#pragma unroll
    for (int kk = 0; kk < kKS; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], xs + (wm * 32 + i * 16) * kLds + kk, kLds);
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::load_matrix_sync(b[j], ws + (wn * 64 + j * 16) * kLds + kk, kLds);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  if constexpr (kLora) {
    // LoRA epilogue in the idle tiles: xa [128 x 16] f32 in ws, then
    // bf16(xa * gate) and the block's B_cat rows [128 x 16] in xs
    float* xstage = reinterpret_cast<float*>(ws);
    bf16* xab = xs;
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
  float* stg = reinterpret_cast<float*>(xs) + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(stg, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int m = m0 + wm * 32 + i * 16 + (e >> 4);
        const int o = n0 + wn * 64 + j * 16 + (e & 15);
        if (m < M && o < O) out[static_cast<size_t>(m) * O + o] = __float2bfloat16(stg[e]);
      }
      __syncwarp();
    }
  }
}

template <bool kLora>
int launch_gemm(const bf16* x, const QFields& w, bf16* out, int M, int K, int O, const bf16* la,
                const bf16* lb, const bf16* lg, int R, cudaStream_t stream) {
  const int smem = gemm_smem(kLora);
  cudaFuncSetAttribute(gemm_kernel<kLora>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((O + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_kernel<kLora><<<grid, 256, smem, stream>>>(x, w, out, M, K, O, la, lb, lg, R);
  return static_cast<int>(cudaGetLastError());
}

QFields fields(const void* data, const void* scales, const void* mins, const void* sub_scales,
               const void* sub_mins) {
  return QFields{static_cast<const uint8_t*>(data), static_cast<const __half*>(scales),
                 static_cast<const __half*>(mins), static_cast<const uint8_t*>(sub_scales),
                 static_cast<const uint8_t*>(sub_mins)};
}

}  // namespace

// x [M, K] bf16, the weight's fields (null where absent), out [M, O] bf16.
extern "C" int qmatmul_gemv(const void* x, const void* data, const void* scales, const void* mins,
                            const void* sub_scales, const void* sub_mins, void* out, int M, int K,
                            int O, void* stream) {
  const bf16* xp = static_cast<const bf16*>(x);
  const QFields w = fields(data, scales, mins, sub_scales, sub_mins);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 1) return launch_gemv<1, 4>(xp, w, op, M, K, O, st);
  if (M <= 2) return launch_gemv<2, 4>(xp, w, op, M, K, O, st);
  if (M <= 4) return launch_gemv<4, 4>(xp, w, op, M, K, O, st);
  if (M <= 8) return launch_gemv<8, 4>(xp, w, op, M, K, O, st);
  if (M <= 16) return launch_gemv<16, 2>(xp, w, op, M, K, O, st);
  if (M <= 32) return launch_gemv<32, 1>(xp, w, op, M, K, O, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int qmatmul_gemm(const void* x, const void* data, const void* scales, const void* mins,
                            const void* sub_scales, const void* sub_mins, void* out, int M, int K,
                            int O, void* stream) {
  return launch_gemm<false>(static_cast<const bf16*>(x), fields(data, scales, mins, sub_scales, sub_mins),
                            static_cast<bf16*>(out), M, K, O, nullptr, nullptr, nullptr, 0,
                            static_cast<cudaStream_t>(stream));
}

// a_cat [R, K], b_cat [O, R], gate [M, R], all bf16; R <= 16.
extern "C" int qmatmul_gemm_lora(const void* x, const void* data, const void* scales, const void* mins,
                                 const void* sub_scales, const void* sub_mins, const void* a_cat,
                                 const void* b_cat, const void* gate, void* out, int M, int K, int O,
                                 int R, void* stream) {
  if (R < 1 || R > kLoraR) return static_cast<int>(cudaErrorInvalidValue);
  return launch_gemm<true>(static_cast<const bf16*>(x), fields(data, scales, mins, sub_scales, sub_mins),
                           static_cast<bf16*>(out), M, K, O, static_cast<const bf16*>(a_cat),
                           static_cast<const bf16*>(b_cat), static_cast<const bf16*>(gate), R,
                           static_cast<cudaStream_t>(stream));
}
