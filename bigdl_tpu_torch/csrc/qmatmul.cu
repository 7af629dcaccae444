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
// * the LoRA arm of `_kernel` (`qmatmul_lora`): y = x . dq(W)^T +
//   bf16((x . A_cat^T) * gate) . B_cat^T for any R adapter columns that
//   the JAX package's `lora_fused_ok` admits (A_cat up to 4 MB). The TPU
//   kernel keeps A_cat resident in VMEM and recomputes x . A_cat^T for
//   every output tile; here A_cat fits no shared memory, and reading it
//   once per output block would multiply its bytes by the block count. So
//   each entry is two launches on one stream: a first pass computes
//   xg = bf16((x . A_cat^T) * gate) [M, R] once (f32 sums, one rounding,
//   the reference's point), reading A_cat once; the dequant kernel then
//   adds xg . B_cat^T to its f32 accumulator before the one bf16 rounding
//   of y, reading B_cat once. A zero gate gives xg = 0 and adds exactly 0,
//   so a base row of a mixed batch gets the plain form's bits.
//   - qmatmul_gemv_lora (M <= 32, serving decode and short prefill
//     tails): the first pass on CUDA cores (`lora_xa_small_kernel`, a
//     block streams RB rows of A_cat with 16-byte loads against every row
//     of x; bound by A_cat's bytes), then the GEMV with each lane summing
//     xg . B_cat over every 32nd column before the warp reduction.
//   - qmatmul_gemm_lora (M > 32, prefill and training): the first pass on
//     the tensor cores (`lora_xa_tc_kernel`, 16 x 32 tiles of xa, its 4
//     warps splitting the K walk, wmma), then the GEMM, which after its K walk stages
//     kKS columns of xg and of its B_cat rows at a time in the idle tiles
//     and runs them through the same wmma loop.
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

// Eight bf16 values (one 16-byte vector) as floats.
__device__ __forceinline__ void unpack8(const uint4 v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = bf16x2_to_float2(w[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// One warp owns RPW output rows; a block owns kGemvWarps * RPW rows. MT is
// the row count of x rounded up to a power of two (rows >= M are zero).
// With kLora, xg [M, R] (bf16(xa * gate), from lora_xa_small_kernel) and
// B_cat [O, R] add the LoRA epilogue before the warp reduction.
template <int MT, int RPW, bool kLora>
__global__ void __launch_bounds__(kGemvWarps * 32)
    gemv_kernel(const bf16* __restrict__ x, const QFields w, bf16* __restrict__ out, int M, int K,
                int O, const bf16* __restrict__ xg, const bf16* __restrict__ lb, int R) {
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

  if constexpr (kLora) {
    // lane j of the warp sums columns j, j + 32, ... of xg . B_cat^T into
    // the same f32 partials; a zero xg row adds exactly 0
    for (int j = lane; j < R; j += 32) {
      float xv[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        xv[m] = m < M ? __bfloat162float(xg[static_cast<size_t>(m) * R + j]) : 0.0f;
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int o = row0 + r;
        const float b = o < O ? __bfloat162float(lb[static_cast<size_t>(o) * R + j]) : 0.0f;
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[r][m] = fmaf(xv[m], b, acc[r][m]);
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

template <int MT, int RPW, bool kLora>
int launch_gemv(const bf16* x, const QFields& w, bf16* out, int M, int K, int O, const bf16* xg,
                const bf16* lb, int R, cudaStream_t stream) {
  const int rows_per_block = kGemvWarps * RPW;
  const int smem = MT * kS * gemv_chunk<MT>() * static_cast<int>(sizeof(bf16));
  cudaFuncSetAttribute(gemv_kernel<MT, RPW, kLora>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((O + rows_per_block - 1) / rows_per_block);
  gemv_kernel<MT, RPW, kLora><<<grid, kGemvWarps * 32, smem, stream>>>(x, w, out, M, K, O, xg, lb, R);
  return static_cast<int>(cudaGetLastError());
}

// The LoRA GEMV's first pass: xg[m, r] = bf16(gate[m, r] * sum_k x[m, k]
// A_cat[r, k]) for M <= 32. A block owns RB rows of A_cat; its 256 threads
// stride K in 16-byte vectors, each A_cat vector feeding MT rows of x (x is
// small and stays in L1/L2), then the block reduces its partial sums.
template <int MT, int RB>
__global__ void __launch_bounds__(256)
    lora_xa_small_kernel(const bf16* __restrict__ x, const bf16* __restrict__ a,
                         const bf16* __restrict__ gate, bf16* __restrict__ xg, int M, int K, int R) {
  __shared__ float red[8][RB * MT];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * RB;
  float acc[RB][MT];
#pragma unroll
  for (int rb = 0; rb < RB; ++rb)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[rb][m] = 0.0f;

  for (int v = threadIdx.x; v < (K >> 3); v += 256) {
    float av[RB][8];
#pragma unroll
    for (int rb = 0; rb < RB; ++rb) {
      uint4 t = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + rb < R) t = __ldg(reinterpret_cast<const uint4*>(a + static_cast<size_t>(r0 + rb) * K) + v);
      unpack8(t, av[rb]);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < M) {
        float xv[8];
        unpack8(__ldg(reinterpret_cast<const uint4*>(x + static_cast<size_t>(m) * K) + v), xv);
#pragma unroll
        for (int rb = 0; rb < RB; ++rb)
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[rb][m] = fmaf(xv[i], av[rb][i], acc[rb][m]);
      }
    }
  }
#pragma unroll
  for (int rb = 0; rb < RB; ++rb)
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float s = warp_sum(acc[rb][m]);
      if (lane == 0) red[warp][rb * MT + m] = s;
    }
  __syncthreads();
  for (int i = threadIdx.x; i < RB * MT; i += 256) {
    const int r = r0 + i / MT;
    const int m = i % MT;
    if (m < M && r < R) {
      float s = 0.0f;
#pragma unroll
      for (int w8 = 0; w8 < 8; ++w8) s += red[w8][i];
      const size_t at = static_cast<size_t>(m) * R + r;
      xg[at] = __float2bfloat16(s * __bfloat162float(gate[at]));
    }
  }
}

template <int MT, int RPW, int RB>
int launch_gemv_lora(const bf16* x, const QFields& w, const bf16* la, const bf16* lb, const bf16* lg,
                     bf16* xg, bf16* out, int M, int K, int O, int R, cudaStream_t stream) {
  lora_xa_small_kernel<MT, RB><<<(R + RB - 1) / RB, 256, 0, stream>>>(x, la, lg, xg, M, K, R);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_gemv<MT, RPW, true>(x, w, out, M, K, O, xg, lb, R, stream);
}

constexpr int kBM = 128;                   // x rows per block tile
constexpr int kBN = 128;                   // output columns (weight rows) per block tile
constexpr int kKS = 16 * kS > 64 ? 16 * kS : 64;  // elements of a row per K step
constexpr int kNG = kKS / 16;              // groups per K step
constexpr int kJB = kKS / kS;              // j positions per K step
constexpr int kLds = kKS + 8;              // bf16 row stride in shared memory (wmma-legal, 16 B aligned)
constexpr int kParts = 2;                  // threads decoding one weight row
constexpr int kGPT = kNG / kParts;         // groups each of them decodes
constexpr int kGemmSmem = 2 * kBM * kLds * static_cast<int>(sizeof(bf16));

using namespace nvcuda;

// The LoRA GEMM's first pass on the tensor cores: a 16 x 32 tile of
// xg = bf16((x . A_cat^T) * gate) per block. Its 4 warps split the K walk
// (warp w takes the 64-wide K steps w, w + 4, ...), each staging its own x
// and A_cat slices in shared memory (rows past M, columns past R and K
// past its end read as zeros); the block then adds the 4 partial tiles.
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
#pragma unroll
    for (int kk = 0; kk < kXaKS; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, xs[warp] + kk, kXaLd);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, as[warp] + j * 16 * kXaLd + kk, kXaLd);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
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

// 8 warps as 4 (M) x 2 (N); each warp owns a 32 x 64 piece of the tile as
// 2 x 4 wmma 16x16 f32 accumulators. With kLora, xg [M, R] and B_cat
// [O, R] add the LoRA epilogue to those accumulators after the K walk.
template <bool kLora>
__global__ void __launch_bounds__(256)
    gemm_kernel(const bf16* __restrict__ x, const QFields w, bf16* __restrict__ out, int M, int K,
                int O, const bf16* __restrict__ xg, const bf16* __restrict__ lb, int R) {
  extern __shared__ __align__(32) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [kBM][kLds]: x in the groups' column order
  bf16* ws = xs + kBM * kLds;                    // [kBN][kLds]: decoded weight rows
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

  // the tile's MMA over one K step: xs [kBM][kKS] . ws [kBN][kKS]^T
  auto mma_step = [&]() {
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
  };

  // One K step's operands in registers: x (kNG vectors a thread) and the W
  // share. `fetch` issues all their loads, `put` stores them (W decoded)
  // into shared memory: all loads of a step go out before its first store.
  uint4 xv[kNG];
  QTileFetch<Fmt, kParts, kGPT> wf;
  auto fetch = [&](int j0) {
#pragma unroll
    for (int v = 0; v < kNG; ++v) {
      // vector i of the tile: row r, group g = i/2 of the step (j position
      // j0 + (g / S) * 16, segment g % S), half h; zero outside x
      const int i = tid + v * 256;
      const int r = i / (kNG * 2);
      const int g = (i % (kNG * 2)) >> 1, h = i & 1;
      const int jj = j0 + (g / kS) * 16;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M && jj < Q)
        val = __ldg(reinterpret_cast<const uint4*>(x + static_cast<size_t>(m0 + r) * K + (g % kS) * Q + jj + h * 8));
      xv[v] = val;
    }
    wf.load(w, tid, kBN, n0, O, K, j0);
  };
  auto put = [&]() {
#pragma unroll
    for (int v = 0; v < kNG; ++v) {
      const int i = tid + v * 256;
      *reinterpret_cast<uint4*>(xs + (i / (kNG * 2)) * kLds + (i % (kNG * 2)) * 8) = xv[v];
    }
    wf.store(lut, ws, kLds);
  };

  for (int j0 = 0; j0 < Q; j0 += kJB) {
    fetch(j0);
    put();
    __syncthreads();
    mma_step();
    __syncthreads();
  }

  if constexpr (kLora) {
    // kKS columns of R at a time: xg's rows of the block in xs, B_cat's
    // in ws (zero past M, O and R), through the same MMA as the K walk
    const bf16 zero = __float2bfloat16(0.0f);
    for (int c0 = 0; c0 < R; c0 += kKS) {
      for (int i = tid; i < kBM * kKS; i += 256) {
        const int r = i / kKS;
        const int c = c0 + i % kKS;
        const bool in_r = c < R;
        xs[r * kLds + i % kKS] =
            in_r && m0 + r < M ? xg[static_cast<size_t>(m0 + r) * R + c] : zero;
        ws[r * kLds + i % kKS] =
            in_r && n0 + r < O ? lb[static_cast<size_t>(n0 + r) * R + c] : zero;
      }
      __syncthreads();
      mma_step();
      __syncthreads();
    }
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
int launch_gemm(const bf16* x, const QFields& w, bf16* out, int M, int K, int O, const bf16* xg,
                const bf16* lb, int R, cudaStream_t stream) {
  cudaFuncSetAttribute(gemm_kernel<kLora>, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  const dim3 grid((O + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_kernel<kLora><<<grid, 256, kGemmSmem, stream>>>(x, w, out, M, K, O, xg, lb, R);
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
  if (M <= 1) return launch_gemv<1, 4, false>(xp, w, op, M, K, O, nullptr, nullptr, 0, st);
  if (M <= 2) return launch_gemv<2, 4, false>(xp, w, op, M, K, O, nullptr, nullptr, 0, st);
  if (M <= 4) return launch_gemv<4, 4, false>(xp, w, op, M, K, O, nullptr, nullptr, 0, st);
  if (M <= 8) return launch_gemv<8, 4, false>(xp, w, op, M, K, O, nullptr, nullptr, 0, st);
  if (M <= 16) return launch_gemv<16, 2, false>(xp, w, op, M, K, O, nullptr, nullptr, 0, st);
  if (M <= 32) return launch_gemv<32, 1, false>(xp, w, op, M, K, O, nullptr, nullptr, 0, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int qmatmul_gemm(const void* x, const void* data, const void* scales, const void* mins,
                            const void* sub_scales, const void* sub_mins, void* out, int M, int K,
                            int O, void* stream) {
  return launch_gemm<false>(static_cast<const bf16*>(x), fields(data, scales, mins, sub_scales, sub_mins),
                            static_cast<bf16*>(out), M, K, O, nullptr, nullptr, 0,
                            static_cast<cudaStream_t>(stream));
}

// The LoRA forms: a_cat [R, K], b_cat [O, R], gate [M, R], all bf16; xg
// [M, R] bf16 scratch for the first pass; out [M, O] bf16. M <= 32 rows.
extern "C" int qmatmul_gemv_lora(const void* x, const void* data, const void* scales, const void* mins,
                                 const void* sub_scales, const void* sub_mins, const void* a_cat,
                                 const void* b_cat, const void* gate, void* xg, void* out, int M, int K,
                                 int O, int R, void* stream) {
  const bf16* xp = static_cast<const bf16*>(x);
  const QFields w = fields(data, scales, mins, sub_scales, sub_mins);
  const bf16* la = static_cast<const bf16*>(a_cat);
  const bf16* lb = static_cast<const bf16*>(b_cat);
  const bf16* lg = static_cast<const bf16*>(gate);
  bf16* xgp = static_cast<bf16*>(xg);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 1) return launch_gemv_lora<1, 4, 4>(xp, w, la, lb, lg, xgp, op, M, K, O, R, st);
  if (M <= 2) return launch_gemv_lora<2, 4, 4>(xp, w, la, lb, lg, xgp, op, M, K, O, R, st);
  if (M <= 4) return launch_gemv_lora<4, 4, 4>(xp, w, la, lb, lg, xgp, op, M, K, O, R, st);
  if (M <= 8) return launch_gemv_lora<8, 4, 4>(xp, w, la, lb, lg, xgp, op, M, K, O, R, st);
  if (M <= 16) return launch_gemv_lora<16, 2, 2>(xp, w, la, lb, lg, xgp, op, M, K, O, R, st);
  if (M <= 32) return launch_gemv_lora<32, 1, 1>(xp, w, la, lb, lg, xgp, op, M, K, O, R, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same operands, M > 32 rows.
extern "C" int qmatmul_gemm_lora(const void* x, const void* data, const void* scales, const void* mins,
                                 const void* sub_scales, const void* sub_mins, const void* a_cat,
                                 const void* b_cat, const void* gate, void* xg, void* out, int M, int K,
                                 int O, int R, void* stream) {
  if (R < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xp = static_cast<const bf16*>(x);
  bf16* xgp = static_cast<bf16*>(xg);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((R + kXaBR - 1) / kXaBR, (M + kXaBM - 1) / kXaBM);
  lora_xa_tc_kernel<<<grid, kXaWarps * 32, 0, st>>>(xp, static_cast<const bf16*>(a_cat),
                                          static_cast<const bf16*>(gate), xgp, M, K, R);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_gemm<true>(xp, fields(data, scales, mins, sub_scales, sub_mins), static_cast<bf16*>(out),
                           M, K, O, xgp, static_cast<const bf16*>(b_cat), R, st);
}
