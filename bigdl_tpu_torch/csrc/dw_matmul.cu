// Weight gradient of a dense projection for Hopper:
// dW[O, K] = g[M, O]^T . x[M, K], bf16 operands, f32 sums over all M rows,
// one rounding to the output type (bf16 or f32) at the end.
//
// Replaces the Pallas kernel bigdl_tpu/ops/pallas/qbackward.py `_dw_kernel`
// (launched by `_dwmm`, wrapped by `dw_matmul`): the weight-shaped gradient
// of y = x . W^T for a weight that trains (the full fine-tune's every dense
// projection and the lm head).
//
// What bounds it: operations. Each output element costs 2 M flops and is
// written once, so at the training shapes (M = 1024) the work is ~1000
// flops per output byte, far above the ~295 flops per byte where the
// H100's bf16 tensor cores stop waiting on memory.
//
// Design: the TPU kernel keeps a [block_o, K] f32 slab in VMEM and walks M
// as its innermost grid axis; here one block owns a 128 x 128 tile of dW
// and walks all of M itself in steps of 32 rows, so no partial sum crosses
// blocks (no atomics; the same result from run to run). Both operands
// arrive row-major [M, .]: the g tile [32 m][128 o] and the x tile [32 m]
// [128 k] are staged in shared memory with cp.async (two stages: the next
// step's tiles load while this step's multiply), and ldmatrix.trans turns
// them into the m16n8k16 fragments of mma.sync (bf16 in, f32 accumulate):
// g^T's A fragments and x's B fragments both come from the transposed
// read. Eight warps as 2 (o) x 4 (k), each 64 x 32 of the tile. Rows past
// M and columns past O or K load as zeros (cp.async's zero fill) and are
// not stored: the wrapper pads nothing. Where O or K is not a multiple of
// 8 (or a base is not 16-byte aligned) a scalar-load variant stages the
// same tiles. No TMA, no wgmma yet.
//
// Returns cudaGetLastError() after the launch; 0 means launched.

#include "common.cuh"

namespace {

constexpr int kBO = 128;       // dW rows (columns of g) per block
constexpr int kBK = 128;       // dW columns (columns of x) per block
constexpr int kBM = 32;        // rows of g and x per step of the M walk
constexpr int kLd = 128 + 8;   // bf16 row stride of both tiles (272 B)
constexpr int kThreads = 256;

__device__ __forceinline__ void store2(bf16* p, float a, float b, bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16(a);
    if (second) p[1] = __float2bfloat16(b);
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b, bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (second) p[1] = b;
  }
}

// One step's tiles: rows m0 .. m0 + 31 of g (columns o0 ..) and of x
// (columns k0 ..) into stage `gs`/`xs`. kVec: 16-byte cp.async pieces
// (O % 8 == 0, K % 8 == 0, aligned bases); else scalar loads.
template <bool kVec>
__device__ __forceinline__ void load_tiles(bf16 (*gs)[kLd], bf16 (*xs)[kLd], const bf16* __restrict__ g,
                                           const bf16* __restrict__ x, int m0, int o0, int k0, int M, int O,
                                           int K, int tid) {
  if constexpr (kVec) {
#pragma unroll
    for (int v = 0; v < kBM * (kBO / 8) / kThreads; ++v) {
      const int i = tid + v * kThreads;
      const int r = i / (kBO / 8);
      const int c = (i % (kBO / 8)) * 8;
      const int m = m0 + r;
      const bool okg = m < M && o0 + c < O;
      const bool okx = m < M && k0 + c < K;
      cp_async16(&gs[r][c], okg ? g + static_cast<size_t>(m) * O + o0 + c : g, okg ? 16 : 0);
      cp_async16(&xs[r][c], okx ? x + static_cast<size_t>(m) * K + k0 + c : x, okx ? 16 : 0);
    }
    cp_async_commit();
  } else {
    const bf16 zero = __float2bfloat16(0.0f);
    for (int e = tid; e < kBM * kBO; e += kThreads) {
      const int r = e / kBO;
      const int c = e % kBO;
      const int m = m0 + r;
      gs[r][c] = (m < M && o0 + c < O) ? g[static_cast<size_t>(m) * O + o0 + c] : zero;
      xs[r][c] = (m < M && k0 + c < K) ? x[static_cast<size_t>(m) * K + k0 + c] : zero;
    }
  }
}

template <typename OutT, bool kVec>
__global__ void __launch_bounds__(kThreads)
    dw_kernel(const bf16* __restrict__ g, const bf16* __restrict__ x, OutT* __restrict__ dw, int M, int O, int K) {
  __shared__ __align__(128) bf16 gs[2][kBM][kLd];  // [stage][row m][column o of the tile]
  __shared__ __align__(128) bf16 xs[2][kBM][kLd];  // [stage][row m][column k of the tile]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wo = warp >> 2;  // 64 dW rows
  const int wk = warp & 3;   // 32 dW columns
  const int o0 = blockIdx.y * kBO;
  const int k0 = blockIdx.x * kBK;
  const int steps = (M + kBM - 1) / kBM;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // ldmatrix row addresses: lane l feeds row (l & 7) of 8x8 matrix l >> 3
  const int mat = lane >> 3;
  const int row8 = lane & 7;

  load_tiles<kVec>(gs[0], xs[0], g, x, 0, o0, k0, M, O, K, tid);
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    if (s + 1 < steps) {
      load_tiles<kVec>(gs[cur ^ 1], xs[cur ^ 1], g, x, (s + 1) * kBM, o0, k0, M, O, K, tid);
      if constexpr (kVec) cp_async_wait<1>();
    } else {
      if constexpr (kVec) cp_async_wait<0>();
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBM; kk += 16) {
      // A = g^T [16 o x 16 m]: matrices (m half, o half) = (i >> 1, i & 1)
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4_trans(a[i], &gs[cur][kk + (mat >> 1) * 8 + row8][wo * 64 + i * 16 + (mat & 1) * 8]);
      // B = x [16 m x 8 k], two n8 tiles a load: matrices (m half, k half)
      // = (i & 1, i >> 1)
      uint32_t b[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldmatrix_x4_trans(b[j], &xs[cur][kk + (mat & 1) * 8 + row8][wk * 32 + j * 16 + (mat >> 1) * 8]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j >> 1][(j & 1) * 2], b[j >> 1][(j & 1) * 2 + 1]);
    }
    __syncthreads();
  }

  // c0, c1: row gid, columns 2 tig, 2 tig + 1; c2, c3: row gid + 8
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const bool even_k = (K & 1) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + wk * 32 + j * 8 + tig * 2;
      if (k >= K) continue;
      const bool second = k + 1 < K;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = o0 + wo * 64 + i * 16 + gid + h * 8;
        if (o < O)
          store2(dw + static_cast<size_t>(o) * K + k, acc[i][j][2 * h], acc[i][j][2 * h + 1], even_k && second,
                 second);
      }
    }
  }
}

template <typename OutT>
void launch(const bf16* g, const bf16* x, OutT* dw, int M, int O, int K, bool vec, cudaStream_t stream) {
  const dim3 grid((K + kBK - 1) / kBK, (O + kBO - 1) / kBO);
  if (vec)
    dw_kernel<OutT, true><<<grid, kThreads, 0, stream>>>(g, x, dw, M, O, K);
  else
    dw_kernel<OutT, false><<<grid, kThreads, 0, stream>>>(g, x, dw, M, O, K);
}

}  // namespace

// g [M, O] bf16, x [M, K] bf16, dw [O, K] bf16 (out_f32 == 0) or f32;
// vec != 0 only where O % 8 == 0, K % 8 == 0 and both bases are 16-byte
// aligned. M >= 1.
extern "C" int dw_matmul(const void* g, const void* x, void* dw, int M, int O, int K, int out_f32, int vec,
                         void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto gp = static_cast<const bf16*>(g);
  const auto xp = static_cast<const bf16*>(x);
  if (out_f32)
    launch(gp, xp, static_cast<float*>(dw), M, O, K, vec != 0, s);
  else
    launch(gp, xp, static_cast<bf16*>(dw), M, O, K, vec != 0, s);
  return static_cast<int>(cudaGetLastError());
}
