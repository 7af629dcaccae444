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
// H100's bf16 tensor cores stop waiting on memory. The reduction is short
// (M = 1024 is 16 steps of 64 rows), so filling the pipeline and writing
// each tile out are a large share of a tile's time.
//
// Design (`dw_tma_kernel`, every shape TMA can read): the TPU kernel keeps a
// [block_o, K] f32 slab in VMEM and walks M as its innermost grid axis;
// here a persistent grid, one block an SM, walks the 128 (o) x 256 (k)
// tiles of dW in the order `tile_origin` gives (groups of 8 o-blocks, the
// o-blocks of a group side by side, so the blocks at work at once share
// x's panels and a few of g's in the L2), and one block sums a tile over
// all of M itself: no split of M, no atomics, the same result from run to
// run. Its three warpgroups:
// * one producer thread keeps a 4-stage ring of 64-row steps in flight
//   with TMA (cp.async.bulk.tensor, 128-byte swizzle, zero fill past M, O
//   and K), each stage's arrival counted on an mbarrier: g's [64 m][128 o]
//   and x's [64 m][256 k] slabs land as they lie in memory, MN-major, so
//   no thread transposes anything; it runs ahead into the next tile while
//   the MMA warpgroups write the last one out;
// * two MMA warpgroups, 64 o-rows each, multiply with wgmma m64n256k16
//   straight from shared memory (A = g^T through the transpose-A bit, B =
//   x through transpose-B), f32 sums in registers (128 a thread;
//   setmaxnreg gives them 232 registers and the producer 40), each step's
//   products issued before the last step's are waited for;
// * the epilogue goes through shared memory: a warpgroup's 64 x 256 sums,
//   rounded, in passes of 256 bytes a row (XOR-swizzled, conflict-free),
//   then written as coalesced 16-byte stores (a warp writes two whole
//   256-byte row pieces); rows and columns past O and K are not stored.
// The tensor maps are encoded on the host per launch (the driver's
// encoder, fetched once through cudaGetDriverEntryPoint, so the library
// needs no -lcuda) and passed as __grid_constant__ parameters.
//
// TMA needs 16-byte row strides and bases: where O or K is not a multiple
// of 8 or a base is not 16-byte aligned, `dw_kernel` (mma.sync m16n8k16 on
// ldmatrix.trans fragments, 128 x 128 tiles, scalar loads staged in
// shared memory, two stages) computes the same sums. The wrapper picks the
// variant by shape (ops/kernels/dw_matmul.py `dw_variant`).
//
// Returns cudaGetLastError() after the launch; 0 means launched.

#include <cuda.h>

#include "qtile.cuh"

namespace {

// ---------------------------------------------------------------- TMA + wgmma

constexpr int kBO = 128;      // dW rows (columns of g) a tile: two warpgroups of 64
constexpr int kBK = 256;      // dW columns (columns of x) a tile
constexpr int kStep = 64;     // rows of g and x a stage
constexpr int kStages = 4;
constexpr int kGroupO = 8;    // o-blocks side by side in the tile order
constexpr int kThreads = 384;  // warpgroups 0, 1: MMA; 2: the producer
constexpr int kAtom = kStep * 128;  // one 64-column swizzle atom of a stage: 8 KB
constexpr int kABytes = kBO / 64 * kAtom;  // g's slab: 16 KB
constexpr int kBBytes = kBK / 64 * kAtom;  // x's slab: 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kEpiBytes = 64 * 256;  // a warpgroup's epilogue pass: 64 rows of 256 bytes
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kEpiBytes + 2 * kStages * 8 + 1024;
static_assert(kSmemBytes <= qtile::kSmemLimit, "the ring, the epilogue buffers and the barriers fit");

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// until the barrier's phase is no longer `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// a 64 x 64 box at (column c0, row r0) of a 2-D map into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(r0)
      : "memory");
}

// tile t's first dW row and column: groups of kGroupO o-blocks, the
// o-block fastest within a group (ops/kernels/dw_matmul.py `dw_tile`)
__device__ __forceinline__ int2 tile_origin(int t, int no, int nk) {
  const int group = t / (kGroupO * nk);
  const int o_first = group * kGroupO;
  const int go = min(kGroupO, no - o_first);
  const int r = t - group * kGroupO * nk;
  return make_int2((o_first + r % go) * kBO, (r / go) * kBK);
}

// One pass of the epilogue: sums of accumulator column groups [kJ p, kJ p +
// kJ) (256 bytes of output a row) of this warpgroup's 64 rows into `buf`,
// then 16-byte stores to dw.
template <typename OutT>
__device__ __forceinline__ void store_pass(const float (&acc)[128], int pass, unsigned char* buf, OutT* dw,
                                           int o_base, int k0, int O, int K, int wtid, int bar) {
  constexpr int kCols = 256 / static_cast<int>(sizeof(OutT));  // output columns a pass
  constexpr int kJ = kCols / 8;                                // accumulator column groups a pass
  const int warp = wtid >> 5;
  const int lane = wtid & 31;
  qtile::bar_sync(bar, 128);  // the previous pass's reads of buf are done
#pragma unroll
  for (int jj = 0; jj < kJ; ++jj) {
    const int j = pass * kJ + jj;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + (lane >> 2) + 8 * h;
      const float a = acc[4 * j + 2 * h], b = acc[4 * j + 2 * h + 1];
      if constexpr (sizeof(OutT) == 2) {  // 8 columns are one 16-byte chunk
        *reinterpret_cast<__nv_bfloat162*>(buf + r * 256 + ((jj ^ (r & 7)) << 4) + (lane & 3) * 4) =
            __floats2bfloat162_rn(a, b);
      } else {  // 8 columns are two chunks
        const int ch = 2 * jj + ((lane & 3) >> 1);
        *reinterpret_cast<float2*>(buf + r * 256 + ((ch ^ (r & 7)) << 4) + (lane & 1) * 8) = make_float2(a, b);
      }
    }
  }
  qtile::bar_sync(bar, 128);
#pragma unroll
  for (int v = 0; v < 8; ++v) {  // 64 rows x 16 chunks; a warp writes two rows
    const int i = wtid + 128 * v;
    const int r = i >> 4;
    const int ch = i & 15;
    const int o = o_base + r;
    const int k = k0 + pass * kCols + ch * (16 / static_cast<int>(sizeof(OutT)));
    const uint4 val = *reinterpret_cast<const uint4*>(buf + r * 256 + ((ch ^ (r & 7)) << 4));
    if (o < O && k < K) *reinterpret_cast<uint4*>(dw + static_cast<size_t>(o) * K + k) = val;
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
    dw_tma_kernel(const __grid_constant__ CUtensorMap gmap, const __grid_constant__ CUtensorMap xmap,
                  OutT* __restrict__ dw, int M, int O, int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  unsigned char* epi = ring + kStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + 2 * kEpiBytes);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);                 // the producer's arrival, plus the stage's bytes
      mbar_init(&empty[s], kThreads - 128);  // every MMA thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int no = (O + kBO - 1) / kBO;
  const int nk = (K + kBK - 1) / kBK;
  const int tiles = no * nk;
  const int steps = (M + kStep - 1) / kStep;

  if (threadIdx.x >= kThreads - 128) {  // the producer warpgroup: one thread issues
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kThreads - 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int2 og = tile_origin(t, no, nk);
        for (int s = 0; s < steps; ++s) {
          mbar_wait(&empty[stage], phase ^ 1);  // the MMA warps are done with this slot
          mbar_expect_tx(&full[stage], kStageBytes);
          unsigned char* a = ring + stage * kStageBytes;
#pragma unroll
          for (int i = 0; i < kBO / 64; ++i) tma_load(a + i * kAtom, &gmap, &full[stage], og.x + 64 * i, s * kStep);
#pragma unroll
          for (int i = 0; i < kBK / 64; ++i)
            tma_load(a + kABytes + i * kAtom, &xmap, &full[stage], og.y + 64 * i, s * kStep);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = threadIdx.x >> 7;
  const int wtid = threadIdx.x & 127;
  unsigned char* buf = epi + wg * kEpiBytes;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int2 og = tile_origin(t, no, nk);
    float acc[128];
#pragma unroll
    for (int e = 0; e < 128; ++e) acc[e] = 0.0f;
    int prev = 0;
    for (int s = 0; s < steps; ++s) {
      mbar_wait(&full[stage], phase);
      const unsigned char* a = ring + stage * kStageBytes + wg * kAtom;  // this warpgroup's 64 o columns
      const unsigned char* b = ring + stage * kStageBytes + kABytes;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kStep; kk += 16)  // rows kk .. kk + 15 of both slabs: 128 bytes a row
        qtile::wgmma_m64n256k16<true, true>(acc, qtile::gmma_desc(a + kk * 128, kAtom / 16),
                                            qtile::gmma_desc(b + kk * 128, kAtom / 16));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (s > 0) {
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // step s - 1's are done
        mbar_arrive(&empty[prev]);
      }
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    mbar_arrive(&empty[prev]);
#pragma unroll
    for (int pass = 0; pass < static_cast<int>(sizeof(OutT)); ++pass)  // 256 k columns: 2 passes bf16, 4 f32
      store_pass<OutT>(acc, pass, buf, dw, og.x + 64 * wg, og.y, O, K, wtid, 1 + wg);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// rows x cols bf16, row-major, read in 64 x 64 boxes in the 128-byte swizzle
bool encode(CUtensorMap* map, const void* base, int rows, int cols) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename OutT>
int launch_tma(const bf16* g, const bf16* x, OutT* dw, int M, int O, int K, int sms, cudaStream_t stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(dw_tma_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap gmap, xmap;
  if (!encode(&gmap, g, M, O) || !encode(&xmap, x, M, K)) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = ((O + kBO - 1) / kBO) * ((K + kBK - 1) / kBK);
  dw_tma_kernel<OutT><<<min(tiles, sms), kThreads, kSmemBytes, stream>>>(gmap, xmap, dw, M, O, K);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- mma.sync, any shape

constexpr int kSBO = 128;      // dW rows (columns of g) per block
constexpr int kSBK = 128;      // dW columns (columns of x) per block
constexpr int kSBM = 32;       // rows of g and x per step of the M walk
constexpr int kLd = 128 + 8;   // bf16 row stride of both tiles (272 B)
constexpr int kSThreads = 256;

__device__ __forceinline__ void store2(bf16* p, float a, float b, bool second) {
  p[0] = __float2bfloat16(a);
  if (second) p[1] = __float2bfloat16(b);
}

__device__ __forceinline__ void store2(float* p, float a, float b, bool second) {
  p[0] = a;
  if (second) p[1] = b;
}

// One step's tiles: rows m0 .. m0 + 31 of g (columns o0 ..) and of x
// (columns k0 ..), element by element, zeros past M, O and K.
__device__ __forceinline__ void load_tiles(bf16 (*gs)[kLd], bf16 (*xs)[kLd], const bf16* __restrict__ g,
                                           const bf16* __restrict__ x, int m0, int o0, int k0, int M, int O,
                                           int K, int tid) {
  const bf16 zero = __float2bfloat16(0.0f);
  for (int e = tid; e < kSBM * kSBO; e += kSThreads) {
    const int r = e / kSBO;
    const int c = e % kSBO;
    const int m = m0 + r;
    gs[r][c] = (m < M && o0 + c < O) ? g[static_cast<size_t>(m) * O + o0 + c] : zero;
    xs[r][c] = (m < M && k0 + c < K) ? x[static_cast<size_t>(m) * K + k0 + c] : zero;
  }
}

// One block owns a 128 x 128 tile of dW and walks all of M in steps of 32
// rows, two stages; eight warps as 2 (o) x 4 (k), each 64 x 32 of the tile,
// ldmatrix.trans turning the row-major tiles into g^T's A and x's B
// fragments of mma.sync m16n8k16.
template <typename OutT>
__global__ void __launch_bounds__(kSThreads)
    dw_kernel(const bf16* __restrict__ g, const bf16* __restrict__ x, OutT* __restrict__ dw, int M, int O, int K) {
  __shared__ __align__(128) bf16 gs[2][kSBM][kLd];  // [stage][row m][column o of the tile]
  __shared__ __align__(128) bf16 xs[2][kSBM][kLd];  // [stage][row m][column k of the tile]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wo = warp >> 2;  // 64 dW rows
  const int wk = warp & 3;   // 32 dW columns
  const int o0 = blockIdx.y * kSBO;
  const int k0 = blockIdx.x * kSBK;
  const int steps = (M + kSBM - 1) / kSBM;

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

  load_tiles(gs[0], xs[0], g, x, 0, o0, k0, M, O, K, tid);
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    if (s + 1 < steps) load_tiles(gs[cur ^ 1], xs[cur ^ 1], g, x, (s + 1) * kSBM, o0, k0, M, O, K, tid);
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kSBM; kk += 16) {
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
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + wk * 32 + j * 8 + tig * 2;
      if (k >= K) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = o0 + wo * 64 + i * 16 + gid + h * 8;
        if (o < O) store2(dw + static_cast<size_t>(o) * K + k, acc[i][j][2 * h], acc[i][j][2 * h + 1], k + 1 < K);
      }
    }
  }
}

template <typename OutT>
int launch_any(const bf16* g, const bf16* x, OutT* dw, int M, int O, int K, cudaStream_t stream) {
  const dim3 grid((K + kSBK - 1) / kSBK, (O + kSBO - 1) / kSBO);
  dw_kernel<OutT><<<grid, kSThreads, 0, stream>>>(g, x, dw, M, O, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g [M, O] bf16, x [M, K] bf16, dw [O, K] bf16 (out_f32 == 0) or f32.
// tma != 0 (the wgmma kernel) only where O % 8 == 0, K % 8 == 0 and both
// bases are 16-byte aligned; sms: the card's SMs (the persistent grid's
// size). M >= 1.
extern "C" int dw_matmul(const void* g, const void* x, void* dw, int M, int O, int K, int out_f32, int tma,
                         int sms, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto gp = static_cast<const bf16*>(g);
  const auto xp = static_cast<const bf16*>(x);
  if (tma) {
    if (O % 8 || K % 8 || reinterpret_cast<uintptr_t>(g) % 16 || reinterpret_cast<uintptr_t>(x) % 16 || sms < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    return out_f32 ? launch_tma(gp, xp, static_cast<float*>(dw), M, O, K, sms, s)
                   : launch_tma(gp, xp, static_cast<bf16*>(dw), M, O, K, sms, s);
  }
  return out_f32 ? launch_any(gp, xp, static_cast<float*>(dw), M, O, K, s)
                 : launch_any(gp, xp, static_cast<bf16*>(dw), M, O, K, s);
}
