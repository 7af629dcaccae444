// The decode pipeline shared by the dequant GEMM (qmatmul.cu `gemm_kernel`)
// and the dequant dx (qbackward.cu `dx_kernel`): both multiply a bf16
// operand A (rows of x, or of g) by a weight tile W that arrives packed
// (0.4-1.1 B an element with its scales, qdecode.cuh) and must be decoded
// to bf16 before the tensor cores can read it.
//
// What bounds them: operations at the paths' shapes (M = 1024), but three
// costs of about the same size stand between them and that bound: the
// tensor cores' own rate, the A tiles' traffic from the L2 (bf16, re-read
// for every 128 weight rows), and the decode (4-5 instructions an
// element, once per block and step). The design runs the three at once,
// in separate warps:
//
// * 4 or 8 decoder warps run the memory side. They keep a ring of kStages
//   (3-6, as many as 227 KB of shared memory holds) slots, each holding
//   one step's A tile and the step's *packed* weight bytes, filled by
//   cp.async kStages - 2 steps ahead, so one to four steps of loads are in
//   flight while a step is multiplied. A step of packed bytes is decoded
//   once, by these warps, into one of two bf16 W tiles (a ring of 2), one
//   step ahead of the MMA warps (qdecode16_tc: one byte permute, one
//   subtraction, one or two f32 roundings and half a paired bf16 rounding
//   an element). The scale fields of a step (1/16-1/4 of its packed bytes,
//   one or two 16-bit fields a group at scattered offsets) are read into
//   registers one step ahead of their decode.
// * 1 or 2 warpgroups of MMA warps multiply with wgmma (m64n128k16, bf16
//   in, f32 sums in registers), A and W read by the tensor cores straight
//   from shared memory: each warpgroup 64 or 128 rows of A by the 128-wide
//   W tile. They never decode, never wait on global memory and hold no
//   operand fragments, so setmaxnreg (above 256 threads) moves the
//   decoder warps' spare registers to them.
//
// The roles meet at named barriers: FULL[b] (decoders arrive when the W
// tile b and the A slot of a step are ready, the MMA warps sync) and
// EMPTY[b] (the MMA warps arrive when done with them, the decoders sync
// before reusing tile b and that step's A slot). The decoders are at most
// two steps ahead, so a barrier's arrivals never mix two steps. Their
// stores reach wgmma through a proxy fence before the arrival.
//
// A step is kDepth = 128 elements of the contraction (64 for the byte
// formats, whose packed step is as large as its A tile); the weight side of
// a block is 128 columns, its A side 64 or 128 rows (ops/kernels/qtile.py
// chooses), one m64 piece a warpgroup: each weight element is decoded
// M / bm times. The deeper step halves the barrier round trips a 128-row
// block makes (7-10 % of the GEMM's and dx's time on the card).
//
// The sums. The tensor cores add into f32 with the addends aligned to the
// largest and truncated, so a wgmma chain over the whole K walk loses low
// bits in proportion to the running sum (5-20x as many misrounded bf16
// outputs as f32 sums rounded to nearest). So each step's wgmmas sum from
// zero, and the MMA warps add the step to their sums with ordinary f32
// adds (round to nearest): a thread holds 64 sums and 64 partials, which
// a 256-row tile's 128 + 128 would not fit.
#pragma once

#include "qdecode.cuh"

namespace qtile {

constexpr int kSmemLimit = 232448;  // dynamic shared memory of one block (227 KB)
constexpr int kMaxStages = 6;
constexpr int kBarDec = 1, kBarFull = 2, kBarEmpty = 4;  // named barriers (0 is __syncthreads')

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Elements of the contraction a step covers (whole 16-byte pieces of
// every plane at either depth).
template <class F>
constexpr int step_depth() {
  return F::kBits == 8 ? 64 : 128;
}

// Byte offset of the 16-byte chunk c8 of row r in a tile of kRows rows in
// wgmma's 128-byte swizzle: atoms of 64 bf16 columns by kRows rows, 128
// bytes a row, chunk c8 of row r at chunk c8 ^ (r % 8) of its row (the
// tile starts 1024-byte aligned). The 8 rows a quarter-warp's 16-byte
// stores touch at one column fall in 8 distinct bank quads.
template <int kRows>
__device__ __forceinline__ int tile_chunk(int r, int c8) {
  return (c8 >> 3) * (kRows * 128) + r * 128 + (((c8 & 7) ^ (r & 7)) << 4);
}

// The decoded W tile of a step: kRows weight rows by kCols elements in
// the groups' order (group g = jg*S + u at column 16 g), bf16, decoded by
// kDW warps.
template <class F, int kRows, int kCols, int kDW>
struct WTile {
  static constexpr int kRowsN = kRows;
  static constexpr int kColsN = kCols;
  static constexpr int kDecThreads = 32 * kDW;
  static constexpr int kJB = kCols / F::kS;         // j positions of a step
  static constexpr int kUPR = kJB / 16;             // decode units of a row
  static constexpr int kUnits = kRows * kUPR;
  static constexpr int kUPT = kUnits / kDecThreads;  // units of a decoder thread
  static constexpr int kRowBytes = F::kPieces * kJB;  // packed bytes of a row: [piece][kJB]
  static constexpr int kPackedBytes = kRows * kRowBytes;
  static constexpr int kTileElems = kRows * kCols;
  static_assert(kJB % 16 == 0 && kUnits % kDecThreads == 0, "a step is whole units, spread evenly");
  static_assert(kCols % 64 == 0, "whole 128-byte swizzle atoms");
  __device__ static int chunk(int r, int c8) { return tile_chunk<kRows>(r, c8); }
};

// 8 decoder warps from 128 rows of A up (as much MMA work a step as 4 or
// 8 MMA warps do) where a step has units for all of them, else 4: two
// decoder warps a scheduler hide each other's latencies.
template <class F, int kBM, int kRows, int kCols>
using WTileFor = WTile<F, kRows, kCols, (kBM >= 128 && kRows * (kCols / F::kS / 16) % 256 == 0) ? 8 : 4>;

// A block's shared memory: the A ring (kBM rows by a step, swizzled), the
// two decoded W tiles, the packed ring and the codebook, for kMmaWarps MMA
// warps. ops/kernels/qtile.py mirrors these sizes (its tile policy passes
// stages and bytes, which the entry points check).
template <class F, int kBM_, int kMmaWarps_, class W>
struct Layout {
  static constexpr int kBM = kBM_;
  static constexpr int kMmaWarps = kMmaWarps_;
  static constexpr int kThreads = 32 * kMmaWarps + W::kDecThreads;
  // Above 256 threads a block starts with 64 K / kThreads registers a
  // thread (in steps of 8), and setmaxnreg moves them from the decoder
  // warps to the MMA warps (64 sums and 64 chain partials a thread) within
  // that pool: an increase the decreases have not freed would wait forever.
  static constexpr int kEntryRegs = 65536 / kThreads / 8 * 8;
  static constexpr int kPool = kThreads * kEntryRegs;
  // wgmma's MMA warps hold only their sums and partials (128 a thread)
  static constexpr int kRegsMma = kMmaWarps == 8 ? 160 : 232;
  static constexpr int kRegsDec = (kPool - 32 * kMmaWarps * kRegsMma) / W::kDecThreads / 8 * 8;
  // only where the entry count is below the MMA warps' (an increase must
  // increase and a decrease decrease)
  static constexpr bool kSplitRegs = kThreads > 256 && kRegsMma > kEntryRegs;
  static_assert(!kSplitRegs || (kRegsDec >= 64 && kRegsDec <= kEntryRegs &&
                                32 * kMmaWarps * kRegsMma + W::kDecThreads * kRegsDec <= kPool),
                "the block's register pool");
  static constexpr int kDepth = step_depth<F>();
  static constexpr int kAElems = kBM * kDepth;
  static constexpr int kStageBytes = kAElems * 2 + W::kPackedBytes;
  // the swizzled layout's 1024-byte alignment costs up to 1 KB
  static constexpr int kFixedBytes = 2 * W::kTileElems * 2 + 16 * 4 + 1024;
  static constexpr int kFit = (kSmemLimit - kFixedBytes) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kBytes = kStages * kStageBytes + kFixedBytes;
  static constexpr int kOffW = kStages * kAElems * 2;
  static constexpr int kOffP = kOffW + 2 * W::kTileElems * 2;
  static constexpr int kOffLut = kOffP + kStages * W::kPackedBytes;
  static_assert(kStages >= 3, "a ring of at least 3 stages");
  static_assert(kAElems * 2 % 1024 == 0 && W::kTileElems * 2 % 1024 == 0 && W::kPackedBytes % 1024 == 0,
                "1024-byte aligned swizzled tiles");
  __device__ static int a_chunk(int r, int c8) { return tile_chunk<kBM>(r, c8); }
};

template <class L, class W>
struct Smem {
  bf16* a;
  bf16* w;
  uint8_t* p;
  float* lut;
  __device__ explicit Smem(unsigned char* raw) {
    unsigned char* base = raw + ((1024u - (smem_addr(raw) & 1023u)) & 1023u);
    a = reinterpret_cast<bf16*>(base);
    w = reinterpret_cast<bf16*>(base + L::kOffW);
    p = base + L::kOffP;
    lut = reinterpret_cast<float*>(base + L::kOffLut);
  }
  __device__ bf16* a_slot(int s) const { return a + (s % L::kStages) * L::kAElems; }
  __device__ bf16* w_tile(int s) const { return w + (s & 1) * W::kTileElems; }
  __device__ uint8_t* p_slot(int s) const { return p + (s % L::kStages) * W::kPackedBytes; }
};

// cp.async of a step's packed bytes: kRows weight rows from o0, kJB j
// positions from j0 of every plane piece, zeros past O and Q. Chunk c
// lands at byte 16 c: row, piece, j in that order.
template <class F, class W>
__device__ __forceinline__ void load_packed(uint8_t* dst, const QFields& w, int K, int O, int Q, int o0,
                                            int j0, int ptid) {
  constexpr int kPerRow = F::kPieces * W::kUPR;
  const size_t row_bytes = static_cast<size_t>(K) * F::kBits / 8;
#pragma unroll
  for (int i = 0; i < W::kRowsN * kPerRow / W::kDecThreads; ++i) {
    const int c = ptid + i * W::kDecThreads;
    const int r = c / kPerRow;
    const int p = (c % kPerRow) / W::kUPR;
    const int jj = j0 + (c % W::kUPR) * 16;
    const int o = o0 + r;
    const bool ok = o < O && jj < Q;
    const size_t off = ok ? static_cast<size_t>(o) * row_bytes +
                                qpiece_offset<F>(K, p < F::kN0 ? 0 : 1, p < F::kN0 ? p : p - F::kN0, jj)
                          : 0;
    cp_async16(dst + c * 16, w.data + off, ok ? 16 : 0);
  }
}

// A decoder thread's scale fields for a step: its kUPT units, S groups each.
template <class F, class W>
__device__ __forceinline__ void load_scales(QScale<F> (&sc)[W::kUPT][F::kS], const QFields& w, int K, int O,
                                            int Q, int o0, int j0, int ptid) {
#pragma unroll
  for (int t = 0; t < W::kUPT; ++t) {
    const int i = ptid + t * W::kDecThreads;
    const int o = o0 + i / W::kUPR;
    const int jj = j0 + (i % W::kUPR) * 16;
    const bool ok = o < O && jj < Q;
#pragma unroll
    for (int u = 0; u < F::kS; ++u) {
      sc[t][u] = QScale<F>{};
      sc[t][u].load(w, o, K, u * Q + jj, ok);
    }
  }
}

// A decoder thread's units of a step: packed slot -> decoded W tile.
template <class F, class W>
__device__ __forceinline__ void decode_step(const uint8_t* src, bf16* dst, const QScale<F> (&sc)[W::kUPT][F::kS],
                                            const float* lut, int ptid) {
#pragma unroll
  for (int t = 0; t < W::kUPT; ++t) {
    const int i = ptid + t * W::kDecThreads;
    const int r = i / W::kUPR;
    const int jg = i % W::kUPR;
    uint4 pc[F::kPieces];
#pragma unroll
    for (int p = 0; p < F::kPieces; ++p)
      pc[p] = *reinterpret_cast<const uint4*>(src + r * W::kRowBytes + p * W::kJB + jg * 16);
    unsigned char* d = reinterpret_cast<unsigned char*>(dst);
    static_for<0, F::kS>([&](auto uc) {
      constexpr int u = decltype(uc)::value;
      uint32_t v[8];
      qdecode16_tc<F, u>(pc, sc[t][u].a(), sc[t][u].b(), lut, v);
      const int c8 = (jg * F::kS + u) * 2;  // the group's two 16-byte chunks
      *reinterpret_cast<uint4*>(d + W::chunk(r, c8)) = make_uint4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<uint4*>(d + W::chunk(r, c8 + 1)) = make_uint4(v[4], v[5], v[6], v[7]);
    });
  }
}

// The decoder warps' loop (ptid 0 .. kDecThreads - 1) over `steps` steps, the first
// `wsteps` of which decode a weight step. origin(s) gives step s's first
// weight row and j position (int2), load_a(s, slot) issues the cp.async of
// its A tile; a step past wsteps is filled by extra(s, A slot, W tile) with
// plain stores (the LoRA GEMM's adapter columns).
template <class F, class L, class W, class Origin, class LoadA, class Extra>
__device__ __forceinline__ void produce(unsigned char* smem, const QFields& w, int K, int O, int Q, int wsteps,
                                        int steps, int ptid, Origin origin, LoadA load_a, Extra extra) {
  if constexpr (L::kSplitRegs) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(L::kRegsDec));
  const Smem<L, W> sm(smem);
  if constexpr (F::kLut) {
    if (ptid < 16) sm.lut[ptid] = qlut<F>()[ptid];
  }
  auto issue = [&](int t) {
    if (t < wsteps) {
      const int2 og = origin(t);
      load_a(t, sm.a_slot(t));
      load_packed<F, W>(sm.p_slot(t), w, K, O, Q, og.x, og.y, ptid);
    }
    cp_async_commit();  // one group a step, empty or not: the wait below counts steps
  };
  for (int t = 0; t < L::kStages - 2; ++t) issue(t);
  QScale<F> cur[W::kUPT][F::kS], nxt[W::kUPT][F::kS];
  if (wsteps > 0) {
    const int2 og = origin(0);
    load_scales<F, W>(cur, w, K, O, Q, og.x, og.y, ptid);
  }
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < wsteps) {
      const int2 og = origin(s + 1);
      load_scales<F, W>(nxt, w, K, O, Q, og.x, og.y, ptid);
    }
    cp_async_wait<L::kStages - 3>();  // this thread's copies of step s have landed
    bar_sync(kBarDec, W::kDecThreads);  // and every decoder's
    if (s >= 2) bar_sync(kBarEmpty + (s & 1), L::kThreads);  // the MMA warps are done with step s - 2
    issue(s + L::kStages - 2);  // into step s - 2's slot
    if (s < wsteps)
      decode_step<F, W>(sm.p_slot(s), sm.w_tile(s), cur, sm.lut, ptid);
    else
      extra(s, sm.a_slot(s), sm.w_tile(s));
    // wgmma reads shared memory through the async proxy: this thread's
    // stores and landed copies of step s must be visible to it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_arrive(kBarFull + (s & 1), L::kThreads);
#pragma unroll
    for (int t = 0; t < W::kUPT; ++t)
#pragma unroll
      for (int u = 0; u < F::kS; ++u) cur[t][u] = nxt[t][u];
  }
}

// wgmma's shared-memory descriptor of a tile in the 128-byte swizzle
// (tile_chunk): start address; `lbo` bytes / 16 from one 64-column atom
// to the next (read for the MN-major B of dx; unused, 1, for K-major
// tiles); 1024 bytes from one 8-row group to the next; layout type 1.
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo = 1) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(lbo) << 16) |
         (64ull << 32) | (1ull << 62);
}

// d[0..63] = A[64 x 16] . B[16 x 128] (+ d where keep != 0) from shared
// memory: A K-major; B
// K-major ([128 n][16 k], kTransB false) or MN-major ([16 k][128 n]);
// d's layout: register 4 j + 2 h + e is row 16 (warp % 4) + lane / 4 + 8 h,
// column 8 j + 2 (lane % 4) + e of the 64 x 128 piece.
template <bool kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db, int keep) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(keep), "n"(kTransB ? 1 : 0));
}

// d[0..127] += A[64 x 16] . B[16 x 256] from shared memory; kTransA: A
// MN-major (its 64 rows contiguous, [16 k][64 m], as a row-major operand
// read transposed), else K-major; B as in wgmma_m64n128k16. d's layout:
// register 4 j + 2 h + e is row 16 (warp % 4) + lane / 4 + 8 h, column
// 8 j + 2 (lane % 4) + e of the 64 x 256 piece.
template <bool kTransA, bool kTransB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(kTransA ? 1 : 0), "n"(kTransB ? 1 : 0));
}

// The MMA warps' loop on wgmma: a warpgroup's 64 rows of A (from row
// 64 (warp / 4)) against the whole 128-wide W tile: 128 weight rows by a
// step of K (the GEMM), or with kTransB a step of weight rows by 128 dx
// columns (dx, B MN-major). sum in wgmma_m64n128k16's layout. Each step's
// wgmmas start from zero (scale-d 0 on the first), the warps wait for
// them, release the step's tiles to the decoders and add the step to
// sum. The partials are read outside any branch: ptxas serialises every
// wgmma of a kernel that reads its accumulators on a divergent path.
template <class L, class W, bool kTransB>
__device__ __forceinline__ void consume_wgmma(unsigned char* smem, int steps, int warp, float (&sum)[64]) {
  static_assert((kTransB ? W::kColsN : W::kRowsN) == 128, "a 128-wide W tile");
  if constexpr (L::kSplitRegs) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::kRegsMma));
  const Smem<L, W> sm(smem);
  const int row0 = (warp >> 2) * 64;
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
  for (int s = 0; s < steps; ++s) {
    bar_sync(kBarFull + (s & 1), L::kThreads);
    const unsigned char* a = reinterpret_cast<const unsigned char*>(sm.a_slot(s));
    const unsigned char* b = reinterpret_cast<const unsigned char*>(sm.w_tile(s));
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < L::kDepth; kk += 16) {
      // a k16 slice of a K-major tile: atom kk / 64, 2 kk % 64 bytes into
      // each 128-byte row; of the MN-major one: rows kk .. kk + 15, atoms
      // of 64 columns W::kRowsN rows apart
      const uint64_t db = kTransB ? gmma_desc(b + kk * 128, W::kRowsN * 8)
                                  : gmma_desc(b + (kk >> 6) * W::kRowsN * 128 + (kk & 63) * 2);
      wgmma_m64n128k16<kTransB>(acc, gmma_desc(a + (kk >> 6) * L::kBM * 128 + row0 * 128 + (kk & 63) * 2), db,
                                kk == 0 ? 0 : 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if (s + 2 < steps) bar_arrive(kBarEmpty + (s & 1), L::kThreads);  // the decoders wait for it
#pragma unroll
    for (int e = 0; e < 64; ++e) sum[e] = __fadd_rn(sum[e], acc[e]);
  }
}

// Two bf16 outputs from f32 sums; `pair` when both are in range and the
// address is 4-byte aligned, else the first alone.
__device__ __forceinline__ void store_bf16x2(bf16* p, float a, float b, bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16_rn(a);
    if (second) p[1] = __float2bfloat16_rn(b);
  }
}

}  // namespace qtile
