// One-token decode attention over a paged KV pool, for Hopper: bf16 pages
// or float8_e5m2 pages with f32 per-(slot, head) scales, f32 math.
//
// Replaces the Pallas kernel bigdl_tpu/ops/pallas/paged_attention.py
// `_kernel` (wrapped by `paged_decode_attention`). Same contract: q
// [B, Hq, D] (bf16 or f32, times the score scale in f32 as the block
// loads it), the WHOLE
// pool k/v [L, NP, page, Hkv, D] with the layer index as an argument,
// block_tables [B, mp] int32 mapping row b's logical page i to a physical
// page; slot j of row b is valid iff
//     start[b] <= j <= pos[b]   and   j > pos[b] - window (if window > 0),
// scores are q . k, optionally tanh(s / softcap) * softcap; the softmax is
// online in f32 with -1e30 for masked slots and an exp-weight of exactly 0
// there, and a row with no valid slot writes 0. out [B, Hq, D] bf16.
//
// What bounds it: bytes. A decode step reads every live KV slot of every
// row once (8 rows of ~1,160 llama3-8b slots are ~38 MB a layer) and does
// ~4 * D flops per (query head, slot) pair, ~2 flops a byte at G = 4: far
// below the card's operations-per-byte balance. So the design is about
// keeping enough bytes in flight on every SM (flash-decoding):
//
// * Split over slots. Each row's live range [lo, hi] is cut into chunks of
//   `chunk` slots aligned to multiples of `chunk` (ops/kernels/
//   paged_attention.py `split_plan` mirrors the cut, `split_chunk` picks the
//   size), and each (chunk, kv head, row) is a block: ~320 blocks at the
//   engine's decode shape, where one block per (kv head, row) gave 64. A
//   window skips whole chunks exactly; blocks past a row's last chunk
//   return at once.
// * Stream the pages. A block walks its chunk in tiles of 32 slots through
//   a 4-stage cp.async ring (three tiles in flight while one is used),
//   each slot found through the block table (the chunk's entries are
//   staged in shared memory first). K and V stay in their stored type in
//   shared memory (bf16, or the raw e5m2 codes) and are decoded in
//   registers; rows are XOR-swizzled in 16-byte chunks so the lane-per-slot
//   score reads and the lane-per-dimension value reads are both free of
//   bank conflicts. Slots outside the chunk's live range load as zeros.
// * Warp w serves query heads w, w + 4, ... of the GQA group from the same
//   staged tile; lane = slot for the scores (an e5m2 slot's K scale
//   multiplies its score, its V scale its weight), lane = dimension pair
//   for P . V. Scores stay on the CUDA cores in f32.
// * Combine. A row with one chunk writes its output directly. Otherwise
//   each block writes its partial (m, l, unnormalised o) per head in f32 to
//   scratch, and the last block of the (row, kv head) to arrive (a ticket
//   counter, reset by that block for the next launch) merges the partials
//   in chunk order, so the result is the same from run to run. The
//   wrapper allocates scratch and counters; the kernel allocates nothing.
//
// Head dims 64, 80 (phi-2, phixtral), 96 (phi3-mini), 128 and 256: a lane
// holds dimension pairs 64 i + 2 lane (at D = 80 and 96 the second pair
// on lanes 0 .. 7 and 0 .. 15 only), and the 160- and 80-byte slot rows of
// D = 80 and the 192- and 96-byte ones of D = 96 take swizzles of their
// own: each keeps a row's chunks a permutation of the row.
//
// All offsets into the pool are 64-bit: L * NP * page * Hkv * D passes
// 2^31 at larger pools.
//
// Returns cudaGetLastError() after the launch; 0 means launched.

#include "qdecode.cuh"

namespace {

constexpr int kTile = 32;      // slots a stage: one a lane in the score phase
constexpr int kStages = 4;     // cp.async ring depth
constexpr int kThreads = 128;  // 4 warps; warp w serves query heads w, w + 4, ...
constexpr float kNegInf = -1e30f;

// The 16-byte chunk slot of chunk c of row r in a staged tile of kNC chunks
// a row: chunk c of rows r .. r + 7 (lane-per-slot reads) lands in 8
// distinct bank quads, and a row's chunks stay a permutation of the row
// (an XOR within aligned groups of 1, 2, 4 or 8 chunks).
template <int kNC>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (kNC % 8 == 0)
    return r * kNC + (c ^ (r & 7));
  else if constexpr (kNC == 10)  // D = 80, bf16: 160-byte rows, chunks 0 .. 7 and 8, 9
    return r * kNC + (c < 8 ? c ^ (r & 7) : c ^ (r & 1));
  else if constexpr (kNC == 5)  // D = 80, e5m2: 80-byte rows, chunks 0 .. 3 and 4
    return r * kNC + (c < 4 ? c ^ ((r >> 1) & 3) : c);
  else if constexpr (kNC == 12)
    return r * kNC + (c ^ ((r >> 1) & 3));  // D = 96, bf16: 192-byte rows
  else if constexpr (kNC == 6)
    return r * kNC + (c ^ ((r >> 2) & 1));  // D = 96, e5m2: 96-byte rows
  else
    return r * kNC + (c ^ ((r >> 1) & 3));  // 64-byte rows: two a 128-byte line
}

// two e5m2 codes in the high bytes of two halves -> f32 (exact)
__device__ __forceinline__ float2 e5m2_pair(uint32_t halves) {
  return make_float2(__half2float(__ushort_as_half(static_cast<unsigned short>(halves & 0xffffu))),
                     __half2float(__ushort_as_half(static_cast<unsigned short>(halves >> 16))));
}

template <int D, bool kFp8, int kHPW>
__global__ void __launch_bounds__(kThreads)
    paged_split_kernel(const void* __restrict__ q, int q_f32, float scale, const void* __restrict__ kpool,
                       const void* __restrict__ vpool,
                       const float* __restrict__ kscale, const float* __restrict__ vscale,
                       const int* __restrict__ bt, const int* __restrict__ pos, const int* __restrict__ start,
                       bf16* __restrict__ out, float* __restrict__ part_o, float* __restrict__ part_ml,
                       int* __restrict__ tickets, int NP, int page, int Hkv, int G, int mp, int layer, int window,
                       float softcap, int chunk, int nmax) {
  constexpr int kRowBytes = D * (kFp8 ? 1 : 2);
  constexpr int kNC = kRowBytes / 16;  // 16-byte chunks a slot row
  constexpr int kEPC = kFp8 ? 16 : 8;  // elements a chunk
  constexpr int kTileBytes = kTile * kRowBytes;
  constexpr int kStageBytes = 2 * kTileBytes + (kFp8 ? 2 * kTile * 4 : 0);
  constexpr int kPairs = (D + 63) / 64;  // dimension pairs a lane holds
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;  // [stage][K tile | V tile | K scales | V scales]
  float* qs = reinterpret_cast<float*>(smem + kStages * kStageBytes);  // [G][D]
  int* pages = reinterpret_cast<int*>(qs + G * D);  // the chunk's physical pages
  __shared__ int last;

  const int c = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t head0 = static_cast<size_t>(b) * Hkv * G + static_cast<size_t>(hk) * G;
  // pair i of lane l is dimensions 64 i + 2 l, + 1: at D = 80 and 96 the
  // second pair exists for lanes 0 .. 7 and 0 .. 15 only
  auto has_pair = [&](int i) { return D % 64 == 0 || 64 * i + 2 * lane < D; };

  // the row's live slots [lo, hi] (slots past the block table do not
  // exist) and its chunks: n of them, aligned to multiples of `chunk`
  const int p = pos[b];
  const int hi = min(p, mp * page - 1);
  int lo = max(start[b], 0);
  if (window > 0) lo = max(lo, p - window + 1);
  const int n = lo <= hi ? hi / chunk - lo / chunk + 1 : 0;
  if (n == 0) {  // no valid slot: the row's heads are exactly 0
    if (c == 0)
      for (int i = tid; i < G * D; i += kThreads) out[head0 * D + i] = __float2bfloat16(0.0f);
    return;
  }
  if (c >= n) return;
  const int cbase = (lo / chunk + c) * chunk;
  const int clo = max(lo, cbase);
  const int chi = min(hi, cbase + chunk - 1);
  const int t0 = clo / kTile;
  const int ntiles = chi / kTile - t0 + 1;
  const int pg0 = t0 * kTile / page;

  const int* btrow = bt + static_cast<size_t>(b) * mp;
  for (int i = tid; i <= chi / page - pg0; i += kThreads) pages[i] = min(max(btrow[pg0 + i], 0), NP - 1);
  for (int i = tid; i < G * D; i += kThreads)
    qs[i] = (q_f32 ? static_cast<const float*>(q)[head0 * D + i]
                   : __bfloat162float(static_cast<const bf16*>(q)[head0 * D + i])) * scale;
  __syncthreads();

  const size_t layer_base = static_cast<size_t>(layer) * NP;
  auto slot_of = [&](int j) {
    return ((layer_base + pages[j / page - pg0]) * page + j % page) * Hkv + hk;
  };
  // tile t of the chunk into ring slot t % kStages; one commit group a
  // tile, empty or not, so the waits below count tiles
  auto issue = [&](int t) {
    if (t < ntiles) {
      unsigned char* st = ring + (t % kStages) * kStageBytes;
      const int j0 = (t0 + t) * kTile;
#pragma unroll
      for (int v = 0; v < (kTile * kNC + kThreads - 1) / kThreads; ++v) {  // the same slot's K and V chunk
        const int i = tid + v * kThreads;
        if (kTile * kNC % kThreads != 0 && i >= kTile * kNC) break;
        const int r = i / kNC;
        const int ch = i % kNC;
        const int j = j0 + r;
        const bool ok = j >= clo && j <= chi;
        const size_t off = ok ? slot_of(j) * kRowBytes + ch * 16 : 0;
        cp_async16(st + swz<kNC>(r, ch) * 16, static_cast<const unsigned char*>(kpool) + off, ok ? 16 : 0);
        cp_async16(st + kTileBytes + swz<kNC>(r, ch) * 16, static_cast<const unsigned char*>(vpool) + off,
                   ok ? 16 : 0);
      }
      if constexpr (kFp8) {
        if (tid < 2 * kTile) {
          const int j = j0 + (tid % kTile);
          const bool ok = j >= clo && j <= chi;
          cp_async4(st + 2 * kTileBytes + tid * 4, (tid < kTile ? kscale : vscale) + (ok ? slot_of(j) : 0),
                    ok ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };

  float m[kHPW], l[kHPW], acc[kHPW][kPairs][2];
#pragma unroll
  for (int h = 0; h < kHPW; ++h) {
    m[h] = kNegInf;
    l[h] = 0.0f;
#pragma unroll
    for (int i = 0; i < kPairs; ++i) acc[h][i][0] = acc[h][i][1] = 0.0f;
  }

  for (int t = 0; t < kStages - 1; ++t) issue(t);
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile t have landed
    __syncthreads();               // and every thread's; tile t - 1's slot is free
    issue(t + kStages - 1);
    const unsigned char* kt = ring + (t % kStages) * kStageBytes;
    const unsigned char* vt = kt + kTileBytes;
    const int j = (t0 + t) * kTile + lane;
    const bool valid = j >= clo && j <= chi;

    // scores: lane = slot j, every head of this warp from one read of the row
    float s[kHPW];
#pragma unroll
    for (int h = 0; h < kHPW; ++h) s[h] = 0.0f;
#pragma unroll
    for (int ch = 0; ch < kNC; ++ch) {
      const uint4 w = *reinterpret_cast<const uint4*>(kt + swz<kNC>(lane, ch) * 16);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
      float kf[kEPC];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kFp8) {
          const float2 a = e5m2_pair(__byte_perm(ws[e], 0, 0x1404));
          const float2 c2 = e5m2_pair(__byte_perm(ws[e], 0, 0x3424));
          kf[4 * e] = a.x;
          kf[4 * e + 1] = a.y;
          kf[4 * e + 2] = c2.x;
          kf[4 * e + 3] = c2.y;
        } else {
          const float2 a = bf16x2_to_float2(ws[e]);
          kf[2 * e] = a.x;
          kf[2 * e + 1] = a.y;
        }
      }
#pragma unroll
      for (int h = 0; h < kHPW; ++h) {
        const int g = warp + 4 * h;
        if (g < G) {
          const float4* qg = reinterpret_cast<const float4*>(qs + g * D + ch * kEPC);
#pragma unroll
          for (int e = 0; e < kEPC / 4; ++e) {
            const float4 qv = qg[e];
            s[h] = fmaf(qv.x, kf[4 * e], s[h]);
            s[h] = fmaf(qv.y, kf[4 * e + 1], s[h]);
            s[h] = fmaf(qv.z, kf[4 * e + 2], s[h]);
            s[h] = fmaf(qv.w, kf[4 * e + 3], s[h]);
          }
        }
      }
    }

    // online softmax per head; an e5m2 slot's scales fold into its score
    // and its weight
    float pj[kHPW];
    const float* ksc = reinterpret_cast<const float*>(vt + kTileBytes);
#pragma unroll
    for (int h = 0; h < kHPW; ++h) {
      float sc = s[h];
      if constexpr (kFp8) sc *= ksc[lane];
      if (softcap > 0.0f) sc = tanhf(sc / softcap) * softcap;
      sc = valid ? sc : kNegInf;
      const float m_new = fmaxf(m[h], warp_max(sc));
      const float alpha = expf(m[h] - m_new);
      pj[h] = valid ? expf(sc - m_new) : 0.0f;
      l[h] = alpha * l[h] + warp_sum(pj[h]);
      m[h] = m_new;
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        acc[h][i][0] *= alpha;
        acc[h][i][1] *= alpha;
      }
      if constexpr (kFp8) pj[h] *= ksc[kTile + lane];
    }

    // P . V: lane holds dimensions 64 i + 2 lane and + 1
    if (warp < G) {
#pragma unroll
      for (int jb = 0; jb < kTile; jb += 8) {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int jj = jb + u;
          float pw[kHPW];
#pragma unroll
          for (int h = 0; h < kHPW; ++h) pw[h] = __shfl_sync(0xffffffffu, pj[h], jj);
#pragma unroll
          for (int i = 0; i < kPairs; ++i) {
            if (!has_pair(i)) continue;
            float2 v2;
            if constexpr (kFp8) {
              const int ch = 4 * i + (lane >> 3);
              const uint32_t codes = *reinterpret_cast<const unsigned short*>(vt + swz<kNC>(jj, ch) * 16 +
                                                                              (lane & 7) * 2);
              v2 = e5m2_pair(__byte_perm(codes, 0, 0x1404));
            } else {
              const int ch = 8 * i + (lane >> 2);
              v2 = bf16x2_to_float2(*reinterpret_cast<const uint32_t*>(vt + swz<kNC>(jj, ch) * 16 + (lane & 3) * 4));
            }
#pragma unroll
            for (int h = 0; h < kHPW; ++h) {
              acc[h][i][0] = fmaf(pw[h], v2.x, acc[h][i][0]);
              acc[h][i][1] = fmaf(pw[h], v2.y, acc[h][i][1]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

  // one chunk: the output; else this chunk's partial per head
#pragma unroll
  for (int h = 0; h < kHPW; ++h) {
    const int g = warp + 4 * h;
    if (g >= G) continue;
    if (n == 1) {
      const float inv = 1.0f / (l[h] == 0.0f ? 1.0f : l[h]);
      bf16* orow = out + (head0 + g) * D;
#pragma unroll
      for (int i = 0; i < kPairs; ++i)
        if (has_pair(i))
          *reinterpret_cast<__nv_bfloat162*>(orow + 64 * i + 2 * lane) =
              __floats2bfloat162_rn(acc[h][i][0] * inv, acc[h][i][1] * inv);
    } else {
      const size_t pi = ((static_cast<size_t>(b) * Hkv + hk) * nmax + c) * G + g;
#pragma unroll
      for (int i = 0; i < kPairs; ++i)
        if (has_pair(i))
          *reinterpret_cast<float2*>(part_o + pi * D + 64 * i + 2 * lane) = make_float2(acc[h][i][0], acc[h][i][1]);
      if (lane == 0) {
        part_ml[2 * pi] = m[h];
        part_ml[2 * pi + 1] = l[h];
      }
    }
  }
  if (n == 1) return;

  // the last block of the (row, kv head) merges the partials in chunk order
  __threadfence();
  __syncthreads();
  int* ticket = tickets + static_cast<size_t>(b) * Hkv + hk;
  if (tid == 0) last = atomicAdd(ticket, 1) == n - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int h = 0; h < kHPW; ++h) {
    const int g = warp + 4 * h;
    if (g >= G) continue;
    const size_t p0 = (static_cast<size_t>(b) * Hkv + hk) * nmax * G + g;  // chunk cc at p0 + cc G
    float mx = kNegInf;
    for (int cc = 0; cc < n; ++cc) mx = fmaxf(mx, __ldcg(part_ml + 2 * (p0 + cc * G)));
    float ls = 0.0f, o[kPairs][2];
#pragma unroll
    for (int i = 0; i < kPairs; ++i) o[i][0] = o[i][1] = 0.0f;
    for (int cc = 0; cc < n; ++cc) {
      const size_t pi = p0 + static_cast<size_t>(cc) * G;
      const float w = expf(__ldcg(part_ml + 2 * pi) - mx);
      ls = fmaf(__ldcg(part_ml + 2 * pi + 1), w, ls);
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        if (!has_pair(i)) continue;
        const float2 v = __ldcg(reinterpret_cast<const float2*>(part_o + pi * D + 64 * i + 2 * lane));
        o[i][0] = fmaf(v.x, w, o[i][0]);
        o[i][1] = fmaf(v.y, w, o[i][1]);
      }
    }
    const float inv = 1.0f / (ls == 0.0f ? 1.0f : ls);
    bf16* orow = out + (head0 + g) * D;
#pragma unroll
    for (int i = 0; i < kPairs; ++i)
      if (has_pair(i))
        *reinterpret_cast<__nv_bfloat162*>(orow + 64 * i + 2 * lane) =
            __floats2bfloat162_rn(o[i][0] * inv, o[i][1] * inv);
  }
  if (tid == 0) *ticket = 0;
}

template <int D, bool kFp8, int kHPW>
int launch(const void* q, int q_f32, float scale, const void* k, const void* v, const float* ks, const float* vs, const int* bt,
           const int* pos, const int* start, bf16* out, float* part_o, float* part_ml, int* tickets, int B,
           int Hq, int Hkv, int NP, int page, int mp, int layer, int window, float softcap, int chunk, int nmax,
           cudaStream_t stream) {
  constexpr int kStageBytes = 2 * kTile * D * (kFp8 ? 1 : 2) + (kFp8 ? 2 * kTile * 4 : 0);
  const int G = Hq / Hkv;
  const int npages = (chunk + page - 1) / page + 1;  // pages a chunk's tiles touch, at most
  const int smem = kStages * kStageBytes + G * D * static_cast<int>(sizeof(float)) + npages * 4;
  const cudaError_t err = cudaFuncSetAttribute(paged_split_kernel<D, kFp8, kHPW>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nmax, Hkv, B);
  paged_split_kernel<D, kFp8, kHPW><<<grid, kThreads, smem, stream>>>(q, q_f32, scale, k, v, ks, vs, bt, pos,
                                                                       start, out,
                                                                       part_o, part_ml, tickets, NP, page, Hkv,
                                                                       G, mp, layer, window, softcap, chunk, nmax);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kFp8>
int by_group(const void* q, int q_f32, float scale, const void* k, const void* v, const float* ks, const float* vs, const int* bt,
             const int* pos, const int* start, bf16* out, float* part_o, float* part_ml, int* tickets, int B,
             int Hq, int Hkv, int NP, int page, int mp, int layer, int window, float softcap, int chunk, int nmax,
             cudaStream_t st) {
  const int G = Hq / Hkv;
  if (G <= 4)
    return launch<D, kFp8, 1>(q, q_f32, scale, k, v, ks, vs, bt, pos, start, out, part_o, part_ml, tickets, B, Hq, Hkv, NP,
                              page, mp, layer, window, softcap, chunk, nmax, st);
  if (G <= 8)
    return launch<D, kFp8, 2>(q, q_f32, scale, k, v, ks, vs, bt, pos, start, out, part_o, part_ml, tickets, B, Hq, Hkv, NP,
                              page, mp, layer, window, softcap, chunk, nmax, st);
  return launch<D, kFp8, 4>(q, q_f32, scale, k, v, ks, vs, bt, pos, start, out, part_o, part_ml, tickets, B, Hq, Hkv, NP, page,
                            mp, layer, window, softcap, chunk, nmax, st);
}

template <bool kFp8>
int dispatch(const void* q, int q_f32, float scale, const void* k, const void* v, const void* ks, const void* vs, const void* bt,
             const void* pos, const void* start, void* out, void* part_o, void* part_ml, void* tickets, int B,
             int Hq, int Hkv, int D, int NP, int page, int mp, int layer, int window, float softcap, int chunk,
             int nmax, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > 16 || chunk <= 0 || chunk % kTile != 0 || nmax <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* ksp = static_cast<const float*>(ks);
  const float* vsp = static_cast<const float*>(vs);
  const int* btp = static_cast<const int*>(bt);
  const int* pp = static_cast<const int*>(pos);
  const int* sp = static_cast<const int*>(start);
  bf16* op = static_cast<bf16*>(out);
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  int* tk = static_cast<int*>(tickets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return by_group<64, kFp8>(q, q_f32, scale, k, v, ksp, vsp, btp, pp, sp, op, po, pml, tk, B, Hq, Hkv, NP, page, mp, layer,
                                window, softcap, chunk, nmax, st);
    case 80:
      return by_group<80, kFp8>(q, q_f32, scale, k, v, ksp, vsp, btp, pp, sp, op, po, pml, tk, B, Hq, Hkv, NP, page, mp, layer,
                                window, softcap, chunk, nmax, st);
    case 96:
      return by_group<96, kFp8>(q, q_f32, scale, k, v, ksp, vsp, btp, pp, sp, op, po, pml, tk, B, Hq, Hkv, NP, page, mp, layer,
                                window, softcap, chunk, nmax, st);
    case 128:
      return by_group<128, kFp8>(q, q_f32, scale, k, v, ksp, vsp, btp, pp, sp, op, po, pml, tk, B, Hq, Hkv, NP, page, mp,
                                 layer, window, softcap, chunk, nmax, st);
    case 256:
      return by_group<256, kFp8>(q, q_f32, scale, k, v, ksp, vsp, btp, pp, sp, op, po, pml, tk, B, Hq, Hkv, NP, page, mp,
                                 layer, window, softcap, chunk, nmax, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q bf16 (q_f32 == 0) or f32, multiplied by `scale` in f32 as it loads;
// window <= 0: no sliding window; softcap <= 0: no softcap. part_o [B, Hkv,
// nmax, G, D] and part_ml [B, Hkv, nmax, G, 2] f32 scratch; tickets
// [B * Hkv] int32, zero before the launch and left zero after it. chunk: a
// multiple of 32 slots; nmax: the most chunks a row can have.
extern "C" int paged_attention_bf16(const void* q, const void* k, const void* v, const void* bt, const void* pos,
                                    const void* start, void* out, void* part_o, void* part_ml, void* tickets, int B,
                                    int Hq, int Hkv, int D, int NP, int page, int mp, int layer, int window,
                                    float softcap, int chunk, int nmax, int q_f32, float scale, void* stream) {
  return dispatch<false>(q, q_f32, scale, k, v, nullptr, nullptr, bt, pos, start, out, part_o, part_ml, tickets, B, Hq, Hkv, D,
                         NP, page, mp, layer, window, softcap, chunk, nmax, stream);
}

extern "C" int paged_attention_fp8(const void* q, const void* k, const void* v, const void* k_scale,
                                   const void* v_scale, const void* bt, const void* pos, const void* start,
                                   void* out, void* part_o, void* part_ml, void* tickets, int B, int Hq, int Hkv,
                                   int D, int NP, int page, int mp, int layer, int window, float softcap, int chunk,
                                   int nmax, int q_f32, float scale, void* stream) {
  return dispatch<true>(q, q_f32, scale, k, v, k_scale, v_scale, bt, pos, start, out, part_o, part_ml, tickets, B, Hq, Hkv, D,
                        NP, page, mp, layer, window, softcap, chunk, nmax, stream);
}
