// One-token decode attention over a paged KV pool, for Hopper: bf16 pages
// or float8_e5m2 pages with f32 per-(slot, head) scales, f32 math.
//
// Replaces the Pallas kernel bigdl_tpu/ops/pallas/paged_attention.py
// `_kernel` (wrapped by `paged_decode_attention`). Same contract: q
// [B, Hq, D] (already multiplied by the score scale, in f32), the WHOLE
// pool k/v [L, NP, page, Hkv, D] with the layer index as an argument,
// block_tables [B, mp] int32 mapping row b's logical page i to a physical
// page; slot j of row b is valid iff
//     start[b] <= j <= pos[b]   and   j > pos[b] - window (if window > 0),
// scores are q . k, optionally tanh(s / softcap) * softcap; the softmax is
// online in f32 with -1e30 for masked slots and an exp-weight of exactly 0
// there, and a row with no valid slot writes 0. out [B, Hq, D] bf16.
//
// What bounds it: bytes. A decode step reads every live KV slot of every
// row once (8 rows of ~1,100 llama3-8b slots are ~36 MB a layer) and does
// ~4 * D flops per (query head, slot) pair, far below the card's
// operations-per-byte balance. The design reads pages where they lie —
// the pool is never sliced per layer or gathered into a dense copy, which
// is what the XLA fallback does (three times the traffic). One block per
// (kv head, row) serves the GQA group's query heads from one read of each
// page: warp g owns query head g. It walks the row's live slots only,
// [max(start, pos - window + 1), pos], in tiles of 32 logical slots, each
// slot fetched through the block table; fully masked tiles are skipped,
// which is exact because they would add weight 0. A tile is decoded to f32
// while it is staged in shared memory (fp8: the shared e5m2 decode times
// the slot's scale, qdecode.cuh) with a row stride of D + 1 words, so the
// lane-per-slot score reads and the lane-per-dimension value reads are
// both free of bank conflicts. All offsets into the pool are 64-bit: L *
// NP * page * Hkv * D passes 2^31 at larger pools.
//
// Returns cudaGetLastError() after the launch; 0 means launched.

#include "qdecode.cuh"

namespace {

constexpr int kTile = 32;  // logical slots per staged tile
constexpr float kNegInf = -1e30f;

template <int D, bool kFp8>
__global__ void __launch_bounds__(512)
    paged_kernel(const float* __restrict__ q, const void* __restrict__ kpool, const void* __restrict__ vpool,
                 const float* __restrict__ kscale, const float* __restrict__ vscale, const int* __restrict__ bt,
                 const int* __restrict__ pos, const int* __restrict__ start, bf16* __restrict__ out, int NP,
                 int page, int Hkv, int G, int mp, int layer, int window, float softcap) {
  constexpr int kLd = D + 1;  // f32 row stride of a staged tile
  constexpr int kElems = kFp8 ? 16 : 8;  // elements per 16-byte chunk
  constexpr int kChunks = D / kElems;    // chunks per slot row
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [G][D]
  float* ks = qs + G * D;           // [kTile][kLd]
  float* vs = ks + kTile * kLd;     // [kTile][kLd]

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int Hq = Hkv * G;
  const int tid = threadIdx.x;
  const int g = tid >> 5;
  const int lane = tid & 31;

  const float* qrow = q + (static_cast<size_t>(b) * Hq + static_cast<size_t>(hk) * G) * D;
  for (int i = tid; i < G * D; i += blockDim.x) qs[i] = qrow[i];

  // the row's live slots: [lo, hi]; slots past the block table do not exist
  const int p = pos[b];
  const int hi = min(p, mp * page - 1);
  int lo = max(start[b], 0);
  if (window > 0) lo = max(lo, p - window + 1);
  const int* btrow = bt + static_cast<size_t>(b) * mp;
  const size_t layer_base = static_cast<size_t>(layer) * NP;

  float m = kNegInf, l = 0.0f, acc[D / 32];
#pragma unroll
  for (int i = 0; i < D / 32; ++i) acc[i] = 0.0f;

  for (int j0 = lo / kTile * kTile; j0 <= hi; j0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int i = tid; i < kTile * kChunks; i += blockDim.x) {
      const int r = i / kChunks;
      const int c = i % kChunks;
      const int j = j0 + r;
      float kf[kElems], vf[kElems];
      if (j >= lo && j <= hi) {
        const int phys = min(max(btrow[j / page], 0), NP - 1);
        const size_t slot = ((layer_base + phys) * page + j % page) * Hkv + hk;
        const size_t off = slot * D + static_cast<size_t>(c) * kElems;
        if constexpr (kFp8) {
          const uint4 kw = *reinterpret_cast<const uint4*>(static_cast<const uint8_t*>(kpool) + off);
          const uint4 vw = *reinterpret_cast<const uint4*>(static_cast<const uint8_t*>(vpool) + off);
          const float sk = kscale[slot], sv = vscale[slot];
          const uint32_t kws[4] = {kw.x, kw.y, kw.z, kw.w}, vws[4] = {vw.x, vw.y, vw.z, vw.w};
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            kf[e] = e5m2_to_float(kws[e >> 2] >> (8 * (e & 3))) * sk;
            vf[e] = e5m2_to_float(vws[e >> 2] >> (8 * (e & 3))) * sv;
          }
        } else {
          const uint4 kw = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(kpool) + off);
          const uint4 vw = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(vpool) + off);
          const uint32_t kws[4] = {kw.x, kw.y, kw.z, kw.w}, vws[4] = {vw.x, vw.y, vw.z, vw.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 k2 = bf16x2_to_float2(kws[e]), v2 = bf16x2_to_float2(vws[e]);
            kf[2 * e] = k2.x;
            kf[2 * e + 1] = k2.y;
            vf[2 * e] = v2.x;
            vf[2 * e + 1] = v2.y;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < kElems; ++e) kf[e] = vf[e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        ks[r * kLd + c * kElems + e] = kf[e];
        vs[r * kLd + c * kElems + e] = vf[e];
      }
    }
    __syncthreads();

    // scores: warp g = query head g of the group, lane = slot j0 + lane
    const float* qg = qs + g * D;
    const float* kr = ks + lane * kLd;
    float s = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) s = fmaf(qg[d], kr[d], s);
    if (softcap > 0.0f) s = tanhf(s / softcap) * softcap;
    const int j = j0 + lane;
    const bool valid = j >= lo && j <= hi;
    const float sc = valid ? s : kNegInf;
    const float m_new = fmaxf(m, warp_max(sc));
    const float alpha = expf(m - m_new);
    const float pj = valid ? expf(sc - m_new) : 0.0f;
    l = alpha * l + warp_sum(pj);
    m = m_new;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) acc[i] *= alpha;

    // P . V: lane owns output dims lane + 32 i
#pragma unroll 4
    for (int jj = 0; jj < kTile; ++jj) {
      const float pw = __shfl_sync(0xffffffffu, pj, jj);
      const float* vr = vs + jj * kLd + lane;
#pragma unroll
      for (int i = 0; i < D / 32; ++i) acc[i] = fmaf(pw, vr[32 * i], acc[i]);
    }
  }

  const float inv = 1.0f / (l == 0.0f ? 1.0f : l);
  bf16* orow = out + (static_cast<size_t>(b) * Hq + static_cast<size_t>(hk) * G + g) * D;
#pragma unroll
  for (int i = 0; i < D / 32; ++i) orow[lane + 32 * i] = __float2bfloat16(acc[i] * inv);
}

template <int D, bool kFp8>
int launch(const float* q, const void* k, const void* v, const float* ks, const float* vs, const int* bt,
           const int* pos, const int* start, bf16* out, int B, int Hq, int Hkv, int NP, int page, int mp,
           int layer, int window, float softcap, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int smem = (G * D + 2 * kTile * (D + 1)) * static_cast<int>(sizeof(float));
  cudaFuncSetAttribute(paged_kernel<D, kFp8>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid(Hkv, B);
  paged_kernel<D, kFp8><<<grid, 32 * G, smem, stream>>>(q, k, v, ks, vs, bt, pos, start, out, NP, page, Hkv, G,
                                                        mp, layer, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <bool kFp8>
int dispatch(const void* q, const void* k, const void* v, const void* ks, const void* vs, const void* bt,
             const void* pos, const void* start, void* out, int B, int Hq, int Hkv, int D, int NP, int page,
             int mp, int layer, int window, float softcap, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > 16) return static_cast<int>(cudaErrorInvalidValue);
  const float* qp = static_cast<const float*>(q);
  const float* ksp = static_cast<const float*>(ks);
  const float* vsp = static_cast<const float*>(vs);
  const int* btp = static_cast<const int*>(bt);
  const int* pp = static_cast<const int*>(pos);
  const int* sp = static_cast<const int*>(start);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64, kFp8>(qp, k, v, ksp, vsp, btp, pp, sp, op, B, Hq, Hkv, NP, page, mp, layer, window,
                              softcap, st);
    case 128:
      return launch<128, kFp8>(qp, k, v, ksp, vsp, btp, pp, sp, op, B, Hq, Hkv, NP, page, mp, layer, window,
                               softcap, st);
    case 256:
      return launch<256, kFp8>(qp, k, v, ksp, vsp, btp, pp, sp, op, B, Hq, Hkv, NP, page, mp, layer, window,
                               softcap, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// window <= 0: no sliding window; softcap <= 0: no softcap.
extern "C" int paged_attention_bf16(const void* q, const void* k, const void* v, const void* bt, const void* pos,
                                    const void* start, void* out, int B, int Hq, int Hkv, int D, int NP, int page,
                                    int mp, int layer, int window, float softcap, void* stream) {
  return dispatch<false>(q, k, v, nullptr, nullptr, bt, pos, start, out, B, Hq, Hkv, D, NP, page, mp, layer,
                         window, softcap, stream);
}

extern "C" int paged_attention_fp8(const void* q, const void* k, const void* v, const void* k_scale,
                                   const void* v_scale, const void* bt, const void* pos, const void* start,
                                   void* out, int B, int Hq, int Hkv, int D, int NP, int page, int mp, int layer,
                                   int window, float softcap, void* stream) {
  return dispatch<true>(q, k, v, k_scale, v_scale, bt, pos, start, out, B, Hq, Hkv, D, NP, page, mp, layer,
                        window, softcap, stream);
}
