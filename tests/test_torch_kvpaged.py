"""bigdl_tpu_torch's paged KV pool against bigdl_tpu/kvpaged.py (page
accounting, writes and gathers through the block table, bf16 and fp8
pages, the host-RAM swap) and the plain version of the paged-attention
kernel against the JAX Pallas kernel in interpret mode, with the kernel's
split over slots (its plan, and its arithmetic modelled in torch). The
CUDA kernel against its plain version is in test_torch_gpu.py."""

import dataclasses
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import kvpaged as jkp
from bigdl_tpu.ops.pallas.paged_attention import paged_decode_attention
from bigdl_tpu_torch import kvcache, kvpaged
from bigdl_tpu_torch.ops import kernels

# the module, not the `paged_attention` function that kernels/__init__ exports
pa = importlib.import_module("bigdl_tpu_torch.ops.kernels.paged_attention")

# One intra-op thread: the suite runs in parallel worker processes, and a
# torch thread pool per worker oversubscribes the cores (tiny ops then
# run tens of times slower). Process-wide, like the import itself.
torch.set_num_threads(1)

# Both sides do every product and the softmax in f32 and round the output
# to bf16 once; sums run in other orders (pages there, 32-slot tiles
# here), so an output may land one bf16 rounding step away: within 2^-7
# relative, plus a floor far below a ULP.
_ULPS = 2 ** -7


def _bytes(t):
    """A torch tensor's bytes as numpy (fp8 through its uint8 view)."""
    return kvcache.as_bits(t).contiguous().view(torch.uint8).numpy()


def _jbytes(a):
    return np.asarray(a).view(np.uint8)


def test_page_pool_order_and_negative_refcount_match_jax():
    ours, ref = kvpaged.PagePool(9), jkp.PagePool(9)
    got, want = [], []
    for pool, out in ((ours, got), (ref, want)):
        pages = [pool.alloc() for _ in range(5)]
        pool.incref(pages[1])
        for pg in (pages[3], pages[1], pages[0], pages[1]):
            pool.decref(pg)
        out += pages + [pool.alloc() for _ in range(7)]
        out.append(list(pool.free))
        out.append(list(pool.ref))
    assert got == want and 0 not in got[:-2]  # page 0 is never handed out
    assert got[5:12].count(None) == 1  # 6 pages free, 7 asked for
    for cls in (kvpaged.PagePool, jkp.PagePool):
        pool = cls(3)
        pg = pool.alloc()
        pool.decref(pg)
        with pytest.raises(AssertionError, match="negative"):
            pool.decref(pg)


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "fp8"])
def test_update_and_read_through_block_table_byte_equal(quantize):
    rng = np.random.default_rng(1)
    L, NP, P, Hkv, D, B, mp = 2, 10, 4, 2, 16, 3, 3
    bt = np.asarray([[7, 2, 9], [3, 0, 5], [1, 8, 4]], np.int32)
    pos = np.asarray([1, 0, 6], np.int32)
    jc = dataclasses.replace(
        jkp.init_paged(L, NP, P, Hkv, D, B, mp, quantize_kv=quantize),
        block_tables=jnp.asarray(bt), pos=jnp.asarray(pos))
    tc = dataclasses.replace(
        kvpaged.init_paged(L, NP, P, Hkv, D, B, mp, quantize_kv=quantize, device="cpu"),
        block_tables=torch.from_numpy(bt), pos=torch.from_numpy(pos))
    for layer, T in ((1, 5), (0, 1)):
        kn = rng.normal(size=(B, T, Hkv, D)).astype(np.float32) * 3
        vn = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
        jc = jkp.update_layer(jc, jnp.asarray(layer), jnp.asarray(kn, jnp.bfloat16),
                              jnp.asarray(vn, jnp.bfloat16))
        kvpaged.update_layer(tc, layer, torch.from_numpy(kn).bfloat16(),
                             torch.from_numpy(vn).bfloat16())
    assert tc.k.dtype == (torch.float8_e5m2 if quantize else torch.bfloat16)
    np.testing.assert_array_equal(_bytes(tc.k), _jbytes(jc.k))
    np.testing.assert_array_equal(_bytes(tc.v), _jbytes(jc.v))
    if quantize:
        np.testing.assert_array_equal(tc.k_scale.numpy(), np.asarray(jc.k_scale))
        np.testing.assert_array_equal(tc.v_scale.numpy(), np.asarray(jc.v_scale))
    for layer in (0, 1):
        for got, want in zip(kvpaged.read_layer(tc, layer),
                             jkp.read_layer(jc, jnp.asarray(layer))):
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want, np.float32))
    assert kvpaged.kv_page_nbytes(tc) == jkp.kv_page_nbytes(jc)


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "fp8"])
def test_swap_out_and_in_is_byte_preserving(quantize):
    rng = np.random.default_rng(2)
    tc = kvpaged.init_paged(2, 8, 4, 1, 16, 2, 4, quantize_kv=quantize, device="cpu")
    tc = dataclasses.replace(tc, block_tables=torch.tensor([[1, 2, 3, 4], [5, 6, 7, 0]],
                                                           dtype=torch.int32))
    for layer in (0, 1):
        kvpaged.update_layer(tc, layer, torch.from_numpy(rng.normal(size=(2, 13, 1, 16))).bfloat16(),
                             torch.from_numpy(rng.normal(size=(2, 13, 1, 16))).bfloat16())
    before = [_bytes(t).copy() for t in (tc.k, tc.v)]
    blob = kvpaged.swap_out_pages(tc, [2, 5, 3])
    assert blob.n_pages == 3 and blob.k.device.type == "cpu"
    assert blob.nbytes == 3 * kvpaged.kv_page_nbytes(tc)
    kvpaged.swap_in_pages(tc, blob, [6, 1, 7])  # other physical pages
    after = [_bytes(t) for t in (tc.k, tc.v)]
    for b, a in zip(before, after):
        np.testing.assert_array_equal(a[:, [6, 1, 7]], b[:, [2, 5, 3]])
        np.testing.assert_array_equal(a[:, [0, 2, 3, 4, 5]], b[:, [0, 2, 3, 4, 5]])
    if quantize:
        np.testing.assert_array_equal(blob.k_scale.numpy(), tc.k_scale[:, [6, 1, 7]].numpy())


CASES = [
    # L, NP, page, Hkv, G, D, block tables, pos, start, window, softcap
    (2, 12, 8, 2, 3, 64, [[5, 2, 9, 1], [3, 7, 11, 4], [10, 6, 8, 0]],
     [17, 9, 30], [2, 0, 5], None, None),
    # GQA 4:1, a sliding window, softcap; row 1 idle (pos 0 on the scratch
    # page 0); row 2 starts two whole pages in (pages before start unread)
    (3, 16, 16, 2, 4, 128, [[9, 3, 14, 2], [0, 0, 0, 0], [7, 11, 5, 13]],
     [50, 0, 60], [0, 0, 35], 20, 30.0),
]


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "fp8"])
@pytest.mark.parametrize("case", CASES)
def test_paged_plain_matches_pallas_interpret(case, quantize):
    L, NP, P, Hkv, G, D, bt, pos, start, window, softcap = case
    B, Hq = len(bt), Hkv * G
    rng = np.random.default_rng(D + NP)
    k = rng.normal(size=(L, NP, P, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(L, NP, P, Hkv, D)).astype(np.float32)
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    bt, pos, start = (np.asarray(x, np.int32) for x in (bt, pos, start))
    if quantize:  # codes and f32 scales as the pool stores them
        kq, ks = kvcache._quantize_heads(torch.from_numpy(k), torch.float32)
        vq, vs = kvcache._quantize_heads(torch.from_numpy(v), torch.float32)
        jk, jv = (jnp.asarray(_bytes(t)).view(jnp.float8_e5m2) for t in (kq, vq))
        jks, jvs = jnp.asarray(ks.numpy()), jnp.asarray(vs.numpy())
        tk, tv, tks, tvs = kq, vq, ks, vs
    else:
        jk, jv = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
        jks = jvs = None
        tk, tv = torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16()
        tks = tvs = None
    for layer in range(L):
        ref = paged_decode_attention(
            jnp.asarray(q, jnp.bfloat16), jk, jv, jnp.asarray(bt), jnp.asarray(layer),
            jnp.asarray(pos), jnp.asarray(start), k_scale=jks, v_scale=jvs,
            softcap=softcap, window=window, interpret=True)
        ref = np.asarray(ref, np.float32)
        kernels.reset_launches()
        got = kernels.paged_attention(
            torch.from_numpy(q).bfloat16(), tk, tv, torch.from_numpy(bt), layer,
            torch.from_numpy(pos), torch.from_numpy(start), tks, tvs,
            softcap=softcap, window=window)
        assert kernels.PAGED.launches == kernels.PAGED_FP8.launches == 0
        assert got.dtype == torch.bfloat16 and got.shape == (B, Hq, D)
        got = got.float().numpy()
        assert np.all(np.isfinite(got))
        assert np.all(np.abs(got - ref) <= _ULPS * np.abs(ref) + 1e-5), \
            np.abs(got - ref).max()


def test_row_without_valid_slot_is_exactly_zero():
    k = torch.randn(1, 4, 8, 1, 64).bfloat16()
    q = torch.randn(2, 2, 64).bfloat16()
    bt = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    out = kernels.paged_attention(q, k, k, bt, 0, torch.tensor([5, 3], dtype=torch.int32),
                                  torch.tensor([0, 9], dtype=torch.int32))
    assert bool((out[1] == 0).all()) and bool(out[0].abs().sum() > 0)


# The kernel's split over slots (ops/kernels/paged_attention.py): each
# row's live slots cut into chunks, a block each, partials merged in chunk
# order. The plan is plain Python; the arithmetic is modelled below in
# torch and held against the plain version and the Pallas kernel.

PLAN_CASES = [
    # lo, hi, chunk
    (0, 0, 64), (0, 63, 64), (0, 64, 64), (63, 64, 64), (5, 1160, 256),
    (255, 256, 256), (300, 2047, 128), (1, 2046, 64), (700, 700, 256),
]


@pytest.mark.parametrize("lo,hi,chunk", PLAN_CASES)
def test_split_plan_covers_each_live_slot_once_and_nothing_else(lo, hi, chunk):
    plan = pa.split_plan(lo, hi, chunk)
    covered = [j for clo, chi in plan for j in range(clo, chi + 1)]
    assert covered == list(range(lo, hi + 1))  # once each, in order
    for clo, chi in plan:  # inside [lo, hi] and inside one aligned chunk
        assert lo <= clo <= chi <= hi and clo // chunk == chi // chunk
    assert len(plan) == hi // chunk - lo // chunk + 1


@pytest.mark.parametrize("window", [1, 63, 64, 65, 300, 1000])
def test_a_window_skips_whole_chunks(window):
    """Chunks stay aligned to multiples of the chunk, so a window's lower
    edge drops every chunk below it and cuts at most the first kept one;
    the grid's chunk axis (`max_chunks`) covers every row."""
    cap, chunk = 2048, 128
    for pos in (0, 5, 127, 128, 1000, 2047):
        lo, hi = pa.live_range(pos, 0, cap, window)
        plan = pa.split_plan(lo, hi, chunk)
        assert plan[0][0] == max(0, pos - window + 1) and plan[-1][1] == pos
        assert all(clo % chunk == 0 for clo, _ in plan[1:])
        assert len(plan) == pos // chunk - lo // chunk + 1
        assert len(plan) <= pa.max_chunks(cap, chunk, window)


def test_a_row_without_valid_slot_gets_no_chunk():
    for pos, start, window in ((5, 6, None), (0, 1, None), (100, 101, 50)):
        lo, hi = pa.live_range(pos, start, 2048, window)
        assert lo > hi and pa.split_plan(lo, hi, 256) == []


def test_split_gives_two_waves_at_the_engine_decode_shape():
    """chip_smoke phase 8's steady decode: 8 rows of ~1,160 live slots
    (1100 + 13 i tokens after 14 steps), llama3-8b's 8 kv heads, max_len
    2048 in pages of 64: at least two blocks per SM of the H100's 132."""
    B, Hkv, cap = 8, 8, 2048
    chunk = pa.split_chunk(B, Hkv, cap)
    assert chunk % pa.SPLIT_TILE == 0 and chunk % 64 == 0
    pos = [1100 + 13 * i + 14 for i in range(B)]
    blocks = Hkv * sum(len(pa.split_plan(0, p, chunk)) for p in pos)
    assert blocks >= 2 * pa.SMS
    assert pa.max_chunks(cap, chunk) * B * Hkv >= blocks


def _split_combine(q, k_pages, v_pages, bt, layer, pos, start, k_scale, v_scale,
                   softcap, window, chunk, tile=pa.SPLIT_TILE):
    """The kernel's arithmetic in torch: per row the chunks of split_plan;
    per chunk tiles of 32 slots with an online softmax in f32 (an e5m2
    slot's K scale times its score, its V scale times its weight); each
    chunk's (m, l, o) merged in chunk order; one bf16 rounding."""
    B, Hq, D = q.shape
    Hkv = k_pages.shape[3]
    G = Hq // Hkv
    cap = bt.shape[1] * k_pages.shape[2]

    def rows(pool, scale):
        x = kvcache.as_bits(pool[layer])[bt.long()].view(pool.dtype).float()
        x = x.reshape(B, cap, Hkv, D)
        s = (torch.ones(B, cap, Hkv) if scale is None
             else scale[layer][bt.long()].float().reshape(B, cap, Hkv))
        return x, s

    kc, ks = rows(k_pages, k_scale)
    vc, vs = rows(v_pages, v_scale)
    qf = (q.float() / math.sqrt(D)).reshape(B, Hkv, G, D)
    out = torch.zeros(B, Hkv, G, D)
    for b in range(B):
        lo, hi = pa.live_range(int(pos[b]), int(start[b]), cap, window)
        parts = []
        for clo, chi in pa.split_plan(lo, hi, chunk):
            m = torch.full((Hkv, G), -1e30)
            l = torch.zeros(Hkv, G)
            o = torch.zeros(Hkv, G, D)
            for t0 in range(clo // tile * tile, chi + 1, tile):
                j = torch.arange(t0, t0 + tile)
                valid = (j >= clo) & (j <= chi)
                jc = j.clamp(max=cap - 1)
                s = torch.einsum("hgd,jhd->hgj", qf[b], kc[b, jc]) * ks[b, jc].T[:, None]
                if softcap is not None:
                    s = torch.tanh(s / softcap) * softcap
                s = torch.where(valid, s, torch.full_like(s, -1e30))
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.where(valid, torch.exp(s - m_new[..., None]), torch.zeros_like(s))
                l = alpha * l + p.sum(-1)
                o = o * alpha[..., None] + torch.einsum(
                    "hgj,jhd->hgd", p * vs[b, jc].T[:, None], vc[b, jc])
                m = m_new
            parts.append((m, l, o))
        if len(parts) == 1:
            out[b] = parts[0][2] / parts[0][1][..., None]
        elif parts:
            mx = torch.stack([m for m, _, _ in parts]).amax(0)
            ls, os_ = torch.zeros(Hkv, G), torch.zeros(Hkv, G, D)
            for m, l, o in parts:
                w = torch.exp(m - mx)
                ls = ls + l * w
                os_ = os_ + o * w[..., None]
            out[b] = os_ / ls[..., None]
    return out.reshape(B, Hq, D).bfloat16()


SPLIT_CASES = [
    # L, NP, page, Hkv, G, D, block tables, pos, start, window, softcap, chunk
    # chunk edges (every 64 slots) inside pages of 48; a one-slot row
    (1, 14, 48, 2, 2, 64, [[3, 7, 1, 12, 5], [9, 2, 11, 4, 13], [6, 8, 10, 0, 0]],
     [200, 130, 90], [0, 63, 90], None, None, 64),
    # chunk edges on page boundaries (pages of 32, chunks of 64); row 2 has
    # no valid slot (start past pos): exactly 0
    (1, 13, 32, 2, 2, 64, [[3, 7, 1, 12], [9, 2, 11, 4], [6, 8, 10, 5]],
     [127, 64, 40], [0, 63, 41], None, None, 64),
    # a window that skips whole chunks, softcap, GQA 4:1
    (2, 16, 32, 1, 4, 64, [[9, 3, 14, 2, 5, 7, 1, 11], [4, 6, 8, 10, 12, 13, 15, 0]],
     [250, 200], [0, 10], 70, 30.0, 64),
]


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "fp8"])
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_and_combine_match_plain_and_pallas_interpret(case, quantize):
    """The split arithmetic over split_plan equals the plain version and
    the Pallas kernel in interpret mode within the kernel's per-element
    tolerance, and rows without a valid slot are exactly 0 in all three."""
    L, NP, P, Hkv, G, D, bt, pos, start, window, softcap, chunk = case
    B, Hq = len(bt), Hkv * G
    rng = np.random.default_rng(NP + D + P)
    k = rng.normal(size=(L, NP, P, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(L, NP, P, Hkv, D)).astype(np.float32)
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    bt, pos, start = (np.asarray(x, np.int32) for x in (bt, pos, start))
    if quantize:
        kq, ks = kvcache._quantize_heads(torch.from_numpy(k), torch.float32)
        vq, vs = kvcache._quantize_heads(torch.from_numpy(v), torch.float32)
        jk, jv = (jnp.asarray(_bytes(t)).view(jnp.float8_e5m2) for t in (kq, vq))
        jks, jvs = jnp.asarray(ks.numpy()), jnp.asarray(vs.numpy())
        tk, tv, tks, tvs = kq, vq, ks, vs
    else:
        jk, jv = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
        jks = jvs = None
        tk, tv = torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16()
        tks = tvs = None
    tq = torch.from_numpy(q).bfloat16()
    targs = (torch.from_numpy(bt), L - 1, torch.from_numpy(pos), torch.from_numpy(start))
    assert max(len(pa.split_plan(
        *pa.live_range(int(p), int(s), bt.shape[1] * P, window), chunk))
        for p, s in zip(pos, start)) > 1  # the combine runs
    got = _split_combine(tq, tk, tv, *targs, tks, tvs, softcap, window, chunk).float()
    plain = kernels.paged_attention_plain(tq, tk, tv, *targs, tks, tvs, softcap=softcap,
                                          window=window).float()
    ref = torch.from_numpy(np.asarray(paged_decode_attention(
        jnp.asarray(q, jnp.bfloat16), jk, jv, jnp.asarray(bt), jnp.asarray(L - 1),
        jnp.asarray(pos), jnp.asarray(start), k_scale=jks, v_scale=jvs,
        softcap=softcap, window=window, interpret=True), np.float32))
    for other in (plain, ref):
        assert bool(((got - other).abs() <= _ULPS * other.abs() + 1e-5).all()), \
            (got - other).abs().max().item()
    empty = start > pos
    assert empty.any() == (case is SPLIT_CASES[1])
    for t in (got, plain, ref):
        assert bool((t[torch.from_numpy(empty)] == 0).all())
