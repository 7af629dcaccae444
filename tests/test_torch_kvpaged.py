"""bigdl_tpu_torch's paged KV pool against bigdl_tpu/kvpaged.py (page
accounting, writes and gathers through the block table, bf16 and fp8
pages, the host-RAM swap) and the plain version of the paged-attention
kernel against the JAX Pallas kernel in interpret mode. The CUDA kernel
against its plain version is in test_torch_gpu.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import kvpaged as jkp
from bigdl_tpu.ops.pallas.paged_attention import paged_decode_attention
from bigdl_tpu_torch import kvcache, kvpaged
from bigdl_tpu_torch.ops import kernels

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
