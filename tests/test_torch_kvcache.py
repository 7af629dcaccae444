"""bigdl_tpu_torch's dense KV cache against bigdl_tpu/kvcache.py: the fp8
layout (codes and scales byte-equal), per-row writes with the drop past a
row's end, row insert and the host-RAM row swap; and the plain version of
the flash kernel's fp8 arm against the JAX Pallas kernel in interpret
mode. The CUDA kernel against its plain version is in test_torch_gpu.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import kvcache as jkv
from bigdl_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from bigdl_tpu_torch import kvcache
from bigdl_tpu_torch.ops import kernels
from bigdl_tpu_torch.ops.kernels.flash_attention import valid_mask
# the flash kernels' tile walk, as the dQ emulation walks it
from test_torch_flash_backward import _LOG2E, _TILE, _live_key_tiles, _whole_tile

# One intra-op thread: the suite runs in parallel worker processes, and a
# torch thread pool per worker oversubscribes the cores (tiny ops then
# run tens of times slower). Process-wide, like the import itself.
torch.set_num_threads(1)

# as test_torch_flash.py: f32 math on both sides, one bf16 rounding of
# the output, sums in other orders — one bf16 step, 2^-7 relative
_ULPS = 2 ** -7


def _bytes(t):
    return kvcache.as_bits(t).contiguous().view(torch.uint8).numpy()


def _jbytes(a):
    return np.asarray(a).view(np.uint8)


@pytest.mark.parametrize("scale_dtype", [torch.float16, torch.float32])
def test_quantize_heads_byte_equal_to_jax(scale_dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 7, 4, 64)).astype(np.float32) * np.exp(
        rng.normal(size=(3, 7, 4, 1)) * 3)
    x[0, 2, 1] = 0.0  # an all-zero vector: scale 0, codes 0
    xb = torch.from_numpy(x).bfloat16()
    codes, scale = kvcache._quantize_heads(xb, scale_dtype)
    jdt = {torch.float16: jnp.float16, torch.float32: jnp.float32}[scale_dtype]
    jcodes, jscale = jkv._quantize_heads(jnp.asarray(x, jnp.bfloat16), jdt)
    assert codes.dtype == torch.float8_e5m2 and scale.dtype == scale_dtype
    np.testing.assert_array_equal(_bytes(codes), _jbytes(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    assert float(scale[0, 2, 1]) == 0 and bool((_bytes(codes)[0, 2, 1] == 0).all())


def _caches(quantize, pos, start, L=2, B=3, S=16, Hkv=2, D=64):
    jc = dataclasses.replace(jkv.init_cache(L, B, S, Hkv, D, quantize_kv=quantize),
                             pos=jnp.asarray(pos, jnp.int32),
                             start=jnp.asarray(start, jnp.int32))
    tc = dataclasses.replace(kvcache.init_cache(L, B, S, Hkv, D, quantize_kv=quantize,
                                                device="cpu"),
                             pos=torch.tensor(pos, dtype=torch.int32),
                             start=torch.tensor(start, dtype=torch.int32))
    return jc, tc


def _assert_equal(tc, jc):
    np.testing.assert_array_equal(_bytes(tc.k), _jbytes(jc.k))
    np.testing.assert_array_equal(_bytes(tc.v), _jbytes(jc.v))
    if jc.k_scale is not None:
        np.testing.assert_array_equal(tc.k_scale.numpy(), np.asarray(jc.k_scale))
        np.testing.assert_array_equal(tc.v_scale.numpy(), np.asarray(jc.v_scale))
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    np.testing.assert_array_equal(tc.start.numpy(), np.asarray(jc.start))


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "fp8"])
def test_per_row_writes_drop_past_the_end_like_jax(quantize):
    """Row 2 sits at the last slot and row 1 past the end: a one-token
    write lands for row 2 and is dropped for row 1; a three-token write
    from pos [2, 14, 15] keeps only the slots inside the row."""
    rng = np.random.default_rng(1)
    jc, tc = _caches(quantize, [3, 16, 15], [0, 1, 2])
    for layer, T in ((1, 1), (0, 3)):
        if T == 3:
            jc = dataclasses.replace(jc, pos=jnp.asarray([2, 14, 15], jnp.int32))
            tc = dataclasses.replace(tc, pos=torch.tensor([2, 14, 15], dtype=torch.int32))
        kn = rng.normal(size=(3, T, 2, 64)).astype(np.float32)
        vn = rng.normal(size=(3, T, 2, 64)).astype(np.float32)
        jc = jkv.update_layer(jc, jnp.asarray(layer), jnp.asarray(kn, jnp.bfloat16),
                              jnp.asarray(vn, jnp.bfloat16))
        kvcache.update_layer(tc, layer, torch.from_numpy(kn).bfloat16(),
                             torch.from_numpy(vn).bfloat16())
        _assert_equal(tc, jc)
    # row 1's one-token write (layer 1, pos 16) was dropped
    assert _bytes(tc.k)[0, 1].any() and not _bytes(tc.k)[1, 1].any()
    for layer in (0, 1):
        for got, want in zip(kvcache.read_layer(tc, layer),
                             jkv.read_layer(jc, jnp.asarray(layer))):
            np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    assert kvcache.advance(tc, 1).pos.tolist() == [3, 15, 16]


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "fp8"])
def test_insert_row_and_row_swap_match_jax(quantize):
    rng = np.random.default_rng(2)
    jc, tc = _caches(quantize, [0, 0, 0], [0, 0, 0])
    # a 1-row, 8-slot prefill cache, left-padded by 3
    jp = jkv.init_cache(2, 1, 8, 2, 64, quantize_kv=quantize)
    tp = kvcache.init_cache(2, 1, 8, 2, 64, quantize_kv=quantize, device="cpu")
    for layer in (0, 1):
        kn = rng.normal(size=(1, 8, 2, 64)).astype(np.float32)
        jp = jkv.update_layer(jp, jnp.asarray(layer), jnp.asarray(kn, jnp.bfloat16),
                              jnp.asarray(-kn, jnp.bfloat16))
        kvcache.update_layer(tp, layer, torch.from_numpy(kn).bfloat16(),
                             torch.from_numpy(-kn).bfloat16())
    jc = jkv.insert_row(jc, jp, 1, 3)
    kvcache.insert_row(tc, tp, 1, 3)
    _assert_equal(tc, jc)
    blob = kvcache.swap_out_row(tc, 1, 8)
    jblob = jkv.swap_out_row(jc, 1, 8)
    for got, want in zip(blob, jblob):
        if want is not None:
            np.testing.assert_array_equal(_bytes(got), _jbytes(want))
    # back into another row, with its pos/start
    jc = jkv.swap_in_row(jc, *jblob, 2, jnp.asarray(8), jnp.asarray(3))
    kvcache.swap_in_row(tc, *blob, 2, 8, 3)
    _assert_equal(tc, jc)
    np.testing.assert_array_equal(_bytes(tc.k)[:, 2, :8], _bytes(tc.k)[:, 1, :8])


FP8_CASES = [
    # B, T, S, Hq, Hkv, D, q_offset, start, window, softcap
    (2, 24, 64, 4, 2, 64, 0, (0, 9), None, None),
    (3, 16, 48, 4, 1, 128, 8, (0, 5, 20), None, 20.0),
    (2, 32, 64, 2, 2, 128, 16, (3, 30), 12, None),
]


@pytest.mark.parametrize("case", FP8_CASES)
def test_flash_fp8_plain_matches_pallas_interpret(case):
    B, T, S, Hq, Hkv, D, qoff, start, window, softcap = case
    rng = np.random.default_rng(T + S)
    q = rng.normal(size=(B, T, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32) * 4
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    kq, ks = kvcache._quantize_heads(torch.from_numpy(k))
    vq, vs = kvcache._quantize_heads(torch.from_numpy(v))
    st = np.asarray(start, np.int32)
    ref = jax_flash(jnp.asarray(q, jnp.bfloat16),
                    jnp.asarray(_bytes(kq)).view(jnp.float8_e5m2),
                    jnp.asarray(_bytes(vq)).view(jnp.float8_e5m2),
                    start=jnp.asarray(st), q_offset=jnp.asarray(qoff, jnp.int32),
                    window=window, softcap=softcap, k_scale=jnp.asarray(ks.numpy()),
                    v_scale=jnp.asarray(vs.numpy()), interpret=True)
    ref = np.asarray(ref, np.float32)
    kernels.reset_launches()
    got = kernels.flash_attention(torch.from_numpy(q).bfloat16(), kq, vq,
                                  start=torch.from_numpy(st), q_offset=qoff,
                                  window=window, softcap=softcap,
                                  k_scale=ks, v_scale=vs)
    assert kernels.FLASH_FP8.launches == 0  # the CPU takes the plain version
    got = got.float().numpy()
    assert np.all(np.abs(got - ref) <= _ULPS * np.abs(ref) + 1e-5), np.abs(got - ref).max()
    pad_rows = ~valid_mask(torch.from_numpy(st), qoff, T, S, window).any(-1)
    assert pad_rows.any() and np.all(got[pad_rows.numpy()] == 0)


# csrc/flash_attention.cu's fp8 arm runs bf16 tensor-core products on the
# codes themselves: every finite e5m2 code is a bf16 value, and the per-slot
# scales factor out of both products, S[t, j] = kscale[j] (q_t . code_j) and
# O[t] = sum_j (P[t, j] vscale[j]) vcode_j. kscale multiplies S in f32;
# vscale is folded into P in f32, which then goes in as bf16 hi + lo. The
# emulation below walks the kernel's tiles (64 queries of a block, its live
# 64-slot tiles, masks only on the tiles a mask cuts, the online softmax in
# the log2 domain) with exactly those roundings, and is held to JAX's
# quantized arm (code * scale decoded in f32) as the card holds the kernel
# to its plain version: per element within 2^-7 |ref| + 1e-5.
def _hi_lo(x):
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _fp8_arm_emulated(q, kq, vq, ks, vs, start, q_offset, window, softcap):
    B, T, Hq, D = q.shape
    S, Hkv = kq.shape[1], kq.shape[2]
    G = Hq // Hkv
    scale = 1.0 / np.sqrt(D)
    out = torch.zeros(B, T, Hq, D)
    for b in range(B):
        st = int(start[b])
        # the codes as bf16 (exact), GQA-expanded: [Hq, S, D]; scales [Hq, S]
        kc, vc = (x[b].float().bfloat16().float().repeat_interleave(G, dim=1).transpose(0, 1)
                  for x in (kq, vq))
        ksc, vsc = (x[b].float().repeat_interleave(G, dim=1).T for x in (ks, vs))
        for t0 in range(0, T, _TILE):
            t1 = min(t0 + _TILE, T)
            slots = q_offset + torch.arange(t0, t1)
            qt = q[b, t0:t1].float().transpose(0, 1)  # [Hq, n, D]
            m = torch.full((Hq, t1 - t0, 1), -1e30)
            l = torch.zeros(Hq, t1 - t0, 1)
            o = torch.zeros(Hq, t1 - t0, D)
            for j0 in _live_key_tiles(q_offset + t0, q_offset + t1 - 1, S, st, window):
                j1 = min(j0 + _TILE, S)
                x = (qt @ kc[:, j0:j1].transpose(1, 2)) * ksc[:, None, j0:j1]
                x = (torch.tanh(x * scale / softcap) * softcap * _LOG2E if softcap
                     else x * (scale * _LOG2E))
                if not _whole_tile(t0, q_offset + t0, j0, T, S, st, window):
                    j = torch.arange(j0, j1)[None]
                    ok = (j <= slots[:, None]) & (j >= st)
                    if window:
                        ok &= j > slots[:, None] - window
                    x = torch.where(ok, x, torch.full_like(x, -1e30))
                mn = torch.maximum(m, x.amax(-1, keepdim=True))
                mu = torch.where(mn == -1e30, torch.zeros_like(mn), mn)
                p = torch.exp2(x - mu)
                alpha = torch.exp2(m - mu)
                l = l * alpha + p.sum(-1, keepdim=True)
                hi, lo = _hi_lo(p * vsc[:, None, j0:j1])
                o = o * alpha + hi @ vc[:, j0:j1] + lo @ vc[:, j0:j1]
                m = mn
            out[b, t0:t1] = (o / torch.where(l == 0, torch.ones_like(l), l)).transpose(0, 1)
    return out.bfloat16()


@pytest.mark.parametrize("case", FP8_CASES + [
    # K/V of absmax < 1: every scale (absmax / 57344) is an f16 subnormal
    (2, 80, 128, 4, 2, 64, 24, (0, 40), None, None, 0.2),
    (1, 70, 96, 2, 1, 128, 0, (13,), 40, None, 0.2),
])
def test_flash_fp8_tensor_core_roundings_match_pallas_interpret(case):
    B, T, S, Hq, Hkv, D, qoff, start, window, softcap, *amp = case
    amp = amp[0] if amp else 1.0
    rng = np.random.default_rng(T + S + 1)
    q = rng.normal(size=(B, T, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32) * 4 * amp
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32) * amp
    kq, ks = kvcache._quantize_heads(torch.from_numpy(k))
    vq, vs = kvcache._quantize_heads(torch.from_numpy(v))
    if amp < 1:
        assert bool((ks < 2 ** -14).all() and (vs < 2 ** -14).all())
    st = np.asarray(start, np.int32)
    ref = jax_flash(jnp.asarray(q, jnp.bfloat16),
                    jnp.asarray(_bytes(kq)).view(jnp.float8_e5m2),
                    jnp.asarray(_bytes(vq)).view(jnp.float8_e5m2),
                    start=jnp.asarray(st), q_offset=jnp.asarray(qoff, jnp.int32),
                    window=window, softcap=softcap, k_scale=jnp.asarray(ks.numpy()),
                    v_scale=jnp.asarray(vs.numpy()), interpret=True)
    ref = np.asarray(ref, np.float32)
    got = _fp8_arm_emulated(torch.from_numpy(q).bfloat16(), kq, vq, ks, vs,
                            torch.from_numpy(st), qoff, window, softcap).float().numpy()
    assert np.all(np.abs(got - ref) <= _ULPS * np.abs(ref) + 1e-5), np.abs(got - ref).max()
    pad_rows = ~valid_mask(torch.from_numpy(st), qoff, T, S, window).any(-1).numpy()
    assert np.all(got[pad_rows] == 0) and np.all(ref[pad_rows] == 0)
