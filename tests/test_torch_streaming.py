"""Attention-sink streaming in the port against the JAX package, on the CPU.

The eviction against JAX's on the same cache (random bf16 keys and
values, chunks of 1 and 3): the sinks and values bit for bit, the re-based
keys within one bf16 rounding (both rotate in float32 and round once; the
f32 cos/sin of the two libraries may differ in the last bit); the shift
against a cache built directly from the kept tokens at re-based positions
(the rotation is exact up to that rounding). Then generation on tiny-llama
(sym_int4, both packages on their dequant paths): far past the window
against JAX's, the logits of every step along JAX's tokens within 4 bf16
ULPs of the largest logit and the tokens by the margin rule; within the
window against the port's plain generate (another cache length and
padding, so logits, not tokens); and the guards of the JAX package's
tests/test_streaming.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import kvcache as jkv
from bigdl_tpu.api import TpuModel
from bigdl_tpu.streaming import make_evict as jax_make_evict
from bigdl_tpu.streaming import make_sink_shift as jax_make_sink_shift
from bigdl_tpu_torch import TorchModel, kvcache
from bigdl_tpu_torch.models import llama
from bigdl_tpu_torch.ops import apply_rotary_emb
from bigdl_tpu_torch.ops.rope import make_inv_freq_scaled, rope_cos_sin
from bigdl_tpu_torch.streaming import (default_chunk, make_evict, make_sink_shift,
                                       validate_streaming)
from bigdl_tpu_torch.utils import cache_len_for
from test_torch_snapkv import JCFG, TCFG, TOL_ULPS, _jfwd, assert_margin_rule, pair, port_cache

torch.set_num_threads(1)


def _random_cache(seed, L=2, B=2, S=16, H=2, D=16, pos=16):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((L, B, S, H, D)).astype(np.float32)
    v = rng.standard_normal((L, B, S, H, D)).astype(np.float32)
    return dataclasses.replace(jkv.init_cache(L, B, S, H, D), k=jnp.asarray(k, jnp.bfloat16),
                               v=jnp.asarray(v, jnp.bfloat16), pos=jnp.asarray(pos, jnp.int32))


@pytest.mark.parametrize("chunk", [1, 3, 12])
def test_evict_matches_jax(chunk):
    cfg = dataclasses.replace(TCFG, head_dim=16)
    jc = _random_cache(chunk)
    want = jax_make_evict(JCFG, 16, 4, chunk)(jc)
    got = make_evict(cfg, 16, 4, chunk)(port_cache(jc))
    assert got.pos == int(want.pos) == 16 - chunk
    wk, wv = np.asarray(want.k, np.float32), np.asarray(want.v, np.float32)
    gk, gv = got.k.float().numpy(), got.v.float().numpy()
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gk[:, :, :4], wk[:, :, :4])
    np.testing.assert_array_equal(gk[:, :, 16 - chunk:], 0)
    np.testing.assert_allclose(gk, wk, rtol=2 ** -8, atol=1e-6)


def test_sink_shift_only_when_full():
    jc = _random_cache(0, pos=11)
    shift = make_sink_shift(dataclasses.replace(TCFG, head_dim=16), 16, 4, 3)
    tc = port_cache(jc)
    assert shift(tc) is tc
    full = port_cache(_random_cache(0))
    assert shift(full).pos == 13
    np.testing.assert_array_equal(
        port_cache(jax_make_sink_shift(JCFG, 16, 4, 3)(jc)).k.float().numpy(),
        port_cache(jc).k.float().numpy())


def test_shift_equals_recompute_oracle():
    """Keys written at positions 0..W-1, shifted, against a cache written
    directly from the kept tokens at positions 0..W-1-chunk."""
    L, H, D, W, sink = 2, 2, 16, 8, 2
    rng = np.random.default_rng(0)
    k_raw = torch.from_numpy(rng.standard_normal((W, 1, 1, H, D)).astype(np.float32))
    inv_freq, _ = make_inv_freq_scaled(D, TCFG.rope_theta, None, seq_len=W)
    cfg = dataclasses.replace(TCFG, head_dim=D)

    def build(token_ids, positions):
        cache = kvcache.init_cache(L, 1, W, H, D, dtype=torch.float32, device="cpu")
        for n, (t, p) in enumerate(zip(token_ids, positions)):
            cos, sin = rope_cos_sin(torch.tensor([[p]]), inv_freq)
            _, k_rot = apply_rotary_emb(k_raw[t], k_raw[t], cos, sin)
            for layer in range(L):
                kvcache.update_layer(dataclasses.replace(cache, pos=n), layer, k_rot, k_raw[t])
        return dataclasses.replace(cache, pos=len(token_ids))

    for chunk in (1, 3):
        a = make_sink_shift(cfg, W, sink, chunk)(build(range(W), range(W)))
        kept = list(range(sink)) + list(range(sink + chunk, W))
        b = build(kept, range(W - chunk))
        S = W - chunk
        assert a.pos == S
        np.testing.assert_allclose(a.k[:, :, :S].numpy(), b.k[:, :, :S].numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(a.v[:, :, :S].numpy(), b.v[:, :, :S].numpy())


def _stream_logits(prompts, out_tokens, window, sink):
    """[B, N, V] logits of every generated position along `out_tokens`
    with the cache a `window`-slot sink ring (None: the plain cache of
    generate), in the port and in JAX."""
    jparams, model = pair("sym_int4")
    N = out_tokens.shape[1]
    tokens = np.asarray(prompts, np.int32)
    B, T = tokens.shape
    S = window or cache_len_for(T, N)
    chunk = default_chunk(window, sink) if window else 0
    jc = jkv.init_cache(2, B, S, JCFG.num_key_value_heads, JCFG.head_dim_)
    tc = kvcache.init_cache(2, B, S, TCFG.num_key_value_heads, TCFG.head_dim_, device="cpu")
    jshift = jax_make_sink_shift(JCFG, window, sink, chunk) if window else None
    tshift = make_sink_shift(TCFG, window, sink, chunk) if window else None
    jl, jc = _jfwd(JCFG, jparams, jnp.asarray(tokens), jc, mode="prefill")
    with torch.inference_mode():
        tl, tc = llama.forward(TCFG, model, torch.from_numpy(tokens).long(), tc)
        js, ts = [np.asarray(jl)[:, -1]], [tl[:, -1].numpy()]
        for i in range(N - 1):
            cur = out_tokens[:, i:i + 1].astype(np.int32)
            if window:
                jc, tc = jshift(jc), tshift(tc)
            jl, jc = _jfwd(JCFG, jparams, jnp.asarray(cur), jc, mode="decode")
            tl, tc = llama.forward(TCFG, model, torch.from_numpy(cur).long(), tc, mode="decode")
            assert tc.max_len == S
            js.append(np.asarray(jl)[:, -1])
            ts.append(tl[:, -1].numpy())
    return np.stack(ts, 1), np.stack(js, 1)


@pytest.mark.parametrize("window,sink", [(24, 4), (40, 2)])
def test_generate_far_past_window_matches_jax(window, sink):
    jparams, model = pair("sym_int4")
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8]]
    N = 3 * window
    want = TpuModel(JCFG, jparams, "sym_int4").generate(
        prompts, N, streaming_window=window, streaming_sink=sink)
    tm = TorchModel(TCFG, model, "sym_int4", device="cpu")
    got = tm.generate(prompts, N, streaming_window=window, streaming_sink=sink)
    assert got.shape == (2, N) and ((got >= 0) & (got < TCFG.vocab_size)).all()
    np.testing.assert_array_equal(
        got, tm.generate(prompts, N, streaming_window=window, streaming_sink=sink))
    ts, js = _stream_logits(prompts, np.asarray(want), window, sink)
    assert np.abs(ts - js).max() <= TOL_ULPS * np.abs(js).max(), np.abs(ts - js).max()
    assert_margin_rule(got, np.asarray(want), js)


def test_within_window_matches_plain_generate():
    """No eviction before the window fills: the ring's logits are the
    plain cache's (another length and padding, so within the bound), and
    its tokens the plain generate's by the margin rule."""
    _, model = pair("sym_int4")
    tm = TorchModel(TCFG, model, "sym_int4", device="cpu")
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6]]
    plain = tm.generate(prompts, 12)
    streamed = tm.generate(prompts, 12, streaming_window=64, streaming_sink=4)
    ring, _ = _stream_logits(prompts, plain, 64, 4)
    flat, _ = _stream_logits(prompts, plain, None, 4)
    assert np.abs(ring - flat).max() <= TOL_ULPS * np.abs(flat).max()
    assert_margin_rule(streamed, plain, flat)


def test_env_default_kv_flags_are_ignored_with_a_warning(monkeypatch):
    _, model = pair("sym_int4")
    tm = TorchModel(TCFG, model, "sym_int4", device="cpu")
    want = tm.generate([[3, 1, 4, 1]], 6, streaming_window=32)
    for name in ("BIGDL_TPU_QUANTIZE_KV_CACHE", "BIGDL_TPU_COMPRESS_KV_CACHE"):
        monkeypatch.setenv(name, "1")
        with pytest.warns(UserWarning, match="ignoring env-default"):
            out = tm.generate([[3, 1, 4, 1]], 6, streaming_window=32)
        np.testing.assert_array_equal(out, want)
        monkeypatch.delenv(name)


def test_streaming_guards():
    _, model = pair("sym_int4")
    tm = TorchModel(TCFG, model, "sym_int4", device="cpu")
    with pytest.raises(ValueError, match="equal-length"):
        tm.generate([[1, 2, 3], [1, 2]], 4, streaming_window=16)
    with pytest.raises(ValueError, match="shorter than"):
        tm.generate([list(range(20))], 4, streaming_window=16)
    with pytest.raises(ValueError, match="incompatible"):
        tm.generate([[1, 2, 3]], 4, streaming_window=16, quantize_kv=True)
    with pytest.raises(ValueError, match="incompatible"):
        tm.generate([[1, 2, 3]], 4, streaming_window=16, compress_kv=8)
    with pytest.raises(ValueError, match="sink"):
        validate_streaming(TCFG, 16, 0)
    with pytest.raises(ValueError, match="chunk"):
        validate_streaming(TCFG, 16, 4, 13)
    with pytest.raises(NotImplementedError, match="sliding"):
        validate_streaming(dataclasses.replace(TCFG, sliding_window=8), 16, 4)
    with pytest.raises(NotImplementedError, match="1-D rope"):
        validate_streaming(dataclasses.replace(TCFG, rope_local_theta=10000.0), 16, 4)
    fp8 = kvcache.init_cache(2, 1, 16, 4, 16, quantize_kv=True, device="cpu")
    with pytest.raises(NotImplementedError, match="fp8"):
        make_evict(TCFG, 16, 4, 2)(dataclasses.replace(fp8, pos=16))
    comp = kvcache.init_cache(2, 1, 16, 4, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="SnapKV"):
        make_evict(TCFG, 16, 4, 2)(dataclasses.replace(comp, rope_base=torch.zeros(1)))
    with pytest.raises(NotImplementedError, match="per-row"):
        make_evict(TCFG, 16, 4, 2)(dataclasses.replace(comp, pos=torch.full((1,), 16)))
