"""SnapKV compression in the port against the JAX package, on the CPU.

`kvcache.compress` is held against JAX's on the same cache and the same
observation queries (JAX's prefill, crossed as numpy arrays): the slots at
or after each row's new start bit for bit (they are gathers), and pos,
start and rope_base exactly, over bf16 and fp8 e5m2 caches, ragged rows, a
row shorter than the observation window, partial validity and a budget
that covers the prompt. Slots left of the new start are masked in both
packages and may hold any pick. Then end to end on tiny-llama (hidden 64,
both packages on their dequant paths), where each package computes its
own K: the prefill's observation queries, the compressed cache and the
first decode logits against JAX's; and `TorchModel.generate(compress_kv=
...)` against `TpuModel.generate`.

K differs between the packages by bf16 roundings, so the pooled votes do
too, and a slot whose vote sits at the keep boundary may be kept by one
package and not the other. The selection rule: with dv the largest vote
difference of a layer, a slot kept by one package only has a JAX vote
within 2 dv of JAX's k-th largest (order statistics move by at most dv).
Rows whose selections agree in every layer hold the logits of every step
along JAX's tokens within 4 bf16 ULPs of the largest logit, and the
tokens equal up to a step where JAX's top-1/top-2 margin is within twice
that (the margin rule); the port's decode over JAX's compressed cache
holds the logit bound for every row. The sliding-window warn-and-skip,
the environment budget and performance mode's refusal close the file.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import kvcache as jkv
from bigdl_tpu.api import TpuModel
from bigdl_tpu.api import optimize_model as jax_optimize_model
from bigdl_tpu.generate import pad_prompts as jax_pad_prompts
from bigdl_tpu.models import llama as jllama
from bigdl_tpu.models.config import PRESETS as JAX_PRESETS
from bigdl_tpu.utils import cache_len_for as jax_cache_len_for
from bigdl_tpu_torch import TorchModel, kvcache
from bigdl_tpu_torch.convert import params_from_numpy
from bigdl_tpu_torch.models import llama
from bigdl_tpu_torch.models.config import ModelConfig
from bigdl_tpu_torch.utils import cache_len_for, flags
from test_torch_llama import _flatten

torch.set_num_threads(1)

JCFG = JAX_PRESETS["tiny-llama"]
TCFG = ModelConfig(**dataclasses.asdict(JCFG))
# logits leave the lm head in bf16 after two bf16 layers: 4 bf16 ULPs of
# the largest logit; a token may differ only where JAX's top-1/top-2
# margin is within twice that
TOL_ULPS = 2 ** -6

_jfwd = jax.jit(jllama.forward, static_argnames=("config", "mode", "last_logits_only",
                                                  "collect_obs"))


@functools.lru_cache(maxsize=None)
def pair(qtype):
    """(JAX parameters, the port's model holding the same weights): the
    dense bf16 tree of tiny-llama, or its optimize_model(qtype) form."""
    jparams = jllama.init_params(JCFG, jax.random.PRNGKey(0))
    if qtype != "bf16":
        jparams = jax_optimize_model(jparams, JCFG, qtype)
    arrays, qtypes = {}, {}
    _flatten(jparams, "", arrays, qtypes)
    return jparams, params_from_numpy(arrays, qtypes, TCFG, device="cpu")


def jax_prefill(jparams, tokens, start, window, cache_len, quantize_kv=False):
    cache = jkv.init_cache(JCFG.num_hidden_layers, tokens.shape[0], cache_len,
                           JCFG.num_key_value_heads, JCFG.head_dim_, quantize_kv=quantize_kv)
    cache = dataclasses.replace(cache, start=jnp.asarray(start, jnp.int32))
    return _jfwd(JCFG, jparams, jnp.asarray(tokens), cache, mode="prefill",
                 collect_obs=window)


def port_cache(jc):
    """The port's cache holding a JAX cache's arrays (fp8 codes through
    their bytes)."""
    def t(a):
        a = np.array(a)
        if a.dtype == jnp.float8_e5m2:
            return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e5m2)
        return torch.from_numpy(np.asarray(a, np.float32)).to(
            torch.float16 if a.dtype == np.float16 else torch.bfloat16)
    return kvcache.KVCache(
        k=t(jc.k), v=t(jc.v), pos=int(jc.pos), start=torch.from_numpy(np.array(jc.start)),
        k_scale=None if jc.k_scale is None else t(jc.k_scale),
        v_scale=None if jc.v_scale is None else t(jc.v_scale))


def as_np(t):
    if t.dtype == torch.float8_e5m2:
        return t.view(torch.uint8).numpy()
    return t.float().numpy()


def jax_np(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype == jnp.float8_e5m2 else np.asarray(a, np.float32)


def assert_same_compressed(got, want):
    """Equal pos, start and rope_base, and every slot at or after a row's
    start bit for bit (k, v and the fp8 scales)."""
    assert got.pos == int(want.pos)
    np.testing.assert_array_equal(got.start.numpy(), np.asarray(want.start))
    np.testing.assert_array_equal(got.rope_base.numpy(), np.asarray(want.rope_base))
    assert got.k.shape == want.k.shape and got.quantized == (want.k_scale is not None)
    names = ("k", "v") + (("k_scale", "v_scale") if got.quantized else ())
    for b, s0 in enumerate(np.asarray(want.start)):
        for name in names:
            g = as_np(getattr(got, name))[:, b, s0:]
            w = jax_np(getattr(want, name))[:, b, s0:]
            np.testing.assert_array_equal(g, w, err_msg=f"{name} row {b}")


# (label, prompts, bucket, window, budget, out_len, quantize_kv)
COMPRESS_CASES = [
    ("budget covers the prompt", [[5, 9, 2, 7, 3, 11, 4, 8, 6, 1], [9, 2, 6, 4, 8, 1, 3]],
     16, 4, 20, 32, False),
    ("tight budget", [list(range(1, 25))], 32, 4, 8, 16, False),
    ("partial validity", [[5, 9, 2, 7, 3, 11]], 8, 4, 10, 16, False),
    ("row shorter than the window", [list(range(1, 25)), [7, 3, 9]], 32, 8, 12, 32, False),
    ("ragged rows", [list(range(3, 60)), list(range(100, 131)), list(range(40, 52))],
     64, 8, 24, 48, False),
    ("fp8", [list(range(1, 17))], 16, 4, 8, 16, True),
    ("fp8 ragged", [list(range(3, 60)), list(range(100, 131)), [7, 3, 9]], 64, 8, 24, 48, True),
]


@pytest.mark.parametrize("case", COMPRESS_CASES, ids=[c[0] for c in COMPRESS_CASES])
def test_compress_matches_jax_on_the_same_cache(case):
    _, prompts, bucket, W, budget, out_len, fp8 = case
    jparams, _ = pair("bf16")
    tokens, start = jax_pad_prompts(prompts, 0, bucket=bucket)
    _, jc, obs = jax_prefill(jparams, tokens, start, W, 64, fp8)
    want = jkv.compress(jc, obs, budget=budget, out_len=out_len, window=W)
    q_obs = torch.from_numpy(np.asarray(obs, np.float32)).to(torch.bfloat16)
    got = kvcache.compress(port_cache(jc), q_obs, budget, out_len, window=W)
    assert_same_compressed(got, want)


@pytest.mark.parametrize("kernel", [1, 3, 7])
def test_compress_random_cache_matches_jax(kernel):
    """A random bf16 cache of 96 slots (2 layers, 3 rows, 2 kv heads of 4
    query heads): the selection per head differs from head to head."""
    rng = np.random.default_rng(kernel)
    L, B, S, Hkv, G, D, W = 2, 3, 96, 2, 4, 16, 8
    k = rng.standard_normal((L, B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((L, B, S, Hkv, D)).astype(np.float32)
    q = rng.standard_normal((L, B, W, Hkv * G, D)).astype(np.float32) * 2
    start = np.array([0, 17, 70], np.int32)
    jc = dataclasses.replace(
        jkv.init_cache(L, B, S, Hkv, D), k=jnp.asarray(k, jnp.bfloat16),
        v=jnp.asarray(v, jnp.bfloat16), pos=jnp.asarray(S, jnp.int32),
        start=jnp.asarray(start))
    want = jkv.compress(jc, jnp.asarray(q, jnp.bfloat16), budget=40, out_len=56,
                        window=W, kernel=kernel)
    tc = port_cache(jc)
    got = kvcache.compress(tc, torch.from_numpy(q).to(torch.bfloat16), 40, 56,
                           window=W, kernel=kernel)
    assert_same_compressed(got, want)


def test_avg_pool_matches_jax():
    x = np.random.default_rng(0).random((2, 3, 40)).astype(np.float32)
    for kernel in (1, 2, 5, 7):
        np.testing.assert_allclose(
            kvcache._avg_pool_1d(torch.from_numpy(x), kernel).numpy(),
            np.asarray(jkv._avg_pool_1d(jnp.asarray(x), kernel)), rtol=1e-6, atol=1e-7)


def _torch(a):
    """A JAX array as the port holds it (bf16, f16 scales, fp8 codes)."""
    a = np.array(a)
    if a.dtype == jnp.float8_e5m2:
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e5m2)
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.float16 if a.dtype == np.float16 else torch.bfloat16)


def selection_rule(tc, tobs, jc, jobs, W, keep_k, kernel=7) -> np.ndarray:
    """Hold the port's SnapKV selection on its own prefill (cache tc,
    queries tobs) against JAX's (jc, jobs) by the selection rule; returns
    [B] bool, the rows whose kept slots agree in every layer and head."""
    jk, jks = _torch(jc.k), None if jc.k_scale is None else _torch(jc.k_scale)
    jq = _torch(jobs)
    prefix = kvcache.snapkv_prefix(tc.start, tc.pos, W, tc.max_len)
    same = np.ones(tc.k.shape[1], bool)
    for layer in range(tc.k.shape[0]):
        vp = kvcache.snapkv_votes(tc.k[layer], None if tc.k_scale is None else tc.k_scale[layer],
                                  tobs[layer], prefix, kernel)
        vj = kvcache.snapkv_votes(jk[layer], None if jks is None else jks[layer], jq[layer],
                                  prefix, kernel)
        ip, ij = kvcache.snapkv_select(vp, prefix, keep_k), kvcache.snapkv_select(vj, prefix, keep_k)
        dv = (vp - vj).abs()[prefix[:, None, :].expand(vp.shape)].max().item()
        kth = torch.sort(vj, dim=-1, descending=True).values[..., keep_k - 1]
        for b in range(vp.shape[0]):
            ok = set(np.nonzero(prefix[b].numpy())[0])
            for h in range(vp.shape[1]):
                diff = (set(ip[b, h].tolist()) ^ set(ij[b, h].tolist())) & ok
                for slot in diff:
                    gap = abs(vj[b, h, slot].item() - kth[b, h].item())
                    assert gap <= 2 * dv, (layer, b, h, slot, gap, dv)
                same[b] &= not diff
    return same


@pytest.mark.parametrize("fp8", [False, True])
def test_prefill_obs_compress_and_decode_match_jax(fp8):
    """The port end to end on its own prefill: the observation queries
    within a bf16 rounding of JAX's, the kept slots by the selection rule,
    the compressed cache's bookkeeping exactly; the first decode over it
    (positions from rope_base) within the logit bound of JAX's where the
    selections agree, and over JAX's compressed cache for every row."""
    jparams, model = pair("sym_int4")
    prompts = [list(range(3, 60)), list(range(100, 131)), [7, 3, 9]]
    W, budget = 8, 24
    tokens, start = jax_pad_prompts(prompts, 0)
    jl, jc, jobs = jax_prefill(jparams, tokens, start, W, 80, fp8)
    want = jkv.compress(jc, jobs, budget=budget, out_len=40, window=W)
    cache = kvcache.init_cache(2, 3, 80, TCFG.num_key_value_heads, TCFG.head_dim_,
                               quantize_kv=fp8, device="cpu")
    cache = dataclasses.replace(cache, start=torch.from_numpy(start))
    with torch.inference_mode():
        tl, cache, obs = llama.forward(TCFG, model, torch.from_numpy(tokens).long(), cache,
                                       collect_obs=W)
        assert obs.shape == (2, 3, W, TCFG.num_attention_heads, TCFG.head_dim_)
        # queries of real tokens only: a pad query attends nothing, which
        # the flash route gives as 0 and JAX's XLA route as a uniform mean
        real = (np.arange(tokens.shape[1] - W, tokens.shape[1])[None, :]
                >= start[:, None])  # [B, W]
        ref = np.asarray(jobs, np.float32)[:, real]
        np.testing.assert_allclose(obs.float().numpy()[:, real], ref,
                                   atol=2 ** -7 * np.abs(ref).max())
        same = selection_rule(cache, obs, jc, jobs, W, budget - W)
        assert same[1:].all()  # rows 1 and 2 keep every prefix slot
        got = kvcache.compress(cache, obs, budget, 40, window=W)
        assert got.pos == budget
        np.testing.assert_array_equal(got.start.numpy(), np.asarray(want.start))
        np.testing.assert_array_equal(got.rope_base.numpy(), np.asarray(want.rope_base))
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        jd, jc2 = _jfwd(JCFG, jparams, jnp.asarray(nxt), want, mode="decode")
        crossed = dataclasses.replace(port_cache(want),
                                      rope_base=torch.from_numpy(np.array(want.rope_base)))
        tx, _ = llama.forward(TCFG, model, torch.from_numpy(nxt).long(), crossed, mode="decode")
        td, tc2 = llama.forward(TCFG, model, torch.from_numpy(nxt).long(), got, mode="decode")
    assert tc2.pos == budget + 1
    np.testing.assert_array_equal(tc2.rope_base.numpy(), np.asarray(jc2.rope_base))
    ref = np.asarray(jd)
    tol = TOL_ULPS * np.abs(ref).max()
    assert np.abs(tx.numpy() - ref).max() <= tol
    assert np.abs(td.numpy() - ref)[same].max() <= tol


def _teacher_forced_logits(prompts, out_tokens, budget, W, fp8):
    """[B, N, V] logits of every generated position along `out_tokens`
    (JAX's), under the same policy in each package: the port's and JAX's,
    and [B] bool, the rows whose SnapKV selections agree (the selection
    rule holds for every row)."""
    jparams, model = pair("sym_int4")
    N = out_tokens.shape[1]
    tokens, start = jax_pad_prompts(prompts, 0)
    T = tokens.shape[1]
    jc = jkv.init_cache(2, len(prompts), jax_cache_len_for(T, N), JCFG.num_key_value_heads,
                        JCFG.head_dim_, quantize_kv=fp8)
    jc = dataclasses.replace(jc, start=jnp.asarray(start))
    tc = kvcache.init_cache(2, len(prompts), cache_len_for(T, N), TCFG.num_key_value_heads,
                            TCFG.head_dim_, quantize_kv=fp8, device="cpu")
    tc = dataclasses.replace(tc, start=torch.from_numpy(start))
    jl, jc, jobs = _jfwd(JCFG, jparams, jnp.asarray(tokens), jc, collect_obs=W,
                         last_logits_only=True)
    same = np.ones(len(prompts), bool)
    with torch.inference_mode():
        tl, tc, tobs = llama.forward(TCFG, model, torch.from_numpy(tokens).long(), tc,
                                     collect_obs=W, last_logits_only=True)
        if budget:
            same = selection_rule(tc, tobs, jc, jobs, W, budget - W)
            jc = jkv.compress(jc, jobs, budget, jax_cache_len_for(budget, N), window=W)
            tc = kvcache.compress(tc, tobs, budget, cache_len_for(budget, N), window=W)
        js, ts = [np.asarray(jl)[:, -1]], [tl[:, -1].numpy()]
        for i in range(N - 1):
            cur = out_tokens[:, i:i + 1].astype(np.int32)
            jl, jc = _jfwd(JCFG, jparams, jnp.asarray(cur), jc, mode="decode")
            tl, tc = llama.forward(TCFG, model, torch.from_numpy(cur).long(), tc, mode="decode")
            js.append(np.asarray(jl)[:, -1])
            ts.append(tl[:, -1].numpy())
    return np.stack(ts, 1), np.stack(js, 1), same


def assert_margin_rule(got, want, ref_logits, tol_ulps=TOL_ULPS, rows=None):
    """Equal tokens, or a first divergence where the reference's
    top-1/top-2 margin (logits [B, N, V] along its own tokens) is within
    twice the logit tolerance; over `rows` ([B] bool, default all)."""
    for b in range(want.shape[0]):
        if rows is not None and not rows[b]:
            continue
        diff = np.nonzero(got[b] != want[b])[0]
        if diff.size:
            i = diff[0]
            ref = ref_logits[b, i]
            top = np.sort(ref)
            assert top[-1] - top[-2] <= 2 * tol_ulps * np.abs(ref).max(), (b, i)


# (label, prompts, compress_kv, window, quantize_kv): the budget covers
# the longest prompt (lossless), or bites, over bf16 and fp8 caches
GENERATE_CASES = [
    ("covering", [list(range(1, 40))], 48, 8, False),
    ("tight", [list(range(1, 40)), list(range(60, 83))], 16, 8, False),
    ("tight fp8", [list(range(1, 40)), list(range(60, 83))], 20, 8, True),
    ("default window", [list(np.random.default_rng(3).integers(1, 256, 70))], 40, 32, False),
]


@pytest.mark.parametrize("case", GENERATE_CASES, ids=[c[0] for c in GENERATE_CASES])
def test_generate_compress_kv_matches_jax(case):
    _, prompts, budget, W, fp8 = case
    jparams, model = pair("sym_int4")
    N = 8
    want = TpuModel(JCFG, jparams, "sym_int4").generate(
        prompts, N, compress_kv=budget, compress_window=W, quantize_kv=fp8)
    tm = TorchModel(TCFG, model, "sym_int4", device="cpu")
    got = tm.generate(prompts, N, compress_kv=budget, compress_window=W, quantize_kv=fp8)
    assert got.shape == want.shape == (len(prompts), N)
    assert ((got >= 0) & (got < TCFG.vocab_size)).all()
    W = min(W, budget - 1)
    ts, js, same = _teacher_forced_logits(prompts, np.asarray(want), budget, W, fp8)
    assert same.any()
    # fp8: K/V codes a bf16 rounding apart may land a code step apart
    tol = (4 if fp8 else 1) * TOL_ULPS
    assert np.abs(ts - js)[same].max() <= tol * np.abs(js).max(), np.abs(ts - js).max()
    assert_margin_rule(got, np.asarray(want), js, tol, rows=same)


def test_covering_budget_is_lossless_against_plain_generate():
    """A budget past the prompt keeps every token: the same greedy tokens
    as the uncompressed cache, within the port (same kernels, one cache
    re-laid out)."""
    _, model = pair("sym_int4")
    tm = TorchModel(TCFG, model, "sym_int4", device="cpu")
    prompts = [list(range(1, 40))]
    plain = tm.generate(prompts, 8)
    comp = tm.generate(prompts, 8, compress_kv=48, compress_window=8)
    tight = tm.generate(prompts, 8, compress_kv=16, compress_window=8)
    np.testing.assert_array_equal(comp, plain)
    assert ((tight >= 0) & (tight < TCFG.vocab_size)).all()


def test_sliding_window_config_warns_and_skips():
    """After compression slots are not positions, so a sliding window's
    mask would be wrong: generate warns and runs uncompressed, as JAX."""
    jparams, _ = pair("sym_int4")
    cfg = dataclasses.replace(TCFG, sliding_window=8)
    _, model = pair("sym_int4")
    arrays, qtypes = {}, {}
    _flatten(jparams, "", arrays, qtypes)
    tm = TorchModel(cfg, params_from_numpy(arrays, qtypes, cfg, device="cpu"), "sym_int4",
                    device="cpu")
    prompts = [list(range(1, 30))]
    with pytest.warns(UserWarning, match="compress_kv skipped"):
        got = tm.generate(prompts, 6, compress_kv=12)
    np.testing.assert_array_equal(got, tm.generate(prompts, 6))
    jcfg = dataclasses.replace(JCFG, sliding_window=8)
    with pytest.warns(UserWarning, match="compress_kv skipped"):
        want = TpuModel(jcfg, jparams, "sym_int4").generate(prompts, 6, compress_kv=12)
    assert want.shape == got.shape


def test_env_budget_and_flags(monkeypatch):
    from bigdl_tpu.utils import flags as jflags

    for name, val in (("BIGDL_TPU_COMPRESS_KV_CACHE", "1"), ("BIGDL_TPU_COMPRESS_KV_BUDGET", "512"),
                      ("BIGDL_TPU_QUANTIZE_KV_CACHE", "1"), ("BIGDL_TPU_PERFORMANCE_MODE", "on")):
        monkeypatch.setenv(name, val)
    assert flags.compress_kv_budget() == jflags.compress_kv_budget() == 512
    assert flags.quantize_kv_default() and flags.performance_mode()
    monkeypatch.delenv("BIGDL_TPU_COMPRESS_KV_BUDGET")
    assert flags.compress_kv_budget() == jflags.compress_kv_budget() == 1024
    monkeypatch.setenv("BIGDL_TPU_QUANTIZE_KV_CACHE", "0")
    monkeypatch.delenv("BIGDL_TPU_PERFORMANCE_MODE")
    monkeypatch.delenv("BIGDL_TPU_COMPRESS_KV_CACHE")
    assert flags.compress_kv_budget() is None and not flags.quantize_kv_default()
    assert not flags.performance_mode()
    # the environment's budget applies where the call gives none
    _, model = pair("sym_int4")
    tm = TorchModel(TCFG, model, "sym_int4", device="cpu")
    prompts = [list(range(1, 40))]
    explicit = tm.generate(prompts, 6, compress_kv=16)
    monkeypatch.setenv("BIGDL_TPU_COMPRESS_KV_CACHE", "1")
    monkeypatch.setenv("BIGDL_TPU_COMPRESS_KV_BUDGET", "16")
    np.testing.assert_array_equal(tm.generate(prompts, 6), explicit)


def test_performance_mode_lookup_switch_raises(monkeypatch):
    """Where JAX's performance mode switches to prompt-lookup decoding
    (greedy, no SnapKV or streaming or penalty, a prompt of 256 or more),
    the port switches too since decode/lookup.py was ported: the tokens
    are `generate_lookup`'s (its parity: test_torch_decode.py); a shorter
    prompt decodes as usual."""
    _, model = pair("sym_int4")
    tm = TorchModel(TCFG, model, "sym_int4", device="cpu")
    monkeypatch.setenv("BIGDL_TPU_PERFORMANCE_MODE", "1")
    long = [list(range(1, 200)) * 2]
    np.testing.assert_array_equal(tm.generate(long, 4), tm.generate_lookup(long, 4))
    short = tm.generate([list(range(1, 40))], 4)
    monkeypatch.delenv("BIGDL_TPU_PERFORMANCE_MODE")
    np.testing.assert_array_equal(short, tm.generate([list(range(1, 40))], 4))
