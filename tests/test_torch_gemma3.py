"""gemma3 in the port against the JAX package, on the CPU.

gemma3 is gemma2's layer (four (1 + w) norms, the embedding scale, a
tied head, an attention scale from query_pre_attn_scalar) with qwen3's
q/k norms and two rope tables: the global layers rotate at rope_theta
with its rope_scaling, the sliding ones at rope_local_theta unscaled.
The tiny configuration here (tests/test_torch_layer_shapes.py's widths,
2 layers: layer 0 sliding with a window of 4, layer 1 global) takes
gemma-3-27b's bases (1e6 with linear x8 scaling, 1e4 local) and its
attention scale 168^-0.5, and its norms, biases-free, drawn around 0.

The published gemma-3-27b-it text_config translates to the same
ModelConfig in both packages, and the dispatch routes its 62 layers as
JAX does (no flash prefill: the windows are not uniform; the paged kernel
with each layer's window). JAX's parameters cross with
`params_from_numpy`; one JAX reference run is shared by the cases, with
test_torch_layer_shapes.py's bounds. The last test walks ModelConfig's
fields: each one runs in the port or belongs to a family of item [9].
"""

import dataclasses
import functools
import json
import zipfile
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.api import AutoModelForCausalLM as JaxAuto
from bigdl_tpu.api import TpuModel
from bigdl_tpu.api import optimize_model as jax_optimize_model
from bigdl_tpu.convert.low_bit import _flatten as jax_flatten_artifact
from bigdl_tpu.models import llama as jllama
from bigdl_tpu.models.config import ModelConfig as JaxConfig
from bigdl_tpu.ops import rope as jrope
from bigdl_tpu.serving.engine import InferenceEngine as JaxEngine
from bigdl_tpu.streaming import validate_streaming as jax_validate_streaming
from bigdl_tpu_torch import AutoModelForCausalLM, TorchModel
from bigdl_tpu_torch.convert import params_from_numpy, params_to_numpy
from bigdl_tpu_torch.models import llama
from bigdl_tpu_torch.models.config import ModelConfig
from bigdl_tpu_torch.ops import kernels
from bigdl_tpu_torch.ops.rope import make_inv_freq_scaled, rope_cos_sin
from bigdl_tpu_torch.serving import InferenceEngine
from bigdl_tpu_torch.streaming import validate_streaming
from test_torch_flags import _jax_rule
from test_torch_layer_shapes import (BASE, _TOL_ULPS, assert_logits_close, cache_free_inputs,
                                     jax_steps, pallas, perturb, port_steps, prompts_for)
from test_torch_llama import _flatten
from test_torch_serving import _compare, _lockstep

torch.set_num_threads(1)

# google/gemma-3-27b-it's published config.json (its text_config; the
# vision tower's fields left out)
GEMMA3_27B = {
    "architectures": ["Gemma3ForConditionalGeneration"], "model_type": "gemma3",
    "text_config": {
        "model_type": "gemma3_text", "vocab_size": 262208, "hidden_size": 5376,
        "intermediate_size": 21504, "num_hidden_layers": 62, "num_attention_heads": 32,
        "num_key_value_heads": 16, "head_dim": 128, "query_pre_attn_scalar": 168,
        "sliding_window": 1024, "sliding_window_pattern": 6, "rope_theta": 1000000.0,
        "rope_scaling": {"rope_type": "linear", "factor": 8.0},
        "rope_local_base_freq": 10000.0, "rms_norm_eps": 1e-06,
        "max_position_embeddings": 131072, "hidden_activation": "gelu_pytorch_tanh",
        "final_logit_softcapping": None, "attn_logit_softcapping": None,
    },
}
GEMMA3 = dict(model_type="gemma3_text", sliding_window=4, sliding_window_pattern=2,
              rope_theta=1e6, rope_scaling={"rope_type": "linear", "factor": 8.0},
              rope_local_theta=1e4, attn_scale=168 ** -0.5, qk_norm=True, post_attn_norm=True,
              rms_norm_offset=True, scale_embeddings=True, tie_word_embeddings=True,
              hidden_act="gelu_pytorch_tanh", rms_norm_eps=1e-6)


def test_gemma3_27b_config_translates_as_jax():
    """The multimodal config and its text_config alone (gemma3_text), the
    pattern form and HF's layer_types form: the same ModelConfig in both
    packages, with gemma-3-27b's values."""
    text = GEMMA3_27B["text_config"]
    lt = ["full_attention" if (i + 1) % 6 == 0 else "sliding_attention" for i in range(62)]
    for hf in (GEMMA3_27B, text, {**text, "layer_types": lt}):
        cfg = ModelConfig.from_hf_config(hf)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(JaxConfig.from_hf_config(hf))
        llama.check_supported(cfg)
        assert (cfg.hidden_size, cfg.num_hidden_layers, cfg.head_dim_, cfg.vocab_size) == (
            5376, 62, 128, 262208)
        assert cfg.attn_scale == 168 ** -0.5 and cfg.rope_local_theta == 1e4
        rs = cfg.rope_scaling_dict
        assert (rs["rope_type"], rs["factor"]) == ("linear", 8.0)
        assert cfg.tie_word_embeddings and cfg.qk_norm and cfg.post_attn_norm
        assert [cfg.layer_is_sliding(i) for i in range(62)] == [t == "sliding_attention"
                                                                 for t in lt]


CALLS = [("dense", "prefill", 64, False), ("dense", "decode", 1, False),
         ("paged", "prefill", 64, True), ("paged", "decode", 1, True),
         ("none", "prefill", 64, False)]


def test_gemma3_27b_routes_follow_jax_rule():
    """Every layer of gemma-3-27b, every call: the kernel and window
    JAX's dispatch gives (no flash and no flash training: the windows
    are not uniform; the paged kernel with 1024 on the five sliding
    layers of each six), the scale 168^-0.5 everywhere."""
    cfg = ModelConfig.from_hf_config(GEMMA3_27B)
    kinds = set()
    for call in CALLS:
        for layer in range(cfg.num_hidden_layers):
            r = llama.attention_route(cfg, layer, *call)
            kernel, win = _jax_rule(cfg, layer, *call)
            assert (r.kernel, r.window) == (kernel, None if win == 2 ** 30 else win), (call, layer)
            assert r.scale == 168 ** -0.5 and r.softcap is None
            kinds.add((r.kernel, r.window))
    assert kinds == {("plain", 1024), ("plain", None), ("paged", 1024), ("paged", None)}


@pytest.mark.parametrize("local", [False, True], ids=["global", "local"])
def test_rope_tables_match_jax(local):
    """The global table (base 1e6, linear x8) and the local one (base 1e4,
    unscaled), inv_freq and cos/sin at positions up to 2000."""
    cfg = JaxConfig(**{**BASE, **GEMMA3})
    theta, scaling = ((cfg.rope_local_theta, None) if local
                      else (cfg.rope_theta, cfg.rope_scaling_dict))
    inv_j, _ = jrope.make_inv_freq_scaled(cfg.rotary_dim, theta, scaling, seq_len=32)
    inv_t, _ = make_inv_freq_scaled(cfg.rotary_dim, theta, scaling, seq_len=32, device="cpu")
    np.testing.assert_allclose(inv_t.numpy(), np.asarray(inv_j), rtol=2e-6)
    pos = np.random.default_rng(1).integers(0, 2000, (2, 7)).astype(np.int32)
    cos_j, sin_j = jrope.rope_cos_sin(jnp.asarray(pos), inv_j)
    cos_t, sin_t = rope_cos_sin(torch.from_numpy(pos), inv_t)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=1e-4)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=1e-4)


@functools.lru_cache(maxsize=None)
def quantized():
    """(jcfg, JAX sym_int4 tree in the fused layout, tcfg, port model)."""
    jcfg = JaxConfig(**{**BASE, **GEMMA3})
    jparams = jax.jit(functools.partial(jllama.init_params, jcfg))(jax.random.PRNGKey(0))
    jparams = perturb(jparams, jcfg, 1)
    jparams = jax.jit(lambda p: jax_optimize_model(p, jcfg, "sym_int4"))(jparams)
    arrays, qtypes = {}, {}
    _flatten(jparams, "", arrays, qtypes)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    return jcfg, jparams, tcfg, params_from_numpy(arrays, qtypes, tcfg, device="cpu")


@functools.lru_cache(maxsize=None)
def reference():
    """JAX's prefill last logits (Pallas interpret and XLA), two greedy
    decode steps over the dense cache, the cache-free forward."""
    jcfg, jparams, _, _ = quantized()
    prompts = prompts_for(jcfg.vocab_size)
    out = {}
    with pallas("interpret"):
        out["prefill_interpret"] = jax_steps(jcfg, jparams, prompts, 0)[0][0]
    with pallas("0"):
        out["decode"], out["greedy"] = jax_steps(jcfg, jparams, prompts, 2)
        out["prefill_0"] = out["decode"][0]
        tokens, start = cache_free_inputs(jcfg.vocab_size)
        logits, _ = jllama.forward(jcfg, jparams, jnp.asarray(tokens), None,
                                   start=jnp.asarray(start))
        out["cache_free"] = np.asarray(logits)
    return out


def test_weights_carry_over_exactly():
    """params_from_numpy holds JAX's quantized tree (its artifact arrays:
    the q/k norms and post norms, no lm head), and the port's init_params
    makes JAX's leaves."""
    jcfg, jparams, tcfg, model = quantized()
    want = {}
    jax_flatten_artifact(jparams, "", want, {})
    got, _ = params_to_numpy(model)
    assert got.keys() == want.keys() and "lm_head@data" not in got
    for k, a in want.items():
        np.testing.assert_array_equal(got[k], a, err_msg=k)
    jdense = {}
    jax_flatten_artifact(jax.jit(functools.partial(jllama.init_params, jcfg))(
        jax.random.PRNGKey(0)), "", jdense, {})
    ours, _ = params_to_numpy(llama.init_params(tcfg, 0, device="cpu"))
    assert {k: v.shape for k, v in ours.items()} == {k: v.shape for k, v in jdense.items()}


@pytest.mark.parametrize("mode", ["interpret", "0"])
def test_prefill_logits_match_jax(mode):
    """Prefill last logits (the plain attention on both layers, as JAX's
    dispatch takes for windows that are not uniform, with each layer's
    table), against JAX's Pallas and XLA runs."""
    jcfg, _, tcfg, model = quantized()
    kernels.reset_launches()
    got = port_steps(tcfg, model, prompts_for(jcfg.vocab_size), np.zeros((3, 0), np.int64))
    assert all(n == 0 for n in kernels.launch_counts().values())
    assert_logits_close(got[0], reference()[f"prefill_{mode}"], mode)


def test_dense_decode_logits_and_greedy_tokens_match_jax():
    jcfg, _, tcfg, model = quantized()
    ref = reference()
    got = port_steps(tcfg, model, prompts_for(jcfg.vocab_size), ref["greedy"])
    for i, (g, r) in enumerate(zip(got, ref["decode"])):
        assert_logits_close(g, r, i)
        top = np.sort(r, -1)
        clear = top[:, -1] - top[:, -2] > 2 * _TOL_ULPS * np.abs(r).max()
        np.testing.assert_array_equal(g.argmax(-1)[clear], r.argmax(-1)[clear])


def test_cache_free_forward_matches_jax():
    jcfg, _, tcfg, model = quantized()
    tokens, start = cache_free_inputs(jcfg.vocab_size)
    with torch.inference_mode():
        got, _ = llama.forward(tcfg, model, torch.from_numpy(tokens).long(), None,
                               start=torch.from_numpy(start))
    ref = reference()["cache_free"]
    for b, s in enumerate(start):
        assert_logits_close(got[b, s:].numpy(), ref[b, s:], b)


def test_each_table_reaches_its_layers():
    """Each table moves the logits past the bound when its base or scaling
    changes (the local base 1e4 -> 1e5 reaches the sliding layer, the
    global scaling x8 -> none the global one), and the port follows JAX
    there too; so does a config making layer 0 global (the local table
    then unused)."""
    jcfg, jparams, tcfg, model = quantized()
    prompts = prompts_for(jcfg.vocab_size)
    none = np.zeros((3, 0), np.int64)
    base = port_steps(tcfg, model, prompts, none)[0]
    tol = _TOL_ULPS * np.abs(base).max()
    for kw in ({"rope_local_theta": 1e5}, {"rope_scaling": None},
               {"sliding_layers": (False, False)}):
        got = port_steps(dataclasses.replace(tcfg, **kw), model, prompts, none)[0]
        with pallas("0"):
            ref = jax_steps(dataclasses.replace(jcfg, **kw), jparams, prompts, 0)[0][0]
        assert_logits_close(got, ref, kw)
        assert np.abs(got - base).max() > 2 * tol, kw


def test_generate_and_paged_engine_match_jax():
    """`generate` (greedy tokens by the margin rule) and both packages'
    paged engines in lockstep (pages of 8): pages after every step,
    tokens by the margin rule, chosen-token logprobs within twice the
    bound, no page leaks; the paged kernel's plain version takes the
    window 4 on layer 0 only and the scale 168^-0.5 on both."""
    jcfg, jparams, tcfg, model = quantized()
    prompts = prompts_for(jcfg.vocab_size)
    tol = _TOL_ULPS * np.abs(reference()["prefill_0"]).max()
    tm = TorchModel(tcfg, model, "sym_int4", device="cpu")
    with pallas("0"):
        want = TpuModel(jcfg, jparams, "sym_int4").generate(prompts, 6)
    got = tm.generate(prompts, 6)
    for b in range(len(prompts)):
        diff = np.nonzero(got[b] != want[b])[0]
        if diff.size:
            with pallas("0"):
                r = jax_steps(jcfg, jparams, [prompts[b] + list(want[b, :diff[0]])], 0)[0][0][0]
            top = np.sort(r)
            assert top[-1] - top[-2] <= 2 * tol, (b, diff[0])
    calls = []
    real = kernels.paged_attention

    def recorded(q, k, v, bt, layer, *a, **kw):
        calls.append((layer, kw.get("window"), kw.get("scale")))
        return real(q, k, v, bt, layer, *a, **kw)

    kw = dict(n_slots=2, max_len=64, paged=True, page_size=8)
    with pallas("0"), mock.patch.object(kernels, "paged_attention", recorded):
        jeng = JaxEngine(TpuModel(jcfg, jparams, "sym_int4"), logprobs_top_k=2, **kw)
        teng = InferenceEngine(tm, **kw)
        script = {0: [dict(prompt=prompts[0], max_new_tokens=8),
                      dict(prompt=prompts[0][:9] + prompts[1], max_new_tokens=8)],
                  3: [dict(prompt=prompts[2], max_new_tokens=8)]}
        reqs = _lockstep(jeng, teng, script)
    _compare(reqs, tol, [])
    assert [r.finish_reason for _, r in reqs] == ["length"] * 3
    assert teng.page_leaks() == jeng.page_leaks() == 0
    assert set(calls) == {(0, 4, 168 ** -0.5), (1, None, 168 ** -0.5)}


def test_artifacts_are_the_same_bytes_both_ways(tmp_path):
    """A gemma3 model saved by each package: the same npz members, digests,
    manifest and model_config (rope_local_theta and the window pattern
    among it); each loads the other's (the port JAX's arrays exactly, JAX
    the port's under verify="full": its greedy tokens exactly)."""
    jcfg, jparams, tcfg, model = quantized()
    jm = TpuModel(jcfg, jparams, "sym_int4")
    TorchModel(tcfg, model, "sym_int4", device="cpu").save_low_bit(str(tmp_path / "port"))
    jm.save_low_bit(str(tmp_path / "jax"))
    metas, members = {}, {}
    for side in ("jax", "port"):
        metas[side] = json.loads((tmp_path / side / "bigdl_tpu_config.json").read_text())
        with zipfile.ZipFile(tmp_path / side / metas[side]["weights_file"]) as zf:
            members[side] = {n: zf.read(n) for n in zf.namelist()}
    assert members["port"].keys() == members["jax"].keys()
    assert {"layers.q_norm.npy", "layers.post_mlp_norm.npy"} <= members["jax"].keys()
    for member, raw in members["jax"].items():
        assert members["port"][member] == raw, member
    for key in ("format_version", "qtype", "model_config", "manifest", "integrity"):
        assert metas["port"][key] == metas["jax"][key], key
    assert metas["port"]["model_config"]["rope_local_theta"] == 1e4
    loaded = AutoModelForCausalLM.load_low_bit(str(tmp_path / "jax"), device="cpu")
    assert loaded.config == tcfg
    got, _ = params_to_numpy(loaded.params)
    want = {}
    jax_flatten_artifact(jparams, "", want, {})
    assert got.keys() == want.keys()
    for k, a in want.items():
        np.testing.assert_array_equal(got[k], a, err_msg=k)
    with pallas("0"):
        back = JaxAuto.load_low_bit(str(tmp_path / "port"), verify="full")
        prompts = prompts_for(jcfg.vocab_size)
        np.testing.assert_array_equal(back.generate(prompts, 4), jm.generate(prompts, 4))


def test_streaming_refuses_gemma3_as_jax_does():
    """Attention sinks re-base one rope table; gemma3 has two (and its
    window already bounds the sliding layers' span): both packages
    refuse it, with the same message."""
    for cfg in (JaxConfig(**{**BASE, **GEMMA3}),
                JaxConfig(**{**BASE, **GEMMA3, "sliding_window": None})):
        with pytest.raises(NotImplementedError) as jerr:
            jax_validate_streaming(cfg, 16, 4, 1)
        with pytest.raises(NotImplementedError) as terr:
            validate_streaming(ModelConfig(**dataclasses.asdict(cfg)), 16, 4, 1)
        assert str(terr.value) == str(jerr.value)


def test_gemv_tile_is_none_exactly_where_x_does_not_fit():
    """`qtile.gemv_tile` gives no tile (the dispatch then takes the GEMM)
    exactly where x's rows, and the adapter's xg, overflow shared memory
    at the least a tile needs (the most cluster ranks, 8 warps), at every
    M <= 32 and the slice's contraction widths: gemma-3-27b's w_down
    (21504: 30 to 32 rows, 29 to 32 with an adapter), command-r's (22528),
    starcoder2-15b's (24576), phi-2's (10240)."""
    from bigdl_tpu_torch.ops.kernels import qtile

    def fits(M, K, R):
        return qtile.gemv_smem(M, K, "sym_int4", qtile.GEMV_KC[-1], R,
                               qtile.GEMV_WARPS[0]) <= qtile.SMEM_LIMIT

    for K in (5376, 10240, 21504, 22528, 24576):
        for R in (0, 16):
            for M in range(1, 33):
                t = qtile.gemv_tile(M, 4096, K, "sym_int4", R)
                assert (t is not None) == fits(M, K, R), (K, R, M)
                assert t is None or t.smem <= qtile.SMEM_LIMIT
    none = [[M for M in range(1, 33) if qtile.gemv_tile(M, 5376, 21504, "sym_int4", R) is None]
            for R in (0, 16)]
    assert none == [[30, 31, 32], [29, 30, 31, 32]]


def test_every_config_field_runs_or_is_a_family_field():
    """Each ModelConfig field is one the port runs at any value, one of
    the MoE group, checked by value (rope_scaling, hidden_act), or a field
    of a family with modules of its own (ROADMAP queue 1 item [9]); no
    refusal names item [4] any more. A family field still raises, naming
    item [9]."""
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    ran = llama._SUPPORTED_FIELDS | llama._MOE_FIELDS | {"rope_scaling", "hidden_act"}
    assert fields == ran | llama._FAMILY_FIELDS and not ran & llama._FAMILY_FIELDS
    base = ModelConfig(**BASE)
    for name in sorted(llama._FAMILY_FIELDS):
        value = {"scoring_func": "sigmoid", "routed_scaling_factor": 2.5,
                 "first_k_dense_replace": 1, "topk_method": "greedy"}.get(name, 8)
        if name in ("cross_attention_layers", "mrope_section"):
            value = (1,)
        with pytest.raises(NotImplementedError, match=r"ROADMAP queue 1 item \[9\]"):
            llama.check_supported(dataclasses.replace(base, **{name: value}))
    for cfg in (JaxConfig(**{**BASE, **GEMMA3}), ModelConfig.from_hf_config(GEMMA3_27B)):
        llama.check_supported(ModelConfig(**dataclasses.asdict(cfg)))
