"""HF ingest in the port against the JAX package, on the CPU.

`ModelConfig.from_hf_config` against JAX's over HF config dicts of eight
families; the port's safetensors reader (`convert.hf.open_checkpoint`)
against the `safetensors` package, bit for bit, and chip_smoke.py's
writer read back by the package; `load_hf_checkpoint` of tiny llama,
phi3 (fused qkv_proj/gate_up_proj, split and fused again), mistral,
qwen2 (q/k/v biases), qwen3 (q/k norms), gemma2 (four norms, tied head),
the published phi3-mini-4k config (window 2047), gemma3 (under a
multimodal checkpoint's `language_model.model.` names) and gemma3_text,
phi, phixtral, starcoder2, gpt_neox, cohere, gpt2, bloom, stablelm and
minicpm, each under its family's HF names, against JAX's: the same
stored bytes for every tensor, prefill logits within
tests/test_torch_llama.py's tolerance, in sym_int4 and q4_k_m (the
families from gemma3 on in one of the two each); and the refusals,
each naming its ROADMAP item before a tensor is read. Fixtures are
written here with the `safetensors` package from seeds.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file

from bigdl_tpu.api import AutoModelForCausalLM as JaxAuto
from bigdl_tpu.convert.low_bit import _flatten as jax_flatten
from bigdl_tpu.models.config import ModelConfig as JaxConfig
from bigdl_tpu_torch import AutoModelForCausalLM
from bigdl_tpu_torch.convert import hf as hf_mod
from bigdl_tpu_torch.convert import open_checkpoint, params_to_numpy
from bigdl_tpu_torch.models.config import ModelConfig
from test_torch_llama import PROMPT_LENS, _TOL_ULPS, _jax_last_logits, _port_last_logits

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


LLAMA = {"model_type": "llama", "vocab_size": 512, "hidden_size": 256,
         "intermediate_size": 512, "num_hidden_layers": 2, "num_attention_heads": 2,
         "num_key_value_heads": 1, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
         "max_position_embeddings": 128, "tie_word_embeddings": False, "hidden_act": "silu"}
PHI3 = {**LLAMA, "model_type": "phi3", "num_key_value_heads": 2,
        "architectures": ["Phi3ForCausalLM"]}
# the published Phi-3-mini-4k-instruct config.json (its sliding window)
PHI3_MINI_4K = {"model_type": "phi3", "vocab_size": 32064, "hidden_size": 3072,
                "intermediate_size": 8192, "num_hidden_layers": 32, "num_attention_heads": 32,
                "num_key_value_heads": 32, "rms_norm_eps": 1e-05, "rope_theta": 10000.0,
                "max_position_embeddings": 4096, "original_max_position_embeddings": 4096,
                "sliding_window": 2047, "rope_scaling": None, "tie_word_embeddings": False,
                "hidden_act": "silu", "attention_bias": False}
HF_CONFIGS = {
    "llama": {**LLAMA, "rope_scaling": {"rope_type": "llama3", "factor": 8.0,
                                        "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                                        "original_max_position_embeddings": 8192}},
    "mistral": {**LLAMA, "model_type": "mistral", "sliding_window": 4096,
                "rope_theta": 1e6},
    "qwen2": {**LLAMA, "model_type": "qwen2", "use_sliding_window": False,
              "sliding_window": 32768, "max_window_layers": 28},
    "phi3": {**PHI3_MINI_4K, "rope_scaling": {"type": "longrope", "short_factor": [1.0] * 48,
                                              "long_factor": [2.0] * 48}},
    "gemma2": {**LLAMA, "model_type": "gemma2", "head_dim": 256, "sliding_window": 4096,
               "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
               "query_pre_attn_scalar": 224, "hidden_activation": "gelu_pytorch_tanh"},
    "mixtral": {**LLAMA, "model_type": "mixtral", "num_local_experts": 8,
                "num_experts_per_tok": 2},
    "qwen2_vl": {"model_type": "qwen2_vl", "vision_config": {"depth": 2},
                 "text_config": {**LLAMA, "model_type": "qwen2_vl",
                                 "rope_scaling": {"type": "mrope",
                                                  "mrope_section": [16, 24, 24]}}},
    "phi-msft": {**LLAMA, "model_type": "phi-msft", "num_local_experts": 4,
                 "num_experts_per_tok": 2},
}


@pytest.mark.parametrize("family", list(HF_CONFIGS))
def test_config_translation_equals_jax(family):
    hf = HF_CONFIGS[family]
    assert dataclasses.asdict(ModelConfig.from_hf_config(hf)) == dataclasses.asdict(
        JaxConfig.from_hf_config(hf))


def test_legacy_phi_msft_is_refused_as_jax_refuses_it():
    hf = {**LLAMA, "model_type": "phi-msft"}
    for cls in (ModelConfig, JaxConfig):
        with pytest.raises(NotImplementedError, match="phi-msft"):
            cls.from_hf_config(hf)


def _tensors(seed):
    g = torch.Generator().manual_seed(seed)
    return {
        "model.embed_tokens.weight": torch.randn(64, 16, generator=g).to(torch.bfloat16),
        "a.f16": torch.randn(3, 5, generator=g).to(torch.float16),
        "a.f32": torch.randn(7, generator=g),
        "a.i32": torch.randint(-2 ** 31, 2 ** 31 - 1, (4, 6), generator=g, dtype=torch.int32),
        "a.scalar": torch.tensor(2.5),
    }


def _bits_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.numel():
        assert torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("sharded", [False, True])
def test_the_reader_returns_the_packages_bits(tmp_path, sharded):
    ts = _tensors(0)
    if sharded:
        names = sorted(ts)
        parts = {"model-00001-of-00002.safetensors": names[:2],
                 "model-00002-of-00002.safetensors": names[2:]}
        for shard, keys in parts.items():
            save_file({k: ts[k] for k in keys}, str(tmp_path / shard))
        (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
            {"weight_map": {k: s for s, keys in parts.items() for k in keys}}))
    else:
        save_file(ts, str(tmp_path / "model.safetensors"))
    get = open_checkpoint(str(tmp_path))
    for name in ts:
        shard = ("model.safetensors" if not sharded else next(
            s for s, keys in parts.items() if name in keys))
        with safe_open(str(tmp_path / shard), framework="pt") as f:
            _bits_equal(get(name), f.get_tensor(name))
    # no lm_head.weight: the embedding stands in, as in the JAX reader
    _bits_equal(get("lm_head.weight"), ts["model.embed_tokens.weight"])
    with pytest.raises(KeyError, match="has no tensor 'model.norm.weight'"):
        get("model.norm.weight")


def test_chip_smoke_writer_is_read_by_the_package(tmp_path):
    cs = _chip_smoke()
    ts = _tensors(1)
    entries = [(k, t.dtype, tuple(t.shape), lambda t=t: t) for k, t in ts.items()]
    n = cs.write_safetensors(tmp_path / "model.safetensors", entries)
    assert n == (tmp_path / "model.safetensors").stat().st_size
    with safe_open(str(tmp_path / "model.safetensors"), framework="pt") as f:
        assert sorted(f.keys()) == sorted(ts)
        for k, t in ts.items():
            _bits_equal(f.get_tensor(k), t)
    hf = {**LLAMA, "num_hidden_layers": 2}
    total = cs.write_hf_checkpoint(torch, tmp_path / "hf", hf, 3, torch.device("cpu"))
    get = open_checkpoint(str(tmp_path / "hf"))
    index = json.loads((tmp_path / "hf" / "model.safetensors.index.json").read_text())
    assert index["metadata"]["total_size"] == total and len(set(index["weight_map"].values())) == 2
    for k, shard in index["weight_map"].items():
        with safe_open(str(tmp_path / "hf" / shard), framework="pt") as f:
            _bits_equal(get(k), f.get_tensor(k))


def _llama_names(cfg, i, mt):
    """(name, shape, kind) of layer i under HF's llama names: the two
    norms (with biases under norm_bias), q/k/v/o with the biases the
    config has (qwen2's q/k/v always), the gated MLP; phi3's fused
    qkv_proj/gate_up_proj, gemma2/3's pre/post feed-forward norms,
    qwen3's and gemma3's q/k norms."""
    H, I, D = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim_
    QD, KD = cfg.q_dim, cfg.kv_dim
    p = f"model.layers.{i}."
    out = [(p + "input_layernorm.weight", (H,), "norm"),
           (p + "post_attention_layernorm.weight", (H,), "norm"),
           (p + "self_attn.o_proj.weight", (H, QD), "w"), (p + "mlp.down_proj.weight", (H, I), "w")]
    if mt == "phi3":
        out += [(p + "self_attn.qkv_proj.weight", (QD + 2 * KD, H), "w"),
                (p + "mlp.gate_up_proj.weight", (2 * I, H), "w")]
    else:
        out += [(p + f"self_attn.{n}_proj.weight", (r, H), "w")
                for n, r in (("q", QD), ("k", KD), ("v", KD))]
        out += [(p + f"mlp.{n}_proj.weight", (I, H), "w") for n in ("gate", "up")]
    if cfg.attention_bias:
        out += [(p + f"self_attn.{n}_proj.bias", (r,), "bias")
                for n, r in (("q", QD), ("k", KD), ("v", KD))]
    if cfg.norm_bias:
        out += [(p + f"{n}.bias", (H,), "bias")
                for n in ("input_layernorm", "post_attention_layernorm")]
    if mt.startswith("gemma"):
        out += [(p + f"{n}.weight", (H,), "norm")
                for n in ("pre_feedforward_layernorm", "post_feedforward_layernorm")]
    if cfg.qk_norm:
        out += [(p + f"self_attn.{n}_norm.weight", (D,), "norm")
                for n in ("q", "k")]
    return out


def _family_names(cfg, mt):
    """(name, shape, kind) of every tensor of a checkpoint of family `mt`
    under its HF names (the JAX package's tables read exactly these)."""
    H, I, V, D, L = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.head_dim_,
                     cfg.num_hidden_layers)
    QD, KD, nh = cfg.q_dim, cfg.kv_dim, cfg.num_attention_heads

    def biased(name, shape):
        return [(name + ".weight", shape, "w"), (name + ".bias", (shape[0],), "bias")]

    def ln(name):
        return [(name + ".weight", (H,), "norm"), (name + ".bias", (H,), "bias")]

    out = []
    for i in range(L):
        if mt == "phi":
            p = f"model.layers.{i}."
            out += ln(p + "input_layernorm")
            for n, r in (("q", QD), ("k", KD), ("v", KD)):
                out += biased(p + f"self_attn.{n}_proj", (r, H))
            out += biased(p + "self_attn.dense", (H, QD)) + biased(p + "mlp.fc1", (I, H))
            out += biased(p + "mlp.fc2", (H, I))
        elif mt == "phixtral":
            p = f"transformer.h.{i}."
            out += ln(p + "ln") + biased(p + "mixer.Wqkv", (3 * H, H))
            out += biased(p + "mixer.out_proj", (H, H))
            out += [(p + "moe.gate.weight", (cfg.num_experts, H), "w")]
            for e in range(cfg.num_experts):
                out += biased(p + f"moe.mlp.{e}.fc1", (I, H)) + biased(p + f"moe.mlp.{e}.fc2", (H, I))
        elif mt == "starcoder2":
            p = f"model.layers.{i}."
            out += ln(p + "input_layernorm") + ln(p + "post_attention_layernorm")
            for n, r in (("q", QD), ("k", KD), ("v", KD)):
                out += biased(p + f"self_attn.{n}_proj", (r, H))
            out += biased(p + "self_attn.o_proj", (H, QD)) + biased(p + "mlp.c_fc", (I, H))
            out += biased(p + "mlp.c_proj", (H, I))
        elif mt in ("gpt_neox", "bloom"):
            p, attn = ((f"gpt_neox.layers.{i}.", "attention") if mt == "gpt_neox"
                       else (f"transformer.h.{i}.", "self_attention"))
            out += ln(p + "input_layernorm") + ln(p + "post_attention_layernorm")
            out += biased(p + attn + ".query_key_value", (nh * 3 * D, H))
            out += biased(p + attn + ".dense", (H, QD)) + biased(p + "mlp.dense_h_to_4h", (I, H))
            out += biased(p + "mlp.dense_4h_to_h", (H, I))
        elif mt == "gpt2":  # Conv1D: weights stored [in, out]
            p = f"transformer.h.{i}."
            out += ln(p + "ln_1") + ln(p + "ln_2")
            out += [(p + "attn.c_attn.weight", (H, 3 * H), "w"), (p + "attn.c_attn.bias", (3 * H,), "bias"),
                    (p + "attn.c_proj.weight", (H, H), "w"), (p + "attn.c_proj.bias", (H,), "bias"),
                    (p + "mlp.c_fc.weight", (H, I), "w"), (p + "mlp.c_fc.bias", (I,), "bias"),
                    (p + "mlp.c_proj.weight", (I, H), "w"), (p + "mlp.c_proj.bias", (H,), "bias")]
        elif mt == "cohere":
            p = f"model.layers.{i}."
            out += [n for n in _llama_names(cfg, i, mt) if "post_attention" not in n[0]]
        else:
            out += _llama_names(cfg, i, mt)
    if mt == "phixtral":
        out += [("transformer.embd.wte.weight", (V, H), "w")] + ln("lm_head.ln")
        out += biased("lm_head.linear", (V, H))
    elif mt == "gpt2":
        out += [("transformer.wte.weight", (V, H), "w"),
                ("transformer.wpe.weight", (cfg.max_position_embeddings, H), "w")]
        out += ln("transformer.ln_f")
    elif mt == "bloom":
        out += [("transformer.word_embeddings.weight", (V, H), "w")]
        out += ln("transformer.word_embeddings_layernorm") + ln("transformer.ln_f")
    elif mt == "gpt_neox":
        out += [("gpt_neox.embed_in.weight", (V, H), "w")] + ln("gpt_neox.final_layer_norm")
        if not cfg.tie_word_embeddings:
            out += [("embed_out.weight", (V, H), "w")]
    else:
        final = "model.final_layernorm" if mt == "phi" else "model.norm"
        out += [("model.embed_tokens.weight", (V, H), "w"), (final + ".weight", (H,), "norm")]
        if cfg.norm_bias:
            out += [(final + ".bias", (H,), "bias")]
        if not cfg.tie_word_embeddings:
            out += (biased("lm_head", (V, H)) if cfg.lm_head_bias
                    else [("lm_head.weight", (V, H), "w")])
    return out


def _write_checkpoint(root, hf, seed, prefix=""):
    """config.json and one safetensors file of the family's tensors (the
    JAX package's translation of `hf` gives their shapes): bf16 N(0,
    0.02^2) weights, biases N(0, 0.1^2), norms (q/k norms too) drawn
    around 1 (around 0 for gemma's (1 + w)); no lm_head.weight when the
    head is tied. `prefix` goes before every name whose family keeps it
    (gemma3's multimodal checkpoints: "language_model.")."""
    root.mkdir(parents=True, exist_ok=True)
    (root / "config.json").write_text(json.dumps(hf))
    cfg = JaxConfig.from_hf_config(hf)
    rng = np.random.default_rng(seed)
    norm_at = 0.0 if cfg.rms_norm_offset else 1.0
    loc = {"w": (0.0, 0.02), "bias": (0.0, 0.1), "norm": (norm_at, 0.1)}
    ts = {}
    for name, shape, kind in _family_names(cfg, cfg.model_type):
        m, sd = loc[kind]
        ts[prefix + name] = torch.from_numpy(
            (m + sd * rng.standard_normal(shape)).astype(np.float32)).to(torch.bfloat16)
    save_file(ts, str(root / "model.safetensors"))
    return root


# tiny configurations of the families the ingest takes (the phi3-mini-4k
# one is the published config.json at LLAMA's widths: its window 2047)
INGEST = {
    "llama": LLAMA,
    "phi3": PHI3,
    "mistral": {**LLAMA, "model_type": "mistral", "sliding_window": 4, "rope_theta": 1e6},
    "qwen2": {**LLAMA, "model_type": "qwen2", "use_sliding_window": False,
              "sliding_window": 32768, "max_window_layers": 28},
    "qwen3": {**LLAMA, "model_type": "qwen3", "head_dim": 128, "attention_bias": False},
    "gemma2": {**{k: v for k, v in LLAMA.items() if k != "tie_word_embeddings"},
               "model_type": "gemma2", "head_dim": 128, "sliding_window": 4,
               "query_pre_attn_scalar": 96, "attn_logit_softcapping": 0.5,
               "final_logit_softcapping": 2.0, "hidden_activation": "gelu_pytorch_tanh",
               "rms_norm_eps": 1e-6},
    "phi3-mini-4k": {**PHI3_MINI_4K, **{k: PHI3[k] for k in (
        "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
        "num_attention_heads", "num_key_value_heads", "max_position_embeddings")}},
    # the families of the rest of the llama flags, each as its config.json
    # names its fields (gemma3: the multimodal form, its weights under
    # `language_model.model.`)
    "gemma3": {"model_type": "gemma3", "text_config": {
        **{k: v for k, v in LLAMA.items() if k != "tie_word_embeddings"},
        "model_type": "gemma3_text", "head_dim": 128, "sliding_window": 4,
        "sliding_window_pattern": 2, "query_pre_attn_scalar": 168, "rope_theta": 1e6,
        "rope_scaling": {"rope_type": "linear", "factor": 8.0}, "rope_local_base_freq": 1e4,
        "rms_norm_eps": 1e-6}},
    "gemma3_text": {**{k: v for k, v in LLAMA.items() if k != "tie_word_embeddings"},
                    "model_type": "gemma3_text", "head_dim": 128, "sliding_window": 4,
                    "layer_types": ["sliding_attention", "full_attention"],
                    "query_pre_attn_scalar": 168, "rms_norm_eps": 1e-6},
    "phi": {**LLAMA, "model_type": "phi", "partial_rotary_factor": 0.4,
            "hidden_act": "gelu_new", "layer_norm_eps": 1e-5},
    "phixtral": {"model_type": "phi-msft", "vocab_size": 512, "n_embd": 256, "n_layer": 2,
                 "n_head": 2, "n_inner": 512, "n_positions": 128, "rotary_dim": 32,
                 "num_local_experts": 4, "num_experts_per_tok": 2,
                 "activation_function": "gelu_new", "tie_word_embeddings": False},
    "starcoder2": {**LLAMA, "model_type": "starcoder2", "sliding_window": 4,
                   "hidden_act": "gelu_pytorch_tanh", "use_bias": True, "norm_epsilon": 1e-5,
                   "tie_word_embeddings": True},
    "gpt_neox": {**LLAMA, "model_type": "gpt_neox", "num_key_value_heads": 2, "rotary_pct": 0.25,
                 "use_parallel_residual": True, "hidden_act": "gelu"},
    "cohere": {**LLAMA, "model_type": "cohere", "logit_scale": 0.0625,
               "tie_word_embeddings": True},
    "gpt2": {"model_type": "gpt2", "vocab_size": 512, "n_embd": 256, "n_layer": 2, "n_head": 2,
             "n_positions": 128, "activation_function": "gelu_new"},
    "bloom": {"model_type": "bloom", "vocab_size": 512, "hidden_size": 256, "n_layer": 2,
              "n_head": 2},
    "stablelm": {**LLAMA, "model_type": "stablelm", "partial_rotary_factor": 0.25,
                 "layer_norm_eps": 1e-5},
    "minicpm": {**LLAMA, "model_type": "minicpm", "scale_emb": 12, "scale_depth": 1.4,
                "dim_model_base": 128, "tie_word_embeddings": True},
}
# gemma3's multimodal checkpoints keep the text weights under this prefix
PREFIX = {"gemma3": "language_model."}
# the families before gemma3 in both formats; the later ones (their
# tables are what they add: the quantizer is the same) in one each, the
# two formats alternating
_NEW = list(INGEST)[list(INGEST).index("gemma3"):]
INGEST_CASES = [(f, q) for f in INGEST if f not in _NEW for q in ("sym_int4", "q4_k_m")] + [
    (f, ("sym_int4", "q4_k_m")[i % 2]) for i, f in enumerate(_NEW)]


@pytest.mark.parametrize("family,qtype", INGEST_CASES, ids=[f"{f}-{q}" for f, q in INGEST_CASES])
def test_ingest_matches_jax(tmp_path, family, qtype, monkeypatch):
    """The port's ingest quantizes in row chunks (here 40 rows of 256, so
    every projection and the lm head goes in pieces): the same bytes as
    JAX's one call a weight, the same dense leaves (biases merged into
    bqkv, gemma2's four norms, qwen3's q/k norms, the norms' biases,
    gpt2's wpe, bloom's embedding layernorm, phi's lm head bias, the
    experts' biases, no lm_head when tied), and prefill logits within
    test_torch_llama.py's bound."""
    monkeypatch.setenv("BIGDL_TPU_PALLAS", "0")
    monkeypatch.setattr(hf_mod, "QUANT_CHUNK", 40 * 256)
    d = _write_checkpoint(tmp_path / family, INGEST[family], 7, PREFIX.get(family, ""))
    jm = JaxAuto.from_pretrained(str(d), load_in_low_bit=qtype)
    tm = AutoModelForCausalLM.from_pretrained(str(d), load_in_low_bit=qtype, device="cpu")
    assert dataclasses.asdict(tm.config) == dataclasses.asdict(jm.config)
    mlp = set() if tm.config.is_moe else {
        "w_gateup" if tm.config.gated_mlp else "w_up", "w_down"}
    assert set(tm.params.layers[0].proj) == {"wqkv", "wo"} | mlp
    assert (tm.params.lm_head is None) == tm.config.tie_word_embeddings
    jarrays, jmanifest = {}, {}
    jax_flatten(jm.params, "", jarrays, jmanifest)
    arrays, manifest = params_to_numpy(tm.params)
    assert manifest == jmanifest
    for k, a in jarrays.items():
        np.testing.assert_array_equal(arrays[k], a, err_msg=k)
    prompts = [list(np.random.default_rng(i).integers(1, 512, n))
               for i, n in enumerate(PROMPT_LENS)]
    ref = _jax_last_logits(jm.config, jm.params, prompts)
    got = _port_last_logits(tm.config, tm.params, prompts)
    assert np.abs(got - ref).max() <= _TOL_ULPS * np.abs(ref).max()


def test_refusals_name_their_roadmap_items(tmp_path):
    """Each refusal names its item before a tensor is read (no tensor file
    exists): falcon's and internlm2's tables are families still to port,
    GPTQ the quantized checkpoints. phi3-mini-4k (window 2047) and qwen2
    (q/k/v bias) are ingest cases since the flags were ported, gemma3 and
    cohere since the rest of them were."""
    cases = {
        "falcon": ({**LLAMA, "model_type": "falcon", "parallel_attn": True}, r"item \[9\]"),
        "internlm2": ({**LLAMA, "model_type": "internlm2"}, r"item \[9\]"),
        "gptq": (LLAMA | {"quantization_config": {"quant_method": "gptq", "bits": 4}},
                 r"item \[10\]"),
    }
    for name, (hf, item) in cases.items():
        d = tmp_path / name
        d.mkdir()
        (d / "config.json").write_text(json.dumps(hf))  # no tensor is ever read
        with pytest.raises(NotImplementedError, match=item):
            AutoModelForCausalLM.from_pretrained(str(d), device="cpu")
    with pytest.raises(NotImplementedError, match=r"item \[10\]"):
        AutoModelForCausalLM.from_gguf(str(tmp_path / "model.gguf"))


def test_unknown_rope_scheme_raises_before_any_tensor_is_read(tmp_path, monkeypatch):
    """A rope_scaling type the JAX package does not compute raises in
    check_supported, before the reader opens a shard: a complete
    checkpoint sits beside the config, and every read fails the test."""
    d = _write_checkpoint(tmp_path / "ckpt", {**LLAMA, "rope_scaling": {
        "rope_type": "ntk-by-parts", "factor": 4.0}}, 3)

    def no_read(*a, **kw):
        raise AssertionError("a tensor was read")

    monkeypatch.setattr(hf_mod, "read_header", no_read)
    monkeypatch.setattr(hf_mod, "read_tensor", no_read)
    with pytest.raises(NotImplementedError, match="rope_scaling type 'ntk-by-parts'"):
        AutoModelForCausalLM.from_pretrained(str(d), device="cpu")
