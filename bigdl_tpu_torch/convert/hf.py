"""HuggingFace checkpoint ingest (port of bigdl_tpu/convert/hf.py).

`load_hf_checkpoint(dir, qtype)` reads a local checkpoint (`config.json`
and one `model.safetensors` or the shards of
`model.safetensors.index.json`) into the port's quantized model: the
tensors stream in layer by layer, each layer's projections are quantized
on the model's device (the card unless told otherwise) by the port's own
encoder from f32 values, as the JAX package quantizes them, and the lm
head takes the format the mixed aliases name (q4_k_m: a q6_k head).
`models.llama.merge_fused_params` then fuses qkv and gate/up. The host
and the device hold about one layer in f32 beside the model built so far.

`open_checkpoint` is the port's own safetensors reader (an 8-byte header
length, a JSON header, raw little-endian bytes): one tensor at a time,
read straight from its byte range.

The family tables are copies of the JAX package's: the llama-shaped
default (llama, mistral, qwen2, stablelm, minicpm: q/k/v and o biases
and the norms' biases where the config has them, no lm head when tied),
phi3 (fused qkv_proj and gate_up_proj, split here as the JAX package
splits them), gemma2 (four norms a layer), gemma3 (gemma2's norms and
q/k norms, under bare `model.` names or a multimodal checkpoint's
`model.language_model.` or `language_model.model.`), qwen3 (q/k norms),
phi-1/1.5/2 (one biased layernorm feeding both parallel branches,
biases everywhere), starcoder2, gpt-neox and bloom (q/k/v fused per head,
split here), cohere (one bias-free layernorm), gpt2 (Conv1D weights
stored [in, out], transposed here; learned positions), bloom's embedding
layernorm, and the experts of mixtral, qwen2-moe (with its shared expert
and q/k/v biases), qwen3-moe (q/k norms) and phixtral (phi-2 fc1/fc2
experts with their biases), each expert's weights stacked [E, ...] as
the JAX package stacks them and quantized in row chunks like any weight
(rows are independent, so the bytes are those of one call). Every
other `model_type` the JAX package's tables map raises
NotImplementedError before a tensor is read (ROADMAP queue 1 item [9]),
and so does every configuration `models.llama.check_supported` refuses.
As in the JAX package, the llama-shaped table reads no MLP biases.
GPTQ/AWQ checkpoints (a `quantization_config`) wait for item [10].
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from bigdl_tpu_torch.models.config import ModelConfig
from bigdl_tpu_torch.models.llama import (BIAS_OF, MOE_BIAS_OF, MOE_EXPERTS, MOE_SHARED,
                                          OPTIONAL_NORMS, TOP_LEAVES, DecoderLayer,
                                          LlamaModel, MoEBlock, check_supported,
                                          merge_fused_params)
from bigdl_tpu_torch.ops.linear import Linear
from bigdl_tpu_torch.quant import QTensor, concat_rows, quantize, resolve_qtype
from bigdl_tpu_torch.quant.qtypes import split_mixed_qtype
from bigdl_tpu_torch.utils import resolve_device

_QUANT_TARGETS = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                  "w_gate_e", "w_up_e", "w_down_e", "w_gate_s", "w_up_s", "w_down_s"}
# rows of a weight quantized at once hold at most this many f32 values
# (256 MiB, about a llama3-8b projection): the lm head of a 128K
# vocabulary goes in pieces, so the device holds less than a layer of f32
# values at a time (the encoders treat rows independently, so the bytes
# are those of one call)
QUANT_CHUNK = 1 << 26

Get = Callable[[str], torch.Tensor]


# ---------------------------------------------------------------------------
# per-family layer/top tensor builders
# ---------------------------------------------------------------------------

def _attention(p: str, get: Get) -> dict:
    """A layer's two norms and the attention's projections under HF's
    llama names (prefix `p`)."""
    return {
        "attn_norm": get(p + "input_layernorm.weight"),
        "mlp_norm": get(p + "post_attention_layernorm.weight"),
        "wq": get(p + "self_attn.q_proj.weight"),
        "wk": get(p + "self_attn.k_proj.weight"),
        "wv": get(p + "self_attn.v_proj.weight"),
        "wo": get(p + "self_attn.o_proj.weight"),
    }


def _llama_layer(config: ModelConfig, i: int, get: Get) -> dict:
    p = f"model.layers.{i}."
    out = {
        **_attention(p, get),
        "w_gate": get(p + "mlp.gate_proj.weight"),
        "w_up": get(p + "mlp.up_proj.weight"),
        "w_down": get(p + "mlp.down_proj.weight"),
    }
    if config.attention_bias:
        out["bq"] = get(p + "self_attn.q_proj.bias")
        out["bk"] = get(p + "self_attn.k_proj.bias")
        out["bv"] = get(p + "self_attn.v_proj.bias")
    if config.attention_out_bias:
        out["bo"] = get(p + "self_attn.o_proj.bias")
    if config.norm_bias:
        out["attn_norm_b"] = get(p + "input_layernorm.bias")
        out["mlp_norm_b"] = get(p + "post_attention_layernorm.bias")
    return out


def _llama_top(config: ModelConfig, get: Get) -> dict:
    out = {
        "embed": get("model.embed_tokens.weight"),
        "final_norm": get("model.norm.weight"),
    }
    if config.norm_bias:
        out["final_norm_b"] = get("model.norm.bias")
    if not config.tie_word_embeddings:
        out["lm_head"] = get("lm_head.weight")
    return out


def _gemma2_layer(config: ModelConfig, i: int, get: Get) -> dict:
    """gemma2's four norms a layer: post_attention_layernorm is the norm
    after attention here, pre_feedforward_layernorm the MLP's input norm."""
    p = f"model.layers.{i}."
    return {
        "attn_norm": get(p + "input_layernorm.weight"),
        "post_attn_norm": get(p + "post_attention_layernorm.weight"),
        "mlp_norm": get(p + "pre_feedforward_layernorm.weight"),
        "post_mlp_norm": get(p + "post_feedforward_layernorm.weight"),
        "wq": get(p + "self_attn.q_proj.weight"),
        "wk": get(p + "self_attn.k_proj.weight"),
        "wv": get(p + "self_attn.v_proj.weight"),
        "wo": get(p + "self_attn.o_proj.weight"),
        "w_gate": get(p + "mlp.gate_proj.weight"),
        "w_up": get(p + "mlp.up_proj.weight"),
        "w_down": get(p + "mlp.down_proj.weight"),
    }


def _gemma3_get(get: Get) -> Get:
    """Multimodal gemma3 checkpoints (4B and up) keep the text weights
    under `model.language_model.` (HF >= 4.52) or `language_model.model.`
    (the original releases); gemma3_text (1B) under bare `model.` names."""

    def g(name):
        try:
            return get(name)
        except KeyError:
            pass
        try:
            return get("model.language_" + name)
        except KeyError:
            return get("language_model." + name)

    return g


def _gemma3_layer(config: ModelConfig, i: int, get: Get) -> dict:
    """gemma2's four norms a layer and the per-head q/k RMSNorm."""
    g = _gemma3_get(get)
    out = _gemma2_layer(config, i, g)
    p = f"model.layers.{i}."
    out["q_norm"] = g(p + "self_attn.q_norm.weight")
    out["k_norm"] = g(p + "self_attn.k_norm.weight")
    return out


def _gemma3_top(config: ModelConfig, get: Get) -> dict:
    return _llama_top(config, _gemma3_get(get))


def _qwen3_layer(config: ModelConfig, i: int, get: Get) -> dict:
    """Qwen3: llama names + per-head q/k RMSNorm weights."""
    out = _llama_layer(config, i, get)
    p = f"model.layers.{i}."
    out["q_norm"] = get(p + "self_attn.q_norm.weight")
    out["k_norm"] = get(p + "self_attn.k_norm.weight")
    return out


def _phi3_layer(config: ModelConfig, i: int, get: Get) -> dict:
    """phi3 ships fused qkv_proj [QD+2*KD, H] and gate_up_proj [2I, H];
    split for the unfused layout (merge_fused_params fuses them again)."""
    p = f"model.layers.{i}."
    qkv = get(p + "self_attn.qkv_proj.weight")
    QD, KD = config.q_dim, config.kv_dim
    gate_up = get(p + "mlp.gate_up_proj.weight")
    I = gate_up.shape[0] // 2
    return {
        "attn_norm": get(p + "input_layernorm.weight"),
        "mlp_norm": get(p + "post_attention_layernorm.weight"),
        "wq": qkv[:QD],
        "wk": qkv[QD:QD + KD],
        "wv": qkv[QD + KD:],
        "wo": get(p + "self_attn.o_proj.weight"),
        "w_gate": gate_up[:I],
        "w_up": gate_up[I:],
        "w_down": get(p + "mlp.down_proj.weight"),
    }


def _starcoder2_layer(config: ModelConfig, i: int, get: Get) -> dict:
    """starcoder2: biased layernorms, biased q/k/v/o, a plain c_fc ->
    act -> c_proj MLP with biases."""
    p = f"model.layers.{i}."
    return {
        "attn_norm": get(p + "input_layernorm.weight"),
        "attn_norm_b": get(p + "input_layernorm.bias"),
        "mlp_norm": get(p + "post_attention_layernorm.weight"),
        "mlp_norm_b": get(p + "post_attention_layernorm.bias"),
        "wq": get(p + "self_attn.q_proj.weight"),
        "wk": get(p + "self_attn.k_proj.weight"),
        "wv": get(p + "self_attn.v_proj.weight"),
        "wo": get(p + "self_attn.o_proj.weight"),
        "bq": get(p + "self_attn.q_proj.bias"),
        "bk": get(p + "self_attn.k_proj.bias"),
        "bv": get(p + "self_attn.v_proj.bias"),
        "bo": get(p + "self_attn.o_proj.bias"),
        "w_up": get(p + "mlp.c_fc.weight"),
        "b_up": get(p + "mlp.c_fc.bias"),
        "w_down": get(p + "mlp.c_proj.weight"),
        "b_down": get(p + "mlp.c_proj.bias"),
    }


def _gpt2_layer(config: ModelConfig, i: int, get: Get) -> dict:
    """GPT-2 stores its linears as Conv1D ([in, out], transposed here)
    with a fused c_attn [in, 3H]."""
    p = f"transformer.h.{i}."
    H = config.hidden_size
    c_attn = get(p + "attn.c_attn.weight").T  # [3H, H]
    b_attn = get(p + "attn.c_attn.bias")
    return {
        "attn_norm": get(p + "ln_1.weight"),
        "attn_norm_b": get(p + "ln_1.bias"),
        "mlp_norm": get(p + "ln_2.weight"),
        "mlp_norm_b": get(p + "ln_2.bias"),
        "wq": c_attn[:H], "wk": c_attn[H:2 * H], "wv": c_attn[2 * H:],
        "bq": b_attn[:H], "bk": b_attn[H:2 * H], "bv": b_attn[2 * H:],
        "wo": get(p + "attn.c_proj.weight").T,
        "bo": get(p + "attn.c_proj.bias"),
        "w_up": get(p + "mlp.c_fc.weight").T,
        "b_up": get(p + "mlp.c_fc.bias"),
        "w_down": get(p + "mlp.c_proj.weight").T,
        "b_down": get(p + "mlp.c_proj.bias"),
    }


def _gpt2_top(config: ModelConfig, get: Get) -> dict:
    return {
        "embed": get("transformer.wte.weight"),
        "wpe": get("transformer.wpe.weight"),
        "final_norm": get("transformer.ln_f.weight"),
        "final_norm_b": get("transformer.ln_f.bias"),
    }


def _split_headwise_qkv(fused: torch.Tensor, n_heads: int, head_dim: int):
    """[heads * 3 * D, H] fused per head (bloom's and gpt-neox's
    query_key_value) -> (q, k, v), each [heads * D, H]."""
    H_in = fused.shape[-1]
    g = fused.reshape(n_heads, 3, head_dim, H_in)
    return tuple(g[:, j].reshape(-1, H_in) for j in range(3))


def _headwise_layer(config: ModelConfig, get: Get, p: str, attn: str) -> dict:
    """bloom's and gpt-neox's layer under prefix `p`, the attention's
    module `attn`: biased layernorms, query_key_value split per head,
    dense, and dense_h_to_4h -> act -> dense_4h_to_h, all biased."""
    D, nh = config.head_dim_, config.num_attention_heads
    wq, wk, wv = _split_headwise_qkv(get(p + attn + ".query_key_value.weight"), nh, D)
    bq, bk, bv = (b.reshape(-1) for b in _split_headwise_qkv(
        get(p + attn + ".query_key_value.bias").reshape(-1, 1), nh, D))
    return {
        "attn_norm": get(p + "input_layernorm.weight"),
        "attn_norm_b": get(p + "input_layernorm.bias"),
        "mlp_norm": get(p + "post_attention_layernorm.weight"),
        "mlp_norm_b": get(p + "post_attention_layernorm.bias"),
        "wq": wq, "wk": wk, "wv": wv, "bq": bq, "bk": bk, "bv": bv,
        "wo": get(p + attn + ".dense.weight"),
        "bo": get(p + attn + ".dense.bias"),
        "w_up": get(p + "mlp.dense_h_to_4h.weight"),
        "b_up": get(p + "mlp.dense_h_to_4h.bias"),
        "w_down": get(p + "mlp.dense_4h_to_h.weight"),
        "b_down": get(p + "mlp.dense_4h_to_h.bias"),
    }


def _bloom_layer(config: ModelConfig, i: int, get: Get) -> dict:
    return _headwise_layer(config, get, f"transformer.h.{i}.", "self_attention")


def _bloom_top(config: ModelConfig, get: Get) -> dict:
    return {
        "embed": get("transformer.word_embeddings.weight"),
        "embed_norm": get("transformer.word_embeddings_layernorm.weight"),
        "embed_norm_b": get("transformer.word_embeddings_layernorm.bias"),
        "final_norm": get("transformer.ln_f.weight"),
        "final_norm_b": get("transformer.ln_f.bias"),
    }


def _gptneox_layer(config: ModelConfig, i: int, get: Get) -> dict:
    return _headwise_layer(config, get, f"gpt_neox.layers.{i}.", "attention")


def _gptneox_top(config: ModelConfig, get: Get) -> dict:
    out = {
        "embed": get("gpt_neox.embed_in.weight"),
        "final_norm": get("gpt_neox.final_layer_norm.weight"),
        "final_norm_b": get("gpt_neox.final_layer_norm.bias"),
    }
    if not config.tie_word_embeddings:
        out["lm_head"] = get("embed_out.weight")
    return out


def _phi_layer(config: ModelConfig, i: int, get: Get) -> dict:
    """phi-1/1.5/2: the parallel attention and MLP read the SAME input
    layernorm, which fills both norm slots; fc1/fc2 and dense, all
    biased."""
    p = f"model.layers.{i}."
    ln_w = get(p + "input_layernorm.weight")
    ln_b = get(p + "input_layernorm.bias")
    return {
        "attn_norm": ln_w, "attn_norm_b": ln_b,
        "mlp_norm": ln_w, "mlp_norm_b": ln_b,
        "wq": get(p + "self_attn.q_proj.weight"),
        "bq": get(p + "self_attn.q_proj.bias"),
        "wk": get(p + "self_attn.k_proj.weight"),
        "bk": get(p + "self_attn.k_proj.bias"),
        "wv": get(p + "self_attn.v_proj.weight"),
        "bv": get(p + "self_attn.v_proj.bias"),
        "wo": get(p + "self_attn.dense.weight"),
        "bo": get(p + "self_attn.dense.bias"),
        "w_up": get(p + "mlp.fc1.weight"),
        "b_up": get(p + "mlp.fc1.bias"),
        "w_down": get(p + "mlp.fc2.weight"),
        "b_down": get(p + "mlp.fc2.bias"),
    }


def _phi_top(config: ModelConfig, get: Get) -> dict:
    out = {
        "embed": get("model.embed_tokens.weight"),
        "final_norm": get("model.final_layernorm.weight"),
        "final_norm_b": get("model.final_layernorm.bias"),
    }
    if not config.tie_word_embeddings:
        out["lm_head"] = get("lm_head.weight")
        out["lm_head_b"] = get("lm_head.bias")
    return out


def _cohere_layer(config: ModelConfig, i: int, get: Get) -> dict:
    """cohere: one bias-free layernorm feeds both parallel branches."""
    p = f"model.layers.{i}."
    ln = get(p + "input_layernorm.weight")
    out = {
        "attn_norm": ln, "mlp_norm": ln,
        "wq": get(p + "self_attn.q_proj.weight"),
        "wk": get(p + "self_attn.k_proj.weight"),
        "wv": get(p + "self_attn.v_proj.weight"),
        "wo": get(p + "self_attn.o_proj.weight"),
        "w_gate": get(p + "mlp.gate_proj.weight"),
        "w_up": get(p + "mlp.up_proj.weight"),
        "w_down": get(p + "mlp.down_proj.weight"),
    }
    if config.attention_bias:
        out["bq"] = get(p + "self_attn.q_proj.bias")
        out["bk"] = get(p + "self_attn.k_proj.bias")
        out["bv"] = get(p + "self_attn.v_proj.bias")
    return out


def _experts(config: ModelConfig, p: str, get: Get, names: tuple[str, str, str]) -> dict:
    """The experts' gate, up and down weights (HF's `names` under `p` +
    "experts.{e}."), each stacked [E, rows, cols]."""
    return {leaf: torch.stack([get(f"{p}experts.{e}.{n}.weight")
                               for e in range(config.num_experts)])
            for leaf, n in zip(("w_gate_e", "w_up_e", "w_down_e"), names)}


def _mixtral_layer(config: ModelConfig, i: int, get: Get) -> dict:
    """mixtral's block_sparse_moe: the router `gate`, experts w1 (gate),
    w3 (up) and w2 (down)."""
    p = f"model.layers.{i}."
    return {**_attention(p, get), "router": get(p + "block_sparse_moe.gate.weight"),
            **_experts(config, p + "block_sparse_moe.", get, ("w1", "w3", "w2"))}


def _qwen2_moe_layer(config: ModelConfig, i: int, get: Get) -> dict:
    """qwen2-moe: q/k/v biases, the router `mlp.gate`, the experts, and
    the shared expert with its sigmoid gate `shared_expert_gate`."""
    p = f"model.layers.{i}."
    return {
        **_attention(p, get),
        "bq": get(p + "self_attn.q_proj.bias"),
        "bk": get(p + "self_attn.k_proj.bias"),
        "bv": get(p + "self_attn.v_proj.bias"),
        "router": get(p + "mlp.gate.weight"),
        **_experts(config, p + "mlp.", get, ("gate_proj", "up_proj", "down_proj")),
        "w_gate_s": get(p + "mlp.shared_expert.gate_proj.weight"),
        "w_up_s": get(p + "mlp.shared_expert.up_proj.weight"),
        "w_down_s": get(p + "mlp.shared_expert.down_proj.weight"),
        "shared_gate": get(p + "mlp.shared_expert_gate.weight"),
    }


def _phixtral_layer(config: ModelConfig, i: int, get: Get) -> dict:
    """phixtral (the legacy mixformer names): one shared biased
    layernorm, a fused mixer.Wqkv, and a router over phi-2's fc1/fc2
    experts (moe.mlp.{e}), each with its biases."""
    p = f"transformer.h.{i}."
    H = config.hidden_size
    ln_w = get(p + "ln.weight")
    ln_b = get(p + "ln.bias")
    wqkv = get(p + "mixer.Wqkv.weight")  # [3H, H]
    bqkv = get(p + "mixer.Wqkv.bias")
    out = {
        "attn_norm": ln_w, "attn_norm_b": ln_b,
        "mlp_norm": ln_w, "mlp_norm_b": ln_b,
        "wq": wqkv[:H], "wk": wqkv[H:2 * H], "wv": wqkv[2 * H:],
        "bq": bqkv[:H], "bk": bqkv[H:2 * H], "bv": bqkv[2 * H:],
        "wo": get(p + "mixer.out_proj.weight"),
        "bo": get(p + "mixer.out_proj.bias"),
        "router": get(p + "moe.gate.weight"),
    }
    for leaf, n in (("w_up_e", "fc1.weight"), ("b_up_e", "fc1.bias"),
                    ("w_down_e", "fc2.weight"), ("b_down_e", "fc2.bias")):
        out[leaf] = torch.stack([get(f"{p}moe.mlp.{e}.{n}") for e in range(config.num_experts)])
    return out


def _phixtral_top(config: ModelConfig, get: Get) -> dict:
    return {
        "embed": get("transformer.embd.wte.weight"),
        "final_norm": get("lm_head.ln.weight"),
        "final_norm_b": get("lm_head.ln.bias"),
        "lm_head": get("lm_head.linear.weight"),
        "lm_head_b": get("lm_head.linear.bias"),
    }


def _qwen3_moe_layer(config: ModelConfig, i: int, get: Get) -> dict:
    """qwen3-moe: qwen3's q/k norms, the router `mlp.gate` and the experts."""
    p = f"model.layers.{i}."
    return {
        **_attention(p, get),
        "q_norm": get(p + "self_attn.q_norm.weight"),
        "k_norm": get(p + "self_attn.k_norm.weight"),
        "router": get(p + "mlp.gate.weight"),
        **_experts(config, p + "mlp.", get, ("gate_proj", "up_proj", "down_proj")),
    }


_FAMILY_LAYER = {"phi3": _phi3_layer, "gemma2": _gemma2_layer, "gemma3": _gemma3_layer,
                 "gemma3_text": _gemma3_layer, "qwen3": _qwen3_layer,
                 "starcoder2": _starcoder2_layer, "gpt2": _gpt2_layer,
                 "bloom": _bloom_layer, "gpt_neox": _gptneox_layer, "phi": _phi_layer,
                 "cohere": _cohere_layer, "mixtral": _mixtral_layer,
                 "qwen2_moe": _qwen2_moe_layer, "qwen3_moe": _qwen3_moe_layer,
                 "phixtral": _phixtral_layer}
_FAMILY_TOP = {"gemma3": _gemma3_top, "gemma3_text": _gemma3_top, "gpt2": _gpt2_top,
               "bloom": _bloom_top, "gpt_neox": _gptneox_top, "phi": _phi_top,
               "phixtral": _phixtral_top}

# model_types with their own layer or tree builders in the JAX package's
# tables (bigdl_tpu/convert/hf.py `_FAMILY_LAYER`, `_FAMILY_TOP`, the mllama
# and deepseek trees) that this port's tables do not hold yet: each
# family's own modules (MLA, rwkv, the VL and audio towers, mllama's
# cross-attention) or weight layouts (fused W_pack, grouped wqkv, falcon's
# query_key_value) are ROADMAP queue 1 item [9]
_ZOO = frozenset({
    "phi3_v", "baichuan", "internlm2", "internlmxcomposer2", "glm", "chatglm", "chatglm4v",
    "qwen2_vl", "mpt", "rwkv", "rwkv5", "falcon", "yuan", "minicpmv", "minicpmo", "megrezo",
    "qwen2_audio", "internvl", "janus", "qwen", "deci", "gpt_bigcode", "baichuan_m1",
    "mllama", "mllama_text_model", "deepseek_v2", "deepseek_v3", "minicpm3",
})


def check_family(config: ModelConfig) -> None:
    """Raise NotImplementedError, naming its ROADMAP item, for a checkpoint
    this port cannot ingest yet: a family whose tables are not ported
    (item [9]), then any configuration `check_supported` refuses (a
    family's own fields, item [9])."""
    mt = config.model_type
    if mt in _ZOO:
        raise NotImplementedError(
            f"HF ingest of model_type {mt!r}: ROADMAP queue 1 item [9], the rest "
            "of the zoo is still to be ported (the port's tables hold the "
            f"llama-shaped default and {sorted(_FAMILY_LAYER)})")
    try:
        check_supported(config)
    except NotImplementedError as e:
        raise NotImplementedError(f"HF ingest of model_type {mt!r}: {e}") from None


def layer_tensors(config: ModelConfig, i: int, get: Get) -> dict:
    return _FAMILY_LAYER.get(config.model_type, _llama_layer)(config, i, get)


def top_tensors(config: ModelConfig, get: Get) -> dict:
    return _FAMILY_TOP.get(config.model_type, _llama_top)(config, get)


# ---------------------------------------------------------------------------
# model assembly
# ---------------------------------------------------------------------------

def params_from_state_dict(config: ModelConfig, get_tensor: Get, qtype: str = "sym_int4",
                           dtype=torch.bfloat16, lm_head_qtype: Optional[str] = None,
                           device=None) -> LlamaModel:
    """The port's model from an HF tensor-name accessor, on `device`: each
    layer's projections quantized as its tensors stream in (f32 values on
    the device, the port's encoder), dense leaves in `dtype`, the lm head
    in `lm_head_qtype`, else the head format a mixed alias names, else
    `qtype`; then qkv and gate/up fused (`merge_fused_params`)."""
    check_family(config)
    dev = resolve_device(device)
    qtype, head_default = split_mixed_qtype(qtype)
    lm_head_qtype = lm_head_qtype or head_default
    spec = resolve_qtype(qtype)
    head_spec = resolve_qtype(lm_head_qtype) if lm_head_qtype else spec

    def maybe_quant(name: str, t: torch.Tensor):
        use = head_spec if name == "lm_head" else spec
        if not use.is_dense and (name in _QUANT_TARGETS or name == "lm_head"):
            flat = t.reshape(-1, t.shape[-1])  # the experts' [E, rows, cols] as rows
            rows = max(1, QUANT_CHUNK // t.shape[-1])
            parts = [quantize(flat[i:i + rows].to(dev).float(), use.name)
                     for i in range(0, flat.shape[0], rows)]
            qt = parts[0] if len(parts) == 1 else concat_rows(parts)
            return QTensor(qtype=qt.qtype, **{f: a.reshape(*t.shape[:-1], *a.shape[1:])
                                              for f, a in qt.fields().items()})
        # a fresh contiguous copy: phi's one layernorm fills two slots,
        # gpt2's transposed weights are views
        return t.to(device=dev, dtype=dtype, memory_format=torch.contiguous_format, copy=True)

    layers = []
    for i in range(config.num_hidden_layers):
        d = {k: maybe_quant(k, v) for k, v in layer_tensors(config, i, get_tensor).items()}
        norms = d.pop("attn_norm"), d.pop("mlp_norm")
        extra = {n: d.pop(n) for n in OPTIONAL_NORMS if n in d}
        moe = None
        if "router" in d:
            moe = MoEBlock(d.pop("router"), {
                n: Linear(d.pop(n), d.pop(MOE_BIAS_OF.get(n, ""), None))
                for n in list(d) if n in MOE_EXPERTS + MOE_SHARED}, d.pop("shared_gate", None))
        biases = {n: d.pop(BIAS_OF[n], None) for n in list(d) if n in BIAS_OF}
        layers.append(DecoderLayer(*norms, {k: Linear(v, biases[k]) for k, v in d.items()},
                                   moe, **extra))
    top = {k: maybe_quant(k, v) for k, v in top_tensors(config, get_tensor).items()}
    head = Linear(top["lm_head"], top.get("lm_head_b")) if "lm_head" in top else None
    model = LlamaModel(top["embed"], layers, top["final_norm"], head,
                       **{n: top[n] for n in TOP_LEAVES if n in top})
    return merge_fused_params(model, config)


# ---------------------------------------------------------------------------
# the safetensors reader
# ---------------------------------------------------------------------------

# safetensors dtype names -> torch dtypes (stored little-endian)
_ST_DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32, "F64": torch.float64,
    "I8": torch.int8, "I16": torch.int16, "I32": torch.int32, "I64": torch.int64,
    "U8": torch.uint8, "BOOL": torch.bool,
    "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
}


def read_header(path: str) -> tuple[dict, int]:
    """(tensors, data offset) of one safetensors file: {name: {"dtype",
    "shape", "data_offsets"}} from its JSON header (the "__metadata__"
    entry dropped) and the byte where the tensor data starts."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def read_tensor(path: str, entry: dict, base: int) -> torch.Tensor:
    """One tensor of a safetensors file, read from its byte range into a
    fresh CPU tensor of its stored dtype and shape."""
    dt = entry["dtype"]
    if dt not in _ST_DTYPES:
        raise NotImplementedError(f"safetensors dtype {dt} is not read by this port")
    b, e = entry["data_offsets"]
    buf = np.empty(e - b, np.uint8)
    with open(path, "rb") as f:
        f.seek(base + b)
        if f.readinto(memoryview(buf)) != e - b:
            raise ValueError(f"{path}: truncated tensor data ({e - b} bytes expected)")
    t = torch.from_numpy(buf)
    if e > b:
        t = t.view(_ST_DTYPES[dt])
    else:
        t = torch.empty(0, dtype=_ST_DTYPES[dt])
    return t.reshape(entry["shape"])


def open_checkpoint(model_path: str) -> Get:
    """Tensor getter over a local safetensors checkpoint directory (one
    `model.safetensors` or the shards of `model.safetensors.index.json`):
    name -> CPU tensor in its stored dtype, read one at a time. A missing
    `lm_head.weight` falls back to `model.embed_tokens.weight` (checkpoints
    that tie without the flag)."""
    index_path = os.path.join(model_path, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            weight_map = json.load(f)["weight_map"]
    else:
        header, _ = read_header(os.path.join(model_path, "model.safetensors"))
        weight_map = {k: "model.safetensors" for k in header}
    headers: dict[str, tuple[dict, int]] = {}

    def get_tensor(name: str) -> torch.Tensor:
        if name not in weight_map and name == "lm_head.weight":
            name = "model.embed_tokens.weight"
        if name not in weight_map:
            raise KeyError(
                f"checkpoint at {model_path} has no tensor {name!r} "
                f"({len(weight_map)} tensors present) — incomplete "
                "download, or a layout this translation doesn't cover?")
        shard = weight_map[name]
        if shard not in headers:
            headers[shard] = read_header(os.path.join(model_path, shard))
        header, base = headers[shard]
        return read_tensor(os.path.join(model_path, shard), header[name], base)

    return get_tensor


def load_hf_checkpoint(model_path: str, qtype: str = "sym_int4", dtype=torch.bfloat16,
                       config: Optional[ModelConfig] = None,
                       device=None) -> tuple[ModelConfig, LlamaModel, str]:
    """An HF-format local checkpoint directory (config.json + safetensors)
    as (config, model, qtype), the model quantized on `device` (the card
    unless told otherwise) and fused."""
    with open(os.path.join(model_path, "config.json")) as f:
        hf_config = json.load(f)
    if hf_config.get("quantization_config"):
        raise NotImplementedError(
            "HF ingest of a GPTQ/AWQ checkpoint (quantization_config): ROADMAP "
            "queue 1 item [10], autoq.py is still to be ported")
    if config is None:
        config = ModelConfig.from_hf_config(hf_config)
    check_family(config)  # before a byte of the checkpoint is read
    model = params_from_state_dict(config, open_checkpoint(model_path), qtype, dtype,
                                   device=device)
    return config, model, qtype
