"""Llama-family decoder (port of bigdl_tpu/models/llama.py) for every
family the JAX package runs on it: llama, mistral, qwen2, qwen3, gemma2,
gemma3 and phi3; phi-1/1.5/2, starcoder2, stablelm, gpt-neox, cohere,
gpt2, bloom and minicpm; the mixture-of-experts ones (mixtral,
qwen2-moe, qwen3-moe, phixtral) and the ALiBi and logn attention of
baichuan-13b and qwen v1 — GQA, RMSNorm (gemma's (1 + w) too) or
LayerNorm with or without bias, a gated or a plain fc -> act -> proj MLP
with silu, gelu or relu, the three bias flags and the lm head's, tied
embeddings, qk-norm, sliding windows (uniform, alternating or listed per
layer), gemma2's softcaps, attention scale, post-norms, the embedding
scales, minicpm's residual and logit scales, cohere's logit scale,
parallel residuals (attention and MLP read the same layer input), gpt2's
learned positions, bloom's embedding layernorm, partial and interleaved
rope, gemma3's local rope (its sliding layers rotate at their own base,
unscaled) and every rope-scaling scheme of the JAX package.

The JAX package keeps parameters as a pytree with layers stacked for
`lax.scan`; here they are modules — `LlamaModel` holds the embedding,
one `DecoderLayer` per layer (norm weights and biases, projections as
`ops.linear.Linear` keyed by the JAX leaf names, each with its bias), the
final norm, the optional top-level leaves of `TOP_LEAVES` and the lm
head with its bias, absent when tied — and `forward` walks the layers in
a Python loop; an MoE layer holds its experts in a `MoEBlock` instead of
the MLP's projections. The embedding, the norms, the biases and
every dense projection are parameters that require no gradient until
`make_trainable` turns them on (the full fine-tune, train/recipes.py);
quantized projections stay buffers. `forward` runs both layouts, as
JAX's does: the fused one (wqkv, w_gateup, their biases concatenated)
that `optimize_model` makes, and the unfused one (wq/wk/wv, w_gate/w_up)
of `init_params`, which the full fine-tune trains. A field of a family
with modules of its own (MLA, rwkv, mllama, the VL and audio towers)
raises `NotImplementedError` naming its ROADMAP item (`check_supported`).

Attention follows JAX's dispatch, layer by layer (`attention_route`): a
prefill (T > 1) over a cache with one position for all rows (generate,
the serving engine's 1-row prefill) and one window for every layer goes
through the flash kernel, its fp8 arm for an fp8 cache; a one-token
decode over a paged cache through the paged kernel, which reads the pool
in place, with the layer's window; the cache-free path (training,
scoring) at T > 1 through the differentiable flash kernels (forward with
logsumexp, dQ, dK/dV) unless the windows alternate or the scores are
softcapped. Every other call — decode over a dense cache, calls with
per-row positions such as the engine's paged prefill, gemma2's prefill
and training — goes through the plain masked attention, over the full
cache [0, max_len) (`kvcache.read_layer`'s dense view) under the layer's
mask from (start, pos): causal, and for a sliding layer k_slot > q_slot
- window. Without a cache query t of row b sits at slot t with position
max(t - start[b], 0). An ALiBi model takes the plain attention on every
route (JAX's rule): no rope, and the masks become a float bias, the
head's slope times (k_slot - q_slot), -1e30 where masked; logn scales q
by max(1, log(position + 1) / log(logn_train_len)) after rope on every
route, so the kernels take the scaled q. `remat=True` recomputes each
layer in the backward instead of keeping its activations (JAX's
`jax.checkpoint` around the scan body). Every path takes LoRA adapters
(`lora=`: a
`train.qlora.LoRA`, or JAX's {"layers": {target: {"a", "b"}}, "scale"}
tree, shared — a [L, r, in], b [L, out, r], scalar scale — or batched per
row, as the serving engine's decode step gathers them — a [L, B, rb, in],
b [L, B, out, rb], scale [B]): the q/k/v and gate/up deltas apply as
`lora_epilogue` on the fused projections' slices, wo and w_down pass
theirs to `linear`, which folds them into the fused kernel's writeback
where JAX's eligibility rule admits the width.

The experts' products are plain torch, as JAX leaves them to XLA: each
expert weight is dequantized (`QTensor.dequantize`), then `einsum`s run
(`_moe_mlp`): top-k routing on float32 softmax weights, then either the
dense combine (every expert computes every token) or the capacity
dispatch ("ragged": each expert its routed tokens up to capacity C, the
overflow dropped), chosen by `resolve_moe_dispatch`, and qwen2-moe's
shared expert behind its sigmoid gate. phixtral's experts are plain fc ->
act -> proj with a bias on each (`b_up_e`, `b_down_e`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from bigdl_tpu_torch import kvcache
from bigdl_tpu_torch.embedding import HostEmbedding, embed_lookup
from bigdl_tpu_torch.kvcache import KVCache
from bigdl_tpu_torch.kvpaged import PagedKVCache
from bigdl_tpu_torch.models.config import ModelConfig
from bigdl_tpu_torch.ops import (Linear, apply_rotary_emb, attention, kernels,
                                 layer_norm, linear, rms_norm, rope_cos_sin)
from bigdl_tpu_torch.ops.attention import _NEG_INF
from bigdl_tpu_torch.ops.linear import lora_epilogue
from bigdl_tpu_torch.ops.rope import alibi_slopes, check_rope_scaling, make_inv_freq_scaled
from bigdl_tpu_torch.quant import QTensor, concat_rows, quantize_or_dense
from bigdl_tpu_torch.quant.qtypes import resolve_qtype, split_mixed_qtype
from bigdl_tpu_torch.utils import resolve_device

# ModelConfig fields the port runs at any value; `hidden_act` and
# `rope_scaling` are checked by value, and every other field must keep
# its default
_SUPPORTED_FIELDS = frozenset({
    "model_type", "vocab_size", "hidden_size", "intermediate_size",
    "num_hidden_layers", "num_attention_heads", "num_key_value_heads",
    "head_dim", "rms_norm_eps", "rope_theta", "max_position_embeddings",
    "tie_word_embeddings", "attention_bias", "attention_out_bias", "mlp_bias",
    "sliding_window", "sliding_window_pattern", "attn_logit_softcap",
    "final_logit_softcap", "attn_scale", "post_attn_norm", "rms_norm_offset",
    "scale_embeddings", "qk_norm", "alibi", "alibi_scale", "logn_attn",
    "logn_train_len", "sliding_layers", "rope_local_theta", "norm_type", "norm_bias",
    "parallel_residual", "partial_rotary_factor", "rope_interleaved", "learned_positions",
    "embed_layernorm", "gated_mlp", "embedding_scale", "residual_scale", "logit_scale",
    "lm_head_bias",
})
# JAX's `_act` (bigdl_tpu/models/llama.py:282-291)
ACTIVATIONS = ("silu", "gelu", "gelu_new", "gelu_pytorch_tanh", "gelu_tanh", "relu")
# the MoE group (mixtral, qwen2-moe, qwen3-moe; phixtral's non-gated,
# biased experts under gated_mlp=False and mlp_bias)
_MOE_FIELDS = frozenset({
    "num_experts", "num_experts_per_tok", "moe_intermediate_size",
    "shared_expert_intermediate_size", "norm_topk_prob", "moe_dispatch",
    "moe_capacity_factor",
})
# fields of families with their own modules (MLA, rwkv, mllama, the VL and
# audio towers): ROADMAP queue 1 item [9]
_FAMILY_FIELDS = frozenset({
    "cross_attention_layers", "q_lora_rank", "kv_lora_rank", "qk_nope_head_dim",
    "qk_rope_head_dim", "v_head_dim", "n_group", "topk_group", "topk_method",
    "scoring_func", "routed_scaling_factor", "first_k_dense_replace",
    "n_shared_experts", "attention_hidden_size", "rwkv_head_size",
    "rwkv_group_norm_eps", "mrope_section", "image_token_id", "video_token_id",
    "vision_start_token_id", "audio_token_id", "audio_pool_step",
})
_DEFAULTS = ModelConfig()


def check_supported(config: ModelConfig) -> None:
    """Raise NotImplementedError for a config field the port does not
    run: a family's own fields (item [9]); a rope-scaling scheme or an
    activation the JAX package does not compute raises too. Called
    before any weight is made or read. Every other `ModelConfig` field
    runs at any value (`_SUPPORTED_FIELDS`, `_MOE_FIELDS`)."""
    for f in dataclasses.fields(ModelConfig):
        name, value = f.name, getattr(config, f.name)
        if (name in _SUPPORTED_FIELDS or name in _MOE_FIELDS
                or value == getattr(_DEFAULTS, name)):
            continue
        if name == "rope_scaling":
            check_rope_scaling(config.rope_scaling_dict)
            continue
        if name == "hidden_act":
            if value in ACTIVATIONS:
                continue
            raise NotImplementedError(
                f"hidden_act {value!r}: the JAX package computes {ACTIVATIONS} only")
        raise NotImplementedError(
            f"llama forward with {name}={value!r}: ROADMAP queue 1 item [9], the rest "
            "of the zoo is still to be ported")


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# per-layer norm leaves beyond attn_norm/mlp_norm, each held when its
# flag is on: the two norms' biases (norm_bias), gemma2's post-norms
# (post_attn_norm) and qk-norm's [D] pair
OPTIONAL_NORMS = ("attn_norm_b", "mlp_norm_b", "post_attn_norm", "post_mlp_norm", "q_norm",
                  "k_norm")
# the model's top-level leaves beyond embed/final_norm, each held when its
# flag is on: the final norm's bias (norm_bias), gpt2's learned positions
# `wpe` [max_position_embeddings, H], bloom's embedding layernorm
TOP_LEAVES = ("final_norm_b", "wpe", "embed_norm", "embed_norm_b")
# a projection's bias under JAX's leaf names (each Linear holds its own)
BIAS_OF = {"wq": "bq", "wk": "bk", "wv": "bv", "wo": "bo", "w_gate": "b_gate",
           "w_up": "b_up", "w_down": "b_down", "wqkv": "bqkv", "w_gateup": "b_gateup"}


# an MoE layer's expert weights under JAX's leaf names, quantized as its
# `_QUANT_TARGETS` are: the experts stacked [E, EI, H] (w_down_e
# [E, H, EI]; no w_gate_e when the experts are not gated: phixtral) and
# qwen2-moe's shared expert [S, H] (w_down_s [H, S]); the router [E, H]
# and the shared expert's gate [1, H] stay dense, and so do phixtral's
# expert biases b_up_e [E, EI] and b_down_e [E, H], held by their
# experts' Linears
MOE_EXPERTS = ("w_gate_e", "w_up_e", "w_down_e")
MOE_SHARED = ("w_gate_s", "w_up_s", "w_down_s")
MOE_BIAS_OF = {"w_up_e": "b_up_e", "w_down_e": "b_down_e"}
# JAX's init_params makes the dense MLP's biases beside experts under
# mlp_bias, and its MoE forward reads none of them: a MoEBlock carries
# them (`unused`), so that the tree and its artifact stay JAX's
MOE_UNUSED = ("b_gate", "b_up", "b_down")
MOE_LEAVES = (("router",) + MOE_EXPERTS + MOE_SHARED + ("shared_gate",)
              + tuple(MOE_BIAS_OF.values()) + MOE_UNUSED)


class MoEBlock(nn.Module):
    """A layer's mixture-of-experts MLP: the dense `router` [E, H], the
    expert weights in `proj` (`MOE_EXPERTS`, without w_gate_e for
    non-gated experts, and `MOE_SHARED` with qwen2-moe's shared expert),
    each held by an `ops.linear.Linear` as a dense tensor or a QTensor
    (w_up_e and w_down_e with their biases where the experts have them),
    `shared_gate` [1, H] beside a shared expert (None otherwise) and the
    `MOE_UNUSED` biases given. `_moe_mlp` computes with `leaves()`."""

    def __init__(self, router: torch.Tensor, proj: dict[str, Linear],
                 shared_gate: Optional[torch.Tensor] = None, **unused: torch.Tensor):
        super().__init__()
        experts = set(proj) - set(MOE_SHARED)
        shared = set(proj) & set(MOE_SHARED)
        if (experts not in (set(MOE_EXPERTS), set(MOE_EXPERTS[1:]))
                or shared not in (set(), set(MOE_SHARED))
                or bool(shared) != (shared_gate is not None)
                or set(unused) - set(MOE_UNUSED)):
            raise ValueError(f"MoEBlock: projections {sorted(proj)} with "
                             f"{'a' if shared_gate is not None else 'no'} shared gate and "
                             f"{sorted(unused)}; want {MOE_EXPERTS} (w_gate_e optional), "
                             f"plus {MOE_SHARED} and shared_gate, and some of {MOE_UNUSED}")
        self.router = _frozen(router)
        self.proj = nn.ModuleDict(proj)
        for name, t in (("shared_gate", shared_gate),) + tuple(
                (n, unused.get(n)) for n in MOE_UNUSED):
            if t is None:
                self.register_parameter(name, None)
            else:
                setattr(self, name, _frozen(t))

    def unused(self) -> dict:
        return {n: getattr(self, n) for n in MOE_UNUSED if getattr(self, n) is not None}

    def leaves(self) -> dict:
        """{JAX leaf name: tensor or QTensor} of the present leaves."""
        out = {"router": self.router, **{n: lin.w for n, lin in self.proj.items()}}
        out.update({b: self.proj[n].bias for n, b in MOE_BIAS_OF.items()
                    if n in self.proj and self.proj[n].bias is not None})
        if self.shared_gate is not None:
            out["shared_gate"] = self.shared_gate
        return {**out, **self.unused()}

    def copy(self) -> "MoEBlock":
        """A new block holding the same weights (`quantized_copy`)."""
        return MoEBlock(self.router, dict(self.proj.items()), self.shared_gate, **self.unused())


class DecoderLayer(nn.Module):
    """One decoder layer's weights: the `attn_norm`/`mlp_norm` weights,
    the projections in `proj` — wq/wk/wv, wo, w_gate/w_up, w_down as
    `init_params` makes them, wqkv, wo, w_gateup, w_down after
    `merge_fused_params` (no w_gate or w_gateup in a plain fc -> act ->
    proj MLP: w_up, w_down) — each with its bias where the config has
    one, and the `OPTIONAL_NORMS` the config's flags ask for, the norms'
    biases among them (None otherwise). An MoE layer's `proj` holds the
    attention's projections only and `moe` its experts (None in a dense
    layer)."""

    def __init__(self, attn_norm: torch.Tensor, mlp_norm: torch.Tensor,
                 proj: dict[str, Linear], moe: Optional[MoEBlock] = None,
                 **norms: Optional[torch.Tensor]):
        super().__init__()
        unknown = set(norms) - set(OPTIONAL_NORMS)
        if unknown:
            raise TypeError(f"DecoderLayer: unknown norms {sorted(unknown)}")
        self.attn_norm = _frozen(attn_norm)
        self.mlp_norm = _frozen(mlp_norm)
        for name in OPTIONAL_NORMS:
            t = norms.get(name)
            if t is None:
                self.register_parameter(name, None)
            else:
                setattr(self, name, _frozen(t))
        self.proj = nn.ModuleDict(proj)
        self.register_module("moe", moe)


class LlamaModel(nn.Module):
    """Embedding table, decoder layers, final norm, the `TOP_LEAVES` the
    config's flags ask for (None otherwise) and lm head (None when the
    head is tied to the embedding; its bias is the Linear's). `embed` is
    the table in any of the three forms `embedding.embed_lookup` takes
    (`set_embed`)."""

    def __init__(self, embed: Union[torch.Tensor, QTensor, HostEmbedding],
                 layers: list[DecoderLayer], final_norm: torch.Tensor,
                 lm_head: Optional[Linear], **top: Optional[torch.Tensor]):
        super().__init__()
        unknown = set(top) - set(TOP_LEAVES)
        if unknown:
            raise TypeError(f"LlamaModel: unknown leaves {sorted(unknown)}")
        self.set_embed(embed)
        self.layers = nn.ModuleList(layers)
        self.final_norm = _frozen(final_norm)
        for name in TOP_LEAVES:
            t = top.get(name)
            if t is None:
                self.register_parameter(name, None)
            else:
                setattr(self, name, _frozen(t))
        self.lm_head = lm_head

    def top_leaves(self) -> dict:
        """{name: tensor} of the present `TOP_LEAVES`."""
        return {n: getattr(self, n) for n in TOP_LEAVES if getattr(self, n) is not None}

    def set_embed(self, embed: Union[torch.Tensor, QTensor, HostEmbedding]) -> None:
        """Replace the embedding table: a dense tensor becomes the frozen
        parameter `embed`; a low-bit QTensor's fields become the buffers
        of `low_bit_embed` (a Linear), which move with the model and read
        back as `embed`; a HostEmbedding stays a plain attribute, which
        `nn.Module.to` leaves on the host."""
        for name in ("embed", "low_bit_embed"):
            self._parameters.pop(name, None)
            self._modules.pop(name, None)
            self.__dict__.pop(name, None)
        if isinstance(embed, QTensor):
            self.low_bit_embed = Linear(embed)
        else:
            self.embed = embed if isinstance(embed, HostEmbedding) else _frozen(embed)

    def __getattr__(self, name: str):
        if name == "embed" and "low_bit_embed" in self.__dict__["_modules"]:
            return self.__dict__["_modules"]["low_bit_embed"].w
        return super().__getattr__(name)


def make_trainable(model: LlamaModel) -> list[nn.Parameter]:
    """Turn on gradients for every leaf the full fine-tune trains (JAX's
    `make_full_train_step` differentiates the whole parameter tree): the
    embedding, the norms, the biases, every dense projection and the lm
    head. A tied embedding is one parameter: it gets the sum of both
    uses' gradients, as JAX's tree does. Quantized projections are
    buffers and cannot train (QLoRA trains adapters over them). Returns
    the parameters, for the optimizer."""
    quantized = [n for n, m in model.named_modules()
                 if isinstance(m, Linear) and m.qtype is not None]
    if quantized:
        raise ValueError(f"make_trainable: {quantized[:3]}... are quantized; the "
                         "full fine-tune needs dense weights (QLoRA trains "
                         "adapters over a low-bit base)")
    params = list(model.parameters())
    for p in params:
        p.requires_grad_(True)
    return params


# ---------------------------------------------------------------------------
# init / quantize / merge
# ---------------------------------------------------------------------------

def init_params(config: ModelConfig, seed: int = 0, device=None,
                dtype=torch.bfloat16, scale: float = 0.02,
                low_bit: Optional[str] = None) -> LlamaModel:
    """Random dense init in `dtype` on `device` (the card unless told
    otherwise), N(0, scale^2) weights from a seeded torch.Generator, in
    the unfused layout, with JAX's other leaves: unit norms (post-norms,
    q/k norms and the embedding layernorm too), zero biases (the norms'
    and the lm head's too), N(0, scale^2) learned positions, no lm head
    when tied; an MoE layer's router, experts and shared expert in JAX's
    order, and the dense MLP's biases it carries unused under mlp_bias.
    With `low_bit`,
    each layer is quantized as soon as it is made (then the lm head), so
    only one dense layer is ever held: mixtral-8x7b's 32 dense layers are
    ~93 GB of bf16. The result equals `quantize_params(init_params(...),
    low_bit)`: quantizing draws nothing from the generator."""
    check_supported(config)
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    H, I = config.hidden_size, config.intermediate_size
    QD, KD = config.q_dim, config.kv_dim

    def w(shape):
        return (torch.randn(shape, generator=g, device=dev,
                            dtype=torch.float32) * scale).to(dtype)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=dev)

    def zeros(n, on):
        return torch.zeros(n, dtype=dtype, device=dev) if on else None

    ab, mb, gated = config.attention_bias, config.mlp_bias, config.gated_mlp
    E, EI = config.num_experts, config.moe_intermediate_size or I
    S = config.shared_expert_intermediate_size
    body = None if low_bit is None else resolve_qtype(split_mixed_qtype(low_bit)[0])
    layers = []
    for _ in range(config.num_hidden_layers):
        shapes = [("wq", (QD, H), ab), ("wk", (KD, H), ab), ("wv", (KD, H), ab),
                  ("wo", (H, QD), config.attention_out_bias)]
        if not config.is_moe:
            shapes += ([("w_gate", (I, H), mb)] if gated else []) + [
                ("w_up", (I, H), mb), ("w_down", (H, I), mb)]
        proj = {name: Linear(w(shape), zeros(shape[0], on)) for name, shape, on in shapes}
        moe = None
        if config.is_moe:
            router = w((E, H))
            biased = not gated and mb  # phixtral's experts
            experts = {n: Linear(w(shape), zeros(bias, biased)) for n, shape, bias in (
                [("w_gate_e", (E, EI, H), None)] if gated else []) + [
                ("w_up_e", (E, EI, H), (E, EI)), ("w_down_e", (E, H, EI), (E, H))]}
            if S:
                experts.update({n: Linear(w(shape)) for n, shape in (
                    ("w_gate_s", (S, H)), ("w_up_s", (S, H)), ("w_down_s", (H, S)))})
            unused = {}
            if mb:
                unused = {"b_up": zeros(I, True), "b_down": zeros(H, True)}
                if gated:
                    unused["b_gate"] = zeros(I, True)
            moe = MoEBlock(router, experts, w((1, H)) if S else None, **unused)
        norms = {}
        if config.norm_bias:
            norms.update(attn_norm_b=zeros(H, True), mlp_norm_b=zeros(H, True))
        if config.post_attn_norm:
            norms.update(post_attn_norm=ones(H), post_mlp_norm=ones(H))
        if config.qk_norm:
            norms.update(q_norm=ones(config.head_dim_), k_norm=ones(config.head_dim_))
        layer = DecoderLayer(ones(H), ones(H), proj, moe, **norms)
        if body is not None and not body.is_dense:
            quantize_layer(layer, body.name)
        layers.append(layer)
    V = config.vocab_size
    embed = w((V, H))
    top = {}
    if config.norm_bias:
        top["final_norm_b"] = zeros(H, True)
    if config.learned_positions:
        top["wpe"] = w((config.max_position_embeddings, H))
    if config.embed_layernorm:
        top.update(embed_norm=ones(H), embed_norm_b=zeros(H, True))
    head = None if config.tie_word_embeddings else Linear(
        w((V, H)), zeros(V, config.lm_head_bias))
    model = LlamaModel(embed, layers, ones(H), head, **top)
    return model if low_bit is None else quantize_params(model, low_bit)


def quantize_layer(layer: DecoderLayer, qtype: str) -> None:
    """Quantize a layer's dense projections and experts to `qtype` (a
    body format, not a mixed alias), in place; the router and the shared
    expert's gate stay dense."""
    for proj in (layer.proj,) + ((layer.moe.proj,) if layer.moe is not None else ()):
        for name, lin in proj.items():
            if lin.qtype is None:
                proj[name] = Linear(quantize_or_dense(lin.weight, qtype, name), lin.bias)


def quantize_params(model: LlamaModel, qtype: str,
                    lm_head_qtype: Optional[str] = None) -> LlamaModel:
    """Quantize every projection, expert and the lm head, in place (each
    dense weight is freed as its QTensor replaces it); norms, biases, the
    router, the shared expert's gate and the embedding stay dense, and so does a tied head (it is the embedding,
    which JAX never quantizes). The lm head takes `lm_head_qtype`, else
    the head format a mixed alias names (q4_k_m: q4_k body, q6_k head),
    else `qtype`. A weight whose last dim the format cannot take stays
    dense, with a warning (`quantize_or_dense`). Returns `model`."""
    qtype, head_default = split_mixed_qtype(qtype)
    lm_head_qtype = lm_head_qtype or head_default
    spec = resolve_qtype(qtype)
    if spec.is_dense:
        return model
    for layer in model.layers:
        quantize_layer(layer, spec.name)
    head = model.lm_head
    lm_spec = resolve_qtype(lm_head_qtype) if lm_head_qtype else spec
    if head is not None and head.qtype is None and not lm_spec.is_dense:
        model.lm_head = Linear(
            quantize_or_dense(head.weight, lm_spec.name, "lm_head"), head.bias)
    return model


def quantized_copy(model: LlamaModel, qtype: str) -> LlamaModel:
    """A model whose projections, experts and lm head are `qtype` copies
    of `model`'s (`quantize_params` on new layer containers), sharing the
    embedding, the norms, the biases, the routers and the other top-level
    leaves with it; `model` is left as it is. JAX's `optimize_model` is functional and gives this; the
    self-speculative draft is built with it."""
    layers = []
    for layer in model.layers:
        norms = {n: getattr(layer, n) for n in OPTIONAL_NORMS if getattr(layer, n) is not None}
        moe = None if layer.moe is None else layer.moe.copy()
        layers.append(DecoderLayer(layer.attn_norm, layer.mlp_norm, dict(layer.proj.items()),
                                   moe, **norms))
    return quantize_params(LlamaModel(model.embed, layers, model.final_norm, model.lm_head,
                                      **model.top_leaves()), qtype)


def _concat(lins: list[Linear], what: str) -> Linear:
    """Row-concatenation of same-format linears, their biases
    concatenated (JAX's bqkv, b_gateup) when every part has one."""
    ws = [lin.w for lin in lins]
    if all(isinstance(w, QTensor) for w in ws) and len({w.qtype for w in ws}) == 1:
        weight = concat_rows(ws)
    elif all(isinstance(w, torch.Tensor) for w in ws):
        weight = torch.cat(ws, dim=0)
    else:
        raise NotImplementedError(
            f"merging {what} of mixed formats: the JAX package leaves them "
            "unmerged; the port's forward takes one layout a model")
    biases = [lin.bias for lin in lins]
    if all(b is None for b in biases):
        return Linear(weight)
    if any(b is None for b in biases):
        raise ValueError(f"merging {what}: some parts have a bias and some not")
    return Linear(weight, torch.cat([b.detach() for b in biases], dim=0))


def merge_fused_params(model: LlamaModel, config: ModelConfig) -> LlamaModel:
    """Fuse wq/wk/wv into wqkv and w_gate/w_up into w_gateup (their biases
    into bqkv and b_gateup), in place: one kernel launch streams one
    larger weight. The forward splits the fused output, so results equal
    the unmerged layout's. An MoE layer has no w_gate/w_up: its experts
    stay as they are, and a plain MLP has no w_gate: its w_up stays alone
    (JAX's rule)."""
    for layer in model.layers:
        p = layer.proj
        if "wq" in p:
            p["wqkv"] = _concat([p.pop("wq"), p.pop("wk"), p.pop("wv")], "wq/wk/wv")
        if "w_gate" in p:
            p["w_gateup"] = _concat([p.pop("w_gate"), p.pop("w_up")], "w_gate/w_up")
    return model


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def embed_tokens(config: ModelConfig, model: LlamaModel, tokens: torch.Tensor,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The embedding rows in the compute dtype, from a dense, low-bit or
    host table (`embedding.embed_lookup`); gemma's scale_embeddings
    multiplies by sqrt(hidden) and minicpm's embedding_scale by scale_emb,
    each rounded to the compute dtype first, as JAX does (59.75 for
    hidden 3584 in bf16)."""
    h = embed_lookup(model.embed, tokens, compute_dtype)
    for on, factor in ((config.scale_embeddings, config.hidden_size ** 0.5),
                       (config.embedding_scale, config.embedding_scale)):
        if on:
            h = h * torch.tensor(factor, dtype=compute_dtype, device=h.device)
    return h


def _softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    return x if cap is None else torch.tanh(x / cap) * cap


def lm_head_logits(config: ModelConfig, model: LlamaModel, h: torch.Tensor,
                   compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Final norm (a layernorm with its bias under norm_type
    "layernorm") + lm head with its bias (the embedding when tied: a
    dense product, or the quantized one of a low-bit table, as in JAX),
    logits in float32, times logit_scale, then the final softcap. A tied
    head over a HostEmbedding raises AttributeError, as the JAX package's
    linear does on it: the head would need the whole table on the
    device."""
    if config.norm_type == "layernorm":
        h = layer_norm(h, model.final_norm, model.final_norm_b, config.rms_norm_eps)
    else:
        h = rms_norm(h, model.final_norm, config.rms_norm_eps,
                     offset=config.rms_norm_offset)
    if model.lm_head is None:
        if isinstance(model.embed, HostEmbedding):
            raise AttributeError(
                "a tied lm head multiplies by the whole embedding table on the "
                "device; a HostEmbedding keeps it on the host (untie the head, "
                "or keep the table dense or low-bit)")
        logits = linear(h, model.embed, None, compute_dtype)
    else:
        logits = model.lm_head(h, compute_dtype)
    logits = logits.float()
    if config.logit_scale:
        logits = logits * config.logit_scale
    return _softcap(logits, config.final_logit_softcap)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    """JAX's `_act`: HF's "gelu" is the exact erf gelu, the tanh names
    the approximation."""
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x)
    if name in ("gelu_new", "gelu_pytorch_tanh", "gelu_tanh"):
        return F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu(x)
    raise NotImplementedError(f"hidden_act {name}")


# ---------------------------------------------------------------------------
# mixture of experts (JAX's `_moe_*`, bigdl_tpu/models/llama.py:346-504)
# ---------------------------------------------------------------------------

def _deq(w, compute_dtype):
    return w.dequantize(compute_dtype) if isinstance(w, QTensor) else w.to(compute_dtype)


def resolve_moe_dispatch(config: ModelConfig) -> str:
    """JAX's auto rule: the dense combine up to 8 experts (all matmuls,
    no gather or scatter), the capacity dispatch above (FLOPs ~ k / E)."""
    if config.moe_dispatch is not None:
        return config.moe_dispatch
    return "ragged" if config.num_experts > 8 else "dense"


def _moe_router(config: ModelConfig, xc: torch.Tensor, p: dict):
    """Top-k routing on float32 softmax weights: (topv [B, T, k] f32,
    topi [B, T, k] int64), topv renormalized under norm_topk_prob
    (mixtral). lax.top_k's order, the larger first and the lower expert
    first on ties, comes from a stable sort on either device (torch.topk
    does not promise the tie order on CUDA)."""
    logits = torch.matmul(xc.float(), p["router"].to(xc.dtype).float().t())
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = config.num_experts_per_tok
    topv, topi = topv[..., :k], topi[..., :k]
    if config.norm_topk_prob:
        topv = topv / (topv.sum(-1, keepdim=True) + 1e-20)
    return topv, topi


def _expert_ffn(config: ModelConfig, xe: torch.Tensor, p: dict, compute_dtype) -> torch.Tensor:
    """Each expert's FFN on its grouped tokens: [E, C, H] -> [E, C, H],
    gated (mixtral, qwen2-moe) or plain fc -> act -> proj with the
    experts' biases (phixtral)."""
    u = torch.bmm(xe, _deq(p["w_up_e"], compute_dtype).transpose(1, 2))  # [E, C, I]
    if config.gated_mlp:
        g = torch.bmm(xe, _deq(p["w_gate_e"], compute_dtype).transpose(1, 2))
        z = _act(config.hidden_act, g) * u
        del g
    else:
        if "b_up_e" in p:
            u = u + p["b_up_e"].to(compute_dtype)[:, None, :]
        z = _act(config.hidden_act, u)
    del u
    out = torch.bmm(z, _deq(p["w_down_e"], compute_dtype).transpose(1, 2))
    if not config.gated_mlp and "b_down_e" in p:
        out = out + p["b_down_e"].to(compute_dtype)[:, None, :]
    return out


def _moe_dispatch_ragged(config: ModelConfig, xc: torch.Tensor, p: dict, compute_dtype,
                         topv: torch.Tensor, topi: torch.Tensor) -> torch.Tensor:
    """The capacity dispatch (GShard): each expert computes at most C =
    ceil(N k / E * capacity_factor) of its routed tokens, in token-major
    order of assignment; the rest are dropped (their weight never
    arrives). A kept slot holds one token, so the dispatch is a plain
    index write (JAX's scatter-add into zeros; the overflow bin it sums
    into is thrown away), and each token's k contributions are added in
    JAX's token-major order, rounding to the compute dtype after each
    add: no atomics, two calls are bit-equal."""
    B, T, H = xc.shape
    E, k = config.num_experts, config.num_experts_per_tok
    N = B * T
    C = max(1, min(N, int(-(-N * k * config.moe_capacity_factor // E))))
    dev = xc.device
    x_flat = xc.reshape(N, H)
    e_flat = topi.reshape(N * k)
    w_flat = topv.reshape(N * k).to(compute_dtype)
    onehot = F.one_hot(e_flat, E)  # [N k, E]
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(-1)  # slot within expert
    slot = torch.where(pos < C, e_flat * C + pos, E * C)  # E C: the overflow bin
    tok = torch.arange(N, device=dev).repeat_interleave(k)
    x_disp = torch.zeros(E * C + 1, H, dtype=compute_dtype, device=dev)
    x_disp[slot] = x_flat[tok]
    y = _expert_ffn(config, x_disp[:-1].reshape(E, C, H), p, compute_dtype).reshape(E * C, H)
    y = torch.cat([y, torch.zeros(1, H, dtype=compute_dtype, device=dev)])
    contrib = (y[slot] * w_flat[:, None]).reshape(N, k, H)  # overflow reads zeros
    out = torch.zeros(N, H, dtype=compute_dtype, device=dev)
    for j in range(k):
        out = out + contrib[:, j]
    return out.reshape(B, T, H)


def _moe_dispatch_dense(config: ModelConfig, xc: torch.Tensor, p: dict, compute_dtype,
                        topv: torch.Tensor, topi: torch.Tensor) -> torch.Tensor:
    """The dense combine: every expert computes every token, and the
    top-k weights (0 for an expert not chosen) combine them; phixtral's
    expert biases ride inside each expert's weighted term, as HF's
    per-expert MLP call adds them."""
    combine = torch.zeros(*topi.shape[:-1], config.num_experts, dtype=torch.float32,
                          device=xc.device).scatter_(-1, topi, topv)
    u = torch.einsum("bth,eih->btei", xc, _deq(p["w_up_e"], compute_dtype))  # [B, T, E, I]
    if config.gated_mlp:
        g = torch.einsum("bth,eih->btei", xc, _deq(p["w_gate_e"], compute_dtype))
        z = _act(config.hidden_act, g) * u
        del g
    else:
        if "b_up_e" in p:
            u = u + p["b_up_e"].to(compute_dtype)[None, None]
        z = _act(config.hidden_act, u)
    del u
    d = torch.einsum("btei,ehi->bteh", z, _deq(p["w_down_e"], compute_dtype))
    if not config.gated_mlp and "b_down_e" in p:
        d = d + p["b_down_e"].to(compute_dtype)[None, None]
    return torch.einsum("bteh,bte->bth", d, combine.to(compute_dtype))


def _moe_mlp(config: ModelConfig, x: torch.Tensor, p: dict, compute_dtype) -> torch.Tensor:
    """The mixture-of-experts MLP over `p` (`MoEBlock.leaves()`): route,
    dispatch by `resolve_moe_dispatch`, then qwen2-moe's shared expert
    times its sigmoid gate."""
    xc = x.to(compute_dtype)
    topv, topi = _moe_router(config, xc, p)
    if resolve_moe_dispatch(config) == "ragged":
        out = _moe_dispatch_ragged(config, xc, p, compute_dtype, topv, topi)
    else:
        out = _moe_dispatch_dense(config, xc, p, compute_dtype, topv, topi)
    if config.shared_expert_intermediate_size:
        sg = torch.matmul(xc, _deq(p["w_gate_s"], compute_dtype).t())
        su = torch.matmul(xc, _deq(p["w_up_s"], compute_dtype).t())
        sd = torch.matmul(_act(config.hidden_act, sg) * su,
                          _deq(p["w_down_s"], compute_dtype).t())
        gate = torch.sigmoid(torch.matmul(xc, p["shared_gate"].to(compute_dtype).t()))
        out = out + sd * gate
    return out


@dataclasses.dataclass(frozen=True)
class AttentionRoute:
    """Where one layer's attention goes and what it is passed: `kernel` is
    "flash" (the prefill kernel over the cache, `kernels.flash_attention`),
    "flash_train" (the differentiable kernels, cache-free), "paged"
    (`kernels.paged_attention`) or "plain" (`ops.attention` under the
    layer's mask); `window` is the layer's sliding window (None on a
    global layer), `softcap` and `scale` the attention's (None: none, and
    1/sqrt(head_dim))."""
    kernel: str
    window: Optional[int]
    softcap: Optional[float]
    scale: Optional[float]


def attention_route(config: ModelConfig, layer: int, cache: str = "dense",
                    mode: str = "prefill", T: int = 1,
                    per_row: bool = False) -> AttentionRoute:
    """The JAX package's dispatch (bigdl_tpu/models/llama.py:644-697 and
    805-847) for layer `layer` of a call with `cache` "none", "dense" or
    "paged", `mode`, T query tokens and per-row positions or not:
    - a one-token decode over a paged cache: the paged kernel, with the
      layer's window, the softcap and the scale;
    - without a cache, T > 1: the flash training kernels, if every layer
      has the same window and the scores are not softcapped (the kernels
      take no cap);
    - a prefill over a cache, T > 1, one position for all rows, every
      layer the same window: the flash kernel with the window, softcap
      and scale;
    - everything else, gemma2's alternating windows among it, and every
      call of an ALiBi model (`not config.alibi` on each of JAX's kernel
      routes; the kernels take no bias): the plain attention under the
      layer's mask."""
    uniform = config.sliding_window_pattern is None and config.sliding_layers is None
    window = config.sliding_window if config.layer_is_sliding(layer) else None
    cap, scale = config.attn_logit_softcap, config.attn_scale
    if config.alibi:
        kernel = "plain"
    elif cache == "paged" and mode == "decode" and T == 1:
        kernel = "paged"
    elif cache == "none":
        kernel = "flash_train" if T > 1 and uniform and cap is None else "plain"
    elif mode == "prefill" and T > 1 and not per_row and uniform:
        kernel = "flash"
    else:
        kernel = "plain"
    return AttentionRoute(kernel, window, None if kernel == "flash_train" else cap, scale)


def forward(config: ModelConfig, model: LlamaModel, tokens: torch.Tensor,
            cache: Optional[Union[KVCache, PagedKVCache]], mode: str = "prefill",
            compute_dtype=torch.bfloat16, last_logits_only: bool = False,
            start: Optional[torch.Tensor] = None,
            lora=None, remat: bool = False, collect_obs: int = 0):
    """Returns (logits [B, T, V] float32 — [B, 1, V] with
    last_logits_only — and the cache with pos advanced by T, or None
    without a cache). The cache is written in place; its pos is an int
    (rows aligned) or an int32 [B] tensor (per-row, the serving engine's
    pools); a compressed cache's rope_base gives the positions. `start`
    [B] gives the left padding of the cache-free path (the cache carries
    its own); `lora` is a shared or batched adapter tree; `remat`
    (cache-free only) recomputes each layer in the backward.
    `collect_obs` = W > 0 also returns, third, every layer's last W
    rotated queries [L, B, W, Hq, D], SnapKV's observation window
    (`kvcache.compress`)."""
    if mode not in ("prefill", "decode"):
        raise ValueError(f"mode must be 'prefill' or 'decode', got {mode!r}")
    if remat and cache is not None:
        raise ValueError("remat=True is for the cache-free training path")
    check_supported(config)
    B, T = tokens.shape
    Hq, Hkv, D = (config.num_attention_heads, config.num_key_value_heads,
                  config.head_dim_)
    QD, KD = Hq * D, Hkv * D
    eps = config.rms_norm_eps
    dev = tokens.device
    if cache is None:
        pos0 = 0
        row_start = (torch.zeros((B,), dtype=torch.int32, device=dev)
                     if start is None else start.to(device=dev, dtype=torch.int32))
        positions = torch.clamp(
            torch.arange(T, dtype=torch.int32, device=dev)[None, :]
            - row_start[:, None], min=0)
        max_len = T
    else:
        pos0 = cache.pos
        row_start = cache.start
        positions = cache.next_positions(T)
        max_len = cache.max_len
    per_row = isinstance(pos0, torch.Tensor)

    h = embed_tokens(config, model, tokens, compute_dtype)
    if config.learned_positions:  # gpt2's wpe table; a position past it
        # reads its last row, as JAX's gather clamps
        wpe = model.wpe.to(compute_dtype)
        h = h + wpe[positions.long().clamp(max=wpe.shape[0] - 1)]
    if config.embed_layernorm:  # bloom's word_embeddings_layernorm
        h = layer_norm(h, model.embed_norm, model.embed_norm_b, eps)
    # ALiBi's positions are its bias, gpt2's its learned table
    use_rope = not (config.alibi or config.learned_positions)
    interleaved = config.rope_interleaved
    cos_local = None
    if use_rope:
        inv_freq, att_scale = make_inv_freq_scaled(
            config.rotary_dim, config.rope_theta, config.rope_scaling_dict,
            seq_len=max_len, device=dev)
        cos, sin = rope_cos_sin(positions, inv_freq, scale=att_scale, interleaved=interleaved)
        if config.rope_local_theta is not None:
            # gemma3: the sliding layers rotate at the local base, unscaled
            # (HF applies rope_scaling to the global layers only)
            inv_local, _ = make_inv_freq_scaled(config.rotary_dim, config.rope_local_theta,
                                                None, device=dev)
            cos_local, sin_local = rope_cos_sin(positions, inv_local, interleaved=interleaved)
    # qwen v1's logn: queries past the training length scale by
    # log_train_len(position + 1), from the positions (per row under a
    # speculative verify), not the slots
    logn_col = None
    if config.logn_attn and config.logn_train_len:
        logn = torch.log(positions.float() + 1.0) / torch.log(
            torch.tensor(float(config.logn_train_len), device=dev))
        logn_col = torch.clamp(logn, min=1.0)[:, :, None, None].to(compute_dtype)

    kind = ("none" if cache is None else
            "paged" if isinstance(cache, PagedKVCache) else "dense")
    routes = [attention_route(config, idx, kind, mode, T, per_row)
              for idx in range(len(model.layers))]
    # the plain attention's masks, built once a forward: global and, with
    # a window, sliding (k_slot > q_slot - window), keyed by the window
    masks = {}
    if any(r.kernel == "plain" for r in routes):
        sj = torch.arange(max_len, device=dev)
        slots = torch.arange(T, device=dev)[None, :] + (
            pos0.long()[:, None] if per_row else pos0)  # [B | 1, T]
        base = ((sj[None, None, :] <= slots[..., None])
                & (sj[None, None, :] >= row_start[:, None, None]))
        masks[None] = base[:, None, None]  # [B, 1, 1, T, S]
        for r in routes:
            if r.kernel == "plain" and r.window is not None and r.window not in masks:
                masks[r.window] = (base & (sj[None, None, :] > slots[..., None] - r.window)
                                   )[:, None, None]
        del base
        if config.alibi:
            # the additive bias slope_h * (k_slot - q_slot), 0 on the
            # diagonal (row starts cancel), -1e30 where masked: one
            # [B, Hkv, G, T, S] float mask a window, built once a forward
            slopes = alibi_slopes(Hq, device=dev).reshape(Hkv, Hq // Hkv)
            if config.alibi_scale:  # falcon-rw: the bias shares the score scale
                slopes = slopes * config.alibi_scale
            dist = (sj[None, None, :] - slots[..., None]).float()  # [B | 1, T, S]
            bias = slopes[None, :, :, None, None] * dist[:, None, None]
            masks = {w: torch.where(m, bias, _NEG_INF) for w, m in masks.items()}
            del bias, dist

    lora_layers, lora_scale = ((None, None) if lora is None else
                               (lora["layers"], lora["scale"]) if isinstance(lora, dict)
                               else (lora.layers, lora.scale))

    def adapter(target, idx):
        """(a, b, scale) of layer idx's `target` — a [r, in], b [out, r]
        shared, or a [B, rb, in], b [B, out, rb] batched — or None."""
        if lora is None or target not in lora_layers:
            return None
        pair = lora_layers[target]
        return pair["a"][idx], pair["b"][idx], lora_scale

    def plus_delta(y, x, target, idx):
        """y + the LoRA delta of x for a slice of a fused projection (the
        adapters keep the unmerged names)."""
        pair = adapter(target, idx)
        return y if pair is None else y + lora_epilogue(x, *pair, compute_dtype)

    def norm(x, w, b=None):
        if config.norm_type == "layernorm":
            return layer_norm(x, w, b, eps)
        return rms_norm(x, w, eps, offset=config.rms_norm_offset)

    rs = config.residual_scale  # minicpm: both branches times scale_depth / sqrt(L)
    rs_t = None if not rs else torch.tensor(rs, dtype=compute_dtype, device=dev)

    def decoder_layer(h, idx):
        layer = model.layers[idx]
        route = routes[idx]
        p = layer.proj
        x = norm(h, layer.attn_norm, layer.attn_norm_b)
        if "wqkv" in p:  # fused layout; the adapters keep the unmerged names
            qkv = p["wqkv"](x, compute_dtype)
            q, k, v = qkv[..., :QD], qkv[..., QD:QD + KD], qkv[..., QD + KD:]
            q, k, v = (plus_delta(t, x, n, idx) for t, n in ((q, "wq"), (k, "wk"), (v, "wv")))
        else:
            q, k, v = (p[n](x, compute_dtype, lora=adapter(n, idx)) for n in ("wq", "wk", "wv"))
        q = q.reshape(B, T, Hq, D)
        k = k.reshape(B, T, Hkv, D)
        v = v.reshape(B, T, Hkv, D)
        if config.qk_norm:
            q = rms_norm(q, layer.q_norm, eps, offset=config.rms_norm_offset)
            k = rms_norm(k, layer.k_norm, eps, offset=config.rms_norm_offset)
        if use_rope:
            local = cos_local is not None and config.layer_is_sliding(idx)
            q, k = apply_rotary_emb(q, k, cos_local if local else cos,
                                    sin_local if local else sin, interleaved)
        if logn_col is not None:
            q = q * logn_col
        # without rope (learned positions, ALiBi) q is still a view of the
        # fused projection's output; the attention kernels read whole rows
        q = q.contiguous()
        if collect_obs:  # a copy: a view would keep the layer's whole q alive
            obs.append(q[:, T - collect_obs:].clone())

        attend = dict(scale=route.scale, softcap=route.softcap, window=route.window)
        if route.kernel == "flash_train":
            attn = kernels.flash_attention_train(q, k.to(compute_dtype), v.to(compute_dtype),
                                                 start=row_start, **attend)
        elif cache is None:
            attn = attention(q, k.to(compute_dtype), v.to(compute_dtype),
                             masks[route.window], route.scale, route.softcap)
        elif route.kernel == "paged":
            kvcache.update_layer(cache, idx, k, v)
            attn = kernels.paged_attention(
                q[:, 0], cache.k, cache.v, cache.block_tables, idx,
                cache.pos, cache.start, cache.k_scale, cache.v_scale, **attend)[:, None]
        elif route.kernel == "flash":
            kvcache.update_layer(cache, idx, k, v)
            # fp8 codes and scales go to the kernel's fp8 arm as they are
            k_att, v_att, k_sc, v_sc = kvcache.read_layer_raw(cache, idx)
            attn = kernels.flash_attention(q, k_att, v_att, start=row_start,
                                           q_offset=pos0, k_scale=k_sc,
                                           v_scale=v_sc, **attend)
        else:
            kvcache.update_layer(cache, idx, k, v)
            k_att, v_att = kvcache.read_layer(cache, idx, compute_dtype)
            attn = attention(q, k_att, v_att, masks[route.window], route.scale,
                             route.softcap)
        out = p["wo"](attn.reshape(B, T, QD), compute_dtype, lora=adapter("wo", idx))
        if config.post_attn_norm:
            out = norm(out, layer.post_attn_norm)
        if not config.parallel_residual:  # gpt-neox, phi, cohere: the MLP reads h too
            h = h + (out * rs_t if rs else out)

        x = norm(h, layer.mlp_norm, layer.mlp_norm_b)
        if layer.moe is not None:  # JAX's MoE path takes no adapter
            down = _moe_mlp(config, x, layer.moe.leaves(), compute_dtype)
        elif "w_gateup" in p:
            gate, up = p["w_gateup"](x, compute_dtype).chunk(2, dim=-1)
            gate = plus_delta(gate, x, "w_gate", idx)
            up = plus_delta(up, x, "w_up", idx)
            down = p["w_down"](_act(config.hidden_act, gate) * up, compute_dtype,
                               lora=adapter("w_down", idx))
        else:
            up = p["w_up"](x, compute_dtype, lora=adapter("w_up", idx))
            if config.gated_mlp:
                gate = p["w_gate"](x, compute_dtype, lora=adapter("w_gate", idx))
                up = _act(config.hidden_act, gate) * up
            else:  # plain fc -> act -> proj
                up = _act(config.hidden_act, up)
            down = p["w_down"](up, compute_dtype, lora=adapter("w_down", idx))
        if config.post_attn_norm:
            down = norm(down, layer.post_mlp_norm)
        if config.parallel_residual:
            return h + out + down
        return h + (down * rs_t if rs else down)

    obs = []
    for idx in range(len(model.layers)):
        if remat and torch.is_grad_enabled():
            h = torch.utils.checkpoint.checkpoint(decoder_layer, h, idx,
                                                  use_reentrant=False)
        else:
            h = decoder_layer(h, idx)

    if last_logits_only:
        h = h[:, -1:]
    logits = lm_head_logits(config, model, h, compute_dtype)
    cache = None if cache is None else kvcache.advance(cache, T)
    if collect_obs:
        return logits, cache, torch.stack(obs)
    return logits, cache
