"""Llama-family decoder (port of bigdl_tpu/models/llama.py) for the plain
llama flags: GQA, rope with the default theta, RMSNorm, SiLU-gated MLP,
untied lm head.

The JAX package keeps parameters as a pytree with layers stacked for
`lax.scan`; here they are modules — `LlamaModel` holds the embedding,
one `DecoderLayer` per layer (norm weights as buffers, projections as
`ops.linear.Linear` keyed by the JAX leaf names) and the lm head — and
`forward` walks the layers in a Python loop. Every flag this slice does
not run raises `NotImplementedError` (`check_supported`).

With a cache, attention runs over the full cache [0, max_len) under a
validity mask from (start, pos), as in JAX: prefill (T > 1) goes through
the flash kernel, decode through the plain masked attention. Without a
cache (`cache=None`, the training / scoring path) query t of row b sits at
slot t with position max(t - start[b], 0); T > 1 goes through the
differentiable flash kernels (forward with logsumexp, dQ, dK/dV), T = 1
through the masked attention. That path takes LoRA adapters (`lora=`, a
`train.qlora.LoRA`): the q/k/v and gate/up deltas apply in plain torch on
the fused projections' slices, wo and w_down fold theirs into the fused
GEMM's writeback.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch import kvcache
from bigdl_tpu_torch.kvcache import KVCache
from bigdl_tpu_torch.models.config import ModelConfig
from bigdl_tpu_torch.ops import (Linear, apply_rotary_emb, attention, kernels,
                                 rms_norm, rope_cos_sin)
from bigdl_tpu_torch.ops.linear import lora_epilogue
from bigdl_tpu_torch.ops.rope import make_inv_freq_scaled
from bigdl_tpu_torch.quant import QTensor, concat_rows, quantize
from bigdl_tpu_torch.quant.qtypes import resolve_qtype, split_mixed_qtype
from bigdl_tpu_torch.utils import resolve_device

# ModelConfig fields this slice runs at any value; every other field must
# keep its default (plain llama)
_SUPPORTED_FIELDS = frozenset({
    "model_type", "vocab_size", "hidden_size", "intermediate_size",
    "num_hidden_layers", "num_attention_heads", "num_key_value_heads",
    "head_dim", "rms_norm_eps", "rope_theta", "rope_scaling",
    "max_position_embeddings",
})
_DEFAULTS = ModelConfig()


def check_supported(config: ModelConfig) -> None:
    """Raise for any config flag beyond the plain llama family."""
    for f in dataclasses.fields(ModelConfig):
        if f.name in _SUPPORTED_FIELDS:
            continue
        if getattr(config, f.name) != getattr(_DEFAULTS, f.name):
            raise NotImplementedError(
                f"llama forward with {f.name}={getattr(config, f.name)!r}: "
                "ROADMAP queue 1, the llama flags beyond plain llama are "
                "still to be ported")


class DecoderLayer(nn.Module):
    """One decoder layer's weights: `attn_norm`/`mlp_norm` buffers and the
    projections in `proj` — wq/wk/wv, wo, w_gate/w_up, w_down as
    `init_params` makes them, wqkv, wo, w_gateup, w_down after
    `merge_fused_params` (the layout `forward` runs)."""

    def __init__(self, attn_norm: torch.Tensor, mlp_norm: torch.Tensor,
                 proj: dict[str, Linear]):
        super().__init__()
        self.register_buffer("attn_norm", attn_norm)
        self.register_buffer("mlp_norm", mlp_norm)
        self.proj = nn.ModuleDict(proj)


class LlamaModel(nn.Module):
    """Embedding table, decoder layers, final norm and lm head."""

    def __init__(self, embed: torch.Tensor, layers: list[DecoderLayer],
                 final_norm: torch.Tensor, lm_head: Linear):
        super().__init__()
        self.register_buffer("embed", embed)
        self.layers = nn.ModuleList(layers)
        self.register_buffer("final_norm", final_norm)
        self.lm_head = lm_head


# ---------------------------------------------------------------------------
# init / quantize / merge
# ---------------------------------------------------------------------------

def init_params(config: ModelConfig, seed: int = 0, device=None,
                dtype=torch.bfloat16, scale: float = 0.02) -> LlamaModel:
    """Random dense init on `device` (the card unless told otherwise),
    N(0, scale^2) weights from a seeded torch.Generator, unit norms."""
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

    layers = []
    for _ in range(config.num_hidden_layers):
        proj = {name: Linear(w(shape)) for name, shape in (
            ("wq", (QD, H)), ("wk", (KD, H)), ("wv", (KD, H)),
            ("wo", (H, QD)), ("w_gate", (I, H)), ("w_up", (I, H)),
            ("w_down", (H, I)))}
        layers.append(DecoderLayer(ones(H), ones(H), proj))
    embed = w((config.vocab_size, H))
    return LlamaModel(embed, layers, ones(H), Linear(w((config.vocab_size, H))))


def _quantize_or_dense(w: torch.Tensor, qtype: str, what: str):
    """quantize(), but a weight whose last dim the format's block does not
    divide stays dense with a warning (the JAX package's rule)."""
    block = resolve_qtype(qtype).block_size
    if w.shape[-1] % block:
        warnings.warn(f"{what}: last dim {w.shape[-1]} not divisible by "
                      f"{qtype}'s block size {block}; keeping this weight dense")
        return w
    return quantize(w, qtype)


def quantize_params(model: LlamaModel, qtype: str) -> LlamaModel:
    """Quantize every projection and the lm head, in place (each dense
    weight is freed as its QTensor replaces it); norms and the embedding
    stay dense. A mixed alias names the lm head's format. Returns
    `model`."""
    qtype, lm_head_qtype = split_mixed_qtype(qtype)
    spec = resolve_qtype(qtype)
    if spec.is_dense:
        return model
    for layer in model.layers:
        for name, lin in layer.proj.items():
            if lin.qtype is None:
                layer.proj[name] = Linear(
                    _quantize_or_dense(lin.weight, spec.name, name), lin.bias)
    head = model.lm_head
    lm_spec = resolve_qtype(lm_head_qtype) if lm_head_qtype else spec
    if head.qtype is None and not lm_spec.is_dense:
        model.lm_head = Linear(
            _quantize_or_dense(head.weight, lm_spec.name, "lm_head"), head.bias)
    return model


def _concat(lins: list[Linear], what: str) -> Linear:
    """Row-concatenation of same-format, bias-free linears."""
    ws = [lin.w for lin in lins]
    if all(isinstance(w, QTensor) for w in ws) and len({w.qtype for w in ws}) == 1:
        merged = Linear(concat_rows(ws))
    elif all(isinstance(w, torch.Tensor) for w in ws):
        merged = Linear(torch.cat(ws, dim=0))
    else:
        merged = None
    if merged is None or any(lin.bias is not None for lin in lins):
        raise NotImplementedError(
            f"merging {what} of mixed formats or with biases: ROADMAP queue 1, "
            "the llama flags beyond plain llama are still to be ported")
    return merged


def merge_fused_params(model: LlamaModel, config: ModelConfig) -> LlamaModel:
    """Fuse wq/wk/wv into wqkv and w_gate/w_up into w_gateup, in place:
    one kernel launch streams one larger weight. The forward splits the
    fused output, so results equal the unmerged layout's."""
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
    return model.embed.to(compute_dtype)[tokens]


def lm_head_logits(config: ModelConfig, model: LlamaModel, h: torch.Tensor,
                   compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Final norm + lm head, logits in float32."""
    h = rms_norm(h, model.final_norm, config.rms_norm_eps)
    return model.lm_head(h, compute_dtype).float()


def forward(config: ModelConfig, model: LlamaModel, tokens: torch.Tensor,
            cache: Optional[KVCache], mode: str = "prefill",
            compute_dtype=torch.bfloat16, last_logits_only: bool = False,
            start: Optional[torch.Tensor] = None,
            lora=None) -> tuple[torch.Tensor, Optional[KVCache]]:
    """Returns (logits [B, T, V] float32 — [B, 1, V] with
    last_logits_only — and the cache with pos advanced by T, or None
    without a cache). The cache is written in place. `start` [B] gives
    the left padding of the cache-free path (the cache carries its own);
    `lora` runs only there."""
    if mode not in ("prefill", "decode"):
        raise ValueError(f"mode must be 'prefill' or 'decode', got {mode!r}")
    if cache is not None and lora is not None:
        raise NotImplementedError(
            "LoRA adapters with a KV cache (serving adapters): ROADMAP "
            "queue 1 item 7, still to be ported")
    check_supported(config)
    if any("wqkv" not in layer.proj for layer in model.layers):
        raise ValueError("forward runs the fused layout (wqkv, w_gateup): "
                         "pass the model through optimize_model or "
                         "merge_fused_params first")
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

    h = embed_tokens(config, model, tokens, compute_dtype)
    inv_freq, att_scale = make_inv_freq_scaled(
        config.rotary_dim, config.rope_theta, config.rope_scaling_dict,
        seq_len=max_len, device=dev)
    cos, sin = rope_cos_sin(positions, inv_freq, scale=att_scale)

    # prefill through the flash kernel (no [T, S] scores in memory), the
    # cache-free path through the differentiable flash kernels, decode
    # and single-token scoring through the masked plain attention — the
    # JAX dispatch
    use_flash = T > 1 and (cache is None or mode == "prefill")
    mask = None
    if not use_flash:
        sj = torch.arange(max_len, device=dev)
        slots = pos0 + torch.arange(T, device=dev)
        mask = ((sj[None, None, :] <= slots[None, :, None])
                & (sj[None, None, :] >= row_start[:, None, None]))
        mask = mask[:, None, None]  # [B, 1, 1, T, S]

    def adapter(target, idx):
        """(a [r, in], b [out, r], scale) of layer idx's `target`, or None."""
        if lora is None or target not in lora.layers:
            return None
        pair = lora.layers[target]
        return pair["a"][idx], pair["b"][idx], lora.scale

    def plus_delta(y, x, target, idx):
        """y + the LoRA delta of x for a slice of a fused projection (the
        adapters keep the unmerged names)."""
        pair = adapter(target, idx)
        return y if pair is None else y + lora_epilogue(x, *pair, compute_dtype)

    for idx, layer in enumerate(model.layers):
        p = layer.proj
        x = rms_norm(h, layer.attn_norm, eps)
        qkv = p["wqkv"](x, compute_dtype)
        q, k, v = qkv[..., :QD], qkv[..., QD:QD + KD], qkv[..., QD + KD:]
        q = plus_delta(q, x, "wq", idx).reshape(B, T, Hq, D)
        k = plus_delta(k, x, "wk", idx).reshape(B, T, Hkv, D)
        v = plus_delta(v, x, "wv", idx).reshape(B, T, Hkv, D)
        q, k = apply_rotary_emb(q, k, cos, sin)

        if cache is None:
            k_att, v_att = k.to(compute_dtype), v.to(compute_dtype)
        else:
            kvcache.update_layer(cache, idx, k, v)
            k_att, v_att = kvcache.read_layer(cache, idx)
        if use_flash and cache is None:
            attn = kernels.flash_attention_train(q, k_att, v_att, start=row_start)
        elif use_flash:
            attn = kernels.flash_attention(q, k_att, v_att, start=row_start,
                                           q_offset=pos0)
        else:
            attn = attention(q, k_att, v_att, mask)
        h = h + p["wo"](attn.reshape(B, T, QD), compute_dtype,
                        lora=adapter("wo", idx))

        x = rms_norm(h, layer.mlp_norm, eps)
        gate, up = p["w_gateup"](x, compute_dtype).chunk(2, dim=-1)
        gate = plus_delta(gate, x, "w_gate", idx)
        up = plus_delta(up, x, "w_up", idx)
        h = h + p["w_down"](F.silu(gate) * up, compute_dtype,
                            lora=adapter("w_down", idx))

    if last_logits_only:
        h = h[:, -1:]
    logits = lm_head_logits(config, model, h, compute_dtype)
    return logits, (None if cache is None else kvcache.advance(cache, T))
