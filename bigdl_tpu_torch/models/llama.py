"""Llama-family decoder (port of bigdl_tpu/models/llama.py) for the plain
llama flags: GQA, rope with the default theta, RMSNorm, SiLU-gated MLP,
untied lm head.

The JAX package keeps parameters as a pytree with layers stacked for
`lax.scan`; here they are modules — `LlamaModel` holds the embedding,
one `DecoderLayer` per layer (norm weights, projections as
`ops.linear.Linear` keyed by the JAX leaf names) and the lm head — and
`forward` walks the layers in a Python loop. The embedding, the norms and
every dense projection are parameters that require no gradient until
`make_trainable` turns them on (the full fine-tune, train/recipes.py);
quantized projections stay buffers. `forward` runs both layouts, as
JAX's does: the fused one (wqkv, w_gateup) that `optimize_model` makes,
and the unfused one (wq/wk/wv, w_gate/w_up) of `init_params`, which the
full fine-tune trains. Every flag this slice does not run raises
`NotImplementedError` (`check_supported`).

With a cache, attention follows JAX's dispatch: a prefill (T > 1) over a
dense cache with one position for all rows (generate, the serving
engine's 1-row prefill) goes through the flash kernel, its fp8 arm for an
fp8 cache; a one-token decode over a paged cache through the paged
kernel, which reads the pool in place; every other cached call — decode
over a dense cache, and any call with per-row positions such as the
engine's paged prefill — through the plain masked attention over the
full cache [0, max_len) (`kvcache.read_layer`'s dense view) under a
validity mask from (start, pos). Without a
cache (`cache=None`, the training / scoring path) query t of row b sits at
slot t with position max(t - start[b], 0); T > 1 goes through the
differentiable flash kernels (forward with logsumexp, dQ, dK/dV), T = 1
through the masked attention; `remat=True` recomputes each layer in the
backward instead of keeping its activations (JAX's `jax.checkpoint`
around the scan body). Every path takes LoRA adapters (`lora=`: a
`train.qlora.LoRA`, or JAX's {"layers": {target: {"a", "b"}}, "scale"}
tree, shared — a [L, r, in], b [L, out, r], scalar scale — or batched per
row, as the serving engine's decode step gathers them — a [L, B, rb, in],
b [L, B, out, rb], scale [B]): the q/k/v and gate/up deltas apply as
`lora_epilogue` on the fused projections' slices, wo and w_down pass
theirs to `linear`, which folds them into the fused kernel's writeback
where JAX's eligibility rule admits the width.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from bigdl_tpu_torch import kvcache
from bigdl_tpu_torch.kvcache import KVCache
from bigdl_tpu_torch.kvpaged import PagedKVCache
from bigdl_tpu_torch.models.config import ModelConfig
from bigdl_tpu_torch.ops import (Linear, apply_rotary_emb, attention, kernels,
                                 rms_norm, rope_cos_sin)
from bigdl_tpu_torch.ops.linear import lora_epilogue
from bigdl_tpu_torch.ops.rope import make_inv_freq_scaled
from bigdl_tpu_torch.quant import QTensor, concat_rows, quantize_or_dense
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


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class DecoderLayer(nn.Module):
    """One decoder layer's weights: the `attn_norm`/`mlp_norm` weights and
    the projections in `proj` — wq/wk/wv, wo, w_gate/w_up, w_down as
    `init_params` makes them, wqkv, wo, w_gateup, w_down after
    `merge_fused_params`."""

    def __init__(self, attn_norm: torch.Tensor, mlp_norm: torch.Tensor,
                 proj: dict[str, Linear]):
        super().__init__()
        self.attn_norm = _frozen(attn_norm)
        self.mlp_norm = _frozen(mlp_norm)
        self.proj = nn.ModuleDict(proj)


class LlamaModel(nn.Module):
    """Embedding table, decoder layers, final norm and lm head."""

    def __init__(self, embed: torch.Tensor, layers: list[DecoderLayer],
                 final_norm: torch.Tensor, lm_head: Linear):
        super().__init__()
        self.embed = _frozen(embed)
        self.layers = nn.ModuleList(layers)
        self.final_norm = _frozen(final_norm)
        self.lm_head = lm_head


def make_trainable(model: LlamaModel) -> list[nn.Parameter]:
    """Turn on gradients for every leaf the full fine-tune trains (JAX's
    `make_full_train_step` differentiates the whole parameter tree): the
    embedding, the norms, every dense projection and the lm head.
    Quantized projections are buffers and cannot train (QLoRA trains
    adapters over them). Returns the parameters, for the optimizer."""
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
                dtype=torch.bfloat16, scale: float = 0.02) -> LlamaModel:
    """Random dense init in `dtype` on `device` (the card unless told
    otherwise), N(0, scale^2) weights from a seeded torch.Generator, unit
    norms, in the unfused layout."""
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


def quantize_params(model: LlamaModel, qtype: str,
                    lm_head_qtype: Optional[str] = None) -> LlamaModel:
    """Quantize every projection and the lm head, in place (each dense
    weight is freed as its QTensor replaces it); norms and the embedding
    stay dense. The lm head takes `lm_head_qtype`, else the head format a
    mixed alias names (q4_k_m: q4_k body, q6_k head), else `qtype`. A
    weight whose last dim the format cannot take stays dense, with a
    warning (`quantize_or_dense`). Returns `model`."""
    qtype, head_default = split_mixed_qtype(qtype)
    lm_head_qtype = lm_head_qtype or head_default
    spec = resolve_qtype(qtype)
    if spec.is_dense:
        return model
    for layer in model.layers:
        for name, lin in layer.proj.items():
            if lin.qtype is None:
                layer.proj[name] = Linear(
                    quantize_or_dense(lin.weight, spec.name, name), lin.bias)
    head = model.lm_head
    lm_spec = resolve_qtype(lm_head_qtype) if lm_head_qtype else spec
    if head.qtype is None and not lm_spec.is_dense:
        model.lm_head = Linear(
            quantize_or_dense(head.weight, lm_spec.name, "lm_head"), head.bias)
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
            cache: Optional[Union[KVCache, PagedKVCache]], mode: str = "prefill",
            compute_dtype=torch.bfloat16, last_logits_only: bool = False,
            start: Optional[torch.Tensor] = None,
            lora=None, remat: bool = False) -> tuple[torch.Tensor, Optional[KVCache]]:
    """Returns (logits [B, T, V] float32 — [B, 1, V] with
    last_logits_only — and the cache with pos advanced by T, or None
    without a cache). The cache is written in place; its pos is an int
    (rows aligned) or an int32 [B] tensor (per-row, the serving engine's
    pools). `start` [B] gives the left padding of the cache-free path (the
    cache carries its own); `lora` is a shared or batched adapter tree;
    `remat` (cache-free only) recomputes each layer in the backward."""
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
    inv_freq, att_scale = make_inv_freq_scaled(
        config.rotary_dim, config.rope_theta, config.rope_scaling_dict,
        seq_len=max_len, device=dev)
    cos, sin = rope_cos_sin(positions, inv_freq, scale=att_scale)

    # the JAX dispatch: a scalar-pos prefill through the flash kernel (no
    # [T, S] scores in memory), the cache-free path through the
    # differentiable flash kernels, a paged decode through the paged
    # kernel, the rest through the masked plain attention
    use_flash = T > 1 and (cache is None or (mode == "prefill" and not per_row))
    use_paged = isinstance(cache, PagedKVCache) and mode == "decode" and T == 1
    mask = None
    if not (use_flash or use_paged):
        sj = torch.arange(max_len, device=dev)
        slots = torch.arange(T, device=dev)[None, :] + (
            pos0.long()[:, None] if per_row else pos0)  # [B | 1, T]
        mask = ((sj[None, None, :] <= slots[..., None])
                & (sj[None, None, :] >= row_start[:, None, None]))
        mask = mask[:, None, None]  # [B, 1, 1, T, S]

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

    def decoder_layer(h, idx):
        layer = model.layers[idx]
        p = layer.proj
        x = rms_norm(h, layer.attn_norm, eps)
        if "wqkv" in p:  # fused layout; the adapters keep the unmerged names
            qkv = p["wqkv"](x, compute_dtype)
            q, k, v = qkv[..., :QD], qkv[..., QD:QD + KD], qkv[..., QD + KD:]
            q, k, v = (plus_delta(t, x, n, idx) for t, n in ((q, "wq"), (k, "wk"), (v, "wv")))
        else:
            q, k, v = (p[n](x, compute_dtype, lora=adapter(n, idx)) for n in ("wq", "wk", "wv"))
        q = q.reshape(B, T, Hq, D)
        k = k.reshape(B, T, Hkv, D)
        v = v.reshape(B, T, Hkv, D)
        q, k = apply_rotary_emb(q, k, cos, sin)

        if cache is None:
            attn = (kernels.flash_attention_train(q, k.to(compute_dtype),
                                                  v.to(compute_dtype),
                                                  start=row_start)
                    if use_flash else attention(q, k.to(compute_dtype),
                                                v.to(compute_dtype), mask))
        elif use_paged:
            kvcache.update_layer(cache, idx, k, v)
            attn = kernels.paged_attention(
                q[:, 0], cache.k, cache.v, cache.block_tables, idx,
                cache.pos, cache.start, cache.k_scale, cache.v_scale)[:, None]
        elif use_flash:
            kvcache.update_layer(cache, idx, k, v)
            # fp8 codes and scales go to the kernel's fp8 arm as they are
            k_att, v_att, k_sc, v_sc = kvcache.read_layer_raw(cache, idx)
            attn = kernels.flash_attention(q, k_att, v_att, start=row_start,
                                           q_offset=pos0, k_scale=k_sc,
                                           v_scale=v_sc)
        else:
            kvcache.update_layer(cache, idx, k, v)
            k_att, v_att = kvcache.read_layer(cache, idx, compute_dtype)
            attn = attention(q, k_att, v_att, mask)
        h = h + p["wo"](attn.reshape(B, T, QD), compute_dtype,
                        lora=adapter("wo", idx))

        x = rms_norm(h, layer.mlp_norm, eps)
        if "w_gateup" in p:
            gate, up = p["w_gateup"](x, compute_dtype).chunk(2, dim=-1)
            gate = plus_delta(gate, x, "w_gate", idx)
            up = plus_delta(up, x, "w_up", idx)
        else:
            gate, up = (p[n](x, compute_dtype, lora=adapter(n, idx)) for n in ("w_gate", "w_up"))
        return h + p["w_down"](F.silu(gate) * up, compute_dtype,
                               lora=adapter("w_down", idx))

    for idx in range(len(model.layers)):
        if remat and torch.is_grad_enabled():
            h = torch.utils.checkpoint.checkpoint(decoder_layer, h, idx,
                                                  use_reentrant=False)
        else:
            h = decoder_layer(h, idx)

    if last_logits_only:
        h = h[:, -1:]
    logits = lm_head_logits(config, model, h, compute_dtype)
    return logits, (None if cache is None else kvcache.advance(cache, T))
