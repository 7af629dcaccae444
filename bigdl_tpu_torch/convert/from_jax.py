"""Weight carry from the JAX package's parameter layout into the port.

`params_from_numpy` takes the JAX package's parameters as numpy arrays,
flattened under the key naming of its low-bit artifacts
(bigdl_tpu/convert/low_bit.py `_flatten`): a dense leaf under its dotted
path ("embed", "final_norm", "layers.attn_norm"), a QTensor's fields
under "<path>@<field>" ("layers.wqkv@data", "layers.wqkv@scales",
"@mins", "@sub_scales", "@sub_mins" where the format has them), with the
qtype of each QTensor path in `qtypes`. Leaves under "layers." are
stacked [L, ...] and are split per layer here. bf16 leaves arrive as
float32 (exact) and are stored as bf16 (`dtype=None` keeps each dense
leaf's own type instead: the f32 parameters of a full fine-tune); codes
and sub-scales keep their integer types, scales and mins float16, and fp8
codes (numpy float8 arrays, as the JAX package holds them) become torch's
float8 types through their uint8 bytes. The projections come in either
layout the port's `forward` runs: the fused one the JAX package's
`optimize_model` makes by default (wqkv, w_gateup), or the unfused one of
its `init_params` (wq/wk/wv, w_gate/w_up).

The embedding may be low-bit (`embedding.quantize_embedding`): its
fields ride under "embed@<field>" as any QTensor's, both ways. A
HostEmbedding has no place in the flattening, and `params_to_numpy`
refuses it.

The leaves of the llama flags ride along under JAX's names: the biases
(bq/bk/bv or bqkv, bo, b_gate/b_up or b_gateup, b_down) on their
projections, the norms' biases (attn_norm_b, mlp_norm_b), post-norms and
q/k norms on the layers; final_norm_b, gpt2's wpe, bloom's embed_norm and
embed_norm_b on the model, lm_head_b on the lm head; a tied model has no
lm_head. A plain fc -> act -> proj MLP has w_up and w_down only. An MoE
model's layers hold the attention's projections (wqkv, wo or wq/wk/wv,
wo) and, in place of the MLP, the leaves of its `MoEBlock`: the router,
the experts w_gate_e/w_up_e/w_down_e stacked [L, E, ...] (QTensors whose
fields are [L, E, rows, *]; phixtral's have no w_gate_e and carry
b_up_e/b_down_e), qwen2-moe's w_gate_s/w_up_s/w_down_s and shared_gate,
and the dense MLP's biases JAX's init_params makes beside experts under
mlp_bias (unused).

`params_to_numpy` is the inverse: the port's model flattened under the
same naming, in the artifact's stored form, for `convert/low_bit.py`'s
`save_low_bit`.

`lora_from_numpy` carries a JAX LoRA tree (train/qlora.py `init_lora`:
{'layers': {target: {'a': [L, r, in], 'b': [L, out, r]}}, 'scale'}) the
same way, keyed "layers.<target>.a" / "layers.<target>.b" and "scale".
"""

from __future__ import annotations

import numpy as np
import torch

from bigdl_tpu_torch.embedding import HostEmbedding
from bigdl_tpu_torch.models.config import ModelConfig
from bigdl_tpu_torch.models.llama import (BIAS_OF, MOE_BIAS_OF, MOE_EXPERTS, MOE_LEAVES,
                                          MOE_SHARED, MOE_UNUSED, OPTIONAL_NORMS, TOP_LEAVES,
                                          DecoderLayer, LlamaModel, MoEBlock, check_supported)
from bigdl_tpu_torch.ops.linear import Linear
from bigdl_tpu_torch.quant import ARRAY_FIELDS, QTensor, resolve_qtype
from bigdl_tpu_torch.quant.numerics import FP8_DTYPE
from bigdl_tpu_torch.train.qlora import DEFAULT_TARGETS, LoRA, _target_dims
from bigdl_tpu_torch.utils import resolve_device

_NORMS = ("attn_norm", "mlp_norm")
# the attention's projections of each layout: fused (optimize_model) and
# unfused (init_params); the MLP's follow, by its kind (none beside
# experts)
_ATTENTION = (("wqkv", "wo"), ("wq", "wk", "wv", "wo"))
_MLP = {"gated": (("w_gateup", "w_down"), ("w_gate", "w_up", "w_down")),
        "plain": (("w_up", "w_down"), ("w_up", "w_down")), "moe": ((), ())}


def _layouts(config: ModelConfig) -> tuple[tuple[str, ...], ...]:
    kind = "moe" if config.is_moe else "gated" if config.gated_mlp else "plain"
    return tuple(a + m for a, m in zip(_ATTENTION, _MLP[kind]))


def _moe_leaves(config: ModelConfig) -> tuple[str, ...]:
    """The MoE leaves the config needs (the biases are optional)."""
    if not config.is_moe:
        return ()
    experts = MOE_EXPERTS if config.gated_mlp else MOE_EXPERTS[1:]
    shared = MOE_SHARED + ("shared_gate",) if config.shared_expert_intermediate_size else ()
    return ("router",) + experts + shared


def _required(config: ModelConfig) -> tuple[str, ...]:
    """The optional leaves the config's flags need, as JAX's forward reads
    them without a default."""
    return (tuple(f"layers.{n}" for n in (
        (("post_attn_norm", "post_mlp_norm") if config.post_attn_norm else ())
        + (("q_norm", "k_norm") if config.qk_norm else ()) + _moe_leaves(config)))
        + (("wpe",) if config.learned_positions else ())
        + (("embed_norm",) if config.embed_layernorm else ()))


def params_from_numpy(arrays: dict[str, np.ndarray], qtypes: dict[str, str],
                      config: ModelConfig, device=None,
                      dtype=torch.bfloat16) -> LlamaModel:
    """The port's model holding exactly the given weights, on `device`;
    dense float leaves in `dtype`, or in their own type if it is None.
    Besides the projections, the tree may hold each projection's bias
    under JAX's name (bq/bk/bv or bqkv, bo, b_gate/b_up or b_gateup,
    b_down), the optional norms and norm biases, the `TOP_LEAVES`, the lm
    head's bias and, when the head is tied, no lm_head; those the
    config's flags need must be there."""
    check_supported(config)
    dev = resolve_device(device)
    paths = {k.split("@")[0] for k in arrays}
    moe = MOE_LEAVES if config.is_moe else ()
    layout = next((names for names in _layouts(config)
                   if {f"layers.{n}" for n in names} <= paths), None)
    if layout is None:
        raise ValueError(
            "params_from_numpy: the layer projections are neither the fused "
            "layout (wqkv, wo, then w_gateup, w_down; w_up, w_down in a plain "
            "MLP; none beside experts) nor the unfused one (wq, wk, wv, wo, "
            "then w_gate, w_up, w_down; w_up, w_down in a plain MLP); a layout "
            "mixing the two is unmerged in part")
    known = {"embed", "final_norm", "lm_head", "lm_head_b", *TOP_LEAVES} | {
        f"layers.{n}" for n in _NORMS + layout + OPTIONAL_NORMS + moe
        + tuple(BIAS_OF[n] for n in layout)}
    unknown = sorted(p for p in paths if p not in known)
    if unknown:
        raise ValueError(
            f"params_from_numpy: leaves {unknown} are not the config's "
            f"(layout {layout}), or mix layouts")
    missing = [n for n in _required(config) if n not in paths]
    if "lm_head" not in paths and not config.tie_word_embeddings:
        missing.append("lm_head")
    if missing:
        raise ValueError(f"params_from_numpy: the config's flags need {missing}, "
                         "which the arrays do not hold")

    def tensor(key, index=None):
        a = arrays[key] if index is None else arrays[key][index]
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
        if t.is_floating_point() and t.dtype != torch.float16 and dtype is not None:
            t = t.to(dtype)
        return t.to(dev)

    def field(key, index, qtype):
        a = arrays[key] if index is None else arrays[key][index]
        if key.endswith("@data") and qtype in FP8_DTYPE:
            if isinstance(a, torch.Tensor):
                return a.view(FP8_DTYPE[qtype]).to(dev)
            return torch.from_numpy(np.array(a).view(np.uint8)).view(FP8_DTYPE[qtype]).to(dev)
        return tensor(key, index)

    def weight(path, index=None):
        if path in qtypes:
            qtype = resolve_qtype(qtypes[path]).name
            return QTensor(qtype=qtype, **{
                f: field(f"{path}@{f}", index, qtype) for f in ARRAY_FIELDS
                if f"{path}@{f}" in arrays})
        return tensor(path, index)

    def optional(path, index):
        return tensor(path, index) if path in paths else None

    layers = []
    for i in range(config.num_hidden_layers):
        proj = {n: Linear(weight(f"layers.{n}", i), optional(f"layers.{BIAS_OF[n]}", i))
                for n in layout}
        norms = {n: optional(f"layers.{n}", i) for n in OPTIONAL_NORMS}
        block = None
        if moe:
            block = MoEBlock(weight("layers.router", i),
                             {n: Linear(weight(f"layers.{n}", i),
                                        optional(f"layers.{MOE_BIAS_OF[n]}", i)
                                        if n in MOE_BIAS_OF else None)
                              for n in MOE_EXPERTS + MOE_SHARED if f"layers.{n}" in paths},
                             optional("layers.shared_gate", i),
                             **{n: optional(f"layers.{n}", i) for n in MOE_UNUSED})
        layers.append(DecoderLayer(tensor("layers.attn_norm", i),
                                   tensor("layers.mlp_norm", i), proj, block, **norms))
    head = (Linear(weight("lm_head"), optional("lm_head_b", None)) if "lm_head" in paths
            else None)
    return LlamaModel(weight("embed"), layers, tensor("final_norm"), head,
                      **{n: optional(n, None) for n in TOP_LEAVES})


def params_to_numpy(model: LlamaModel) -> tuple[dict[str, np.ndarray], dict[str, dict]]:
    """The inverse of `params_from_numpy`: (arrays, manifest) as the JAX
    package's artifact flattens its tree (bigdl_tpu/convert/low_bit.py
    `_flatten`): dense leaves by dotted path, a QTensor's present fields
    as "<path>@<field>" in ARRAY_FIELDS order, per-layer leaves stacked
    [L, ...] under "layers.", keys in the order the JAX tree's sorted
    dicts give them. Arrays are host copies in their stored form (bf16 and
    fp8 as unsigned bit views, `utils.durability.encode_array`); the
    manifest maps each key to {"kind": "array", "dtype": name} and each
    QTensor path to {"kind": "qtensor", "qtype": ...}."""
    from bigdl_tpu_torch.utils.durability import encode_array

    def leaf(t):
        return t.w if isinstance(t, Linear) else t

    layers = list(model.layers)
    if any(set(layer.proj) != set(layers[0].proj) for layer in layers):
        raise ValueError("params_to_numpy: the layers mix the fused and unfused layouts")

    def per_layer(name):
        """Layer i's leaf `name` (a norm, a projection or its bias, an MoE
        leaf), or None."""
        def get(layer):
            if name in _NORMS or name in OPTIONAL_NORMS:
                return getattr(layer, name)
            if name in layer.proj:
                return leaf(layer.proj[name])
            if layer.moe is not None and name in MOE_LEAVES:
                return layer.moe.leaves().get(name)
            lin = next(layer.proj[n] for n, b in BIAS_OF.items() if b == name)
            return lin.bias
        return [get(layer) for layer in layers]

    def stacked(vals, name):
        if any((v is None) != (vals[0] is None) for v in vals):
            raise ValueError(f"params_to_numpy: layers.{name} is in some layers only")
        if isinstance(vals[0], QTensor):
            if len({v.qtype for v in vals}) != 1:
                raise ValueError(f"params_to_numpy: layers.{name} mixes formats")
            return QTensor(qtype=vals[0].qtype, **{
                f: torch.stack([getattr(v, f).detach().cpu() for v in vals])
                for f in ARRAY_FIELDS if getattr(vals[0], f) is not None})
        return torch.stack([v.detach().cpu() for v in vals])

    if isinstance(model.embed, HostEmbedding):
        raise ValueError("params_to_numpy: the embedding is a HostEmbedding, a table "
                         "on the host that the artifact does not carry (the JAX "
                         "package refuses it too); save with the dense or low-bit table")
    tree = {"embed": model.embed, "final_norm": model.final_norm, **model.top_leaves()}
    if model.lm_head is not None:
        tree["lm_head"] = leaf(model.lm_head)
        if model.lm_head.bias is not None:
            tree["lm_head_b"] = model.lm_head.bias
    if layers:
        names = (_NORMS + OPTIONAL_NORMS + tuple(layers[0].proj)
                 + tuple(BIAS_OF[n] for n in layers[0].proj)
                 + (MOE_LEAVES if layers[0].moe is not None else ()))
        tree["layers"] = {}
        for n in names:
            vals = per_layer(n)
            if vals[0] is not None:
                tree["layers"][n] = stacked(vals, n)
    arrays: dict[str, np.ndarray] = {}
    manifest: dict[str, dict] = {}

    def flatten(node, prefix):
        if isinstance(node, QTensor):
            manifest[prefix] = {"kind": "qtensor", "qtype": node.qtype}
            for f in ARRAY_FIELDS:
                val = getattr(node, f)
                if val is not None:
                    arrays[f"{prefix}@{f}"], dt = encode_array(val)
                    manifest[f"{prefix}@{f}"] = {"kind": "array", "dtype": dt}
        elif isinstance(node, dict):
            for k in sorted(node):
                flatten(node[k], f"{prefix}.{k}" if prefix else k)
        else:
            arrays[prefix], dt = encode_array(node)
            manifest[prefix] = {"kind": "array", "dtype": dt}

    flatten(tree, "")
    return arrays, manifest


def lora_from_numpy(arrays: dict[str, np.ndarray], config: ModelConfig,
                    device=None, dtype=torch.bfloat16) -> LoRA:
    """The port's adapters holding exactly the given LoRA arrays, on
    `device`: "layers.<target>.a" [L, r, in], "layers.<target>.b"
    [L, out, r] (bf16 values, e.g. widened to float32) and the scalar
    "scale"."""
    dev = resolve_device(device)
    targets = sorted({k.split(".")[1] for k in arrays if k.startswith("layers.")})
    unknown = [t for t in targets if t not in DEFAULT_TARGETS]
    if unknown or "scale" not in arrays:
        raise ValueError(f"lora_from_numpy: unknown targets {unknown} or no "
                         "'scale' among the arrays")
    L = config.num_hidden_layers
    layers = {}
    for t in targets:
        a = torch.from_numpy(np.array(arrays[f"layers.{t}.a"], np.float32))
        b = torch.from_numpy(np.array(arrays[f"layers.{t}.b"], np.float32))
        out_dim, in_dim = _target_dims(config, t)
        r = a.shape[1]
        if a.shape != (L, r, in_dim) or b.shape != (L, out_dim, r):
            raise ValueError(f"lora_from_numpy: {t} has a {tuple(a.shape)}, b "
                             f"{tuple(b.shape)}; the config wants [{L}, r, "
                             f"{in_dim}] and [{L}, {out_dim}, r]")
        layers[t] = (a.to(dtype).to(dev), b.to(dtype).to(dev))
    scale = torch.tensor(float(np.asarray(arrays["scale"])), dtype=dtype, device=dev)
    return LoRA(layers, scale)
