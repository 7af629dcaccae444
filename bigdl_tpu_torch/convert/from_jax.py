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
projections, the post-norms and q/k norms on the layers; a tied model
has no lm_head. An MoE model's layers hold the attention's projections
(wqkv, wo or wq/wk/wv, wo) and, in place of the gated MLP, the leaves of
its `MoEBlock`: the router, the experts w_gate_e/w_up_e/w_down_e stacked
[L, E, ...] (QTensors whose fields are [L, E, rows, *]) and qwen2-moe's
w_gate_s/w_up_s/w_down_s and shared_gate.

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
from bigdl_tpu_torch.models.llama import (BIAS_OF, MOE_EXPERTS, MOE_LEAVES, MOE_SHARED,
                                          OPTIONAL_NORMS, DecoderLayer, LlamaModel,
                                          MoEBlock, check_supported)
from bigdl_tpu_torch.ops.linear import Linear
from bigdl_tpu_torch.quant import ARRAY_FIELDS, QTensor, resolve_qtype
from bigdl_tpu_torch.quant.numerics import FP8_DTYPE
from bigdl_tpu_torch.train.qlora import DEFAULT_TARGETS, LoRA, _target_dims
from bigdl_tpu_torch.utils import resolve_device

_NORMS = ("attn_norm", "mlp_norm")
# the projections of each layout: fused (optimize_model) and unfused
# (init_params); an MoE layer has the attention's only, beside its experts
_LAYOUTS = (("wqkv", "wo", "w_gateup", "w_down"),
            ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"))
_MOE_LAYOUTS = (("wqkv", "wo"), ("wq", "wk", "wv", "wo"))


def _moe_leaves(config: ModelConfig) -> tuple[str, ...]:
    if not config.is_moe:
        return ()
    if config.shared_expert_intermediate_size:
        return MOE_LEAVES
    return ("router",) + MOE_EXPERTS


def _required_norms(config: ModelConfig) -> tuple[str, ...]:
    return ((("post_attn_norm", "post_mlp_norm") if config.post_attn_norm else ())
            + (("q_norm", "k_norm") if config.qk_norm else ()))


def params_from_numpy(arrays: dict[str, np.ndarray], qtypes: dict[str, str],
                      config: ModelConfig, device=None,
                      dtype=torch.bfloat16) -> LlamaModel:
    """The port's model holding exactly the given weights, on `device`;
    dense float leaves in `dtype`, or in their own type if it is None.
    Besides the projections, the tree may hold each projection's bias
    under JAX's name (bq/bk/bv or bqkv, bo, b_gate/b_up or b_gateup,
    b_down), the optional norms the config's flags ask for
    (post_attn_norm/post_mlp_norm, q_norm/k_norm) and, when the head is
    tied, no lm_head."""
    check_supported(config)
    dev = resolve_device(device)
    paths = {k.split("@")[0] for k in arrays}
    moe = _moe_leaves(config)
    layout = next((names for names in (_MOE_LAYOUTS if moe else _LAYOUTS)
                   if {f"layers.{n}" for n in names} <= paths), None)
    if layout is None:
        raise ValueError(
            "params_from_numpy: the layer projections are neither the fused "
            "layout (wqkv, wo, w_gateup, w_down) nor the unfused one (wq, wk, "
            "wv, wo, w_gate, w_up, w_down), or (wqkv, wo) or (wq, wk, wv, wo) "
            "beside experts; a layout mixing the two is unmerged in part")
    known = {"embed", "final_norm", "lm_head"} | {
        f"layers.{n}" for n in _NORMS + layout + OPTIONAL_NORMS + moe
        + tuple(BIAS_OF[n] for n in layout)}
    unknown = sorted(p for p in paths if p not in known)
    if unknown:
        raise NotImplementedError(
            f"params_from_numpy: leaves {unknown} belong to llama flags this "
            "port does not run yet (ROADMAP queue 1 item [4]), or mix layouts")
    missing = [n for n in _required_norms(config) + moe if f"layers.{n}" not in paths]
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
                             {n: Linear(weight(f"layers.{n}", i)) for n in moe
                              if n in MOE_EXPERTS + MOE_SHARED},
                             optional("layers.shared_gate", i))
        layers.append(DecoderLayer(tensor("layers.attn_norm", i),
                                   tensor("layers.mlp_norm", i), proj, block, **norms))
    head = Linear(weight("lm_head")) if "lm_head" in paths else None
    return LlamaModel(weight("embed"), layers, tensor("final_norm"), head)


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
            if name in MOE_LEAVES:
                return None if layer.moe is None else layer.moe.leaves().get(name)
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
    tree = {"embed": model.embed, "final_norm": model.final_norm}
    if model.lm_head is not None:
        tree["lm_head"] = leaf(model.lm_head)
    if layers:
        names = (_NORMS + OPTIONAL_NORMS + tuple(layers[0].proj)
                 + tuple(BIAS_OF[n] for n in layers[0].proj) + MOE_LEAVES)
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
