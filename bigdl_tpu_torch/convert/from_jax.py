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

`lora_from_numpy` carries a JAX LoRA tree (train/qlora.py `init_lora`:
{'layers': {target: {'a': [L, r, in], 'b': [L, out, r]}}, 'scale'}) the
same way, keyed "layers.<target>.a" / "layers.<target>.b" and "scale".
"""

from __future__ import annotations

import numpy as np
import torch

from bigdl_tpu_torch.models.config import ModelConfig
from bigdl_tpu_torch.models.llama import (DecoderLayer, LlamaModel,
                                          check_supported)
from bigdl_tpu_torch.ops.linear import Linear
from bigdl_tpu_torch.quant import ARRAY_FIELDS, QTensor, resolve_qtype
from bigdl_tpu_torch.quant.numerics import FP8_DTYPE
from bigdl_tpu_torch.train.qlora import DEFAULT_TARGETS, LoRA, _target_dims
from bigdl_tpu_torch.utils import resolve_device

_NORMS = ("attn_norm", "mlp_norm")
# the projections of each layout: fused (optimize_model) and unfused (init_params)
_LAYOUTS = (("wqkv", "wo", "w_gateup", "w_down"),
            ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"))


def params_from_numpy(arrays: dict[str, np.ndarray], qtypes: dict[str, str],
                      config: ModelConfig, device=None,
                      dtype=torch.bfloat16) -> LlamaModel:
    """The port's model holding exactly the given weights, on `device`;
    dense float leaves in `dtype`, or in their own type if it is None."""
    check_supported(config)
    dev = resolve_device(device)
    paths = {k.split("@")[0] for k in arrays}
    layout = next((names for names in _LAYOUTS
                   if {f"layers.{n}" for n in names} <= paths), None)
    if layout is None:
        raise ValueError(
            "params_from_numpy: the layer projections are neither the fused "
            "layout (wqkv, wo, w_gateup, w_down) nor the unfused one (wq, wk, "
            "wv, wo, w_gate, w_up, w_down); a layout mixing the two is unmerged "
            "in part")
    known = {"embed", "final_norm", "lm_head"} | {
        f"layers.{n}" for n in _NORMS + layout}
    unknown = sorted(p for p in paths if p not in known)
    if unknown:
        raise NotImplementedError(
            f"params_from_numpy: leaves {unknown} belong to llama flags "
            "this port does not run yet (ROADMAP queue 1), or mix layouts")

    def tensor(key, index=None):
        a = arrays[key] if index is None else arrays[key][index]
        t = torch.from_numpy(np.array(a))
        if t.is_floating_point() and t.dtype != torch.float16 and dtype is not None:
            t = t.to(dtype)
        return t.to(dev)

    def field(key, index, qtype):
        a = np.array(arrays[key] if index is None else arrays[key][index])
        if key.endswith("@data") and qtype in FP8_DTYPE:
            return torch.from_numpy(a.view(np.uint8)).view(FP8_DTYPE[qtype]).to(dev)
        return tensor(key, index)

    def weight(path, index=None):
        if path in qtypes:
            qtype = resolve_qtype(qtypes[path]).name
            return QTensor(qtype=qtype, **{
                f: field(f"{path}@{f}", index, qtype) for f in ARRAY_FIELDS
                if f"{path}@{f}" in arrays})
        return tensor(path, index)

    layers = []
    for i in range(config.num_hidden_layers):
        proj = {n: Linear(weight(f"layers.{n}", i)) for n in layout}
        layers.append(DecoderLayer(tensor("layers.attn_norm", i),
                                   tensor("layers.mlp_norm", i), proj))
    return LlamaModel(tensor("embed"), layers, tensor("final_norm"),
                      Linear(weight("lm_head")))


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
