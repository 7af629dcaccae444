"""Weight carry from the JAX package's parameter layout into the port.

`params_from_numpy` takes the JAX package's parameters as numpy arrays,
flattened under the key naming of its low-bit artifacts
(bigdl_tpu/convert/low_bit.py `_flatten`): a dense leaf under its dotted
path ("embed", "final_norm", "layers.attn_norm"), a QTensor's fields
under "<path>@<field>" ("layers.wqkv@data", "layers.wqkv@scales",
"@mins", "@sub_scales", "@sub_mins" where the format has them), with the
qtype of each QTensor path in `qtypes`. Leaves under "layers." are
stacked [L, ...] and are split per layer here. bf16 leaves arrive as
float32 (exact) and are stored as bf16; codes and sub-scales keep their
integer types, scales and mins float16, and fp8 codes (numpy float8
arrays, as the JAX package holds them) become torch's float8 types
through their uint8 bytes. The projections come in the fused layout the JAX
package's `optimize_model` makes by default (wqkv, w_gateup), the only
one the port's `forward` runs.

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
_PROJ = ("wqkv", "wo", "w_gateup", "w_down")
_UNMERGED = ("wq", "wk", "wv", "w_gate", "w_up")


def params_from_numpy(arrays: dict[str, np.ndarray], qtypes: dict[str, str],
                      config: ModelConfig, device=None) -> LlamaModel:
    """The port's model holding exactly the given weights, on `device`."""
    check_supported(config)
    dev = resolve_device(device)
    known = {"embed", "final_norm", "lm_head"} | {
        f"layers.{n}" for n in _NORMS + _PROJ}
    unmerged = sorted(k for k in arrays if k.split("@")[0] in
                      {f"layers.{n}" for n in _UNMERGED})
    if unmerged:
        raise ValueError(
            f"params_from_numpy: leaves {unmerged} are unmerged; the port "
            "takes the fused layout (wqkv, w_gateup) — merge them with the "
            "JAX package's merge_fused_params first")
    unknown = sorted(k for k in arrays if k.split("@")[0] not in known)
    if unknown:
        raise NotImplementedError(
            f"params_from_numpy: leaves {unknown} belong to llama flags "
            "this port does not run yet (ROADMAP queue 1)")

    def tensor(key, index=None):
        a = arrays[key] if index is None else arrays[key][index]
        t = torch.from_numpy(np.array(a))
        if t.is_floating_point() and t.dtype != torch.float16:
            t = t.to(torch.bfloat16)
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
        proj = {n: Linear(weight(f"layers.{n}", i)) for n in _PROJ}
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
