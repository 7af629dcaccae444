"""Weight carry from the JAX package's parameter layout into the port.

`params_from_numpy` takes the JAX package's parameters as numpy arrays,
flattened under the key naming of its low-bit artifacts
(bigdl_tpu/convert/low_bit.py `_flatten`): a dense leaf under its dotted
path ("embed", "final_norm", "layers.attn_norm"), a QTensor's fields
under "<path>@<field>" ("layers.wqkv@data", "layers.wqkv@scales"), with
the qtype of each QTensor path in `qtypes`. Leaves under "layers." are
stacked [L, ...] and are split per layer here. bf16 leaves arrive as
float32 (exact) and are stored as bf16; packed codes stay uint8 and
scales float16. The projections come in the fused layout the JAX
package's `optimize_model` makes by default (wqkv, w_gateup), the only
one the port's `forward` runs.
"""

from __future__ import annotations

import numpy as np
import torch

from bigdl_tpu_torch.models.config import ModelConfig
from bigdl_tpu_torch.models.llama import (DecoderLayer, LlamaModel,
                                          check_supported)
from bigdl_tpu_torch.ops.linear import Linear
from bigdl_tpu_torch.quant import QTensor
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

    def weight(path, index=None):
        if path in qtypes:
            return QTensor(tensor(f"{path}@data", index),
                           tensor(f"{path}@scales", index), qtype=qtypes[path])
        return tensor(path, index)

    layers = []
    for i in range(config.num_hidden_layers):
        proj = {n: Linear(weight(f"layers.{n}", i)) for n in _PROJ}
        layers.append(DecoderLayer(tensor("layers.attn_norm", i),
                                   tensor("layers.mlp_norm", i), proj))
    return LlamaModel(tensor("embed"), layers, tensor("final_norm"),
                      Linear(weight("lm_head")))
