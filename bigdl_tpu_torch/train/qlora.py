"""QLoRA: LoRA adapters over a frozen low-bit base (port of
bigdl_tpu/train/qlora.py).

The base weights are buffers that get no gradient; only the adapters'
A and B are `nn.Parameter`s. The frozen quantized projections run fused in
both directions (ops/linear.py): the forward's y = x @ dq(W)^T through the
dequant GEMM (with the LoRA epilogue on wo and w_down), the backward's
dx = g @ dq(W) through the dequant dx kernel, and attention through the
differentiable flash kernels — no bf16 copy of a weight and no [T, T]
probability matrix is kept for the backward.

JAX's step is one jitted function returning new adapters and optimizer
state; here `make_train_step` returns a step that runs forward, backward
and a torch optimizer's update in place, the optimizer holding its own
state. `remat=True` recomputes each decoder layer in the backward
(`torch.utils.checkpoint`, JAX's `jax.checkpoint` around the scan body);
`fused_backward=False` sends every quantized projection's dx of that
step through the dequantize-then-matmul path (JAX's rematerialized-
dequant oracle, `ops.linear.fused_backward_scope`). `seq_spec`/
`ring_mesh` (sequence-parallel and ring attention) raise until ported.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from bigdl_tpu_torch.models.config import ModelConfig
from bigdl_tpu_torch.quant import QTensor, quantize
from bigdl_tpu_torch.utils import resolve_device

DEFAULT_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

# lora target -> (merged base name, row-slice index) for the fused layout
# (models/llama.merge_fused_params)
_MERGED_HOME = {
    "wq": ("wqkv", 0), "wk": ("wqkv", 1), "wv": ("wqkv", 2),
    "w_gate": ("w_gateup", 0), "w_up": ("w_gateup", 1),
}


def _target_dims(config: ModelConfig, name: str) -> tuple[int, int]:
    H, I = config.hidden_size, config.intermediate_size
    return {
        "wq": (config.q_dim, H),
        "wk": (config.kv_dim, H),
        "wv": (config.kv_dim, H),
        "wo": (H, config.q_dim),
        "w_gate": (I, H),
        "w_up": (I, H),
        "w_down": (H, I),
    }[name]


class LoRA(nn.Module):
    """Adapters of every layer: `layers[target]["a"]` [L, r, in] and
    `layers[target]["b"]` [L, out, r] parameters, and the fixed alpha/rank
    `scale` buffer (JAX's {'layers': {target: {'a', 'b'}}, 'scale'} tree).
    The targets keep the unmerged projection names whatever the base's
    layout."""

    def __init__(self, layers: dict[str, tuple[torch.Tensor, torch.Tensor]],
                 scale: torch.Tensor):
        super().__init__()
        self.layers = nn.ModuleDict({
            t: nn.ParameterDict({"a": nn.Parameter(a), "b": nn.Parameter(b)})
            for t, (a, b) in layers.items()})
        self.register_buffer("scale", scale)


def init_lora(config: ModelConfig, seed: int = 0, rank: int = 8,
              alpha: float = 16.0, targets: tuple[str, ...] = DEFAULT_TARGETS,
              dtype=torch.bfloat16, device=None) -> LoRA:
    """Adapters on `device` (the card unless told otherwise): A ~ N(0, 1)
    / rank from a seeded torch.Generator, B = 0 (the adapter starts as
    the identity), scale alpha / rank."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    L = config.num_hidden_layers
    layers = {}
    for t in targets:
        out_dim, in_dim = _target_dims(config, t)
        a = torch.randn((L, rank, in_dim), generator=g, device=dev,
                        dtype=torch.float32) / rank
        layers[t] = (a.to(dtype), torch.zeros((L, out_dim, rank), dtype=dtype,
                                              device=dev))
    return LoRA(layers, torch.tensor(alpha / rank, dtype=dtype, device=dev))


def adamw(lora: LoRA, learning_rate: float = 1e-4,
          weight_decay: float = 1e-4) -> torch.optim.AdamW:
    """The torch counterpart of `optax.adamw(learning_rate)`:
    betas (0.9, 0.999), eps 1e-8 and weight_decay 1e-4 are optax's
    defaults. torch's own AdamW default, weight_decay=0.01, is not."""
    return torch.optim.AdamW(lora.parameters(), lr=learning_rate,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def _delta_rows(model, lora: LoRA, target: str, layer: int) -> tuple[str, Optional[int], torch.Tensor]:
    """(base name, first row or None, f32 delta [out, in]) of one target
    in one layer. Row offsets inside a fused base come from the target's
    own B width and the base's total rows, never from its peers (an
    adapter trained on wk/wv alone still lands in the k/v rows)."""
    pair = lora.layers[target]
    scale = lora.scale.float()
    delta = (pair["b"][layer].float() @ pair["a"][layer].float()) * scale
    proj = model.layers[layer].proj
    if target in proj:
        return target, None, delta
    if target not in _MERGED_HOME or _MERGED_HOME[target][0] not in proj:
        raise KeyError(f"lora target {target!r} not found in the model "
                       "(neither split nor fused layout)")
    name = _MERGED_HOME[target][0]
    total = proj[name].w.shape[-2]
    width = delta.shape[0]
    if name == "wqkv":
        row = {"wq": 0, "wk": total - 2 * width, "wv": total - width}[target]
    else:  # w_gateup: gate rows first, both halves share width I
        row = 0 if target == "w_gate" else total // 2
    return name, row, delta


@torch.no_grad()
def merge_lora(model, lora: LoRA, requantize: Optional[str] = None):
    """Fold the adapters into the base, in place (ReLoRA's merge step);
    returns `model`. Dense bases merge exactly; quantized bases are
    dequantized, merged and quantized again to `requantize` (their own
    format by default). Both layouts: in a fused base each target's delta
    lands in its row slice, and every base is quantized once after all
    its deltas are added, so quantization noise does not compound."""
    from bigdl_tpu_torch.ops.linear import Linear

    for i, layer in enumerate(model.layers):
        pending: dict[str, list] = {}
        for t in lora.layers:
            name, row, delta = _delta_rows(model, lora, t, i)
            pending.setdefault(name, []).append((row, delta))
        for name, deltas in pending.items():
            lin = layer.proj[name]
            base = lin.w
            quantized = isinstance(base, QTensor)
            dense = base.dequantize(torch.float32) if quantized else base.float()
            for row, delta in deltas:
                if row is None:
                    dense = dense + delta
                else:
                    dense[row:row + delta.shape[0]] += delta
            merged = (quantize(dense, requantize or base.qtype) if quantized
                      else dense.to(base.dtype))
            layer.proj[name] = Linear(merged, lin.bias)
    return model


def next_token_loss(config: ModelConfig, forward_fn: Callable, model,
                    lora: Optional[LoRA], tokens: torch.Tensor,
                    loss_mask: torch.Tensor) -> torch.Tensor:
    """Causal LM cross-entropy: predict tokens[:, 1:] from tokens[:, :-1];
    loss_mask [B, T] is 1.0 where the target token counts."""
    logits, _ = forward_fn(config, model, tokens[:, :-1], None, lora=lora)
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    mask = loss_mask[:, 1:].float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def make_train_step(config: ModelConfig, forward_fn: Callable,
                    optimizer: torch.optim.Optimizer, seq_spec=None,
                    ring_mesh=None, remat: bool = False,
                    return_grad_norm: bool = False,
                    fused_backward: bool = True) -> Callable:
    """Returns step(model, lora, tokens, loss_mask) -> loss: one forward,
    backward and `optimizer` update of the adapters in place (build the
    optimizer over `lora.parameters()`, e.g. with `adamw`). Only the
    adapters train; the base and the scale stay fixed.
    return_grad_norm=True returns (loss, global norm of the gradients),
    the training supervisor's overflow guard. remat=True recomputes each
    layer in the backward (`forward_fn` takes `remat=`, as llama.forward
    does); fused_backward=False takes the dequantize-then-matmul dx."""
    if seq_spec is not None or ring_mesh is not None:
        raise NotImplementedError(
            "make_train_step(seq_spec=..., ring_mesh=...): ROADMAP queue 1 "
            "item 8, sequence-parallel and ring-attention training are still "
            "to be ported")
    inner_forward = forward_fn
    if remat:
        def inner_forward(cfg, model, toks, cache, lora=None):
            return forward_fn(cfg, model, toks, cache, lora=lora, remat=True)

    def step(model, lora: LoRA, tokens: torch.Tensor,
             loss_mask: torch.Tensor):
        from bigdl_tpu_torch.ops.linear import fused_backward_scope

        optimizer.zero_grad(set_to_none=True)
        # the backward inside the scope too: a remat layer reruns its
        # forward there
        with fused_backward_scope(fused_backward):
            loss = next_token_loss(config, inner_forward, model, lora, tokens,
                                   loss_mask)
            loss.backward()
        norm = None
        if return_grad_norm:
            grads = [p.grad.float() for p in lora.parameters() if p.grad is not None]
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
        optimizer.step()
        loss = loss.detach()
        return (loss, norm) if return_grad_norm else loss

    return step
