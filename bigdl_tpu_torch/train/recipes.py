"""Finetuning recipes beyond plain QLoRA (port of
bigdl_tpu/train/recipes.py): the full fine-tune of a dense model, LISA's
per-layer freezing, and ReLoRA's merge-and-reset.

JAX's recipes are pure functions over (params, opt_state) and return new
ones; here the step updates the model's parameters in place through a
torch optimizer that holds its own state, as `train.qlora` does.

- Full fine-tune (`make_full_train_step`): every dense leaf trains — the
  norms, every projection (its dW through the dW kernel, ops/linear.py),
  the lm head and, with `train_embed`, the embedding. Turn the gradients
  on with `models.llama.make_trainable` and build the optimizer over what
  it returns (`train.galore.GaLore` is what lets an 8B model's full
  fine-tune fit on one card).
- LISA (`sample_lisa_mask`, `apply_layer_mask`): a random subset of
  layers trains each interval; the others' gradients are zeroed before
  the optimizer, as JAX zeroes its stacked leaves'. `sample_lisa_mask`
  draws from a `torch.Generator`, which gives other layers than
  `jax.random.permutation` from the same seed: tests hand both packages
  the same mask.
- ReLoRA (`relora_reset`, `ReLoRASchedule`): high-rank updates from a
  sequence of low-rank phases — merge the adapters into the base,
  restart them as the identity and restart the optimizer cold.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from bigdl_tpu_torch.models.config import ModelConfig
from bigdl_tpu_torch.train.qlora import LoRA, init_lora, merge_lora, next_token_loss


# ---------------------------------------------------------------------------
# ReLoRA
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ReLoRAState:
    model: torch.nn.Module  # the base, merged so far
    lora: LoRA
    resets: int = 0


@torch.no_grad()
def relora_reset(config: ModelConfig, state: ReLoRAState,
                 optimizer: torch.optim.Optimizer, seed: int,
                 alpha: float = 16.0, requantize: Optional[str] = None) -> ReLoRAState:
    """Merge the adapters into the base (`merge_lora`, requantizing a
    quantized base to `requantize` or its own format), draw fresh adapters
    of the same targets and rank (`init_lora(seed)`: A random, B = 0, the
    identity) into the same parameters, and clear `optimizer`'s state so
    the phase starts cold (JAX re-inits its optax state). The adapters and
    the optimizer stay the same objects, so a step function built over
    them keeps working. Returns the state with `resets` + 1."""
    lora = state.lora
    targets = tuple(lora.layers.keys())
    a0 = lora.layers[targets[0]]["a"]
    merge_lora(state.model, lora, requantize=requantize)
    fresh = init_lora(config, seed, rank=a0.shape[1], alpha=alpha, targets=targets,
                      dtype=a0.dtype, device=a0.device)
    for t in targets:
        for ab in ("a", "b"):
            lora.layers[t][ab].copy_(fresh.layers[t][ab])
    lora.scale.copy_(fresh.scale)
    optimizer.state.clear()
    return ReLoRAState(model=state.model, lora=lora, resets=state.resets + 1)


class ReLoRASchedule:
    """Host side: call should_reset(step) each step; reset_every in steps
    (the reference's relora_steps)."""

    def __init__(self, reset_every: int, warmup: int = 0):
        self.reset_every = reset_every
        self.warmup = warmup

    def should_reset(self, step: int) -> bool:
        return (step > self.warmup and self.reset_every > 0
                and step % self.reset_every == 0)


# ---------------------------------------------------------------------------
# LISA
# ---------------------------------------------------------------------------

def sample_lisa_mask(generator: torch.Generator, n_layers: int,
                     n_active: int) -> torch.Tensor:
    """[L] float mask with exactly n_active ones (the layers that train
    this interval), on the generator's device."""
    perm = torch.randperm(n_layers, generator=generator, device=generator.device)
    return (perm < n_active).float()


@torch.no_grad()
def apply_layer_mask(layers, mask: torch.Tensor) -> None:
    """Scale every gradient of layer i by mask[i], in place: a frozen
    layer's gradients become 0. Parameters outside `layers` (embedding,
    final norm, lm head) are not touched."""
    if len(layers) != mask.shape[0]:
        raise ValueError(f"apply_layer_mask: {len(layers)} layers, mask of {mask.shape[0]}")
    for layer, m in zip(layers, mask.tolist()):
        for p in layer.parameters():
            if p.grad is not None:
                p.grad.mul_(m)


# ---------------------------------------------------------------------------
# Full fine-tune (dense weights)
# ---------------------------------------------------------------------------

def make_full_train_step(config: ModelConfig, forward_fn: Callable,
                         optimizer: torch.optim.Optimizer,
                         train_embed: bool = True) -> Callable:
    """Returns step(model, tokens, loss_mask, layer_mask=None) -> loss: one
    forward, backward and `optimizer` update of every trainable parameter
    in place. layer_mask [L] is LISA's per-layer mask; None trains every
    layer. With train_embed False the embedding's gradient is replaced by
    zeros (the optimizer still applies its rule to it, as JAX's step
    does).
    Quantized weights cannot train: use QLoRA for a low-bit base."""

    def step(model, tokens: torch.Tensor, loss_mask: torch.Tensor,
             layer_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = next_token_loss(config, forward_fn, model, None, tokens, loss_mask)
        loss.backward()
        if layer_mask is not None:
            apply_layer_mask(model.layers, layer_mask)
        if not train_embed:
            model.embed.grad = torch.zeros_like(model.embed)
        optimizer.step()
        return loss.detach()

    return step
