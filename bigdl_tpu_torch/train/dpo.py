"""Direct Preference Optimization (port of bigdl_tpu/train/dpo.py).

The policy is the frozen low-bit base plus LoRA adapters; the reference
model is the same base with `lora=None`, scored under `torch.no_grad()`
— no second model copy on the card (TRL's `ref_model=None` peft trick),
as in the JAX package, where the reference scores are `stop_gradient`ed.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.models.config import ModelConfig


def sequence_logprob(config: ModelConfig, forward_fn: Callable, model,
                     lora: Optional[object], tokens: torch.Tensor,
                     loss_mask: torch.Tensor) -> torch.Tensor:
    """[B] sum of log p(target) over the positions where loss_mask [B, T]
    is 1 (the completion tokens; targets are tokens[:, 1:])."""
    logits, _ = forward_fn(config, model, tokens[:, :-1], None, lora=lora)
    logp = torch.log_softmax(logits.float(), dim=-1)
    tok_lp = torch.gather(logp, -1, tokens[:, 1:].long()[..., None])[..., 0]
    return (tok_lp * loss_mask[:, 1:].float()).sum(-1)


def dpo_loss(config: ModelConfig, forward_fn: Callable, model, lora,
             chosen: torch.Tensor, chosen_mask: torch.Tensor,
             rejected: torch.Tensor, rejected_mask: torch.Tensor,
             beta: float = 0.1, label_smoothing: float = 0.0) -> tuple[torch.Tensor, dict]:
    """-log sigmoid(beta [(pi_c - pi_r) - (ref_c - ref_r)]), mean over the
    batch (with `label_smoothing` the conservative-DPO mix), and the aux
    dict: reward_margin, accuracy, policy_chosen_logp,
    policy_rejected_logp. Gradients reach only the adapters."""
    pol_c = sequence_logprob(config, forward_fn, model, lora, chosen, chosen_mask)
    pol_r = sequence_logprob(config, forward_fn, model, lora, rejected, rejected_mask)
    with torch.no_grad():
        ref_c = sequence_logprob(config, forward_fn, model, None, chosen, chosen_mask)
        ref_r = sequence_logprob(config, forward_fn, model, None, rejected, rejected_mask)
    logits = beta * ((pol_c - pol_r) - (ref_c - ref_r))
    loss = (-F.logsigmoid(logits) * (1 - label_smoothing)
            - F.logsigmoid(-logits) * label_smoothing)
    aux = {
        "reward_margin": logits.mean().detach() / beta,
        "accuracy": (logits > 0).float().mean(),
        "policy_chosen_logp": pol_c.mean().detach(),
        "policy_rejected_logp": pol_r.mean().detach(),
    }
    return loss.mean(), aux


def make_dpo_step(config: ModelConfig, forward_fn: Callable,
                  optimizer: torch.optim.Optimizer, beta: float = 0.1) -> Callable:
    """Returns step(model, lora, chosen, chosen_mask, rejected,
    rejected_mask) -> (loss, aux): one forward, backward and `optimizer`
    update of the adapters in place (build the optimizer over
    `lora.parameters()`)."""

    def step(model, lora, chosen, chosen_mask, rejected, rejected_mask):
        optimizer.zero_grad(set_to_none=True)
        loss, aux = dpo_loss(config, forward_fn, model, lora, chosen, chosen_mask,
                             rejected, rejected_mask, beta=beta)
        loss.backward()
        optimizer.step()
        return loss.detach(), aux

    return step
