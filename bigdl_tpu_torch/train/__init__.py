"""Finetuning (port of bigdl_tpu/train): QLoRA over a quantized base,
the full fine-tune with GaLore and LISA, ReLoRA and DPO. The checkpoint
and supervisor modules are still to be ported (ROADMAP queue 1 item 6)."""

from bigdl_tpu_torch.train.dpo import dpo_loss, make_dpo_step, sequence_logprob
from bigdl_tpu_torch.train.galore import GaLore
from bigdl_tpu_torch.train.qlora import (
    DEFAULT_TARGETS, LoRA, adamw, init_lora, make_train_step, merge_lora,
    next_token_loss,
)
from bigdl_tpu_torch.train.recipes import (
    ReLoRASchedule, ReLoRAState, apply_layer_mask, make_full_train_step,
    relora_reset, sample_lisa_mask,
)

__all__ = ["DEFAULT_TARGETS", "GaLore", "LoRA", "ReLoRASchedule", "ReLoRAState",
           "adamw", "apply_layer_mask", "dpo_loss", "init_lora",
           "make_dpo_step", "make_full_train_step", "make_train_step",
           "merge_lora", "next_token_loss", "relora_reset", "sample_lisa_mask",
           "sequence_logprob"]
