"""Finetuning on quantized bases (port of bigdl_tpu/train): QLoRA. The
checkpoint, supervisor, recipe, DPO and GaLore modules are still to be
ported (ROADMAP queue 1 item 6)."""

from bigdl_tpu_torch.train.qlora import (
    DEFAULT_TARGETS, LoRA, adamw, init_lora, make_train_step, merge_lora,
    next_token_loss,
)

__all__ = ["DEFAULT_TARGETS", "LoRA", "adamw", "init_lora", "make_train_step",
           "merge_lora", "next_token_loss"]
