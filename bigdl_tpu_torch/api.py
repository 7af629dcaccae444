"""User-facing API (port of bigdl_tpu/api.py): `optimize_model` quantizes
a dense model, `TorchModel.generate` runs greedy or sampled generation.

`TorchModel` places its model on the card unless told otherwise; without
a card it raises and asks for device="cpu". SnapKV (`compress_kv`) and
attention-sink streaming (`streaming_window`) raise until ported; the
serving engine is `serving.engine.InferenceEngine`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from bigdl_tpu_torch.generate import (GenerationConfig, generate_tokens,
                                      pad_prompts)
from bigdl_tpu_torch.models import llama
from bigdl_tpu_torch.models.config import ModelConfig
from bigdl_tpu_torch.utils import cache_len_for, flags, resolve_device


def optimize_model(params: llama.LlamaModel, config: ModelConfig,
                   low_bit: str = "sym_int4",
                   lm_head_qtype: Optional[str] = None) -> llama.LlamaModel:
    """Quantize a dense model's projections and lm head (to `lm_head_qtype`
    where given, else as `llama.quantize_params` picks) and fuse qkv and
    gate/up into single linears, in place — the layout `forward` runs."""
    return llama.merge_fused_params(
        llama.quantize_params(params, low_bit, lm_head_qtype), config)


@dataclasses.dataclass
class TorchModel:
    config: ModelConfig
    params: llama.LlamaModel
    qtype: str
    device: Optional[Union[str, torch.device]] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.params = self.params.to(self.device)

    def generate(
        self,
        prompts: Union[Sequence[Sequence[int]], np.ndarray],
        max_new_tokens: int = 32,
        do_sample: bool = False,
        temperature: float = 1.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        repetition_penalty: float = 1.0,
        eos_token_id: Optional[int] = None,
        pad_token_id: int = 0,
        seed: int = 0,
        quantize_kv: bool = False,
        compress_kv: Optional[int] = None,
        streaming_window: Optional[int] = None,
    ) -> np.ndarray:
        """prompts: ragged list of token-id lists (or a [B, T] array).
        Returns [B, max_new_tokens] generated ids."""
        for name, on in (("compress_kv", compress_kv is not None),
                         ("streaming_window", streaming_window is not None)):
            if on:
                raise NotImplementedError(
                    f"generate({name}=...): ROADMAP queue 1, {name} is still "
                    "to be ported")
        if isinstance(prompts, np.ndarray):
            prompts = [list(row) for row in prompts]
        if not prompts:
            raise ValueError("prompts is empty — nothing to generate")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if any(len(p) == 0 for p in prompts):
            raise ValueError("empty prompt row — every prompt needs at least one token")
        lo = min(min(p) for p in prompts)
        hi = max(max(p) for p in prompts)
        if lo < 0 or hi >= self.config.vocab_size:
            raise ValueError(
                f"prompt token ids must be in [0, {self.config.vocab_size}); "
                f"got range [{lo}, {hi}]")
        if top_k is not None:
            # HF semantics: top_k <= 0 disables; larger than vocab caps
            top_k = None if top_k <= 0 else min(top_k, self.config.vocab_size)
        tokens, start = pad_prompts(prompts, pad_token_id)
        gen = GenerationConfig(
            max_new_tokens=max_new_tokens, do_sample=do_sample,
            temperature=temperature, top_k=top_k, top_p=top_p,
            repetition_penalty=repetition_penalty, eos_token_id=eos_token_id,
            pad_token_id=pad_token_id,
        )
        generator = None
        if do_sample:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        out = generate_tokens(
            self.config, self.params,
            torch.as_tensor(tokens, device=self.device),
            torch.as_tensor(start, device=self.device),
            generator, gen,
            cache_len=cache_len_for(tokens.shape[1], max_new_tokens),
            last_logits=flags.last_lm_head_default(),
            quantize_kv=quantize_kv,
        )
        return out.cpu().numpy().astype(np.int32)
