"""User-facing API (port of bigdl_tpu/api.py): `optimize_model` quantizes
a dense model, `TorchModel.generate` runs greedy or sampled generation,
`TorchModel.save_low_bit` writes the JAX package's low-bit artifact, and
`AutoModelForCausalLM` loads one (`load_low_bit`) or ingests a
HuggingFace safetensors checkpoint (`from_pretrained`).

`TorchModel` places its model on the card unless told otherwise; without
a card it raises and asks for device="cpu". `generate` takes the JAX
package's KV-cache policies: the fp8 cache (`quantize_kv`), SnapKV
(`compress_kv`) and attention-sink streaming (`streaming_window`), with
their environment defaults, and under BIGDL_TPU_PERFORMANCE_MODE switches
long greedy prompts to prompt-lookup decoding (`generate_lookup`);
`generate_speculative` decodes self-speculatively against a sym_int4
draft (`self_draft_params`). Multi-turn chat is `chat.ChatSession`, the
serving engine `serving.engine.InferenceEngine`.
"""

from __future__ import annotations

import dataclasses
import warnings
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
    """Quantize a dense model's projections, experts and lm head (to
    `lm_head_qtype` where given, else as `llama.quantize_params` picks)
    and fuse qkv and gate/up into single linears (an MoE layer's experts
    stay as they are), in place — the layout `forward` runs."""
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
        if isinstance(self.params, llama.LlamaModel):  # else a salvaged subset
            self.params = self.params.to(self.device)

    def save_low_bit(self, path: str, *, faults=None) -> None:
        """The JAX package's low-bit artifact (convert/low_bit.py): atomic,
        with per-tensor digests; either package loads it."""
        from bigdl_tpu_torch.convert.low_bit import save_low_bit

        save_low_bit(path, self.config, self.params, self.qtype, faults=faults)

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
        compress_window: int = 32,
        streaming_window: Optional[int] = None,
        streaming_sink: int = 4,
    ) -> np.ndarray:
        """prompts: ragged list of token-id lists (or a [B, T] array).
        Returns [B, max_new_tokens] generated ids.

        quantize_kv keeps the KV cache in fp8 (default:
        BIGDL_TPU_QUANTIZE_KV_CACHE); compress_kv is SnapKV's budget in
        slots (default: BIGDL_TPU_COMPRESS_KV_CACHE with _BUDGET), applied
        only when the prompt bucket is longer than the budget, with an
        observation window of compress_window. streaming_window makes the
        cache a fixed ring of that many slots, the first streaming_sink
        tokens kept, so max_new_tokens may exceed it (equal-length prompts
        shorter than the window)."""
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
        # environment defaults; an explicit argument wins
        explicit_quantize_kv, explicit_compress_kv = quantize_kv, compress_kv
        quantize_kv = quantize_kv or flags.quantize_kv_default()
        if compress_kv is None:
            compress_kv = flags.compress_kv_budget()
        longest = max(len(p) for p in prompts)
        if (compress_kv is not None and longest > compress_kv
                and (self.config.sliding_window or self.config.alibi)):
            # compressed slots are no longer positions, so window masks and
            # slot-distance biases would be wrong
            warnings.warn("SnapKV compress_kv skipped: incompatible with "
                          "sliding-window/ALiBi attention for this config")
            compress_kv = None
        if (flags.performance_mode() and streaming_window is None and not do_sample
                and compress_kv is None and repetition_penalty == 1.0 and longest >= 256):
            # JAX's switch (api.py:360-373): lookup has no eviction, SnapKV
            # or penalty, and pays off on long prompts that the output quotes
            return self.generate_lookup(prompts, max_new_tokens=max_new_tokens,
                                        eos_token_id=eos_token_id,
                                        pad_token_id=pad_token_id, seed=seed,
                                        quantize_kv=quantize_kv)
        streaming = None
        if streaming_window is not None:
            from bigdl_tpu_torch.streaming import validate_streaming

            validate_streaming(self.config, streaming_window, streaming_sink)
            if explicit_quantize_kv or explicit_compress_kv is not None:
                raise ValueError("streaming_window is incompatible with quantize_kv/"
                                 "compress_kv — the evicted keys are re-based in place")
            if quantize_kv or compress_kv is not None:
                warnings.warn("streaming_window: ignoring env-default "
                              "quantize_kv/compress_kv for this call")
                quantize_kv, compress_kv = False, None
            lens = {len(p) for p in prompts}
            if len(lens) > 1:
                raise ValueError(
                    "streaming_window needs equal-length prompts (the sink slots "
                    "must hold real tokens in every row) — batch equal lengths or "
                    "generate per prompt")
            if longest >= streaming_window:
                raise ValueError(
                    f"prompt ({longest} tokens) must be shorter than streaming_window "
                    f"({streaming_window}); raise the window or pre-truncate the prompt")
            streaming = (streaming_sink, streaming_window)
        # streaming pads to the exact prompt length: the sinks hold real
        # tokens, and a bucket as long as the window would leave no room
        tokens, start = pad_prompts(prompts, pad_token_id,
                                    bucket=longest if streaming is not None else None)
        gen = GenerationConfig(
            max_new_tokens=max_new_tokens, do_sample=do_sample,
            temperature=temperature, top_k=top_k, top_p=top_p,
            repetition_penalty=repetition_penalty, eos_token_id=eos_token_id,
            pad_token_id=pad_token_id,
        )
        budget = compress_kv if compress_kv is not None and tokens.shape[1] > compress_kv else 0
        generator = None
        if do_sample:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        out = generate_tokens(
            self.config, self.params,
            torch.as_tensor(tokens, device=self.device),
            torch.as_tensor(start, device=self.device),
            generator, gen,
            cache_len=(streaming_window if streaming is not None
                       else cache_len_for(tokens.shape[1], max_new_tokens)),
            last_logits=flags.last_lm_head_default(),
            quantize_kv=quantize_kv,
            compress_budget=budget,
            compress_window=min(compress_window, max(budget - 1, 1)),
            streaming=streaming,
        )
        return out.cpu().numpy().astype(np.int32)

    def generate_lookup(self, prompts, max_new_tokens: int = 32, lookahead: int = 4,
                        max_ngram: int = 3, **kw) -> np.ndarray:
        """Prompt-lookup decoding (the reference's lookup.py:274, what
        BIGDL_TPU_PERFORMANCE_MODE switches generate to): n-gram candidates
        from the history, one verify forward a round; batch 1."""
        from bigdl_tpu_torch.decode import lookup_generate

        return lookup_generate(self.config, self.params, prompts,
                               max_new_tokens=max_new_tokens, lookahead=lookahead,
                               max_ngram=max_ngram, **kw)

    def self_draft_params(self) -> llama.LlamaModel:
        """The sym_int4 self-draft of this model's weights (the reference's
        self-speculative draft, model.py:366-379): projections, experts and
        lm head quantized, built once and cached; it shares the embedding,
        norms, biases and an MoE model's router with the target. Raises for a
        quantized target, whose draft would equal it: all cost, no
        speed-up."""
        from bigdl_tpu_torch.quant.qtypes import resolve_qtype

        try:
            dense = resolve_qtype(self.qtype).is_dense
        except ValueError:  # a mixed alias such as q4_k_m
            dense = False
        if not dense:
            raise ValueError(
                f"model qtype {self.qtype!r} is already quantized; a sym_int4 "
                "self-draft would equal the target. Pass explicit draft_params or "
                "load the target as fp16/bf16.")
        draft = getattr(self, "_draft_params", None)
        if draft is None:
            draft = llama.quantized_copy(self.params, "sym_int4")
            self._draft_params = draft
        return draft

    def generate_speculative(self, prompts, draft_params=None, max_new_tokens: int = 32,
                             draft_k: int = 4, **kw) -> np.ndarray:
        """Self-speculative decoding (the reference's speculative.py:803):
        the draft (`self_draft_params()` unless given) proposes up to
        draft_k tokens, one target forward verifies them; batch 1."""
        from bigdl_tpu_torch.decode import speculative_generate

        if draft_params is None:
            draft_params = self.self_draft_params()
        return speculative_generate(self.config, self.params, draft_params, prompts,
                                    max_new_tokens=max_new_tokens, draft_k=draft_k, **kw)


class AutoModelForCausalLM:
    """Loader namespace with the reference's spelling
    (ipex_llm.transformers.AutoModelForCausalLM)."""

    @classmethod
    def from_pretrained(cls, model_path: str, load_in_low_bit: str = "sym_int4",
                        load_in_4bit: bool = False, device=None) -> TorchModel:
        """A HuggingFace safetensors checkpoint directory, quantized layer
        by layer on `device` (the card unless told otherwise) and fused
        (convert/hf.py)."""
        from bigdl_tpu_torch.convert.hf import load_hf_checkpoint

        qtype = "sym_int4" if load_in_4bit else load_in_low_bit
        config, params, qtype = load_hf_checkpoint(model_path, qtype=qtype, device=device)
        return TorchModel(config, params, qtype, device=device)

    @classmethod
    def load_low_bit(cls, path: str, verify: str = "fast", salvage: bool = False,
                     device=None) -> TorchModel:
        """A `save_low_bit` artifact of either package, verified
        (verify="off" | "fast" | "full") and fused. A corrupt artifact
        raises an IntegrityError naming every bad tensor; salvage=True
        loads what verified instead and leaves the report on the model as
        `salvage_report` (None when clean): a salvaged subset is a dict of
        tensors for inspection, not a model that runs."""
        from bigdl_tpu_torch.convert.low_bit import load_low_bit

        if salvage:
            config, params, qtype, report = load_low_bit(path, verify=verify, salvage=True,
                                                         device=device)
        else:
            config, params, qtype = load_low_bit(path, verify=verify, device=device)
            report = None
        if report is None:
            params = llama.merge_fused_params(params, config)
        model = TorchModel(config, params, qtype, device=device)
        model.salvage_report = report
        return model

    @classmethod
    def from_gguf(cls, path: str, qtype: Optional[str] = None) -> TorchModel:
        raise NotImplementedError(
            "AutoModelForCausalLM.from_gguf: ROADMAP queue 1 item [10], "
            "convert/gguf.py is still to be ported")
