"""Decode-time acceleration (port of bigdl_tpu/decode): self-speculative
decoding, a low-bit draft checked by its full-precision target
(`speculative`), and prompt-lookup decoding, n-gram candidates from the
token history (`lookup`). Both emit only the target's choices, so their
greedy tokens are plain greedy generation's. The serving engine's
in-flight speculative rounds share `speculative.rejection_accept`."""

from bigdl_tpu_torch.decode.lookup import lookup_generate, lookup_tokens
from bigdl_tpu_torch.decode.speculative import (mask_after_eos, rejection_accept,
                                                speculative_generate, speculative_tokens)

__all__ = ["lookup_generate", "lookup_tokens", "mask_after_eos", "rejection_accept",
           "speculative_generate", "speculative_tokens"]
