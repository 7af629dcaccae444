"""Embedding tables for memory-constrained serving (port of
bigdl_tpu/embedding.py).

- `quantize_embedding`: a low-bit table, a `QTensor` quantized along each
  row's hidden dim, so one row dequantizes alone: a lookup gathers the
  packed rows and their scales and dequantizes only those.
- `HostEmbedding`: the table stays in host RAM (a numpy array) or on disk
  (`from_file`: an `np.load(mmap_mode="r")` memmap, rows pulled in by the
  page cache). A lookup copies the token ids to the host, gathers there and
  sends only the [B, T, H] rows to the tokens' device: the card never holds
  the [V, H] matrix. The gather is synchronous, once a forward.

`embed_lookup` dispatches on the table's type; `models.llama.embed_tokens`
calls it, so every entry point takes all three. A model holds a host table
as a plain attribute, which `nn.Module.to` leaves where it is.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from bigdl_tpu_torch.quant import QTensor, quantize


class HostEmbedding:
    """A [V, H] embedding table in host memory (a numpy array, float32 or
    any type numpy widens to it exactly) whose rows reach the device one
    lookup at a time, cast to `dtype`."""

    def __init__(self, table: np.ndarray, dtype=torch.bfloat16):
        self.table = table
        self.dtype = dtype
        self.vocab_size, self.hidden_size = table.shape

    @classmethod
    def from_file(cls, path: str, dtype=torch.bfloat16) -> "HostEmbedding":
        """A table saved with np.save, read through a memmap: rows stay on
        disk until the page cache pulls them in."""
        return cls(np.load(path, mmap_mode="r"), dtype=dtype)

    def lookup(self, tokens: torch.Tensor) -> torch.Tensor:
        """[B, T] ids (any device) -> [B, T, H] rows in `dtype` on the ids'
        device: gathered in float32 on the host, as the JAX package's host
        callback does, and cast there, so only the rows cross."""
        idx = tokens.detach().cpu().numpy()
        rows = torch.from_numpy(np.asarray(self.table[idx], np.float32)).to(self.dtype)
        return rows.to(tokens.device)


def quantize_embedding(embed: Union[torch.Tensor, np.ndarray], qtype: str = "sym_int4") -> QTensor:
    """A low-bit table: the rows quantized blockwise along their hidden
    dim (from float32, as the JAX package quantizes), on the table's
    device."""
    return quantize(torch.as_tensor(embed).float(), qtype)


def embed_lookup(embed, tokens: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The rows of `tokens` from a dense table, a low-bit QTensor (only the
    gathered rows dequantized) or a HostEmbedding, in the compute dtype."""
    if isinstance(embed, HostEmbedding):
        return embed.lookup(tokens).to(compute_dtype)
    if isinstance(embed, QTensor):
        rows = QTensor(qtype=embed.qtype, **{f: t[tokens] for f, t in embed.fields().items()})
        return rows.dequantize(compute_dtype)
    return embed.to(compute_dtype)[tokens]
