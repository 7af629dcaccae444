"""Shared utilities: the port's copies of `round_up` / `cache_len_for`
(bigdl_tpu/utils/__init__.py) and the device rule every entry point
follows."""

from __future__ import annotations

from typing import Optional, Union

import torch


def round_up(x: int, m: int) -> int:
    """Smallest multiple of m that is >= x."""
    return (x + m - 1) // m * m


def cache_len_for(prompt_len: int, max_new_tokens: int) -> int:
    """KV cache length for a prompt bucket plus the decode budget, rounded
    to the slot quantum so few distinct cache shapes ever exist."""
    from bigdl_tpu_torch.utils.flags import cache_slot_quantum

    return round_up(prompt_len + max_new_tokens, cache_slot_quantum())


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another. Without a card, None and "cuda" raise — the port never
    drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU"
        )
    return dev
