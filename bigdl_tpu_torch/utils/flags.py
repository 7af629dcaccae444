"""Environment flags the port's main path reads (the BIGDL_TPU_*
namespace of bigdl_tpu/utils/flags.py, read lazily so tests can
monkeypatch os.environ)."""

from __future__ import annotations

import os
from typing import Optional


def _bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() not in ("", "0", "false", "no", "off")


def _int(name: str, default: Optional[int] = None) -> Optional[int]:
    v = os.environ.get(name)
    if v is None or not v.strip():
        return default
    return int(v)


def last_lm_head_default() -> bool:
    """Compute the lm head on the last prefill position only. Default ON:
    generate never reads earlier prefill logits."""
    return _bool("BIGDL_TPU_LAST_LM_HEAD", True)


def cache_slot_quantum() -> int:
    """KV cache size rounding."""
    return _int("BIGDL_TPU_KV_CACHE_QUANTUM", 64)
