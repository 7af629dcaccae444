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


def quantize_kv_default() -> bool:
    """The fp8 KV cache by default (BIGDL_TPU_QUANTIZE_KV_CACHE)."""
    return _bool("BIGDL_TPU_QUANTIZE_KV_CACHE")


def compress_kv_budget() -> Optional[int]:
    """SnapKV's budget in slots by default: BIGDL_TPU_COMPRESS_KV_BUDGET
    (1024 when unset) once BIGDL_TPU_COMPRESS_KV_CACHE is on, else None."""
    if _bool("BIGDL_TPU_COMPRESS_KV_CACHE"):
        return _int("BIGDL_TPU_COMPRESS_KV_BUDGET", 1024)
    return None


def performance_mode() -> bool:
    """Prompt-lookup decoding for long prompts (BIGDL_TPU_PERFORMANCE_MODE)."""
    return _bool("BIGDL_TPU_PERFORMANCE_MODE")


def last_lm_head_default() -> bool:
    """Compute the lm head on the last prefill position only. Default ON:
    generate never reads earlier prefill logits."""
    return _bool("BIGDL_TPU_LAST_LM_HEAD", True)


def cache_slot_quantum() -> int:
    """KV cache size rounding."""
    return _int("BIGDL_TPU_KV_CACHE_QUANTUM", 64)
