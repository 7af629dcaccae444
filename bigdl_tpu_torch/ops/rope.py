"""Rotary position embeddings (port of bigdl_tpu/ops/rope.py): the
default-theta frequencies, cos/sin tables and the rotate-half (HF llama)
rotation over the whole head, computed in float32. The rope_scaling
schemes (linear, dynamic, llama3, yarn, longrope) raise until ported."""

from __future__ import annotations

from typing import Optional

import torch


def default_inv_freq(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / head_dim))


def make_inv_freq_scaled(head_dim: int, theta: float,
                         rope_scaling: Optional[dict],
                         seq_len: Optional[int] = None,
                         device=None) -> tuple[torch.Tensor, float]:
    """(inv_freq [head_dim//2], attention_scale); cos/sin are multiplied
    by attention_scale (1.0 without scaling)."""
    rope_type = None
    if rope_scaling:
        rope_type = rope_scaling.get("rope_type", rope_scaling.get("type"))
    if rope_type not in (None, "default"):
        raise NotImplementedError(
            f"rope_scaling {rope_type!r}: ROADMAP queue 1, rope scaling "
            "schemes are still to be ported")
    return default_inv_freq(head_dim, theta, device), 1.0


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor,
                 scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [..., T] int -> float32 cos/sin [..., T, head_dim], the
    angles duplicated over both halves (HF llama layout)."""
    angles = positions.float()[..., None] * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles) * scale, torch.sin(angles) * scale


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary_emb(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                     sin: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """q [B,T,Hq,D], k [B,T,Hk,D], cos/sin [B,T,D] -> rotated, computed
    in f32 and cast back."""
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    qf, kf = q.float(), k.float()
    return ((qf * cos + _rotate_half(qf) * sin).to(q.dtype),
            (kf * cos + _rotate_half(kf) * sin).to(k.dtype))
