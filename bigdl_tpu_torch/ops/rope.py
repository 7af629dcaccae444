"""Rotary position embeddings (port of bigdl_tpu/ops/rope.py): the
frequencies, with the HF `rope_scaling` schemes the JAX package computes
(linear, dynamic NTK, llama3 smoothing, yarn, longrope/su), the cos/sin
tables and the rotation, all in float32 on the caller's device. Two
conventions: rotate-half (HF llama: contiguous halves, the angles
duplicated over both) and interleaved pairs (GPT-NeoX/GLM/cohere: lanes
rotated as even/odd pairs, each angle repeated pairwise). Partial rotary
(phi, stablelm, gpt-neox) rotates only the first R = `rotary_dim` lanes
of a head, the cos/sin tables' width, and passes the rest through. A
scheme the JAX package does not know raises in `check_rope_scaling`,
which `models.llama.check_supported` calls before a model is built."""

from __future__ import annotations

import math
from typing import Optional

import torch

# the rope_type values make_inv_freq_scaled computes (JAX's branches)
ROPE_TYPES = frozenset({None, "default", "linear", "dynamic", "llama3", "yarn",
                        "longrope", "su"})


def rope_type(rope_scaling: Optional[dict]) -> Optional[str]:
    if not rope_scaling:
        return None
    return rope_scaling.get("rope_type", rope_scaling.get("type", "default"))


def check_rope_scaling(rope_scaling: Optional[dict]) -> None:
    """Raise NotImplementedError for a scheme make_inv_freq_scaled does
    not compute."""
    kind = rope_type(rope_scaling)
    if kind not in ROPE_TYPES:
        raise NotImplementedError(
            f"rope_scaling type {kind!r}: the JAX package computes "
            f"{sorted(k for k in ROPE_TYPES if k)} only")


def get_mscale(scale: float, m: float = 1.0) -> float:
    """HF yarn_get_mscale: the yarn attention temperature."""
    if scale <= 1.0 or m == 0:
        return 1.0
    return 0.1 * m * math.log(scale) + 1.0


def default_inv_freq(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / head_dim))


def llama3_scaled_inv_freq(inv_freq: torch.Tensor, factor: float = 8.0,
                           low_freq_factor: float = 1.0,
                           high_freq_factor: float = 4.0,
                           original_max_position: int = 8192) -> torch.Tensor:
    """Llama-3.1 rope scaling: smooth interpolation between scaled and
    unscaled frequencies (HF _compute_llama3_parameters)."""
    low_freq_wavelen = original_max_position / low_freq_factor
    high_freq_wavelen = original_max_position / high_freq_factor
    wavelen = 2 * math.pi / inv_freq
    scaled = inv_freq / factor
    smooth = (original_max_position / wavelen - low_freq_factor) / (
        high_freq_factor - low_freq_factor)
    smoothed = (1 - smooth) * scaled + smooth * inv_freq
    out = torch.where(wavelen > low_freq_wavelen, scaled, inv_freq)
    mid = (wavelen <= low_freq_wavelen) & (wavelen >= high_freq_wavelen)
    return torch.where(mid, smoothed, out)


def yarn_scaled_inv_freq(inv_freq: torch.Tensor, head_dim: int, theta: float,
                         factor: float = 1.0, beta_fast: float = 32.0,
                         beta_slow: float = 1.0, original_max_position: int = 4096,
                         attention_factor: Optional[float] = None,
                         mscale: Optional[float] = None,
                         mscale_all_dim: Optional[float] = None
                         ) -> tuple[torch.Tensor, float]:
    """YaRN: NTK-by-parts interpolation plus the attention temperature
    (returned; cos/sin are multiplied by it), as HF
    _compute_yarn_parameters: an explicit attention_factor wins, else
    get_mscale(f, mscale) / get_mscale(f, mscale_all_dim) when both are
    set, else 0.1 ln(f) + 1."""

    def find_dim(num_rot):
        return (head_dim * math.log(original_max_position / (num_rot * 2 * math.pi))
                ) / (2 * math.log(theta))

    low = max(math.floor(find_dim(beta_fast)), 0)
    high = min(math.ceil(find_dim(beta_slow)), head_dim // 2 - 1)
    ramp = torch.clamp(
        (torch.arange(head_dim // 2, dtype=torch.float32, device=inv_freq.device) - low)
        / max(high - low, 1), 0.0, 1.0)
    inv = (inv_freq / factor) * ramp + inv_freq * (1 - ramp)
    if attention_factor is not None:
        att = float(attention_factor)
    elif mscale and mscale_all_dim:
        att = get_mscale(factor, mscale) / get_mscale(factor, mscale_all_dim)
    else:
        att = get_mscale(factor)
    return inv, att


def make_inv_freq_scaled(head_dim: int, theta: float,
                         rope_scaling: Optional[dict],
                         seq_len: Optional[int] = None,
                         device=None) -> tuple[torch.Tensor, float]:
    """(inv_freq [head_dim//2] float32, attention_scale); cos/sin are
    multiplied by attention_scale (yarn's temperature, longrope's factor;
    1.0 otherwise). `dynamic` and `longrope` read `seq_len`: the cache's
    length, or T without a cache."""
    check_rope_scaling(rope_scaling)
    inv_freq = default_inv_freq(head_dim, theta, device)
    kind = rope_type(rope_scaling)
    if kind in (None, "default"):
        return inv_freq, 1.0
    if kind == "linear":
        return inv_freq / rope_scaling.get("factor", 1.0), 1.0
    if kind == "dynamic":
        # dynamic NTK: theta grows with the length in use
        factor = rope_scaling.get("factor", 1.0)
        orig = (rope_scaling.get("original_max_position_embeddings")
                or rope_scaling.get("max_position_embeddings", 4096))
        use_len = seq_len or int(orig * factor)
        if use_len > orig:
            adj = theta * ((factor * use_len / orig) - (factor - 1)) ** (
                head_dim / (head_dim - 2))
            return default_inv_freq(head_dim, adj, device), 1.0
        return inv_freq, 1.0
    if kind == "llama3":
        return llama3_scaled_inv_freq(
            inv_freq, factor=rope_scaling.get("factor", 8.0),
            low_freq_factor=rope_scaling.get("low_freq_factor", 1.0),
            high_freq_factor=rope_scaling.get("high_freq_factor", 4.0),
            original_max_position=rope_scaling.get("original_max_position_embeddings", 8192),
        ), 1.0
    if kind == "yarn":
        return yarn_scaled_inv_freq(
            inv_freq, head_dim, theta, factor=rope_scaling.get("factor", 1.0),
            beta_fast=rope_scaling.get("beta_fast", 32.0),
            beta_slow=rope_scaling.get("beta_slow", 1.0),
            original_max_position=rope_scaling.get("original_max_position_embeddings", 4096),
            attention_factor=rope_scaling.get("attention_factor"),
            mscale=rope_scaling.get("mscale"),
            mscale_all_dim=rope_scaling.get("mscale_all_dim"))
    # longrope / su (phi3): per-frequency factors, long or short by length
    orig = rope_scaling.get("original_max_position_embeddings", 4096)
    maxp = rope_scaling.get("max_position_embeddings", orig)
    key = "long_factor" if (seq_len or maxp) > orig else "short_factor"
    ext = torch.tensor(rope_scaling[key], dtype=torch.float32, device=device)
    scale = maxp / orig
    att = 1.0 if scale <= 1.0 else math.sqrt(1 + math.log(scale) / math.log(orig))
    return inv_freq / ext, att


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor,
                 scale: float = 1.0, interleaved: bool = False
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [..., T] int -> float32 cos/sin [..., T, R], R twice
    inv_freq's length: the angles duplicated over both halves (HF llama)
    or repeated pairwise (`interleaved`)."""
    angles = positions.float()[..., None] * inv_freq
    if interleaved:
        angles = torch.repeat_interleave(angles, 2, dim=-1)
    else:
        angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles) * scale, torch.sin(angles) * scale


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _rotate_pairs(x: torch.Tensor) -> torch.Tensor:
    """Even/odd pair rotation (HF modeling_glm's rotate_half): lane pair
    (x0, x1) becomes (-x1, x0)."""
    return torch.stack([-x[..., 1::2], x[..., 0::2]], dim=-1).reshape(x.shape)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
           interleaved: bool = False) -> torch.Tensor:
    """x [..., D] rotated by cos/sin [..., R] broadcast against it,
    computed in f32 and cast back to x's dtype; with R < D only the first
    R lanes rotate (partial rotary), the others pass through."""
    xf = x.float()
    R = cos.shape[-1]
    rot = xf[..., :R] if R < xf.shape[-1] else xf
    out = rot * cos + (_rotate_pairs(rot) if interleaved else _rotate_half(rot)) * sin
    if R < xf.shape[-1]:
        out = torch.cat([out, xf[..., R:]], dim=-1)
    return out.to(x.dtype)


def apply_rotary_emb(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                     sin: torch.Tensor, interleaved: bool = False
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """q [B,T,Hq,D], k [B,T,Hk,D], cos/sin [B,T,R] with R <= D ->
    rotated, computed in f32 and cast back."""
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    return rotate(q, cos, sin, interleaved), rotate(k, cos, sin, interleaved)


def alibi_slopes(num_heads: int, device=None) -> torch.Tensor:
    """ALiBi's per-head slopes [num_heads] in float32 (JAX's
    `alibi_slopes`, baichuan-13b and bloom): powers of 2^(-8/n) for the
    nearest power-of-two head count n, then every other slope of 2n's
    series for the heads past n (baichuan-13b's 40 heads: 32 + 8)."""

    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    n = 2 ** math.floor(math.log2(num_heads))
    slopes = pow2_slopes(n)
    if n < num_heads:
        slopes += pow2_slopes(2 * n)[0::2][: num_heads - n]
    # float64 values rounded once to float32, as numpy's asarray does
    return torch.tensor(slopes, dtype=torch.float64).to(torch.float32).to(device)
