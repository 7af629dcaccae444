"""RMS and layer normalization (port of bigdl_tpu/ops/norms.py): computed
in float32 whatever the input dtype, then cast back."""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6, offset: bool = False) -> torch.Tensor:
    """offset=True is gemma's convention: scale by (1 + w), formed in
    float32 after the weight's cast (in bf16 it would lose the small
    weights)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    w = weight.float()
    if offset:
        w = 1.0 + w
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim with the biased variance, the bias
    optional (cohere has none)."""
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)
