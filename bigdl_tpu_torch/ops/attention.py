"""Masked scaled dot-product attention with GQA (port of
bigdl_tpu/ops/attention.py): the decode path, plain torch as in JAX.
Scores and softmax in float32; the probabilities round to v's dtype
before the value product, which sums in float32."""

from __future__ import annotations

import math

import torch

_NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """q [B,T,Hq,D]; k,v [B,S,Hkv,D]; bool mask broadcastable to
    [B,Hkv,G,T,S] (True = attend); scores scaled by 1/sqrt(D). Returns
    [B,T,Hq,D] in q.dtype."""
    b, t, hq, d = q.shape
    _, s, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {hq} % {hkv}")
    qg = q.reshape(b, t, hkv, hq // hkv, d)
    scores = torch.einsum("bthgd,bshd->bhgts", qg.float(), k.float())
    scores = torch.where(mask, scores * (1.0 / math.sqrt(d)),
                         torch.full_like(scores, _NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgts,bshd->bthgd", probs.float(), v.float())
    return out.reshape(b, t, hq, d).to(q.dtype)
