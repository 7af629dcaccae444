"""Masked scaled dot-product attention with GQA (port of
bigdl_tpu/ops/attention.py): plain torch as in JAX, for the decode over a
dense cache, per-row prefills and every layer the kernels' dispatch does
not take (models/llama.py `attention_route`). Scores and softmax in
float32; the probabilities round to v's dtype before the value product,
which sums in float32."""

from __future__ import annotations

import math
from typing import Optional

import torch

_NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None,
              scale: Optional[float] = None,
              softcap: Optional[float] = None) -> torch.Tensor:
    """q [B,T,Hq,D]; k,v [B,S,Hkv,D]; mask broadcastable to [B,Hkv,G,T,S]:
    bool (True = attend), or float, added to the scores (ALiBi's bias,
    -1e30 where a slot is masked). Scores are scaled (by 1/sqrt(D)
    unless `scale` is given), capped by tanh(s / softcap) * softcap, and
    only then masked, in JAX's order: a cap after the mask would turn
    -1e30 into -softcap and give masked slots weight. Returns [B,T,Hq,D]
    in q.dtype."""
    b, t, hq, d = q.shape
    _, s, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {hq} % {hkv}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, t, hkv, hq // hkv, d)
    scores = torch.einsum("bthgd,bshd->bhgts", qg.float(), k.float()) * scale
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    if mask is not None and mask.dtype == torch.bool:
        scores = scores.masked_fill(~mask, _NEG_INF)
    elif mask is not None:
        scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    del scores
    out = torch.einsum("bhgts,bshd->bthgd", probs.float(), v.float())
    return out.reshape(b, t, hq, d).to(q.dtype)
