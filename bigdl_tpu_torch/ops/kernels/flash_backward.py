"""Trainable causal flash attention: the forward with per-row logsumexp,
the dQ and dK/dV backward kernels, their plain version, launch counts and
the `torch.autograd.Function` that joins them.

Port of bigdl_tpu/ops/pallas/flash_backward.py (`flash_attention_trainable`,
`_fwd_kernel`, `_dq_kernel`, `_dkv_kernel`). The CUDA source is
`csrc/flash_backward.cu`, kept apart from the inference kernel as the JAX
package keeps its own apart; its header note says what bounds the kernels
on the card and what the design does about it.

Layout is the model's: q, out [B, T, Hq, D]; k, v [B, S, Hkv, D]; lse and
delta [B, T, Hq] float32. Query t of row b attends key j iff
start[b] <= j <= t (and j > t - window with a sliding window); a row with
no valid key (left padding) has out = 0 and lse = -1e30. As in JAX,
delta = rowsum(dO * O) is plain torch between the forward and the two
backward kernels. Softcap raises: JAX sends it to its XLA attention.

Each wrapper dispatches on the tensor's device: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises. The dK/dV
kernel walks a schedule that `dkv_schedule` builds here per shape, so the
CPU tests reach it too.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from bigdl_tpu_torch.ops.kernels._build import Kernel

_SHAPE = "iiiiiifi"  # B, T, S, Hq, Hkv, D, scale, window
# (q, k, v, start, out, lse, ...)
FLASH_FWD = Kernel("flash_train_fwd_bf16", "flash_backward", "pppppp" + _SHAPE,
                   replaces="bigdl_tpu/ops/pallas/flash_backward.py:80")
# (q, k, v, start, dout, lse, delta, dq, ...)
FLASH_DQ = Kernel("flash_train_dq_bf16", "flash_backward", "pppppppp" + _SHAPE,
                  replaces="bigdl_tpu/ops/pallas/flash_backward.py:134")
# (q, k, v, start, dout, lse, delta, dk, dv, ..., work, n_blocks, cluster)
FLASH_DKV = Kernel("flash_train_dkv_bf16", "flash_backward", "ppppppppp" + _SHAPE + "pii",
                   replaces="bigdl_tpu/ops/pallas/flash_backward.py:178")

_NEG_INF = -1e30
_HEAD_DIMS = (64, 128)
# keys of a dK/dV block and queries of each step of its walk, at both
# head dims (csrc/flash_backward.cu's kTile)
DKV_TILE = 64
# the most blocks a cluster may hold without the non-portable opt-in
_MAX_CLUSTER = 8


def _valid(start: torch.Tensor, T: int, S: int,
           window: Optional[int]) -> torch.Tensor:
    """[B, 1, 1, T, S] bool: query t of row b attends key j."""
    rows = torch.arange(T, device=start.device)[:, None]
    cols = torch.arange(S, device=start.device)[None, :]
    ok = (cols <= rows)[None] & (cols[None] >= start.to(torch.long)[:, None, None])
    if window is not None:
        ok = ok & (cols > rows - window)[None]
    return ok[:, None, None]


def _probs(q, k, start, window, scale, lse=None):
    """Scores (q * scale) . k as f32 [B, Hkv, G, T, S] and the validity
    mask; with lse, also P = exp(S - lse), exactly 0 where masked."""
    B, T, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    qf = (q.float() * scale).reshape(B, T, Hkv, Hq // Hkv, D)
    s = torch.einsum("bthgd,bshd->bhgts", qf, k.float())
    valid = _valid(start, T, S, window)
    if lse is None:
        return s, valid
    lse_ = lse.reshape(B, T, Hkv, Hq // Hkv).permute(0, 2, 3, 1)[..., None]
    return torch.where(valid, torch.exp(s - lse_), torch.zeros_like(s)), valid


def flash_attention_train_plain(q, k, v, start, window: Optional[int] = None,
                                scale: Optional[float] = None):
    """The forward kernel's function in plain torch, all math in f32:
    returns (out [B, T, Hq, D] in q.dtype, lse [B, T, Hq] f32), lse =
    m + log(l) per row and -1e30 for a row with no valid key, whose out
    is exactly 0."""
    B, T, Hq, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    s, valid = _probs(q, k, start, window, scale)
    s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    safe = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("bhgts,bshd->bhgtd", p, v.float()) / safe
    lse = torch.where(l == 0, torch.full_like(l, _NEG_INF), m + torch.log(safe))
    out = o.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, D).to(q.dtype)
    return out, lse[..., 0].permute(0, 3, 1, 2).reshape(B, T, Hq)


def flash_attention_train_bwd_plain(q, k, v, start, dout, lse, delta,
                                    window: Optional[int] = None,
                                    scale: Optional[float] = None):
    """The two backward kernels' function in plain torch, all math in
    f32, from the forward's lse and delta = rowsum(dO * O): returns (dq,
    dk, dv) in q's, k's and v's dtypes, with P = exp(S - lse) (0 where
    masked), dS = P * (dO . V^T - delta), dQ = scale * dS . K,
    dK = scale * dS^T . Q and dV = P^T . dO."""
    B, T, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    p, _ = _probs(q, k, start, window, scale, lse)  # [B, Hkv, G, T, S]
    do = dout.float().reshape(B, T, Hkv, G, D)
    dp = torch.einsum("bthgd,bshd->bhgts", do, v.float())
    dl = delta.reshape(B, T, Hkv, G).permute(0, 2, 3, 1)[..., None]
    ds = p * (dp - dl)
    dq = torch.einsum("bhgts,bshd->bthgd", ds, k.float()) * scale
    dk = torch.einsum("bhgts,bthgd->bshd", ds, q.float().reshape(B, T, Hkv, G, D)) * scale
    dv = torch.einsum("bhgts,bthgd->bshd", p, do)
    return (dq.reshape(B, T, Hq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def flash_train_dq_plain(q, k, v, start, dout, lse, delta, window=None, scale=None):
    return flash_attention_train_bwd_plain(q, k, v, start, dout, lse, delta,
                                           window, scale)[0]


def flash_train_dkv_plain(q, k, v, start, dout, lse, delta, window=None, scale=None):
    return flash_attention_train_bwd_plain(q, k, v, start, dout, lse, delta,
                                           window, scale)[1:]


def _check(q, k, v, start, dout=None, lse=None, delta=None) -> None:
    B, T, Hq, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention_train: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if Hq % k.shape[2]:
        raise ValueError(f"flash_attention_train: Hq={Hq} is not a multiple "
                         f"of Hkv={k.shape[2]}")
    if D not in _HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention_train: head_dim {D} (the kernels take "
            f"{_HEAD_DIMS}; others: ROADMAP queue 2 item 1)")
    operands = [("q", q, torch.bfloat16, q.shape), ("k", k, torch.bfloat16, k.shape),
                ("v", v, torch.bfloat16, k.shape)]
    if dout is not None:
        operands += [("dout", dout, torch.bfloat16, q.shape),
                     ("lse", lse, torch.float32, (B, T, Hq)),
                     ("delta", delta, torch.float32, (B, T, Hq))]
    for name, t, dtype, shape in operands:
        if t.dtype != dtype or t.shape != shape:
            raise TypeError(f"flash_attention_train: {name} must be {dtype} "
                            f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
        # the bf16 tiles load 16 bytes at a time, lse and delta 4
        align = 16 if dtype == torch.bfloat16 else 4
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"flash_attention_train: {name} must be a "
                             f"contiguous tensor on {q.device} at a "
                             f"{align}-byte aligned address")
    if (start.dtype != torch.int32 or start.shape != (B,)
            or start.device != q.device or not start.is_contiguous()):
        raise ValueError("flash_attention_train: start must be a contiguous "
                         f"int32 [B] tensor on {q.device}")


def dkv_schedule(B: int, T: int, S: int, Hq: int, Hkv: int,
                 window: Optional[int]) -> tuple[torch.Tensor, int]:
    """The dK/dV kernel's work: (int32 [n_blocks, 6] CPU tensor, cluster).

    A row is one block: (batch row, key tile, first q head, q heads, first
    and last live query tile), with tiles of DKV_TILE keys and queries.
    A query tile is live for a key tile if one of its queries attends one
    of its keys by the causal and window masks; start[b] is a device value
    that the kernel applies itself. Every (batch row, key tile, q head)
    has exactly one row, also a key tile no query attends (its dk and dv
    are written as zeros). The G = Hq / Hkv heads of a kv head form one
    cluster of `cluster` consecutive rows (the largest divisor of G up to
    8; each row takes G / cluster heads), summed in the kernel without
    atomics. Rows are ordered heaviest first (q heads x live query tiles),
    so the longest walks start first."""
    tile = DKV_TILE
    G = Hq // Hkv
    cluster = max(c for c in range(1, _MAX_CLUSTER + 1) if G % c == 0)
    per = G // cluster
    n_qt = -(-T // tile)
    rows = []
    for kt in range(-(-S // tile)):
        j0 = kt * tile
        if j0 <= T - 1:  # queries j0 .. attend key j0 at least
            lo, hi = kt, n_qt - 1
            if window:  # the tile's last key is attended up to query j + window - 1
                hi = min(hi, (min(j0 + tile, S) - 1 + window - 1) // tile)
        else:
            lo, hi = 0, -1
        work = per * (hi - lo + 1)
        for b in range(B):
            for hk in range(Hkv):
                for r in range(cluster):
                    rows.append((-work, kt, b, hk, r,
                                 (b, kt, hk * G + r * per, per, lo, hi)))
    rows.sort(key=lambda x: x[:5])
    table = torch.tensor([x[5] for x in rows], dtype=torch.int32).reshape(-1, 6)
    return table, cluster


_DEVICE_SCHEDULES: dict = {}


def _dkv_work(q, k, window) -> tuple[torch.Tensor, int]:
    """`dkv_schedule` for these operands, on their device (kept per shape:
    every layer of a step asks again)."""
    B, T, Hq, _ = q.shape
    key = (B, T, k.shape[1], Hq, k.shape[2], window or None, str(q.device))
    if key not in _DEVICE_SCHEDULES:
        table, cluster = dkv_schedule(*key[:-1])
        _DEVICE_SCHEDULES[key] = (table.to(q.device), cluster)
    return _DEVICE_SCHEDULES[key]


def _shape_args(q, k, window, scale):
    B, T, Hq, D = q.shape
    return (B, T, k.shape[1], Hq, k.shape[2], D, float(scale), int(window or 0))


def _on_card(fn: str, q: torch.Tensor) -> bool:
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise NotImplementedError(f"{fn}: no kernel for {q.device}")
    return True


def flash_train_fwd(q, k, v, start, window=None, scale=None):
    """(out, lse) of causal attention: the forward kernel on the card, the
    plain version for CPU tensors."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not _on_card("flash_train_fwd", q):
        return flash_attention_train_plain(q, k, v, start, window, scale)
    _check(q, k, v, start)
    B, T, Hq, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, T, Hq), dtype=torch.float32, device=q.device)
    if out.numel():
        FLASH_FWD(q, k, v, start, out, lse, *_shape_args(q, k, window, scale),
                  device=q.device)
    return out, lse


def flash_train_dq(q, k, v, start, dout, lse, delta, window=None, scale=None):
    """dq from the forward's lse and delta: the dQ kernel on the card."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not _on_card("flash_train_dq", q):
        return flash_train_dq_plain(q, k, v, start, dout, lse, delta, window, scale)
    _check(q, k, v, start, dout, lse, delta)
    dq = torch.empty_like(q)
    if dq.numel():
        FLASH_DQ(q, k, v, start, dout, lse, delta, dq,
                 *_shape_args(q, k, window, scale), device=q.device)
    return dq


def flash_train_dkv(q, k, v, start, dout, lse, delta, window=None, scale=None):
    """(dk, dv) from the forward's lse and delta: the dK/dV kernel on the
    card."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not _on_card("flash_train_dkv", q):
        return flash_train_dkv_plain(q, k, v, start, dout, lse, delta, window, scale)
    _check(q, k, v, start, dout, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if dk.numel():
        work, cluster = _dkv_work(q, k, window)
        FLASH_DKV(q, k, v, start, dout, lse, delta, dk, dv,
                  *_shape_args(q, k, window, scale), work, work.shape[0], cluster,
                  device=q.device)
    return dk, dv


def _kernels():
    # looked up at call time, so a caller can hold the kernels against
    # their plain versions by patching the package's names
    from bigdl_tpu_torch.ops import kernels

    return kernels


class FlashAttentionTrain(torch.autograd.Function):
    """out = causal flash attention; the backward runs delta = rowsum(dO *
    O) in torch, then the dQ and dK/dV kernels (JAX's custom_vjp,
    flash_backward.py:358-448). start, window and scale get no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, start, window, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = _kernels().flash_train_fwd(q, k, v, start, window, scale)
        ctx.save_for_backward(q, k, v, start, out, lse)
        ctx.window, ctx.scale = window, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, start, out, lse = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        delta = (dout.float() * out.float()).sum(-1)  # [B, T, Hq]
        kern = _kernels()
        dq = kern.flash_train_dq(q, k, v, start, dout, lse, delta, ctx.window, ctx.scale)
        dk, dv = kern.flash_train_dkv(q, k, v, start, dout, lse, delta, ctx.window, ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          start: Optional[torch.Tensor] = None,
                          causal: bool = True, window: Optional[int] = None,
                          scale: Optional[float] = None,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """Differentiable causal flash attention: q [B, T, Hq, D]; k, v
    [B, S, Hkv, D]; start [B] int32 left-pad offsets. Query positions are
    0..T-1 (no cache offset). Returns [B, T, Hq, D] in q.dtype."""
    if not causal:
        raise ValueError("flash_attention_train is causal: the bidirectional "
                         "path is ops.attention, as in JAX")
    if softcap is not None:
        raise NotImplementedError(
            "flash_attention_train with a softcap: JAX sends it to its XLA "
            "attention; ROADMAP queue 1 item 4 (the llama flags)")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if start is None:
        start = torch.zeros((q.shape[0],), dtype=torch.int32, device=q.device)
    return FlashAttentionTrain.apply(q, k, v, start.to(torch.int32).contiguous(),
                                     window, float(scale))
