"""bigdl_tpu_torch's trainable flash attention (the plain version of the
forward-with-logsumexp, dQ and dK/dV kernels, under the port's autograd
Function) against the JAX package's `flash_attention_trainable` with its
Pallas kernels in interpret mode. The CUDA kernels against the plain
version are in test_torch_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.pallas.flash_backward import (_train_fwd,
                                                  flash_attention_trainable)
from bigdl_tpu_torch.ops import kernels

# tests/test_flash_backward.py's CASES: (B, T, Hq, Hkv, D, window, start)
CASES = [
    (1, 32, 4, 4, 16, None, None),
    (2, 48, 4, 2, 16, None, [0, 13]),  # GQA + left padding
    (1, 64, 2, 2, 16, 24, None),  # sliding window
]

# Both sides run f32 math on f32 inputs, blockwise in JAX and in one pass
# here: the tolerance of tests/test_flash_backward.py, rtol = atol = 2e-3.
_TOL = 2e-3


@pytest.mark.parametrize("B,T,Hq,Hkv,D,window,start", CASES)
def test_flash_train_matches_pallas_interpret(B, T, Hq, Hkv, D, window, start):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((B, T, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D)))
    st = np.asarray(start or [0] * B, np.int32)
    # padding query rows (t < start) are zero on both sides; the weights
    # exclude them as tests/test_flash_backward.py does
    w = (rng.standard_normal((B, T, Hq, D))
         * (np.arange(T)[None, :, None, None] >= st[:, None, None, None])).astype(np.float32)

    def loss_jax(q_, k_, v_):
        o = flash_attention_trainable(q_, k_, v_, jnp.asarray(st), window=window,
                                      interpret=True, block_q=16, block_k=16)
        return jnp.sum(o * w)

    j_val, j_grads = jax.value_and_grad(loss_jax, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _, res = _train_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(st), True, window, None, 16, 16, True)
    j_lse = np.asarray(res[6])[:, :, :T, 0].transpose(0, 2, 1)  # [B, T, Hq]

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tst = torch.from_numpy(st)
    kernels.reset_launches()
    out = kernels.flash_attention_train(tq, tk, tv, tst, window=window)
    val = (out * torch.from_numpy(w)).sum()
    val.backward()
    assert all(n == 0 for n in kernels.launch_counts().values())  # CPU: plain

    np.testing.assert_allclose(val.item(), float(j_val), rtol=_TOL, atol=_TOL)
    for got, ref, name in zip((tq.grad, tk.grad, tv.grad), j_grads, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=_TOL,
                                   atol=_TOL, err_msg=f"d{name}")
    _, lse = kernels.flash_train_fwd(tq.detach(), tk.detach(), tv.detach(), tst, window)
    pad = j_lse <= -1e29  # rows with no valid key: lse is -1e30 on both sides
    assert pad.any() == bool(start and max(start) > 0)
    np.testing.assert_array_equal(lse.numpy()[pad], np.float32(-1e30))
    np.testing.assert_allclose(lse.numpy()[~pad], j_lse[~pad], rtol=_TOL, atol=_TOL)


def test_flash_train_contract():
    """Causal only, and a softcap raises (JAX sends it to its XLA
    attention)."""
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="causal"):
        kernels.flash_attention_train(q, q, q, causal=False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kernels.flash_attention_train(q, q, q, softcap=30.0)
    out = kernels.flash_attention_train(q.requires_grad_(), q, q)
    assert out.shape == q.shape


def _live_tiles(T, S, tile, window):
    """[query tile, key tile] bool: some query of the one attends some key
    of the other by the causal and window masks (start aside), from the
    element mask itself."""
    t = np.arange(T)[:, None]
    j = np.arange(S)[None, :]
    ok = j <= t
    if window:
        ok &= j > t - window
    n_qt, n_kt = -(-T // tile), -(-S // tile)
    pad = np.zeros((n_qt * tile, n_kt * tile), bool)
    pad[:T, :S] = ok
    return pad.reshape(n_qt, tile, n_kt, tile).any(axis=(1, 3))


@pytest.mark.parametrize("G", [1, 2, 4, 8])
# window 66: a full tile's last key is attended up to the first query of
# the tile two on, the edge of the live range
@pytest.mark.parametrize("window", [None, 24, 48, 64, 66])
@pytest.mark.parametrize("T", [48, 70, 100, 160, 1024])
def test_dkv_schedule_covers_live_tiles_once(T, window, G):
    """The dK/dV kernel's work table: every live (query tile, key tile, q
    head) triple of every batch row exactly once and no other, every
    (key tile, q head) in exactly one block (so keys no query attends get
    their zeros), clusters of one kv head's heads, heaviest blocks first.
    The table does not depend on the head dim: the kernel's tile is
    DKV_TILE at D = 64 and 128."""
    from bigdl_tpu_torch.ops.kernels.flash_backward import DKV_TILE, dkv_schedule

    B, Hkv = 2, 2
    Hq, S, tile = G * Hkv, T, DKV_TILE
    table, cluster = dkv_schedule(B, T, S, Hq, Hkv, window)
    rows = table.numpy()
    live = _live_tiles(T, S, tile, window)
    n_qt, n_kt = live.shape
    seen = np.zeros((B, Hq, n_qt, n_kt), np.int64)
    owner = np.zeros((B, Hq, n_kt), np.int64)
    for b, kt, h0, nh, lo, hi in rows:
        for h in range(h0, h0 + nh):
            owner[b, h, kt] += 1
            seen[b, h, lo:hi + 1, kt] += 1
    np.testing.assert_array_equal(seen, np.broadcast_to(live, seen.shape).astype(np.int64))
    assert (owner == 1).all()

    work = rows[:, 3] * np.maximum(rows[:, 5] - rows[:, 4] + 1, 0)
    assert (np.diff(work) <= 0).all(), "blocks not ordered heaviest first"
    assert 1 <= cluster <= 8 and G % cluster == 0 and len(rows) % cluster == 0
    for grp in rows.reshape(-1, cluster, 6):
        # one cluster: one batch row, key tile, kv head and walk; the
        # group's heads in rank order
        assert (grp[:, [0, 1, 3, 4, 5]] == grp[0, [0, 1, 3, 4, 5]]).all()
        assert (grp[:, 2] == grp[0, 2] + grp[0, 3] * np.arange(cluster)).all()
        assert grp[0, 2] % G == 0


# csrc/flash_backward.cu's dQ kernel on the tensor cores rounds dS to bf16
# once (the A operand of dQ += dS . K); everything else is f32. The
# emulation below walks the kernel's tiles (64 queries of a block, its live
# 64-key tiles, masks only on the tiles a mask cuts) with that one rounding,
# and is held to JAX's gradient as the card holds the kernel to its plain
# version (chip_smoke phase 2): 2^-6 of the largest element, 1 % in the
# Frobenius norm.
_TILE = 64
_LOG2E = 1.4426950408889634


# the tile walk of csrc/flash_tc.cuh's live_tiles and whole_tile, with the
# query rows at slots row_lo .. row_hi (the prefill kernel's q_offset + t;
# the training kernels' t); test_torch_kvcache.py's fp8 emulation walks it too
def _live_key_tiles(row_lo, row_hi, S, st, window):
    j_hi = min(S, row_hi + 1)
    lo = max(st, row_lo - window + 1) if window else st
    j_lo = max(lo, 0) // _TILE * _TILE
    return range(j_lo, j_hi, _TILE)


def _whole_tile(t0, row0, j0, T, S, st, window):
    return (j0 >= st and j0 + _TILE - 1 <= row0 and t0 + _TILE <= T
            and j0 + _TILE <= S and (not window or j0 > row0 + _TILE - 1 - window))


def _dq_emulated(q, k, v, start, do, lse, delta, window, scale):
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dq = torch.zeros(B, T, Hq, D)
    for b in range(B):
        st = int(start[b])
        kb = k[b].float().repeat_interleave(G, dim=1).transpose(0, 1)  # [Hq, S, D]
        vb = v[b].float().repeat_interleave(G, dim=1).transpose(0, 1)
        for t0 in range(0, T, _TILE):
            t1 = min(t0 + _TILE, T)
            rows = torch.arange(t0, t1)
            qt = q[b, t0:t1].float().transpose(0, 1)  # [Hq, n, D]
            dot = do[b, t0:t1].float().transpose(0, 1)
            lse2 = lse[b, t0:t1].T[..., None] * _LOG2E  # [Hq, n, 1]
            dl = delta[b, t0:t1].T[..., None]
            acc = torch.zeros(Hq, t1 - t0, D)
            for j0 in _live_key_tiles(t0, t1 - 1, S, st, window):
                j1 = min(j0 + _TILE, S)
                kt, vt = kb[:, j0:j1], vb[:, j0:j1]
                p = torch.exp2(qt @ kt.transpose(1, 2) * (scale * _LOG2E) - lse2)
                if not _whole_tile(t0, t0, j0, T, S, st, window):
                    j = torch.arange(j0, j1)[None]
                    ok = (j <= rows[:, None]) & (j >= st)
                    if window:
                        ok &= j > rows[:, None] - window
                    p = torch.where(ok, p, torch.zeros_like(p))
                ds = p * (dot @ vt.transpose(1, 2) - dl)
                acc += ds.bfloat16().float() @ kt
            dq[b, t0:t1] = (acc * scale).transpose(0, 1)
    return dq.bfloat16()


@pytest.mark.parametrize("B,T,Hq,Hkv,D,window,start", [
    (1, 128, 4, 4, 64, None, None),
    (2, 160, 4, 2, 64, 40, [0, 37]),  # GQA, a left pad, a window across key tiles
    (1, 192, 4, 1, 128, None, [70]),  # the pad covers key tile 0
])
def test_dq_one_bf16_rounding_of_ds_matches_pallas_interpret(B, T, Hq, Hkv, D, window, start):
    rng = np.random.default_rng(T + D)
    st = np.asarray(start or [0] * B, np.int32)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()
                   for s in ((B, T, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D), (B, T, Hq, D)))
    # rows before start attend nothing; their cotangent is 0 as in the
    # weights of test_flash_train_matches_pallas_interpret
    do = do * torch.from_numpy(np.arange(T)[None, :] >= st[:, None])[..., None, None]

    def f(q_):
        return flash_attention_trainable(q_, jnp.asarray(k.float().numpy()),
                                         jnp.asarray(v.float().numpy()), jnp.asarray(st),
                                         window=window, interpret=True, block_q=64, block_k=64)

    _, vjp = jax.vjp(f, jnp.asarray(q.float().numpy()))
    ref = torch.from_numpy(np.array(vjp(jnp.asarray(do.float().numpy()))[0]))

    tst = torch.from_numpy(st)
    out, lse = kernels.flash_attention_train_plain(q, k, v, tst, window)
    delta = (do.float() * out.float()).sum(-1)
    got = _dq_emulated(q, k, v, tst, do, lse, delta, window, 1.0 / np.sqrt(D)).float()
    err = (got - ref).abs().max().item()
    assert err <= 2 ** -6 * ref.abs().max().item(), err
    assert ((got - ref).norm() <= 1e-2 * ref.norm()).item()
    for b, s0 in enumerate(st):
        assert bool((got[b, :s0] == 0).all())
