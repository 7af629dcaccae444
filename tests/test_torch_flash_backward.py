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
