"""bigdl_tpu_torch flash attention: the plain version against the JAX
Pallas flash kernel in interpret mode (ragged left padding, nonzero
q_offset, GQA, sliding window, softcap), every row compared — the
left-pad rows must be exactly 0 in both. The CUDA kernel against the
plain version is in test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from bigdl_tpu_torch.ops import kernels
from bigdl_tpu_torch.ops.kernels.flash_attention import valid_mask

# Both sides do every product and the softmax in f32 and round the output
# to bf16 once; sums run in other orders, so an output may land one bf16
# rounding step away: within 2^-7 relative (+ a floor far below a ULP).
_ULPS = 2 ** -7

CASES = [
    # B, T, S, Hq, Hkv, D, q_offset, start, window, softcap
    (2, 24, 64, 4, 2, 64, 0, (0, 9), None, None),
    (3, 16, 48, 4, 1, 128, 8, (0, 5, 20), None, 20.0),
    (2, 32, 64, 2, 2, 128, 16, (3, 30), 12, None),
]


def _inputs(B, T, S, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    return q, k, v


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas_interpret(case):
    B, T, S, Hq, Hkv, D, qoff, start, window, softcap = case
    q, k, v = _inputs(B, T, S, Hq, Hkv, D, T + S + D)
    st = np.asarray(start, np.int32)
    ref = jax_flash(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                    jnp.asarray(v, jnp.bfloat16), start=jnp.asarray(st),
                    q_offset=jnp.asarray(qoff, jnp.int32), window=window,
                    softcap=softcap, interpret=True)
    ref = np.asarray(ref, np.float32)
    got = kernels.flash_attention(_bf16(q), _bf16(k), _bf16(v),
                                  start=torch.from_numpy(st), q_offset=qoff,
                                  window=window, softcap=softcap)
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, Hq, D)
    got = got.float().numpy()
    assert np.all(np.abs(got - ref) <= _ULPS * np.abs(ref) + 1e-5), \
        np.abs(got - ref).max()
    pad_rows = ~valid_mask(torch.from_numpy(st), qoff, T, S, window).any(-1)
    assert pad_rows.any()  # every case has a row starting past q_offset
    assert np.all(got[pad_rows.numpy()] == 0) and np.all(ref[pad_rows.numpy()] == 0)


def test_fp8_kv_raises_not_implemented():
    q = torch.zeros(1, 4, 2, 64, dtype=torch.bfloat16)
    kv = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kernels.flash_attention(q, kv, kv, k_scale=torch.ones(1, 8, 2),
                                v_scale=torch.ones(1, 8, 2))


def test_cpu_tensor_takes_plain_version_without_launch():
    kernels.reset_launches()
    q, k, v = _inputs(2, 8, 16, 2, 1, 64, 0)
    start = torch.tensor([0, 3], dtype=torch.int32)
    got = kernels.flash_attention(_bf16(q), _bf16(k), _bf16(v), start=start)
    ref = kernels.flash_attention_plain(_bf16(q), _bf16(k), _bf16(v), start)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert kernels.FLASH.launches == 0



def test_every_finite_e5m2_code_is_a_bf16_value():
    """The fp8 arm of csrc/flash_attention.cu runs its products on the
    codes as bf16: each of the 248 finite float8_e5m2 codes, subnormals
    included, is a bf16 value, and the kernel's conversion (the code as the
    high byte of an f16) gives it."""
    from bigdl_tpu_torch.kvcache import FP8

    bits = torch.arange(256, dtype=torch.int32)
    val = bits.to(torch.uint8).view(FP8).float()
    finite = torch.isfinite(val)
    assert int(finite.sum()) == 248
    assert torch.equal(val[finite].bfloat16().float(), val[finite])
    as_f16 = (bits << 8).to(torch.int16).view(torch.float16).float()
    assert torch.equal(as_f16[finite], val[finite])
    assert bool((val[~finite].isnan() == as_f16[~finite].isnan()).all())
