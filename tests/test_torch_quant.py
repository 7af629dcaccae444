"""bigdl_tpu_torch quantization against the JAX package: sym_int4 bytes,
scales and dequantized values must be EQUAL, since one stored artifact
has to mean the same weights in both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.quant import numerics as jnum
from bigdl_tpu.quant import quantize as jquantize
from bigdl_tpu_torch.quant import (QTensor, concat_rows, pack_nibbles,
                                   quantize, unpack_nibbles)


def _weights(shape, seed):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=shape) * 0.05).astype(np.float32)
    flat = w.reshape(-1, 32)
    # the tie-breaks byte equality rests on: a block whose largest
    # magnitude appears with both signs (first one wins), an all-zero
    # block (scale 0 -> inverse 0), and exact .5 quotients (half-to-even)
    flat[0, :4] = [0.3, -0.3, 0.1, -0.1]
    flat[1] = 0.0
    flat[2] = np.linspace(-1.0, 1.0, 32, dtype=np.float32) * 0.8
    flat[2, 5] = -0.8  # d = 0.1 -> many codes land on x.5 boundaries
    return w


@pytest.mark.parametrize("shape", [(64, 64), (128, 256), (3, 96, 320)])
def test_sym_int4_quantize_matches_jax_bytes(shape):
    w = _weights(shape, sum(shape))
    ref = jquantize(jnp.asarray(w), "sym_int4")
    got = quantize(torch.from_numpy(w), "sym_int4")
    assert got.qtype == ref.qtype == "sym_int4"
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    assert got.scales.dtype == torch.float16
    np.testing.assert_array_equal(got.scales.numpy().view(np.uint16),
                                  np.asarray(ref.scales).view(np.uint16))
    assert got.shape == tuple(ref.shape)
    for dt_t, dt_j in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(
            got.dequantize(dt_t).float().numpy(),
            np.asarray(ref.dequantize(dt_j), np.float32))


def test_nibble_layout_matches_jax():
    """Half-split packing: byte j = element j | element j + K/2 << 4."""
    codes = np.random.default_rng(1).integers(0, 16, (5, 128), dtype=np.uint8)
    packed = pack_nibbles(torch.from_numpy(codes))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jnum.pack_nibbles(jnp.asarray(codes))))
    assert packed[0, 3].item() == codes[0, 3] | (codes[0, 64 + 3] << 4)
    np.testing.assert_array_equal(unpack_nibbles(packed).numpy(), codes)


@pytest.mark.parametrize("qtype", ["asym_int4", "nf4", "sym_int8", "q4_k"])
def test_other_formats_raise_not_implemented(qtype):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        quantize(torch.zeros(128, 256), qtype)


def test_concat_rows_is_lossless():
    w = torch.from_numpy(_weights((192, 128), 3))
    parts = [quantize(w[:64], "sym_int4"), quantize(w[64:], "sym_int4")]
    whole = concat_rows(parts)
    assert isinstance(whole, QTensor) and whole.shape == (192, 128)
    torch.testing.assert_close(whole.dequantize(torch.float32),
                               quantize(w, "sym_int4").dequantize(torch.float32),
                               rtol=0, atol=0)
