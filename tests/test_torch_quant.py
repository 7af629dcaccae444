"""bigdl_tpu_torch quantization against the JAX package: for every one of
the 16 formats the bytes of every field and the dequantized values must
be EQUAL, since one stored artifact has to mean the same weights in both
packages. The k-quants are encoded in torch here and on the host through
llama.cpp's block codec and the planar repack there."""

import re
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.quant import numerics as jnum
from bigdl_tpu.quant import quantize as jquantize
from bigdl_tpu.quant import quantize_or_dense as jquantize_or_dense
from bigdl_tpu.quant.qtypes import qtype_registry
from bigdl_tpu_torch.quant import (ARRAY_FIELDS, QTensor, concat_rows,
                                   pack_nibbles, pack_planes, quantize,
                                   quantize_or_dense, unpack_nibbles,
                                   unpack_planes)

torch.set_num_threads(1)

OTHER_FORMATS = [n for n, s in qtype_registry().items()
                 if not s.is_dense and n != "sym_int4"]


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


def _bytes(t):
    """A field as numpy bytes of its own itemsize (fp8 as uint8)."""
    a = np.asarray(t.view(torch.uint8) if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2)
                   else t) if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _assert_same_qtensor(got, ref):
    assert got.qtype == ref.qtype and got.shape == tuple(ref.shape)
    for f in ARRAY_FIELDS:
        g, r = getattr(got, f), getattr(ref, f)
        assert (g is None) == (r is None), f
        if g is not None:
            assert str(g.dtype).removeprefix("torch.") == np.asarray(r).dtype.name, f
            np.testing.assert_array_equal(_bytes(g), _bytes(r), err_msg=f)
    for dt_t, dt_j in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(
            _bytes(got.dequantize(dt_t).float()),
            _bytes(np.asarray(ref.dequantize(dt_j), np.float32)))


@pytest.mark.parametrize("shape", [(16, 1024), (2, 24, 512)])
@pytest.mark.parametrize("qtype", OTHER_FORMATS)
def test_other_formats_quantize_matches_jax_bytes(qtype, shape):
    """Every field's bytes and the dequantized values in f32 and bf16 equal
    the JAX package's, on weights with an all-zero block, a block whose
    largest magnitude appears with both signs and exact .5 quotients."""
    w = _weights(shape, sum(shape) + len(qtype))
    flat = w.reshape(-1, 256)
    flat[3] = np.where(np.arange(256) % 2, 1.0, -1.0) * 0.25  # ties, both signs
    ref = jquantize(jnp.asarray(w), qtype)
    got = quantize(torch.from_numpy(w), qtype)
    _assert_same_qtensor(got, ref)


def test_kquant_fallback_and_dense_rule_match_jax():
    """A k-quant over K % 256 != 0 falls back as llama.cpp does (q5_k to
    sym_int5, q6_k to sym_int8, the rest to sym_int4); a weight whose K the
    (effective) block does not divide stays dense with a warning."""
    w = _weights((8, 96), 4)
    for qtype in ("q2_k", "q3_k", "q4_k", "q5_k", "q6_k"):
        got, ref = quantize(torch.from_numpy(w), qtype), jquantize(jnp.asarray(w), qtype)
        _assert_same_qtensor(got, ref)
    w40 = _weights((8, 40), 5)
    for qtype in ("nf4", "q4_k", "fp8_e4m3"):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = quantize_or_dense(torch.from_numpy(w40), qtype, "w")
            ref = jquantize_or_dense(jnp.asarray(w40), qtype, "w")
        assert isinstance(got, torch.Tensor) and not hasattr(ref, "qtype")
        assert any("dense" in str(c.message) for c in caught)
    assert isinstance(quantize_or_dense(torch.from_numpy(w), "q4_k"), QTensor)


@pytest.mark.parametrize("planes", [(4,), (2,), (4, 1), (4, 2), (2, 1)])
def test_pack_planes_matches_jax(planes):
    k = 1024
    bits = sum(planes)
    codes = np.random.default_rng(bits).integers(0, 1 << bits, (3, k), dtype=np.uint8)
    packed = pack_planes(torch.from_numpy(codes), planes)
    ref = np.asarray(jnum.pack_planes(jnp.asarray(codes), planes))
    np.testing.assert_array_equal(packed.numpy(), ref)
    assert packed.shape == (3, k * bits // 8)
    np.testing.assert_array_equal(unpack_planes(packed, planes, k).numpy(), codes)
    np.testing.assert_array_equal(
        np.asarray(jnum.unpack_planes(jnp.asarray(ref), planes, k)), codes)


@pytest.mark.parametrize("name", ["float8_e4m3fn", "float8_e5m2"])
def test_fp8_rounding_matches_xla(name):
    """The fp8 encoders end in an f32 -> fp8 conversion: torch's and XLA's
    give the same bytes on every fp8 value, every midpoint between two
    neighbours, one f32 step either side of it, and random values."""
    jd, td = getattr(jnp, name), getattr(torch, name)
    vals = np.asarray(jnp.asarray(np.arange(256, dtype=np.uint8)).view(jd)
                      .astype(jnp.float32))
    vals = np.sort(vals[np.isfinite(vals)])
    mids = ((vals[1:].astype(np.float64) + vals[:-1]) / 2).astype(np.float32)
    rng = np.random.default_rng(0)
    cands = np.concatenate([vals, mids, np.nextafter(mids, np.float32(np.inf)),
                            np.nextafter(mids, np.float32(-np.inf)),
                            rng.normal(size=20000).astype(np.float32) * vals.max() / 4])
    cands = cands[np.abs(cands) <= vals.max()]
    np.testing.assert_array_equal(
        torch.from_numpy(cands).to(td).view(torch.uint8).numpy(),
        np.asarray(jnp.asarray(cands).astype(jd)).view(np.uint8))


def test_kernel_codebooks_equal_the_registry():
    """csrc/qdecode.cuh spells the nf4, fp4 and nf3 codebooks as hex
    float literals: they must be the registry's float32 values."""
    src = (Path(__file__).resolve().parents[1] / "bigdl_tpu_torch" / "csrc"
           / "qdecode.cuh").read_text()
    reg = qtype_registry()
    for table, qtype in (("kQLutNF4", "nf4"), ("kQLutFP4", "fp4"), ("kQLutNF3", "nf3")):
        body = re.search(table + r"\[16\] = \{(.*?)\};", src, re.S).group(1)
        vals = [float.fromhex(v.strip().rstrip("f")) if "x" in v else float(v)
                for v in body.split(",")]
        cb = reg[qtype].codebook
        np.testing.assert_array_equal(np.asarray(vals[:len(cb)], np.float32).view(np.uint32),
                                      cb.view(np.uint32))


def test_concat_rows_is_lossless():
    w = torch.from_numpy(_weights((192, 128), 3))
    parts = [quantize(w[:64], "sym_int4"), quantize(w[64:], "sym_int4")]
    whole = concat_rows(parts)
    assert isinstance(whole, QTensor) and whole.shape == (192, 128)
    torch.testing.assert_close(whole.dequantize(torch.float32),
                               quantize(w, "sym_int4").dequantize(torch.float32),
                               rtol=0, atol=0)
