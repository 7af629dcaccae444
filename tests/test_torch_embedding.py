"""The embedding variants in the port against the JAX package, on the CPU:
the six cases of the JAX package's tests/test_embedding.py, and what a
low-bit or host table does to a tied head and to the low-bit artifact.

A host table (RAM, or a memmap of a .npy file) holds the dense table's
values, so the port's rows, prefill logits and greedy tokens are the dense
table's bit for bit (same kernels, same shapes); against JAX's host table
the logits hold tests/test_torch_llama.py's bound (4 bf16 ULPs of the
largest logit). A low-bit table is the JAX package's bytes exactly (same
encoder), its rows dequantize to JAX's, and its logits stay within 10 %
of the dense table's mean magnitude, as JAX's test asks of its own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import kvcache as jkv
from bigdl_tpu.convert import load_low_bit as jax_load_low_bit
from bigdl_tpu.convert import save_low_bit as jax_save_low_bit
from bigdl_tpu.embedding import HostEmbedding as JaxHostEmbedding
from bigdl_tpu.embedding import embed_lookup as jax_embed_lookup
from bigdl_tpu.embedding import quantize_embedding as jax_quantize_embedding
from bigdl_tpu.models import llama as jllama
from bigdl_tpu_torch import TorchModel, kvcache
from bigdl_tpu_torch.convert import params_from_numpy
from bigdl_tpu_torch.convert.low_bit import load_low_bit, save_low_bit
from bigdl_tpu_torch.embedding import HostEmbedding, embed_lookup, quantize_embedding
from bigdl_tpu_torch.models import llama
from bigdl_tpu_torch.quant import ARRAY_FIELDS
from bigdl_tpu_torch.utils import cache_len_for, flags
from test_torch_llama import _flatten
from test_torch_snapkv import JCFG, TCFG, TOL_ULPS, pair

torch.set_num_threads(1)

TOKENS = [[3, 1, 4, 1, 5, 9]]


def _jax_forward(jparams, cfg=JCFG, **kw):
    cache = jkv.init_cache(cfg.num_hidden_layers, 1, 32, cfg.num_key_value_heads, cfg.head_dim_)
    logits, _ = jllama.forward(cfg, jparams, jnp.asarray(TOKENS, jnp.int32), cache,
                               mode="prefill", **kw)
    return np.asarray(logits)


def _forward(model, cfg=TCFG, **kw):
    cache = kvcache.init_cache(cfg.num_hidden_layers, 1, 32, cfg.num_key_value_heads,
                               cfg.head_dim_, device="cpu")
    with torch.inference_mode():
        logits, _ = llama.forward(cfg, model, torch.tensor(TOKENS), cache, **kw)
    return logits.numpy()


def _fresh(qtype="bf16", cfg=JCFG):
    """(JAX params, a port model of the same weights, not shared with
    other tests: the embedding gets replaced)."""
    jparams = jllama.init_params(cfg, jax.random.PRNGKey(0))
    arrays, qtypes = {}, {}
    _flatten(jparams, "", arrays, qtypes)
    tcfg = dataclasses.replace(TCFG, tie_word_embeddings=cfg.tie_word_embeddings)
    return jparams, params_from_numpy(arrays, qtypes, tcfg, device="cpu"), tcfg


def _close(got, ref):
    assert np.abs(got - ref).max() <= TOL_ULPS * np.abs(ref).max(), np.abs(got - ref).max()


def test_low_bit_embedding_close():
    jparams, model, _ = _fresh()
    ref = _forward(model)
    jq = jax_quantize_embedding(jparams["embed"], "sym_int8")
    q = quantize_embedding(model.embed, "sym_int8")
    for f in ARRAY_FIELDS:  # the JAX package's encoder bytes
        jf = getattr(jq, f)
        assert (getattr(q, f) is None) == (jf is None)
        if jf is not None:
            np.testing.assert_array_equal(getattr(q, f).float().numpy(),
                                          np.asarray(jf, np.float32))
    model.set_embed(q)
    out = _forward(model)
    err = np.abs(out - ref).mean() / (np.abs(ref).mean() + 1e-6)
    assert err < 0.1, err
    _close(out, _jax_forward(dict(jparams, embed=jq)))
    tok = torch.tensor([[7, 0, 255], [1, 2, 3]])
    rows = embed_lookup(q, tok)
    np.testing.assert_array_equal(
        rows.float().numpy(), np.asarray(jax_embed_lookup(jq, jnp.asarray(tok.numpy())), np.float32))
    # the gathered rows dequantize to the whole table's bits
    assert torch.equal(rows, q.dequantize(torch.bfloat16)[tok])


def test_host_embedding_exact():
    jparams, model, _ = _fresh()
    ref = _forward(model)
    table = model.embed.float().numpy()
    model.set_embed(HostEmbedding(table))
    out = _forward(model)
    np.testing.assert_array_equal(out, ref)
    _close(out, _jax_forward(dict(jparams, embed=JaxHostEmbedding(table))))


def test_disk_embedding(tmp_path):
    jparams, model, _ = _fresh()
    path = str(tmp_path / "embed.npy")
    np.save(path, model.embed.float().numpy())
    he = HostEmbedding.from_file(path)
    assert isinstance(he.table, np.memmap)
    tok = torch.tensor(TOKENS)
    got = embed_lookup(he, tok)
    np.testing.assert_array_equal(got.float().numpy(), embed_lookup(model.embed, tok).float().numpy())
    want = jax_embed_lookup(JaxHostEmbedding.from_file(path), jnp.asarray(TOKENS))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_host_embedding_through_generate(tmp_path):
    """The JAX test runs the host lookup under jit; the port's counterpart
    is the entry point: TorchModel keeps a host table on the host when it
    moves the model, and generate gives the dense table's tokens."""
    _, model = pair("sym_int4")
    tm = TorchModel(TCFG, model, "sym_int4", device="cpu")
    prompts = [[3, 1, 4, 1, 5, 9], [2, 7]]
    want = tm.generate(prompts, 8)
    jparams, _ = pair("sym_int4")
    arrays, qtypes = {}, {}
    _flatten(jparams, "", arrays, qtypes)
    host = params_from_numpy(arrays, qtypes, TCFG, device="cpu")
    path = str(tmp_path / "embed.npy")
    np.save(path, host.embed.float().numpy())
    for table in (HostEmbedding(host.embed.float().numpy()), HostEmbedding.from_file(path)):
        host.set_embed(table)
        tm_host = TorchModel(TCFG, host, "sym_int4", device="cpu")
        assert tm_host.params.embed is table and "embed" not in dict(host.named_parameters())
        np.testing.assert_array_equal(tm_host.generate(prompts, 8), want)


def test_last_logits_only_matches():
    _, model, _ = _fresh()
    full = _forward(model)
    last = _forward(model, last_logits_only=True)
    assert last.shape == (1, 1, TCFG.vocab_size)
    np.testing.assert_array_equal(last[:, 0], full[:, -1])


def test_env_flag_defaults(monkeypatch):
    from bigdl_tpu.utils import flags as jflags

    for val, want in (("1", True), ("0", False)):
        monkeypatch.setenv("BIGDL_TPU_QUANTIZE_KV_CACHE", val)
        assert flags.quantize_kv_default() == jflags.quantize_kv_default() == want
    monkeypatch.setenv("BIGDL_TPU_COMPRESS_KV_CACHE", "1")
    monkeypatch.setenv("BIGDL_TPU_COMPRESS_KV_BUDGET", "512")
    assert flags.compress_kv_budget() == jflags.compress_kv_budget() == 512
    monkeypatch.delenv("BIGDL_TPU_COMPRESS_KV_CACHE")
    assert flags.compress_kv_budget() is None
    monkeypatch.setenv("BIGDL_TPU_KV_CACHE_QUANTUM", "128")
    assert cache_len_for(100, 50) == 256


def test_tied_head_follows_jax():
    """A low-bit table under a tied head is the head's quantized weight in
    both packages; a host table under one is refused by both with an
    AttributeError (the head needs the table on the device)."""
    tied = dataclasses.replace(JCFG, tie_word_embeddings=True)
    jparams, model, tcfg = _fresh(cfg=tied)
    jq = jax_quantize_embedding(jparams["embed"], "sym_int4")
    model.set_embed(quantize_embedding(model.embed, "sym_int4"))
    _close(_forward(model, tcfg), _jax_forward(dict(jparams, embed=jq), tied))
    table = np.asarray(jparams["embed"], np.float32)
    with pytest.raises(AttributeError):
        _jax_forward(dict(jparams, embed=JaxHostEmbedding(table)), tied)
    model.set_embed(HostEmbedding(table))
    with pytest.raises(AttributeError, match="HostEmbedding"):
        _forward(model, tcfg)


def test_low_bit_embed_in_the_artifact_both_ways(tmp_path):
    """The JAX artifact carries a low-bit embed leaf: the port loads JAX's
    and JAX loads the port's, the table's fields unchanged; a host table
    is refused on the save by both packages (ValueError)."""
    jparams, model = pair("sym_int4")
    jq = jax_quantize_embedding(jparams["embed"], "sym_int4")
    jax_save_low_bit(str(tmp_path / "jax"), JCFG, dict(jparams, embed=jq), "sym_int4")
    _, loaded, _ = load_low_bit(str(tmp_path / "jax"), verify="full", device="cpu")
    for f, t in loaded.embed.fields().items():
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(getattr(jq, f), np.float32))
    tm = TorchModel(TCFG, loaded, "sym_int4", device="cpu")
    tm.save_low_bit(str(tmp_path / "port"))
    _, jloaded, _ = jax_load_low_bit(str(tmp_path / "port"), verify="full")
    for f in ARRAY_FIELDS:
        if getattr(jq, f) is not None:
            np.testing.assert_array_equal(np.asarray(getattr(jloaded["embed"], f)),
                                          np.asarray(getattr(jq, f)))
    np.testing.assert_array_equal(_forward(loaded), _forward(_with_embed(jq)))
    table = np.asarray(jparams["embed"], np.float32)
    with pytest.raises(ValueError):
        jax_save_low_bit(str(tmp_path / "jh"), JCFG, dict(jparams, embed=JaxHostEmbedding(table)),
                         "sym_int4")
    loaded.set_embed(HostEmbedding(table))
    with pytest.raises(ValueError, match="HostEmbedding"):
        save_low_bit(str(tmp_path / "ph"), TCFG, loaded, "sym_int4")


def _with_embed(jembed):
    """pair("sym_int4")'s weights in a fresh port model, embed from JAX's."""
    jparams, _ = pair("sym_int4")
    arrays, qtypes = {}, {}
    _flatten(dict(jparams, embed=jembed), "", arrays, qtypes)
    return params_from_numpy(arrays, qtypes, TCFG, device="cpu")
