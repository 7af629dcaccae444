"""The low-bit artifact between the JAX package and the port, both ways.

JAX's `TpuModel.save_low_bit` writes and the port's
`AutoModelForCausalLM.load_low_bit` reads (prefill logits within
tests/test_torch_llama.py's tolerance, greedy tokens by its margin
rule); the port writes and JAX's `load_low_bit(verify="full")` reads
(the same tokens as the JAX model the weights came from); both packages
save the same weights as the same npz member bytes, digests, manifest and
model_config, in all 16 formats, q4_k_m and dense bf16, and for a
gemma2-style and a qwen2-style model (their flags' leaves: bqkv,
b_gateup, post and q/k norms, a tied head's missing lm_head), which
each package also loads from the other's save. The durability paths
(a flipped byte in every verify mode, salvage, verify_low_bit's rows,
the format-version gate, the overwrite's new archive and sweep) are held
to JAX's behaviour on the same bytes. All on the CPU at hidden 256,
where every projection passes every format's k_multiple.
"""

import dataclasses
import functools
import json
import os
import shutil
import zipfile

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu.api import AutoModelForCausalLM as JaxAuto
from bigdl_tpu.api import TpuModel
from bigdl_tpu.api import optimize_model as jax_optimize_model
from bigdl_tpu.convert import load_low_bit as jax_load_low_bit
from bigdl_tpu.convert import verify_low_bit as jax_verify_low_bit
from bigdl_tpu.convert.low_bit import _flatten as jax_flatten_artifact
from bigdl_tpu.models import llama as jllama
from bigdl_tpu.models.config import ModelConfig as JaxConfig
from bigdl_tpu.quant.qtypes import resolve_qtype, split_mixed_qtype
from bigdl_tpu.utils.durability import IntegrityError as JaxIntegrityError
from bigdl_tpu_torch import AutoModelForCausalLM, TorchModel, load_low_bit, verify_low_bit
from bigdl_tpu_torch.convert import params_from_numpy, params_to_numpy
from bigdl_tpu_torch.models.config import ModelConfig
from bigdl_tpu_torch.utils.durability import IntegrityError
from test_torch_flags import BASE as FLAGS_BASE
from test_torch_flags import GROUPS
from test_torch_flags import _perturb as perturb
from test_torch_llama import (NEW_TOKENS, PROMPT_LENS, _TOL_ULPS,
                              _assert_tokens_match_where_margin_allows, _flatten,
                              _jax_last_logits, _port_last_logits)

torch.set_num_threads(1)

CFG = JaxConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                num_attention_heads=2, num_key_value_heads=1)
PROMPTS = [list(np.random.default_rng(i).integers(1, CFG.vocab_size, n))
           for i, n in enumerate(PROMPT_LENS)]
# all 16 formats, the mixed q4_k_m (q6_k head) and a dense bf16 model
FORMATS = ["sym_int4", "asym_int4", "nf4", "fp4", "sym_int8", "asym_int5", "fp8_e4m3",
           "fp8_e5m2", "sym_int5", "fp6", "nf3", "q2_k", "q3_k", "q4_k", "q5_k", "q6_k",
           "q4_k_m", "bf16"]


@functools.lru_cache(maxsize=None)
def jax_model(qtype: str) -> TpuModel:
    jparams = jax.jit(functools.partial(jllama.init_params, CFG))(jax.random.PRNGKey(0))
    if resolve_qtype(split_mixed_qtype(qtype)[0]).superblock:
        jparams = jax_optimize_model(jparams, CFG, qtype)  # host encoder
    else:
        jparams = jax.jit(lambda p: jax_optimize_model(p, CFG, qtype))(jparams)
    return TpuModel(CFG, jparams, qtype)


def port_model(qtype: str) -> TorchModel:
    """The JAX model's weights carried into the port (params_from_numpy)."""
    arrays, qtypes = {}, {}
    _flatten(jax_model(qtype).params, "", arrays, qtypes)
    tcfg = ModelConfig(**dataclasses.asdict(CFG))
    return TorchModel(tcfg, params_from_numpy(arrays, qtypes, tcfg, device="cpu"), qtype,
                      device="cpu")


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """sym_int4 saved by each package: {"jax": dir, "port": dir}."""
    root = tmp_path_factory.mktemp("low_bit")
    jax_model("sym_int4").save_low_bit(str(root / "jax"))
    port_model("sym_int4").save_low_bit(str(root / "port"))
    return {"jax": root / "jax", "port": root / "port"}


def _copy(src, tmp_path, name):
    dst = tmp_path / name
    shutil.copytree(src, dst)
    return dst


def test_jax_writes_the_port_reads(artifacts, monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_PALLAS", "0")
    model = AutoModelForCausalLM.load_low_bit(str(artifacts["jax"]), device="cpu")
    assert model.salvage_report is None and model.qtype == "sym_int4"
    jm = jax_model("sym_int4")
    ref = _jax_last_logits(CFG, jm.params, PROMPTS)
    got = _port_last_logits(model.config, model.params, PROMPTS)
    assert np.abs(got - ref).max() <= _TOL_ULPS * np.abs(ref).max()
    want = jm.generate(PROMPTS, NEW_TOKENS)
    _assert_tokens_match_where_margin_allows("sym_int4", CFG, jm.params, PROMPTS,
                                             model.generate(PROMPTS, NEW_TOKENS), want)


def test_the_port_writes_jax_reads(artifacts):
    jm = JaxAuto.load_low_bit(str(artifacts["port"]), verify="full")
    assert jm.salvage_report is None and jm.config == CFG
    np.testing.assert_array_equal(jm.generate(PROMPTS, NEW_TOKENS),
                                  jax_model("sym_int4").generate(PROMPTS, NEW_TOKENS))


@pytest.mark.parametrize("qtype", FORMATS)
def test_both_packages_write_the_same_bytes(qtype, tmp_path):
    jax_model(qtype).save_low_bit(str(tmp_path / "jax"))
    port_model(qtype).save_low_bit(str(tmp_path / "port"))
    metas = {}
    members = {}
    for side in ("jax", "port"):
        with open(tmp_path / side / "bigdl_tpu_config.json") as f:
            metas[side] = json.load(f)
        with zipfile.ZipFile(tmp_path / side / metas[side]["weights_file"]) as zf:
            members[side] = {n: zf.read(n) for n in zf.namelist()}
    assert members["port"].keys() == members["jax"].keys()
    for name, raw in members["jax"].items():
        assert members["port"][name] == raw, name
    for key in ("format_version", "qtype", "model_config", "manifest", "integrity"):
        assert metas["port"][key] == metas["jax"][key], key


# flagged configurations (tests/test_torch_flags.py's tiny widths, its
# non-zero biases and norms): gemma2-style (every flag, tied head) and
# qwen2-style (q/k/v biases, merged into bqkv)
FLAGGED = {"gemma2": GROUPS["gemma2"], "qwen2": dict(model_type="qwen2", attention_bias=True)}


@functools.lru_cache(maxsize=None)
def flagged_model(name: str) -> TpuModel:
    jcfg = JaxConfig(**FLAGS_BASE, **FLAGGED[name])
    jparams = jax.jit(functools.partial(jllama.init_params, jcfg))(jax.random.PRNGKey(0))
    jparams = jax.jit(lambda p: jax_optimize_model(p, jcfg, "sym_int4"))(
        perturb(jparams, jcfg, 1))
    return TpuModel(jcfg, jparams, "sym_int4")


@pytest.mark.parametrize("name", list(FLAGGED))
def test_flagged_artifacts_are_the_same_bytes_both_ways(name, tmp_path, monkeypatch):
    """A flagged model saved by each package: the same npz members (bqkv,
    b_gateup where the flags have them, gemma2's post norms and q/k norms,
    no lm_head member when tied), digests, manifest and model_config.
    Each package then loads the other's: the port JAX's (prefill logits
    within test_torch_llama.py's bound, every array as JAX holds it), JAX
    the port's under verify="full" (JAX's greedy tokens exactly)."""
    monkeypatch.setenv("BIGDL_TPU_PALLAS", "0")
    jm = flagged_model(name)
    arrays, qtypes = {}, {}
    _flatten(jm.params, "", arrays, qtypes)
    tcfg = ModelConfig(**dataclasses.asdict(jm.config))
    TorchModel(tcfg, params_from_numpy(arrays, qtypes, tcfg, device="cpu"), "sym_int4",
               device="cpu").save_low_bit(str(tmp_path / "port"))
    jm.save_low_bit(str(tmp_path / "jax"))
    metas, members = {}, {}
    for side in ("jax", "port"):
        metas[side] = json.loads((tmp_path / side / "bigdl_tpu_config.json").read_text())
        with zipfile.ZipFile(tmp_path / side / metas[side]["weights_file"]) as zf:
            members[side] = {n: zf.read(n) for n in zf.namelist()}
    assert members["port"].keys() == members["jax"].keys()
    heads = [m for m in members["jax"] if m.startswith("lm_head")]
    assert bool(heads) != jm.config.tie_word_embeddings, heads
    want = {"gemma2": {"layers.bqkv.npy", "layers.b_gateup.npy", "layers.bo.npy",
                       "layers.post_attn_norm.npy", "layers.q_norm.npy"},
            "qwen2": {"layers.bqkv.npy"}}[name]
    assert want <= members["jax"].keys()
    for member, raw in members["jax"].items():
        assert members["port"][member] == raw, member
    for key in ("format_version", "qtype", "model_config", "manifest", "integrity"):
        assert metas["port"][key] == metas["jax"][key], key

    loaded = AutoModelForCausalLM.load_low_bit(str(tmp_path / "jax"), device="cpu")
    got_arrays, _ = params_to_numpy(loaded.params)
    jarrays = {}
    jax_flatten_artifact(jm.params, "", jarrays, {})
    assert got_arrays.keys() == jarrays.keys()
    for k, a in jarrays.items():
        np.testing.assert_array_equal(got_arrays[k], a, err_msg=k)
    ref = _jax_last_logits(jm.config, jm.params, PROMPTS)
    got = _port_last_logits(loaded.config, loaded.params, PROMPTS)
    assert np.abs(got - ref).max() <= _TOL_ULPS * np.abs(ref).max()
    back = JaxAuto.load_low_bit(str(tmp_path / "port"), verify="full")
    assert back.salvage_report is None and back.config == jm.config
    np.testing.assert_array_equal(back.generate(PROMPTS, NEW_TOKENS),
                                  jm.generate(PROMPTS, NEW_TOKENS))


def _flip_byte(path, member):
    """Flip one payload byte of an npz member past its .npy header."""
    wpath = path / json.loads((path / "bigdl_tpu_config.json").read_text())["weights_file"]
    with zipfile.ZipFile(wpath) as zf:
        info = zf.getinfo(member + ".npy")
    with open(wpath, "r+b") as f:
        f.seek(info.header_offset + 26)
        n, m = (int.from_bytes(f.read(2), "little") for _ in range(2))
        at = info.header_offset + 30 + n + m + info.file_size - 3
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ 0x5A]))


def _rewrite_member(path, member):
    """Rewrite the archive with one payload byte of `member` flipped and
    the zip's own crc brought up to date: only the manifest's digests
    can tell."""
    wpath = path / json.loads((path / "bigdl_tpu_config.json").read_text())["weights_file"]
    with zipfile.ZipFile(wpath) as zf:
        members = [(n, zf.read(n)) for n in zf.namelist()]
    with zipfile.ZipFile(wpath, "w", zipfile.ZIP_STORED) as zf:
        for n, raw in members:
            if n == member + ".npy":
                raw = raw[:-3] + bytes([raw[-3] ^ 0x5A]) + raw[-2:]
            zf.writestr(n, raw)


@pytest.mark.parametrize("how", ["payload", "rewritten"])
@pytest.mark.parametrize("verify", ["off", "fast", "full"])
def test_a_flipped_byte_names_its_tensor(artifacts, tmp_path, verify, how):
    """A flipped payload byte fails the zip's own crc in every mode; a
    member rewritten with a matching zip crc fails the digests in fast
    and full mode, and loads unchecked in off mode, in both packages."""
    d = _copy(artifacts["port"], tmp_path, "flip")
    (_flip_byte if how == "payload" else _rewrite_member)(d, "layers.wo@data")
    if how == "rewritten" and verify == "off":
        jax_load_low_bit(str(d), verify=verify)
        load_low_bit(str(d), verify=verify, device="cpu")
        return
    with pytest.raises(JaxIntegrityError) as jerr:
        jax_load_low_bit(str(d), verify=verify)
    with pytest.raises(IntegrityError) as terr:
        load_low_bit(str(d), verify=verify, device="cpu")
    assert list(terr.value.corrupted) == list(jerr.value.corrupted) == ["layers.wo@data"]
    assert terr.value.corrupted == jerr.value.corrupted
    assert (terr.value.missing, terr.value.extra) == (jerr.value.missing, jerr.value.extra)


def test_salvage_quarantines_what_jax_quarantines(artifacts, tmp_path):
    d = _copy(artifacts["jax"], tmp_path, "salvage")
    _flip_byte(d, "layers.w_gateup@scales")
    _flip_byte(d, "final_norm")
    *_, jreport = jax_load_low_bit(str(d), verify="full", salvage=True)
    cfg, tree, qtype, report = load_low_bit(str(d), verify="full", salvage=True, device="cpu")
    assert report.quarantined_params == jreport.quarantined_params == ["final_norm",
                                                                      "layers.w_gateup"]
    assert report.corrupted == jreport.corrupted
    assert "final_norm" not in tree and "w_gateup" not in tree["layers"]
    assert tree["layers"]["wqkv"].qtype == "sym_int4"
    model = AutoModelForCausalLM.load_low_bit(str(d), verify="full", salvage=True, device="cpu")
    assert model.salvage_report.quarantined_params == jreport.quarantined_params


def test_verify_low_bit_rows_equal_jax(artifacts, tmp_path):
    d = _copy(artifacts["port"], tmp_path, "verify")
    assert verify_low_bit(str(d)).ok and jax_verify_low_bit(str(d)).ok
    _flip_byte(d, "embed")
    meta = json.loads((d / "bigdl_tpu_config.json").read_text())
    wpath = d / meta["weights_file"]
    with zipfile.ZipFile(wpath, "a") as zf:  # an extra member
        zf.writestr("stray.npy", b"x")
    got, want = verify_low_bit(str(d)), jax_verify_low_bit(str(d))
    rows = sorted((r.name, r.status, r.detail) for r in got.rows)
    assert rows == sorted((r.name, r.status, r.detail) for r in want.rows)
    assert not got.ok and got.format() == want.format()


@pytest.mark.parametrize("version,qtype,ok", [(1, "sym_int4", False), (3, "q2_k", False),
                                               (3, "sym_int4", True)])
def test_the_version_gate_matches_jax(tmp_path, version, qtype, ok):
    d = tmp_path / "v"
    (jax_model(qtype).save_low_bit if qtype == "q2_k" else
     port_model(qtype).save_low_bit)(str(d))
    meta = json.loads((d / "bigdl_tpu_config.json").read_text())
    meta["format_version"] = version
    (d / "bigdl_tpu_config.json").write_text(json.dumps(meta))
    if ok:
        _, model, _ = load_low_bit(str(d), device="cpu")
        jax_load_low_bit(str(d))
        assert model.layers[0].proj["wqkv"].qtype == qtype
    else:
        for load in (functools.partial(load_low_bit, device="cpu"), jax_load_low_bit):
            with pytest.raises(ValueError, match=f"unsupported format_version {version}"):
                load(str(d))


def test_an_overwrite_writes_a_new_archive_and_sweeps_the_old(tmp_path):
    d = tmp_path / "ow"
    m = port_model("sym_int4")
    m.save_low_bit(str(d))
    assert sorted(os.listdir(d)) == ["bigdl_tpu_config.json", "weights.npz"]
    (d / "weights-0badf00d.npz.tmp-123").write_bytes(b"stale")
    (d / "weights.npz.bak").write_bytes(b"operator's")
    m.save_low_bit(str(d))
    files = sorted(os.listdir(d))
    wname = json.loads((d / "bigdl_tpu_config.json").read_text())["weights_file"]
    assert wname.startswith("weights-") and files == sorted(
        ["bigdl_tpu_config.json", wname, "weights.npz.bak"])
    assert verify_low_bit(str(d)).ok and jax_verify_low_bit(str(d)).ok


def test_faults_are_not_ported_and_the_card_is_the_default(artifacts, tmp_path):
    # the disk fault injector is ported (tests/test_torch_journal_tracing.py
    # holds every mode against JAX's): a dropped weights write is detected
    # at load, as in JAX
    from bigdl_tpu_torch.utils.diskfaults import DiskFaultInjector

    d = str(tmp_path / "f")
    port_model("sym_int4").save_low_bit(d, faults=DiskFaultInjector(seed=1).arm("drop_file"))
    assert not os.path.exists(os.path.join(d, "weights.npz"))
    with pytest.raises(IntegrityError, match="does not exist"):
        load_low_bit(d, device="cpu")
    with pytest.raises(JaxIntegrityError, match="does not exist"):
        jax_load_low_bit(d)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_low_bit(str(artifacts["port"]))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            AutoModelForCausalLM.load_low_bit(str(artifacts["port"]))
