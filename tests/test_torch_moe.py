"""The mixture-of-experts layer of the port against the JAX package, on
the CPU.

Two tiny configurations (hidden 256, 2 q heads of 128 over 1 kv head,
vocab 512, 2 layers: the attention's projections pass the fused kernels'
shape guards, so the port runs their plain versions and JAX, with
BIGDL_TPU_PALLAS=interpret, its Pallas kernels; the experts are plain
torch and plain XLA on both sides):

- mixtral: 4 experts of 512, top-2 with renormalized weights, the dense
  combine (JAX's auto rule at E <= 8);
- qwen2_moe: 8 experts of 128, top-4 without renormalization, the
  ragged (capacity) dispatch forced, a shared expert of 256 behind its
  sigmoid gate, q/k/v biases.

JAX's sym_int4 parameters cross with `params_from_numpy`. The routers are
drawn N(0, 0.2^2) (init_params' 0.02 gives router logits of ~0.3 whose
top-k margins are within the packages' bf16 rounding differences: a
near-tie picks another expert and moves a token's output by a whole
expert). Logits are held within 4 bf16 ULPs of JAX's largest logit, as
the dense tests hold them (test_torch_llama.py); greedy tokens by the
margin rule. The router and the MoE MLP are also held on one shared
input, where no rounding difference precedes them: the chosen experts
equal wherever JAX's k-th and (k+1)-th probabilities are apart by more
than 1e-6, the weights within 1e-6, the MLP's outputs within 4 bf16 ULPs
of its largest output (bf16 roundings chain through the experts' gate
and up products, the down product and the combine, each summed in
another order by the two libraries).

Then the capacity dispatch with overflow (a capacity factor of 0.25
drops most assignments), dense against ragged (a capacity factor of E / k
drops none: equal to 2e-4 in float32, JAX's own bound in
tests/test_moe.py), `resolve_moe_dispatch`, the sym_int4 self-draft of a
bf16 MoE model (JAX's bytes), `init_params(low_bit=)` against quantizing
after, the low-bit artifact byte-equal both ways, and HF ingest of
mixtral, qwen2_moe and qwen3_moe from safetensors written here.
"""

import dataclasses
import functools
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

from bigdl_tpu.api import AutoModelForCausalLM as JaxAuto
from bigdl_tpu.api import TpuModel
from bigdl_tpu.api import optimize_model as jax_optimize_model
from bigdl_tpu.convert.low_bit import _flatten as jax_flatten_artifact
from bigdl_tpu.models import llama as jllama
from bigdl_tpu.models.config import ModelConfig as JaxConfig
from bigdl_tpu.serving.engine import InferenceEngine as JaxEngine
from bigdl_tpu_torch import AutoModelForCausalLM, TorchModel, optimize_model
from bigdl_tpu_torch.convert import hf as hf_mod
from bigdl_tpu_torch.convert import params_from_numpy, params_to_numpy
from bigdl_tpu_torch.models import llama
from bigdl_tpu_torch.models.config import ModelConfig
from bigdl_tpu_torch.ops import kernels
from bigdl_tpu_torch.quant import QTensor
from bigdl_tpu_torch.serving import InferenceEngine
from test_torch_flags import _jax_steps, _perturb, _port_steps
from test_torch_llama import _flatten, _jax_last_logits, _port_last_logits
from test_torch_serving import _compare, _lockstep

torch.set_num_threads(1)

BASE = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
            num_attention_heads=2, num_key_value_heads=1)
MODELS = {
    "mixtral": dict(model_type="mixtral", num_experts=4, num_experts_per_tok=2,
                    norm_topk_prob=True, rope_theta=1e6),
    "qwen2_moe": dict(model_type="qwen2_moe", attention_bias=True, num_experts=8,
                      num_experts_per_tok=4, moe_intermediate_size=128,
                      shared_expert_intermediate_size=256, moe_dispatch="ragged"),
}
PROMPT_LENS = (14, 12, 16)
NEW_TOKENS = 6
# logits: 4 bf16 ULPs of JAX's largest (test_torch_llama.py); tokens may
# differ only where JAX's top-1/top-2 margin is within twice that
_TOL_ULPS = 2 ** -6
ROUTER_SCALE = 0.2


def _jax_config(name, **kw):
    return JaxConfig(**{**BASE, **MODELS[name], **kw})


def _port_config(jcfg):
    return ModelConfig(**dataclasses.asdict(jcfg))


def _routers(jparams, seed):
    """The JAX tree with its routers drawn N(0, ROUTER_SCALE^2) (bf16)."""
    out = dict(jparams)
    out["layers"] = dict(jparams["layers"])
    r = jparams["layers"]["router"]
    v = ROUTER_SCALE * np.random.default_rng(seed).standard_normal(r.shape)
    out["layers"]["router"] = jnp.asarray(v, r.dtype)
    return out


@functools.lru_cache(maxsize=None)
def _dense_tree(name):
    jcfg = _jax_config(name)
    jparams = jax.jit(functools.partial(jllama.init_params, jcfg))(jax.random.PRNGKey(0))
    return _routers(_perturb(jparams, jcfg, 1), 2)


@functools.lru_cache(maxsize=None)
def _quantized(name):
    """(jcfg, JAX sym_int4 tree, tcfg, the port's model of its bytes)."""
    jcfg = _jax_config(name)
    jparams = jax.jit(lambda p: jax_optimize_model(p, jcfg, "sym_int4"))(_dense_tree(name))
    arrays, qtypes = {}, {}
    _flatten(jparams, "", arrays, qtypes)
    tcfg = _port_config(jcfg)
    return jcfg, jparams, tcfg, params_from_numpy(arrays, qtypes, tcfg, device="cpu")


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    return (request.param,) + _quantized(request.param)


def _prompts(vocab):
    return [list(np.random.default_rng(i).integers(1, vocab, n))
            for i, n in enumerate(PROMPT_LENS)]


def _assert_logits_close(got, ref, what):
    for i, (g, r) in enumerate(zip(got, ref)):
        tol = _TOL_ULPS * np.abs(r).max()
        assert np.abs(g - r).max() <= tol, (what, i, np.abs(g - r).max(), tol)


def test_weights_carry_over_exactly(pair):
    """Each layer's MoEBlock holds JAX's bytes: the experts' QTensor
    fields [E, rows, *] as layer i of JAX's [L, E, rows, *], the router
    and shared gate dense; the attention's projections fused, the MLP
    unfused (JAX's merge leaves experts alone)."""
    name, jcfg, jparams, tcfg, model = pair
    jl = jparams["layers"]
    for i, layer in enumerate(model.layers):
        assert set(layer.proj) == {"wqkv", "wo"}
        leaves = layer.moe.leaves()
        assert set(leaves) == {k for k in llama.MOE_LEAVES if k in jl}
        for n, v in leaves.items():
            if isinstance(v, QTensor):
                assert v.qtype == jl[n].qtype == "sym_int4"
                for f, a in v.fields().items():
                    np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(jl[n], f)[i]),
                                                  err_msg=f"{n}@{f}")
            else:
                assert n in ("router", "shared_gate")
                np.testing.assert_array_equal(v.float().numpy(),
                                              np.asarray(jl[n][i], np.float32))


def _layer_leaves(jparams, i):
    return {k: (v.map_arrays(lambda a: a[i]) if hasattr(v, "map_arrays") else v[i])
            for k, v in jparams["layers"].items()}


@pytest.mark.parametrize("name", list(MODELS))
def test_router_matches_jax_on_one_input(name):
    jcfg, jparams, tcfg, model = _quantized(name)
    x = np.random.default_rng(5).standard_normal((3, 9, jcfg.hidden_size))
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(xj, np.float32)).to(torch.bfloat16)
    jv, ji = jllama._moe_router(jcfg, xj, _layer_leaves(jparams, 1))
    tv, ti = llama._moe_router(tcfg, xt, model.layers[1].moe.leaves())
    jv, ji = np.asarray(jv), np.asarray(ji)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0, atol=1e-6)
    # JAX's probabilities, sorted: a chosen expert may differ only on a near-tie
    logits = np.einsum("bth,eh->bte", np.asarray(xj, np.float32),
                       np.asarray(jparams["layers"]["router"][1], np.float32))
    p = np.sort(jax.nn.softmax(logits, -1), -1)[..., ::-1]
    k = jcfg.num_experts_per_tok
    clear = p[..., k - 1] - p[..., k] > 1e-6
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(np.sort(ti.numpy(), -1)[clear], np.sort(ji, -1)[clear])


@pytest.mark.parametrize("case", ["dense", "ragged", "overflow", "mixtral-ragged"])
def test_moe_mlp_matches_jax_on_one_input(case):
    """`_moe_mlp` on one bf16 input and layer 1's sym_int4 leaves: qwen2_moe
    ragged (shared expert), with overflow (capacity factor 0.25), and
    dense; mixtral dense and ragged. Within 4 bf16 ULPs of JAX's largest
    output."""
    name = "mixtral" if case.startswith("mixtral") else "qwen2_moe"
    jcfg, jparams, _, model = _quantized(name)
    kw = {"dense": dict(moe_dispatch="dense"), "ragged": {},
          "overflow": dict(moe_capacity_factor=0.25),
          "mixtral-ragged": dict(moe_dispatch="ragged")}.get(case, {})
    jcfg = dataclasses.replace(jcfg, **kw)
    tcfg = _port_config(jcfg)
    x = np.random.default_rng(6).standard_normal((2, 11, jcfg.hidden_size))
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(xj, np.float32)).to(torch.bfloat16)
    want = np.asarray(jllama._moe_mlp(jcfg, xj, _layer_leaves(jparams, 1), jnp.bfloat16),
                      np.float32)
    got = llama._moe_mlp(tcfg, xt, model.layers[1].moe.leaves(), torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    tol = _TOL_ULPS * np.abs(want).max()
    assert np.abs(got.float().numpy() - want).max() <= tol


def test_ragged_overflow_drops_what_jax_drops():
    """At a capacity of one slot an expert (N k cf / E < 1), the
    contributions that arrive are JAX's: the tokens whose assignments all
    overflowed get exactly 0 from the experts in both packages."""
    jcfg, jparams, _, model = _quantized("qwen2_moe")
    jcfg = dataclasses.replace(jcfg, moe_capacity_factor=0.05,
                               shared_expert_intermediate_size=None)
    tcfg = _port_config(jcfg)
    leaves = {k: v for k, v in model.layers[0].moe.leaves().items()
              if k in ("router",) + llama.MOE_EXPERTS}
    jleaves = {k: v for k, v in _layer_leaves(jparams, 0).items() if k in leaves}
    x = np.random.default_rng(7).standard_normal((1, 10, jcfg.hidden_size))
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(xj, np.float32)).to(torch.bfloat16)
    want = np.asarray(jllama._moe_mlp(jcfg, xj, jleaves, jnp.bfloat16), np.float32)
    got = llama._moe_mlp(tcfg, xt, leaves, torch.bfloat16).float().numpy()
    dropped = np.all(want == 0, axis=-1)
    assert dropped.sum() >= 2  # C = 1: at most 8 of the 10 tokens get a slot
    np.testing.assert_array_equal(np.all(got == 0, axis=-1), dropped)
    assert np.abs(got - want).max() <= _TOL_ULPS * np.abs(want).max()


@pytest.mark.parametrize("pallas", ["interpret", "0"])
def test_prefill_logits_match_jax(pair, pallas, monkeypatch):
    """Prefill over a dense cache: the flash kernel's plain version for the
    attention (both packages' kernels take the prefill), the experts in
    plain torch against plain XLA."""
    name, jcfg, jparams, tcfg, model = pair
    monkeypatch.setenv("BIGDL_TPU_PALLAS", pallas)
    prompts = _prompts(jcfg.vocab_size)
    none = np.zeros((len(prompts), 0), np.int64)
    kernels.reset_launches()
    got = _port_steps(tcfg, model, prompts, none)
    assert all(n == 0 for n in kernels.launch_counts().values())  # CPU: plain versions
    _assert_logits_close(got, _jax_steps(jcfg, jparams, prompts, none), name)


def test_dense_decode_logits_match_jax(pair, monkeypatch):
    name, jcfg, jparams, tcfg, model = pair
    monkeypatch.setenv("BIGDL_TPU_PALLAS", "0")
    prompts = _prompts(jcfg.vocab_size)
    steps = np.random.default_rng(9).integers(1, jcfg.vocab_size, (len(prompts), 3))
    _assert_logits_close(_port_steps(tcfg, model, prompts, steps),
                         _jax_steps(jcfg, jparams, prompts, steps), name)


def test_greedy_tokens_match_jax_where_margin_allows(pair, monkeypatch):
    """`generate` in both packages: prefill and decode through the experts."""
    name, jcfg, jparams, tcfg, model = pair
    monkeypatch.setenv("BIGDL_TPU_PALLAS", "interpret")
    prompts = _prompts(jcfg.vocab_size)
    want = TpuModel(jcfg, jparams, "sym_int4").generate(prompts, NEW_TOKENS)
    tm = TorchModel(tcfg, model, "sym_int4", device="cpu")
    got = tm.generate(prompts, NEW_TOKENS)
    np.testing.assert_array_equal(got, tm.generate(prompts, NEW_TOKENS))
    assert got.shape == want.shape == (len(prompts), NEW_TOKENS)
    for b in range(len(prompts)):
        diff = np.nonzero(got[b] != want[b])[0]
        if diff.size:
            ref = _jax_last_logits(jcfg, jparams, [prompts[b] + list(want[b, :diff[0]])])[0]
            top = np.sort(ref)
            assert top[-1] - top[-2] <= 2 * _TOL_ULPS * np.abs(ref).max(), (name, b)


def test_cache_free_forward_matches_jax(pair, monkeypatch):
    """The cache-free path (training, scoring) with left padding: the
    training flash kernel's plain version against JAX's interpret-mode
    kernel, logits at every valid position."""
    name, jcfg, jparams, tcfg, model = pair
    monkeypatch.setenv("BIGDL_TPU_PALLAS", "interpret")
    rng = np.random.default_rng(11)
    tokens = rng.integers(1, jcfg.vocab_size, (2, 12)).astype(np.int32)
    start = np.array([0, 4], np.int32)
    want, _ = jllama.forward(jcfg, jparams, jnp.asarray(tokens), None,
                             start=jnp.asarray(start))
    with torch.inference_mode():
        got, _ = llama.forward(tcfg, model, torch.from_numpy(tokens).long(), None,
                               start=torch.from_numpy(start))
    want, got = np.asarray(want), got.numpy()
    for b in range(2):
        _assert_logits_close(got[b, start[b]:], want[b, start[b]:], (name, b))


def test_ragged_with_overflow_matches_jax(monkeypatch):
    """A whole forward at capacity factor 0.25 (most assignments dropped)."""
    monkeypatch.setenv("BIGDL_TPU_PALLAS", "0")
    jcfg, jparams, _, model = _quantized("qwen2_moe")
    jcfg = dataclasses.replace(jcfg, moe_capacity_factor=0.25)
    prompts = _prompts(jcfg.vocab_size)
    steps = np.random.default_rng(12).integers(1, jcfg.vocab_size, (len(prompts), 2))
    _assert_logits_close(_port_steps(_port_config(jcfg), model, prompts, steps),
                         _jax_steps(jcfg, jparams, prompts, steps), "overflow")


@pytest.mark.parametrize("name", list(MODELS))
def test_dense_equals_ragged_when_nothing_overflows(name):
    """JAX's tests/test_moe.py:39 in the port: in float32, the capacity
    dispatch with a capacity factor of E / k (C >= N: nothing dropped)
    equals the dense combine within 2e-4."""
    _, _, tcfg, model = _quantized(name)
    dense = dataclasses.replace(tcfg, moe_dispatch="dense")
    ragged = dataclasses.replace(tcfg, moe_dispatch="ragged",
                                 moe_capacity_factor=tcfg.num_experts / tcfg.num_experts_per_tok)
    tokens = torch.tensor([[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8]])
    with torch.inference_mode():
        a = llama.forward(dense, model, tokens, None, compute_dtype=torch.float32)[0]
        b = llama.forward(ragged, model, tokens, None, compute_dtype=torch.float32)[0]
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-4, atol=2e-4)


def test_resolve_moe_dispatch_matches_jax():
    cases = [dict(num_experts=8), dict(num_experts=9), dict(num_experts=60, num_experts_per_tok=4),
             dict(num_experts=60, num_experts_per_tok=4, moe_dispatch="dense"),
             dict(num_experts=4, moe_dispatch="ragged")]
    for kw in cases:
        jcfg = JaxConfig(**{**BASE, "model_type": "mixtral", **kw})
        assert llama.resolve_moe_dispatch(_port_config(jcfg)) == jllama.resolve_moe_dispatch(jcfg)
    assert llama.resolve_moe_dispatch(_port_config(_jax_config("mixtral"))) == "dense"
    with pytest.raises(ValueError):
        ModelConfig(num_experts=8, moe_dispatch="Ragged")


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_engine_matches_jax(paged):
    """Both packages' engines in lockstep on mixtral: a prefix-sharing
    pair and a third request; pages after every step, greedy tokens by the
    margin rule, chosen-token logprobs within twice the logit bound, no
    page leaks. The paged decode takes the paged kernel's plain version."""
    jcfg, jparams, tcfg, model = _quantized("mixtral")
    kw = dict(n_slots=2, max_len=64, paged=paged, page_size=8)
    jeng = JaxEngine(TpuModel(jcfg, jparams, "sym_int4"), logprobs_top_k=2, **kw)
    teng = InferenceEngine(TorchModel(tcfg, model, "sym_int4", device="cpu"), **kw)
    with torch.inference_mode():
        logits, _ = llama.forward(tcfg, model, torch.arange(1, 17)[None], None)
    tol = _TOL_ULPS * float(logits.abs().max())
    prompts = _prompts(jcfg.vocab_size)
    script = {0: [dict(prompt=prompts[0], max_new_tokens=8),
                  dict(prompt=prompts[0][:9] + prompts[1], max_new_tokens=8)],
              3: [dict(prompt=prompts[2], max_new_tokens=8)]}
    reqs = _lockstep(jeng, teng, script)
    _compare(reqs, tol, [])
    assert [r.finish_reason for _, r in reqs] == ["length"] * 3
    if paged:
        assert teng.page_leaks() == jeng.page_leaks() == 0


def test_self_draft_quantizes_the_experts_as_jax():
    """A bf16 MoE model's sym_int4 self-draft: every projection and expert
    in JAX's draft bytes, the router and shared gate shared with the
    target (dense), the target left bf16."""
    jcfg = _jax_config("qwen2_moe")
    jdense = _dense_tree("qwen2_moe")
    arrays, qtypes = {}, {}
    _flatten(jdense, "", arrays, qtypes)
    tcfg = _port_config(jcfg)
    tm = TorchModel(tcfg, params_from_numpy(arrays, qtypes, tcfg, device="cpu"), "bf16",
                    device="cpu")
    draft = tm.self_draft_params()
    jdraft = jllama.quantize_params(jdense, "sym_int4")
    got, _ = params_to_numpy(draft)
    want = {}
    jax_flatten_artifact(jdraft, "", want, {})
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (draft.layers[0].moe.router.data_ptr()
            == tm.params.layers[0].moe.router.data_ptr())
    assert tm.params.layers[0].moe.proj["w_up_e"].qtype is None
    assert draft.layers[0].moe.proj["w_up_e"].qtype == "sym_int4"


@pytest.mark.parametrize("name", list(MODELS))
def test_init_params_low_bit_equals_quantizing_after(name):
    """Quantizing each layer as it is made (how a model too large for the
    card's memory in bf16 is built) gives the bytes of quantizing after."""
    tcfg = _port_config(_jax_config(name))
    a, _ = params_to_numpy(optimize_model(llama.init_params(tcfg, 3, device="cpu"), tcfg))
    b, _ = params_to_numpy(optimize_model(
        llama.init_params(tcfg, 3, device="cpu", low_bit="sym_int4"), tcfg))
    assert a.keys() == b.keys() and "layers.w_gate_e@data" in a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name", list(MODELS))
def test_artifacts_are_the_same_bytes_both_ways(name, tmp_path, monkeypatch):
    """An MoE model saved by each package: the same npz members (the
    experts' fields stacked [L, E, ...], the router dense), digests,
    manifest and model_config; each package loads the other's (the port
    JAX's: prefill logits within the bound; JAX the port's under
    verify="full": its greedy tokens exactly)."""
    monkeypatch.setenv("BIGDL_TPU_PALLAS", "0")
    jcfg, jparams, tcfg, model = _quantized(name)
    jm = TpuModel(jcfg, jparams, "sym_int4")
    TorchModel(tcfg, model, "sym_int4", device="cpu").save_low_bit(str(tmp_path / "port"))
    jm.save_low_bit(str(tmp_path / "jax"))
    metas, members = {}, {}
    for side in ("jax", "port"):
        metas[side] = json.loads((tmp_path / side / "bigdl_tpu_config.json").read_text())
        with zipfile.ZipFile(tmp_path / side / metas[side]["weights_file"]) as zf:
            members[side] = {n: zf.read(n) for n in zf.namelist()}
    assert members["port"].keys() == members["jax"].keys()
    assert {"layers.router.npy", "layers.w_gate_e@data.npy", "layers.w_down_e@scales.npy"} <= \
        members["jax"].keys()
    for member, raw in members["jax"].items():
        assert members["port"][member] == raw, member
    for key in ("format_version", "qtype", "model_config", "manifest", "integrity"):
        assert metas["port"][key] == metas["jax"][key], key
    loaded = AutoModelForCausalLM.load_low_bit(str(tmp_path / "jax"), device="cpu")
    prompts = _prompts(jcfg.vocab_size)
    ref = _jax_last_logits(jcfg, jparams, prompts)
    got = _port_last_logits(loaded.config, loaded.params, prompts)
    assert np.abs(got - ref).max() <= _TOL_ULPS * np.abs(ref).max()
    back = JaxAuto.load_low_bit(str(tmp_path / "port"), verify="full")
    assert back.salvage_report is None and back.config == jcfg
    np.testing.assert_array_equal(back.generate(prompts, NEW_TOKENS),
                                  jm.generate(prompts, NEW_TOKENS))


# tiny HF configs of the three MoE families (the published configs'
# field names; mixtral and qwen3_moe at 4 experts, qwen2_moe at 8 with
# its shared expert)
LLAMA_HF = {"vocab_size": 512, "hidden_size": 256, "intermediate_size": 512,
            "num_hidden_layers": 2, "num_attention_heads": 2, "num_key_value_heads": 1,
            "rms_norm_eps": 1e-6, "rope_theta": 1e6, "max_position_embeddings": 128,
            "tie_word_embeddings": False, "hidden_act": "silu"}
HF_MOE = {
    "mixtral": {**LLAMA_HF, "model_type": "mixtral", "num_local_experts": 4,
                "num_experts_per_tok": 2},
    "qwen2_moe": {**LLAMA_HF, "model_type": "qwen2_moe", "num_experts": 8,
                  "num_experts_per_tok": 4, "moe_intermediate_size": 128,
                  "shared_expert_intermediate_size": 256, "norm_topk_prob": False},
    "qwen3_moe": {**LLAMA_HF, "model_type": "qwen3_moe", "head_dim": 128, "num_experts": 4,
                  "num_experts_per_tok": 2, "moe_intermediate_size": 256,
                  "norm_topk_prob": True},
}


def _write_moe_checkpoint(root, hf, seed):
    """config.json and one safetensors file of bf16 weights under HF's
    names: N(0, 0.02^2) projections and experts, routers N(0, 0.2^2),
    norms around 1; qwen2_moe's q/k/v biases and shared expert, qwen3's
    q/k norms."""
    root.mkdir(parents=True, exist_ok=True)
    (root / "config.json").write_text(json.dumps(hf))
    rng = np.random.default_rng(seed)
    mt = hf["model_type"]
    H, V = hf["hidden_size"], hf["vocab_size"]
    D = hf.get("head_dim") or H // hf["num_attention_heads"]
    QD, KD = hf["num_attention_heads"] * D, hf["num_key_value_heads"] * D
    E = hf.get("num_local_experts") or hf["num_experts"]
    EI = hf.get("moe_intermediate_size") or hf["intermediate_size"]

    def w(*shape, scale=0.02, loc=0.0):
        return torch.from_numpy((loc + scale * rng.standard_normal(shape)).astype(np.float32)
                                ).to(torch.bfloat16)

    ts = {"model.embed_tokens.weight": w(V, H), "model.norm.weight": w(H, scale=0.1, loc=1.0),
          "lm_head.weight": w(V, H)}
    for i in range(hf["num_hidden_layers"]):
        p = f"model.layers.{i}."
        ts[p + "input_layernorm.weight"] = w(H, scale=0.1, loc=1.0)
        ts[p + "post_attention_layernorm.weight"] = w(H, scale=0.1, loc=1.0)
        for n, rows, cols in (("q", QD, H), ("k", KD, H), ("v", KD, H), ("o", H, QD)):
            ts[p + f"self_attn.{n}_proj.weight"] = w(rows, cols)
        moe = p + ("block_sparse_moe." if mt == "mixtral" else "mlp.")
        ts[moe + "gate.weight"] = w(E, H, scale=ROUTER_SCALE)
        names = ("w1", "w3", "w2") if mt == "mixtral" else ("gate_proj", "up_proj", "down_proj")
        for e in range(E):
            for n, shape in zip(names, ((EI, H), (EI, H), (H, EI))):
                ts[moe + f"experts.{e}.{n}.weight"] = w(*shape)
        if mt == "qwen2_moe":
            for n in ("q", "k", "v"):
                ts[p + f"self_attn.{n}_proj.bias"] = w(QD if n == "q" else KD, scale=0.1)
            S = hf["shared_expert_intermediate_size"]
            for n, shape in (("gate_proj", (S, H)), ("up_proj", (S, H)), ("down_proj", (H, S))):
                ts[p + f"mlp.shared_expert.{n}.weight"] = w(*shape)
            ts[p + "mlp.shared_expert_gate.weight"] = w(1, H)
        if mt == "qwen3_moe":
            ts[p + "self_attn.q_norm.weight"] = w(D, scale=0.1, loc=1.0)
            ts[p + "self_attn.k_norm.weight"] = w(D, scale=0.1, loc=1.0)
    save_file(ts, str(root / "model.safetensors"))
    return root, ts


@pytest.mark.parametrize("family", list(HF_MOE))
def test_hf_ingest_matches_jax_and_params_from_numpy(tmp_path, family, monkeypatch):
    """Ingest in row chunks (40 rows of 256: every expert goes in pieces)
    gives JAX's ingest bytes and dense leaves, the same model as
    `params_from_numpy` of the same tensors under JAX's names +
    `optimize_model`, and prefill logits within the bound."""
    monkeypatch.setenv("BIGDL_TPU_PALLAS", "0")
    monkeypatch.setattr(hf_mod, "QUANT_CHUNK", 40 * 256)
    d, ts = _write_moe_checkpoint(tmp_path / family, HF_MOE[family], 8)
    jm = JaxAuto.from_pretrained(str(d), load_in_low_bit="sym_int4")
    tm = AutoModelForCausalLM.from_pretrained(str(d), load_in_low_bit="sym_int4", device="cpu")
    assert dataclasses.asdict(tm.config) == dataclasses.asdict(jm.config)
    assert set(tm.params.layers[0].proj) == {"wqkv", "wo"}
    jarrays, jmanifest = {}, {}
    jax_flatten_artifact(jm.params, "", jarrays, jmanifest)
    arrays, manifest = params_to_numpy(tm.params)
    assert manifest == jmanifest and arrays.keys() == jarrays.keys()
    for k, a in jarrays.items():
        np.testing.assert_array_equal(arrays[k], a, err_msg=k)

    def get(name):
        return ts[name].float().numpy()

    tables = [hf_mod.layer_tensors(tm.config, i, lambda n: torch.from_numpy(get(n)))
              for i in range(tm.config.num_hidden_layers)]
    dense = {f"layers.{k}": np.stack([t[k].numpy() for t in tables]) for k in tables[0]}
    dense.update(embed=get("model.embed_tokens.weight"), final_norm=get("model.norm.weight"),
                 lm_head=get("lm_head.weight"))
    direct = optimize_model(params_from_numpy(dense, {}, tm.config, device="cpu"), tm.config)
    direct_arrays, _ = params_to_numpy(direct)
    assert direct_arrays.keys() == arrays.keys()
    for k, a in arrays.items():
        np.testing.assert_array_equal(direct_arrays[k], a, err_msg=k)
    prompts = _prompts(512)
    ref = _jax_last_logits(jm.config, jm.params, prompts)
    got = _port_last_logits(tm.config, tm.params, prompts)
    assert np.abs(got - ref).max() <= _TOL_ULPS * np.abs(ref).max()


def test_refusals_name_what_is_still_unported():
    """phixtral's non-gated experts and MLP biases beside experts run since
    the rest of the llama flags were ported (test_torch_layer_shapes.py);
    DeepSeek's MoE fields (item [9]) raise, naming their item;
    params_from_numpy without an MoE leaf the config needs raises."""
    base = _port_config(_jax_config("mixtral"))
    for kw in ({"gated_mlp": False}, {"mlp_bias": True}):
        llama.check_supported(dataclasses.replace(base, **kw))
    for kw in ({"n_shared_experts": 2}, {"topk_method": "noaux_tc"}):
        with pytest.raises(NotImplementedError, match=r"ROADMAP queue 1 item \[9\]"):
            llama.check_supported(dataclasses.replace(base, **kw))
    _, jparams, tcfg, _ = _quantized("mixtral")
    arrays, qtypes = {}, {}
    _flatten(jparams, "", arrays, qtypes)
    arrays = {k: v for k, v in arrays.items() if not k.startswith("layers.router")}
    with pytest.raises(ValueError, match="router"):
        params_from_numpy(arrays, qtypes, tcfg, device="cpu")
