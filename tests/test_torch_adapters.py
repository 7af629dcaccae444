"""Multi-tenant LoRA adapter serving in bigdl_tpu_torch against the JAX
package (bigdl_tpu/serving/adapters.py and the engine's adapter routing;
tests/test_adapters.py is the JAX package's own suite).

Oracles: the JAX engine on the same request trace (greedy tokens by the
margin rule of test_torch_serving.py, chosen-token logprobs), and the
offline merge: a request decoding with adapter X through the batched
epilogue gives the tokens of the same prompt through a model whose
weights were merged with `merge_lora` (the base kept dense bf16, so the
merge is exact up to rounding). Adapter artifacts cross between the
packages both ways.

Two configurations: tiny-llama with a dense bf16 base (every projection
takes the dequant path and the plain epilogue), and a small sym_int4
model wide enough for the fused path (hidden 256: wo and w_down fold the
adapters into the LoRA GEMV and GEMM, their plain versions here)."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.api import TpuModel
from bigdl_tpu.api import optimize_model as jax_optimize_model
from bigdl_tpu.models import llama as jllama
from bigdl_tpu.models.config import PRESETS as JAX_PRESETS
from bigdl_tpu.models.config import ModelConfig as JaxConfig
from bigdl_tpu.ops.linear import _lora_cat_operands as jax_lora_cat_operands
from bigdl_tpu.quant import QTensor as JaxQTensor
from bigdl_tpu.serving.adapters import AdapterRegistry as JaxRegistry
from bigdl_tpu.serving.adapters import load_adapter as jax_load_adapter
from bigdl_tpu.serving.adapters import save_adapter as jax_save_adapter
from bigdl_tpu.serving.engine import InferenceEngine as JaxEngine
from bigdl_tpu.train import init_lora as jax_init_lora
from bigdl_tpu_torch import TorchModel
from bigdl_tpu_torch.convert import lora_from_numpy, params_from_numpy
from bigdl_tpu_torch.models import llama
from bigdl_tpu_torch.models.config import ModelConfig
from bigdl_tpu_torch.ops import kernels
from bigdl_tpu_torch.ops.linear import _lora_cat_operands, lora_epilogue
from bigdl_tpu_torch.serving import InferenceEngine
from bigdl_tpu_torch.serving.adapters import (AdapterError, AdapterRegistry,
                                              load_adapter, rank_bucket,
                                              save_adapter)
from bigdl_tpu_torch.train import merge_lora
from bigdl_tpu_torch.utils.durability import IntegrityError

# one intra-op thread per test worker (see test_torch_serving.py)
torch.set_num_threads(1)

TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
TENANTS = (("t-r2", 11, 2), ("t-r3", 12, 3), ("t-r5", 13, 5))
PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8], [9, 9, 8, 2, 4, 9, 1],
           [5, 3, 5, 8, 9, 7]]
JOBS = list(zip(PROMPTS, [None, "t-r2", "t-r3", "t-r5"]))
# logits of the two packages agree within 4 bf16 ULPs of the largest
# (test_torch_llama.py): chosen-token logprobs within twice that, and a
# greedy token may differ only where the reference's top-1/top-2 margin
# is within twice that too
_TOL_ULPS = 2 ** -6


def _flatten(tree, prefix, arrays, qtypes):
    """A JAX tree under convert/low_bit.py's key naming, bf16 leaves
    widened to float32 (exact)."""
    if isinstance(tree, JaxQTensor):
        qtypes[prefix] = tree.qtype
        arrays[f"{prefix}@data"] = np.asarray(tree.data)
        arrays[f"{prefix}@scales"] = np.asarray(tree.scales)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}.{k}" if prefix else k, arrays, qtypes)
    else:
        arrays[prefix] = np.asarray(tree, np.float32)


def _mk_lora(cfg, seed: int, rank: int):
    """A JAX rank-r adapter on all seven projections with NONZERO B
    (init_lora's B = 0 is the identity adapter), alpha = 2 rank."""
    lora = jax_init_lora(cfg, jax.random.PRNGKey(seed), rank=rank,
                         alpha=2.0 * rank, targets=TARGETS)
    for i, t in enumerate(TARGETS):
        b = lora["layers"][t]["b"]
        lora["layers"][t]["b"] = (jax.random.normal(
            jax.random.PRNGKey(seed * 31 + i), b.shape, jnp.float32) * 0.05).astype(b.dtype)
    return lora


class _Setup:
    """JAX model + port model over the same weights, three tenants saved
    by the JAX package, and the logit-scale tolerance."""

    def __init__(self, jcfg, qtype, adapter_dir):
        jparams = jax.jit(functools.partial(jllama.init_params, jcfg))(jax.random.PRNGKey(7))
        jparams = jax.jit(lambda p: jax_optimize_model(p, jcfg, qtype))(jparams)
        self.jcfg, self.qtype = jcfg, qtype
        self.jmodel = TpuModel(jcfg, jparams, qtype)
        self.arrays, self.qtypes = {}, {}
        _flatten(jparams, "", self.arrays, self.qtypes)
        self.tcfg = ModelConfig(**dataclasses.asdict(jcfg))
        self.tmodel = self.port_model()
        self.dir = str(adapter_dir)
        self.loras = {}
        for name, seed, rank in TENANTS:
            lora = _mk_lora(jcfg, seed, rank)
            jax_save_adapter(os.path.join(self.dir, f"{name}.npz"), lora)
            self.loras[name] = lora
        with torch.inference_mode():
            logits, _ = llama.forward(self.tcfg, self.tmodel.params,
                                      torch.arange(1, 17)[None] % self.tcfg.vocab_size, None)
        self.tol = _TOL_ULPS * float(logits.abs().max())

    def port_model(self):
        return TorchModel(self.tcfg, params_from_numpy(self.arrays, self.qtypes, self.tcfg,
                                                       device="cpu"), self.qtype, device="cpu")

    def merged(self, name, prompt, paged=True, n_new=8):
        """The request of `prompt` through the port's base merged offline
        with tenant `name` (None: the base), alone in an engine."""
        tm = self.port_model()
        if name is not None:
            la = {}
            _flatten(self.loras[name], "", la, {})
            merge_lora(tm.params, lora_from_numpy(la, self.tcfg, device="cpu"))
        eng = InferenceEngine(tm, n_slots=1, max_len=128, paged=paged, page_size=16,
                              logprobs_top_k=2)
        req = eng.submit(prompt, max_new_tokens=n_new)
        eng.run_until_idle()
        return req


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return _Setup(JAX_PRESETS["tiny-llama"], "bf16", tmp_path_factory.mktemp("tiny"))


@pytest.fixture(scope="module")
def fused(tmp_path_factory):
    cfg = JaxConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                    num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1)
    return _Setup(cfg, "sym_int4", tmp_path_factory.mktemp("fused"))


@pytest.fixture(scope="module")
def oracle(tiny):
    """Merged-weight requests per (tenant, prompt, paged) of JOBS."""
    return {(n, tuple(p), paged): tiny.merged(n, p, paged)
            for p, n in JOBS for paged in (True, False)}


def _matches_merged(req, ref, tol):
    """The adapter request's greedy tokens equal the merged oracle's, up
    to the oracle's length, beyond near-ties: the merge rounds W + delta
    to bf16 where serving rounds W and the delta apart, so a first
    divergence must sit where the oracle's top-1/top-2 margin is within
    twice the logit tolerance."""
    n = len(ref.out_tokens)
    diff = [i for i, (a, b) in enumerate(zip(ref.out_tokens, req.out_tokens[:n])) if a != b]
    if diff:
        top = sorted(ref.out_top_logprobs[diff[0]].values(), reverse=True)
        assert top[0] - top[1] <= 2 * tol, (diff[0], top, tol)
    return not diff


def _port_engine(setup, registry, **kw):
    kw = {"n_slots": 4, "max_len": 128, "paged": True, "page_size": 16, **kw}
    return InferenceEngine(setup.tmodel, adapters=registry, **kw)


def _run(eng, jobs, n_new=8):
    reqs = [eng.submit(p, max_new_tokens=n_new, adapter=a) for p, a in jobs]
    eng.run_until_idle()
    assert eng.page_leaks() == 0
    return reqs


def _compare(pairs, tol):
    """Finish reasons, greedy tokens (margin rule) and chosen-token
    logprobs of each (JAX, port) request pair."""
    for jr, tr in pairs:
        assert (tr.finish_reason, tr.error is None) == (jr.finish_reason, jr.error is None)
        diff = [i for i, (a, b) in enumerate(zip(jr.out_tokens, tr.out_tokens)) if a != b]
        upto = diff[0] if diff else len(jr.out_tokens)
        assert len(tr.out_tokens) == len(jr.out_tokens)
        np.testing.assert_allclose(tr.out_logprobs[:upto], jr.out_logprobs[:upto],
                                   atol=2 * tol, rtol=0)
        if diff:  # the first divergence must sit on a near-tie of JAX's
            top = sorted(jr.out_top_logprobs[upto].values(), reverse=True)
            assert top[0] - top[1] <= 2 * tol, (upto, top, tol)


# ---------------------------------------------------------------------------
# artifacts
# ---------------------------------------------------------------------------

def test_artifacts_cross_both_ways(tiny, tmp_path):
    """JAX saves -> the port loads equal leaves; the port saves -> JAX's
    load_adapter(verify="full") accepts; the same tree saved by either
    package gives the same member bytes and manifest."""
    jl = tiny.loras["t-r3"]
    got, meta = load_adapter(os.path.join(tiny.dir, "t-r3.npz"), verify="full")
    assert meta["rank"] == 3 and meta["targets"] == sorted(TARGETS)
    assert got["scale"] == pytest.approx(2.0)
    for t, pair in jl["layers"].items():
        for leaf in ("a", "b"):
            assert got["layers"][t][leaf].dtype == torch.bfloat16
            np.testing.assert_array_equal(got["layers"][t][leaf].float().numpy(),
                                          np.asarray(pair[leaf], np.float32))
    # the port saves the tree it loaded (CPU bf16 tensors)
    path = str(tmp_path / "port.npz")
    save_adapter(path, got)
    back, jmeta = jax_load_adapter(path, verify="full")
    assert jmeta["rank"] == 3 and jmeta["dtypes"] == meta["dtypes"]
    for t, pair in jl["layers"].items():
        for leaf in ("a", "b"):
            assert back["layers"][t][leaf].dtype == jnp.bfloat16
            np.testing.assert_array_equal(np.asarray(back["layers"][t][leaf], np.float32),
                                          np.asarray(pair[leaf], np.float32))
    # byte for byte: every member and the manifest
    jpath = str(tmp_path / "jax.npz")
    jax_save_adapter(jpath, jl)
    import zipfile
    with zipfile.ZipFile(path) as zp, zipfile.ZipFile(jpath) as zj:
        assert sorted(zp.namelist()) == sorted(zj.namelist())
        for n in zj.namelist():
            assert zp.read(n) == zj.read(n), n


def test_corrupt_artifact_is_structured(tiny, tmp_path):
    path = str(tmp_path / "a.npz")
    jax_save_adapter(path, tiny.loras["t-r2"])
    with open(path, "r+b") as f:  # interior bit rot
        raw = bytearray(f.read())
        raw[len(raw) // 2] ^= 0xFF
        f.seek(0)
        f.write(bytes(raw))
    with pytest.raises(IntegrityError):
        load_adapter(path, verify="fast")
    reg = AdapterRegistry(dir=str(tmp_path))
    with pytest.raises(AdapterError) as ei:
        reg.load("a")
    assert ei.value.kind == "corrupt" and reg.stats()["load_failures"] == 1
    # fault injection is ported: an armed adapter_load_corrupt fails the
    # next load the same structured way (test_torch_journal_tracing.py
    # holds it through the engine against JAX's)
    from bigdl_tpu_torch.serving.faults import FaultInjector

    jax_save_adapter(path, tiny.loras["t-r2"])
    reg = AdapterRegistry(dir=str(tmp_path),
                          faults=FaultInjector(seed=0).arm("adapter_load_corrupt"))
    with pytest.raises(AdapterError, match="injected corrupt") as ei:
        reg.load("a")
    assert ei.value.kind == "corrupt" and reg.stats()["load_failures"] == 1
    assert reg.load("a")["rank"] == 2  # one charge


def test_rank_bucket_ladder():
    assert [rank_bucket(r) for r in (1, 2, 4, 5, 8, 9, 33)] == [4, 4, 4, 8, 8, 16, 64]


def test_eviction_under_refcount(tiny, tmp_path):
    """Budget for one resident adapter: a referenced one is never evicted
    (a structured "budget" error instead); released, it is; its path is
    remembered for a counted reload; a pinned one survives; a double
    release raises at its site."""
    d = str(tmp_path)
    for name, (_, seed, _) in zip("abc", TENANTS):
        jax_save_adapter(os.path.join(d, f"{name}.npz"), _mk_lora(tiny.jcfg, seed, 2))
    one = load_adapter(os.path.join(d, "a.npz"))[0]
    from bigdl_tpu_torch.serving.adapters import lora_nbytes

    reg = AdapterRegistry(dir=d, budget_bytes=lora_nbytes(one))
    ea = reg.acquire("a")
    with pytest.raises(AdapterError) as ei:
        reg.get("b")
    assert ei.value.kind == "budget"
    reg.release(ea)
    reg.get("b")
    assert reg.stats()["evictions"] == 1 and reg.stats()["resident"] == 1
    reg.get("a")
    assert reg.stats()["loads"] == 3
    reg.load("b", pin=True)
    with pytest.raises(AdapterError):
        reg.get("c")
    eb = reg.acquire("b")
    reg.release(eb)
    with pytest.raises(AssertionError):
        reg.release(eb)


# ---------------------------------------------------------------------------
# the batched epilogue and its operands
# ---------------------------------------------------------------------------

def _batched_tree(loras, L):
    """JAX's batched per-row tree ([L, B, rb, in] / [L, B, out, rb], a [B]
    scale) of `loras` (None = a base row), as numpy f32."""
    rb = rank_bucket(max(lo["layers"]["wq"]["a"].shape[1] for lo in loras if lo))
    layers = {}
    for t in TARGETS:
        ref = next(lo for lo in loras if lo)["layers"][t]
        a = np.zeros((L, len(loras), rb, ref["a"].shape[-1]), np.float32)
        b = np.zeros((L, len(loras), ref["b"].shape[-2], rb), np.float32)
        for i, lo in enumerate(loras):
            if lo is not None:
                r = lo["layers"][t]["a"].shape[1]
                a[:, i, :r] = np.asarray(lo["layers"][t]["a"], np.float32)
                b[:, i, :, :r] = np.asarray(lo["layers"][t]["b"], np.float32)
        layers[t] = {"a": a, "b": b}
    scale = np.asarray([float(lo["scale"]) if lo else 0.0 for lo in loras], np.float32)
    return layers, scale


@pytest.mark.parametrize("which", ["tiny", "fused"])
def test_batched_epilogue_matches_per_request(which, request):
    """Rows each with their own adapter (one base row) through ONE
    forward equal separate forwards with each row's own tree: the
    zero padding to the rank bucket adds nothing. At the fused config wo
    and w_down take the batched concatenated operands."""
    setup = request.getfixturevalue(which)
    loras = [setup.loras["t-r2"], setup.loras["t-r5"], None]
    layers, scale = _batched_tree(loras, setup.tcfg.num_hidden_layers)
    tree = {"layers": {t: {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p.items()}
                       for t, p in layers.items()},
            "scale": torch.from_numpy(scale)}
    toks = torch.tensor([[3, 1, 4, 1], [2, 7, 1, 8], [9, 9, 8, 2]])
    with torch.inference_mode():
        batched, _ = llama.forward(setup.tcfg, setup.tmodel.params, toks, None, lora=tree)
        for i, lo in enumerate(loras):
            single_tree = None
            if lo is not None:
                la = {}
                _flatten(lo, "", la, {})
                single_tree = lora_from_numpy(la, setup.tcfg, device="cpu")
            single, _ = llama.forward(setup.tcfg, setup.tmodel.params, toks[i:i + 1], None,
                                      lora=single_tree)
            np.testing.assert_allclose(batched[i].float().numpy(), single[0].float().numpy(),
                                       atol=2 * setup.tol, rtol=0)


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "shared"])
def test_lora_cat_operands_match_jax(batched):
    """a_cat, b_cat and the gate built as JAX builds them (group-major
    columns, rank within; gate row m holds scale_g in its group's
    columns), and the same None past JAX's eligibility rule."""
    rng = np.random.default_rng(4)
    B, T, K, O, rb = 3, 2, 256, 128, 4
    x = rng.normal(size=(B, T, K)).astype(np.float32)
    if batched:
        a = rng.normal(size=(B, rb, K)).astype(np.float32)
        b = rng.normal(size=(B, O, rb)).astype(np.float32)
        scale = np.asarray([2.0, 0.0, 0.5], np.float32)
    else:
        a = rng.normal(size=(rb, K)).astype(np.float32)
        b = rng.normal(size=(O, rb)).astype(np.float32)
        scale = np.float32(2.0)
    ref = jax_lora_cat_operands(jnp.asarray(x), (jnp.asarray(a), jnp.asarray(b),
                                                 jnp.asarray(scale)), jnp.bfloat16)
    got = _lora_cat_operands(torch.from_numpy(x), (torch.from_numpy(a), torch.from_numpy(b),
                                                   torch.from_numpy(np.asarray(scale))),
                             torch.bfloat16)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(r, np.float32))
    assert got[2].dtype == torch.bfloat16
    # past the edge at K = 256 both refuse
    wide = next(r for r in range(1, 4096) if not kernels.lora_fused_ok(r, K))
    if batched:
        aw = np.zeros((B, -(-wide // B), K), np.float32)
        bw = np.zeros((B, O, aw.shape[1]), np.float32)
    else:
        aw, bw = np.zeros((wide, K), np.float32), np.zeros((O, wide), np.float32)
    assert jax_lora_cat_operands(jnp.asarray(x), (jnp.asarray(aw), jnp.asarray(bw),
                                                  jnp.asarray(scale)), jnp.bfloat16) is None
    assert _lora_cat_operands(torch.from_numpy(x), (torch.from_numpy(aw), torch.from_numpy(bw),
                                                    torch.from_numpy(np.asarray(scale))),
                              torch.bfloat16) is None
    if batched:  # the unfused batched epilogue: each row through its own pair
        y = lora_epilogue(torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(b),
                          torch.from_numpy(scale))
        for i in range(B):
            yi = lora_epilogue(torch.from_numpy(x[i]), torch.from_numpy(a[i]),
                               torch.from_numpy(b[i]), float(scale[i]))
            torch.testing.assert_close(y[i], yi)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_mixed_batch_matches_jax_and_merged(tiny, oracle, paged):
    """3 adapters of ranks 2/3/5 and one base request in ONE decode batch,
    on both pools: each request's greedy tokens equal the JAX engine's on
    the same trace (margin rule, logprobs) and its offline-merged
    oracle's; every reference released at the finish."""
    jreg, treg = JaxRegistry(dir=tiny.dir), AdapterRegistry(dir=tiny.dir)
    kw = dict(n_slots=4, max_len=128, paged=paged, page_size=16)
    jeng = JaxEngine(tiny.jmodel, adapters=jreg, logprobs_top_k=2, **kw)
    teng = InferenceEngine(tiny.tmodel, adapters=treg, **kw)
    jreqs = [jeng.submit(p, max_new_tokens=8, adapter=a) for p, a in JOBS]
    jeng.run_until_idle()
    treqs = _run(teng, JOBS)
    _compare(list(zip(jreqs, treqs)), tiny.tol)
    for (prompt, name), req in zip(JOBS, treqs):
        assert req.finish_reason == "length", req.error
        _matches_merged(req, oracle[(name, tuple(prompt), paged)], tiny.tol)
    assert treg.stats()["loads"] == 3 and treg.stats()["load_failures"] == 0
    assert all(e["refcount"] == 0 for e in treg.resident())
    if paged:
        assert teng._pager.page_ins == jeng._pager.page_ins > 0
        assert [list(p) for p in jeng._slot_pages] == teng._slot_pages


def test_fused_config_mixed_batch_matches_jax(fused):
    """The kernel-eligible sym_int4 config, paged: decode steps fold the
    batched adapters into the LoRA GEMV at wo and w_down (R = 4 slots x
    bucket 8), prefills into the LoRA GEMV or GEMM by their length (the
    plain versions here); tokens and logprobs against the JAX engine."""
    jobs = JOBS[:3] + [(list(range(1, 40)), "t-r5")]  # a 39-token prefill: the GEMM
    kw = dict(n_slots=4, max_len=128, paged=True, page_size=16)
    jeng = JaxEngine(fused.jmodel, adapters=JaxRegistry(dir=fused.dir), logprobs_top_k=2, **kw)
    teng = InferenceEngine(fused.tmodel, adapters=AdapterRegistry(dir=fused.dir), **kw)
    jreqs = [jeng.submit(p, max_new_tokens=8, adapter=a) for p, a in jobs]
    jeng.run_until_idle()
    calls = []
    real = kernels.qmatmul_lora

    def spy(x, *a):
        calls.append(x.reshape(-1, x.shape[-1]).shape[0])
        return real(x, *a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kernels, "qmatmul_lora", spy)
        treqs = _run(teng, jobs)
    _compare(list(zip(jreqs, treqs)), fused.tol)
    # 2 layers x (wo, w_down) per prefill with an adapter and per decode step
    assert 4 in calls and 39 in calls and min(calls) >= 1
    assert teng.page_leaks() == 0


def test_base_only_step_takes_the_plain_path(tiny):
    """Without an adapter row the decode step gets no tree (the base
    program), and a finished adapter request's row leaves the tree."""
    eng = _port_engine(tiny, AdapterRegistry(dir=tiny.dir), n_slots=2)
    eng.submit(PROMPTS[0], max_new_tokens=3)
    eng.step()
    assert eng._gather_blora() is None
    r = eng.submit(PROMPTS[1], max_new_tokens=4, adapter="t-r2")
    eng.step()
    tree = eng._gather_blora()
    assert tree is not None and tree["layers"]["wo"]["a"].shape[:3] == (
        tiny.tcfg.num_hidden_layers, 2, rank_bucket(2))
    assert tree["scale"].tolist() == [0.0, 2.0]
    eng.run_until_idle()
    assert r.done and eng._gather_blora() is None and eng.page_leaks() == 0


def test_shared_prefix_never_crosses_tenants(tiny):
    """Pages prefilled under adapter A carry its K/V: the base and tenant
    B never reuse them (each matches its merged oracle), while A's own
    repeat hits its namespace."""
    prompt = list(range(1, 36))  # 2 full pages + a tail at page_size 16
    eng = _port_engine(tiny, AdapterRegistry(dir=tiny.dir))
    first = _run(eng, [(prompt, "t-r2")])[0]
    _matches_merged(first, tiny.merged("t-r2", prompt), tiny.tol)
    assert eng.radix.n_nodes == 2
    for name in (None, "t-r3", "t-r2"):
        hits = eng.prefix_hits
        req = _run(eng, [(prompt, name)])[0]
        _matches_merged(req, tiny.merged(name, prompt), tiny.tol)
        assert eng.prefix_hits == hits + (name == "t-r2"), name


def test_parity_under_preemption(tiny, oracle):
    """A pool too small for decode growth preempts adapter requests to
    host RAM; resumed, they keep their adapter (the parked reference) and
    their merged-oracle tokens."""
    eng = _port_engine(tiny, AdapterRegistry(dir=tiny.dir), n_pages=12)
    reqs = _run(eng, JOBS, n_new=40)
    assert eng.preemptions > 0, "the scenario must preempt"
    for (prompt, name), req in zip(JOBS, reqs):
        assert req.finish_reason == "length", req.error
        _matches_merged(req, oracle[(name, tuple(prompt), True)], tiny.tol)


def test_unified_paging_shares_kv_pool(tiny, oracle):
    """Adapter weights take pages of the KV pool: paged in at admission,
    resident after the drain (warm), counted by page_leaks(); under page
    pressure holder-free adapters page out before anything is preempted,
    and the next admission pages them back in from the host copy."""
    eng = _port_engine(tiny, AdapterRegistry(dir=tiny.dir))
    reqs = _run(eng, JOBS)
    pager = eng._pager
    assert pager.page_ins >= 3 and pager.pages_resident > 0
    for (prompt, name), req in zip(JOBS, reqs):
        _matches_merged(req, oracle[(name, tuple(prompt), True)], tiny.tol)
    for pg in pager.held_pages():
        assert eng._pool.ref[pg] == 1
    grabbed = []
    pg = eng._alloc_page()
    while pg is not None:
        grabbed.append(pg)
        pg = eng._alloc_page()
    assert pager.pages_resident == 0 and pager.page_outs >= 3 and eng.preemptions == 0
    for pg in grabbed:
        eng._pool.decref(pg)
    assert eng.page_leaks() == 0
    r = _run(eng, [(PROMPTS[1], "t-r2")], n_new=8)[0]
    assert r.out_tokens == reqs[1].out_tokens  # paged back in: the same tokens
    assert pager.pages_resident > 0
    # KV growth beside a held adapter: a holder-free one pages out and
    # nothing is preempted (15 pages: t-r2 and t-r3 hold 2 + 3, t-r5 5,
    # and its 106 tokens need 7 pages of KV: t-r2, least recently used,
    # gives its 2)
    eng2 = _port_engine(tiny, AdapterRegistry(dir=tiny.dir), n_slots=2, n_pages=16)
    _run(eng2, JOBS[1:3], n_new=4)
    assert eng2._pager.pages_resident == 5
    long = _run(eng2, [(PROMPTS[3], "t-r5")], n_new=100)[0]
    assert long.finish_reason == "length" and len(long.out_tokens) == 100
    assert eng2.preemptions == 0 and eng2._pager.page_outs == 2
    _matches_merged(long, oracle[("t-r5", tuple(PROMPTS[3]), True)], tiny.tol)


def test_corrupt_adapter_fails_one_request(tiny, tmp_path):
    """A corrupt artifact fails the request naming it ("error", with the
    structured message); the rest of the batch completes; an unknown name
    and a wrong-base adapter fail the same way."""
    d = str(tmp_path)
    for name in ("good", "bad"):
        jax_save_adapter(os.path.join(d, f"{name}.npz"), tiny.loras["t-r3"])
    path = os.path.join(d, "bad.npz")
    with open(path, "r+b") as f:
        raw = bytearray(f.read())
        raw[len(raw) // 2] ^= 0xFF
        f.seek(0)
        f.write(bytes(raw))
    wrong = jax_init_lora(JAX_PRESETS["tiny-llama"], jax.random.PRNGKey(5), rank=2,
                          targets=("wq",))
    wrong["layers"]["wq"]["a"] = wrong["layers"]["wq"]["a"][:, :, :-8]
    jax_save_adapter(os.path.join(d, "wrong.npz"), wrong)
    reg = AdapterRegistry(dir=d)
    eng = _port_engine(tiny, reg)
    bad, good, base, missing, wrong_r = _run(eng, [
        (PROMPTS[0], "bad"), (PROMPTS[1], "good"), (PROMPTS[2], None),
        (PROMPTS[3], "never-saved"), (PROMPTS[0], "wrong")])
    assert bad.finish_reason == "error" and "corrupt" in bad.error and "bad" in bad.error
    assert missing.finish_reason == "error" and "missing" in missing.error
    assert wrong_r.finish_reason == "error" and "rank_mismatch" in wrong_r.error
    assert good.finish_reason == base.finish_reason == "length"
    assert reg.stats()["load_failures"] == 2  # an unknown name is no load
    assert eng.finish_reasons["error"] == 3


def test_admission_order_matches_jax_with_adapter_namespaces(tiny):
    """chip_smoke phase 12's trace shape at tiny size: 16 requests, the
    first 8 sharing a 40-token prefix and the rest independent, tenants
    assigned as phase 11's ADAPTER_OF (4 base, 3 per adapter, over the
    three test tenants), submitted at once to 4 paged slots. Cache-aware
    admission scores each queued request's radix match in its own
    adapter namespace: the port admits them in the order the JAX engine
    does."""
    rng = np.random.default_rng(12)
    V = tiny.tcfg.vocab_size
    prefix = [int(t) for t in rng.integers(1, V, 40)]
    prompts = ([prefix + [int(t) for t in rng.integers(1, V, n)] for n in (3, 9, 17, 5, 11, 20, 7, 13)]
               + [[int(t) for t in rng.integers(1, V, n)] for n in (12, 30, 8, 44, 19, 25, 6, 33)])
    tenant = {"r4": "t-r2", "r8": "t-r3", "r16": "t-r5", "r32": "t-r5", None: None}
    of = ("r8", "r8", None, "r32", "r32", None, "r32", "r4",
          None, "r16", "r16", None, "r8", "r16", "r4", "r4")
    jobs = [(p, tenant[a]) for p, a in zip(prompts, of)]
    kw = dict(n_slots=4, max_len=128, paged=True, page_size=16)
    orders = []
    for eng in (JaxEngine(tiny.jmodel, adapters=JaxRegistry(dir=tiny.dir), **kw),
                InferenceEngine(tiny.tmodel, adapters=AdapterRegistry(dir=tiny.dir), **kw)):
        order, mark = [], eng._mark_admitted

        def spy(req, mark=mark, order=order):
            if req.admit_ts is None:
                order.append(req.rid)
            return mark(req)

        eng._mark_admitted = spy
        reqs = [eng.submit(p, max_new_tokens=4, adapter=a) for p, a in jobs]
        eng.run_until_idle()
        assert all(r.finish_reason == "length" for r in reqs) and eng.page_leaks() == 0
        rid_of = {r.rid: i for i, r in enumerate(reqs)}
        orders.append([rid_of[rid] for rid in order])
    assert sorted(orders[1]) == list(range(16))
    assert orders[1] == orders[0]
    assert orders[0] != list(range(16))  # the namespaces reordered admission
