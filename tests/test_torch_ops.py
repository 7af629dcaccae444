"""bigdl_tpu_torch ops against the JAX package op by op (rms_norm, rope,
masked attention, KV-cache positions, prompt padding, sampling filters),
and the port's guards: no jax or bigdl_tpu import, entry points that
refuse to run without a card unless given device="cpu"."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import generate as jgen
from bigdl_tpu import kvcache as jkv
from bigdl_tpu.ops.attention import attention as jax_attention
from bigdl_tpu.ops import norms as jnorms
from bigdl_tpu.ops import rope as jrope
from bigdl_tpu_torch import generate as tgen
from bigdl_tpu_torch import kvcache as tkv
from bigdl_tpu_torch.ops import apply_rotary_emb, attention, rms_norm, rope_cos_sin
from bigdl_tpu_torch.ops.rope import make_inv_freq_scaled

ROOT = Path(__file__).resolve().parents[1]
_ULPS = 2 ** -7  # two bf16 rounding steps, relative


def _close_bf16(got, ref, floor=1e-5):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert np.all(np.abs(got - ref) <= _ULPS * np.abs(ref) + floor), \
        np.abs(got - ref).max()


def _t(a, dtype=torch.bfloat16):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 256)).astype(np.float32)
    w = (1 + 0.1 * rng.normal(size=(256,))).astype(np.float32)
    ref = jnorms.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), 1e-5)
    got = rms_norm(_t(x), _t(w), 1e-5)
    assert got.dtype == torch.bfloat16
    _close_bf16(got.float().numpy(), ref)


def test_rope_matches_jax():
    rng = np.random.default_rng(1)
    inv_j, sc_j = jrope.make_inv_freq_scaled(128, 500000.0, None)
    inv_t, sc_t = make_inv_freq_scaled(128, 500000.0, None)
    assert sc_t == sc_j == 1.0
    np.testing.assert_allclose(inv_t.numpy(), np.asarray(inv_j), rtol=1e-6)
    pos = rng.integers(0, 300, (2, 7)).astype(np.int32)
    cos_j, sin_j = jrope.rope_cos_sin(jnp.asarray(pos), inv_j)
    cos_t, sin_t = rope_cos_sin(torch.from_numpy(pos), inv_t)
    # f32 cos/sin of angles up to 300 rad: a few f32 ULPs of the angle
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=1e-4)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=1e-4)
    q = rng.normal(size=(2, 7, 4, 128))
    k = rng.normal(size=(2, 7, 2, 128))
    qj, kj = jrope.apply_rotary_emb(jnp.asarray(q, jnp.bfloat16),
                                    jnp.asarray(k, jnp.bfloat16), cos_j, sin_j)
    qt, kt = apply_rotary_emb(_t(q), _t(k), _t(np.asarray(cos_j), torch.float32),
                              _t(np.asarray(sin_j), torch.float32))
    _close_bf16(qt.float().numpy(), qj)
    _close_bf16(kt.float().numpy(), kj)


def test_rope_scaling_raises_not_implemented():
    """Llama-3.1's scheme is computed as JAX computes it (every scheme:
    test_torch_flags.py); a scheme the JAX package does not know raises."""
    rs = {"rope_type": "llama3", "factor": 8.0}
    inv_j, sc_j = jrope.make_inv_freq_scaled(128, 500000.0, rs)
    inv_t, sc_t = make_inv_freq_scaled(128, 500000.0, rs)
    assert sc_t == sc_j == 1.0
    np.testing.assert_allclose(inv_t.numpy(), np.asarray(inv_j), rtol=2e-6)
    with pytest.raises(NotImplementedError, match="rope_scaling type 'ntk-by-parts'"):
        make_inv_freq_scaled(128, 500000.0, {"rope_type": "ntk-by-parts", "factor": 8.0})


def test_masked_gqa_attention_matches_jax():
    rng = np.random.default_rng(2)
    B, T, S, Hq, Hkv, D = 2, 1, 32, 4, 2, 64
    q = rng.normal(size=(B, T, Hq, D))
    k = rng.normal(size=(B, S, Hkv, D))
    v = rng.normal(size=(B, S, Hkv, D))
    start, pos = np.array([0, 11]), 20
    sj = np.arange(S)
    mask = (sj[None, None, :] <= pos) & (sj[None, None, :] >= start[:, None, None])
    mask = mask[:, None, None]  # [B, 1, 1, T, S]
    ref = jax_attention(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                        jnp.asarray(v, jnp.bfloat16), jnp.asarray(mask))
    got = attention(_t(q), _t(k), _t(v), torch.from_numpy(mask))
    _close_bf16(got.float().numpy(), ref)


def test_rms_norm_offset_matches_jax():
    """gemma's (1 + w): formed in f32 after the weight's cast, so weights
    of 1e-3 (which 1 + w in bf16 would round away) scale the output as
    JAX's do."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 256)).astype(np.float32)
    w = (1e-3 * rng.normal(size=(256,))).astype(np.float32)
    ref = jnorms.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), 1e-6,
                          offset=True)
    got = rms_norm(_t(x), _t(w), 1e-6, offset=True)
    _close_bf16(got.float().numpy(), ref)
    plain = rms_norm(_t(x), _t(np.ones_like(w)), 1e-6)
    assert not torch.equal(got, plain)  # the small weights moved outputs


@pytest.mark.parametrize("T", [1, 6])
def test_attention_scale_and_softcap_match_jax(T):
    """gemma2's scale and softcap, capped before the mask as JAX caps: a
    cap after the mask would give masked slots weight (-1e30 -> -cap)."""
    rng = np.random.default_rng(5)
    B, S, Hq, Hkv, D = 2, 24, 4, 2, 64
    q, k, v = (rng.normal(size=s) for s in ((B, T, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    start, pos = np.array([0, 7]), 14
    sj, slots = np.arange(S), pos + np.arange(T)
    mask = ((sj[None, None, :] <= slots[None, :, None])
            & (sj[None, None, :] >= start[:, None, None])
            & (sj[None, None, :] > slots[None, :, None] - 4))[:, None, None]
    ref = jax_attention(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                        jnp.asarray(v, jnp.bfloat16), jnp.asarray(mask), scale=0.3,
                        softcap=2.0)
    got = attention(_t(q), _t(k), _t(v), torch.from_numpy(mask), scale=0.3, softcap=2.0)
    _close_bf16(got.float().numpy(), ref)
    # masked slots take no weight: v moved there changes nothing
    v2 = v.copy()
    v2[:, 0] += 100.0
    again = attention(_t(q), _t(k), _t(v2), torch.from_numpy(mask), scale=0.3, softcap=2.0)
    assert torch.equal(again, got)


def test_kvcache_positions_and_update_match_jax():
    jc = jkv.init_cache(2, 2, 16, 1, 64)
    tc = tkv.init_cache(2, 2, 16, 1, 64, device="cpu")
    start = np.array([0, 3], np.int32)
    jc = jkv.advance(jc.__class__(**{**jc.__dict__, "start": jnp.asarray(start)}), 5)
    tc = tkv.advance(tkv.KVCache(tc.k, tc.v, tc.pos, torch.from_numpy(start)), 5)
    np.testing.assert_array_equal(tc.next_positions(3).numpy(),
                                  np.asarray(jc.next_positions(3)))
    kn = np.random.default_rng(3).normal(size=(2, 3, 1, 64))
    jc = jkv.update_layer(jc, jnp.asarray(1), jnp.asarray(kn, jnp.bfloat16),
                          jnp.asarray(-kn, jnp.bfloat16))
    tkv.update_layer(tc, 1, _t(kn), _t(-kn))
    np.testing.assert_array_equal(tc.k.float().numpy(), np.asarray(jc.k, np.float32))
    np.testing.assert_array_equal(tc.v.float().numpy(), np.asarray(jc.v, np.float32))
    fp8 = tkv.init_cache(1, 1, 16, 1, 64, quantize_kv=True, device="cpu")
    jfp8 = jkv.init_cache(1, 1, 16, 1, 64, quantize_kv=True)
    assert (fp8.k.dtype, fp8.k_scale.dtype) == (torch.float8_e5m2, torch.float16)
    assert fp8.k_scale.shape == jfp8.k_scale.shape and str(jfp8.k.dtype) == "float8_e5m2"


def test_pad_prompts_matches_jax():
    prompts = [[5, 6, 7], list(range(1, 20)), [9]]
    for got, ref in zip(tgen.pad_prompts(prompts, 0), jgen.pad_prompts(prompts, 0)):
        np.testing.assert_array_equal(got, ref)


def test_sampling_stays_in_jax_filtered_support():
    """Greedy is the JAX argmax; sampled draws (temperature, top-k, then
    top-p) land only where JAX's filtered distribution is nonzero."""
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(3, 64)) * 3).astype(np.float32)
    greedy = tgen.sample_token(torch.from_numpy(logits), None, tgen.GenerationConfig())
    np.testing.assert_array_equal(greedy.numpy(), np.argmax(logits, -1))
    gen = tgen.GenerationConfig(do_sample=True, temperature=0.7, top_k=10, top_p=0.8)
    filt = np.asarray(jgen.filter_logits_per_row(
        jnp.asarray(logits), jnp.full((3,), 0.7), jnp.full((3,), 10, jnp.int32),
        jnp.full((3,), 0.8)))
    g = torch.Generator().manual_seed(0)
    for _ in range(50):
        tok = tgen.sample_token(torch.from_numpy(logits), g, gen).numpy()
        assert np.all(np.isfinite(filt[np.arange(3), tok]))


def test_port_imports_no_jax_or_reference_package():
    """AST scan: no module of the port (nor chip_smoke.py) imports jax or
    any bigdl_tpu module."""
    files = sorted((ROOT / "bigdl_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    assert {"speculative.py", "lookup.py"} <= {f.name for f in files if f.parent.name == "decode"}
    rel = {str(f.relative_to(ROOT / "bigdl_tpu_torch")) for f in files if "bigdl_tpu_torch" in f.parts}
    assert {"cli.py", "utils/common.py", "utils/errors.py", "obs/profiler.py",
            "serving/api_server.py", "serving/fastchat_worker.py"} <= rel
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "bigdl_tpu", "flax", "optax"):
                    bad.append(f"{f.relative_to(ROOT)}: {n}")
    assert not bad, bad


def test_cpu_generate_in_fresh_process_loads_no_jax():
    code = (
        "import sys\n"
        "from bigdl_tpu_torch import ModelConfig, TorchModel, optimize_model\n"
        "from bigdl_tpu_torch.models import llama\n"
        "cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512,"
        " num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1)\n"
        "m = optimize_model(llama.init_params(cfg, 0, device='cpu'), cfg)\n"
        "out = TorchModel(cfg, m, 'sym_int4', device='cpu').generate([[1, 2, 3]], 4)\n"
        "assert out.shape == (1, 4)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'bigdl_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-2000:]


def test_training_modules_load_no_jax_in_fresh_process():
    """The full fine-tune's modules (the dW kernel's wrapper, GaLore, the
    recipes, DPO, the checkpoint and the watchdog) import and run a GaLore
    step of a small model on the CPU without loading jax or bigdl_tpu."""
    code = (
        "import sys, torch\n"
        "from bigdl_tpu_torch import PRESETS\n"
        "from bigdl_tpu_torch.models import llama\n"
        "from bigdl_tpu_torch.ops.kernels import dw_matmul\n"
        "from bigdl_tpu_torch.train import GaLore, make_full_train_step, make_dpo_step\n"
        "from bigdl_tpu_torch.train import checkpoint, watchdog\n"
        "cfg = PRESETS['tiny-llama']\n"
        "m = llama.init_params(cfg, 0, device='cpu')\n"
        "step = make_full_train_step(cfg, llama.forward, GaLore(llama.make_trainable(m), 1e-3, rank=8))\n"
        "loss = step(m, torch.ones((1, 9), dtype=torch.long), torch.ones((1, 9)))\n"
        "assert torch.isfinite(loss)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'bigdl_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-2000:]


def test_decode_modules_load_no_jax_in_fresh_process():
    """The decode algorithms (decode/speculative.py, decode/lookup.py) and
    the speculative engine import and run a few tokens of a small model
    on the CPU without loading jax or bigdl_tpu."""
    code = (
        "import sys\n"
        "from bigdl_tpu_torch import PRESETS, TorchModel, optimize_model\n"
        "from bigdl_tpu_torch.models import llama\n"
        "from bigdl_tpu_torch.serving import InferenceEngine\n"
        "cfg = PRESETS['tiny-llama']\n"
        "tm = TorchModel(cfg, optimize_model(llama.init_params(cfg, 0, device='cpu'), cfg, 'bf16'),"
        " 'bf16', device='cpu')\n"
        "assert tm.generate_speculative([[1, 2, 3]], max_new_tokens=6).shape == (1, 6)\n"
        "assert tm.generate_lookup([[1, 2, 1, 2, 1]], max_new_tokens=6).shape == (1, 6)\n"
        "eng = InferenceEngine(tm, n_slots=1, max_len=64, speculative=True)\n"
        "r = eng.submit([1, 2, 3], max_new_tokens=5)\n"
        "eng.run_until_idle()\n"
        "assert len(r.out_tokens) == 5\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'bigdl_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-2000:]


def test_http_layer_loads_no_jax_in_fresh_process():
    """The HTTP layer (the server, the FastChat worker, the command line,
    the profiler window and the error helpers) imports and serves one
    request of a small model on the CPU without loading jax or
    bigdl_tpu."""
    code = (
        "import json, sys, urllib.request\n"
        "from bigdl_tpu_torch import PRESETS, TorchModel, optimize_model, cli\n"
        "from bigdl_tpu_torch.models import llama\n"
        "from bigdl_tpu_torch.obs import PROFILER, ProfilerWindow\n"
        "from bigdl_tpu_torch.serving import FastChatWorker\n"
        "from bigdl_tpu_torch.serving.api_server import ApiServer\n"
        "from bigdl_tpu_torch.utils import common, errors\n"
        "cfg = PRESETS['tiny-llama']\n"
        "tm = TorchModel(cfg, optimize_model(llama.init_params(cfg, 0, device='cpu'), cfg), "
        "'sym_int4', device='cpu')\n"
        "srv = ApiServer(tm, port=0, n_slots=1, max_len=64).start()\n"
        "req = urllib.request.Request(f'http://127.0.0.1:{srv.port}/generate', "
        "data=json.dumps({'prompt': [1, 2, 3], 'max_new_tokens': 3}).encode())\n"
        "assert len(json.loads(urllib.request.urlopen(req, timeout=60).read())['tokens']) == 3\n"
        "assert srv.shutdown(graceful=True)\n"
        "cli.build_parser()\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'bigdl_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-2000:]


def test_entry_points_refuse_to_run_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    from bigdl_tpu_torch import PRESETS, TorchModel
    from bigdl_tpu_torch.models import llama
    from bigdl_tpu_torch.utils import resolve_device

    cfg = PRESETS["tiny-llama"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llama.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tkv.init_cache(cfg.num_hidden_layers, 2, 16, cfg.num_key_value_heads,
                       cfg.head_dim_)
    model = llama.init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchModel(cfg, model, "sym_int4")
    assert TorchModel(cfg, model, "sym_int4", device="cpu").device.type == "cpu"
    assert tkv.init_cache(1, 2, 16, 1, 64, device="cpu").k.device.type == "cpu"


def test_forward_and_carry_take_only_the_fused_layout():
    """forward runs the fused layout (wqkv/w_gateup, what optimize_model
    makes) and, as JAX's forward does, the unfused one of init_params
    (wq/wk/wv, w_gate/w_up), which the full fine-tune trains: the same
    dense weights give the same logits in both, within two bf16 ULPs of
    the largest (the concatenated matmul may sum in another order). The
    carry takes either layout and refuses leaves that mix them."""
    from bigdl_tpu_torch import PRESETS
    from bigdl_tpu_torch.convert import params_from_numpy
    from bigdl_tpu_torch.models import llama

    cfg = PRESETS["tiny-llama"]
    dense = llama.init_params(cfg, 0, device="cpu")
    assert set(dense.layers[0].proj) == {"wq", "wk", "wv", "wo", "w_gate",
                                         "w_up", "w_down"}
    tokens = torch.ones((1, 4), dtype=torch.long)

    def run(model):
        cache = tkv.init_cache(cfg.num_hidden_layers, 1, 16, cfg.num_key_value_heads,
                               cfg.head_dim_, device="cpu")
        with torch.no_grad():
            return llama.forward(cfg, model, tokens, cache)

    unfused, cache = run(dense)
    assert unfused.shape == (1, 4, cfg.vocab_size) and cache.pos == 4
    fused_model = llama.merge_fused_params(dense, cfg)
    assert set(fused_model.layers[0].proj) == {"wqkv", "wo", "w_gateup", "w_down"}
    fused, cache = run(fused_model)
    assert cache.pos == 4
    _close_bf16(unfused.numpy(), fused.numpy(), floor=2 ** -7 * fused.abs().max().item())
    L, H = cfg.num_hidden_layers, cfg.hidden_size
    with pytest.raises(ValueError, match="unmerged"):
        params_from_numpy({"layers.wq": np.zeros((L, H, H), np.float32)}, {},
                          cfg, device="cpu")
