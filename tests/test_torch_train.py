"""The training slice end to end: the JAX package's llama parameters and
LoRA adapters carried into bigdl_tpu_torch (`params_from_numpy`,
`lora_from_numpy`), then the QLoRA loss, the adapters' gradients and three
AdamW steps compared between the packages.

Two configurations, as in test_torch_llama.py: a small kernel-eligible one
(every projection passes O % 128 and K % 64, so the port runs its kernels'
plain versions — fused GEMM, LoRA epilogue on wo/w_down, dx, trainable
flash — and JAX, with BIGDL_TPU_PALLAS=interpret, its Pallas kernels) and
tiny-llama (hidden 64: both packages take the dequant path). 2 rows of 25
tokens give 48 rows per projection, the GEMM shape class of training."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bigdl_tpu.api import optimize_model as jax_optimize_model
from bigdl_tpu.models import llama as jllama
from bigdl_tpu.models.config import PRESETS as JAX_PRESETS
from bigdl_tpu.models.config import ModelConfig as JaxConfig
from bigdl_tpu.quant import QTensor as JaxQTensor
from bigdl_tpu.train import init_lora as jax_init_lora
from bigdl_tpu.train import make_train_step as jax_make_train_step
from bigdl_tpu.train import next_token_loss as jax_next_token_loss
from bigdl_tpu_torch.convert import lora_from_numpy, params_from_numpy
from bigdl_tpu_torch.models import llama
from bigdl_tpu_torch.models.config import ModelConfig
from bigdl_tpu_torch.ops import kernels
from bigdl_tpu_torch.quant import ARRAY_FIELDS
from bigdl_tpu_torch.train import (adamw, init_lora, make_train_step,
                                   merge_lora, next_token_loss)

torch.set_num_threads(1)

CONFIGS = {
    "kernel-eligible": JaxConfig(vocab_size=512, hidden_size=256,
                                 intermediate_size=512, num_hidden_layers=2,
                                 num_attention_heads=2, num_key_value_heads=1),
    "tiny-llama": JAX_PRESETS["tiny-llama"],
}
LR = 1e-4


def _flatten(tree, prefix, arrays, qtypes):
    """A JAX tree under convert/low_bit.py's key naming, bf16 leaves
    widened to float32 (exact)."""
    if isinstance(tree, JaxQTensor):
        qtypes[prefix] = tree.qtype
        for f in ARRAY_FIELDS:
            if getattr(tree, f) is not None:
                arrays[f"{prefix}@{f}"] = np.asarray(getattr(tree, f))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}.{k}" if prefix else k, arrays, qtypes)
    else:
        arrays[prefix] = np.asarray(tree, np.float32)


def _make_pair(name, jcfg, qtype):
    jparams = jax.jit(functools.partial(jllama.init_params, jcfg))(jax.random.PRNGKey(0))
    jparams = jax.jit(lambda p: jax_optimize_model(p, jcfg, qtype))(jparams)
    jlora = jax_init_lora(jcfg, jax.random.PRNGKey(1), rank=8)
    arrays, qtypes = {}, {}
    _flatten(jparams, "", arrays, qtypes)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    model = params_from_numpy(arrays, qtypes, tcfg, device="cpu")
    larrays = {}
    _flatten(jlora, "", larrays, {})
    rng = np.random.default_rng(2)
    tokens = rng.integers(1, jcfg.vocab_size, (2, 25)).astype(np.int32)
    mask = np.ones((2, 25), np.float32)
    mask[1, :4] = 0.0  # targets that do not count
    return name, jcfg, jparams, jlora, tcfg, model, larrays, tokens, mask


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    return _make_pair(request.param, CONFIGS[request.param], "sym_int4")


def _port_lora(tcfg, larrays):
    return lora_from_numpy(larrays, tcfg, device="cpu")


def test_lora_carries_over_exactly(pair):
    _, _, _, jlora, tcfg, _, larrays, _, _ = pair
    lora = _port_lora(tcfg, larrays)
    for t, leaf in jlora["layers"].items():
        np.testing.assert_array_equal(lora.layers[t]["a"].float().detach().numpy(),
                                      np.asarray(leaf["a"], np.float32))
        assert not lora.layers[t]["b"].any()
    assert lora.scale.item() == float(jlora["scale"]) == 2.0


def test_step1_loss_and_grads_match_jax(pair, monkeypatch):
    """Loss to 1e-3 relative; dA exactly 0 on both sides (B = 0); dB per
    leaf within 5 % of its largest element: bf16 activations cross two
    layers forward and back, and the two packages round at the same
    points but sum in different orders."""
    _assert_step1_matches_jax(pair, monkeypatch)


def test_nf4_qlora_step1_loss_and_grads_match_jax(monkeypatch):
    """QLoRA over an nf4 base (QLoRA's own format) at the kernel-eligible
    config: the fused nf4 GEMM, LoRA epilogue and dx (plain versions)
    against JAX's Pallas kernels, with step 1's tolerances."""
    _assert_step1_matches_jax(_make_pair("nf4", CONFIGS["kernel-eligible"], "nf4"),
                              monkeypatch)


def _assert_step1_matches_jax(pair, monkeypatch):
    name, jcfg, jparams, jlora, tcfg, model, larrays, tokens, mask = pair
    monkeypatch.setenv("BIGDL_TPU_PALLAS", "interpret")
    scale = jlora["scale"]
    j_loss, j_grads = jax.value_and_grad(lambda layers: jax_next_token_loss(
        jcfg, jllama.forward, jparams, {"layers": layers, "scale": scale},
        jnp.asarray(tokens), jnp.asarray(mask)))(jlora["layers"])

    lora = _port_lora(tcfg, larrays)
    kernels.reset_launches()
    loss = next_token_loss(tcfg, llama.forward, model, lora,
                           torch.from_numpy(tokens), torch.from_numpy(mask))
    loss.backward()
    assert all(n == 0 for n in kernels.launch_counts().values())  # CPU: plain
    assert abs(loss.item() - float(j_loss)) <= 1e-3 * abs(float(j_loss)), (name, loss.item(), float(j_loss))
    for t, g in j_grads.items():
        assert not np.asarray(g["a"], np.float32).any()
        assert not lora.layers[t]["a"].grad.any()
        ref = np.asarray(g["b"], np.float32)
        got = lora.layers[t]["b"].grad.float().numpy()
        assert np.abs(ref).max() > 0
        assert np.abs(got - ref).max() <= 0.05 * np.abs(ref).max(), (name, t)


def test_three_adamw_steps_match_optax(pair, monkeypatch):
    """A and B after three steps of torch AdamW (optax.adamw's defaults
    through `adamw`) against three jitted JAX steps of optax.adamw(1e-4),
    within 3 * lr: each step moves an element by about lr whatever the
    gradient's size, so a skipped or reversed step shows. Where an
    element's gradient sits within the packages' rounding noise of zero,
    its sign is a coin toss and Adam still moves it a full lr, rounded to
    a bf16 step of the parameter: up to 1 % of a leaf may then differ by
    more, but by no more than two opposite full steps (6 * lr)."""
    name, jcfg, jparams, jlora, tcfg, model, larrays, tokens, mask = pair
    monkeypatch.setenv("BIGDL_TPU_PALLAS", "0")  # XLA oracles: one fast compile
    opt = optax.adamw(LR)
    jstep = jax.jit(jax_make_train_step(jcfg, jllama.forward, opt))
    jl, state = jlora, opt.init(jlora["layers"])
    for _ in range(3):
        jl, state, _ = jstep(jparams, jl, state, jnp.asarray(tokens), jnp.asarray(mask))

    lora = _port_lora(tcfg, larrays)
    torch_opt = adamw(lora, LR)
    # optax.adamw's defaults, not torch's (weight_decay=0.01)
    assert {k: torch_opt.defaults[k] for k in ("lr", "betas", "eps", "weight_decay")} == {
        "lr": LR, "betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 1e-4}
    step = make_train_step(tcfg, llama.forward, torch_opt)
    losses = [step(model, lora, torch.from_numpy(tokens), torch.from_numpy(mask))
              for _ in range(3)]
    assert all(torch.isfinite(x) for x in losses) and losses[2] < losses[0]
    moved = 0.0
    for t, leaf in jl["layers"].items():
        for ab in ("a", "b"):
            ref = np.asarray(leaf[ab], np.float32)
            diff = np.abs(lora.layers[t][ab].detach().float().numpy() - ref)
            assert (diff > 3 * LR).mean() <= 0.01, (name, t, ab, (diff > 3 * LR).mean())
            assert diff.max() <= 6 * LR, (name, t, ab, diff.max())
        moved = max(moved, np.abs(np.asarray(leaf["b"], np.float32)).max())
    assert moved >= 2 * LR  # the adapters did train


def test_cache_free_forward_with_left_pad_matches_jax(pair, monkeypatch):
    """The cache-free forward with left padding (`start=`) and trained
    adapters against JAX's, logits within 4 bf16 ULPs of the largest (the
    tolerance of test_torch_llama.py: bf16 activations across two
    layers)."""
    name, jcfg, jparams, jlora, tcfg, model, larrays, tokens, _ = pair
    monkeypatch.setenv("BIGDL_TPU_PALLAS", "interpret")
    rng = np.random.default_rng(3)
    jl = jax.tree_util.tree_map(lambda x: x, jlora)
    for t in jl["layers"]:
        jl["layers"][t]["b"] = jnp.asarray(
            rng.normal(size=jl["layers"][t]["b"].shape) * 0.02, jnp.bfloat16)
    start = np.asarray([0, 7], np.int32)
    ref, _ = jllama.forward(jcfg, jparams, jnp.asarray(tokens), None,
                            start=jnp.asarray(start), lora=jl)
    la = {}
    _flatten(jl, "", la, {})
    with torch.no_grad():
        got, cache = llama.forward(tcfg, model, torch.from_numpy(tokens), None,
                                   start=torch.from_numpy(start),
                                   lora=lora_from_numpy(la, tcfg, device="cpu"))
    ref = np.asarray(ref)
    assert cache is None and got.shape == ref.shape
    tol = 2 ** -6 * np.abs(ref).max()
    assert np.abs(got.numpy() - ref).max() <= tol, (name, np.abs(got.numpy() - ref).max(), tol)


def test_grad_norm_is_the_global_norm(pair):
    _, _, _, _, tcfg, model, larrays, tokens, mask = pair
    lora = _port_lora(tcfg, larrays)
    step = make_train_step(tcfg, llama.forward, adamw(lora), return_grad_norm=True)
    loss, norm = step(model, lora, torch.from_numpy(tokens), torch.from_numpy(mask))
    want = torch.sqrt(sum((p.grad.float() ** 2).sum() for p in lora.parameters()))
    assert torch.isfinite(loss) and norm > 0
    torch.testing.assert_close(norm, want)


def test_train_entry_points_refuse_cache_and_unported_options(pair):
    _, _, _, _, tcfg, model, larrays, tokens, _ = pair
    lora = _port_lora(tcfg, larrays)
    opt = adamw(lora)
    for kw in ({"remat": True}, {"seq_spec": object()}, {"ring_mesh": object()},
               {"fused_backward": False}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_train_step(tcfg, llama.forward, opt, **kw)
    from bigdl_tpu_torch.kvcache import init_cache

    # LoRA with a KV cache (the serving engine's adapter prefill) is no
    # longer refused: its logits equal the cache-free forward's
    cache = init_cache(tcfg.num_hidden_layers, 2, 32, tcfg.num_key_value_heads,
                       tcfg.head_dim_, device="cpu")
    with torch.no_grad():
        cached, _ = llama.forward(tcfg, model, torch.from_numpy(tokens), cache, lora=lora)
        free, _ = llama.forward(tcfg, model, torch.from_numpy(tokens), None, lora=lora)
    torch.testing.assert_close(cached, free, rtol=0, atol=2 ** -6 * free.abs().max().item())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_lora(tcfg)


def test_merge_lora_matches_jax(pair):
    """Folding trained adapters into the base: the port's merge of the
    fused layout against JAX's merge_lora, byte for byte after
    requantization (both dequantize, add in f32 and quantize once)."""
    from bigdl_tpu.train import merge_lora as jax_merge_lora

    _, jcfg, jparams, jlora, tcfg, _, larrays, _, _ = pair
    rng = np.random.default_rng(7)
    jl = jax.tree_util.tree_map(lambda x: x, jlora)
    for t in jl["layers"]:
        b = jl["layers"][t]["b"]
        jl["layers"][t]["b"] = jnp.asarray(rng.normal(size=b.shape) * 0.02, jnp.bfloat16)
    merged_ref = jax_merge_lora(jparams, jl)
    arrays, qtypes = {}, {}
    _flatten(jparams, "", arrays, qtypes)
    model = params_from_numpy(arrays, qtypes, tcfg, device="cpu")
    la = {}
    _flatten(jl, "", la, {})
    merge_lora(model, lora_from_numpy(la, tcfg, device="cpu"))
    for name in ("wqkv", "wo", "w_gateup", "w_down"):
        ref = merged_ref["layers"][name]
        got = model.layers[1].proj[name].w
        if isinstance(ref, JaxQTensor):
            np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data[1]))
            np.testing.assert_array_equal(got.scales.numpy(), np.asarray(ref.scales[1]))
        else:
            np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref[1], np.float32))
