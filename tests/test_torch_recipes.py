"""The port's training recipes against the JAX package's
(bigdl_tpu/train/recipes.py, dpo.py, qlora.py): the full fine-tune's
step-1 loss and every gradient (the dense linear's dW through the dW
kernel's plain version), LISA's frozen and active layers, a ReLoRA
merge/reset cycle, the DPO loss, its aux and LoRA gradients, and the
QLoRA step under remat=True and fused_backward=False.

Parameters cross from JAX as numpy arrays (`params_from_numpy`; the full
fine-tune keeps them f32 with dtype=None, as tests/test_galore.py and
test_train_recipes.py run them). Two configurations where the kernels
matter: tiny-llama (hidden 64) and a kernel-eligible one (hidden 256,
head_dim 128: the trainable flash kernels and, over sym_int4, the fused
GEMM, LoRA epilogue and dx; their plain versions here, JAX's Pallas
kernels in interpret mode)."""

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
from bigdl_tpu.ops.linear import fused_backward_scope as jax_fused_backward_scope
from bigdl_tpu.ops.linear import linear as jax_linear
from bigdl_tpu.quant import QTensor as JaxQTensor
from bigdl_tpu.train import ReLoRASchedule as JaxReLoRASchedule
from bigdl_tpu.train import ReLoRAState as JaxReLoRAState
from bigdl_tpu.train import dpo_loss as jax_dpo_loss
from bigdl_tpu.train import init_lora as jax_init_lora
from bigdl_tpu.train import make_full_train_step as jax_make_full_train_step
from bigdl_tpu.train import make_train_step as jax_make_train_step
from bigdl_tpu.train import next_token_loss as jax_next_token_loss
from bigdl_tpu.train import relora_reset as jax_relora_reset
from bigdl_tpu_torch.convert import lora_from_numpy, params_from_numpy
from bigdl_tpu_torch.models import llama
from bigdl_tpu_torch.models.config import ModelConfig
from bigdl_tpu_torch.ops import kernels, linear
from bigdl_tpu_torch.quant import ARRAY_FIELDS
from bigdl_tpu_torch.train import (ReLoRASchedule, ReLoRAState, adamw,
                                   apply_layer_mask, dpo_loss, make_dpo_step,
                                   make_full_train_step, make_train_step,
                                   next_token_loss, relora_reset,
                                   sample_lisa_mask)

torch.set_num_threads(1)

CONFIGS = {
    "tiny-llama": JAX_PRESETS["tiny-llama"],
    "kernel-eligible": JaxConfig(vocab_size=512, hidden_size=256,
                                 intermediate_size=512, num_hidden_layers=2,
                                 num_attention_heads=2, num_key_value_heads=1),
}


def _flatten(tree, prefix, arrays, qtypes):
    """A JAX tree under convert/low_bit.py's key naming, float leaves as
    float32 (exact for bf16)."""
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


def _port_model(jparams, jcfg, dtype=torch.bfloat16):
    arrays, qtypes = {}, {}
    _flatten(jparams, "", arrays, qtypes)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    return tcfg, params_from_numpy(arrays, qtypes, tcfg, device="cpu", dtype=dtype)


def _port_lora(jlora, tcfg):
    arrays = {}
    _flatten(jlora, "", arrays, {})
    return lora_from_numpy(arrays, tcfg, device="cpu")


def _tokens(seed, vocab, B=2, T=17):
    return np.random.default_rng(seed).integers(1, vocab, (B, T)).astype(np.int32)


def _close_to(got, ref, frac, what):
    """max |got - ref| within `frac` of max |ref|."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert np.abs(ref).max() > 0, what
    assert np.abs(got - ref).max() <= frac * np.abs(ref).max(), (
        what, np.abs(got - ref).max(), np.abs(ref).max())


@pytest.fixture(scope="module", params=list(CONFIGS))
def dense(request):
    """JAX f32 parameters in init_params' unfused layout, and the port's
    model holding them in f32."""
    jcfg = CONFIGS[request.param]
    jparams = jax.jit(functools.partial(jllama.init_params, jcfg, dtype=jnp.float32))(
        jax.random.PRNGKey(0))
    tcfg, model = _port_model(jparams, jcfg, dtype=None)
    return request.param, jcfg, jparams, tcfg, model


@pytest.fixture(scope="module")
def qpair():
    """The kernel-eligible config over sym_int4 in the fused layout, and
    JAX's rank-4 adapters with B random (every adapter gets a gradient)."""
    jcfg = CONFIGS["kernel-eligible"]
    jparams = jax.jit(functools.partial(jllama.init_params, jcfg))(jax.random.PRNGKey(0))
    jparams = jax.jit(lambda p: jax_optimize_model(p, jcfg, "sym_int4"))(jparams)
    jlora = jax_init_lora(jcfg, jax.random.PRNGKey(1), rank=4)
    rng = np.random.default_rng(5)
    for t in jlora["layers"]:
        b = jlora["layers"][t]["b"]
        jlora["layers"][t]["b"] = jnp.asarray(rng.normal(size=b.shape) * 0.02, jnp.bfloat16)
    tcfg, model = _port_model(jparams, jcfg)
    return jcfg, jparams, jlora, tcfg, model


def _layer_grads(jgrads, model, tcfg):
    """[(name, port grad, JAX grad)] over every leaf, JAX's stacked layer
    leaves split per layer."""
    out = [("embed", model.embed.grad, jgrads["embed"]),
           ("final_norm", model.final_norm.grad, jgrads["final_norm"]),
           ("lm_head", model.lm_head.weight.grad, jgrads["lm_head"])]
    for i, layer in enumerate(model.layers):
        out += [(f"{i}.{n}", getattr(layer, n).grad, jgrads["layers"][n][i])
                for n in ("attn_norm", "mlp_norm")]
        out += [(f"{i}.{n}", lin.weight.grad, jgrads["layers"][n][i])
                for n, lin in layer.proj.items()]
    return out


def test_full_ft_step1_loss_and_grads_match_jax(dense, monkeypatch):
    """The full fine-tune's loss and the gradient of every leaf (embedding,
    norms, the seven projections of each layer, lm head) against JAX's
    value_and_grad over the same f32 parameters. The loss to 1e-4 of
    itself; each leaf within 5 % of its largest gradient (test_torch_
    train.py's adapter tolerance: bf16 activations through two layers and
    back, rounded at the same points and summed in other orders). The
    dense weights' dW runs through `kernels.dw_matmul` (the plain version
    on the CPU): 7 per layer and the lm head's."""
    name, jcfg, jparams, tcfg, model = dense
    monkeypatch.setenv("BIGDL_TPU_PALLAS", "interpret")
    tokens = _tokens(3, jcfg.vocab_size, T=25)
    mask = np.ones_like(tokens, np.float32)
    mask[1, :4] = 0.0
    j_loss, j_grads = jax.value_and_grad(lambda p: jax_next_token_loss(
        jcfg, jllama.forward, p, None, jnp.asarray(tokens), jnp.asarray(mask)))(jparams)

    params = llama.make_trainable(model)
    for p in params:
        p.grad = None
    calls = []
    plain = kernels.dw_matmul
    monkeypatch.setattr(kernels, "dw_matmul",
                        lambda g, x, out_dtype: calls.append(1) or plain(g, x, out_dtype))
    loss = next_token_loss(tcfg, llama.forward, model, None,
                           torch.from_numpy(tokens), torch.from_numpy(mask))
    loss.backward()
    assert len(calls) == 7 * tcfg.num_hidden_layers + 1
    assert abs(loss.item() - float(j_loss)) <= 1e-4 * abs(float(j_loss)), (name, loss.item())
    for what, got, ref in _layer_grads(j_grads, model, tcfg):
        assert got is not None and got.dtype == torch.float32, what
        _close_to(got.numpy(), ref, 0.05, (name, what))


@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
def test_dense_linear_dw_matches_jax_grad(wdtype):
    """The dense linear's weight gradient (`_DenseMatmul`: dW of the bf16
    copy through the dW kernel, cast to the weight's dtype) and dx against
    jax.vjp of JAX's `linear` over a weight of either dtype: both round
    bf16 products summed in f32 once, within two bf16 ULPs per element."""
    rng = np.random.default_rng(11)
    O, K = 96, 80
    x = rng.normal(size=(2, 24, K)).astype(np.float32)
    w = (rng.normal(size=(O, K)) * 0.05).astype(np.float32)
    g = rng.normal(size=(2, 24, O)).astype(np.float32)
    jw = jnp.asarray(w, getattr(jnp, wdtype))
    _, vjp = jax.vjp(lambda x_, w_: jax_linear(x_, w_), jnp.asarray(x), jw)
    jdx, jdw = vjp(jnp.asarray(g, jnp.bfloat16))

    tw = torch.nn.Parameter(torch.from_numpy(np.array(jw, np.float32)).to(getattr(torch, wdtype)))
    tx = torch.from_numpy(x).requires_grad_()
    before = kernels.DW.launches
    linear(tx, tw).backward(torch.from_numpy(g).to(torch.bfloat16))
    assert kernels.DW.launches == before  # CPU: the plain version
    assert tw.grad.dtype == getattr(torch, wdtype) and tw.grad.shape == (O, K)
    for got, ref in ((tw.grad, jdw), (tx.grad, jdx)):
        got, ref = got.float().numpy(), np.asarray(ref, np.float32)
        assert np.all(np.abs(got - ref) <= 2 ** -7 * np.abs(ref) + 1e-6 * np.abs(ref).max())


def test_lisa_mask_and_grad_masking():
    """test_train_recipes.py's LISA mask test: exactly n_active ones; the
    frozen layers' gradients become 0, the active ones' unchanged, and
    nothing outside the layers is touched."""
    mask = sample_lisa_mask(torch.Generator().manual_seed(0), 8, 2)
    assert mask.shape == (8,) and mask.sum().item() == 2.0
    layers = torch.nn.ModuleList(torch.nn.Linear(4, 4) for _ in range(8))
    outside = torch.nn.Parameter(torch.ones(16, 4))
    for p in list(layers.parameters()) + [outside]:
        p.grad = torch.ones_like(p)
    apply_layer_mask(layers, mask)
    for layer, m in zip(layers, mask.tolist()):
        for p in layer.parameters():
            assert torch.equal(p.grad, torch.full_like(p, m))
    assert torch.equal(outside.grad, torch.ones(16, 4))


def test_full_finetune_with_lisa_matches_jax(dense, monkeypatch):
    """test_train_recipes.py's full fine-tune with LISA, the mask handed to
    both packages (torch.Generator and jax.random draw different layers):
    one SGD step (lr 1e-2) with layer 0 active and layer 1 frozen. The
    frozen layer's weights come out bit-unchanged, every active leaf
    moved, and each leaf's update equals JAX's within 5 % of its largest
    (the gradient's tolerance above)."""
    name, jcfg, jparams, tcfg, _ = dense
    monkeypatch.setenv("BIGDL_TPU_PALLAS", "interpret")
    tokens = _tokens(4, jcfg.vocab_size)
    mask = np.ones_like(tokens, np.float32)
    lmask = np.asarray([1.0, 0.0], np.float32)
    opt = optax.sgd(1e-2)
    jstep = jax.jit(jax_make_full_train_step(jcfg, jllama.forward, opt))
    jnew, _, jloss = jstep(jparams, opt.init(jparams), jnp.asarray(tokens),
                           jnp.asarray(mask), jnp.asarray(lmask))

    _, model = _port_model(jparams, jcfg, dtype=None)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = make_full_train_step(tcfg, llama.forward,
                                torch.optim.SGD(llama.make_trainable(model), lr=1e-2))
    loss = step(model, torch.from_numpy(tokens), torch.from_numpy(mask),
                torch.from_numpy(lmask))
    assert abs(loss.item() - float(jloss)) <= 1e-4 * abs(float(jloss))
    for n, p in model.named_parameters():
        if n.startswith("layers.1."):
            assert torch.equal(p, before[n]), n  # frozen: bit-unchanged
        else:
            assert not torch.equal(p, before[n]), n
    np.testing.assert_array_equal(np.asarray(jnew["layers"]["wq"][1]),
                                  np.asarray(jparams["layers"]["wq"][1]))
    for n in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        got = (model.layers[0].proj[n].weight - before[f"layers.0.proj.{n}.weight"]).detach()
        ref = np.asarray(jnew["layers"][n][0]) - np.asarray(jparams["layers"][n][0])
        _close_to(got.numpy(), ref, 0.05, (name, n))
    got = (model.lm_head.weight - before["lm_head.weight"]).detach()
    _close_to(got.numpy(), np.asarray(jnew["lm_head"]) - np.asarray(jparams["lm_head"]),
              0.05, (name, "lm_head"))


def test_relora_cycle_matches_jax(monkeypatch):
    """A ReLoRA cycle (tiny-llama over sym_int4 in init_params' unfused
    layout, rank-4 adapters on all seven targets, a merge-and-reset every 3
    of 6 steps) in both packages, with optax.sgd(5e-2) and torch's SGD
    (test_train_recipes.py's mid-phase checkpoint setting; under Adam an
    element whose gradient sits at rounding noise moves a full lr in a
    direction the noise picks, so trajectories part after one step).
    After each reset the port's fresh A is replaced by JAX's (the two
    packages draw different random numbers), B is 0 in both and the
    optimizer starts cold. Per-step losses agree to 1e-3 of the loss (the
    step-1 tolerance); the merged bases after the last reset dequantize
    to within one code step (the block's scale) per merge of JAX's,
    element by element, two steps after the two resets: each merge
    requantizes adapters that agree to the gradients' tolerance, so a
    block's absmax scale may move by an f16 rounding and a code may round
    to its neighbour, and the next merge starts from that code."""
    monkeypatch.setenv("BIGDL_TPU_PALLAS", "interpret")
    jcfg = CONFIGS["tiny-llama"]
    jbase = jllama.quantize_params(jllama.init_params(jcfg, jax.random.PRNGKey(0)), "sym_int4")
    tokens = _tokens(6, jcfg.vocab_size)
    mask = np.ones_like(tokens, np.float32)
    optimizer = optax.sgd(5e-2)
    jstep = jax.jit(jax_make_train_step(jcfg, jllama.forward, optimizer))
    jlora = jax_init_lora(jcfg, jax.random.PRNGKey(1), rank=4)
    state = JaxReLoRAState(params=jbase, lora=jlora, opt_state=optimizer.init(jlora["layers"]))
    sched, jsched = ReLoRASchedule(reset_every=3), JaxReLoRASchedule(reset_every=3)
    want, fresh = [], {}
    for i in range(1, 7):
        state.lora, state.opt_state, loss = jstep(state.params, state.lora, state.opt_state,
                                                  jnp.asarray(tokens), jnp.asarray(mask))
        want.append(float(loss))
        if jsched.should_reset(i):
            state = jax_relora_reset(jcfg, state, optimizer, jax.random.PRNGKey(i), rank=4)
            fresh[i] = state.lora
    assert state.resets == 2

    tcfg, model = _port_model(jbase, jcfg)
    assert set(model.layers[0].proj) == {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}
    lora = _port_lora(jlora, tcfg)
    opt = torch.optim.SGD(lora.parameters(), lr=5e-2)
    step = make_train_step(tcfg, llama.forward, opt)
    tstate = ReLoRAState(model=model, lora=lora)
    got = []
    for i in range(1, 7):
        got.append(step(tstate.model, tstate.lora, torch.from_numpy(tokens),
                        torch.from_numpy(mask)).item())
        if sched.should_reset(i):
            tstate = relora_reset(tcfg, tstate, opt, seed=i, alpha=16.0)
            assert tstate.lora is lora  # the step function keeps working
            for pair in lora.layers.values():
                assert not pair["b"].any()  # fresh adapters start as the identity
            with torch.no_grad():
                for t, pair in fresh[i]["layers"].items():
                    lora.layers[t]["a"].copy_(torch.from_numpy(np.asarray(pair["a"], np.float32)))
    assert tstate.resets == 2
    np.testing.assert_allclose(got, want, rtol=1e-3)
    for n in ("wq", "w_down"):
        jw = state.params["layers"][n]
        ref = np.asarray(jw.dequantize(jnp.float32)[1])
        w = tstate.model.layers[1].proj[n].w
        assert w.qtype == "sym_int4"
        diff = np.abs(w.dequantize(torch.float32).numpy() - ref)
        step_ = np.repeat(np.maximum(np.abs(w.scales.float().numpy()),
                                     np.abs(np.asarray(jw.scales[1], np.float32))), 32, axis=-1)
        assert np.all(diff <= 2.002 * step_), n  # one code step per merge
        orig = np.asarray(jbase["layers"][n].dequantize(jnp.float32)[1])
        assert np.abs(ref - orig).max() > 0  # the merges changed the base


def test_relora_adamw_cycle_restarts_cold():
    """test_train_recipes.py's merge/reset cycle under adamw(1e-2): two
    resets in six steps, each leaving B = 0, the optimizer's state empty
    (a fresh AdamW's first step follows) and the loss finite and not
    exploding."""
    from bigdl_tpu_torch.train import init_lora

    tcfg = ModelConfig(**dataclasses.asdict(CONFIGS["tiny-llama"]))
    model = llama.quantize_params(llama.init_params(tcfg, 0, device="cpu"), "sym_int4")
    lora = init_lora(tcfg, seed=1, rank=4, device="cpu")
    opt = adamw(lora, 1e-2)
    step = make_train_step(tcfg, llama.forward, opt)
    tokens = torch.from_numpy(_tokens(7, tcfg.vocab_size)).long()
    mask = torch.ones_like(tokens, dtype=torch.float32)
    state, sched, losses = ReLoRAState(model=model, lora=lora), ReLoRASchedule(3), []
    for i in range(1, 7):
        losses.append(step(state.model, state.lora, tokens, mask).item())
        if sched.should_reset(i):
            assert opt.state  # AdamW's moments before the reset
            state = relora_reset(tcfg, state, opt, seed=i, alpha=16.0)
            assert not opt.state and all(not p["b"].any() for p in lora.layers.values())
    assert state.resets == 2
    assert np.isfinite(losses).all() and losses[-1] < losses[0] + 1.0


def test_dpo_loss_aux_and_grads_match_jax(qpair, monkeypatch):
    """DPO over the sym_int4 base with adapters whose B is random: the
    loss, every aux value and the A and B gradients against JAX's
    value_and_grad of dpo_loss (beta 0.5, label_smoothing 0.1), JAX's
    Pallas kernels in interpret mode against the plain versions. Each
    sequence log-probability is a sum of token terms, held like a loss
    (test_torch_train.py's step-1 tolerance, 1e-3 of itself); the loss
    and the margin are differences of four such sums, so their bound is
    1e-3 of the four sums' size S (times beta for the loss, whose slope
    in its logits is at most 1); the accuracy is exact. Each gradient
    leaf within 5 % of its largest (the step-1 tolerance)."""
    jcfg, jparams, jlora, tcfg, model = qpair
    monkeypatch.setenv("BIGDL_TPU_PALLAS", "interpret")
    chosen, rejected = _tokens(8, jcfg.vocab_size, T=20), _tokens(9, jcfg.vocab_size, T=20)
    cmask = np.ones_like(chosen, np.float32)
    cmask[:, :6] = 0.0  # the prompt part
    rmask = cmask.copy()
    scale = jlora["scale"]
    (jl, jaux), jg = jax.value_and_grad(
        lambda layers: jax_dpo_loss(jcfg, jllama.forward, jparams,
                                    {"layers": layers, "scale": scale},
                                    jnp.asarray(chosen), jnp.asarray(cmask),
                                    jnp.asarray(rejected), jnp.asarray(rmask),
                                    beta=0.5, label_smoothing=0.1),
        has_aux=True)(jlora["layers"])

    lora = _port_lora(jlora, tcfg)
    loss, aux = dpo_loss(tcfg, llama.forward, model, lora, torch.from_numpy(chosen),
                         torch.from_numpy(cmask), torch.from_numpy(rejected),
                         torch.from_numpy(rmask), beta=0.5, label_smoothing=0.1)
    loss.backward()
    S = 2 * (abs(float(jaux["policy_chosen_logp"])) + abs(float(jaux["policy_rejected_logp"])))
    tols = {"policy_chosen_logp": 1e-3 * abs(float(jaux["policy_chosen_logp"])),
            "policy_rejected_logp": 1e-3 * abs(float(jaux["policy_rejected_logp"])),
            "reward_margin": 1e-3 * S, "accuracy": 0.0, "loss": 0.5 * 1e-3 * S}
    for k, ref in [("loss", jl)] + sorted(jaux.items()):
        val = loss.item() if k == "loss" else aux[k].item()
        assert abs(val - float(ref)) <= tols[k], (k, val, float(ref), tols[k])
    for t, pair in jg.items():
        for ab in ("a", "b"):
            _close_to(lora.layers[t][ab].grad.float().numpy(), pair[ab], 0.05, (t, ab))


def test_dpo_reference_is_adapterless_policy(qpair):
    """Zero-init adapters (B = 0): the policy equals the reference, the
    loss is log 2 and the margin 0, as in test_train_recipes.py."""
    jcfg, _, _, tcfg, model = qpair
    from bigdl_tpu_torch.train import init_lora

    lora = init_lora(tcfg, seed=1, rank=4, device="cpu")
    toks = torch.from_numpy(_tokens(10, jcfg.vocab_size, T=10)).long()
    m = torch.ones_like(toks, dtype=torch.float32)
    with torch.no_grad():
        loss, aux = dpo_loss(tcfg, llama.forward, model, lora, toks, m,
                             torch.flip(toks, (1,)), m, beta=0.1)
    np.testing.assert_allclose(loss.item(), np.log(2.0), rtol=1e-4)
    assert aux["reward_margin"].item() == 0.0


def test_dpo_step_improves_margin(qpair):
    """test_train_recipes.py's DPO step: five steps of adamw(5e-2), beta
    0.5, widen the reward margin."""
    jcfg, _, jlora, tcfg, model = qpair
    lora = _port_lora(jlora, tcfg)
    step = make_dpo_step(tcfg, llama.forward, adamw(lora, 5e-2), beta=0.5)
    chosen = torch.from_numpy(_tokens(11, jcfg.vocab_size, T=12)).long()
    rejected = torch.from_numpy(_tokens(12, jcfg.vocab_size, T=12)).long()
    m = torch.ones_like(chosen, dtype=torch.float32)
    margins = [step(model, lora, chosen, m, rejected, m)[1]["reward_margin"].item()
               for _ in range(5)]
    assert np.isfinite(margins).all() and margins[-1] > margins[0]


def _step_grads(tcfg, model, jlora, tokens, mask, **kw):
    """One QLoRA step from the given adapters through `make_train_step`
    (SGD at lr 0, so the adapters stay put): the loss and every adapter
    leaf's gradient, which the step leaves in `.grad`."""
    lora = _port_lora(jlora, tcfg)
    step = make_train_step(tcfg, llama.forward, torch.optim.SGD(lora.parameters(), lr=0.0), **kw)
    loss = step(model, lora, torch.from_numpy(tokens), torch.from_numpy(mask))
    return loss.item(), {f"{t}.{ab}": lora.layers[t][ab].grad.float()
                         for t in lora.layers for ab in ("a", "b")}


def test_remat_matches_plain_step(qpair):
    """remat=True (each layer recomputed in the backward) changes memory,
    not math: the loss and the adapters' gradients equal the plain step's
    bit for bit on the CPU (the recomputation repeats the same
    operations)."""
    jcfg, _, jlora, tcfg, model = qpair
    tokens = _tokens(13, jcfg.vocab_size, T=25)
    mask = np.ones_like(tokens, np.float32)
    loss0, leaves0 = _step_grads(tcfg, model, jlora, tokens, mask)
    loss1, leaves1 = _step_grads(tcfg, model, jlora, tokens, mask, remat=True)
    assert loss0 == loss1
    for k in leaves0:
        assert torch.equal(leaves0[k], leaves1[k]), k


def test_fused_backward_false_matches_jax(qpair, monkeypatch):
    """fused_backward=False: every quantized projection's dx of the step
    goes through the dequantized weight in torch.matmul (the dx kernel is
    not called) — JAX's rematerialized-dequant oracle. The loss and the
    adapters' gradients against JAX's value_and_grad under its fused_backward_scope(False),
    with test_torch_train.py's step-1 tolerances (loss 1e-3, each leaf
    5 % of its largest); and against the fused step within the same."""
    jcfg, jparams, jlora, tcfg, model = qpair
    monkeypatch.setenv("BIGDL_TPU_PALLAS", "interpret")
    tokens = _tokens(14, jcfg.vocab_size, T=25)
    mask = np.ones_like(tokens, np.float32)
    scale = jlora["scale"]
    with jax_fused_backward_scope(False):
        jl, jg = jax.value_and_grad(lambda layers: jax_next_token_loss(
            jcfg, jllama.forward, jparams, {"layers": layers, "scale": scale},
            jnp.asarray(tokens), jnp.asarray(mask)))(jlora["layers"])

    fused_loss, fused = _step_grads(tcfg, model, jlora, tokens, mask)

    def no_dx_kernel(*a, **k):
        raise AssertionError("the dx kernel ran under fused_backward=False")

    monkeypatch.setattr(kernels, "qmatmul_dx", no_dx_kernel)
    loss, grads = _step_grads(tcfg, model, jlora, tokens, mask, fused_backward=False)
    assert abs(loss - float(jl)) <= 1e-3 * abs(float(jl))
    assert abs(loss - fused_loss) <= 1e-3 * abs(fused_loss)
    for t, pair in jg.items():
        for ab in ("a", "b"):
            _close_to(grads[f"{t}.{ab}"].numpy(), pair[ab], 0.05, (t, ab))
            _close_to(grads[f"{t}.{ab}"].numpy(), fused[f"{t}.{ab}"].numpy(), 0.05,
                      (t, ab, "fused"))
