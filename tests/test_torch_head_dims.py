"""Head dims on the card's attention wrappers: every preset the port
admits runs its head_dim and GQA group through each of the flash
prefill, paged decode and training flash wrappers that the dispatch rule
sends its paths to (their card-side checks, run here on CPU tensors), an
unported head_dim names its ROADMAP item, and the flash
wrappers' zero-padding of D (phi3-mini's 96 run at 128) gives the
unpadded function. D = 96 against the JAX package's Pallas kernels in
interpret mode is a case of test_torch_flash.py and
test_torch_flash_backward.py."""

import importlib
import math

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import PRESETS
from bigdl_tpu_torch.models import llama
from bigdl_tpu_torch.models.llama import check_supported

# the wrapper modules (the package's names are their entry functions)
fa, fb, pa = (importlib.import_module(f"bigdl_tpu_torch.ops.kernels.{m}")
              for m in ("flash_attention", "flash_backward", "paged_attention"))

torch.set_num_threads(1)


def admitted_presets() -> dict:
    out = {}
    for name, cfg in PRESETS.items():
        try:
            check_supported(cfg)
        except NotImplementedError:
            continue
        out[name] = cfg
    return out


# tiny-llama (D = 16) is a CPU fixture: the paged kernel has no D = 16
# instantiation and raises for it, naming its ROADMAP item
PAGED_EXCEPTIONS = {"tiny-llama"}


def _bf16(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape)).to(torch.bfloat16)


def test_every_admitted_preset_is_covered():
    assert {"tiny-llama", "llama3-8b", "phi3-mini", "mistral-7b", "qwen2-7b",
            "gemma2-9b"} <= set(admitted_presets())


def reached_kernels(cfg) -> set:
    """The attention kernels the preset's paths reach, by the dispatch
    rule (`llama.attention_route`) over every layer: generate's prefill,
    the paged engine's decode, the cache-free training step."""
    calls = [("dense", "prefill", 64, False), ("paged", "decode", 1, True),
             ("none", "prefill", 64, False)]
    return {llama.attention_route(cfg, layer, *call).kernel
            for call in calls for layer in range(cfg.num_hidden_layers)} - {"plain"}


@pytest.mark.parametrize("name", sorted(admitted_presets()))
def test_admitted_presets_head_dim_and_group_are_taken_by_the_card_wrappers(name):
    """The checks each wrapper runs before a launch, on the preset's head
    dim and group, for each kernel the dispatch sends the preset's paths
    to: the flash prefill and the training flash take them (padding D
    where the kernels were not built for it), the paged decode takes them
    except for tiny-llama's D = 16. gemma2-9b's alternating windows and
    softcap keep its prefill and training on the plain attention (JAX's
    rule), so its D = 256 meets the paged kernel alone."""
    cfg = admitted_presets()[name]
    reached = reached_kernels(cfg)
    assert reached == ({"paged"} if name == "gemma2-9b" else {"flash", "paged", "flash_train"})
    D, Hq, Hkv = cfg.head_dim_, cfg.num_attention_heads, cfg.num_key_value_heads
    B, T, S = 1, 2, 4
    q, kv = _bf16(B, T, Hq, D), _bf16(B, S, Hkv, D, seed=1)
    start = torch.zeros(B, dtype=torch.int32)
    if "flash" in reached:
        fa._check(q, kv, kv, start)
        assert fa.kernel_head_dim(D) in fa._HEAD_DIMS and fa.kernel_head_dim(D) >= D
    if "flash_train" in reached:
        fb._check(q, kv, kv, start)
        lse = torch.zeros(B, T, Hq)
        fb._check(q, kv, kv, start, q, lse, lse)
    pool = _bf16(1, 2, 4, Hkv, D, seed=2)
    i32 = dict(dtype=torch.int32)
    args = (_bf16(B, Hq, D), pool, pool, torch.zeros(B, 2, **i32), torch.zeros(B, **i32),
            torch.zeros(B, **i32), None, None)
    if name in PAGED_EXCEPTIONS:
        with pytest.raises(NotImplementedError, match="ROADMAP queue 2 item 1"):
            pa._check(*args)
    else:
        pa._check(*args)


@pytest.mark.parametrize("D", [40, 48, 272])
def test_an_unported_head_dim_names_its_roadmap_item(D):
    """A head_dim no kernel takes (40: not a multiple of 16; 48: no paged
    instantiation; 272: wider than every kernel) raises NotImplementedError
    citing ROADMAP queue 2 item 1 in each wrapper that does not take it."""
    q, kv = _bf16(1, 2, 2, D), _bf16(1, 4, 2, D)
    start = torch.zeros(1, dtype=torch.int32)
    wrappers = [lambda: pa._check(_bf16(1, 2, D), _bf16(1, 2, 4, 2, D), _bf16(1, 2, 4, 2, D),
                                  torch.zeros(1, 2, dtype=torch.int32),
                                  torch.zeros(1, dtype=torch.int32),
                                  torch.zeros(1, dtype=torch.int32), None, None)]
    if D % 16 or D > 256:
        wrappers.append(lambda: fa._check(q, kv, kv, start))
    if D % 16 or D > 128:
        wrappers.append(lambda: fb._check(q, kv, kv, start))
    for call in wrappers:
        with pytest.raises(NotImplementedError, match="ROADMAP queue 2 item 1"):
            call()


@pytest.mark.parametrize("D,Dk", [(16, 64), (96, 128), (64, 64), (160, 256)])
def test_prefill_padding_of_d_gives_the_unpadded_function(D, Dk):
    """The wrapper's padding: q, k, v zero-padded to the kernel's width,
    the true D's scale, the output sliced back, equals the function at D
    (the plain version on both sides; bf16 and the fp8 cache's codes)."""
    from bigdl_tpu_torch.kvcache import _quantize_heads

    assert fa.kernel_head_dim(D) == Dk
    B, T, S, Hq, Hkv = 2, 9, 20, 4, 2
    q, k, v = _bf16(B, T, Hq, D), _bf16(B, S, Hkv, D, seed=1), _bf16(B, S, Hkv, D, seed=2)
    start = torch.tensor([0, 5], dtype=torch.int32)
    scale = 1.0 / math.sqrt(D)
    ref = fa.flash_attention_plain(q, k, v, start, 4, 12, 30.0, scale)
    pad = [fa.pad_head_dim(t, Dk) for t in (q, k, v)]
    got = fa.flash_attention_plain(*pad, start, 4, 12, 30.0, scale)[..., :D]
    assert torch.equal(got, ref)
    (k8, ks), (v8, vs) = (_quantize_heads(t.float() * 3) for t in (k, v))
    ref8 = fa.flash_attention_plain(q, k8, v8, start, 0, None, None, scale, ks, vs)
    got8 = fa.flash_attention_plain(pad[0], fa.pad_head_dim(k8, Dk), fa.pad_head_dim(v8, Dk),
                                    start, 0, None, None, scale, ks, vs)[..., :D]
    assert torch.equal(got8, ref8)


def test_training_padding_of_d_gives_the_unpadded_gradients():
    """FlashAttentionTrain's padding at phi3-mini's D = 96 (run at 128):
    the forward's output and lse and every gradient of the padded
    function, sliced back, equal the unpadded function's (plain versions;
    the padded columns of dq, dk and dv are exactly 0)."""
    D, Dk = 96, fb.kernel_head_dim(96, fb._HEAD_DIMS)
    assert Dk == 128
    B, T, Hq, Hkv = 2, 21, 4, 2
    q, k, v, do = (_bf16(B, T, h, D, seed=s) for s, h in enumerate((Hq, Hkv, Hkv, Hq)))
    start = torch.tensor([0, 6], dtype=torch.int32)
    scale = 1.0 / math.sqrt(D)
    out, lse = fb.flash_attention_train_plain(q, k, v, start, 8, scale)
    qp, kp, vp, dop = (fa.pad_head_dim(t, Dk) for t in (q, k, v, do))
    outp, lsep = fb.flash_attention_train_plain(qp, kp, vp, start, 8, scale)
    assert torch.equal(outp[..., :D], out) and torch.equal(lsep, lse)
    assert bool((outp[..., D:] == 0).all())
    delta = (do.float() * out.float()).sum(-1)
    deltap = (dop.float() * outp.float()).sum(-1)
    assert torch.equal(delta, deltap)
    ref = fb.flash_attention_train_bwd_plain(q, k, v, start, do, lse, delta, 8, scale)
    got = fb.flash_attention_train_bwd_plain(qp, kp, vp, start, dop, lsep, deltap, 8, scale)
    for g, r in zip(got, ref):
        assert torch.equal(g[..., :D], r) and bool((g[..., D:] == 0).all())
