"""bigdl_tpu_torch's CUDA kernels against their plain versions, and a
small model on the card against the same model on the CPU. Every test
here needs a CUDA card and skips without one (decided inside the test).

This file imports neither jax nor bigdl_tpu, so it also runs where only
the port is installed:

    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu -q
"""

import dataclasses

import pytest
import torch

from bigdl_tpu_torch import ModelConfig, TorchModel, optimize_model
from bigdl_tpu_torch.generate import pad_prompts
from bigdl_tpu_torch.kvcache import init_cache
from bigdl_tpu_torch.models import llama
from bigdl_tpu_torch.ops import kernels
from bigdl_tpu_torch.ops.kernels.flash_attention import valid_mask
from bigdl_tpu_torch.quant import quantize

# sums in other orders, then one bf16 rounding on each side: within two
# bf16 ULPs of the largest output
_ULPS = 2 ** -7

pytestmark = pytest.mark.gpu


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("M", [1, 4, 32, 33, 300])
@pytest.mark.parametrize("O,K", [(384, 1024), (256, 320)])
def test_qmatmul_kernels_match_plain(M, O, K):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(M + O)
    w = quantize(torch.randn(O, K, device=dev, generator=g) * 0.05, "sym_int4")
    x = torch.randn(M, K, device=dev, generator=g).to(torch.bfloat16)
    kernel = kernels.GEMV if M <= kernels.GEMV_MAX_ROWS else kernels.GEMM
    before = kernel.launches
    y = kernels.qmatmul_int4(x, w.data, w.scales).float()
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ref = kernels.qmatmul_int4_plain(x, w.data, w.scales).float()
    assert (y - ref).abs().max() <= _ULPS * ref.abs().max()


@pytest.mark.parametrize("case", [
    # B, T, S, Hq, Hkv, D, q_offset, start, window, softcap
    (2, 24, 64, 4, 2, 64, 0, (0, 9), None, None),
    (3, 16, 48, 4, 1, 128, 8, (0, 5, 20), None, 20.0),
    (2, 32, 64, 2, 2, 128, 16, (3, 30), 12, None),
    (1, 70, 96, 2, 1, 256, 0, (13,), None, None),
])
def test_flash_kernel_matches_plain(case):
    dev = _cuda()
    B, T, S, Hq, Hkv, D, qoff, start, window, softcap = case
    g = torch.Generator(device=dev).manual_seed(T + S)
    q = torch.randn(B, T, Hq, D, device=dev, generator=g).to(torch.bfloat16)
    k = torch.randn(B, S, Hkv, D, device=dev, generator=g).to(torch.bfloat16)
    v = torch.randn(B, S, Hkv, D, device=dev, generator=g).to(torch.bfloat16)
    st = torch.tensor(start, dtype=torch.int32, device=dev)
    before = kernels.FLASH.launches
    got = kernels.flash_attention(q, k, v, start=st, q_offset=qoff,
                                  window=window, softcap=softcap).float()
    torch.cuda.synchronize()
    assert kernels.FLASH.launches == before + 1
    ref = kernels.flash_attention_plain(q, k, v, st, qoff, window, softcap).float()
    # per element: a row that averages many slots has small outputs, and a
    # bound scaled by the largest output would not see a dropped slot there
    assert bool(((got - ref).abs() <= _ULPS * ref.abs() + 1e-5).all())
    pad_rows = ~valid_mask(st, qoff, T, S, window).any(-1)
    assert pad_rows.any() and bool((got[pad_rows] == 0).all())


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    dev = _cuda()
    w = quantize(torch.randn(128, 256, device=dev), "sym_int4")
    with pytest.raises(TypeError):
        kernels.qmatmul_int4(torch.zeros(2, 256, device=dev), w.data, w.scales)
    q = torch.zeros(1, 4, 2, 96, dtype=torch.bfloat16, device=dev)
    with pytest.raises(NotImplementedError):
        kernels.flash_attention(q, q, q)


def test_model_on_card_matches_plain_on_cpu():
    """The kernel-eligible slice config: prefill logits on the card (all
    three kernels) against the same weights on the CPU (plain versions)."""
    dev = _cuda()
    cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=1)
    cpu = optimize_model(llama.init_params(cfg, 0, device="cpu"), cfg)
    tokens, start = pad_prompts([[5, 9, 200, 7], list(range(1, 40))], 0)

    def logits(model, d):
        cache = dataclasses.replace(
            init_cache(2, 2, 64, 1, 128, device=d),
            start=torch.as_tensor(start, device=d))
        with torch.inference_mode():
            return llama.forward(cfg, model, torch.as_tensor(tokens, device=d).long(),
                                 cache, "prefill", last_logits_only=True)[0].float().cpu()

    ref = logits(cpu, torch.device("cpu"))
    kernels.reset_launches()
    gpu = TorchModel(cfg, optimize_model(llama.init_params(cfg, 0, device="cpu"), cfg),
                     "sym_int4", device=dev).params
    got = logits(gpu, dev)
    counts = kernels.launch_counts()
    assert counts[kernels.GEMM.name] == 8 and counts[kernels.FLASH.name] == 2
    assert counts[kernels.GEMV.name] == 1  # the lm head at the last position
    # bf16 activations through two layers: 4 bf16 ULPs of the largest logit
    assert (got - ref).abs().max() <= 2 ** -6 * ref.abs().max()
