"""bigdl_tpu_torch's CUDA kernels against their plain versions, and a
small model on the card against the same model on the CPU. Every test
here needs a CUDA card and skips without one (decided inside the test).

This file imports neither jax nor bigdl_tpu, so it also runs where only
the port is installed:

    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu -q
"""

import dataclasses
from unittest import mock

import pytest
import torch

from bigdl_tpu_torch import PRESETS, ModelConfig, TorchModel, optimize_model
from bigdl_tpu_torch.generate import pad_prompts
from bigdl_tpu_torch.kvcache import FP8, init_cache
from bigdl_tpu_torch.models import llama
from bigdl_tpu_torch.ops import kernels
from bigdl_tpu_torch.ops.kernels.flash_attention import valid_mask
from bigdl_tpu_torch.quant import quantize
from bigdl_tpu_torch.train import adamw, init_lora, make_train_step, next_token_loss

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
    y = kernels.qmatmul(x, w).float()
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ref = kernels.qmatmul_plain(x, w).float()
    assert (y - ref).abs().max() <= _ULPS * ref.abs().max()


OTHER_FORMATS = ["asym_int4", "nf4", "fp4", "sym_int8", "asym_int5", "fp8_e4m3",
                 "fp8_e5m2", "sym_int5", "fp6", "nf3", "q2_k", "q3_k", "q4_k",
                 "q5_k", "q6_k"]


@pytest.mark.parametrize("O", [384, 200])
@pytest.mark.parametrize("qtype", OTHER_FORMATS)
def test_format_kernels_match_plain(qtype, O):
    """Every form of every other format against its plain version: the
    GEMV at 1, 5 and 32 rows, the GEMM at 33 and 200, the LoRA GEMM at 40
    (R = 8) and dx at 33, at K = 2048 (every format's k_multiple divides
    it); O = 200 leaves a ragged last tile. The encoder ran on the card:
    its bytes equal the CPU's."""
    dev = _cuda()
    K = 2048
    g = torch.Generator(device=dev).manual_seed(len(qtype) + O)
    dense = torch.randn(O, K, device=dev, generator=g) * 0.02
    w = quantize(dense, qtype)
    cpu = quantize(dense.cpu(), qtype)
    for f, t in w.fields().items():
        assert torch.equal(t.cpu().view(torch.uint8), cpu.fields()[f].view(torch.uint8)), f

    def rnd(*shape):
        return torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)

    def check(kernel, got, ref, before):
        torch.cuda.synchronize()
        assert kernel.launches == before + 1 and kernel.by_format[qtype] >= 1
        assert bool(torch.isfinite(got).all()) and got.shape == ref.shape
        assert _max_err(got, ref) <= _ULPS * ref.float().abs().max().item()

    for M in (1, 5, 32, 33, 200):
        x = rnd(M, K)
        kernel = kernels.GEMV if M <= kernels.GEMV_MAX_ROWS else kernels.GEMM
        before = kernel.launches
        check(kernel, kernels.qmatmul(x, w), kernels.qmatmul_plain(x, w), before)
    x, R = rnd(40, K), 8
    a, b = rnd(R, K) / R, rnd(O, R) * 0.1
    gate = torch.full((40, R), 2.0, dtype=torch.bfloat16, device=dev)
    before = kernels.LORA_GEMM.launches
    check(kernels.LORA_GEMM, kernels.qmatmul_lora(x, w, a, b, gate),
          kernels.qmatmul_lora_plain(x, w, a, b, gate), before)
    gr = rnd(33, O)
    before = kernels.DX.launches
    check(kernels.DX, kernels.qmatmul_dx(gr, w), kernels.qmatmul_dx_plain(gr, w), before)


@pytest.mark.parametrize("case", [
    # B, T, S, Hq, Hkv, D, q_offset, start, window, softcap
    (2, 24, 64, 4, 2, 64, 0, (0, 9), None, None),
    (3, 16, 48, 4, 1, 128, 8, (0, 5, 20), None, 20.0),
    (2, 32, 64, 2, 2, 128, 16, (3, 30), 12, None),
    (1, 70, 96, 2, 1, 256, 0, (13,), None, None),
    (2, 17, 64, 4, 2, 128, 0, (0, 9), None, None),  # one query tile, mostly past T
    (2, 30, 96, 4, 1, 128, 20, (0, 35), None, 30.0),
    # q_offset > 0, the window's edge inside key tile 0 for the first rows
    (2, 40, 192, 4, 2, 128, 100, (0, 110), 50, None),
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


def paged_inputs(dev, B, Hq, Hkv, D, page, mp, pos, start, L=2, fp8=False, seed=0):
    """A random pool, a block table of distinct shuffled pages per row
    (row b holds pos[b] // page + 1 pages; the rest, and an idle row with
    pos 0, point at the scratch page 0), and the per-row pos/start."""
    from bigdl_tpu_torch.kvcache import _quantize_heads

    g = torch.Generator(device=dev).manual_seed(seed)
    need = [p // page + 1 for p in pos]
    NP = sum(need) + 1
    perm = torch.randperm(NP - 1, device=dev, generator=g) + 1
    bt = torch.zeros((B, mp), dtype=torch.int32, device=dev)
    used = 0
    for b, n in enumerate(need):
        if pos[b] > 0:
            bt[b, :n] = perm[used:used + n]
            used += n
    shape = (L, NP, page, Hkv, D)
    k = torch.randn(shape, device=dev, generator=g)
    v = torch.randn(shape, device=dev, generator=g)
    if fp8:
        (k, ks), (v, vs) = _quantize_heads(k, torch.float32), _quantize_heads(v, torch.float32)
    else:
        k, v, ks, vs = k.bfloat16(), v.bfloat16(), None, None
    q = torch.randn((B, Hq, D), device=dev, generator=g).bfloat16()
    i32 = dict(dtype=torch.int32, device=dev)
    return q, k, v, bt, torch.tensor(pos, **i32), torch.tensor(start, **i32), ks, vs


PAGED_CASES = [
    # B, Hq, Hkv, D, page, max_pages, pos, start, window, softcap
    (3, 6, 2, 64, 8, 4, (17, 9, 30), (2, 0, 5), None, None),
    (3, 8, 2, 128, 16, 4, (50, 0, 60), (0, 0, 35), 20, 30.0),
    # llama3-8b at the serving engine's decode shape: 8 rows, page 64,
    # ragged positions up to 2047, row 3 idle
    (8, 32, 8, 128, 64, 32, (2047, 1100, 64, 0, 1500, 5, 700, 1999),
     (0,) * 8, None, None),
]


@pytest.mark.parametrize("fp8", [False, True], ids=["bf16", "fp8"])
@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_kernel_matches_plain(case, fp8):
    dev = _cuda()
    B, Hq, Hkv, D, page, mp, pos, start, window, softcap = case
    q, k, v, bt, p, st, ks, vs = paged_inputs(dev, B, Hq, Hkv, D, page, mp, pos,
                                              start, fp8=fp8, seed=B + D)
    kern = kernels.PAGED_FP8 if fp8 else kernels.PAGED
    for layer in (0, 1):
        before = kern.launches
        got = kernels.paged_attention(q, k, v, bt, layer, p, st, ks, vs,
                                      softcap=softcap, window=window).float()
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        ref = kernels.paged_attention_plain(q, k, v, bt, layer, p, st, ks, vs,
                                            softcap=softcap, window=window).float()
        assert bool(torch.isfinite(got).all())
        assert bool(((got - ref).abs() <= _ULPS * ref.abs() + 1e-5).all()), \
            (got - ref).abs().max().item()


# the edges of the kernel's split over slots: at 8 rows of 2048 slots it
# cuts chunks of 256 (on page boundaries), at 2 rows of 22 pages of 96
# chunks of 64 (inside pages)
PAGED_SPLIT_CASES = [
    # B, Hq, Hkv, D, page, max_pages, pos, start, window, softcap
    (8, 32, 8, 128, 64, 32, (255, 256, 511, 512, 767, 1023, 1024, 300),
     (0, 0, 0, 0, 0, 0, 1, 256), None, None),
    (2, 32, 8, 128, 96, 22, (2111, 700), (0, 64), None, None),
    (8, 32, 8, 128, 64, 32, (2047, 1999, 1300, 900, 520, 256, 255, 64), (0,) * 8, 300, 30.0),
    # one-slot rows, and rows 1 and 7 without a valid slot
    (8, 32, 8, 128, 64, 32, (700, 5, 1000, 64, 0, 2047, 300, 1),
     (700, 6, 0, 64, 0, 2047, 0, 2), None, None),
    (3, 8, 2, 64, 16, 8, (127, 64, 40), (0, 63, 41), 70, None),
]


@pytest.mark.parametrize("fp8", [False, True], ids=["bf16", "fp8"])
@pytest.mark.parametrize("case", PAGED_SPLIT_CASES)
def test_paged_split_edges_match_plain_and_relaunch_bit_equal(case, fp8):
    """One launch a call; within one bf16 step of the plain version per
    element; rows without a valid slot exactly 0; a second launch gives the
    same bits (partials merged in chunk order by the last block)."""
    dev = _cuda()
    B, Hq, Hkv, D, page, mp, pos, start, window, softcap = case
    q, k, v, bt, p, st, ks, vs = paged_inputs(dev, B, Hq, Hkv, D, page, mp, pos,
                                              start, fp8=fp8, seed=sum(pos))
    kern = kernels.PAGED_FP8 if fp8 else kernels.PAGED
    before = kern.launches
    got = kernels.paged_attention(q, k, v, bt, 1, p, st, ks, vs, softcap=softcap, window=window)
    again = kernels.paged_attention(q, k, v, bt, 1, p, st, ks, vs, softcap=softcap, window=window)
    torch.cuda.synchronize()
    assert kern.launches == before + 2 and torch.equal(got, again)
    ref = kernels.paged_attention_plain(q, k, v, bt, 1, p, st, ks, vs, softcap=softcap,
                                        window=window).float()
    got = got.float()
    assert bool(torch.isfinite(got).all())
    assert bool(((got - ref).abs() <= _ULPS * ref.abs() + 1e-5).all()), (got - ref).abs().max().item()
    empty = [b for b in range(B) if start[b] > min(pos[b], mp * page - 1)]
    assert all(bool((got[b] == 0).all()) for b in empty)


@pytest.mark.parametrize("case", [
    # B, T, S, Hq, Hkv, D, q_offset, start, window, softcap
    (2, 24, 64, 4, 2, 64, 0, (0, 9), None, None),
    (2, 32, 64, 2, 2, 128, 16, (3, 30), 12, 20.0),
    (1, 1024, 1024, 32, 8, 128, 0, (0,), None, None),  # the dense fp8 prefill
    (2, 17, 64, 4, 2, 128, 0, (0, 9), None, None),
    (2, 30, 96, 4, 1, 128, 20, (0, 35), None, 30.0),
    (2, 40, 192, 4, 2, 128, 100, (0, 110), 50, None),
    (2, 70, 96, 4, 1, 256, 0, (0, 37), None, None),
    # K/V of absmax < 1: every scale (absmax / 57344) is an f16 subnormal
    (2, 48, 96, 4, 2, 128, 8, (0, 20), None, None, 0.2),
])
def test_flash_fp8_kernel_matches_plain(case):
    from bigdl_tpu_torch.kvcache import _quantize_heads

    dev = _cuda()
    B, T, S, Hq, Hkv, D, qoff, start, window, softcap, *amp = case
    amp = amp[0] if amp else 1.0
    g = torch.Generator(device=dev).manual_seed(T + S)
    q = torch.randn(B, T, Hq, D, device=dev, generator=g).to(torch.bfloat16)
    k, ks = _quantize_heads(torch.randn(B, S, Hkv, D, device=dev, generator=g) * 3 * amp)
    v, vs = _quantize_heads(torch.randn(B, S, Hkv, D, device=dev, generator=g) * amp)
    if amp < 1:
        assert bool((ks < 2 ** -14).all() and (vs < 2 ** -14).all())
    st = torch.tensor(start, dtype=torch.int32, device=dev)
    before = kernels.FLASH_FP8.launches
    got = kernels.flash_attention(q, k, v, start=st, q_offset=qoff, window=window,
                                  softcap=softcap, k_scale=ks, v_scale=vs).float()
    torch.cuda.synchronize()
    assert kernels.FLASH_FP8.launches == before + 1
    ref = kernels.flash_attention_plain(q, k, v, st, qoff, window, softcap,
                                        k_scale=ks, v_scale=vs).float()
    assert bool(((got - ref).abs() <= _ULPS * ref.abs() + 1e-5).all())
    pad_rows = ~valid_mask(st, qoff, T, S, window).any(-1)
    assert bool((got[pad_rows] == 0).all())


@pytest.mark.parametrize("paged,quantize_kv", [(True, False), (True, True),
                                               (False, True)])
def test_engine_two_layers_full_width_kernels_vs_plain(paged, quantize_kv):
    """Two llama3-8b layers at full width through the serving engine on
    the card: a shared prefix (a radix hit), the paged kernel at every
    paged decode step, the flash fp8 arm at every dense fp8 prefill, page
    accounting balanced after the drain, and the chosen-token logprobs of
    the same run with every kernel patched to its plain version."""
    from bigdl_tpu_torch.serving import InferenceEngine

    dev = _cuda()
    cfg = dataclasses.replace(PRESETS["llama3-8b"], num_hidden_layers=2)
    tm = TorchModel(cfg, optimize_model(llama.init_params(cfg, seed=5), cfg), "sym_int4")
    g = torch.Generator().manual_seed(6)
    prefix = torch.randint(1, cfg.vocab_size, (128,), generator=g).tolist()
    prompts = [prefix + torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()
               for n in (5, 40)] + [torch.randint(1, cfg.vocab_size, (300,),
                                                  generator=g).tolist()]

    def run():
        eng = InferenceEngine(tm, n_slots=4, max_len=512, paged=paged, page_size=64,
                              quantize_kv=quantize_kv)
        reqs = [eng.submit(prompts[0], max_new_tokens=8)]
        eng.step()  # the prefix's pages are registered before the others come
        reqs += [eng.submit(p, max_new_tokens=8) for p in prompts[1:]]
        eng.run_until_idle()
        assert eng.page_leaks() == 0
        assert all(r.finish_reason == "length" for r in reqs)
        return eng, [(r.out_tokens, r.out_logprobs) for r in reqs]

    kernels.reset_launches()
    eng, outs = run()
    counts = kernels.launch_counts()
    if paged:
        assert eng.prefix_hits == 1
        name = (kernels.PAGED_FP8 if quantize_kv else kernels.PAGED).name
        assert counts[name] == 2 * eng.decode_step_seconds.count  # per decode step
    else:
        assert counts[kernels.FLASH_FP8.name] == 2 * len(prompts)
    plain = {"qmatmul": kernels.qmatmul_plain,
             "flash_attention": kernels.flash_attention_plain,
             "paged_attention": kernels.paged_attention_plain}
    with mock.patch.multiple(kernels, **plain):
        _, ref = run()
    # bf16 activations through two layers: 0.05 in logprob units, twice
    # that over an fp8 pool (a K/V code one e5m2 step over moves its
    # element by a quarter), up to the first token the runs differ on
    tol = 0.1 if quantize_kv else 0.05
    for (ta, a), (tb, b) in zip(outs, ref):
        n = next((j for j, (x, y) in enumerate(zip(ta, tb)) if x != y), len(ta)) + 1
        assert max(abs(x - y) for x, y in zip(a[:n], b[:n])) <= tol


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    dev = _cuda()
    w = quantize(torch.randn(128, 256, device=dev), "sym_int4")
    with pytest.raises(TypeError):
        kernels.qmatmul(torch.zeros(2, 256, device=dev), w)
    q = torch.zeros(1, 4, 2, 96, dtype=torch.bfloat16, device=dev)
    with pytest.raises(NotImplementedError):
        kernels.flash_attention(q, q, q)
    # the training kernels load bf16 tiles 16 bytes at a time: a base 8
    # bytes off raises, it does not fault
    buf = torch.zeros(4 + 1 * 4 * 2 * 64, dtype=torch.bfloat16, device=dev)
    q = buf[4:].view(1, 4, 2, 64)
    with pytest.raises(ValueError, match="aligned"):
        kernels.flash_train_fwd(q, q, q, torch.zeros(1, dtype=torch.int32, device=dev))
    # so does the prefill kernel, both arms
    with pytest.raises(ValueError, match="aligned"):
        kernels.flash_attention(q, q, q)
    codes = torch.zeros(8 + 1 * 4 * 2 * 64, dtype=torch.uint8, device=dev)[8:]
    kv = codes.view(1, 4, 2, 64).view(FP8)
    scales = torch.ones(1, 4, 2, dtype=torch.float16, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        kernels.flash_attention(torch.zeros(1, 4, 2, 64, dtype=torch.bfloat16, device=dev),
                                kv, kv, k_scale=scales, v_scale=scales)


@pytest.mark.parametrize("qtype", ["sym_int4", "nf4", "q4_k_m"])
def test_model_on_card_matches_plain_on_cpu(qtype):
    """The kernel-eligible slice config: prefill logits on the card (all
    three kernels) against the same weights on the CPU (plain versions);
    q4_k_m is a q4_k body under a q6_k lm head."""
    dev = _cuda()
    cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=1)
    cpu = optimize_model(llama.init_params(cfg, 0, device="cpu"), cfg, qtype)
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
    gpu = TorchModel(cfg, optimize_model(llama.init_params(cfg, 0, device="cpu"), cfg, qtype),
                     qtype, device=dev).params
    got = logits(gpu, dev)
    counts = kernels.launch_counts()
    assert counts[kernels.GEMM.name] == 8 and counts[kernels.FLASH.name] == 2
    assert counts[kernels.GEMV.name] == 1  # the lm head at the last position
    # bf16 activations through two layers: 4 bf16 ULPs of the largest logit
    assert (got - ref).abs().max() <= 2 ** -6 * ref.abs().max()


def _max_err(got, ref):
    return (got.float() - ref.float()).abs().max().item()


@pytest.mark.parametrize("M,O,K", [
    (1, 384, 1024), (33, 384, 1024), (300, 256, 320),  # small, ragged K/2
    (1024, 4096, 14336),  # llama3-8b w_down at the training shape
])
def test_dx_kernel_matches_plain(M, O, K):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(M + O)
    w = quantize(torch.randn(O, K, device=dev, generator=g) * 0.05, "sym_int4")
    gr = torch.randn(M, O, device=dev, generator=g).to(torch.bfloat16)
    before = kernels.DX.launches
    dx = kernels.qmatmul_dx(gr, w)
    torch.cuda.synchronize()
    assert kernels.DX.launches == before + 1 and dx.shape == (M, K)
    ref = kernels.qmatmul_dx_plain(gr, w)
    assert _max_err(dx, ref) <= _ULPS * ref.float().abs().max().item()


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("lead,O,K", [
    ((1,), 384, 320), ((33,), 384, 320), ((2, 256), 384, 320),  # test_qbackward's
    ((3, 7), 200, 136),  # ragged tiles, every edge predicated
    ((5,), 385, 321),  # O, K not multiples of 8: the mma.sync kernel
    ((1024,), 1024, 4096),  # llama3-8b wk at the training shape
])
def test_dw_kernel_matches_plain(lead, O, K, out_dtype):
    """dW = g^T @ x against its plain version: f32 sums in another order,
    then one rounding on each side — within two bf16 ULPs of the largest
    output (bf16), or 2^-16 of it (f32)."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(sum(lead) + O + K)
    gr = torch.randn(*lead, O, device=dev, generator=g).to(torch.bfloat16)
    x = torch.randn(*lead, K, device=dev, generator=g).to(torch.bfloat16)
    before = kernels.DW.launches
    dw = kernels.dw_matmul(gr, x, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert kernels.DW.launches == before + 1
    assert dw.shape == (O, K) and dw.dtype == out_dtype
    ref = kernels.dw_matmul_plain(gr, x, out_dtype)
    tol = (_ULPS if out_dtype == torch.bfloat16 else 2 ** -16) * ref.float().abs().max().item()
    assert _max_err(dw, ref) <= tol


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("O,K,skew,variant", [
    (384, 320, False, "tma"), (200, 136, False, "tma"),  # 128 x 256 tiles, ragged edges
    (385, 321, False, "any"), (384, 320, True, "any"),  # no TMA: K % 8, g's base off 16 bytes
])
@pytest.mark.parametrize("M", [1, 63, 65, 1000])
def test_dw_kernels_at_ragged_m_and_both_variants(M, O, K, skew, variant, out_dtype):
    """Each variant the wrapper picks by shape (`dw_variant`) against the
    plain version, and a second launch bit-equal to the first (no split of
    M, no atomics)."""
    from bigdl_tpu_torch.ops.kernels.dw_matmul import dw_variant

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(M + O + K)
    gr = torch.randn(M, O, device=dev, generator=g).to(torch.bfloat16)
    if skew:
        gr = torch.empty(M * O + 1, dtype=torch.bfloat16, device=dev)[1:].view(M, O).copy_(gr)
    x = torch.randn(M, K, device=dev, generator=g).to(torch.bfloat16)
    assert dw_variant(O, K, gr.data_ptr(), x.data_ptr()) == variant
    before = kernels.DW.launches
    dw = kernels.dw_matmul(gr, x, out_dtype=out_dtype)
    again = kernels.dw_matmul(gr, x, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert kernels.DW.launches == before + 2 and torch.equal(dw, again)
    ref = kernels.dw_matmul_plain(gr, x, out_dtype)
    tol = (_ULPS if out_dtype == torch.bfloat16 else 2 ** -16) * ref.float().abs().max().item()
    assert _max_err(dw, ref) <= tol


@pytest.mark.parametrize("R", [3, 8, 16, 32, 128])
@pytest.mark.parametrize("M,O,K", [(33, 384, 1024), (300, 256, 320),
                                   (1024, 4096, 4096)])  # the last: llama3-8b wo
def test_lora_gemm_matches_plain(M, O, K, R):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(M + O + R)
    w = quantize(torch.randn(O, K, device=dev, generator=g) * 0.05, "sym_int4")
    x = torch.randn(M, K, device=dev, generator=g).to(torch.bfloat16)
    a = (torch.randn(R, K, device=dev, generator=g) / R).to(torch.bfloat16)
    b = (torch.randn(O, R, device=dev, generator=g) * 0.1).to(torch.bfloat16)
    gate = torch.full((M, R), 2.0, dtype=torch.bfloat16, device=dev)
    before = kernels.LORA_GEMM.launches
    y = kernels.qmatmul_lora(x, w, a, b, gate)
    torch.cuda.synchronize()
    assert kernels.LORA_GEMM.launches == before + 1
    ref = kernels.qmatmul_lora_plain(x, w, a, b, gate)
    base = kernels.qmatmul_plain(x, w)
    assert _max_err(ref, base) > 0  # the epilogue is not a no-op here
    assert _max_err(y, ref) <= _ULPS * ref.float().abs().max().item()


@pytest.mark.parametrize("case", [
    # B, T, Hq, Hkv, D, window, start
    (2, 48, 4, 2, 64, None, (0, 13)),
    (1, 100, 4, 1, 128, 24, (0,)),
    (2, 70, 2, 2, 128, None, (5, 40)),
    (1, 1024, 32, 8, 128, None, (0,)),  # llama3-8b at the training shape
    (2, 130, 8, 1, 64, 64, (0, 70)),  # G=8: a cluster of 8; row 1's pad covers key tile 0
    (1, 65, 4, 4, 128, None, (0,)),  # G=1, one key past a tile
])
def test_flash_train_kernels_match_plain(case):
    dev = _cuda()
    B, T, Hq, Hkv, D, window, start = case
    g = torch.Generator(device=dev).manual_seed(T + D)

    def rnd(*shape):
        return torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)

    q, k, v, do = rnd(B, T, Hq, D), rnd(B, T, Hkv, D), rnd(B, T, Hkv, D), rnd(B, T, Hq, D)
    st = torch.tensor(start, dtype=torch.int32, device=dev)
    before = [kk.launches for kk in (kernels.FLASH_FWD, kernels.FLASH_DQ, kernels.FLASH_DKV)]
    out, lse = kernels.flash_train_fwd(q, k, v, st, window)
    ref_out, ref_lse = kernels.flash_attention_train_plain(q, k, v, st, window)
    # per element, one bf16 rounding step above a floor far below a ULP
    assert bool(((out.float() - ref_out.float()).abs()
                 <= _ULPS * ref_out.float().abs() + 1e-5).all())
    pad = ref_lse <= -1e29
    assert pad.any() == (max(start) > 0) and bool((lse[pad] == -1e30).all())
    assert bool((out[pad.any(-1)] == 0).all())
    assert _max_err(lse[~pad], ref_lse[~pad]) <= 1e-4  # f32 sums in another order
    delta = (do.float() * out.float()).sum(-1)
    dq = kernels.flash_train_dq(q, k, v, st, do, lse, delta, window)
    dk, dv = kernels.flash_train_dkv(q, k, v, st, do, lse, delta, window)
    torch.cuda.synchronize()
    assert [kk.launches for kk in (kernels.FLASH_FWD, kernels.FLASH_DQ,
                                   kernels.FLASH_DKV)] == [n + 1 for n in before]
    # keys before start[b] are attended by no query: exactly 0
    for b, s0 in enumerate(start):
        assert bool((dk[b, :s0] == 0).all() and (dv[b, :s0] == 0).all())
    # queries before start[b] attend no key: their dq rows are exactly 0
    for b, s0 in enumerate(start):
        assert bool((dq[b, :s0] == 0).all())
    # no atomics: a second launch gives the same bits
    dk2, dv2 = kernels.flash_train_dkv(q, k, v, st, do, lse, delta, window)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert torch.equal(dq, kernels.flash_train_dq(q, k, v, st, do, lse, delta, window))
    refs = kernels.flash_attention_train_bwd_plain(q, k, v, st, do, lse, delta, window)
    for got, ref in zip((dq, dk, dv), refs):
        # gradients sum many signed terms: 4 bf16 ULPs of the largest
        # element, and 1 % in the Frobenius norm
        scale = ref.float().abs().max().item()
        assert _max_err(got, ref) <= 2 ** -6 * scale
        assert ((got.float() - ref.float()).norm() <= 1e-2 * ref.float().norm()).item()


def _train_grads(cfg, model, lora, tokens, plain):
    """Loss and LoRA gradients of one step, with the kernels or, with
    `plain`, every kernel patched to its plain version."""
    patches = [mock.patch.object(kernels, n, getattr(kernels, p)) for n, p in (
        ("qmatmul", "qmatmul_plain"), ("qmatmul_dx", "qmatmul_dx_plain"),
        ("qmatmul_lora", "qmatmul_lora_plain"),
        ("flash_train_fwd", "flash_attention_train_plain"),
        ("flash_train_dq", "flash_train_dq_plain"),
        ("flash_train_dkv", "flash_train_dkv_plain"))] if plain else []
    for p in patches:
        p.start()
    try:
        for prm in lora.parameters():
            prm.grad = None
        loss = next_token_loss(cfg, llama.forward, model, lora, tokens,
                               torch.ones_like(tokens, dtype=torch.float32))
        loss.backward()
        return loss.item(), {n: prm.grad.float().clone() for n, prm in lora.named_parameters()}
    finally:
        for p in patches:
            p.stop()


def test_train_step_kernels_match_plain_full_width():
    """Two llama3-8b layers at full width, B=1 T=256, rank 8: the loss and
    LoRA gradients of one step through the kernels against the same step
    through the plain versions on the card, then a step's launch counts."""
    dev = _cuda()
    cfg = dataclasses.replace(PRESETS["llama3-8b"], num_hidden_layers=2)
    model = optimize_model(llama.init_params(cfg, seed=3), cfg)
    lora = init_lora(cfg, seed=4)
    with torch.no_grad():  # B != 0, so every adapter gets a gradient
        for t in lora.layers.values():
            t["b"].normal_(0.0, 0.01, generator=torch.Generator(device=dev).manual_seed(5))
    tokens = torch.randint(0, cfg.vocab_size, (1, 257), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(6))
    loss_k, grads_k = _train_grads(cfg, model, lora, tokens, plain=False)
    loss_p, grads_p = _train_grads(cfg, model, lora, tokens, plain=True)
    # bf16 activations through two layers and back: 1e-3 of the loss, and
    # per adapter leaf 5 % of its largest gradient
    assert abs(loss_k - loss_p) <= 1e-3 * abs(loss_p)
    for n, ref in grads_p.items():
        assert _max_err(grads_k[n], ref) <= 0.05 * ref.abs().max().item(), n

    kernels.reset_launches()
    step = make_train_step(cfg, llama.forward, adamw(lora))
    loss = step(model, lora, tokens, torch.ones_like(tokens, dtype=torch.float32))
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    L = cfg.num_hidden_layers
    assert kernels.launch_counts() == {
        kernels.GEMM.name: 2 * L + 1, kernels.LORA_GEMM.name: 2 * L,
        kernels.FLASH_FWD.name: L, kernels.FLASH_DQ.name: L,
        kernels.FLASH_DKV.name: L, kernels.DX.name: 4 * L,
        kernels.GEMV.name: 0, kernels.FLASH.name: 0, kernels.PAGED.name: 0,
        kernels.PAGED_FP8.name: 0, kernels.FLASH_FP8.name: 0, kernels.LORA_GEMV.name: 0,
        kernels.DW.name: 0}


def test_full_ft_step_kernels_match_plain():
    """The full fine-tune of a small bf16 model (hidden 256, 2 layers,
    B=2 T=48): every dense weight's gradient through the dW kernel (and
    the flash trio) against the same backward through the plain versions
    on the card — loss to 1e-3 of itself, each leaf within 5 % of its
    largest gradient (bf16 activations through two layers and back) —
    then a GaLore step's launch counts: 7 dW a layer and the lm head's."""
    dev = _cuda()
    cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=1)
    from bigdl_tpu_torch.train import GaLore, make_full_train_step

    model = llama.init_params(cfg, seed=7)
    params = llama.make_trainable(model)
    tokens = torch.randint(1, cfg.vocab_size, (2, 49), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(8))
    mask = torch.ones_like(tokens, dtype=torch.float32)

    def grads():
        for p in params:
            p.grad = None
        loss = next_token_loss(cfg, llama.forward, model, None, tokens, mask)
        loss.backward()
        return loss.item(), [p.grad.float().clone() for p in params]

    loss_k, grads_k = grads()
    with mock.patch.multiple(kernels, dw_matmul=kernels.dw_matmul_plain,
                             flash_train_fwd=kernels.flash_attention_train_plain,
                             flash_train_dq=kernels.flash_train_dq_plain,
                             flash_train_dkv=kernels.flash_train_dkv_plain):
        loss_p, grads_p = grads()
    assert abs(loss_k - loss_p) <= 1e-3 * abs(loss_p)
    for gk, gp in zip(grads_k, grads_p):
        assert _max_err(gk, gp) <= 0.05 * gp.abs().max().item()

    step = make_full_train_step(cfg, llama.forward, GaLore(params, 1e-4, rank=16))
    kernels.reset_launches()
    before = [p.detach().clone() for p in params]
    assert torch.isfinite(step(model, tokens, mask))
    torch.cuda.synchronize()
    L = cfg.num_hidden_layers
    counts = kernels.launch_counts()
    assert counts[kernels.DW.name] == 7 * L + 1
    assert counts[kernels.FLASH_FWD.name] == counts[kernels.FLASH_DKV.name] == L
    assert counts[kernels.GEMM.name] == counts[kernels.DX.name] == 0
    assert any(not torch.equal(p, b) for p, b in zip(params, before))


ALL_FORMATS = ["sym_int4"] + OTHER_FORMATS


@pytest.mark.parametrize("qtype", ALL_FORMATS)
def test_lora_gemv_matches_plain(qtype):
    """The LoRA GEMV of every format against its plain version at M = 1,
    8, 32 and R = 8, 128, with the serving decode's block-diagonal gate
    (the last row all zero: a base row) at M > 1: within 2 bf16 ULPs of
    the largest output, and a zero-gate row bit-equal to the plain GEMV
    kernel's row (the same sums in the same order, plus exact zeros)."""
    dev = _cuda()
    O, K = 200, 2048  # a ragged last block; every format's k_multiple divides K
    g = torch.Generator(device=dev).manual_seed(len(qtype))
    w = quantize(torch.randn(O, K, device=dev, generator=g) * 0.02, qtype)

    def rnd(*shape):
        return torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)

    for M in (1, 8, 32):
        for R in (8, 128):
            x, a, b = rnd(M, K), rnd(R, K) / R, rnd(O, R) * 0.1
            gate = torch.zeros((M, R), dtype=torch.bfloat16, device=dev)
            width = max(R // M, 1)
            for m in range(max(M - 1, 1)):
                gate[m, (m * width) % R:(m * width) % R + width] = 2.0
            before = kernels.LORA_GEMV.launches
            got = kernels.qmatmul_lora(x, w, a, b, gate)
            torch.cuda.synchronize()
            assert kernels.LORA_GEMV.launches == before + 1
            assert kernels.LORA_GEMV.by_format[qtype] >= 1
            ref = kernels.qmatmul_lora_plain(x, w, a, b, gate)
            assert bool(torch.isfinite(got.float()).all())
            assert _max_err(got, ref) <= _ULPS * ref.float().abs().max().item(), (M, R)
            base = kernels.qmatmul(x, w)
            assert _max_err(got, base) > 0  # a real epilogue
            if M > 1:
                assert torch.equal(got[-1], base[-1]), (M, R)


def test_adapter_engine_two_layers_full_width_kernels_vs_plain(tmp_path):
    """Two llama3-8b layers at full width serving a mixed batch (two
    adapters of ranks 4 and 16 on all seven projections, one base
    request) over a paged pool: the LoRA GEMV at wo and w_down in every
    decode step that holds an adapter row (2 per layer), and the
    chosen-token logprobs of the same run with every kernel patched to its
    plain version."""
    from bigdl_tpu_torch.serving import InferenceEngine
    from bigdl_tpu_torch.serving.adapters import AdapterRegistry, save_adapter

    dev = _cuda()
    cfg = dataclasses.replace(PRESETS["llama3-8b"], num_hidden_layers=2)
    tm = TorchModel(cfg, optimize_model(llama.init_params(cfg, seed=5), cfg), "sym_int4")
    for name, rank in (("r4", 4), ("r16", 16)):
        lo = init_lora(cfg, seed=rank, rank=rank, alpha=2.0 * rank)
        with torch.no_grad():
            for t in lo.layers.values():
                t["b"].normal_(0.0, 0.02, generator=torch.Generator(device=dev).manual_seed(rank))
        save_adapter(str(tmp_path / f"{name}.npz"), lo)
    g = torch.Generator().manual_seed(6)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist() for n in (20, 90, 40)]
    jobs = list(zip(prompts, ["r4", "r16", None]))

    def run():
        eng = InferenceEngine(tm, n_slots=4, max_len=512, paged=True, page_size=64,
                              adapters=AdapterRegistry(dir=str(tmp_path)))
        reqs = [eng.submit(p, max_new_tokens=8, adapter=a) for p, a in jobs]
        eng.run_until_idle()
        assert eng.page_leaks() == 0
        assert all(r.finish_reason == "length" for r in reqs)
        return eng, [(r.out_tokens, r.out_logprobs) for r in reqs]

    kernels.reset_launches()
    eng, outs = run()
    counts = kernels.launch_counts()
    # every decode step held an adapter row (the base request finishes with them)
    assert counts[kernels.LORA_GEMV.name] >= 2 * 2 * eng.decode_step_seconds.count
    assert counts[kernels.PAGED.name] == 2 * eng.decode_step_seconds.count
    plain = {"qmatmul": kernels.qmatmul_plain, "qmatmul_lora": kernels.qmatmul_lora_plain,
             "flash_attention": kernels.flash_attention_plain,
             "paged_attention": kernels.paged_attention_plain}
    with mock.patch.multiple(kernels, **plain):
        _, ref = run()
    for (ta, a), (tb, b) in zip(outs, ref):  # bf16 through two layers: 0.05 nat
        n = next((j for j, (x, y) in enumerate(zip(ta, tb)) if x != y), len(ta)) + 1
        assert max(abs(x - y) for x, y in zip(a[:n], b[:n])) <= 0.05


# The tensor-core GEMM, LoRA GEMM and dx (csrc/qtile.cuh) at their tiles'
# edges: ragged M (a partial last block of every tile) with O = 200 (an O
# edge inside a 128-wide tile), and M = 1024, O = 4096, which takes the
# 256-row tile where the format has one; every format at K = 2048.
TILE_CASES = ([("sym_int4", M, 200) for M in (33, 255, 257, 1000, 1024, 4096)]
              + [(q, M, O) for q in ALL_FORMATS for M, O in ((300, 200), (1024, 4096))])


@pytest.mark.parametrize("qtype,M,O", TILE_CASES)
def test_dequant_tile_kernels_match_plain(qtype, M, O):
    """Each within 2 bf16 ULPs of the largest output of its plain version,
    a second launch bit-equal to the first (no atomics), and rows whose
    LoRA gate is zero bit-equal to the GEMM's rows (the adapter steps add
    exactly 0 after the same K walk)."""
    dev = _cuda()
    K, R = 2048, 8
    g = torch.Generator(device=dev).manual_seed(M + O + len(qtype))
    w = quantize(torch.randn(O, K, device=dev, generator=g) * 0.02, qtype)

    def rnd(*shape):
        return torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)

    x, gr = rnd(M, K), rnd(M, O)
    a, b = rnd(R, K) / R, rnd(O, R) * 0.1
    gate = torch.full((M, R), 2.0, dtype=torch.bfloat16, device=dev)
    gate[::3] = 0
    before = [k.launches for k in (kernels.GEMM, kernels.LORA_GEMM, kernels.DX)]
    y, yl, dx = kernels.qmatmul(x, w), kernels.qmatmul_lora(x, w, a, b, gate), kernels.qmatmul_dx(gr, w)
    torch.cuda.synchronize()
    assert [k.launches for k in (kernels.GEMM, kernels.LORA_GEMM, kernels.DX)] == [n + 1 for n in before]
    for got, ref in ((y, kernels.qmatmul_plain(x, w)),
                     (yl, kernels.qmatmul_lora_plain(x, w, a, b, gate)),
                     (dx, kernels.qmatmul_dx_plain(gr, w))):
        assert bool(torch.isfinite(got.float()).all()) and got.shape == ref.shape
        assert _max_err(got, ref) <= _ULPS * ref.float().abs().max().item()
    assert torch.equal(y, kernels.qmatmul(x, w))
    assert torch.equal(yl, kernels.qmatmul_lora(x, w, a, b, gate))
    assert torch.equal(dx, kernels.qmatmul_dx(gr, w))
    assert torch.equal(yl[::3], y[::3])
