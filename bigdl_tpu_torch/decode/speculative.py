"""Self-speculative decoding (port of bigdl_tpu/decode/speculative.py).

The reference algorithm (ipex-llm `speculative.py:803`): a draft model,
by default a sym_int4 copy of the target's own weights, proposes up to K
tokens one at a time; one target forward over [cur, d0..d_{K-2}]
verifies them; the longest prefix that matches the target's choices is
accepted, plus the target's token after it. The JAX package runs a whole
round inside one `lax.while_loop`; here a round is a Python loop over
eager launches, and each round brings its acceptance count to the host
(the aligned cache keeps `pos` as a Python int), as does each draft
step's confidence when the draft early-stops.

Cache discipline (the reference's `_crop_past_key_values`): acceptance
is capped at K-1 and at the drafted count less one, so after a round
    target.pos = draft.pos = P + n_acc + 1,
every slot below pos holding the true sequence; "cropping" resets pos,
and the stale slots above it are overwritten before anything reads them.

Emitted tokens are always the target's choices, so greedy speculative
tokens are greedy `generate_tokens`' whatever the draft. On the card the
verify and the decode step reach different kernels (the flash kernel at
T = K and the GEMV at M = K, against the plain attention and the GEMV at
M = 1), so that holds up to near-ties of the logits there; on the CPU
both run the plain versions.

Batch size 1, as in the reference and the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch import kvcache
from bigdl_tpu_torch.generate import GenerationConfig, pad_prompts, sample_token
from bigdl_tpu_torch.models import llama
from bigdl_tpu_torch.models.config import ModelConfig
from bigdl_tpu_torch.utils import cache_len_for, flags

# auto_th_stop_draft's update constants, the reference's auto_parameters
# defaults (speculative.py:810): matchness EMA 0.5, target matchness
# 0.9, threshold step 1e-2, threshold EMA 0.9. The threshold and the
# matchness are float32 scalars, as JAX keeps them, so the early stop
# compares the same numbers.
_AUTO_EMA, _AUTO_TARGET, _AUTO_STEP, _AUTO_TH_EMA = 0.5, 0.9, 1e-2, 0.9
_F32 = np.float32


def rejection_accept(probs: torch.Tensor, drafts: torch.Tensor, greedy: torch.Tensor,
                     row_greedy: torch.Tensor, row_sampled: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     u: Optional[torch.Tensor] = None,
                     gumbel: Optional[torch.Tensor] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Speculative-sampling acceptance (Leviathan et al.) for a batched
    verify round, rows of mixed decode modes.

    probs [B, K, V] are the target's sampling distributions (filtered),
    drafts [B, K] the draft's greedy tokens (a one-hot proposal), greedy
    [B, K] the target's argmax tokens, row_greedy / row_sampled [B] bool.
    Draft d_i is accepted with probability p_i(d_i) (u [B, K-1] uniform
    noise); on a rejection the residual max(p - q, 0) / Z is p with d_i's
    mass removed, and the token there is drawn as argmax(log p + gumbel)
    (gumbel [B, V]: JAX's `jax.random.categorical`); so every emitted
    token is an exact sample of its p_i. Greedy rows accept by argmax
    match; rows in neither mask (repetition-penalty rows) accept 0. Noise
    not given is drawn from `generator`.

    Returns (n_acc [B], extra [B], the token at position n_acc: the caller
    emits drafts[:, :n_acc] then extra)."""
    B, K, V = probs.shape
    dev = probs.device
    if u is None:
        u = torch.rand((B, K - 1), generator=generator, device=dev)
    p_draft = torch.gather(probs[:, :K - 1], -1, drafts[:, :K - 1, None].long())[..., 0]
    acc_sampled = u.to(dev) < p_draft
    acc_greedy = drafts[:, :K - 1] == greedy[:, :K - 1]
    acc = torch.where(row_greedy[:, None], acc_greedy, acc_sampled)
    acc = acc & (row_greedy | row_sampled)[:, None]
    n_acc = torch.cumprod(acc.long(), dim=1).sum(dim=1)

    p_n = torch.gather(probs, 1, n_acc[:, None, None].expand(B, 1, V))[:, 0]
    d_n = torch.gather(drafts.long(), 1, torch.clamp(n_acc, max=K - 1)[:, None])[:, 0]
    rejected = n_acc < K - 1
    hot = torch.nn.functional.one_hot(d_n, V).to(probs.dtype)
    p_adj = torch.where(rejected[:, None], p_n * (1.0 - hot), p_n)
    if gumbel is None:
        uni = torch.rand((B, V), generator=generator, device=dev)
        gumbel = -torch.log(-torch.log(torch.clamp(uni, min=torch.finfo(uni.dtype).tiny)))
    extra_sampled = torch.argmax(gumbel.to(dev) + torch.log(p_adj + 1e-20), dim=-1)
    extra_greedy = torch.gather(greedy.long(), 1, n_acc[:, None])[:, 0]
    return n_acc, torch.where(row_sampled, extra_sampled, extra_greedy)


def _init_cache(config: ModelConfig, B: int, cache_len: int, start: torch.Tensor,
                quantize_kv: bool) -> kvcache.KVCache:
    cache = kvcache.init_cache(config.num_hidden_layers, B, cache_len,
                               config.num_key_value_heads, config.head_dim_,
                               quantize_kv=quantize_kv, device=start.device)
    return dataclasses.replace(cache, start=start)


def model_device(params: llama.LlamaModel) -> torch.device:
    return params.final_norm.device


@torch.inference_mode()
def speculative_tokens(config: ModelConfig, target_params, draft_params,
                       tokens: torch.Tensor, start: torch.Tensor,
                       generator: Optional[torch.Generator], gen: GenerationConfig,
                       cache_len: int, draft_k: int = 4, quantize_kv: bool = False,
                       adaptive: bool = True, th_stop_draft: float = 0.8,
                       min_step_draft: int = 3, rounds: Optional[list] = None
                       ) -> tuple[torch.Tensor, int, int, int]:
    """tokens [1, T] left-padded, start [1], on the models' device.
    Returns (out [1, max_new_tokens], n_rounds, n_drafted, n_matched);
    `rounds`, where given, gets one (drafts, target choices, n_acc) a
    round, the drafts as far as drafted.

    adaptive=True is the reference's th_stop_draft (speculative.py:
    827-1269): drafting stops once the draft's confidence (its greedy
    token's probability) falls below a threshold after min_step_draft
    drafts, and the threshold follows an EMA of the acceptance rate — low
    matchness raises it, full drafting lowers it. The verify stays K
    tokens wide, its acceptance capped at the drafted count."""
    B, T = tokens.shape
    if B != 1:
        raise ValueError("speculative decoding is batch-1 (as the reference)")
    K = draft_k
    if K < 2:
        raise ValueError(f"draft_k must be >= 2, got {K}")
    max_new = gen.max_new_tokens
    if cache_len < T + max_new + K + 1:
        raise ValueError(f"cache_len {cache_len} < {T} + {max_new} + {K} + 1")
    tokens = tokens.long()
    tcache = _init_cache(config, B, cache_len, start, quantize_kv)
    dcache = _init_cache(config, B, cache_len, start, quantize_kv)

    # prefill both models on the prompt; the first token is the target's
    tlogits, tcache = llama.forward(config, target_params, tokens, tcache, mode="prefill",
                                    last_logits_only=flags.last_lm_head_default())
    _, dcache = llama.forward(config, draft_params, tokens, dcache, mode="prefill",
                              last_logits_only=True)
    cur = sample_token(tlogits[:, -1], generator, gen)  # [1]
    del tlogits
    out = [int(cur[0])]
    eos = gen.eos_token_id
    done = eos is not None and out[0] == eos
    th, matchness = _F32(th_stop_draft), _F32(0.0)
    n_rounds = n_drafted = n_matched = 0
    while len(out) < max_new and not done:
        # draft up to K tokens greedily (KV for cur, d0..d_{n_draft-2})
        drafts, tok = [], cur
        while len(drafts) < K:
            logits, dcache = llama.forward(config, draft_params, tok[:, None], dcache,
                                           mode="decode")
            tok = torch.argmax(logits[:, -1], dim=-1)
            drafts.append(tok)
            if adaptive and len(drafts) >= min_step_draft:
                conf = torch.softmax(logits[:, -1].float(), dim=-1).max()
                if not _F32(conf.item()) >= th:  # the reference's early stop
                    break
        n_draft = len(drafts)
        drafts += [torch.zeros_like(cur)] * (K - n_draft)  # stale in JAX: never accepted
        drafts = torch.stack(drafts, dim=1)  # [1, K]

        # verify: one target forward over [cur, d0..d_{K-2}] (T = K)
        verify_in = torch.cat([cur[:, None], drafts[:, :K - 1]], dim=1)
        tlogits, tcache = llama.forward(config, target_params, verify_in, tcache,
                                        mode="prefill")
        choice = torch.stack([sample_token(tlogits[:, i], generator, gen)
                              for i in range(K)], dim=1)  # [1, K]
        del tlogits
        both = torch.cat([drafts, choice]).tolist()
        dr, ch = both[0], both[1]
        # the longest matching prefix, capped at K-1 and at n_draft-1: the
        # draft cache holds KV for cur, d0..d_{n_draft-2} only
        n_acc = 0
        while n_acc < min(K, n_draft) - 1 and dr[n_acc] == ch[n_acc]:
            n_acc += 1
        emitted = ch[:n_acc + 1]
        out += emitted
        if rounds is not None:
            rounds.append((dr[:n_draft], ch, n_acc))
        cur = choice[:, n_acc]
        # crop both caches to the accepted length
        new_pos = tcache.pos - K + n_acc + 1
        tcache = dataclasses.replace(tcache, pos=new_pos)
        dcache = dataclasses.replace(dcache, pos=new_pos)

        # the adaptive threshold (reference speculative.py:1225-1236), in
        # float32: matchness over the ACCEPTABLE drafts (n_draft - 1, the
        # cap), so a perfect draft reaches the target; a round with
        # n_draft <= 1 carries no signal and moves neither
        if n_draft > 1:
            matchness = (_F32(_AUTO_EMA) * matchness
                         + _F32(1 - _AUTO_EMA) * _F32(n_acc) / _F32(max(n_draft - 1.0, 1.0)))
            if adaptive:
                if matchness < _F32(_AUTO_TARGET):
                    new_th = th + _F32(_AUTO_STEP)  # low acceptance: stop sooner
                elif n_draft == K:
                    new_th = th
                else:
                    new_th = th - _F32(_AUTO_STEP)
                new_th = np.clip(new_th, _F32(0.05), _F32(0.99)).astype(_F32)
                th = _F32(_AUTO_TH_EMA) * th + _F32(1 - _AUTO_TH_EMA) * new_th
        if eos is not None and eos in emitted:
            done = True
        n_rounds += 1
        n_drafted += n_draft
        n_matched += n_acc
    out = out[:max_new] + [gen.pad_token_id] * (max_new - min(len(out), max_new))
    return (torch.tensor([out], dtype=torch.long, device=tokens.device), n_rounds,
            n_drafted, n_matched)


def mask_after_eos(out: np.ndarray, eos: Optional[int], pad: int) -> np.ndarray:
    """Tokens after a row's first EOS become pad (a round can emit a few
    tokens past EOS before the loop stops)."""
    if eos is None:
        return out
    out = np.array(out)
    for b in range(out.shape[0]):
        hits = np.nonzero(out[b] == eos)[0]
        if hits.size:
            out[b, hits[0] + 1:] = pad
    return out


def speculative_generate(config: ModelConfig, target_params, draft_params, prompts,
                         max_new_tokens: int = 32, draft_k: int = 4,
                         do_sample: bool = False, temperature: float = 1.0,
                         top_k: Optional[int] = None, top_p: Optional[float] = None,
                         eos_token_id: Optional[int] = None, pad_token_id: int = 0,
                         seed: int = 0, quantize_kv: bool = False, adaptive: bool = True,
                         th_stop_draft: float = 0.8, min_step_draft: int = 3,
                         stats: Optional[dict] = None) -> np.ndarray:
    """The host entry point of `speculative_generate` (speculative.py:803)
    on the target's device: returns [1, max_new_tokens] ids, pad after
    EOS. adaptive / th_stop_draft / min_step_draft are the reference's
    th_stop_draft knobs. `stats`, where given, gets n_rounds, n_drafted,
    n_matched and `rounds` (speculative_tokens')."""
    tokens, start = pad_prompts(prompts, pad_token_id)
    gen = GenerationConfig(max_new_tokens=max_new_tokens, do_sample=do_sample,
                           temperature=temperature, top_k=top_k, top_p=top_p,
                           eos_token_id=eos_token_id, pad_token_id=pad_token_id)
    dev = model_device(target_params)
    generator = torch.Generator(device=dev).manual_seed(seed) if do_sample else None
    rounds = None if stats is None else []
    out, n_rounds, n_drafted, n_matched = speculative_tokens(
        config, target_params, draft_params, torch.as_tensor(tokens, device=dev),
        torch.as_tensor(start, device=dev), generator, gen,
        cache_len=cache_len_for(tokens.shape[1], max_new_tokens + draft_k + 1),
        draft_k=draft_k, quantize_kv=quantize_kv, adaptive=adaptive,
        th_stop_draft=th_stop_draft, min_step_draft=min_step_draft, rounds=rounds)
    if stats is not None:
        stats.update(n_rounds=n_rounds, n_drafted=n_drafted, n_matched=n_matched,
                     rounds=rounds)
    return mask_after_eos(out.cpu().numpy().astype(np.int32), eos_token_id, pad_token_id)
