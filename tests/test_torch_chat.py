"""ChatSession in the port against the JAX package's, on the CPU: the seven
cases of the JAX package's tests/test_chat.py, with JAX's session on the
same tiny-llama sym_int4 parameters as the oracle.

Replies agree with JAX's by the margin rule: equal up to a reply token
where the logits JAX's session picked from have a top-1/top-2 margin
within twice the logit bound (4 bf16 ULPs of the largest logit); the
logits come from JAX's own session, recorded as it picks. Within the port,
a turn's incremental prefill gives the last token's logits of a one-shot
prefill of the whole transcript within that bound (other shapes: a
right-padded bucket at q_offset = pos against a left-padded bucket), and
its replies the one-shot `generate`'s by the margin rule; runs of the
same shapes (a fresh session, a bounded session before the window fills)
agree token for token.
"""

import dataclasses

import numpy as np
import pytest
import torch

from bigdl_tpu.api import TpuModel
from bigdl_tpu.chat import ChatSession as JaxChatSession
from bigdl_tpu_torch import TorchModel, kvcache
from bigdl_tpu_torch.chat import ChatSession
from bigdl_tpu_torch.generate import pad_prompts
from bigdl_tpu_torch.models import llama
from test_torch_snapkv import JCFG, TCFG, TOL_ULPS, pair

torch.set_num_threads(1)


class RecordingJaxSession(JaxChatSession):
    """JAX's session, keeping the logits of each pick of the last send."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.picks = []
        decode = self._decode_jit

        def recorded(p, t, c):
            lg, c = decode(p, t, c)
            self.picks.append(np.asarray(lg[0, -1], np.float32))
            return lg, c

        self._decode_jit = recorded

    def _prefill(self, ids):
        self.picks = []
        lg = super()._prefill(ids)
        self.picks.append(np.asarray(lg, np.float32))
        return lg


class RecordingSession(ChatSession):
    """The port's session, keeping each turn's prefill logits."""

    def _prefill(self, ids):
        self.prefill_logits = super()._prefill(ids)
        return self.prefill_logits


def _models():
    jparams, model = pair("sym_int4")
    return TpuModel(JCFG, jparams, "sym_int4"), TorchModel(TCFG, model, "sym_int4", device="cpu")


def assert_reply_margin(got, want, picks):
    """got equals want up to a token where JAX's top-1/top-2 margin is
    within twice the logit bound; returns whether they are equal."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            top = np.sort(picks[i])
            assert top[-1] - top[-2] <= 2 * TOL_ULPS * np.abs(picks[i]).max(), (i, g, w)
            return False
    return True


def one_shot_logits(tm, transcript):
    """The port's last-token logits of one prefill of the transcript."""
    tokens, start = pad_prompts([transcript], 0)
    cache = kvcache.init_cache(2, 1, tokens.shape[1], TCFG.num_key_value_heads,
                               TCFG.head_dim_, device="cpu")
    cache = dataclasses.replace(cache, start=torch.from_numpy(start))
    with torch.inference_mode():
        logits, _ = llama.forward(TCFG, tm.params, torch.from_numpy(tokens).long(), cache,
                                  last_logits_only=True)
    return logits[0, -1]


def assert_close_to_one_shot(tm, sess, transcript):
    ref = one_shot_logits(tm, transcript)
    err = (sess.prefill_logits - ref).abs().max().item()
    assert err <= TOL_ULPS * ref.abs().max().item(), err


def test_single_turn_matches_generate_and_jax():
    jm, tm = _models()
    prompt = [3, 1, 4, 1, 5, 9]
    js = RecordingJaxSession(jm, max_len=64)
    want = js.send(prompt, max_new_tokens=10)
    sess = RecordingSession(tm, max_len=64)
    got = sess.send(prompt, max_new_tokens=10)
    assert_reply_margin(got, want, js.picks)
    assert_close_to_one_shot(tm, sess, prompt)
    if got == want:  # JAX's picks are the logits along got's path
        assert_reply_margin(tm.generate([prompt], 10)[0].tolist(), got, js.picks)


def test_multi_turn_matches_full_history():
    jm, tm = _models()
    p1, p2, p3 = [3, 1, 4, 1, 5, 9], [2, 7, 1, 8], [11, 12]
    js = RecordingJaxSession(jm, max_len=128)
    sess = RecordingSession(tm, max_len=128)
    transcript = []
    for p, n in ((p1, 8), (p2, 8), (p3, 6)):
        want = js.send(p, max_new_tokens=n)
        got = sess.send(p, max_new_tokens=n)
        transcript += p
        assert_close_to_one_shot(tm, sess, transcript)
        transcript += got
        assert sess.pos == len(transcript)  # every reply token is in the cache
        if not assert_reply_margin(got, want, js.picks):
            break  # a near-tie flipped: the transcripts part here


def test_eos_token_is_committed_to_history():
    jm, tm = _models()
    p1, p2 = [3, 1, 4, 1, 5, 9], [2, 7]
    g1 = ChatSession(tm, max_len=128).send(p1, max_new_tokens=8)
    eos = g1[3]
    sess = RecordingSession(tm, max_len=128)
    g1b = sess.send(p1, max_new_tokens=8, eos_token_id=eos)
    assert g1b == g1[:g1.index(eos) + 1]
    assert sess.pos == len(p1) + len(g1b)  # the EOS's K/V is in the cache
    js = RecordingJaxSession(jm, max_len=128)
    want = js.send(p1, max_new_tokens=8, eos_token_id=eos)
    if assert_reply_margin(g1b, want, js.picks):
        got2, want2 = sess.send(p2, max_new_tokens=6), js.send(p2, max_new_tokens=6)
        assert_close_to_one_shot(tm, sess, p1 + g1b + p2)
        assert_reply_margin(got2, want2, js.picks)


def test_overflow_without_streaming_raises():
    _, tm = _models()
    sess = ChatSession(tm, max_len=24)
    sess.send([3, 1, 4, 1, 5], max_new_tokens=6)
    with pytest.raises(ValueError, match="streaming"):
        sess.send(list(range(2, 18)), max_new_tokens=8)


def test_streaming_session_unbounded():
    jm, tm = _models()
    W = 32
    sess = ChatSession(tm, max_len=9999, streaming=(4, W))
    js = RecordingJaxSession(jm, max_len=9999, streaming=(4, W))
    assert sess.max_len == W and sess.cache.max_len == W
    agree = True
    outs = []
    for turn in range(6):  # far beyond the window in aggregate
        out = sess.send([5 + turn, 6, 7], max_new_tokens=8)
        want = js.send([5 + turn, 6, 7], max_new_tokens=8)
        assert len(out) == 8 and all(0 <= t < TCFG.vocab_size for t in out)
        assert sess.pos <= W and sess.cache.max_len == W  # constant memory
        if agree:
            agree = assert_reply_margin(out, want, js.picks)
        outs.append(out)
    # a fresh session gives the same bits; before any eviction a bounded
    # session of the window's length runs the same shapes
    fresh = ChatSession(tm, max_len=9999, streaming=(4, W))
    bounded = ChatSession(tm, max_len=W)
    for turn in range(2):
        again = fresh.send([5 + turn, 6, 7], max_new_tokens=8)
        assert again == outs[turn]
        assert bounded.send([5 + turn, 6, 7], max_new_tokens=8) == again


def test_streaming_turn_fits_with_partial_tail_evict():
    jm, tm = _models()
    W, sink = 32, 4
    sess = ChatSession(tm, streaming=(sink, W))
    js = RecordingJaxSession(jm, streaming=(sink, W))
    for p, n in (([3, 1, 4], 4), (list(range(2, 29)), 2)):  # pos 7, then n = 27
        out, want = sess.send(p, max_new_tokens=n), js.send(p, max_new_tokens=n)
        assert len(out) == n and sess.pos <= W and sess.pos == js.pos
        if not assert_reply_margin(out, want, js.picks):
            break
    with pytest.raises(ValueError, match="cannot fit the streaming"):
        sess.send(list(range(2, 2 + W)), max_new_tokens=2)


def test_send_validates_token_ids():
    _, tm = _models()
    sess = ChatSession(tm, max_len=64)
    with pytest.raises(ValueError, match="wrong tokenizer"):
        sess.send([999999], max_new_tokens=2)
    with pytest.raises(ValueError, match="empty turn"):
        sess.send([], max_new_tokens=2)


def test_sampled_turn_is_seeded_per_position():
    """temperature > 0 draws from a torch.Generator seeded with seed + the
    turn's first position: a fresh session repeats it, another seed may
    not, and every token is in the vocabulary (jax.random and torch's
    generator differ, so JAX is no oracle here)."""
    _, tm = _models()
    a = ChatSession(tm, max_len=64).send([3, 1, 4], 12, temperature=1.0, seed=5)
    b = ChatSession(tm, max_len=64).send([3, 1, 4], 12, temperature=1.0, seed=5)
    assert a == b and all(0 <= t < TCFG.vocab_size for t in a)
    sess = ChatSession(tm, max_len=64)
    sess.reset()
    assert sess.pos == 0 and sess.send([3, 1, 4], 12, temperature=1.0, seed=5) == a
