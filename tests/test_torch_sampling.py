"""bigdl_tpu_torch's per-row sampling and repetition penalty against
bigdl_tpu/generate.py: the penalty and the prompt's seen-token mask are
equal, the per-row filter keeps JAX's support, greedy rows are JAX's
argmax and sampled rows land only where JAX's filtered distribution is
nonzero (the two packages draw different random numbers from a seed)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bigdl_tpu import generate as jgen
from bigdl_tpu_torch import generate as tgen

# One intra-op thread: the suite runs in parallel worker processes, and a
# torch thread pool per worker oversubscribes the cores (tiny ops then
# run tens of times slower). Process-wide, like the import itself.
torch.set_num_threads(1)


def _logits(seed, B=4, V=96):
    return (np.random.default_rng(seed).normal(size=(B, V)) * 3).astype(np.float32)


def test_repetition_penalty_and_seen_mask_equal_jax():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 50, (3, 12)).astype(np.int32)
    start = np.asarray([0, 4, 11], np.int32)
    seen = tgen.seen_from_prompt(torch.from_numpy(tokens), torch.from_numpy(start), 50)
    jseen = jgen.seen_from_prompt(jnp.asarray(tokens), jnp.asarray(start), 50)
    np.testing.assert_array_equal(seen.numpy(), np.asarray(jseen))
    assert int(seen[2].sum()) == 1  # one real token in the last row
    logits = _logits(1, 3, 50)
    for penalty in (1.3, np.asarray([1.0, 0.7, 2.0], np.float32)):
        got = tgen.apply_repetition_penalty(torch.from_numpy(logits), seen,
                                            torch.as_tensor(penalty))
        want = jgen.apply_repetition_penalty(jnp.asarray(logits), jseen,
                                             jnp.asarray(penalty))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_per_row_filter_keeps_jax_support():
    logits = _logits(2)
    temp = np.asarray([0.7, 1.0, 1.3, 0.5], np.float32)
    topk = np.asarray([5, 0, 40, 1], np.int32)
    topp = np.asarray([0.9, 0.8, 1.0, 0.3], np.float32)
    got = tgen.filter_logits_per_row(torch.from_numpy(logits), torch.from_numpy(temp),
                                     torch.from_numpy(topk), torch.from_numpy(topp)).numpy()
    want = np.asarray(jgen.filter_logits_per_row(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(topk), jnp.asarray(topp)))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    # both divide by the same temperature in f32
    np.testing.assert_array_equal(got[np.isfinite(got)], want[np.isfinite(want)])


def test_greedy_rows_are_argmax_and_sampled_rows_stay_in_support():
    logits = _logits(3)
    temp = np.full((4,), 0.8, np.float32)
    topk = np.asarray([0, 7, 0, 3], np.int32)
    topp = np.asarray([0.9, 1.0, 0.5, 0.95], np.float32)
    do_sample = np.asarray([True, False, True, True])
    support = np.isfinite(np.asarray(jgen.filter_logits_per_row(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(topk), jnp.asarray(topp))))
    args = [torch.from_numpy(a) for a in (logits, temp, topk, topp)]
    g = torch.Generator().manual_seed(0)
    drawn = set()
    for _ in range(64):
        tok = tgen.sample_token_per_row(args[0], g, *args[1:], do_sample).numpy()
        assert tok[1] == np.argmax(logits[1])
        assert np.all(support[np.arange(4), tok])
        drawn.add(tuple(tok))
    assert len(drawn) > 1  # the sampled rows really sample
    greedy = tgen.sample_token_per_row(args[0], g, *args[1:], np.zeros(4, bool))
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(
        jgen.sample_token_per_row(jnp.asarray(logits), jax.random.PRNGKey(0), jnp.asarray(temp),
                                  jnp.asarray(topk), jnp.asarray(topp),
                                  jnp.zeros((4,), bool))))
