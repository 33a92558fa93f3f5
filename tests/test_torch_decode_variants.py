"""Sampled and streamed decode in the PyTorch port against the JAX engine:
the top-k / top-p filters value for value, sampling by property (torch's
and jax's random streams differ), and streamed chunks call for call."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quickvideo_tpu.prefill import LVUEngine as JEngine
from quickvideo_tpu.prefill import PrefillInputs as JInputs
from quickvideo_tpu_torch.prefill import LVUEngine, PrefillInputs

from test_torch_engine import CFG, TCFG, build_request, configs, params  # noqa: F401

torch.set_num_threads(2)


def seeded_logits(seed, vocab=1000, ties=False):
    x = np.random.default_rng(seed).normal(0, 3, vocab).astype(np.float32)
    if ties:  # many equal values, the k-th and the cutoff among them
        x = np.round(x).astype(np.float32)
    return x


@pytest.mark.parametrize("seed,ties", [(0, False), (1, True), (2, True)])
def test_filters_equal_jax_value_for_value(seed, ties):
    x = seeded_logits(seed, ties=ties)
    for top_k in (None, 0, 1, 2, 7, 50, 999, 1000, 5000):
        for top_p in (None, 0.0, 0.05, 0.3, 0.5, 0.9, 0.999, 1.0):
            want = np.asarray(JEngine._filter_logits(jnp.asarray(x), top_p,
                                                     top_k))
            got = LVUEngine._filter_logits(torch.from_numpy(x), top_p,
                                           top_k).numpy()
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"top_k={top_k} "
                                                  f"top_p={top_p}")


def test_top_k_keeps_ties_at_the_kth_value():
    x = torch.tensor([3.0, 1.0, 2.0, 2.0, 2.0, 0.0])
    got = LVUEngine._filter_logits(x, top_k=2)
    assert torch.isfinite(got).tolist() == [True, False, True, True, True,
                                            False]
    # top_k >= vocab keeps every logit
    assert torch.equal(LVUEngine._filter_logits(x, top_k=100), x)


def _engine(tp, **kw):
    _, tlvu = configs(model_name_or_path="tiny", max_decode_tokens=8, **kw)
    return LVUEngine(tp, TCFG, tlvu, dtype=torch.float32)


def _inputs():
    ids, grid, groups, grids = build_request()
    return PrefillInputs(ids, grid, groups, grids, 2.0)


@pytest.mark.parametrize("on_device", [True, False])
@pytest.mark.parametrize("top_k,top_p", [(5, None), (None, 0.5), (20, 0.9)])
def test_draws_stay_in_the_filtered_support(params, on_device, top_k,
                                            top_p):
    eng = _engine(params[1], sample_on_device=on_device)
    for seed in range(4):
        logits = torch.from_numpy(seeded_logits(seed))
        support = torch.isfinite(LVUEngine._filter_logits(logits, top_p,
                                                          top_k))
        draws = {eng._sample(logits, 0.7, top_p, top_k) for _ in range(64)}
        assert all(bool(support[t]) for t in draws), (draws, seed)
        assert len(draws) > 1 or int(support.sum()) == 1


@pytest.mark.parametrize("on_device", [True, False])
def test_top_k_one_sampling_is_greedy(params, on_device):
    _, tp = params
    eng = _engine(tp, sample_on_device=on_device)
    greedy = eng.generate(_inputs(), max_new_tokens=7)
    sampled = eng.generate(_inputs(), max_new_tokens=7, greedy=False,
                           top_k=1, temperature=0.5)
    np.testing.assert_array_equal(sampled.tokens, greedy.tokens)
    assert sampled.cache_length == greedy.cache_length
    assert sampled.layer_lengths == greedy.layer_lengths


@pytest.mark.parametrize("on_device", [True, False])
def test_a_repeated_seed_repeats_the_sample(params, on_device):
    """Two engines seeded alike draw the same tokens; one engine's stream
    continues across requests (the JAX engine's self._rng)."""
    _, tp = params
    kw = dict(greedy=False, top_p=0.95, temperature=1.5, max_new_tokens=8)
    runs = []
    for _ in range(2):
        eng = _engine(tp, sample_on_device=on_device, seed=11)
        runs.append([eng.generate(_inputs(), **kw).tokens.tolist()
                     for _ in range(3)])
    assert runs[0] == runs[1]
    assert len({tuple(t) for t in runs[0]}) > 1  # the stream moved on
    other = _engine(tp, sample_on_device=on_device, seed=12)
    assert [other.generate(_inputs(), **kw).tokens.tolist()
            for _ in range(3)] != runs[0]


@pytest.mark.parametrize("chunk", [1, 3, 16, 64])
@pytest.mark.parametrize("eos_at", [None, 0, 3])
def test_greedy_stream_calls_equal_the_jax_engines(params, chunk, eos_at):
    """on_tokens: the first token alone, then chunks of min(32,
    stream_chunk_tokens), up to an EOS or max_new: the JAX engine's calls,
    one for one; the chunks concatenate to the unstreamed tokens."""
    jp, tp = params
    ids, grid, groups, grids = build_request()
    jlvu, tlvu = configs(model_name_or_path="tiny", max_decode_tokens=8,
                         stream_chunk_tokens=chunk)
    jeng = JEngine(jp, CFG, jlvu, dtype=jnp.float32)
    eng = LVUEngine(tp, TCFG, tlvu, dtype=torch.float32)
    plain = eng.generate(PrefillInputs(ids, grid, groups, grids, 2.0),
                         max_new_tokens=7)
    eos = [] if eos_at is None else [int(plain.tokens[eos_at])]
    want, got = [], []
    ref = jeng.generate(JInputs(ids, grid, groups, grids, 2.0),
                        max_new_tokens=7, eos_token_ids=eos,
                        on_tokens=lambda t: want.append(list(t)))
    res = eng.generate(PrefillInputs(ids, grid, groups, grids, 2.0),
                       max_new_tokens=7, eos_token_ids=eos,
                       on_tokens=lambda t: got.append(list(t)))
    assert got == want
    np.testing.assert_array_equal(res.tokens, ref.tokens)
    assert sum(got, []) == res.tokens.tolist()
    n = len(res.tokens)
    assert res.tokens.tolist() == plain.tokens[:n].tolist()
    assert res.cache_length == ref.cache_length


@pytest.mark.parametrize("on_device", [True, False])
def test_sampled_stream_chunks(params, on_device):
    """Device sampling streams chunks as greedy decode does; host sampling
    (sample_on_device=False) per token, as the JAX engine's legacy path.
    Either way the chunks concatenate to the tokens, and a seed repeats
    them with or without the callback."""
    _, tp = params
    kw = dict(greedy=False, top_p=0.9, max_new_tokens=8)
    eng = _engine(tp, sample_on_device=on_device, stream_chunk_tokens=3,
                  seed=5)
    chunks = []
    res = eng.generate(_inputs(), on_tokens=chunks.append, **kw)
    assert sum(chunks, []) == res.tokens.tolist()
    sizes = [len(c) for c in chunks]
    if on_device:
        assert sizes[0] == 1 and all(s <= 3 for s in sizes)
        assert all(s == 3 for s in sizes[1:-1])
    else:
        assert set(sizes) == {1}
    plain = _engine(tp, sample_on_device=on_device, stream_chunk_tokens=3,
                    seed=5).generate(_inputs(), **kw)
    np.testing.assert_array_equal(plain.tokens, res.tokens)
    # the cache holds the suffix and every token but the last
    assert res.layer_lengths == [res.cache_length] * len(res.layer_lengths)
