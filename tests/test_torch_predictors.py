"""The 19 pruning predictors of the PyTorch port against the JAX package's
(quickvideo_tpu.ops.predictors.select_top_k_indices) on the same numpy
keys, values, hidden states, probabilities and accumulated scores, tied
scores included; and the attention-side functions the pruning modes feed
them from (group probabilities from the lse, prompt accumulation, partial
attention and its merge). All f32 on the CPU.

The 16 deterministic predictors must give the JAX package's index set
exactly. The 3 random ones draw from a torch.Generator where the JAX
package draws from jax.random: the two streams differ, so those are held
by property (k distinct ascending indices, 0 among `random`'s, the
deterministic half equal to the key-norm or column-sum order, the same
set from the same seed)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quickvideo_tpu.models.qwen25_vl import language as jlang
from quickvideo_tpu.models.qwen25_vl.config import get_config as jget_config
from quickvideo_tpu.ops import attention as jattn
from quickvideo_tpu.ops import predictors as jpred
from quickvideo_tpu.ops import prune as jprune
from quickvideo_tpu_torch.config import ALL_PREDICTORS
from quickvideo_tpu_torch.models.qwen25_vl import language as tlang
from quickvideo_tpu_torch.models.qwen25_vl.config import get_config
from quickvideo_tpu_torch.ops import attention as tattn
from quickvideo_tpu_torch.ops import predictors as tpred
from quickvideo_tpu_torch.ops import prune as tprune

torch.set_num_threads(2)

RANDOM = sorted(tpred.RANDOM_PREDICTORS)
DETERMINISTIC = sorted(ALL_PREDICTORS - tpred.RANDOM_PREDICTORS)
L, HKV, D, C = 96, 2, 16, 24


def _operands(seed, ties):
    """keys, values (Hkv, L, D), hidden (L, C), causal head-averaged probs
    (L, L) and accumulated scores (L,), as numpy. With `ties`, groups of
    tokens share their key, value and hidden rows, and the probabilities and
    scores are multiples of 1/8, so sums tie exactly."""
    rng = np.random.default_rng(seed)
    keys = rng.standard_normal((HKV, L, D)).astype(np.float32)
    values = rng.standard_normal((HKV, L, D)).astype(np.float32)
    hidden = rng.standard_normal((L, C)).astype(np.float32)
    s = rng.standard_normal((L, L)).astype(np.float32) * 2
    s = np.where(np.tril(np.ones((L, L), bool)), s, -np.inf)
    attn = np.exp(s - s.max(1, keepdims=True))
    attn = (attn / attn.sum(1, keepdims=True) * 0.9).astype(np.float32)
    accum = rng.uniform(0, 3, L).astype(np.float32)
    if ties:
        src = rng.integers(0, L // 4, L)
        keys, values, hidden = keys[:, src], values[:, src], hidden[src]
        attn = (np.round(attn * 8) / 8 * np.tril(np.ones((L, L)))).astype(
            np.float32
        )
        accum = np.round(accum * 8) / 8
    return dict(keys=keys, values=values, hidden=hidden, attn=attn,
                accum_attn=accum.astype(np.float32))


def _jax(pt, k, ops, **over):
    kw = {n: None if a is None else jnp.asarray(a)
          for n, a in {**ops, **over}.items()}
    return np.asarray(jpred.select_top_k_indices(pt, k, **kw))


def _torch(pt, k, ops, generator=None, **over):
    kw = {n: None if a is None else torch.from_numpy(np.asarray(a))
          for n, a in {**ops, **over}.items()}
    return tpred.select_top_k_indices(pt, k, generator=generator, **kw)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("pt", DETERMINISTIC)
def test_deterministic_predictors_select_the_jax_set(pt, ties):
    ops = _operands(len(pt) + ties, ties)
    for k in (1, 7, L // 2, L - 1):
        got = _torch(pt, k, ops)
        np.testing.assert_array_equal(got.numpy(), _jax(pt, k, ops),
                                      err_msg=f"{pt} k={k}")
        assert got.dtype == torch.int64


@pytest.mark.parametrize(
    "pt", ["query_attention_weights", "query_attention_weights_by_value_norm"]
)
def test_query_predictors_without_prompt_scores_use_column_sums(pt):
    """The final prefill with do_top_k_for_query has no prompt queries: the
    query predictors score the group's own column sums."""
    ops = _operands(5, ties=False)
    for k in (3, L // 2):
        got = _torch(pt, k, ops, accum_attn=None)
        np.testing.assert_array_equal(
            got.numpy(), _jax(pt, k, ops, accum_attn=None)
        )
    with pytest.raises(ValueError, match="needs"):
        _torch(pt, 3, ops, accum_attn=None, attn=None)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("pt", RANDOM)
def test_random_predictors_hold_their_properties(pt):
    ops = _operands(9, ties=False)
    kn = np.sqrt((ops["keys"].transpose(1, 0, 2).reshape(L, -1) ** 2).sum(-1))
    colsum = ops["attn"].sum(0)
    for k in (1, 2, 9, L // 2, L):
        got = _torch(pt, k, ops, generator=_gen(k))
        idx = got.numpy()
        assert len(idx) == k == len(set(idx.tolist()))
        assert (np.diff(idx) > 0).all() and 0 <= idx.min() and idx.max() < L
        if pt == "random":
            assert 0 in idx
        else:
            order = (np.argsort(kn, kind="stable") if "key_norms" in pt
                     else np.argsort(-colsum, kind="stable"))
            assert set(order[: k // 2].tolist()) <= set(idx.tolist())
        again = _torch(pt, k, ops, generator=_gen(k))
        assert torch.equal(got, again)
    draws = {tuple(_torch(pt, 20, ops, generator=_gen(s)).tolist())
             for s in range(4)}
    assert len(draws) > 1
    with pytest.raises(ValueError, match="Generator"):
        _torch(pt, 4, ops)


def test_unknown_predictor_and_k_are_rejected():
    ops = _operands(0, ties=False)
    with pytest.raises(ValueError, match="Unknown predict type"):
        _torch("nope", 4, ops)
    with pytest.raises(ValueError, match="positive"):
        _torch("key_norms", 0, ops)


@pytest.mark.parametrize("pt", ["salient_tokens", "query_attention_weights",
                                "output_norms", "key_norms_small"])
def test_select_and_compact_gathers_like_jax(pt):
    ops = _operands(11, ties=False)
    kw = dict(hidden=ops["hidden"], group_probs=ops["attn"],
              accum_attn=ops["accum_attn"])
    ref = jprune.select_and_compact(
        pt, 40, jnp.asarray(ops["keys"]), jnp.asarray(ops["values"]),
        **{n: jnp.asarray(a) for n, a in kw.items()},
    )
    got = tprune.select_and_compact(
        pt, 40, torch.from_numpy(ops["keys"]), torch.from_numpy(ops["values"]),
        **{n: torch.from_numpy(a) for n, a in kw.items()},
    )
    for name in ("indices", "k_keep", "v_keep", "accum_keep"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))


def test_indices_to_mask_matches_jax():
    idx = np.array([0, 5, 17, 95])
    np.testing.assert_array_equal(
        tpred.indices_to_mask(torch.from_numpy(idx), L).numpy(),
        np.asarray(jpred.indices_to_mask(jnp.asarray(idx), L)),
    )


# -- the attention-side functions ---------------------------------------------

CFG = get_config("tiny")
JCFG = jget_config("tiny")
# f32 on both sides; only summation order and exp / log rounding differ
ATOL = RTOL = 1e-5


def _qkv(seed, hq, hkv, g, n, d=12):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((hq, g, d)).astype(np.float32) * 1.5,
            rng.standard_normal((hkv, n, d)).astype(np.float32),
            rng.standard_normal((hkv, n, d)).astype(np.float32))


@pytest.mark.parametrize("g", [1, 70])
def test_group_probs_from_lse_match_jax(g):
    q, k, _ = _qkv(1, 4, 2, g, g)
    lse = np.random.default_rng(2).uniform(2, 6, (4, g)).astype(np.float32)
    ref = jlang._group_probs_from_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(lse), 0.3, JCFG.text,
    )
    got = tattn.group_probs_from_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(lse), 0.3,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_prompt_accum_scores_match_jax():
    q, k, _ = _qkv(3, 4, 2, 9, 64)
    ref = jlang._prompt_accum_scores(jnp.asarray(q), jnp.asarray(k), JCFG.text)
    got = tlang._prompt_accum_scores(torch.from_numpy(q), torch.from_numpy(k),
                                     CFG.text)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def _masks(ql, n):
    rng = np.random.default_rng(ql + n)
    mask = rng.random((ql, n)) < 0.6
    mask[0] = False  # a row that sees nothing: out 0, lse NEG_INF
    return mask


def test_partial_attention_and_merge_match_jax():
    q, k, v = _qkv(4, 4, 2, 30, 50)
    mask = _masks(30, 50)
    a_ref = jattn._partial_attention(jnp.asarray(q), jnp.asarray(k[:, :20]),
                                     jnp.asarray(v[:, :20]),
                                     jnp.asarray(mask[:, :20]), 0.25)
    b_ref = jattn._partial_attention(jnp.asarray(q), jnp.asarray(k[:, 20:]),
                                     jnp.asarray(v[:, 20:]),
                                     jnp.asarray(mask[:, 20:]), 0.25)
    t = [torch.from_numpy(x) for x in (q, k, v, mask)]
    a = tattn._partial_attention(t[0], t[1][:, :20], t[2][:, :20],
                                 t[3][:, :20], 0.25)
    b = tattn._partial_attention(t[0], t[1][:, 20:], t[2][:, 20:],
                                 t[3][:, 20:], 0.25)
    for got, ref in ((a, a_ref), (b, b_ref)):
        np.testing.assert_allclose(got.out.numpy(), np.asarray(ref.out),
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got.lse.numpy(), np.asarray(ref.lse),
                                   atol=ATOL, rtol=RTOL)
    assert not a.out[:, 0].any() and bool((a.lse[:, 0] == tattn.NEG_INF).all())
    out, lse = tattn.merge_partials(a, b)
    out_ref, lse_ref = jattn.merge_partials(a_ref, b_ref)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_ref), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=ATOL,
                               rtol=RTOL)
    # the merge of the two halves is the attention over the whole
    whole = tattn._partial_attention(t[0], t[1], t[2], t[3], 0.25)
    np.testing.assert_allclose(out[:, 1:].numpy(), whole.out[:, 1:].numpy(),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("probs", [False, True])
def test_group_only_attention_matches_jax(probs):
    q, k, v = _qkv(6, 4, 2, 40, 40)
    ref = jattn.grouped_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, None, None,
        scale=0.3, return_group_probs=probs,
    )
    got = tattn.grouped_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale=0.3, return_group_probs=probs,
    )
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=ATOL,
                               rtol=RTOL)
    if probs:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                                   atol=ATOL, rtol=RTOL)
    else:
        assert got[1] is None and ref[1] is None
