"""The pruning predictor families and modes of the PyTorch port's engine
against the JAX engine, end to end (the query-based ones in
test_torch_query_modes.py), on the tiny preset in f32 with identical
weights and inputs: greedy tokens, cache length, per-layer cache lengths,
the retained index set of every (group, layer) and of the pruned final
prefill, and the cache rows those sets kept.

The JAX engine runs its kernel route (attention_impl="pallas",
QV_PALLAS_INTERPRET=1): kernel B1 in interpret mode with its lse output on
the hot path and in pure-past mode for the query-based past partial, as the
port runs B1's plain versions. Its retained sets are read at run time with
jax.debug.callback around quickvideo_tpu.ops.prune.select_and_compact.

Tolerances: both sides compute in f32 and differ only in summation order;
the cached K/V rows agree to 1e-5 (the hidden states' parity bound in
test_torch_language.py), and the index sets, the cache lengths and the
tokens are compared exactly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quickvideo_tpu.config import LVUConfig as JLVUConfig
from quickvideo_tpu.models.qwen25_vl import model as jmodel
from quickvideo_tpu.ops import prune as jprune
from quickvideo_tpu.prefill import LVUEngine as JEngine
from quickvideo_tpu.prefill import PrefillInputs as JInputs
from quickvideo_tpu_torch.config import LVUConfig as TLVUConfig
from quickvideo_tpu_torch.models.qwen25_vl.config import get_config
from quickvideo_tpu_torch.models.qwen25_vl.convert import params_from_jax
from quickvideo_tpu_torch.prefill import LVUEngine, PrefillInputs
from test_torch_engine import CFG as JCFG
from test_torch_engine import build_request

torch.set_num_threads(2)

CFG = get_config("tiny")
ATOL = 1e-5


@pytest.fixture(scope="module")
def params():
    jp = jmodel.init_params(JCFG, seed=0, dtype=jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.fixture
def jax_retained(monkeypatch):
    """The index sets the JAX engine's select_and_compact returns, in call
    order (groups, then layers; the pruned final prefill last)."""
    calls = []
    orig = jprune.select_and_compact

    def record(*args, **kw):
        res = orig(*args, **kw)
        jax.debug.callback(lambda i: calls.append(np.asarray(i)), res.indices,
                           ordered=True)
        return res

    monkeypatch.setattr(jprune, "select_and_compact", record)
    monkeypatch.setenv("QV_COMPILE_CACHE", "0")
    return calls


MODES = {
    "salient_tokens": dict(top_k_predict_type="salient_tokens"),
    "per_image": dict(top_k_predict_type="attention_weights_sum_per_image"),
    "weighted_norms": dict(top_k_predict_type="weighted_norms"),
    "decay_linear": dict(top_k_decay_type="linear"),
    "decay_exponential": dict(top_k_decay_type="exponential",
                              top_k_decay_factor=0.7),
    "cascade": dict(top_k_predict_type="salient_tokens",
                    prefill_prune_starting_layer=1),
    "local_only": dict(top_k_predict_type="attention_weights",
                       adaptive_local_attention=False),
    "top_k_for_query": dict(top_k_predict_type="attention_weights_sum",
                            do_top_k_for_query=True),
    "salient_int8_kv": dict(top_k_predict_type="salient_tokens",
                            kv_cache_dtype="int8"),
}


def _port_retained(state):
    """The port's index sets in the JAX engine's call order."""
    sets = [i for group in state["retained"] for i in group if i is not None]
    final = state.get("retained_final") or []
    return sets + [i for i in final if i is not None]


def check_against_jax(params, jax_retained, monkeypatch, mode_kw):
    """One request through both engines under the LVUConfig keywords
    `mode_kw`; every comparison of the module docstring."""
    jp, tp = params
    kw = dict(model_name_or_path="tiny", top_p=0.5, max_decode_tokens=8,
              attention_impl="pallas", **mode_kw)
    jlvu, tlvu = JLVUConfig(**kw), TLVUConfig(**kw)
    ids, grid, groups, grids = build_request(n_post=7)
    monkeypatch.setenv("QV_PALLAS_INTERPRET", "1")
    jeng = JEngine(jp, JCFG, jlvu, dtype=jnp.float32)
    ref = jeng.generate(JInputs(ids, grid, groups, grids, 2.0),
                        max_new_tokens=6)
    want_sets = list(jax_retained)
    jcache, _ = jeng.prefill(JInputs(ids, grid, groups, grids, 2.0))
    monkeypatch.delenv("QV_PALLAS_INTERPRET")

    eng = LVUEngine(tp, CFG, tlvu, dtype=torch.float32)
    got = eng.generate(PrefillInputs(ids, grid, groups, grids, 2.0),
                       max_new_tokens=6)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    assert got.cache_length == ref.cache_length
    assert got.kv_cache_bytes == ref.kv_cache_bytes

    cache, st = eng.prefill(PrefillInputs(ids, grid, groups, grids, 2.0))
    lengths = np.asarray(jcache.length).tolist()
    assert cache.lengths == lengths
    eng.final_prefill(cache, st)
    got_sets = _port_retained(st)
    assert len(got_sets) == len(want_sets) > 0
    for n, (a, b) in enumerate(zip(got_sets, want_sets)):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f"call {n}")
    # the rows the sets kept (codes, for an int8 cache)
    for li, n in enumerate(lengths):
        for name in ("k", "v"):
            t = getattr(cache, name)
            # an int8 code on a rounding boundary may flip by one
            # (test_torch_language.py)
            tol = 1 if t.dtype == torch.int8 else ATOL
            np.testing.assert_allclose(
                t[li, :, :n].float().numpy(),
                np.asarray(getattr(jcache, name)[li, :, :n], np.float32),
                atol=tol, err_msg=f"{name} layer {li}",
            )


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_matches_the_jax_engine(params, jax_retained, monkeypatch, mode):
    check_against_jax(params, jax_retained, monkeypatch, MODES[mode])


def test_random_predictor_runs_and_is_seeded(params):
    """A random predictor through the port's engine (its draws differ from
    jax.random's): the same seed gives the same sets and cache, every set
    holds token 0, every layer holds the planned count."""
    _, tp = params
    ids, grid, groups, grids = build_request()

    def run(seed):
        eng = LVUEngine(tp, CFG, TLVUConfig(
            model_name_or_path="tiny", top_p=0.5, max_decode_tokens=4,
            top_k_predict_type="random", seed=seed,
        ), dtype=torch.float32)
        cache, st = eng.prefill(PrefillInputs(ids, grid, groups, grids, 2.0))
        return cache, st

    (c1, s1), (c2, s2) = run(3), run(3)
    assert c1.lengths == c2.lengths == [s1["cache_len"]] * 3
    for a, b in zip(_port_retained(s1), _port_retained(s2)):
        assert torch.equal(a, b) and bool((a == 0).any())
    assert torch.equal(c1.k, c2.k)
