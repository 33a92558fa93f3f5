"""The query-based pruning mode of the PyTorch port's engine against the
JAX engine, end to end (the comparisons and tolerances of
test_torch_modes.py): the prompt rows ride with every group, the past
partial is kernel B1 in pure-past mode (in interpret mode on the JAX side,
the plain version in the port) and merges with the in-group partial."""

import pytest

from test_torch_modes import check_against_jax, jax_retained, params  # noqa: F401

QUERY = dict(top_k_predict_type="query_attention_weights", query_based=True)
MODES = {
    "query": QUERY,
    "ref_mask": dict(QUERY, reference_query_mask=True),
    "by_value_norm": dict(
        QUERY, top_k_predict_type="query_attention_weights_by_value_norm"
    ),
    "cascade": dict(QUERY, prefill_prune_starting_layer=1),
    "local_only": dict(QUERY, adaptive_local_attention=False),
    "int8k_kv": dict(QUERY, kv_cache_dtype="int8k"),
    "int8_kv_decay": dict(QUERY, kv_cache_dtype="int8",
                          top_k_decay_type="linear"),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_query_mode_matches_the_jax_engine(params, jax_retained,  # noqa: F811
                                           monkeypatch, mode):
    check_against_jax(params, jax_retained, monkeypatch, MODES[mode])
