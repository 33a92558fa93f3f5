"""key_norms_small selection and select_and_compact of the PyTorch port
against the JAX package, including tied scores."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quickvideo_tpu.ops import predictors as jpred
from quickvideo_tpu.ops import prune as jprune
from quickvideo_tpu_torch.ops import predictors as tpred
from quickvideo_tpu_torch.ops import prune as tprune

torch.set_num_threads(2)


@pytest.mark.parametrize("g,k", [(64, 32), (133, 66), (200, 1)])
def test_select_and_compact_matches_jax(g, k):
    rng = np.random.default_rng(g)
    keys = rng.standard_normal((2, g, 12)).astype(np.float32)
    vals = rng.standard_normal((2, g, 12)).astype(np.float32)
    ref = jprune.select_and_compact(
        "key_norms_small", k, jnp.asarray(keys), jnp.asarray(vals)
    )
    got = tprune.select_and_compact(
        "key_norms_small", k, torch.from_numpy(keys), torch.from_numpy(vals)
    )
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_array_equal(got.k_keep.numpy(), np.asarray(ref.k_keep))
    np.testing.assert_array_equal(got.v_keep.numpy(), np.asarray(ref.v_keep))


def test_key_norms_match_jax():
    keys = np.random.default_rng(0).standard_normal((4, 50, 128)).astype(np.float32)
    np.testing.assert_allclose(
        tpred.key_norms(torch.from_numpy(keys)).numpy(),
        np.asarray(jpred.key_norms(jnp.asarray(keys))), rtol=1e-6,
    )


@pytest.mark.parametrize("largest", [False, True])
def test_ties_go_to_the_lowest_index(largest):
    # tokens 0..7 share one score: a stable choice keeps the lowest indices
    scores = np.array([1, 1, 1, 1, 1, 1, 1, 1, 0.5, 2.0, 1, 1], np.float32)
    for k in (3, 6, 9):
        ref = np.asarray(jpred._top_k_indices(jnp.asarray(scores), k, largest))
        got = tpred._top_k_indices(torch.from_numpy(scores), k, largest)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_tied_key_norms_select_like_jax():
    rng = np.random.default_rng(1)
    base = rng.standard_normal((2, 1, 8)).astype(np.float32)
    keys = np.repeat(base, 40, axis=1)  # every token has the same norm
    keys[:, ::5] *= 0.5  # a few smaller ones
    ref = jprune.select_and_compact(
        "key_norms_small", 17, jnp.asarray(keys), jnp.asarray(keys)
    )
    got = tprune.select_and_compact(
        "key_norms_small", 17, torch.from_numpy(keys), torch.from_numpy(keys)
    )
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(ref.indices))
