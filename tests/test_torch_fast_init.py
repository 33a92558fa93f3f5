"""The deterministic weights of a checkpoint-less preset name, against the
JAX package's (ROADMAP C29).

Given a preset name and no checkpoint, the JAX `LVU` builds
`model.py::init_params_fast` (every leaf ((iota % 17) - 8) * 0.01 over its
flat JAX layout) or, with int8 weights, `quantization.py::
init_params_fast_quantized` (codes (iota % 255) - 127, scales 8e-5). The
port's `convert.init_params_fast` / `init_params_fast_quantized` must give
the same leaves exactly: on one device, and on each tp / pp rank its part
of them (`params_from_jax(..., mesh=)`). The JAX iota is int32 and wraps
past 2^31, which only the 72B's large stacked leaves reach: the port's
index function is held against JAX's iota there, on slices XLA computes
without building the leaf. End to end, a port `LVU("tiny")` and a JAX
`LVU("tiny")`, both without `params`, give the same greedy tokens, cache
lengths and retained sets (JAX on its kernel route,
QV_PALLAS_INTERPRET=1); with int8 weights a set may differ only at key
norms tied within one f32 spacing at the selection's edge (ROADMAP C31).
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quickvideo_tpu.api import LVU as JLVU
from quickvideo_tpu.config import LVUConfig as JLVUConfig
from quickvideo_tpu.models.qwen25_vl import model as jmodel
from quickvideo_tpu.models.qwen25_vl.config import get_config as jget_config
from quickvideo_tpu.ops import quantization as jquant
from quickvideo_tpu.prefill import PrefillInputs as JInputs
from quickvideo_tpu_torch.api import LVU as TLVU
from quickvideo_tpu_torch.config import LVUConfig as TLVUConfig
from quickvideo_tpu_torch.models.qwen25_vl.config import get_config
from quickvideo_tpu_torch.models.qwen25_vl.convert import (
    fast_codes,
    fast_index,
    fast_values,
    init_params,
    init_params_fast,
    init_params_fast_quantized,
    params_from_jax,
)
from quickvideo_tpu_torch.prefill import PrefillInputs
from quickvideo_tpu_torch.testing import differing_leaves
from test_torch_engine import build_request

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def assert_same_tree(got, want):
    """Equal keys, and every leaf equal exactly, with its dtype, shape and
    strides (the int8 codes' column-major layout included)."""
    assert differing_leaves(got, want) == []


_JAX_TREES = {}


def jax_tree(dtype: str, int8: bool):
    """The JAX package's fast-init tree of tiny, as numpy."""
    if (dtype, int8) not in _JAX_TREES:
        jdt = DTYPES[dtype][0]
        make = (jquant.init_params_fast_quantized if int8
                else jmodel.init_params_fast)
        _JAX_TREES[dtype, int8] = jax.tree.map(
            np.asarray, make(jget_config("tiny"), jdt))
    return _JAX_TREES[dtype, int8]


def port_tree(dtype: str, int8: bool, mesh=None):
    make = init_params_fast_quantized if int8 else init_params_fast
    return make(get_config("tiny"), DTYPES[dtype][1], "cpu", mesh)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fast_init_equals_the_jax_package_leaf_by_leaf(dtype, int8):
    assert_same_tree(port_tree(dtype, int8),
                     params_from_jax(jax_tree(dtype, int8)))


def test_fast_init_is_not_the_seeded_init():
    """The preset weights are not init_params' normals (the parent's
    preset path), whatever the seed."""
    fast = port_tree("float32", False)["language"]["layers"][0]["wq"]
    for seed in (0, 3):
        drawn = init_params(get_config("tiny"), seed, torch.float32)
        assert not torch.equal(drawn["language"]["layers"][0]["wq"], fast)


def _mesh(tp, pp, rank):
    """A rank's place on a (pp, tp) mesh, tp fastest, as parallel/mesh.py
    lays the ranks out; what convert.py and sharding.py read of it."""
    coords = {"tp": rank % tp, "pp": rank // tp}
    return types.SimpleNamespace(index=lambda a: coords[a], tp=tp, pp=pp)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("tp,pp", [(2, 1), (1, 2), (2, 2)],
                         ids=["tp2", "pp2", "pp2_tp2"])
def test_fast_init_per_mesh_rank_equals_the_jax_tree_cut(tp, pp, int8):
    """Each rank's tree (its stage's layers and parts, its tp slices,
    computed from those indices alone) equals params_from_jax(mesh=) of
    the JAX package's whole tree."""
    want_tree = jax_tree("bfloat16", int8)
    for rank in range(tp * pp):
        mesh = _mesh(tp, pp, rank)
        assert_same_tree(port_tree("bfloat16", int8, mesh),
                         params_from_jax(want_tree, mesh=mesh))


# -- the int32 wrap at the 72B's shapes ----------------------------------------

_72B = jget_config("qwen25-vl-72b").text
# the stacked leaves of the 72B whose iota passes 2^31: (layers, in, out)
_72B_LEAVES = {
    "wq": (_72B.num_hidden_layers, _72B.hidden_size,
           _72B.num_attention_heads * _72B.head_dim),
    "wg": (_72B.num_hidden_layers, _72B.hidden_size,
           _72B.intermediate_size),
}


def _blocks_at(shape, flats, rows=3, cols=7):
    """(layer, rows, cols) blocks of a stacked leaf around the flat
    indices `flats` (each block spans the index), inside the leaf."""
    n_layer = shape[1] * shape[2]
    out = []
    for k in flats:
        li, rest = divmod(k, n_layer)
        r, c = divmod(rest, shape[2])
        r0 = min(max(r - 1, 0), shape[1] - rows)
        c0 = min(max(c - cols // 2, 0), shape[2] - cols)
        out.append((li, range(r0, r0 + rows), range(c0, c0 + cols)))
    return out


@pytest.mark.parametrize("key", sorted(_72B_LEAVES))
def test_fast_index_wraps_as_the_jax_int32_iota_at_72b_shapes(key):
    """At the 72B's stacked wq (80 x 8192 x 8192, 5.4e9 elements) and wg
    (1.9e10): blocks on both sides of 2^31, at 2^32 and in the last
    layer's last rows, the port's index, float values (bf16) and int8
    codes equal JAX's int32 iota formula there; past 2^31 they differ
    from the unwrapped index's."""
    shape = _72B_LEAVES[key]
    n = int(np.prod(shape))
    assert n > 2**31
    flats = [2**31 - 1, 2**31, 2**32 if n > 2**32 else n - 1, n - 1]
    wrapped_somewhere = False
    for li, rows, cols in _blocks_at(shape, flats):
        def jax_slice(f):
            return np.asarray(jax.jit(lambda: f(jax.lax.iota(jnp.int32, n))
                                      .reshape(shape)[
                li, rows.start:rows.stop, cols.start:cols.stop])())

        offset = li * shape[1] * shape[2]
        idx = fast_index(shape[1:], offset, rows, cols)
        np.testing.assert_array_equal(idx.numpy(), jax_slice(lambda i: i))
        want = jax_slice(lambda i: ((i % 17 - 8).astype(jnp.float32) * 0.01)
                         .astype(jnp.bfloat16))
        np.testing.assert_array_equal(
            fast_values(idx, torch.bfloat16).float().numpy(),
            want.astype(np.float32))
        codes = jax_slice(lambda i: (i % 255 - 127).astype(jnp.int8))
        np.testing.assert_array_equal(fast_codes(idx).numpy(), codes)
        # the transposed layout (the int8 codes' storage) is the same block
        np.testing.assert_array_equal(
            fast_index(shape[1:], offset, rows, cols,
                       transposed=True).t().numpy(), idx.numpy())
        flat = (offset + np.arange(rows.start, rows.stop)[:, None] * shape[2]
                + np.arange(cols.start, cols.stop)[None, :])
        wrapped_somewhere |= bool((flat % 17 != idx.numpy() % 17).any())
    assert wrapped_somewhere


# -- end to end ----------------------------------------------------------------


def _record_selections(monkeypatch):
    """Both packages' top-k selections, in call order: (scores, kept
    indices, largest), the JAX side's read with jax.debug.callback."""
    from quickvideo_tpu.ops import predictors as jpred
    from quickvideo_tpu_torch.ops import predictors as tpred

    jcalls, tcalls = [], []
    jtop, ttop = jpred._top_k_indices, tpred._top_k_indices

    def jrecord(scores, k, largest):
        idx = jtop(scores, k, largest)
        jax.debug.callback(lambda s, i: jcalls.append(
            (np.asarray(s), np.asarray(i), largest)), scores, idx,
            ordered=True)
        return idx

    def trecord(scores, k, largest):
        idx = ttop(scores, k, largest)
        tcalls.append((scores.numpy().copy(), idx.numpy().copy(), largest))
        return idx

    monkeypatch.setattr(jpred, "_top_k_indices", jrecord)
    monkeypatch.setattr(tpred, "_top_k_indices", trecord)
    monkeypatch.setenv("QV_COMPILE_CACHE", "0")
    return jcalls, tcalls


def _one_ulp_ties(port, ref):
    """The tokens one call kept on one side only; each must be a tie at
    the selection's edge on both sides: its score within one f32 spacing
    of that side's k-th score (ROADMAP C31)."""
    (ts, ti, largest), (js, ji, _) = port, ref
    apart = sorted(set(ti.tolist()) ^ set(ji.tolist()))
    for scores, kept in ((ts, ti), (js, ji)):
        kth = np.sort(scores)[::-1 if largest else 1][len(kept) - 1]
        for i in apart:
            assert abs(scores[i] - kth) <= np.spacing(np.float32(kth)), (
                i, scores[i], kth)
    return apart


@pytest.mark.parametrize("top_p", [None, 0.5])
@pytest.mark.parametrize("weights", ["float", "int8"])
def test_preset_lvu_without_params_matches_the_jax_lvu(monkeypatch, weights,
                                                       top_p):
    """LVU("tiny") in both packages, neither given `params`: the port's
    preset weights are the JAX LVU's (leaf by leaf), and its greedy
    tokens, cache length and per-layer lengths equal the JAX engine's on
    its kernel route. The retained sets are equal with float weights.
    With int8 weights the period-17 codes put several key norms within an
    f32 spacing of each other at the selection's edge, which the two
    packages' f32 sums round apart: a set may keep another of the tied
    tokens (ROADMAP C31), and nothing else may differ."""
    int8 = weights == "int8"
    kw = dict(model_name_or_path="tiny", top_p=top_p, max_decode_tokens=8,
              dtype="float32", attention_impl="pallas",
              param_dtype="int8" if int8 else "bfloat16", seed=5)
    ids, grid, groups, grids = build_request(n_post=7)
    jcalls, tcalls = _record_selections(monkeypatch)
    monkeypatch.setenv("QV_PALLAS_INTERPRET", "1")
    jlvu = JLVU(JLVUConfig(**kw))
    jparams = params_from_jax(jax.tree.map(np.asarray, jlvu.params))
    ref = jlvu.engine.generate(JInputs(ids, grid, groups, grids, 2.0),
                               max_new_tokens=6)
    jax.effects_barrier()
    jcalls.clear()
    jcache, _ = jlvu.engine.prefill(JInputs(ids, grid, groups, grids, 2.0))
    jax.effects_barrier()
    monkeypatch.delenv("QV_PALLAS_INTERPRET")

    lvu = TLVU(TLVUConfig(**kw), device="cpu")
    # the engine's int8 vision MLP prep replaces wg / wu: compare the rest
    got = lvu.params
    if int8:
        got = dict(got, vision=dict(got["vision"], blocks=[
            {k: v for k, v in b.items() if k in jparams["vision"]["blocks"][0]}
            for b in got["vision"]["blocks"]]))
        jparams["vision"]["blocks"] = [
            {k: v for k, v in b.items() if k in got["vision"]["blocks"][0]}
            for b in jparams["vision"]["blocks"]]
    assert_same_tree(got, jparams)
    res = lvu.engine.generate(PrefillInputs(ids, grid, groups, grids, 2.0),
                              max_new_tokens=6)
    np.testing.assert_array_equal(res.tokens, ref.tokens)
    assert res.cache_length == ref.cache_length
    assert res.kv_cache_bytes == ref.kv_cache_bytes
    tcalls.clear()
    cache, st = lvu.engine.prefill(PrefillInputs(ids, grid, groups, grids,
                                                 2.0))
    assert cache.lengths == np.asarray(jcache.length).tolist()
    sets = [i for g in st["retained"] for i in g if i is not None]
    n_layers = lvu.model_config.text.num_hidden_layers
    assert len(sets) == len(tcalls) == len(jcalls) == (
        0 if top_p is None else len(grids) * n_layers)
    for n, (a, b) in enumerate(zip(sets, tcalls)):
        np.testing.assert_array_equal(a.numpy(), b[1], err_msg=f"call {n}")
    apart = [_one_ulp_ties(t, j) for t, j in zip(tcalls, jcalls)]
    if not int8:
        assert not any(apart), apart
