"""Context parallelism in the PyTorch port (quickvideo_tpu_torch/parallel/
context_parallel.py, the windowed cache of ops/kv_cache.py, the engine's
sp routes) against the JAX package's (quickvideo_tpu/parallel/
context_parallel.py on the conftest's 8 virtual CPU devices).

The port's ranks are real gloo processes (tests/torch_mesh_ranks.py); the
JAX side runs in this process. Tolerances: the f32 partials and merges
differ only in summation order (2e-5, the JAX package's own CP tests'
bound); the engine runs compare greedy tokens, cache lengths, per-layer
lengths and every retained index set exactly, and the final-prefill logits
by rel. L2 (tests/test_torch_parallel.py::check_engine_against_jax).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from quickvideo_tpu.ops import attention as jattn
from quickvideo_tpu.parallel.context_parallel import (
    cp_past_attention,
    cp_stacked_append,
    cp_stacked_append_quantized,
)
from quickvideo_tpu_torch.ops.kv_cache import KVCache, init_cache
from quickvideo_tpu_torch.parallel.context_parallel import (
    in_group_partial,
    shard_cache_cp,
)
from torch_mesh_ranks import run_ranks
from test_torch_parallel import check_engine_against_jax

torch.set_num_threads(2)

HQ, HKV, D = 4, 2, 16
SCALE = D ** -0.5
ATOL = 2e-5


def _jax_mesh(sp):
    return Mesh(np.array(jax.devices()[:sp]).reshape(sp), ("sp",))


def _past_case(length, cap=64, g=12):
    """q and a cache whose slots past `length` hold garbage, as the JAX
    package's test_cp_past_matches_single_device draws them."""
    rng = np.random.default_rng(length)
    q = rng.standard_normal((HQ, g, D)).astype(np.float32)
    k = rng.standard_normal((HKV, cap, D)).astype(np.float32)
    v = rng.standard_normal((HKV, cap, D)).astype(np.float32)
    k[:, length:] = 1e3
    v[:, length:] = -1e3
    return q, k, v


PAST_CASES = [(4, 37), (8, 0), (8, 64), (2, 5)]


@pytest.fixture(scope="module")
def cp_past_results(tmp_path_factory):
    """The port's ranks, once per sp, over that sp's lengths."""
    out = {}
    for sp in sorted({sp for sp, _ in PAST_CASES}):
        tmp = tmp_path_factory.mktemp(f"cp_past_{sp}")
        cases = [(length, tuple(torch.from_numpy(a)
                                for a in _past_case(length)))
                 for s, length in PAST_CASES if s == sp]
        torch.save(cases, tmp / "tensors.pt")
        ranks = run_ranks(tmp, "cp_past", sp, scale=SCALE,
                          tensors=str(tmp / "tensors.pt"))
        out[sp] = ranks
    return out


@pytest.mark.parametrize("sp,length", PAST_CASES)
def test_cp_past_attention_matches_jax(cp_past_results, sp, length):
    """B1 pure past + lse (its plain version) on each rank's window at its
    local length, merged over gloo, against the JAX package's
    cp_past_attention on an sp mesh: out and lse on every rank, the empty
    windows (length 0, or beyond it) weighing nothing."""
    q, k, v = _past_case(length)
    sharded = NamedSharding(_jax_mesh(sp), P(None, "sp", None))
    pa = jax.jit(lambda q, k, v, l: cp_past_attention(
        q, k, v, l, scale=SCALE, mesh=_jax_mesh(sp)))(
        jnp.asarray(q), jax.device_put(jnp.asarray(k), sharded),
        jax.device_put(jnp.asarray(v), sharded), jnp.int32(length))
    for rank in cp_past_results[sp]:
        out, lse = rank["cases"][length]
        np.testing.assert_allclose(out, np.asarray(pa.out), atol=ATOL,
                                   rtol=ATOL)
        np.testing.assert_allclose(lse, np.asarray(pa.lse), atol=ATOL,
                                   rtol=ATOL)
    if length == 0:
        assert not np.any(cp_past_results[sp][0]["cases"][0][0])


@pytest.mark.parametrize("g", [12, 1])
def test_in_group_partial_matches_jaxs_dense_partial(g):
    """The in-group partial runs B1 (unified causal over an empty past,
    with lse) where the JAX package runs its dense masked partial
    (context_parallel.py:371-373): the same out and lse."""
    q, k, v = _past_case(g, cap=g, g=g)
    got = in_group_partial(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), SCALE)
    want = jattn._partial_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jattn.causal_mask(g),
                                    SCALE)
    assert got.out.dtype == torch.float32
    np.testing.assert_allclose(got.out.numpy(), np.asarray(want.out),
                               atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got.lse.numpy(), np.asarray(want.lse),
                               atol=ATOL, rtol=ATOL)


# appends at global offsets, straddling the windows of sp = 2 and 4 over a
# 32-slot, 2-layer cache: (layer, start, rows)
APPENDS = [(0, 0, 5), (0, 5, 9), (1, 0, 16), (1, 16, 3), (0, 14, 12),
           (1, 19, 13)]


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("quantized", [False, True, "k"],
                         ids=["f32", "int8", "int8k"])
def test_cp_append_matches_jax(tmp_path, sp, quantized):
    """Each rank writes the part of [start, start + m) in its window (a
    group may straddle two); the windows put together equal the JAX
    package's cp_stacked_append / cp_stacked_append_quantized on an sp
    mesh (int8 codes within one step of a rounding boundary, as in
    tests/test_torch_modes.py; f32 values and scales to 1e-6)."""
    shape = (2, HKV, 32, D)
    rng = np.random.default_rng(3)
    appends = [(li, start, torch.from_numpy(rng.standard_normal(
        (HKV, m, D)).astype(np.float32)), torch.from_numpy(
        rng.standard_normal((HKV, m, D)).astype(np.float32)))
        for li, start, m in APPENDS]
    torch.save(appends, tmp_path / "tensors.pt")
    ranks = run_ranks(tmp_path, "cp_append", sp, shape=list(shape),
                      quantized=quantized,
                      tensors=str(tmp_path / "tensors.pt"))
    mesh = _jax_mesh(sp)
    val = NamedSharding(mesh, P(None, None, "sp", None))
    sc = NamedSharding(mesh, P(None, None, "sp"))
    qdt = jnp.int8 if quantized else jnp.float32
    k = jax.device_put(jnp.zeros(shape, qdt), val)
    v = jax.device_put(jnp.zeros(shape, jnp.int8 if quantized is True
                                 else jnp.float32), val)
    ks = jax.device_put(jnp.zeros(shape[:3], jnp.float32), sc)
    vs = (jax.device_put(jnp.zeros(shape[:3], jnp.float32), sc)
          if quantized is True else None)
    @jax.jit
    def append_all(k, v, ks, vs, rows):
        for (li, start, _), (kn, vn) in zip(APPENDS, rows):
            if quantized:
                k, v, ks, vs = cp_stacked_append_quantized(
                    k, v, ks, vs, li, jnp.int32(start), kn, vn, mesh=mesh)
            else:
                k, v = cp_stacked_append(k, v, li, jnp.int32(start), kn, vn,
                                         mesh=mesh)
        return k, v, ks, vs

    k, v, ks, vs = append_all(k, v, ks, vs, [
        (jnp.asarray(kn.numpy()), jnp.asarray(vn.numpy()))
        for _, _, kn, vn in appends])
    want = dict(k=k, v=v, k_scale=ks if quantized else None, v_scale=vs)
    for name, ref in want.items():
        parts = [r[name] for r in ranks]
        if ref is None:
            assert all(p is None for p in parts), name
            continue
        got = torch.cat(parts, dim=2).float().numpy()
        tol = 1 if ref.dtype == jnp.int8 else 1e-6
        np.testing.assert_allclose(got, np.asarray(ref, np.float32),
                                   atol=tol, err_msg=name)


def test_a_capacity_that_sp_does_not_divide_raises():
    """As the JAX package's cp functions do: the cache of a rank, and the
    window cut from a whole cache."""
    with pytest.raises(ValueError, match="not divisible"):
        init_cache(1, HKV, 30, D, sp_index=0, sp_size=4)
    whole = KVCache(k=torch.zeros(1, HKV, 30, D), v=torch.zeros(1, HKV, 30, D),
                    lengths=[0])
    with pytest.raises(ValueError, match="not divisible"):
        shard_cache_cp(whole, 0, 4)


def test_windows_cover_the_cache():
    """Local lengths of each window: clip(length - start, 0, C / sp)."""
    caches = [init_cache(1, HKV, 64, D, sp_index=i, sp_size=4)
              for i in range(4)]
    assert [c.capacity for c in caches] == [64] * 4
    assert [c.window_start for c in caches] == [0, 16, 32, 48]
    assert [c.local_length(37) for c in caches] == [16, 16, 5, 0]
    assert [c.local_length(0) for c in caches] == [0, 0, 0, 0]
    assert [c.local_length(64) for c in caches] == [16] * 4


# the engine on sp meshes (keywords of both packages' LVUConfig)
SP_CASES = {
    "sp2": ({"sp": 2}, {}),
    "sp4": ({"sp": 4}, {}),
    "sp2_int8_kv": ({"sp": 2}, dict(kv_cache_dtype="int8")),
    "sp2_int8k_kv": ({"sp": 2}, dict(kv_cache_dtype="int8k")),
    "sp2_attention_weights_sum": (
        {"sp": 2}, dict(top_k_predict_type="attention_weights_sum")),
    "sp2_query_based": ({"sp": 2}, dict(query_based=True)),
}


@pytest.mark.parametrize("case", sorted(SP_CASES))
def test_sp_engine_matches_the_jax_engine(tmp_path, monkeypatch, case):
    """LVUEngine on an sp mesh of gloo ranks against the JAX engine on the
    same sp mesh: greedy tokens, cache lengths (capacities of the 4096 * sp
    quantum), every retained index set, the final-prefill logits; the ranks
    agree with each other exactly."""
    mesh_kw, kw = SP_CASES[case]
    ranks = check_engine_against_jax(tmp_path, monkeypatch, mesh_kw, kw)
    sp = mesh_kw["sp"]
    for r in ranks:
        assert r["capacity"] % (4096 * sp) == 0
        assert r["local_shape"][2] == r["capacity"] // sp
