"""Kernel B1 (flash attention over one cache layer) of the PyTorch port.

The plain versions (the CPU path of the wrapper) are held against the JAX
package's Pallas kernel in interpret mode, on the same numpy inputs, at the
production head dim 128 and the 7B's GQA ratio rep = 7 (Hq=14, Hkv=2), on a
stacked cache read at layer 1: the bf16-cache mode, and the int8 and int8k
caches on the int8-QK route; unified causal and pure past, with the lse
and the f32 output.
The CUDA kernel is held against the plain version on the card in
test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quickvideo_tpu.ops.flash_attention import flash_past_attention as jax_flash
from quickvideo_tpu_torch.ops.attention import (
    cache_attention,
    quantize_q,
)
from quickvideo_tpu_torch.ops.flash_attention import flash_past_attention

torch.set_num_threads(2)

HQ, HKV, D, CAP, LAYERS = 14, 2, 128, 1024, 2
SCALE = D ** -0.5
# f32 on both sides; only summation order and exp/log2 rounding differ
ATOL = RTOL = 2e-5


def _inputs(g, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((HQ, g, D)).astype(np.float32)
    k = rng.standard_normal((LAYERS, HKV, CAP, D)).astype(np.float32)
    v = rng.standard_normal((LAYERS, HKV, CAP, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("g", [1, 37, 300])
@pytest.mark.parametrize("where", ["zero", "mid", "edge"])
def test_plain_matches_pallas_unified_causal(g, where):
    length = {"zero": 0, "mid": 411, "edge": CAP - g}[where]
    q, k, v = _inputs(g, seed=g + length)
    ref = jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(length),
        scale=SCALE, causal=True, layer_idx=jnp.int32(1), block_q=128,
        block_k=256, interpret=True,
    ).out
    got, lse = flash_past_attention(
        torch.from_numpy(q), torch.from_numpy(k)[1], torch.from_numpy(v)[1],
        length, SCALE,
    )
    assert lse is None
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_cpu_wrapper_is_the_plain_version_on_a_layer_view():
    q, k, v = _inputs(5, seed=0)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    for mode in (dict(), dict(causal=False, with_lse=True)):
        got = flash_past_attention(qt, kt[1], vt[1], 7, SCALE, **mode)
        want = cache_attention(qt, kt[1].clone(), vt[1].clone(), 7, SCALE,
                               **mode)
        assert all(a is b is None or torch.equal(a, b)
                   for a, b in zip(got, want))


def test_overflowing_group_raises():
    q, k, v = _inputs(8, seed=0)
    with pytest.raises(ValueError, match="capacity"):
        flash_past_attention(
            torch.from_numpy(q), torch.from_numpy(k)[0],
            torch.from_numpy(v)[0], CAP - 4, SCALE,
        )


def _int8_cache(seed, v_int8=True):
    """A stacked int8 cache quantized by the JAX package's quantize_kv,
    as numpy: K codes and scales, and V codes and scales or V in f32."""
    from quickvideo_tpu.ops.kv_cache import quantize_kv as jax_quantize_kv

    rng = np.random.default_rng(seed)
    k = rng.standard_normal((LAYERS, HKV, CAP, D)).astype(np.float32)
    v = rng.standard_normal((LAYERS, HKV, CAP, D)).astype(np.float32)
    k = k * rng.uniform(0.2, 3.0, (LAYERS, HKV, CAP, 1)).astype(np.float32)
    kq, ks = zip(*(jax_quantize_kv(jnp.asarray(x)) for x in k))
    out = {"k": np.stack(kq), "k_scale": np.stack(ks), "v": v,
           "v_scale": None}
    if v_int8:
        vq, vs = zip(*(jax_quantize_kv(jnp.asarray(x)) for x in v))
        out["v"], out["v_scale"] = np.stack(vq), np.stack(vs)
    return {n: None if a is None else np.asarray(a) for n, a in out.items()}


# f32 activations on both sides and identical int8 codes (q codes are
# pinned by test_q_quantization_equals_the_jax_wrappers): the scores are
# exact int32 products times the same scales, so only the online softmax's
# rescaling and summation order differ
INT8_ATOL = INT8_RTOL = 2e-5


@pytest.mark.parametrize("v_int8", [True, False], ids=["int8", "int8k"])
@pytest.mark.parametrize("g", [1, 37, 300])
@pytest.mark.parametrize("where", ["zero", "mid", "edge"])
def test_int8_plain_matches_pallas_int8_qk(g, where, v_int8):
    length = {"zero": 0, "mid": 411, "edge": CAP - g}[where]
    rng = np.random.default_rng(g + length)
    q = rng.standard_normal((HQ, g, D)).astype(np.float32) * 2.0
    c = _int8_cache(g + length + 1, v_int8)
    vs = c["v_scale"]
    ref = jax_flash(
        jnp.asarray(q), jnp.asarray(c["k"]), jnp.asarray(c["v"]),
        jnp.int32(length), scale=SCALE, causal=True, layer_idx=jnp.int32(1),
        block_q=128, block_k=256, interpret=True,
        k_scale=jnp.asarray(c["k_scale"][1]),
        v_scale=None if vs is None else jnp.asarray(vs[1]),
        int8_qk=True,
    ).out
    got, _ = flash_past_attention(
        torch.from_numpy(q), torch.from_numpy(c["k"])[1],
        torch.from_numpy(c["v"])[1], length, SCALE,
        k_scale=torch.from_numpy(c["k_scale"])[1],
        v_scale=None if vs is None else torch.from_numpy(vs)[1],
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=INT8_ATOL,
                               rtol=INT8_RTOL)


@pytest.mark.parametrize("rows", [1, 37, 3600])
def test_q_quantization_equals_the_jax_wrappers(rows):
    """quantize_q is bit-identical to the JAX wrapper's int8-QK q
    quantization (flash_attention.py:304-312), zero rows included."""
    from quickvideo_tpu.ops.flash_attention import LOG2E as JAX_LOG2E

    rng = np.random.default_rng(rows)
    q = rng.standard_normal((4, rows, D)).astype(np.float32)
    q *= rng.uniform(0.01, 40.0, (4, rows, 1)).astype(np.float32)
    q[1, 0] = 0.0
    qf = jnp.asarray(q) * (SCALE * JAX_LOG2E)
    qs = jnp.maximum(jnp.max(jnp.abs(qf), axis=-1, keepdims=True), 1e-20) / 127.0
    q8 = jnp.clip(jnp.round(qf / qs), -127, 127).astype(jnp.int8)
    got8, got_s = quantize_q(torch.from_numpy(q), SCALE)
    np.testing.assert_array_equal(got8.numpy(), np.asarray(q8))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(qs)[..., 0])
    assert got8.dtype == torch.int8 and got_s.dtype == torch.float32


def test_int8_wrapper_rejects_v_scale_without_k_scale():
    q, k, v = _inputs(4, seed=0)
    with pytest.raises(ValueError, match="v_scale"):
        flash_past_attention(
            torch.from_numpy(q), torch.from_numpy(k)[0],
            torch.from_numpy(v)[0], 0, SCALE,
            v_scale=torch.ones(HKV, CAP),
        )


# lse: f32 on both sides from the same scores; the Pallas kernel forms it
# as m * ln 2 + ln(l) from its log2-space max, the plain version from the
# natural-log max: ~1e-6 of an lse of magnitude <= 20
LSE_ATOL = 2e-5


@pytest.mark.parametrize("cache", ["f32", "int8", "int8k"])
@pytest.mark.parametrize("causal", [False, True], ids=["past", "unified"])
@pytest.mark.parametrize("g", [1, 37, 300])
@pytest.mark.parametrize("where", ["zero", "mid", "full"])
def test_plain_lse_and_pure_past_match_pallas(cache, causal, g, where):
    """B1's lse output in both modes (pure past with the f32 output the
    query-based merge takes), every cache variant, against the Pallas
    kernel in interpret mode: out and lse. Pure past over an empty cache
    gives out 0 and lse NEG_INF, as the Pallas finalize does."""
    full = CAP if not causal else CAP - g
    length = {"zero": 0, "mid": 411, "full": full}[where]
    rng = np.random.default_rng(3 * g + length + causal)
    q = rng.standard_normal((HQ, g, D)).astype(np.float32) * 2.0
    if cache == "f32":
        c = {"k": _inputs(1, g + length)[1], "k_scale": None, "v_scale": None}
        c["v"] = _inputs(1, g + length + 1)[2]
    else:
        c = _int8_cache(g + length + 2, v_int8=cache == "int8")
    ks, vs = c["k_scale"], c["v_scale"]
    ref = jax_flash(
        jnp.asarray(q), jnp.asarray(c["k"]), jnp.asarray(c["v"]),
        jnp.int32(length), scale=SCALE, causal=causal,
        layer_idx=jnp.int32(1), block_q=128, block_k=256, interpret=True,
        k_scale=None if ks is None else jnp.asarray(ks[1]),
        v_scale=None if vs is None else jnp.asarray(vs[1]),
        out_dtype=jnp.float32, with_lse=True,
    )
    got, lse = flash_past_attention(
        torch.from_numpy(q), torch.from_numpy(c["k"])[1],
        torch.from_numpy(c["v"])[1], length, SCALE,
        k_scale=None if ks is None else torch.from_numpy(ks)[1],
        v_scale=None if vs is None else torch.from_numpy(vs)[1],
        causal=causal, with_lse=True, out_dtype=torch.float32,
    )
    assert got.dtype == lse.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.out), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref.lse),
                               atol=LSE_ATOL, rtol=0)
    if length == 0 and not causal:
        assert not got.any() and bool((lse == -1e30).all())


@pytest.mark.parametrize("cache", ["int8", "int8k"])
@pytest.mark.parametrize("where", ["zero", "mid", "full"])
def test_int8_pure_past_lse_at_the_query_based_group_shape(cache, where):
    """G = 20 pure past with the lse (the shape of the query-based mode's
    prompt rows, which the decode kernel serves) on the int8 and int8k
    caches, against the Pallas kernel in interpret mode, as above."""
    test_plain_lse_and_pure_past_match_pallas(cache, False, 20, where)
