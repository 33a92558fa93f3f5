"""Decoder layers of the PyTorch port against the JAX package's, layer by
layer: hidden states, retained index sets and cache contents, over two
groups (the second attends a non-empty past), tiny preset in f32."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quickvideo_tpu.models.qwen25_vl import get_config
from quickvideo_tpu.models.qwen25_vl import language as jlang
from quickvideo_tpu.models.qwen25_vl import model as jmodel
from quickvideo_tpu.ops import kv_cache as jkv
from quickvideo_tpu_torch.models.qwen25_vl import language as tlang
from quickvideo_tpu_torch.models.qwen25_vl.convert import params_from_jax
from quickvideo_tpu_torch.models.qwen25_vl.rope import mrope_cos_sin
from quickvideo_tpu_torch.ops import kv_cache as tkv

torch.set_num_threads(2)

CFG = get_config("tiny")
T = CFG.text
ATOL = RTOL = 1e-5  # f32 on both sides, 3 layers


@pytest.fixture(scope="module")
def params():
    jp = jmodel.init_params(CFG, seed=0, dtype=jnp.float32)["language"]
    return jp, params_from_jax({"language": jax.tree.map(np.asarray, jp)})["language"]


@pytest.mark.parametrize("top_p", [None, 0.5])
def test_layer_by_layer_matches_jax(params, top_p):
    jp, tp = params
    rng = np.random.default_rng(0)
    groups = [96, 80]
    cap = 512
    pos = np.stack([np.arange(sum(groups) + 8)] * 3)
    pos[1, 20:60] //= 3  # some spatial structure in the mRoPE axes
    cos_t, sin_t = mrope_cos_sin(pos, T.head_dim, T.mrope_section, T.rope_theta, "cpu")
    cos_j, sin_j = jnp.asarray(cos_t.numpy()), jnp.asarray(sin_t.numpy())

    jk = jnp.zeros((T.num_hidden_layers, T.num_key_value_heads, cap, T.head_dim))
    jv = jnp.zeros_like(jk)
    jlen = [0] * T.num_hidden_layers
    tcache = tkv.init_cache(
        T.num_hidden_layers, T.num_key_value_heads, cap, T.head_dim,
        dtype=torch.float32,
    )
    off = 0
    for g in groups:
        keep = int(g * top_p) if top_p else 0
        spec = jlang.StepSpec(cfg=T, q_len=g, keep_k=keep)
        x0 = rng.standard_normal((g, T.hidden_size)).astype(np.float32)
        xj, xt = jnp.asarray(x0), torch.from_numpy(x0)
        rows = slice(off, off + g)
        for li in range(T.num_hidden_layers):
            lp = jax.tree.map(lambda a: a[li], jp["layers"])
            xj, jk, jv, _, _, idx_j = jlang.layer_step(
                lp, xj, cos_j[rows], sin_j[rows], jk, jv,
                jnp.int32(jlen[li]), None, spec, li=li,
            )
            xt, idx_t = tlang.layer_step(
                tp["layers"][li], xt, cos_t[rows], sin_t[rows], tcache, li,
                T, tlang.StepSpec(q_len=g, keep_k=keep),
            )
            np.testing.assert_allclose(
                xt.numpy(), np.asarray(xj), atol=ATOL, rtol=RTOL,
                err_msg=f"hidden, group at {off}, layer {li}",
            )
            if keep:
                np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
            else:
                assert idx_t is None and idx_j is None
            jlen[li] += keep or g
            tcache.lengths[li] += keep or g
        off += g
    for li in range(T.num_hidden_layers):
        n = jlen[li]
        np.testing.assert_allclose(
            tcache.k[li, :, :n].numpy(), np.asarray(jk[li, :, :n]), atol=ATOL
        )
        np.testing.assert_allclose(
            tcache.v[li, :, :n].numpy(), np.asarray(jv[li, :, :n]), atol=ATOL
        )


def test_prefill_and_decode_steps_match_jax(params):
    """Whole-stack prefill_step, then decode_step logits, against the JAX
    scan versions on the same cache."""
    jp, tp = params
    rng = np.random.default_rng(1)
    g, cap = 50, 256
    pos = np.stack([np.arange(g + 1)] * 3)
    cos_t, sin_t = mrope_cos_sin(pos, T.head_dim, T.mrope_section, T.rope_theta, "cpu")
    cos_j, sin_j = jnp.asarray(cos_t.numpy()), jnp.asarray(sin_t.numpy())
    x0 = rng.standard_normal((g, T.hidden_size)).astype(np.float32)

    jc = jkv.init_cache(T.num_hidden_layers, T.num_key_value_heads, cap,
                        T.head_dim, dtype=jnp.float32)
    spec = jlang.StepSpec(cfg=T, q_len=g, keep_k=0)
    jc, hj = jlang.prefill_step(jp, jc, jnp.asarray(x0), cos_j[:g], sin_j[:g],
                                jax.random.key(0), spec)
    tc = tkv.init_cache(T.num_hidden_layers, T.num_key_value_heads, cap,
                        T.head_dim, dtype=torch.float32)
    ht, _ = tlang.prefill_step(tp, tc, torch.from_numpy(x0), cos_t[:g], sin_t[:g], T)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=ATOL, rtol=RTOL)
    assert tc.lengths == np.asarray(jc.length).tolist()

    dspec = dataclasses.replace(spec, q_len=1)
    jc, lj = jlang.decode_step(jp, jc, jnp.int32(17), cos_j[g:], sin_j[g:], dspec)
    lt = tlang.decode_step(tp, tc, torch.tensor([17]), cos_t[g:], sin_t[g:], T)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=RTOL)
    assert tc.lengths == np.asarray(jc.length).tolist()


def test_cache_append_past_capacity_raises():
    c = tkv.init_cache(1, 2, 16, 4, dtype=torch.float32)
    with pytest.raises(ValueError, match="overflows"):
        tkv.stacked_append(c, 0, 10, torch.zeros(2, 7, 4), torch.zeros(2, 7, 4))


@pytest.fixture(scope="module")
def params_int8():
    from quickvideo_tpu.ops import quantization as jq

    jp = jax.tree.map(
        np.asarray, jmodel.init_params(CFG, seed=0, dtype=jnp.float32)
    )["language"]
    # the JAX quantizer donates its input: give it a copy
    jqp = jax.tree.map(np.asarray, jq.quantize_language_params(
        jax.tree.map(jnp.array, jp)
    ))
    return jax.tree.map(jnp.asarray, jqp), params_from_jax(
        {"language": jqp}
    )["language"]


# int8 weights with act-quant on every product. The int32 products are
# exact and the codes come out identical, so only f32 sums differ (measured
# 1.5e-7 of the hidden states' scale, 2.7e-7 of the logits'); one flipped
# code would show as ~1e-4
INT8_ATOL = 1e-5


def _lower_gates(monkeypatch):
    from quickvideo_tpu.ops import quantization as jq
    from quickvideo_tpu_torch.ops import quantization as tq

    monkeypatch.setattr(jq, "_ACT_MIN_DIM", 16)
    monkeypatch.setattr(tq, "ACT_MIN_DIM", 16)


def test_int8_prefill_and_decode_steps_match_jax(params_int8, monkeypatch):
    """int8 weights, both packages' _ACT_MIN_DIM lowered so that every
    product of the tiny stack is act-quantized: prefill_step hidden states
    and the weight-only decode logits."""
    _lower_gates(monkeypatch)
    jp, tp = params_int8
    rng = np.random.default_rng(2)
    g, cap = 40, 256
    pos = np.stack([np.arange(g + 1)] * 3)
    cos_t, sin_t = mrope_cos_sin(pos, T.head_dim, T.mrope_section, T.rope_theta, "cpu")
    cos_j, sin_j = jnp.asarray(cos_t.numpy()), jnp.asarray(sin_t.numpy())
    ids = rng.integers(0, T.vocab_size, g)
    xj = jlang.embed_tokens(jp, jnp.asarray(ids))
    xt = tlang.embed_tokens(tp, torch.from_numpy(ids))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-6)

    jc = jkv.init_cache(T.num_hidden_layers, T.num_key_value_heads, cap,
                        T.head_dim, dtype=jnp.float32)
    spec = jlang.StepSpec(cfg=T, q_len=g, keep_k=0)
    jc, hj = jlang.prefill_step(jp, jc, xj, cos_j[:g], sin_j[:g],
                                jax.random.key(0), spec)
    tc = tkv.init_cache(T.num_hidden_layers, T.num_key_value_heads, cap,
                        T.head_dim, dtype=torch.float32)
    ht, _ = tlang.prefill_step(tp, tc, xt, cos_t[:g], sin_t[:g], T)
    hj = np.asarray(hj)
    np.testing.assert_allclose(ht.numpy(), hj, atol=INT8_ATOL * np.abs(hj).max())

    dspec = dataclasses.replace(spec, q_len=1)
    jc, lj = jlang.decode_step(jp, jc, jnp.int32(17), cos_j[g:], sin_j[g:], dspec)
    lt = tlang.decode_step(tp, tc, torch.tensor([17]), cos_t[g:], sin_t[g:], T)
    lj = np.asarray(lj)
    np.testing.assert_allclose(lt.numpy(), lj, atol=INT8_ATOL * np.abs(lj).max())


def test_int8_final_prefill_rows_act_like_the_padded_bucket(params_int8,
                                                            monkeypatch):
    """A 5-row suffix: the JAX package runs it as a 32-row bucket, whose
    products pass the 16-row gate; the port's exact-length final prefill
    (min_rows=0) must act-quantize the same, and by default (decode-sized
    rows) it would not."""
    _lower_gates(monkeypatch)
    jp, tp = params_int8
    rng = np.random.default_rng(3)
    n, bucket, cap = 5, 32, 64
    pos = np.stack([np.arange(bucket)] * 3)
    cos_t, sin_t = mrope_cos_sin(pos, T.head_dim, T.mrope_section, T.rope_theta, "cpu")
    x0 = rng.standard_normal((bucket, T.hidden_size)).astype(np.float32)
    jc = jkv.init_cache(T.num_hidden_layers, T.num_key_value_heads, cap,
                        T.head_dim, dtype=jnp.float32)
    spec = jlang.StepSpec(cfg=T, q_len=bucket, keep_k=0)
    _, hj = jlang.prefill_step(
        jp, jc, jnp.asarray(x0), jnp.asarray(cos_t.numpy()),
        jnp.asarray(sin_t.numpy()), jax.random.key(0), spec,
    )
    hj = np.asarray(hj)[:n]  # causal: the pad rows do not reach these

    def port(min_rows):
        tc = tkv.init_cache(T.num_hidden_layers, T.num_key_value_heads, cap,
                            T.head_dim, dtype=torch.float32)
        h, _ = tlang.prefill_step(tp, tc, torch.from_numpy(x0[:n]),
                                  cos_t[:n], sin_t[:n], T, min_rows=min_rows)
        return h.numpy()

    scale = np.abs(hj).max()
    # measured: 1.8e-8 with min_rows=0, 1.9e-4 with the default gate
    assert np.abs(port(0) - hj).max() <= 1e-6 * scale
    assert np.abs(port(None) - hj).max() > 2e-5 * scale


def test_logits_keep_the_f32_product():
    """bf16 weights: compute_logits returns the f32 accumulator of the head
    product (the JAX package's qdot), not a bf16-rounded one, which would
    be off by up to half a bf16 step (~2e-3 of the magnitude)."""
    gen = torch.Generator().manual_seed(5)
    p = {
        "norm": torch.ones(T.hidden_size).bfloat16(),
        "lm_head": (torch.randn(T.hidden_size, T.vocab_size, generator=gen)
                    * 0.5).bfloat16(),
    }
    h = torch.randn(3, T.hidden_size, generator=gen).bfloat16()
    got = tlang.compute_logits(p, h, T)
    hn = tlang.rms_norm(h, p["norm"], T.rms_norm_eps)
    ref = hn.float() @ p["lm_head"].float()
    assert got.dtype == torch.float32
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


def _assert_codes_close(q, s, jq, js, n):
    """The K or V rows both caches hold come from hidden states that agree
    to f32 summation order (ATOL), so a row scale may differ by an ulp and a
    code sitting on a rounding boundary may flip by one."""
    q, jq = q[:, :, :n].numpy().astype(np.int32), np.asarray(jq)[:, :, :n]
    s, js = s[:, :, :n].numpy(), np.asarray(js)[:, :, :n]
    np.testing.assert_allclose(s, js, rtol=1e-5)
    diff = np.abs(q - jq)
    # measured: every code equal, scales within 6e-7 relative
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999


@pytest.mark.parametrize("quant", [True, "k"], ids=["int8", "int8k"])
@pytest.mark.parametrize("top_p", [None, 0.5])
def test_int8_kv_layers_match_jax_hot_route(params, monkeypatch, quant,
                                            top_p):
    """int8 / int8k KV cache, two groups then a decode step: the port's
    layer_step against the JAX package's hot route (attn_impl="pallas",
    QV_PALLAS_INTERPRET=1): hidden states, retained sets, and the cache's
    codes and scales."""
    monkeypatch.setenv("QV_PALLAS_INTERPRET", "1")
    jp, tp = params
    rng = np.random.default_rng(4)
    groups, cap = [96, 80], 4096  # the JAX int8 kernel tiles 128-slot blocks
    pos = np.stack([np.arange(sum(groups) + 1)] * 3)
    pos[1, 20:60] //= 3
    cos_t, sin_t = mrope_cos_sin(pos, T.head_dim, T.mrope_section, T.rope_theta, "cpu")
    cos_j, sin_j = jnp.asarray(cos_t.numpy()), jnp.asarray(sin_t.numpy())
    jc = jkv.init_cache(T.num_hidden_layers, T.num_key_value_heads, cap,
                        T.head_dim, dtype=jnp.float32, quantized=quant)
    tc = tkv.init_cache(T.num_hidden_layers, T.num_key_value_heads, cap,
                        T.head_dim, dtype=torch.float32, quantized=quant)
    assert tc.quantized == quant
    off = 0
    for g in groups:
        keep = int(g * top_p) if top_p else 0
        spec = jlang.StepSpec(cfg=T, q_len=g, keep_k=keep, attn_impl="pallas",
                              kv_quant=quant)
        x0 = rng.standard_normal((g, T.hidden_size)).astype(np.float32)
        rows = slice(off, off + g)
        jc, hj = jlang.prefill_step(jp, jc, jnp.asarray(x0), cos_j[rows],
                                    sin_j[rows], jax.random.key(0), spec)
        ht, _ = tlang.prefill_step(tp, tc, torch.from_numpy(x0), cos_t[rows],
                                   sin_t[rows], T,
                                   tlang.StepSpec(q_len=g, keep_k=keep))
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=ATOL,
                                   rtol=RTOL, err_msg=f"group at {off}")
        assert tc.lengths == np.asarray(jc.length).tolist()
        off += g
    n = tc.lengths[0]
    _assert_codes_close(tc.k, tc.k_scale, jc.k, jc.k_scale, n)
    if quant is True:
        _assert_codes_close(tc.v, tc.v_scale, jc.v, jc.v_scale, n)
    else:
        assert tc.v_scale is None and jc.v_scale is None
        np.testing.assert_allclose(tc.v[:, :, :n].numpy(),
                                   np.asarray(jc.v)[:, :, :n], atol=ATOL)
    dspec = jlang.StepSpec(cfg=T, q_len=1, keep_k=0, attn_impl="pallas",
                           kv_quant=quant)
    jc, lj = jlang.decode_step(jp, jc, jnp.int32(17), cos_j[off:],
                               sin_j[off:], dspec)
    lt = tlang.decode_step(tp, tc, torch.tensor([17]), cos_t[off:],
                           sin_t[off:], T)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=RTOL)


def test_quantize_kv_equals_the_jax_package():
    """Codes and scales bit-identical to quickvideo_tpu.ops.kv_cache.
    quantize_kv, zero rows (scale 1e-8) and rows with ties included;
    dequantize_kv likewise."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 300, 128)).astype(np.float32)
    x *= rng.uniform(1e-3, 30.0, (4, 300, 1)).astype(np.float32)
    x[0, 0] = 0.0
    x[1, 1] = np.arange(128, dtype=np.float32) - 63.5  # scale 0.5: x / s ties
    jq, js = jkv.quantize_kv(jnp.asarray(x))
    tq, ts = tkv.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tkv.dequantize_kv(tq, ts).numpy(),
        np.asarray(jkv.dequantize_kv(jq, js)),
    )


@pytest.mark.parametrize("quant", [True, "k"], ids=["int8", "int8k"])
def test_quantized_append_writes_codes_and_scales(quant):
    c = tkv.init_cache(2, 2, 64, 8, dtype=torch.float32, quantized=quant)
    k = torch.randn(2, 5, 8)
    v = torch.randn(2, 5, 8)
    tkv.stacked_append(c, 1, 3, k, v)
    kq, ks = tkv.quantize_kv(k)
    assert torch.equal(c.k[1, :, 3:8], kq) and torch.equal(c.k_scale[1, :, 3:8], ks)
    assert not c.k[0].any() and not c.k_scale[0].any()
    if quant is True:
        vq, vs = tkv.quantize_kv(v)
        assert torch.equal(c.v[1, :, 3:8], vq) and torch.equal(c.v_scale[1, :, 3:8], vs)
    else:
        assert c.v.dtype == torch.float32 and c.v_scale is None
        assert torch.equal(c.v[1, :, 3:8], v)
