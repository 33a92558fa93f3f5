"""int8 weights and activations of the PyTorch port (ops/quantization.py)
against the JAX package's (quickvideo_tpu/ops/quantization.py), on the same
numpy inputs.

Tolerances: int8 codes must be identical (both round half to even, after
the same f32 division). Scales and act-quantized products agree to within
1e-6 relative (the int32 products are exact; only the f32 rescale order
could differ, and it does not). Weight-only products sum in another order
than XLA: within 1e-6 of the largest output magnitude.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quickvideo_tpu.models.qwen25_vl import get_config
from quickvideo_tpu.models.qwen25_vl import model as jmodel
from quickvideo_tpu.ops import quantization as jq
from quickvideo_tpu_torch.models.qwen25_vl.convert import (
    init_params,
    params_from_jax,
)
from quickvideo_tpu_torch.ops import quantization as tq

torch.set_num_threads(2)

REL = 1e-6


def _close(got, ref, rel=REL):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rel, atol=rel * np.abs(ref).max())


def _w(shape, seed, scale=0.02):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [-2, -1])
def test_quantize_weight_codes_identical(dtype, axis):
    w = _w((96, 80), 0)
    jw = jnp.asarray(w).astype(dtype)
    tw = torch.from_numpy(np.asarray(jw, np.float32)).to(getattr(torch, dtype))
    ref = jq.quantize_weight(jw, contract_axis=axis)
    got = tq.quantize_weight(tw, contract_axis=axis)
    np.testing.assert_array_equal(got["q8"].numpy(), np.asarray(ref["q8"]))
    _close(got["sc"].numpy(), ref["sc"])
    # matmul weights are the (in, out) view of a row-major (out, in) tensor
    assert got["q8"].t().is_contiguous() == (axis == -2)
    deq = tq.dequantize_weight(got, axis)
    _close(deq.numpy(), jq.dequantize_weight(ref, axis))


def test_quantize_act_codes_identical():
    x = _w((37, 300), 1, 1.0)
    x[5] = 0.0  # a zero row quantizes to zeros under the 1e-8 floor
    ref = jq.quantize_act(jnp.asarray(x))
    got = tq.quantize_act(torch.from_numpy(x))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    _close(got[1].numpy(), ref[1])
    assert not got[0][5].any()


def test_int_mm_is_exact():
    rng = np.random.default_rng(2)
    a = rng.integers(-127, 128, (5, 64), dtype=np.int8)
    b = rng.integers(-127, 128, (64, 24), dtype=np.int8)
    got = tq.int_mm(torch.from_numpy(a), tq.col_major(torch.from_numpy(b)))
    np.testing.assert_array_equal(
        got.numpy(), a.astype(np.int64) @ b.astype(np.int64)
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [40, 3])  # act-quant / weight-only (< 16)
def test_qdot_matches_jax(dtype, rows):
    x = _w((rows, 288), 3, 1.0)
    w = _w((288, 72), 4)
    jw = jq.quantize_weight(jnp.asarray(w))
    tw = tq.quantize_weight(torch.from_numpy(w))
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(np.asarray(jx, np.float32)).to(getattr(torch, dtype))
    ref = jq.qdot(jx, jw)
    got = tq.qdot(tx, tw)
    assert got.dtype == torch.float32
    _close(got.numpy(), ref)
    # a float weight: f32 accumulation, f32 result
    _close(tq.qdot(tx, torch.from_numpy(w).to(tx.dtype)).numpy(),
           jq.qdot(jx, jnp.asarray(w).astype(dtype)))


def test_qdot_multi_and_pre_match_jax():
    x = _w((20, 256), 5, 1.0)
    ws = [_w((256, n), 6 + n) for n in (48, 16, 16)]
    jws = [jq.quantize_weight(jnp.asarray(w)) for w in ws]
    tws = [tq.quantize_weight(torch.from_numpy(w)) for w in ws]
    ref = jq.qdot_multi(jnp.asarray(x), jws)
    got = tq.qdot_multi(torch.from_numpy(x), tws)
    for g, r in zip(got, ref):
        _close(g.numpy(), r)
    xq, xs = jq.quantize_act(jnp.asarray(x))
    _close(
        tq.qdot_pre(torch.from_numpy(np.asarray(xq)),
                    torch.from_numpy(np.asarray(xs)), tws[0]).numpy(),
        jq.qdot_pre(xq, xs, jws[0]),
    )


def test_gates_are_module_constants(monkeypatch):
    """Lowering ACT_MIN_DIM turns act-quant on for narrow inputs in both
    packages alike; min_rows=0 turns it on for few rows."""
    x = _w((20, 48), 7, 1.0)
    w = _w((48, 32), 8)
    jw = jq.quantize_weight(jnp.asarray(w))
    tw = tq.quantize_weight(torch.from_numpy(w))
    tx = torch.from_numpy(x)
    weight_only = tq.qdot(tx, tw)
    _close(weight_only.numpy(), jq.qdot(jnp.asarray(x), jw))
    monkeypatch.setattr(jq, "_ACT_MIN_DIM", 16)
    monkeypatch.setattr(tq, "ACT_MIN_DIM", 16)
    act = tq.qdot(tx, tw)
    _close(act.numpy(), jq.qdot(jnp.asarray(x), jw))
    assert not torch.equal(act, weight_only)
    # 4 rows: weight-only by default; min_rows=0 acts as the padded bucket
    _close(tq.qdot(tx[:4], tw).numpy(), jq.qdot(jnp.asarray(x[:4]), jw))
    _close(tq.qdot(tx[:4], tw, min_rows=0).numpy(), act[:4].numpy())
    # a 1-D input (the decode logits row) is weight-only in both
    _close(tq.qdot(tx[0], tw).numpy(), jq.qdot(jnp.asarray(x[0]), jw))


def test_qtake_matches_jax():
    table = _w((64, 24), 9)
    ids = np.array([3, 0, 63, 3, 17])
    jt = jq.quantize_weight(jnp.asarray(table), contract_axis=-1)
    tt = tq.quantize_weight(torch.from_numpy(table), contract_axis=-1)
    ref = jq.qtake(jt, jnp.asarray(ids), jnp.float32)
    got = tq.qtake(tt, torch.from_numpy(ids), torch.float32)
    _close(got.numpy(), ref)


def test_model_quantization_matches_jax_tree():
    """quantize_model_params of the port (in place, leaf by leaf) gives the
    codes and scales of the JAX package's, leaf for leaf, on tiny."""
    cfg = get_config("tiny")
    jp = jax.tree.map(
        np.asarray, jmodel.init_params(cfg, seed=0, dtype=jnp.float32)
    )
    # the JAX quantizer donates its input: give it a copy
    ref = params_from_jax(jax.tree.map(
        np.asarray, jq.quantize_model_params(jax.tree.map(jnp.array, jp))
    ))
    got = tq.quantize_model_params(params_from_jax(jp))

    def walk(a, b, path=""):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}/{i}")
        else:
            assert a.dtype == b.dtype and a.stride() == b.stride(), path
            if a.dtype == torch.int8:
                assert torch.equal(a, b), path
            else:
                _close(a.numpy(), b.numpy())

    walk(got, ref)
    lang = got["language"]
    assert tq.is_quantized(lang["embed"]) and tq.is_quantized(lang["lm_head"])
    assert not tq.is_quantized(lang["norm"])
    assert all(tq.is_quantized(lp[k]) for lp in lang["layers"]
               for k in tq.LANG_LAYER_KEYS)
    vis = got["vision"]
    assert all(tq.is_quantized(bp[k]) for bp in vis["blocks"]
               for k in tq.VIS_BLOCK_KEYS)
    assert tq.is_quantized(vis["merger"]["w1"])
    # idempotent: a quantized tree comes back as it is
    again = tq.quantize_model_params(got)
    assert again["language"]["embed"]["q8"] is lang["embed"]["q8"]


def test_int8_init_is_the_quantized_float_init():
    cfg = get_config("tiny")
    fl = init_params(cfg, seed=4, dtype=torch.float32)
    q = init_params(cfg, seed=4, dtype=torch.float32, param_dtype="int8")
    ref = tq.quantize_model_params(fl)
    for lp_q, lp_r in zip(q["language"]["layers"], ref["language"]["layers"]):
        for k in tq.LANG_LAYER_KEYS:
            assert torch.equal(lp_q[k]["q8"], lp_r[k]["q8"])
            assert torch.equal(lp_q[k]["sc"], lp_r[k]["sc"])
    assert torch.equal(q["language"]["embed"]["q8"],
                       ref["language"]["embed"]["q8"])
    assert torch.equal(q["vision"]["merger"]["w2"]["q8"],
                       ref["vision"]["merger"]["w2"]["q8"])
