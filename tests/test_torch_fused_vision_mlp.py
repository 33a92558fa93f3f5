"""Kernels B3, B4 and B6 of the PyTorch port (ops/fused_vision_mlp.py, their
plain versions on the CPU) against the JAX package's Pallas kernels run in
interpret mode, on the same numpy inputs, and the weight prep against
`fuse_vision_mlp_weights`.

Tolerances. The prologue's f32 row sum and rsqrt differ from XLA's by an
ulp in about half the rows (XLA's order even changes with the block shape
inside the kernel); that flips a bf16 rounding of the normed row now and
then, and where the flipped value is the row's largest, the row's int8
scale moves by one bf16 step (at most 2^-7 relative) and its codes change.
So at least 98% of the rows must come out identical (B3) or with row
scales within 1e-5 relative and dequantized outputs within one step of
their own row's scale (B4, B6; silu's exp may differ by ulps); every row's
scale within 2^-7 relative, and B3's every output within the JAX suite's
own atol = rtol = 0.05 (tests/test_fused_vision_mlp.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quickvideo_tpu.models.qwen25_vl import get_config
from quickvideo_tpu.ops import fused_vision_mlp as JF
from quickvideo_tpu.ops import quantization as jq
from quickvideo_tpu_torch.ops import fused_vision_mlp as TF
from quickvideo_tpu_torch.ops import quantization as tq

torch.set_num_threads(2)

C, I = 64, 150  # I pads to 192 here (PAD 64) and to 256 in the JAX prep
VCFG = dataclasses.replace(
    get_config("tiny").vision, hidden_size=C, intermediate_size=I
)
EPS = VCFG.rms_norm_eps


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, np.float32 if dtype else None))
    return t.to(dtype) if dtype else t


def _bf16(a):
    return jnp.asarray(a, jnp.bfloat16), _t(jnp.asarray(a, jnp.bfloat16),
                                            torch.bfloat16)


def _quant_w(rng, shape):
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    return jq.quantize_weight(jnp.asarray(w)), tq.quantize_weight(_t(w))


def _block(seed=0):
    """One quantized MLP block in both packages' layouts (stacked for JAX,
    a per-block dict for the port) and both preps."""
    rng = np.random.default_rng(seed)
    jb, tb = {}, {}
    for k, shape in (("wg", (C, I)), ("wu", (C, I)), ("wd", (I, C))):
        jb[k], tb[k] = _quant_w(rng, shape)
    for k, n in (("bg", I), ("bu", I), ("bd", C)):
        jb[k], tb[k] = _bf16(rng.standard_normal(n) * 0.05)
    jstack = JF.fuse_vision_mlp_weights(
        {"blocks": jax.tree.map(lambda a: a[None], jb)}, VCFG
    )["blocks"]
    jprep = jax.tree.map(lambda a: a[0], jstack)
    tprep = TF.fuse_vision_mlp_weights({"blocks": [tb]}, VCFG)["blocks"][0]
    return jprep, tprep


def _rows(s_len, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((s_len, C)) * 0.3
    x[3] = 0.0  # a zero row: variance 0 -> all-zero codes
    ln = 1.0 + rng.standard_normal(C) * 0.1
    return _bf16(x), _bf16(ln)


def test_weight_prep_matches_jax_on_the_unpadded_part():
    jp, tp = _block()
    np_ = TF._round_up(I, TF.PAD)
    jnp_ = JF._round_up(I, JF.LANE)
    assert tp["wgu_p"]["q8"].shape == (C, 2 * np_)
    assert tp["wd_p"]["q8"].shape == (np_, C)
    # column-major int8: the layout the kernels and _int_mm read
    assert tp["wgu_p"]["q8"].stride() == (1, C)
    assert tp["wd_p"]["q8"].stride() == (1, np_)
    jq8 = np.asarray(jp["wgu_p"]["q8"])
    tq8 = tp["wgu_p"]["q8"].numpy()
    jsc = np.asarray(jp["wgu_p"]["sc"]).reshape(-1)
    tsc = tp["wgu_p"]["sc"].numpy()
    jb = np.asarray(jp["bgu_p"], np.float32).reshape(-1)
    tb = tp["bgu_p"].float().numpy()
    for half in (0, 1):  # gate, up
        tj, jj = slice(half * np_, half * np_ + I), slice(
            half * jnp_, half * jnp_ + I)
        np.testing.assert_array_equal(tq8[:, tj], jq8[:, jj])
        np.testing.assert_array_equal(tsc[tj], jsc[jj])
        np.testing.assert_array_equal(tb[tj], jb[jj])
        pad = slice(half * np_ + I, (half + 1) * np_)
        assert not tq8[:, pad].any() and not tb[pad].any()
        assert (tsc[pad] == 1.0).all()
    np.testing.assert_array_equal(
        tp["wd_p"]["q8"][:I].numpy(), np.asarray(jp["wd_p"]["q8"])[:I]
    )
    assert not tp["wd_p"]["q8"][I:].any()
    for k in ("wg", "wu", "wd", "bg", "bu"):
        assert k not in tp  # B4 is the tower's one MLP route
    # idempotent, and a float tower passes through
    prepped = {"blocks": [tp]}
    assert TF.fuse_vision_mlp_weights(prepped, VCFG) is prepped
    fl = {"blocks": [{"wg": torch.zeros(4, 4)}]}
    assert TF.fuse_vision_mlp_weights(fl, VCFG) is fl


@pytest.mark.parametrize("s_len", [90, 128])
def test_prologue_codes_identical(s_len):
    (jx, tx), (jl, tl) = _rows(s_len, 1)
    jxq, jxs = JF._ln_quantize(jx, jl.reshape(1, C), EPS)
    txq, txs = TF.ln_quantize_plain(tx, tl, EPS)
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    np.testing.assert_allclose(txs.numpy(), np.asarray(jxs), rtol=1e-6)
    assert not txq[3].any()


@pytest.mark.parametrize("s_len", [90, 100, 250])
def test_ln_gemm_bias_matches_jax_interpret(s_len):
    (jx, tx), (jl, tl) = _rows(s_len, 2)
    rng = np.random.default_rng(3)
    jw, tw = _quant_w(rng, (C, 3 * C))
    jb, tb = _bf16(rng.standard_normal(3 * C) * 0.05)
    ref = np.asarray(JF.ln_gemm_bias(jx, jl, jw, jb, eps=EPS, interpret=True),
                     np.float32)
    got = TF.ln_gemm_bias(tx, tl, tw, tb, EPS)
    assert got.dtype == torch.bfloat16 and got.shape == (s_len, 3 * C)
    got = got.float().numpy()
    np.testing.assert_allclose(got, ref, atol=0.05, rtol=0.05)
    same = (got == ref).all(1)
    assert same.sum() >= 0.98 * s_len, np.nonzero(~same)
    # the zero row is the bias alone
    np.testing.assert_array_equal(got[3], tb.float().numpy())


def _check_quantized(got, ref, n_real, n_pad):
    (tq8, ts), (jq8, js) = got, ref
    assert tq8.dtype == torch.int8 and tq8.shape[1] == n_pad
    assert ts.shape == (tq8.shape[0], 1)
    assert not tq8[:, n_real:].any()  # pad columns are exact zeros
    js = np.asarray(js)
    ts = ts.numpy()
    np.testing.assert_allclose(ts, js, rtol=2 ** -7)
    same = (np.abs(ts - js) <= 1e-5 * js)[:, 0]
    assert same.sum() >= 0.98 * len(js), np.nonzero(~same)
    # a row whose scale agrees is held to one step of its own scale
    diff = np.abs(
        tq8[:, :n_real].numpy()[same].astype(np.float32) * ts[same]
        - np.asarray(jq8)[:, :n_real][same].astype(np.float32) * js[same]
    )
    assert (diff <= js[same] * 1.01).all(), np.nonzero(diff > js[same] * 1.01)


@pytest.mark.parametrize("s_len", [90, 100, 250])
def test_ln_dual_gemm_silu_quant_matches_jax_interpret(s_len):
    jp, tp = _block(4)
    (jx, tx), (jl, tl) = _rows(s_len, 5)
    ref = JF.ln_dual_gemm_silu_quant(
        jx, jl, jp["wgu_p"], jp["bgu_p"], eps=EPS, interpret=True
    )
    got = TF.ln_dual_gemm_silu_quant(tx, tl, tp["wgu_p"], tp["bgu_p"], EPS)
    _check_quantized(got, ref, I, TF._round_up(I, TF.PAD))


@pytest.mark.parametrize("s_len", [90, 250])
def test_dual_gemm_silu_quant_matches_jax_interpret(s_len):
    jp, tp = _block(6)
    rng = np.random.default_rng(7)
    jh, _ = _bf16(rng.standard_normal((s_len, C)))
    jxq, jxs = jq.quantize_act(jh)
    ref = JF.dual_gemm_silu_quant(
        jxq, jxs, jp["wgu_p"], jp["bgu_p"], interpret=True
    )
    got = TF.dual_gemm_silu_quant(
        _t(jxq), _t(jxs), tp["wgu_p"], tp["bgu_p"]
    )
    _check_quantized(got, ref, I, TF._round_up(I, TF.PAD))


def test_cpu_entries_do_not_count_launches():
    """The launch counters count kernel launches only; a CPU tensor runs
    the plain version."""
    jp, tp = _block(8)
    (_, tx), (_, tl) = _rows(20, 9)
    before = (TF.ln_gemm_bias.launches, TF.ln_dual_gemm_silu_quant.launches,
              TF.dual_gemm_silu_quant.launches)
    TF.ln_dual_gemm_silu_quant(tx, tl, tp["wgu_p"], tp["bgu_p"], EPS)
    TF.dual_gemm_silu_quant(*tq.quantize_act(tx), tp["wgu_p"], tp["bgu_p"])
    after = (TF.ln_gemm_bias.launches, TF.ln_dual_gemm_silu_quant.launches,
             TF.dual_gemm_silu_quant.launches)
    assert after == before


@pytest.mark.parametrize("steps,ok", [(1, True), (3, False)])
def test_card_check_holds_each_row_to_its_own_step(steps, ok):
    """quickvideo_tpu_torch.testing.quantized_close, the rule chip_smoke.py
    and the card tests apply to B4/B6: a code off by `steps` in the row with
    the smallest scale passes only within one step of that row's scale,
    even where it is within one step of the largest scale."""
    from quickvideo_tpu_torch.testing import quantized_close

    _, tp = _block(10)
    (_, tx), (_, tl) = _rows(64, 11)
    q, s = TF.ln_dual_gemm_silu_quant(tx, tl, tp["wgu_p"], tp["bgu_p"], EPS)
    row = int(torch.where(s[:, 0] > 2e-7, s[:, 0], s.max()).argmin())
    assert steps * s[row, 0] < s.max()  # the old rule, largest step, passes
    bad = q.clone()
    col = int(bad[row].abs().argmin())
    bad[row, col] = bad[row, col] + steps
    assert quantized_close((q, s), (q, s))[1]
    assert quantized_close((bad, s), (q, s))[1] is ok
