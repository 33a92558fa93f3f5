"""Kernels B2 (block-diagonal vision attention, fused rotary) and B5
(the same, rotary outside, optional column validity) of the port.

B2's plain version is held against the JAX package's Pallas kernel
`block_diag_attention_2d` in interpret mode at head dim 80. The JAX kernel
takes heads padded to 128 lanes; the test pads q/k/v and cos/sin on the way
in and drops the pad lanes on the way out. B5's plain version is held
against the JAX package's `block_diag_attention` in interpret mode, and,
for spans its tiling rule rejects, against its XLA `_block_attention`, at
the JAX package's own tolerance (tests/test_vision_attention.py: 2e-5, f32
on both sides).
In bf16, B2's plain version and the rotary's plain version are held
against the JAX package at its rounding points (C14): tables cast to bf16,
each rotary product and the sum rounded to bf16.
The CUDA kernels are held against the plain versions on the card in
test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quickvideo_tpu.models.qwen25_vl import vision as jvision
from quickvideo_tpu.ops import vision_attention as jva
from quickvideo_tpu_torch.ops.vision_attention import (
    apply_vision_rotary,
    block_diag_attention,
    block_diag_attention_2d,
    block_diag_attention_2d_plain,
    block_diag_attention_plain,
    kernel_applicable,
    vision_rotary,
)

torch.set_num_threads(2)

NH, HD, DP = 2, 80, 128
SCALE = HD ** -0.5
ATOL = RTOL = 2e-5  # f32 on both sides


def _inputs(s, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((s, NH, HD)).astype(np.float32)
               for _ in range(3))
    ang = rng.uniform(0, 6.28, (s, HD // 2))
    emb = np.concatenate([ang, ang], axis=-1)
    return q, k, v, np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


def _pad_heads(x):  # (S, nh, 80) -> (S, nh*128), pad lanes zero
    s = x.shape[0]
    xp = np.zeros((s, NH, DP), np.float32)
    xp[:, :, :HD] = x
    return jnp.asarray(xp.reshape(s, NH * DP))


def _pallas(q, k, v, cos, sin, span):
    pad = ((0, 0), (0, DP - HD))
    out = jva.block_diag_attention_2d(
        _pad_heads(q), _pad_heads(k), _pad_heads(v), span, scale=SCALE,
        nh=NH, dp=DP, cos=jnp.asarray(np.pad(cos, pad)),
        sin=jnp.asarray(np.pad(sin, pad)), rot_half=HD // 2, interpret=True,
    )
    return np.asarray(out).reshape(-1, NH, DP)[:, :, :HD]


@pytest.mark.parametrize(
    "span,nspan",
    [(64, 4), (48, 3), (36, 4), (16, 8)],  # uniform windows, ragged buckets
)
def test_plain_matches_pallas_2d(span, nspan):
    q, k, v, cos, sin = _inputs(span * nspan, seed=span)
    ref = _pallas(q, k, v, cos, sin, span)
    got = block_diag_attention_2d_plain(
        *(torch.from_numpy(a) for a in (q, k, v, cos, sin)), span, SCALE
    )
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_bucketed_calls_write_their_rows_in_place():
    """Ragged layouts call the kernel once per window-size bucket, each
    writing its slice of one output (vision.py's bucket loop)."""
    q, k, v, cos, sin = _inputs(64 * 2 + 36 * 4, seed=3)
    t = [torch.from_numpy(a) for a in (q, k, v, cos, sin)]
    out = torch.full((q.shape[0], NH, HD), float("nan"))
    for span, a, b in ((64, 0, 128), (36, 128, 272)):
        block_diag_attention_2d(*(x[a:b] for x in t), span, SCALE,
                                out=out[a:b])
    for span, a, b in ((64, 0, 128), (36, 128, 272)):
        ref = _pallas(q[a:b], k[a:b], v[a:b], cos[a:b], sin[a:b], span)
        np.testing.assert_allclose(out[a:b].numpy(), ref, atol=ATOL, rtol=RTOL)


def _bf16_step(x):
    """The spacing of bf16 numbers at |x| (floored at 2^-10)."""
    mag = np.maximum(np.abs(x), 2.0 ** -10)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize(
    "span,nspan", [(64, 4), (48, 3), (36, 4), (16, 8), (100, 2)],
)
def test_plain_matches_pallas_2d_in_bf16(span, nspan):
    """C14: bf16 q/k/v, the tables cast to bf16 as the JAX 2D route casts
    them (vision.py:415-416), JAX kernel in interpret mode. The plain
    version rotates at the JAX rounding points, then attends at the JAX
    kernel's; only f32 summation order differs, which moves an element to
    a neighbouring bf16 value now and then: at most 0.1% of the elements
    differ (measured 0-0.05%), each by at most 4 bf16 steps (measured 3).
    The former f32 rotary from f32 tables differed in ~66% of them."""
    q, k, v, cos, sin = _inputs(span * nspan, seed=span)
    pad = ((0, 0), (0, DP - HD))

    def padded(x):
        return _pad_heads(x).astype(jnp.bfloat16)

    def table(t):
        return jnp.asarray(np.pad(t, pad)).astype(jnp.bfloat16)

    ref = jva.block_diag_attention_2d(
        padded(q), padded(k), padded(v), span, scale=SCALE, nh=NH, dp=DP,
        cos=table(cos), sin=table(sin), rot_half=HD // 2, interpret=True,
    )
    ref = np.asarray(ref.astype(jnp.float32)).reshape(-1, NH, DP)[:, :, :HD]
    got = block_diag_attention_2d_plain(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
        torch.from_numpy(cos), torch.from_numpy(sin), span, SCALE,
    ).float().numpy()
    diff = np.abs(got - ref)
    assert (diff != 0).mean() <= 1e-3
    assert (diff <= 4 * _bf16_step(ref)).all()


def test_rotary_plain_is_bit_equal_to_jax_in_bf16():
    """The rotary's plain version (`apply_vision_rotary`, the pass's
    `vision_rotary` on the CPU) against the JAX package's
    `_apply_vision_rotary` in bf16: bit for bit (both round each product,
    then the sum, to bf16)."""
    q, k, _, cos, sin = _inputs(256, seed=11)
    qb, kb = (torch.from_numpy(a).bfloat16() for a in (q, k))
    ct, st = torch.from_numpy(cos), torch.from_numpy(sin)
    for x, xb in ((q, qb), (k, kb)):
        ref = np.asarray(jvision._apply_vision_rotary(
            jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(cos),
            jnp.asarray(sin),
        ).astype(jnp.float32))
        got = apply_vision_rotary(xb, ct, st).float().numpy()
        np.testing.assert_array_equal(got, ref)
    q0, k0 = qb.clone(), kb.clone()
    qr, kr = vision_rotary(qb, kb, ct, st)
    assert torch.equal(qb, q0) and torch.equal(kb, k0)  # inputs untouched
    assert torch.equal(qr, apply_vision_rotary(qb, ct, st))
    assert torch.equal(kr, apply_vision_rotary(kb, ct, st))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_2d_is_the_rotary_then_the_b5_core(dtype):
    """One plain core serves both kernels: B2's plain version equals the
    rotary pass's plain version followed by B5's, bit for bit."""
    q, k, v, cos, sin = (torch.from_numpy(a) for a in _inputs(36 * 4, seed=4))
    q, k, v = (x.to(dtype) for x in (q, k, v))
    qr, kr = vision_rotary(q, k, cos, sin)
    assert torch.equal(
        block_diag_attention_2d_plain(q, k, v, cos, sin, 36, SCALE),
        block_diag_attention_plain(qr, kr, v, 36, SCALE),
    )


def test_span_must_divide_sequence():
    q, k, v, cos, sin = (torch.from_numpy(a) for a in _inputs(100, seed=0))
    with pytest.raises(ValueError, match="span"):
        block_diag_attention_2d(q, k, v, cos, sin, 64, SCALE)


# -- B5 ------------------------------------------------------------------------

B5_NH, B5_HD = 4, 16  # the JAX package's own test shapes


def _b5_inputs(s, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((s, B5_NH, B5_HD)).astype(np.float32)
            for _ in range(3)]


def _b5_plain(q, k, v, span, valid=None):
    return block_diag_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), span, B5_HD ** -0.5,
        None if valid is None else torch.from_numpy(valid),
    ).numpy()


@pytest.mark.parametrize("span,nspan", [(8, 12), (24, 4), (96, 2), (128, 1)])
def test_b5_plain_matches_pallas(span, nspan):
    q, k, v = _b5_inputs(span * nspan, seed=span)
    assert kernel_applicable(span * nspan, span)
    ref = jva.block_diag_attention(
        *(jnp.asarray(a) for a in (q, k, v)), span, scale=B5_HD ** -0.5,
        interpret=True,
    )
    got = _b5_plain(q, k, v, span)
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_b5_masked_plain_matches_pallas_on_valid_rows():
    """tests/test_vision_attention.py's padded-window case: ragged validity
    in 128-row spans; rows of invalid slots are dead and not compared."""
    nw, mw = 6, 128
    q, k, v = _b5_inputs(nw * mw, seed=5)
    valid = np.ones((nw, mw), bool)
    valid[1, 100:] = False
    valid[4, 7:] = False
    valid = valid.reshape(-1)
    ref = jva.block_diag_attention(
        *(jnp.asarray(a) for a in (q, k, v)), mw, scale=B5_HD ** -0.5,
        valid=jnp.asarray(valid), interpret=True,
    )
    got = _b5_plain(q, k, v, mw, valid)
    np.testing.assert_allclose(got[valid], np.asarray(ref)[valid],
                               atol=ATOL, rtol=RTOL)


def test_b5_plain_zeroes_rows_whose_span_has_no_valid_key():
    q, k, v = _b5_inputs(3 * 16, seed=6)
    valid = np.ones(48, bool)
    valid[16:32] = False
    got = _b5_plain(q, k, v, 16, valid)
    assert not got[16:32].any() and got[:16].all()
    np.testing.assert_allclose(got[32:], _b5_plain(q[32:], k[32:], v[32:], 16),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("span,nspan", [(36, 3), (4, 5), (2304, 1)])
def test_b5_plain_matches_xla_where_the_tiling_rule_refuses(span, nspan):
    """Spans the JAX package sends to its XLA `_block_attention` (an odd
    span count of 4 or 36 rows, a span above 1536 rows): B5 takes them."""
    s = span * nspan
    assert not kernel_applicable(s, span)
    assert not jva.kernel_applicable(s, span)
    q, k, v = _b5_inputs(s, seed=span)
    ref = jvision._block_attention(
        *(jnp.asarray(a).reshape(nspan, span, B5_NH, B5_HD)
          for a in (q, k, v)), None, B5_HD ** -0.5,
    ).reshape(s, B5_NH, B5_HD)
    got = _b5_plain(q, k, v, span)
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_b5_rejects_a_span_that_does_not_divide_the_sequence():
    q = torch.zeros(100, B5_NH, B5_HD)
    with pytest.raises(ValueError, match="not a multiple"):
        block_diag_attention(q, q, q, 64, scale=1.0)


def test_b5_writes_bucket_rows_in_place():
    q, k, v = _b5_inputs(64 * 2 + 12 * 3, seed=9)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    out = torch.full(t[0].shape, float("nan"))
    for span, a, b in ((64, 0, 128), (12, 128, 164)):
        block_diag_attention(*(x[a:b] for x in t), span,
                             scale=B5_HD ** -0.5, out=out[a:b])
        np.testing.assert_allclose(
            out[a:b].numpy(), _b5_plain(q[a:b], k[a:b], v[a:b], span),
            atol=0, rtol=0,
        )
