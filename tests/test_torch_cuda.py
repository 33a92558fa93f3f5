"""The port on a CUDA card: kernels against their plain versions, and the
upload stage of the frame pipeline.

Every test needs a CUDA card and nvcc (marker `cuda`) and skips without
one. This file imports nothing of JAX, so it also runs where JAX is not
installed, without tests/conftest.py (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: both sides read the same bf16 operands (B1's int8 variants:
the same int8 codes and scales); the plain version computes in f32 and
rounds once, the kernel also rounds its softmax weights to bf16 before the
PV product (the plain int8 versions round p * vs or p to bf16 as well, but
against the global row max where the kernel uses the running one). Outputs
are bf16 (2^-7 relative spacing), so one rounding step apart plus the
rounded weights stay within 1e-2 + 1e-2 * |plain|.

B1's lse (f32, natural log): both sides take the same f32 scores (exact
products of the bf16 or int8 operands) and differ only in summation order
and exp2 / log rounding, ~1e-6 of an lse of magnitude <= 20; LSE_TOL leaves
two orders of margin.

B3/B4/B6 (int8): quickvideo_tpu_torch/testing.py states the rule, shared
with chip_smoke.py.
"""

import collections
import contextlib
import traceback

import numpy as np
import pytest
import torch

from quickvideo_tpu_torch.ops import fused_vision_mlp as fm
from quickvideo_tpu_torch.ops.attention import (
    NEG_INF,
    cache_attention,
    cache_attention_int8,
    quantize_q,
)
from quickvideo_tpu_torch.ops.kv_cache import (
    init_cache,
    quantize_kv,
    stacked_append,
)
from quickvideo_tpu_torch.ops.quantization import (
    int_mm,
    qdot,
    quantize_act,
    quantize_weight,
)
from quickvideo_tpu_torch.testing import (
    FUSED_ROWS,
    bf16_rows_close,
    fused_block,
    quantized_close,
)
from quickvideo_tpu_torch.ops.flash_attention import (
    _plan,
    flash_past_attention,
)
from quickvideo_tpu_torch.ops.vision_attention import (
    SHORT_SPAN,
    apply_vision_rotary,
    block_diag_attention,
    block_diag_attention_2d,
    block_diag_attention_2d_plain,
    block_diag_attention_plain,
    vision_rotary,
)

pytestmark = pytest.mark.cuda

TOL = dict(atol=1e-2, rtol=1e-2)
LSE_TOL = dict(atol=1e-4, rtol=0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _launch(dev, g, length, cap, *, causal=True, variant="bf16", **kw):
    """One B1 call with its launch counted: (out, lse) and the kernel it
    ran, which must be the one _plan names for the shape."""
    before = collections.Counter(flash_past_attention.kernel_launches)
    out = flash_past_attention(*kw.pop("args"), causal=causal, **kw)
    ran = flash_past_attention.kernel_launches - before
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = _plan(g, 28, 4, length, cap, causal, sms, variant).kernel
    assert ran == collections.Counter({want: 1}), (ran, want)
    return out, want


# decode (split-K), the final prefill (37, not a tile multiple; over the
# headline's 57,344 slots it splits the prefill kernel), G * rep below one
# prefill row tile (19) and ragged above it (100, 3599), length 0, a causal
# diagonal across key-tile edges (1000 + 100), the 64-frame group step and
# the 1024-frame headline's last one
@pytest.mark.parametrize(
    "g,length,cap",
    [(1, 4000, 8192), (1, 57344, 65536), (37, 3607, 8192),
     (37, 57344, 65536), (19, 1000, 4096), (100, 1000, 4096), (600, 0, 4096),
     (3599, 1807, 8192), (3600, 1807, 8192), (3600, 53744, 65536)],
)
def test_flash_kernel_matches_plain(dev, g, length, cap):
    gen = torch.Generator(device=dev).manual_seed(g)
    k_all = torch.randn(2, 4, cap, 128, generator=gen, device=dev).bfloat16()
    v_all = torch.randn(2, 4, cap, 128, generator=gen, device=dev).bfloat16()
    q = torch.randn(g, 28, 128, generator=gen, device=dev).bfloat16()
    q = q.transpose(0, 1)  # the projection's layout: (G, Hq, D) storage
    scale = 128 ** -0.5
    before = flash_past_attention.launches
    (got, lse), _ = _launch(dev, g, length, cap,
                            args=(q, k_all[1], v_all[1], length, scale))
    assert flash_past_attention.launches == before + 1 and lse is None
    ref, _ = cache_attention(q, k_all[1], v_all[1], length, scale)
    torch.testing.assert_close(got.float(), ref.float(), **TOL)


@pytest.mark.parametrize("g,kernel", [(20, "decode"), (50, "bf16_prefill")])
def test_flash_kernel_reads_only_its_layer(dev, g, kernel):
    """Garbage in the other layer and past length + G must not leak in."""
    gen = torch.Generator(device=dev).manual_seed(1)
    k_all = torch.randn(2, 4, 1024, 128, generator=gen, device=dev).bfloat16()
    v_all = torch.randn(2, 4, 1024, 128, generator=gen, device=dev).bfloat16()
    q = torch.randn(28, g, 128, generator=gen, device=dev).bfloat16()
    args = (q, k_all[1], v_all[1], 300, 0.1)
    (got, _), ran = _launch(dev, g, 300, 1024, args=args)
    assert ran == kernel
    k_all[0].fill_(float("nan"))
    v_all[0].fill_(float("nan"))
    k_all[1, :, 300 + g:].fill_(float("nan"))
    v_all[1, :, 300 + g:].fill_(float("nan"))
    again = flash_past_attention(*args)[0]
    assert torch.equal(got, again)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(dev):
    k = torch.zeros(4, 64, 128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        flash_past_attention(torch.zeros(28, 4, 128, device=dev), k, k, 0, 1.0)
    k96 = torch.zeros(4, 64, 96, device=dev, dtype=torch.bfloat16)
    q96 = torch.zeros(28, 4, 96, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_past_attention(q96, k96, k96, 0, 1.0)


def _int8_cache(dev, cap, variant, seed):
    """A 2-layer stacked int8 cache (K, and V for "int8") quantized from
    seeded bf16 rows, as the main path's appends write it."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    cache = init_cache(2, 4, cap, 128, device=dev,
                       quantized=True if variant == "int8" else "k")
    k = torch.randn(4, cap, 128, generator=gen, device=dev).bfloat16()
    v = torch.randn(4, cap, 128, generator=gen, device=dev).bfloat16()
    for li in range(2):
        stacked_append(cache, li, 0, k, v)
    q = torch.randn(cap, 28, 128, generator=gen, device=dev).bfloat16()
    return cache, q


def _int8_args(cache, li=1):
    return dict(
        k_scale=cache.k_scale[li],
        v_scale=None if cache.v_scale is None else cache.v_scale[li],
    )


@pytest.mark.parametrize("variant", ["int8", "int8k"])
@pytest.mark.parametrize(
    "g,length,cap",
    [(1, 4000, 8192), (1, 57344, 65536), (1, 122880, 131072),
     (27, 1000, 4096), (28, 1000, 4096), (37, 3607, 8192), (600, 0, 4096),
     (3600, 1807, 8192), (3600, 53744, 65536)],
)
def test_flash_int8_kernels_match_plain(dev, variant, g, length, cap):
    """B1's int8-QK variants against their plain version on the same int8
    codes: q quantized once by the shared quantize_q, same tolerance as
    bf16 (both round p * vs or p to bf16 for the PV product)."""
    cache, q = _int8_cache(dev, cap, variant, g)
    q = q[:g].transpose(0, 1)  # (G, Hq, D) storage, as the projection
    scale = 128 ** -0.5
    before = dict(flash_past_attention.variant_launches)
    got, _ = flash_past_attention(q, cache.k[1], cache.v[1], length, scale,
                                  **_int8_args(cache))
    assert flash_past_attention.variant_launches[variant] == before[variant] + 1
    q8, qs = quantize_q(q, scale)
    a = _int8_args(cache)
    ref, _ = cache_attention_int8(
        q8, qs, cache.k[1], a["k_scale"], cache.v[1], a["v_scale"], length,
        torch.bfloat16,
    )
    torch.testing.assert_close(got.float(), ref.float(), **TOL)


@pytest.mark.parametrize("variant", ["int8", "int8k"])
def test_flash_int8_kernel_reads_only_its_layer(dev, variant):
    """NaN codes cannot exist, so poison the scales: of the other layer and
    past length + G."""
    cache, q = _int8_cache(dev, 1024, variant, 3)
    q = q[:50].transpose(0, 1)
    got, _ = flash_past_attention(q, cache.k[1], cache.v[1], 300, 0.1,
                                  **_int8_args(cache))
    for sc in (cache.k_scale, cache.v_scale):
        if sc is not None:
            sc[0].fill_(float("nan"))
            sc[1, :, 350:].fill_(float("nan"))
    cache.k[1, :, 350:].fill_(127)
    if variant == "int8k":
        cache.v[1, :, 350:].fill_(float("nan"))
    again, _ = flash_past_attention(q, cache.k[1], cache.v[1], 300, 0.1,
                                    **_int8_args(cache))
    assert torch.equal(got, again)


def _mode_case(dev, variant, g, length, cap, seed):
    """q in the projection's layout and one cache layer of `variant`, with
    the kernel's keyword operands."""
    if variant == "bf16":
        gen = torch.Generator(device=dev).manual_seed(seed)
        k = torch.randn(4, cap, 128, generator=gen, device=dev).bfloat16()
        v = torch.randn(4, cap, 128, generator=gen, device=dev).bfloat16()
        q = torch.randn(g, 28, 128, generator=gen, device=dev).bfloat16()
        return q.transpose(0, 1), k, v, {}
    cache, q = _int8_cache(dev, cap, variant, seed)
    return q[:g].transpose(0, 1), cache.k[1], cache.v[1], _int8_args(cache)


def _plain(q, k, v, length, scale, kw, **mode):
    if not kw:
        return cache_attention(q, k, v, length, scale, **mode)
    q8, qs = quantize_q(q, scale)
    return cache_attention_int8(q8, qs, k, kw["k_scale"], v, kw["v_scale"],
                                length, torch.bfloat16, **mode)


@pytest.mark.parametrize("variant", ["bf16", "int8", "int8k"])
@pytest.mark.parametrize(
    "causal,g,length,cap",
    [(False, 3620, 1807, 8192), (False, 20, 0, 4096), (False, 100, 0, 4096),
     (False, 100, 1000, 4096), (False, 1, 57344, 65536),
     (True, 3600, 1807, 8192), (True, 37, 3607, 8192),
     (True, 37, 57344, 65536), (True, 600, 0, 4096), (True, 1, 4000, 8192)],
)
def test_flash_lse_and_pure_past_modes_match_plain(dev, variant, causal, g,
                                                   length, cap):
    """B1's lse output in both modes, pure past with the f32 output the
    query-based merge takes (unified with the bf16 output of the hot path),
    every cache variant: out and lse against the plain version; G = 1 and
    G = 37 over 57,344 slots run split-K, so the merge kernel forms the lse
    there. Pure past over an empty cache: out 0, lse NEG_INF, on either
    kernel (G = 20 decode, G = 100 prefill)."""
    q, k, v, kw = _mode_case(dev, variant, g, length, cap, g + length)
    scale = 128 ** -0.5
    out_dtype = torch.bfloat16 if causal else torch.float32
    mode = dict(causal=causal, with_lse=True, out_dtype=out_dtype)
    name = "past+lse" if not causal else "unified+lse"
    before = flash_past_attention.mode_launches[variant, name]
    (got, lse), _ = _launch(dev, g, length, cap, causal=causal,
                            variant=variant, args=(q, k, v, length, scale),
                            **kw, with_lse=True, out_dtype=out_dtype)
    assert flash_past_attention.mode_launches[variant, name] == before + 1
    ref, ref_lse = _plain(q, k, v, length, scale, kw, **mode)
    assert got.dtype == out_dtype and lse.dtype == torch.float32
    assert lse.shape == (28, g)
    torch.testing.assert_close(got.float(), ref.float(), **TOL)
    torch.testing.assert_close(lse, ref_lse, **LSE_TOL)
    if not causal and length == 0:
        assert not got.any() and bool((lse == NEG_INF).all())


@pytest.mark.parametrize("variant,g", [("bf16", 20), ("bf16", 50),
                                       ("int8", 20), ("int8", 50),
                                       ("int8k", 20), ("int8k", 50)])
def test_flash_pure_past_reads_only_the_valid_slots(dev, variant, g):
    """Pure past attends [0, length): poisoning the group's own slots and
    everything past length changes nothing (the decode kernel at G = 20,
    the prefill kernels at G = 50)."""
    q, k, v, kw = _mode_case(dev, variant, g, 300, 1024, 9)
    mode = dict(causal=False, with_lse=True, out_dtype=torch.float32)
    (got, lse), _ = _launch(dev, g, 300, 1024, causal=False, variant=variant,
                            args=(q, k, v, 300, 0.1), **kw, with_lse=True,
                            out_dtype=torch.float32)
    if variant == "bf16":
        k[:, 300:].fill_(float("nan"))
        v[:, 300:].fill_(float("nan"))
    else:
        for sc in (kw["k_scale"], kw["v_scale"]):
            if sc is not None:
                sc[:, 300:].fill_(float("nan"))
        if variant == "int8k":
            v[:, 300:].fill_(float("nan"))
    again, lse2 = flash_past_attention(q, k, v, 300, 0.1, **kw, **mode)
    assert torch.equal(got, again) and torch.equal(lse, lse2)


# decode at G = 1 over 4,000, 57,344 (the headline's occupancy) and 122,880
# slots (hour-scale), query-based group 0 (G = 20, pure past), 189 and 196
# packed rows (either side of one prefill row tile), the 64-frame group step
B1_SHAPES = [(1, 4000, 8192), (1, 57344, 65536), (1, 122880, 131072),
             (20, 1807, 4096), (27, 1000, 4096), (28, 1000, 4096),
             (3600, 1807, 8192)]


@pytest.mark.parametrize("variant", ["bf16", "int8", "int8k"])
@pytest.mark.parametrize("g,length,cap", B1_SHAPES)
def test_flash_every_mode_and_output_matches_plain(dev, variant, g, length,
                                                   cap):
    """Both kernels (decode below one prefill row tile, the prefill kernel
    of the variant above), each mode x output dtype, out and lse against
    the plain version; the launch goes to the kernel _plan names."""
    q, k, v, kw = _mode_case(dev, variant, g, length, cap, 3 * g + length)
    scale = 128 ** -0.5
    for causal in (True, False):
        for with_lse in (False, True):
            for out_dtype in (torch.bfloat16, torch.float32):
                mode = dict(causal=causal, with_lse=with_lse,
                            out_dtype=out_dtype)
                (got, lse), _ = _launch(dev, g, length, cap, causal=causal,
                                        variant=variant,
                                        args=(q, k, v, length, scale), **kw,
                                        with_lse=with_lse,
                                        out_dtype=out_dtype)
                ref, ref_lse = _plain(q, k, v, length, scale, kw, **mode)
                assert got.dtype == out_dtype
                torch.testing.assert_close(got.float(), ref.float(), **TOL)
                if with_lse:
                    torch.testing.assert_close(lse, ref_lse, **LSE_TOL)
                else:
                    assert lse is None


@pytest.mark.parametrize("variant", ["bf16", "int8", "int8k"])
@pytest.mark.parametrize("causal,g", [(True, 1), (False, 1), (False, 20),
                                      (True, 27), (True, 100), (False, 100)])
def test_flash_nan_past_the_reach_leaves_the_output_finite(dev, variant,
                                                           causal, g):
    """NaN written into the other layer and into every K/V row and scale
    past the reach (length + G, or length in pure past) changes no bit of
    the output or the lse: the tensor maps end at the reach."""
    length, cap = 300, 1024
    cache, q = (_int8_cache(dev, cap, variant, 7) if variant != "bf16"
                else (None, None))
    if variant == "bf16":
        gen = torch.Generator(device=dev).manual_seed(7)
        k_all = torch.randn(2, 4, cap, 128, generator=gen, device=dev).bfloat16()
        v_all = torch.randn(2, 4, cap, 128, generator=gen, device=dev).bfloat16()
        q = torch.randn(cap, 28, 128, generator=gen, device=dev).bfloat16()
        kw, scales = {}, ()
    else:
        k_all, v_all = cache.k, cache.v
        kw = _int8_args(cache)
        scales = [sc for sc in (cache.k_scale, cache.v_scale) if sc is not None]
    q = q[:g].transpose(0, 1)
    mode = dict(causal=causal, with_lse=True, out_dtype=torch.float32)
    args = (q, k_all[1], v_all[1], length, 0.1)
    (got, lse), _ = _launch(dev, g, length, cap, causal=causal,
                            variant=variant, args=args, **kw, with_lse=True,
                            out_dtype=torch.float32)
    reach = length + g if causal else length
    for t in (k_all, v_all):
        if t.dtype != torch.int8:  # int8 codes cannot hold NaN
            t[0].fill_(float("nan"))
            t[1, :, reach:].fill_(float("nan"))
        else:
            t[1, :, reach:].fill_(127)
    for sc in scales:
        sc[0].fill_(float("nan"))
        sc[1, :, reach:].fill_(float("nan"))
    again, lse2 = flash_past_attention(*args, **kw, **mode)
    assert torch.isfinite(again).all() and torch.isfinite(lse2).all()
    assert torch.equal(got, again) and torch.equal(lse, lse2)


@pytest.mark.parametrize("variant", ["bf16", "int8", "int8k"])
@pytest.mark.parametrize("g", [1, 20, 100])
def test_flash_pure_past_over_an_empty_cache(dev, variant, g):
    """length 0 in pure past: every row sees nothing, so out is 0 and the
    lse NEG_INF (no NaN), on both kernels, bf16 and f32 out."""
    q, k, v, kw = _mode_case(dev, variant, g, 0, 4096, 5)
    for out_dtype in (torch.bfloat16, torch.float32):
        (out, lse), _ = _launch(dev, g, 0, 4096, causal=False,
                                variant=variant, args=(q, k, v, 0, 0.1),
                                **kw, with_lse=True, out_dtype=out_dtype)
        assert not out.any() and bool((lse == NEG_INF).all())


@pytest.mark.parametrize("variant", ["bf16", "int8", "int8k"])
@pytest.mark.parametrize("g,length,cap", [(1, 57344, 65536), (20, 1807, 4096)])
def test_decode_split_k_matches_one_split(dev, variant, g, length, cap):
    """The decode kernel's split-K (flash_merge_kernel over the splits'
    partials) against the same call in one split, out and lse, and
    repeated calls give the same bits."""
    from quickvideo_tpu_torch.ops import flash_attention as fa

    q, k, v, kw = _mode_case(dev, variant, g, length, cap, 2)
    mode = dict(causal=False, with_lse=True, out_dtype=torch.float32)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert _plan(g, 28, 4, length, cap, False, sms, variant).n_split > 1
    runs = [flash_past_attention(q, k, v, length, 0.1, **kw, **mode)
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    plan = fa._plan

    def one_split(*a, **kw2):
        return plan(*a, **kw2)._replace(n_split=1)

    fa._plan = one_split
    try:
        whole, whole_lse = flash_past_attention(q, k, v, length, 0.1, **kw,
                                                **mode)
    finally:
        fa._plan = plan
    # P is rounded to bf16 against each split's running max: one bf16
    # rounding step apart, as against the plain version
    torch.testing.assert_close(runs[0][0], whole, **TOL)
    torch.testing.assert_close(runs[0][1], whole_lse, **LSE_TOL)


def test_no_b1_instantiation_spills(dev):
    """ptxas keeps every B1 instantiation (decode and prefill kernels of
    each variant, each mode, and the merge kernel) in registers."""
    import ctypes

    from quickvideo_tpu_torch import _build

    lib = _build.library()
    for which in range(52):
        vals = [ctypes.c_int() for _ in range(4)]
        assert lib.qv_flash_kernel_info(
            which, *(ctypes.byref(x) for x in vals)) == 0
        assert vals[1].value == 0, (which, [x.value for x in vals])


def test_flash_mode_operands_are_checked(dev):
    q, k, v, _ = _mode_case(dev, "bf16", 8, 100, 256, 4)
    with pytest.raises(TypeError, match="bf16 or f32"):
        flash_past_attention(q, k, v, 0, 1.0, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="capacity"):  # causal needs G slots
        flash_past_attention(q, k, v, 252, 1.0)
    out, lse = flash_past_attention(q, k, v, 256, 1.0, causal=False)
    assert lse is None and out.dtype == torch.bfloat16


def test_kv_and_q_quantization_on_the_card_equal_the_cpu(dev):
    """quantize_kv and quantize_q at 3600 rows: codes and scales on the
    card bit-identical to the CPU's (a division by a Python scalar would
    become a multiply by its reciprocal on CUDA and flip codes)."""
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(4, 3600, 128, generator=gen, device=dev)
    x = (x * torch.rand(4, 3600, 1, generator=gen, device=dev) * 20).bfloat16()
    for got, want in ((quantize_kv(x), quantize_kv(x.cpu())),
                      (quantize_kv(x.float()), quantize_kv(x.float().cpu())),
                      (quantize_q(x, 128 ** -0.5),
                       quantize_q(x.cpu(), 128 ** -0.5))):
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])


def test_flash_int8_wrapper_rejects_what_the_kernel_does_not_take(dev):
    cache, q = _int8_cache(dev, 256, "int8", 5)
    q = q[:4].transpose(0, 1)
    k, v, ks, vs = cache.k[1], cache.v[1], cache.k_scale[1], cache.v_scale[1]
    with pytest.raises(TypeError):  # bf16 K with K scales
        flash_past_attention(q, k.bfloat16(), v, 0, 1.0, k_scale=ks,
                             v_scale=vs)
    with pytest.raises(TypeError):  # int8 V without V scales
        flash_past_attention(q, k, v, 0, 1.0, k_scale=ks)
    with pytest.raises(TypeError):  # scales not f32
        flash_past_attention(q, k, v, 0, 1.0, k_scale=ks.bfloat16(),
                             v_scale=vs)
    strided = torch.zeros(256, 4, device=dev).t()  # stride 4 along cap
    with pytest.raises(ValueError, match="stride 1"):
        flash_past_attention(q, k, v, 0, 1.0, k_scale=strided, v_scale=vs)
    flat = torch.zeros(4 * 256 * 128 + 8, dtype=torch.int8, device=dev)
    off = flat[8:].view(4, 256, 128)  # rows 8 bytes off 16-byte alignment
    with pytest.raises(ValueError, match="aligned"):
        flash_past_attention(q, off, v, 0, 1.0, k_scale=ks, v_scale=vs)
    with pytest.raises(TypeError):  # f32 activations
        flash_past_attention(q.float(), k, v, 0, 1.0, k_scale=ks, v_scale=vs)


# the main path's spans: window buckets of 4-64 rows (short-span kernel),
# frames of 900 and 1564 rows and 2304-row spans (long-span kernel)
VISION_CASES = [(4, 512), (12, 1560), (16, 1024), (36, 3600), (48, 3600),
                (64, 14400), (900, 3600), (1564, 1564), (2304, 4608)]


def _qkv_views(dev, s, seed):
    """q, k, v as strided (S, 16, 80) views of one fused projection, and
    the projection itself."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(s, 3 * 1280, generator=gen, device=dev).bfloat16()
    return qkv, [qkv[:, i * 1280 : (i + 1) * 1280].view(s, 16, 80)
                 for i in range(3)]


def _tables(dev, s, seed):
    """bf16 rotary tables (the tower casts them once per forward)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    ang = torch.rand(s, 40, generator=gen, device=dev) * 6.28
    emb = torch.cat([ang, ang], dim=-1)
    return torch.cos(emb).bfloat16(), torch.sin(emb).bfloat16()


@pytest.mark.parametrize("span,s", VISION_CASES)
def test_vision_kernel_matches_plain(dev, span, s):
    """B2: one launch per call; above SHORT_SPAN rows one rotary pass too
    (each row rotated once), none below; q/k/v left as they were."""
    qkv, (q, k, v) = _qkv_views(dev, s, span)
    cos, sin = _tables(dev, s, span)
    before = qkv.clone()
    launches = block_diag_attention_2d.launches
    rot = vision_rotary.launches
    got = block_diag_attention_2d(q, k, v, cos, sin, span, 80 ** -0.5)
    assert block_diag_attention_2d.launches == launches + 1
    assert vision_rotary.launches == rot + int(span > SHORT_SPAN)
    ref = block_diag_attention_2d_plain(q, k, v, cos, sin, span, 80 ** -0.5)
    torch.testing.assert_close(got.float(), ref.float(), **TOL)
    assert torch.equal(qkv, before)


def test_vision_wrapper_rejects_what_the_kernel_does_not_take(dev):
    before = block_diag_attention_2d.launches
    x = torch.zeros(64, 2, 80, device=dev)
    cs = torch.zeros(64, 80, device=dev)
    with pytest.raises(TypeError):
        block_diag_attention_2d(x, x, x, cs, cs, 64, 1.0)
    xb = torch.zeros(64, 2, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        block_diag_attention_2d(xb, xb, xb, cs[:, :64], cs[:, :64], 64, 1.0)
    x = x.bfloat16()
    with pytest.raises(ValueError, match="cos"):  # a table of 32 rows
        block_diag_attention_2d(x, x, x, cs[:32], cs[:32], 32, 1.0)
    flat = torch.zeros(64 * 80 + 4, device=dev, dtype=torch.bfloat16)
    off = flat[4:].view(64, 80)  # table rows 8 bytes off 16-byte alignment
    with pytest.raises(ValueError, match="aligned"):
        block_diag_attention_2d(x, x, x, off, off, 64, 1.0)
    assert block_diag_attention_2d.launches == before


@pytest.mark.parametrize("span,s", [(64, 256), (900, 1800)])
def test_b2_writes_in_place_and_counts_each_launch(dev, span, s):
    """`out=` slices (the bucket loop's) written in place, one launch per
    call, on a short and a long span."""
    _, (q, k, v) = _qkv_views(dev, s + 36 * 5, 8)
    cos, sin = _tables(dev, s + 36 * 5, 8)
    out = torch.full_like(q.contiguous(), float("nan"))
    before = block_diag_attention_2d.launches
    cuts = ((span, 0, s), (36, s, s + 180))
    for sp, a, b in cuts:
        block_diag_attention_2d(q[a:b], k[a:b], v[a:b], cos[a:b], sin[a:b],
                                sp, 80 ** -0.5, out=out[a:b])
    assert block_diag_attention_2d.launches == before + 2
    for sp, a, b in cuts:
        ref = block_diag_attention_2d_plain(q[a:b], k[a:b], v[a:b], cos[a:b],
                                            sin[a:b], sp, 80 ** -0.5)
        torch.testing.assert_close(out[a:b].float(), ref.float(), **TOL)


def test_rotary_pass_matches_plain_and_leaves_its_inputs(dev):
    """The rotary pass against `apply_vision_rotary` (the same rounding
    points: bit for bit) on strided views; one launch; q, k unmodified."""
    qkv, (q, k, _) = _qkv_views(dev, 1800, 9)
    cos, sin = _tables(dev, 1800, 9)
    before = qkv.clone()
    launches = vision_rotary.launches
    qr, kr = vision_rotary(q, k, cos, sin)
    assert vision_rotary.launches == launches + 1
    assert torch.equal(qkv, before)
    assert torch.equal(qr, apply_vision_rotary(q, cos, sin))
    assert torch.equal(kr, apply_vision_rotary(k, cos, sin))
    # f32 tables are cast to the activation dtype first, as the JAX route
    qr32, _ = vision_rotary(q, k, cos.float(), sin.float())
    assert torch.equal(qr32, qr)


def test_rotary_pass_rejects_what_the_kernel_does_not_take(dev):
    before = vision_rotary.launches
    x = torch.zeros(64, 2, 80, device=dev)
    cs = torch.zeros(64, 80, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):  # f32 rows
        vision_rotary(x, x, cs, cs)
    xb = x.bfloat16()
    with pytest.raises(ValueError, match="cos"):
        vision_rotary(xb, xb, cs[:, :64], cs[:, :64])
    with pytest.raises(ValueError, match="on"):  # k on the CPU
        vision_rotary(xb, xb.cpu(), cs, cs)
    assert vision_rotary.launches == before


def _b5_inputs(dev, s, seed):
    """q, k, v as strided (S, 16, 80) views of one fused projection."""
    return _qkv_views(dev, s, seed)[1]


@pytest.mark.parametrize("span,s", VISION_CASES + [(1, 128)])
def test_b5_kernel_matches_plain(dev, span, s):
    q, k, v = _b5_inputs(dev, s, span)
    before = block_diag_attention.launches
    got = block_diag_attention(q, k, v, span, scale=80 ** -0.5)
    assert block_diag_attention.launches == before + 1
    ref = block_diag_attention_plain(q, k, v, span, 80 ** -0.5)
    torch.testing.assert_close(got.float(), ref.float(), **TOL)


@pytest.mark.parametrize("span,n", [(64, 40), (36, 20), (900, 5)])
def test_b5_masked_kernel_matches_plain_on_valid_rows(dev, span, n):
    """Ragged validity, as tests/test_vision_attention.py's masked case,
    on the short- and the long-span kernel: spans whose first c rows are
    valid, one span wholly invalid (its rows are 0 in both)."""
    q, k, v = _b5_inputs(dev, span * n, 7)
    counts = (torch.arange(n, device=dev) * (span // 7 + 1)) % (span + 1)
    valid = (torch.arange(span, device=dev)[None, :]
             < counts[:, None]).reshape(-1)
    got = block_diag_attention(q, k, v, span, scale=80 ** -0.5, valid=valid)
    ref = block_diag_attention_plain(q, k, v, span, 80 ** -0.5, valid)
    torch.testing.assert_close(got[valid].float(), ref[valid].float(), **TOL)
    dead = (counts == 0).repeat_interleave(span)
    assert dead.any() and not got[dead].any() and not ref[dead].any()


def test_b5_writes_in_place_and_counts_each_launch(dev):
    q, k, v = _b5_inputs(dev, 64 * 2 + 12 * 5 + 900, 3)
    out = torch.full_like(q.contiguous(), float("nan"))
    before = block_diag_attention.launches
    cuts = ((64, 0, 128), (12, 128, 188), (900, 188, 1088))
    for span, a, b in cuts:
        block_diag_attention(q[a:b], k[a:b], v[a:b], span,
                             scale=80 ** -0.5, out=out[a:b])
    assert block_diag_attention.launches == before + 3
    for span, a, b in cuts:
        ref = block_diag_attention_plain(q[a:b], k[a:b], v[a:b], span,
                                         80 ** -0.5)
        torch.testing.assert_close(out[a:b].float(), ref.float(), **TOL)


def test_b5_wrapper_rejects_what_the_kernel_does_not_take(dev):
    before = block_diag_attention.launches
    x = torch.zeros(64, 2, 80, device=dev)
    with pytest.raises(TypeError):  # f32
        block_diag_attention(x, x, x, 64, scale=1.0)
    xb = torch.zeros(64, 2, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # head dim 64
        block_diag_attention(xb, xb, xb, 64, scale=1.0)
    flat = torch.zeros(64 * 160 + 4, device=dev, dtype=torch.bfloat16)
    off = flat[4:].view(64, 2, 80)  # rows 8 bytes off 16-byte alignment
    with pytest.raises(ValueError, match="aligned"):
        block_diag_attention(off, off, off, 64, scale=1.0)
    xc = torch.zeros(64, 2, 80, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="on"):  # k on the CPU
        block_diag_attention(x.bfloat16(), xc, x.bfloat16(), 64, scale=1.0)
    with pytest.raises(ValueError, match="valid"):  # valid of another length
        block_diag_attention(x.bfloat16(), x.bfloat16(), x.bfloat16(), 64,
                             scale=1.0, valid=torch.ones(32, dtype=torch.bool,
                                                         device=dev))
    with pytest.raises(ValueError, match="multiple"):
        block_diag_attention(x.bfloat16(), x.bfloat16(), x.bfloat16(), 48,
                             scale=1.0)
    assert block_diag_attention.launches == before


def assert_quantized_close(got, ref):
    _, ok, why = quantized_close(got, ref)
    assert ok, why


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize(
    "s,c,n,inter",
    [(14400, 1280, 3840, 3420), (250, 1280, 3840, 3420), (90, 1280, 3840, 3420),
     (100, 160, 480, 256)],
)
def test_fused_kernels_match_plain(dev, s, c, n, inter, seed):
    bp = fused_block(dev, c, n, inter, s + 1000 * seed)
    gen = torch.Generator(device=dev).manual_seed(7 + seed)
    x = torch.randn(s, c, generator=gen, device=dev).bfloat16()
    x[3] = 0  # variance 0: the row's codes are all zero
    eps = 1e-6
    before = (fm.ln_gemm_bias.launches, fm.ln_dual_gemm_silu_quant.launches,
              fm.dual_gemm_silu_quant.launches)
    got = fm.ln_gemm_bias(x, bp["ln"], bp["wqkv"], bp["bqkv"], eps)
    ref = fm.ln_gemm_bias_plain(x, bp["ln"], bp["wqkv"], bp["bqkv"], eps)
    _, ok, why = bf16_rows_close(got, ref)
    assert ok, why
    assert torch.equal(got[3], bp["bqkv"].bfloat16())
    got4 = fm.ln_dual_gemm_silu_quant(x, bp["ln"], bp["wgu_p"], bp["bgu_p"], eps)
    ref4 = fm.ln_dual_gemm_silu_quant_plain(
        x, bp["ln"], bp["wgu_p"], bp["bgu_p"], eps
    )
    assert_quantized_close(got4, ref4)
    assert not got4[0][:, inter : got4[0].shape[1]].any()  # pad columns
    xq, xs = quantize_act(x.float())
    got6 = fm.dual_gemm_silu_quant(xq, xs, bp["wgu_p"], bp["bgu_p"])
    ref6 = fm.dual_gemm_silu_quant_plain(xq, xs, bp["wgu_p"], bp["bgu_p"])
    assert_quantized_close(got6, ref6)
    after = (fm.ln_gemm_bias.launches, fm.ln_dual_gemm_silu_quant.launches,
             fm.dual_gemm_silu_quant.launches)
    assert after == tuple(b + 1 for b in before)


def _fused_case(dev, s, c, n, inter, seed=0):
    bp = fused_block(dev, c, n, inter, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.randn(s, c, generator=gen, device=dev).bfloat16()
    return bp, x


def _capture_row_scratch(monkeypatch):
    """The prologue's (xq, xs) scratch of each B3/B4 call, as the kernel
    left it."""
    seen = []
    orig = fm._row_scratch

    def keep(*args):
        seen.append(orig(*args))
        return seen[-1]

    monkeypatch.setattr(fm, "_row_scratch", keep)
    return seen


@pytest.mark.parametrize("s", [1, 90, 100, 250, 14401])
def test_fused_row_counts_off_the_row_tile(dev, s):
    """Row counts that are no multiple of the 128-row bands: TMA's zero
    fill covers the rows past S, the epilogues mask their stores."""
    bp, x = _fused_case(dev, s, 1280, 3840, 3420, seed=s)
    args = (x, bp["ln"], bp["wqkv"], bp["bqkv"], 1e-6)
    _, ok, why = bf16_rows_close(fm.ln_gemm_bias(*args),
                                 fm.ln_gemm_bias_plain(*args))
    assert ok, why
    args = (x, bp["ln"], bp["wgu_p"], bp["bgu_p"], 1e-6)
    got = fm.ln_dual_gemm_silu_quant(*args)
    assert got[0].shape == (s, 3456) and got[1].shape == (s, 1)
    assert_quantized_close(got, fm.ln_dual_gemm_silu_quant_plain(*args))
    assert not got[0][:, 3420:].any()  # pad columns


def test_fused_zero_rows_give_the_bias(dev):
    """All-zero rows (variance 0: codes all zero), at a band's first and
    last row and past the first band: B3 returns the bias; B4's codes and
    scale of such a row equal the plain version's (silu(bg) * bu only)."""
    bp, x = _fused_case(dev, 300, 1280, 3840, 3420)
    zero = [0, 63, 64, 127, 128, 299]
    x[zero] = 0
    out = fm.ln_gemm_bias(x, bp["ln"], bp["wqkv"], bp["bqkv"], 1e-6)
    assert torch.equal(out[zero], bp["bqkv"].bfloat16().expand(len(zero), -1))
    args = (x, bp["ln"], bp["wgu_p"], bp["bgu_p"], 1e-6)
    (q, s), (qr, sr) = (fm.ln_dual_gemm_silu_quant(*args),
                        fm.ln_dual_gemm_silu_quant_plain(*args))
    assert torch.equal(q[zero], qr[zero]) and torch.equal(s[zero], sr[zero])


def test_b4_and_b6_run_one_gemm_and_match_plain_bit_for_bit(dev, monkeypatch):
    """B4 is the prologue, then B6's GEMM kernel: B6 on the codes and scales
    the B4 call's prologue left gives B4's output bit for bit. B6 takes its
    codes as given, so its codes and scales equal the plain version's bit
    for bit, and so do B4's on every row whose prologue codes and scale
    agree with the plain prologue's."""
    seen = _capture_row_scratch(monkeypatch)
    bp, x = _fused_case(dev, 14400, 1280, 3840, 3420, seed=5)
    eps = 1e-6
    q4, s4 = fm.ln_dual_gemm_silu_quant(x, bp["ln"], bp["wgu_p"],
                                        bp["bgu_p"], eps)
    xq, xs = seen[-1]
    q6, s6 = fm.dual_gemm_silu_quant(xq, xs.reshape(-1, 1), bp["wgu_p"],
                                     bp["bgu_p"])
    assert torch.equal(q4, q6) and torch.equal(s4, s6)
    qr, sr = fm.dual_gemm_silu_quant_plain(xq, xs.reshape(-1, 1),
                                           bp["wgu_p"], bp["bgu_p"])
    assert torch.equal(q6, qr) and torch.equal(s6, sr)
    xq_p, xs_p = fm.ln_quantize_plain(x, bp["ln"], eps)
    agree = (xq == xq_p).all(1) & (xs == xs_p.squeeze(1))
    assert agree.float().mean() >= FUSED_ROWS
    q4r, s4r = fm.ln_dual_gemm_silu_quant_plain(x, bp["ln"], bp["wgu_p"],
                                                bp["bgu_p"], eps)
    assert torch.equal(s4[agree], s4r[agree])
    assert torch.equal(q4[agree], q4r[agree])


def test_fused_repeat_runs_are_bit_identical(dev):
    """No ring or cluster race: three runs of each kernel on the same
    inputs give the same bits."""
    bp, x = _fused_case(dev, 14400, 1280, 3840, 3420, seed=9)
    xq, xs = quantize_act(x)
    for fn, args in (
        (fm.ln_gemm_bias, (x, bp["ln"], bp["wqkv"], bp["bqkv"], 1e-6)),
        (fm.ln_dual_gemm_silu_quant,
         (x, bp["ln"], bp["wgu_p"], bp["bgu_p"], 1e-6)),
        (fm.dual_gemm_silu_quant, (xq, xs, bp["wgu_p"], bp["bgu_p"])),
    ):
        runs = [fn(*args) for _ in range(3)]
        for r in runs[1:]:
            if isinstance(r, tuple):
                assert all(torch.equal(a, b) for a, b in zip(r, runs[0]))
            else:
                assert torch.equal(r, runs[0])


@pytest.mark.parametrize("s,c,n,inter", [
    (200, 3200, 512, 1000),  # C above the old 3072 cap, 25 K stages
    (300, 160, 480, 800),    # Np = 832: 4 CTAs with 4, 3, 3, 3 chunks of 64
    (129, 1280, 3840, 3420),
])
def test_fused_kernels_at_other_widths(dev, s, c, n, inter):
    bp, x = _fused_case(dev, s, c, n, inter, seed=c)
    xq, xs = quantize_act(x)
    args = (x, bp["ln"], bp["wqkv"], bp["bqkv"], 1e-6)
    _, ok, why = bf16_rows_close(fm.ln_gemm_bias(*args),
                                 fm.ln_gemm_bias_plain(*args))
    assert ok, why
    args = (x, bp["ln"], bp["wgu_p"], bp["bgu_p"], 1e-6)
    assert_quantized_close(fm.ln_dual_gemm_silu_quant(*args),
                           fm.ln_dual_gemm_silu_quant_plain(*args))
    args = (xq, xs, bp["wgu_p"], bp["bgu_p"])
    got = fm.dual_gemm_silu_quant(*args)
    ref = fm.dual_gemm_silu_quant_plain(*args)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_no_fused_kernel_spills_and_the_plans_launch(dev):
    """ptxas keeps both prologue kernels, B3's and both B4/B6 GEMM kernels
    in registers; the card keeps at least one cluster of the B4/B6 plan at
    the 7B width resident."""
    import ctypes

    from quickvideo_tpu_torch import _build

    lib = _build.library()
    for which in range(5):
        vals = [ctypes.c_int() for _ in range(4)]
        assert lib.qv_fused_kernel_info(
            which, *(ctypes.byref(x) for x in vals)) == 0
        assert vals[1].value == 0, (which, [x.value for x in vals])
    plan = fm.mlp_plan(3456)
    n = ctypes.c_int()
    assert lib.qv_fused_max_clusters(plan.chunk, plan.cluster, plan.nch,
                                     plan.stages, ctypes.byref(n)) == 0
    assert n.value >= 1, plan


def test_fused_wrappers_count_no_launch_on_empty_input(dev):
    """S = 0 launches no kernel, so it adds nothing to the counts."""
    bp = fused_block(dev, 160, 480, 256, 1)
    x = torch.zeros(0, 160, device=dev, dtype=torch.bfloat16)
    xq, xs = quantize_act(x)
    counters = (fm.ln_gemm_bias, fm.ln_dual_gemm_silu_quant,
                fm.dual_gemm_silu_quant)
    before = tuple(f.launches for f in counters)
    out = fm.ln_gemm_bias(x, bp["ln"], bp["wqkv"], bp["bqkv"], 1e-6)
    q4, s4 = fm.ln_dual_gemm_silu_quant(x, bp["ln"], bp["wgu_p"],
                                        bp["bgu_p"], 1e-6)
    q6, s6 = fm.dual_gemm_silu_quant(xq, xs, bp["wgu_p"], bp["bgu_p"])
    assert out.shape == (0, 480)
    assert q4.shape == q6.shape == (0, 256) and s4.shape == s6.shape == (0, 1)
    assert tuple(f.launches for f in counters) == before


def test_fused_wrappers_reject_what_the_kernels_do_not_take(dev):
    bp = fused_block(dev, 160, 480, 256, 0)
    x = torch.zeros(64, 160, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):  # f32 rows
        fm.ln_gemm_bias(x.float(), bp["ln"], bp["wqkv"], bp["bqkv"], 1e-6)
    wide = torch.zeros(64, 161, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # rows not 16-byte aligned / contiguous
        fm.ln_gemm_bias(wide[:, 1:], bp["ln"], bp["wqkv"], bp["bqkv"], 1e-6)
    row_major = {"q8": bp["wqkv"]["q8"].contiguous(), "sc": bp["wqkv"]["sc"]}
    with pytest.raises(ValueError):  # weight not in the (out, in) layout
        fm.ln_gemm_bias(x, bp["ln"], row_major, bp["bqkv"], 1e-6)
    with pytest.raises(ValueError):  # C not a multiple of 32
        xs = torch.zeros(64, 48, device=dev, dtype=torch.bfloat16)
        w = quantize_weight(torch.zeros(48, 64, device=dev))
        fm.ln_gemm_bias(xs, xs[0], w, torch.zeros(64, device=dev), 1e-6)
    with pytest.raises(TypeError):  # B6 takes int8 rows
        fm.dual_gemm_silu_quant(x, torch.ones(64, 1, device=dev),
                                bp["wgu_p"], bp["bgu_p"])
    with pytest.raises(ValueError):  # [wg | wu] not padded to 2 x 64k
        odd = {"q8": bp["wgu_p"]["q8"][:, :448], "sc": bp["wgu_p"]["sc"][:448]}
        fm.ln_dual_gemm_silu_quant(x, bp["ln"], odd, bp["bgu_p"][:448], 1e-6)
    with pytest.raises(ValueError, match="multiple of 32"):  # C = 0
        fm.ln_gemm_bias(x[:, :0], bp["ln"][:0], bp["wqkv"], bp["bqkv"], 1e-6)
    with pytest.raises(ValueError, match="wider"):  # Np past 16 CTAs' slices
        wide = fused_block(dev, 160, 480, 16 * 4 * 64 + 64, 0)
        fm.ln_dual_gemm_silu_quant(x, wide["ln"], wide["wgu_p"],
                                   wide["bgu_p"], 1e-6)


@pytest.mark.parametrize("rows", [5, 17, 3600])
def test_int8_products_on_the_card(dev, rows):
    """torch._int_mm needs more than 16 rows on CUDA; int_mm pads fewer
    (the final prefill act-quantizes a suffix of any length). Exact against
    an int64 product; qdot's act-quant path equals its CPU result."""
    gen = torch.Generator(device=dev).manual_seed(rows)
    a = torch.randint(-127, 128, (rows, 3584), generator=gen, device=dev,
                      dtype=torch.int8)
    w = quantize_weight(torch.randn(3584, 512, generator=gen, device=dev))
    got = int_mm(a, w["q8"])
    ref = a.cpu().long() @ w["q8"].cpu().long()
    assert torch.equal(got.cpu().long(), ref)
    x = torch.randn(rows, 3584, generator=gen, device=dev).bfloat16()
    on_card = qdot(x, w, min_rows=0)
    on_cpu = qdot(x.cpu(), {k: v.cpu() for k, v in w.items()}, min_rows=0)
    torch.testing.assert_close(on_card.cpu(), on_cpu, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k,n", [(1280, 3420), (3420, 1280), (20, 12)])
def test_int8_products_off_the_multiple_of_8(dev, k, n):
    """The vision MLP's unfused int8 chain (the head-major route without
    the B4 prep) multiplies by 3420-wide weights, which torch._int_mm
    takes only as multiples of 8: int_mm pads with zeros, exactly."""
    gen = torch.Generator(device=dev).manual_seed(k)
    a = torch.randint(-127, 128, (40, k), generator=gen, device=dev,
                      dtype=torch.int8)
    w = quantize_weight(torch.randn(k, n, generator=gen, device=dev))
    got = int_mm(a, w["q8"])
    assert got.shape == (40, n)
    ref = a.cpu().long() @ w["q8"].cpu().long()
    assert torch.equal(got.cpu().long(), ref)


class _Reader:
    """The native InterleavedVideoReader's surface over seeded frames."""

    def __init__(self):
        self.source_height = self.source_width = 224
        self.height = self.width = None
        self.interpolation = None
        self.output_format = "RGB"
        self.frame_iter = 1
        self.closed = False
        self._pos = 0

    def __len__(self):
        return 48

    def get_fps(self):
        return 8.0

    def process(self, indices):
        n = self.height * self.width * 3 // 2
        self.frames = np.stack([
            np.random.default_rng(i).integers(0, 256, n, dtype=np.uint8)
            for i in indices
        ])

    def __next__(self):
        block = self.frames[self._pos : self._pos + self.frame_iter]
        self._pos += len(block)
        return block

    def close(self):
        self.closed = True


def test_stream_uploads_on_a_side_stream(dev):
    """Pinned host -> device copies on the side stream, handed over with an
    event: the consumer sees every frame group intact, in order."""
    from quickvideo_tpu_torch.config import LVUConfig
    from quickvideo_tpu_torch.video.stream import AsyncPixelGroups

    cfg = LVUConfig(num_frames=24, video_group_size=8, decode_output="yuv420")
    reader = _Reader()
    stream = AsyncPixelGroups("clip.mp4", cfg, device=dev, reader=reader)
    try:
        got = [t.cpu().numpy() for t in stream]
    finally:
        stream.close()
    assert reader.closed and len(got) == len(stream.plan.group_frame_counts)
    np.testing.assert_array_equal(np.concatenate(got), reader.frames)


def test_stream_without_prefetch_yields_host_blocks(dev):
    """prefetch_to_device=False (ROADMAP C18): one decode thread, CPU
    tensors for the consumer to upload, the same frames in order."""
    from quickvideo_tpu_torch.config import LVUConfig
    from quickvideo_tpu_torch.video.stream import AsyncPixelGroups

    cfg = LVUConfig(num_frames=24, video_group_size=8, decode_output="yuv420",
                    prefetch_to_device=False)
    reader = _Reader()
    stream = AsyncPixelGroups("clip.mp4", cfg, device=dev, reader=reader)
    try:
        names = [t.name for t in stream._threads]
        got = list(stream)
    finally:
        stream.close()
    assert names == ["qv-decode"] and stream._side is None
    assert all(t.device.type == "cpu" for t in got)
    np.testing.assert_array_equal(np.concatenate([t.numpy() for t in got]),
                                  reader.frames)


def test_stream_consumed_on_another_thread_waits_on_its_stream(dev):
    """The server's worker thread iterates the stream with a current stream
    of its own: the upload events are waited on by that stream."""
    import threading

    from quickvideo_tpu_torch.config import LVUConfig
    from quickvideo_tpu_torch.video.stream import AsyncPixelGroups

    cfg = LVUConfig(num_frames=24, video_group_size=8, decode_output="yuv420")
    reader = _Reader()
    out = {}

    def worker():
        torch.cuda.set_device(dev)
        s = torch.cuda.Stream(dev)
        with torch.cuda.stream(s):
            stream = AsyncPixelGroups("clip.mp4", cfg, device=dev,
                                      reader=reader)
            try:
                # a product on the worker's stream right after the hand-off
                out["sums"] = [int(t.to(torch.int64).sum()) for t in stream]
            finally:
                stream.close()

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    want = [int(g.astype(np.int64).sum())
            for g in np.split(reader.frames, [8, 16])]
    assert out["sums"] == want


@pytest.mark.parametrize("src,out", [((480, 854), (280, 504)),
                                     ((300, 330), (308, 336))])
def test_lanczos3_resize_on_the_card_matches_the_cpu(dev, src, out):
    """The on-device resize's two f32 products on the card (TF32 off, as
    torch's default) against the same function on the CPU."""
    from quickvideo_tpu_torch.ops.resize import lanczos3_resize

    assert not torch.backends.cuda.matmul.allow_tf32
    x = torch.randint(0, 256, (8, 3, *src), generator=torch.Generator()
                      .manual_seed(0)).float()
    got = lanczos3_resize(x.to(dev), out).cpu()
    want = lanczos3_resize(x, out)
    assert (got - want).abs().max().item() <= 1e-3


def test_lvu_on_the_default_device_names_its_card(dev):
    """LVU() and LVU(device="cuda") resolve to the current card's index, so
    a thread that serves the LVU (the server's worker) can select it."""
    from quickvideo_tpu_torch.api import LVU
    from quickvideo_tpu_torch.config import LVUConfig

    cfg = LVUConfig(model_name_or_path="tiny", dtype="float32")
    want = torch.device("cuda", torch.cuda.current_device())
    for device in (None, "cuda"):
        assert LVU(cfg, device=device).device == want


def _narrow_model():
    """Two decoder layers at the 7B's head width (7 q heads, 1 kv head)
    and two vision blocks at head_dim 80: the smallest model the card's
    kernels take (chip_smoke.py::narrow_config)."""
    from quickvideo_tpu_torch.models.qwen25_vl.config import (
        ModelConfig,
        TextConfig,
        VisionConfig,
    )

    return ModelConfig(
        name="narrow128",
        vision=VisionConfig(
            depth=2, hidden_size=160, intermediate_size=256, num_heads=2,
            fullatt_block_indexes=(1,), out_hidden_size=896,
        ),
        text=TextConfig(
            vocab_size=2048, hidden_size=896, intermediate_size=1024,
            num_hidden_layers=2, num_attention_heads=7,
            num_key_value_heads=1,
        ),
        image_token_id=2040, video_token_id=2041,
        vision_start_token_id=2042, vision_end_token_id=2043,
    )


def test_a_request_waits_for_the_card_only_inside_host_wait_spans(
        dev, monkeypatch):
    """Two streamed requests with the benchmark's options (int8 weights,
    pruning at every layer, several tokens; the first one cold) under
    torch.cuda.set_sync_debug_mode("error"), which only the port's
    "host_wait" spans lift: a wait for the card without the span fails
    the test. Prints the sites of the spans it passed through."""
    from quickvideo_tpu_torch import api
    from quickvideo_tpu_torch.config import LVUConfig
    from quickvideo_tpu_torch.models.qwen25_vl.convert import init_params
    from quickvideo_tpu_torch.utils import timing
    from quickvideo_tpu_torch.video import quickdecode as qd

    model = _narrow_model()
    monkeypatch.setattr(api, "get_config", lambda name: model)
    monkeypatch.setattr(qd, "InterleavedVideoReader",
                        lambda path, **kw: _Reader())
    named, sites = timing.host_wait, collections.Counter()

    @contextlib.contextmanager
    def lifted():
        site = traceback.extract_stack()[-3]
        sites[f"{site.filename.rsplit('/', 1)[-1]}:{site.lineno}"] += 1
        torch.cuda.set_sync_debug_mode(0)
        try:
            with named():
                yield
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(timing, "host_wait", lifted)
    cfg = LVUConfig(model_name_or_path="narrow128",
                    model_type="qwen25_lvu_interleaved", param_dtype="int8",
                    num_frames=16, video_group_size=8,
                    top_k_predict_type="key_norms_small", top_p=0.5,
                    max_decode_tokens=16, decode_output="yuv420")
    lvu = api.LVU(cfg, params=init_params(model, 0, torch.bfloat16,
                                          device=dev), device=dev)
    torch.cuda.synchronize(dev)
    tokens = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            lvu.generate("what moves?", "clip.mp4", max_new_tokens=6)
            tokens.append(len(lvu.last_result.tokens))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print("host_wait sites:", dict(sorted(sites.items())))
    assert all(n >= 1 for n in tokens) and sites
