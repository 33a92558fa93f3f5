"""Vision tower of the PyTorch port against the JAX package's, on the tiny
preset in f32, with identical weights and inputs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quickvideo_tpu.models.qwen25_vl import get_config
from quickvideo_tpu.models.qwen25_vl import model as jmodel
from quickvideo_tpu_torch.models.qwen25_vl import model as tmodel
from quickvideo_tpu_torch.models.qwen25_vl.convert import (
    init_params,
    params_from_jax,
)

torch.set_num_threads(2)

CFG = get_config("tiny")
# f32 on both sides through 4 blocks and the merger; only summation order
# and transcendental implementations differ
ATOL = RTOL = 1e-4


@pytest.fixture(scope="module")
def params():
    jp = jmodel.init_params(CFG, seed=0, dtype=jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _both(params, pixels, grid):
    jp, tp = params
    ref = np.asarray(jmodel.encode_video_group(jp, CFG, jnp.asarray(pixels), grid))
    got = tmodel.encode_video_group(tp, CFG, torch.from_numpy(pixels), grid)
    return got.numpy(), ref


@pytest.mark.parametrize("hw", [280, 224])  # ragged (10 units) / uniform (8)
def test_yuv420_frames_match_jax(params, hw):
    """Packed yuv420 uint8 frames: color conversion, patchify, normalize,
    window order (bucketed windows at 280x280), blocks, merger."""
    frames = np.random.default_rng(hw).integers(
        0, 256, (4, hw * hw * 3 // 2), dtype=np.uint8
    )
    grid = (2, hw // 14, hw // 14)
    layout = tmodel.layout_for(CFG, grid)
    assert layout.win_uniform == (hw == 224)
    got, ref = _both(params, frames, grid)
    assert got.shape == (2 * (hw // 28) ** 2, CFG.vision.out_hidden_size)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_rgb_frames_match_jax(params):
    frames = np.random.default_rng(5).integers(
        0, 256, (3, 3, 196, 252), dtype=np.uint8
    )  # odd frame count: the last frame repeats into the temporal patch
    got, ref = _both(params, frames, (2, 14, 18))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_patchified_float_input_matches_jax(params):
    grid = (2, 16, 16)
    pix = np.random.default_rng(2).standard_normal(
        (2 * 16 * 16, CFG.vision.patch_input_dim)
    ).astype(np.float32)
    got, ref = _both(params, pix, grid)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_frames_off_the_model_grid_need_the_unported_resize(params):
    """RGB frames at another size than the model grid are resampled to it
    on the device (lanczos3, as jax.image.resize in the JAX tower), then
    normalized from the 0..255 scale. The name dates from when the port
    refused such frames; it is kept so the test's record carries on."""
    frames = np.random.default_rng(6).integers(
        0, 256, (2, 3, 200, 200), dtype=np.uint8
    )
    got, ref = _both(params, frames, (1, 16, 16))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_merger_keeps_the_f32_product_before_gelu(monkeypatch):
    """bf16 tower: the merger's first product stays f32 before the f32 bias
    and GELU (the JAX package's vision.py:709, qdot(xm, w1) + b1 in f32).
    Rounding the product to bf16 first is off by up to half a bf16 step,
    about 2e-3 of its magnitude; the f32 replay agrees to f32 summation
    noise, within 1e-5 of the largest value."""
    from quickvideo_tpu_torch.models.qwen25_vl import vision as tvision

    vc = CFG.vision
    p = init_params(CFG, seed=1, dtype=torch.bfloat16)["vision"]
    gen = torch.Generator().manual_seed(2)
    p["merger"]["b1"] = torch.randn(
        p["merger"]["b1"].shape, generator=gen
    ).bfloat16()
    # the blocks are not what this test is about
    monkeypatch.setattr(tvision, "vision_block", lambda bp, x, *a, **k: x)
    seen = []
    gelu = torch.nn.functional.gelu

    def spy(h, *a, **k):
        seen.append(h)
        return gelu(h, *a, **k)

    monkeypatch.setattr(torch.nn.functional, "gelu", spy)
    grid = (2, 8, 8)
    pix = torch.from_numpy(
        np.random.default_rng(3).standard_normal(
            (2 * 8 * 8, vc.patch_input_dim)
        ).astype(np.float32)
    ).bfloat16()
    layout = tvision.build_layout(
        grid, vc.patch_size, vc.spatial_merge_size, vc.window_size,
        vc.head_dim,
    )
    tvision.vision_forward(p, pix, layout, vc)
    (h,) = seen
    x = (pix @ p["patch_embed"])[torch.as_tensor(layout.perm)]
    xm = tvision._rms_norm(x, p["merger"]["ln_q"], vc.rms_norm_eps)
    xm = xm.reshape(-1, vc.spatial_merge_unit * vc.hidden_size)
    ref = xm.float() @ p["merger"]["w1"].float() + p["merger"]["b1"].float()
    assert h.dtype == torch.float32
    assert (h - ref).abs().max() <= 1e-5 * ref.abs().max()


# int8 towers, port against JAX, gates lowered to 16 columns (as on the 7B,
# where every width passes): both act-quantize only the MLP chain and B3
# (the JAX package's qdot_vision default) and differ in f32 summation order
# alone. Measured rel. L2 4.8e-6 to 5.8e-6 on the 2D route and 6e-7 to
# 9e-7 head-major (1.1e-2 while the port act-quantized every product); an
# int8 code flipped by those ulps would show as ~1e-3.
INT8_REL_L2 = 1e-4


@pytest.mark.parametrize("hw", [280, 224])
def test_int8_tower_matches_jax_interpret(monkeypatch, hw):
    """int8 weights, gates lowered: the port (B3/B4 plain versions) against
    the JAX tower on its kernel route (QV_PALLAS_INTERPRET=1, padded heads,
    fused MLP prep). f32 tower; tolerance INT8_REL_L2."""
    from quickvideo_tpu.models.qwen25_vl import vision as jvision
    from quickvideo_tpu.ops import fused_vision_mlp as jfm
    from quickvideo_tpu.ops import quantization as jq
    from quickvideo_tpu_torch.ops import fused_vision_mlp as tfm
    from quickvideo_tpu_torch.ops import quantization as tq

    monkeypatch.setattr(jq, "_ACT_MIN_DIM", 16)
    monkeypatch.setattr(tq, "ACT_MIN_DIM", 16)
    vc = CFG.vision
    jp = jmodel.init_params(CFG, seed=0, dtype=jnp.float32)["vision"]
    jv = jax.tree.map(np.asarray, jq.quantize_vision_params(jp))
    tp = tfm.fuse_vision_mlp_weights(
        params_from_jax({"vision": jv})["vision"], vc
    )
    jv = jfm.fuse_vision_mlp_weights(
        jvision.add_padded_block_weights(jax.tree.map(jnp.asarray, jv), vc),
        vc,
    )
    frames = np.random.default_rng(hw).integers(
        0, 256, (4, hw * hw * 3 // 2), dtype=np.uint8
    )
    grid = (2, hw // 14, hw // 14)
    monkeypatch.setenv("QV_PALLAS_INTERPRET", "1")
    ref = np.asarray(jmodel.encode_video_group(
        {"vision": jv}, CFG, jnp.asarray(frames), grid
    ))
    monkeypatch.delenv("QV_PALLAS_INTERPRET")
    got = tmodel.encode_video_group(
        {"vision": tp}, CFG, torch.from_numpy(frames), grid
    ).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel <= INT8_REL_L2, rel


def _int8_trees(vc):
    """The tiny tower's int8 weights: (JAX tree, port tree), same codes."""
    from quickvideo_tpu.ops import quantization as jq

    jp = jmodel.init_params(CFG, seed=0, dtype=jnp.float32)["vision"]
    jv = jax.tree.map(np.asarray, jq.quantize_vision_params(jp))
    return jv, params_from_jax({"vision": jv})["vision"]


def _frames(hw, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (4, hw * hw * 3 // 2), dtype=np.uint8
    )


def _jax_tower(monkeypatch, jv, pixels, grid):
    """The JAX tower on its kernel route (QV_PALLAS_INTERPRET=1): the
    Pallas kernels in interpret mode, XLA where its tiling rule refuses."""
    monkeypatch.setenv("QV_PALLAS_INTERPRET", "1")
    jax.clear_caches()
    try:
        return np.asarray(jmodel.encode_video_group(
            {"vision": jax.tree.map(jnp.asarray, jv)}, CFG,
            jnp.asarray(pixels), grid,
        ))
    finally:
        monkeypatch.delenv("QV_PALLAS_INTERPRET")
        jax.clear_caches()


def test_int8_tower_needs_the_mlp_prep(monkeypatch):
    """The tower no longer needs the B4 prep: an int8 tower without it
    (no `wgu_p`) runs the unfused act-quantized MLP chain
    (vision.py:534-540), as the JAX tower does without its prep, and
    matches it within INT8_REL_L2 (gates lowered as above)."""
    from quickvideo_tpu.ops import quantization as jq
    from quickvideo_tpu_torch.ops import quantization as tq

    monkeypatch.setattr(jq, "_ACT_MIN_DIM", 16)
    monkeypatch.setattr(tq, "ACT_MIN_DIM", 16)
    jv, tp = _int8_trees(CFG.vision)
    assert not any("wgu_p" in bp for bp in tp["blocks"])
    frames = _frames(224, 4)
    grid = (2, 16, 16)
    ref = _jax_tower(monkeypatch, jv, frames, grid)
    got = tmodel.encode_video_group(
        {"vision": tp}, CFG, torch.from_numpy(frames), grid
    ).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel <= INT8_REL_L2, rel


VISION_PRODUCTS = ("patch_embed", "wqkv", "wo", "w1", "w2")


@pytest.mark.parametrize("route", ["1", "0"])  # QV_VISION_2D
def test_int8_vision_products_are_weight_only_as_in_jax(monkeypatch, route):
    """C13: at lowered gates (both packages' ACT_MIN_DIM and ACT_MIN_ROWS),
    the tower's patch embed, attention QKV (head-major route; the 2D route
    runs B3), attention output and merger products are weight-only, as the
    JAX package's qdot_vision makes them: each product, as the tower
    called it, equals JAX's qdot_vision on the same operands (f32
    summation order: 1e-5), and an act-quantized product would not."""
    from quickvideo_tpu.ops import quantization as jq
    from quickvideo_tpu_torch.models.qwen25_vl import vision as tvision
    from quickvideo_tpu_torch.ops import quantization as tq

    for mod, dim, rows in ((jq, "_ACT_MIN_DIM", "_ACT_MIN_ROWS"),
                           (tq, "ACT_MIN_DIM", "ACT_MIN_ROWS")):
        monkeypatch.setattr(mod, dim, 16)
        monkeypatch.setattr(mod, rows, 1)
    monkeypatch.setenv("QV_VISION_2D", route)
    _, tp = _int8_trees(CFG.vision)
    names = {id(tp["patch_embed"]["q8"]): "patch_embed",
             id(tp["merger"]["w1"]["q8"]): "w1",
             id(tp["merger"]["w2"]["q8"]): "w2"}
    for bp in tp["blocks"]:
        names[id(bp["wqkv"]["q8"])] = "wqkv"
        names[id(bp["wo"]["q8"])] = "wo"
    seen = []

    def spy(fn):
        def wrapped(x, w, *a, **k):
            y = fn(x, w, *a, **k)
            if isinstance(w, dict) and id(w.get("q8")) in names:
                seen.append((names[id(w["q8"])], x, w, y))
            return y
        return wrapped

    monkeypatch.setattr(tvision, "linear", spy(tvision.linear))
    monkeypatch.setattr(tvision, "qdot", spy(tvision.qdot))
    tmodel.encode_video_group({"vision": tp}, CFG,
                              torch.from_numpy(_frames(224, 6)), (2, 16, 16))
    want = set(VISION_PRODUCTS) - ({"wqkv"} if route == "1" else set())
    assert {name for name, *_ in seen} == want
    for name, x, w, y in seen:
        xj = jnp.asarray(x.float().numpy()).astype(
            jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32)
        wj = {"q8": jnp.asarray(w["q8"].numpy()),
              "sc": jnp.asarray(w["sc"].numpy())}
        ref = np.asarray(jq.qdot_vision(xj, wj))
        np.testing.assert_allclose(y.float().numpy(), ref, rtol=1e-5,
                                   atol=1e-5, err_msg=name)
        act = np.asarray(jq.qdot(xj, wj, act_quant=True))
        assert not np.allclose(act, ref, rtol=1e-5, atol=1e-5), name


@pytest.mark.parametrize("hw", [280, 224])  # ragged (10 units) / uniform (8)
def test_bf16_tower_matches_jax_on_both_routes(monkeypatch, hw):
    """C14: a bf16 tower (bf16 weights and activations) on the 2D and the
    head-major route against the JAX tower on the same route
    (QV_PALLAS_INTERPRET=1). Both packages rotate in bf16 from bf16 tables
    on either route, so each package's two routes agree bit for bit (the
    port's did not while B2 rotated in f32). Against JAX: within 2 bf16
    steps at the output's largest magnitude and rel. L2 3e-3 (measured 1
    step and 1.3e-3 to 1.4e-3: bf16 products and norms round at other
    points of their f32 sums)."""
    jp = jmodel.init_params(CFG, seed=0, dtype=jnp.bfloat16)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    frames = _frames(hw, hw + 7)
    grid = (2, hw // 14, hw // 14)
    got = {}
    for route in ("1", "0"):
        monkeypatch.setenv("QV_VISION_2D", route)
        ref = _jax_tower(monkeypatch, jp["vision"], frames, grid)
        ref = ref.astype(np.float32)
        out = tmodel.encode_video_group(tp, CFG, torch.from_numpy(frames),
                                        grid)
        assert out.dtype == torch.bfloat16
        got[route] = out.float().numpy()
        step = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
        assert np.abs(got[route] - ref).max() <= 2 * step
        rel = np.linalg.norm(got[route] - ref) / np.linalg.norm(ref)
        assert rel <= 3e-3, (route, rel)
    np.testing.assert_array_equal(got["1"], got["0"])


def _count_attention_calls(monkeypatch):
    """Counts of the port's plain B2 and B5 calls (the CPU path)."""
    from quickvideo_tpu_torch.ops import vision_attention as tva

    calls = {"b2": 0, "b5": 0}
    for key, name in (("b2", "block_diag_attention_2d_plain"),
                      ("b5", "block_diag_attention_plain")):
        fn = getattr(tva, name)

        def spy(*a, _fn=fn, _key=key, **k):
            calls[_key] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(tva, name, spy)
    return calls


@pytest.mark.parametrize("hw", [280, 224])  # ragged (10 units) / uniform (8)
def test_head_major_tower_matches_jax(params, monkeypatch, hw):
    """QV_VISION_2D=0 in both packages: rotary outside in the activation
    dtype, B5 per bucket and per frame (the JAX tower: B5 in interpret mode
    where its tiling rule takes the span, XLA elsewhere)."""
    jp, tp = params
    monkeypatch.setenv("QV_VISION_2D", "0")
    frames = _frames(hw, hw)
    grid = (2, hw // 14, hw // 14)
    calls = _count_attention_calls(monkeypatch)
    ref = _jax_tower(monkeypatch, jp["vision"], frames, grid)
    got = tmodel.encode_video_group(tp, CFG, torch.from_numpy(frames), grid)
    layout = tmodel.layout_for(CFG, grid)
    n_full = len(CFG.vision.fullatt_block_indexes)
    per_window_block = len(layout.buckets) or 1
    assert calls == {"b2": 0, "b5": n_full + (CFG.vision.depth - n_full)
                     * per_window_block}
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_default_env_takes_the_head_major_route_where_the_jax_tower_does(
    params, monkeypatch,
):
    """Default environment, an image's grid (1, 10, 10): windows of 64, 16
    and 4 rows and one 100-row frame. The JAX tiling rule takes the 64- and
    16-row buckets but not the 4-row one nor the frame, so every block goes
    head-major there, and in the port: B5 runs, B2 does not."""
    from quickvideo_tpu.ops import vision_attention as jva

    jp, tp = params
    monkeypatch.delenv("QV_VISION_2D", raising=False)
    grid = (1, 10, 10)
    layout = tmodel.layout_for(CFG, grid)
    assert [span for span, _, _ in layout.buckets] == [64, 16, 4]
    assert [jva.kernel_applicable(b - a, span)
            for span, a, b in layout.buckets] == [True, True, False]
    assert not jva.kernel_applicable(100, 100)
    frame = np.random.default_rng(8).integers(
        0, 256, (1, 3, 140, 140), dtype=np.uint8
    )
    calls = _count_attention_calls(monkeypatch)
    ref = _jax_tower(monkeypatch, jp["vision"], frame, grid)
    got = tmodel.encode_video_group(tp, CFG, torch.from_numpy(frame), grid)
    n_full = len(CFG.vision.fullatt_block_indexes)
    assert calls == {"b2": 0, "b5": n_full + 3 * (CFG.vision.depth - n_full)}
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("hw", [280, 224])
def test_int8_head_major_tower_matches_jax(monkeypatch, hw):
    """int8 weights under QV_VISION_2D=0 in both packages: no B3 and, as
    both engines skip the MLP prep there, no B4; QKV and the attention
    output weight-only, the MLP chain act-quantized (gates lowered as
    above); tolerance INT8_REL_L2."""
    from quickvideo_tpu.ops import quantization as jq
    from quickvideo_tpu_torch.ops import fused_vision_mlp as tfm
    from quickvideo_tpu_torch.ops import quantization as tq

    monkeypatch.setattr(jq, "_ACT_MIN_DIM", 16)
    monkeypatch.setattr(tq, "ACT_MIN_DIM", 16)
    monkeypatch.setenv("QV_VISION_2D", "0")
    for name in ("ln_gemm_bias", "ln_dual_gemm_silu_quant"):
        monkeypatch.setattr(tfm, name + "_plain", None)  # must not run
    jv, tp = _int8_trees(CFG.vision)
    frames = _frames(hw, hw + 1)
    grid = (2, hw // 14, hw // 14)
    ref = _jax_tower(monkeypatch, jv, frames, grid)
    got = tmodel.encode_video_group(
        {"vision": tp}, CFG, torch.from_numpy(frames), grid
    ).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel <= INT8_REL_L2, rel
