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
    frames = np.zeros((2, 3, 200, 200), np.uint8)
    with pytest.raises(NotImplementedError, match="resize"):
        tmodel.encode_video_group(
            params[1], CFG, torch.from_numpy(frames), (1, 16, 16)
        )


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


INT8_REL_L2 = 3e-2


@pytest.mark.parametrize("hw", [280, 224])
def test_int8_tower_matches_jax_interpret(monkeypatch, hw):
    """int8 weights, every product act-quantized in both packages (gates
    lowered to 16 columns, as on the 7B where every width passes): the
    port (B3/B4 plain versions) against the JAX tower on its kernel route
    (QV_PALLAS_INTERPRET=1, padded heads, fused MLP prep). f32 tower. The
    two differ in where bf16 rounding falls inside the attention (the
    port's B2 rounds rotary q/k to bf16 as its kernel stages them, the JAX
    kernel keeps them f32 on an f32 tower) and in ulps of the prologue's
    row sums; each int8 re-quantization carries those on as occasional
    code flips. Measured rel. L2 ~1.1e-2 through 4 blocks and the merger;
    the tolerance is 3e-2."""
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


def test_int8_tower_needs_the_mlp_prep():
    from quickvideo_tpu_torch.ops import quantization as tq

    p = tq.quantize_vision_params(init_params(CFG, seed=0)["vision"])
    frames = np.zeros((2, 224 * 224 * 3 // 2), np.uint8)
    with pytest.raises(ValueError, match="fuse_vision_mlp_weights"):
        tmodel.encode_video_group(
            {"vision": p}, CFG, torch.from_numpy(frames), (1, 16, 16)
        )

