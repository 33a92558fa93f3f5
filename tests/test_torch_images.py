"""Image inputs of the PyTorch port against the JAX package's, on the tiny
preset in f32 with identical weights and inputs: greedy tokens, cache
length and KV bytes of LVUEngine.generate for an image before the video,
after it, and without a video; a suffix image under query-based pruning and
under do_top_k_for_query; LVU.chat with an image and a video for both chat
engines, and with an image alone; `_prepare_images` grids, token counts and
pixels.

The JAX engine runs its kernel route (attention_impl="pallas",
QV_PALLAS_INTERPRET=1). The image grid (1, 10, 10) takes the head-major
vision route by default in both packages: the JAX tiling rule refuses its
4-row window bucket and its 100-row frame (tests/test_torch_vision.py), so
B5 runs (interpret mode in JAX, the plain version in the port) beside
JAX's XLA block attention. Tokens and lengths are compared exactly."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quickvideo_tpu.api import LVU as JLVU
from quickvideo_tpu.engines import qwen25 as jengines
from quickvideo_tpu.prefill import LVUEngine as JEngine
from quickvideo_tpu.prefill import PrefillInputs as JInputs
from quickvideo_tpu.video import quickdecode as qd
from quickvideo_tpu.video import reader as jreader
from quickvideo_tpu_torch.api import LVU as TLVU
from quickvideo_tpu_torch.engines import qwen25 as tengines
from quickvideo_tpu_torch.prefill import LVUEngine, PrefillInputs
from quickvideo_tpu_torch.video import quickdecode as tqd
from quickvideo_tpu_torch.video import reader as treader
from test_torch_engine import (
    CFG,
    HW,
    TCFG,
    FakeInterleavedReader,
    _fake_decode_video_batch,
    configs,
    params,  # noqa: F401 - fixture
    params_int8,  # noqa: F401 - fixture
)

torch.set_num_threads(2)

IMG_GRID = (1, 10, 10)  # a 140 x 140 image: 25 merged tokens
VID_GROUPS_T = (2, 1)  # a group with one temporal patch, as a video's last


def _merged(grid):
    t, h, w = grid
    return t * (h // 2) * (w // 2)


def _image(seed):
    """One (1, 3, H, W) uint8 frame at IMG_GRID's size."""
    hw = IMG_GRID[1] * 14
    return np.random.default_rng(seed).integers(
        0, 256, (1, 3, hw, hw), dtype=np.uint8
    )


def build_image_request(image_pos, seed=3):
    """(ids, video grid, frame groups, group grids, image grids, image
    pixels): [text, (img), text, video, text, (img), text] with the image
    before or after the video, or [text, img, text] for "only"."""
    rng = np.random.default_rng(seed)
    img_span = np.concatenate([
        [CFG.vision_start_token_id],
        np.full(_merged(IMG_GRID), CFG.image_token_id),
        [CFG.vision_end_token_id],
    ])
    img = ([np.array([IMG_GRID])], [_image(seed + 10)])
    if image_pos == "only":
        ids = np.concatenate([rng.integers(5, 900, 4), img_span,
                              rng.integers(5, 900, 6)]).astype(np.int64)
        return ids, None, [], [], *img
    h = w = HW // 14
    t = sum(VID_GROUPS_T)
    vid_span = np.concatenate([
        [CFG.vision_start_token_id],
        np.full(_merged((t, h, w)), CFG.video_token_id),
        [CFG.vision_end_token_id],
    ])
    parts = [rng.integers(5, 900, 4)]
    if image_pos == "prefix":
        parts += [img_span, rng.integers(5, 900, 3), vid_span]
    else:
        parts += [vid_span, rng.integers(5, 900, 3), img_span]
    parts += [rng.integers(5, 900, 5)]
    ids = np.concatenate(parts).astype(np.int64)
    frames = rng.integers(0, 256, (2 * t, HW * HW * 3 // 2), dtype=np.uint8)
    groups, grids, off = [], [], 0
    for tg in VID_GROUPS_T:
        groups.append(frames[off : off + 2 * tg])
        grids.append((tg, h, w))
        off += 2 * tg
    return ids, (t, h, w), groups, grids, img[0][0], img[1]


def _both(params, monkeypatch, image_pos, **kw):  # noqa: F811
    """One image request through the JAX engine (kernel route) and the
    port's: (port result, JAX result, port engine)."""
    jp, tp = params
    ids, grid, groups, grids, img_grids, img_px = build_image_request(
        image_pos
    )
    jlvu, tlvu = configs(model_name_or_path="tiny", max_decode_tokens=8,
                         attention_impl="pallas", **kw)
    monkeypatch.setenv("QV_PALLAS_INTERPRET", "1")
    jax.clear_caches()
    ref = JEngine(jp, CFG, jlvu, dtype=jnp.float32).generate(
        JInputs(ids, grid, groups, grids, 2.0, image_grid_thw=img_grids,
                image_pixels=img_px),
        max_new_tokens=5,
    )
    monkeypatch.delenv("QV_PALLAS_INTERPRET")
    jax.clear_caches()
    eng = LVUEngine(tp, TCFG, tlvu, dtype=torch.float32)
    got = eng.generate(
        PrefillInputs(ids, grid, groups, grids, 2.0, image_grid_thw=img_grids,
                      image_pixels=img_px),
        max_new_tokens=5,
    )
    return got, ref, eng


@pytest.mark.parametrize("image_pos", ["prefix", "suffix", "only"])
@pytest.mark.parametrize("top_p", [None, 0.5])
def test_image_requests_match_the_jax_engine(params, monkeypatch,  # noqa: F811
                                             image_pos, top_p):
    got, ref, _ = _both(params, monkeypatch, image_pos, top_p=top_p)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    assert got.cache_length == ref.cache_length
    assert got.kv_cache_bytes == ref.kv_cache_bytes
    assert got.layer_lengths == [got.cache_length] * CFG.text.num_hidden_layers
    assert got.timings["vision"] > 0
    if image_pos == "only":  # the whole sequence in the final prefill
        assert got.cache_length == got.prefill_tokens + len(got.tokens) - 1


@pytest.mark.parametrize("top_k", [None, 16])
def test_suffix_image_under_query_based_pruning(params, monkeypatch,  # noqa: F811
                                                top_k):
    """The suffix image's placeholders ride in every group's prompt rows
    and are filled there (group 0 takes prefix then suffix images)."""
    got, ref, eng = _both(params, monkeypatch, "suffix", top_k=top_k,
                          top_k_predict_type="query_attention_weights")
    assert eng.lvu.query_based
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    assert got.cache_length == ref.cache_length


@pytest.mark.parametrize("top_k", [512, 16])
def test_suffix_image_with_do_top_k_for_query(params, monkeypatch,  # noqa: F811
                                              top_k):
    """The pruned final prefill scatters the suffix image too (top_k 512
    keeps every suffix row, 16 prunes it)."""
    got, ref, _ = _both(params, monkeypatch, "suffix", top_k=top_k,
                        do_top_k_for_query=True)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    assert got.cache_length == ref.cache_length


def test_image_placeholder_counts_are_checked(params):  # noqa: F811
    _, tp = params
    ids, grid, groups, grids, img_grids, img_px = build_image_request(
        "prefix"
    )
    eng = LVUEngine(tp, TCFG, configs(model_name_or_path="tiny")[1],
                    torch.float32)
    with pytest.raises(ValueError, match="image pixel arrays"):
        eng.generate(PrefillInputs(ids, grid, groups, grids, 2.0,
                                   image_grid_thw=img_grids, image_pixels=[]))
    with pytest.raises(ValueError, match="image placeholders"):
        eng.generate(PrefillInputs(
            ids, grid, groups, grids, 2.0,
            image_grid_thw=np.array([(1, 8, 8)]), image_pixels=[
                np.zeros((1, 3, 112, 112), np.uint8)
            ],
        ))
    with pytest.raises(ValueError, match="no images"):
        eng.generate(PrefillInputs(ids[:4], None, [], []))


def _patch_readers(monkeypatch):
    """Both packages' video decoders replaced by the seeded fake."""
    for mod in (qd, tqd):
        monkeypatch.setattr(mod, "InterleavedVideoReader",
                            FakeInterleavedReader)
    for mod in (jreader, treader):
        monkeypatch.setattr(mod, "decode_video_batch", functools.partial(
            _fake_decode_video_batch, mod.plan_from_reader
        ))
    monkeypatch.setenv("QV_COMPILE_CACHE", "0")


def _image_array(seed, h=140, w=140):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


@pytest.mark.parametrize("model_type", ["qwen25_lvu", "qwen25_lvu_interleaved"])
@pytest.mark.parametrize("with_video", [True, False])
def test_lvu_chat_with_images_matches_jax(params, monkeypatch,  # noqa: F811
                                          model_type, with_video):
    """LVU.chat of both packages on the same messages: an image before the
    video (seeded fake decoder) or an image alone, and a second image of
    another size (smart-resized with PIL) after the question's text."""
    jp, tp = params
    _patch_readers(monkeypatch)
    content = [{"type": "image", "image": _image_array(1)}]
    if with_video:
        content.append({"type": "video", "video": "clip.mp4"})
    content += [{"type": "text", "text": "Compare them."},
                {"type": "image", "image": _image_array(2, 100, 150)}]
    messages = [{"role": "user", "content": content}]
    jcfg, tcfg = configs(
        model_name_or_path="tiny", model_type=model_type, num_frames=8,
        video_group_size=4, top_p=0.5, max_decode_tokens=8,
        decode_output="yuv420", dtype="float32",
    )
    jlvu = JLVU(jcfg, params=jp)
    ref_text = jlvu.chat(messages, max_new_tokens=4)
    lvu = TLVU(tcfg, params=tp, device="cpu")
    text = lvu.chat(messages, max_new_tokens=4)
    assert text == ref_text
    res, want = lvu.last_result, jlvu.last_result
    np.testing.assert_array_equal(res.tokens, want.tokens)
    assert res.cache_length == want.cache_length
    assert res.prefill_tokens == want.prefill_tokens
    assert len(res.tokens) == 4


def test_prepare_images_matches_jax():
    """Grids, token counts and pixels of `_prepare_images`: HWC and CHW
    arrays, a size that smart_resize keeps, one it changes (PIL bicubic),
    explicit resized sizes and pixel bounds."""
    items = [
        {"image": _image_array(0)},
        {"image": _image_array(1, 100, 150).transpose(2, 0, 1)},
        {"image": _image_array(2, 480, 640)},
        {"image": _image_array(3, 90, 90), "resized_height": 60,
         "resized_width": 200},
        {"image": _image_array(4, 300, 500), "max_pixels": 128 * 28 * 28,
         "min_pixels": 8 * 28 * 28},
    ]
    got = tengines._prepare_images(TCFG, items)
    want = jengines._prepare_images(CFG, items)
    np.testing.assert_array_equal(got[1], want[1])
    assert list(got[2]) == list(want[2])
    assert len(got[0]) == len(want[0]) == len(items)
    for a, b in zip(got[0], want[0]):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    assert tuple(got[1][2]) == (1, 476 // 14, 644 // 14)  # a 480x640 photo
    with pytest.raises(ValueError, match="HWC/CHW"):
        tengines._prepare_images(TCFG, [{"image": np.zeros((4, 4))}])


def test_messages_keep_image_items_in_order():
    img_a, img_b = {"type": "image", "image": "a.png"}, {
        "type": "image", "image": "b.png"}
    messages = [{"role": "system", "content": "be brief"}, {
        "role": "user", "content": [
            img_a, {"type": "video", "video": "v.mp4", "fps": 2.0},
            {"type": "text", "text": "q?"}, img_b,
        ],
    }]
    got = tengines._question_from_messages(messages)
    assert got == jengines._question_from_messages(messages)
    assert got == ("v.mp4", "q?", {"fps": 2.0}, [img_a, img_b])


@pytest.mark.parametrize("param_dtype", ["float32", "int8"])
def test_forced_head_major_route_matches_the_jax_engine(
    params, params_int8, monkeypatch, param_dtype,  # noqa: F811
):
    """QV_VISION_2D=0 in both engines, an image before the video: every
    vision block on the head-major route. With int8 weights both engines
    skip the MLP prep there (no `wgu_p`), so the towers run the unfused
    int8 chain; the default keeps the prep."""
    monkeypatch.setenv("QV_VISION_2D", "0")
    jp, tp = params_int8 if param_dtype == "int8" else params
    kw = {} if param_dtype == "float32" else dict(param_dtype="int8")
    got, ref, eng = _both((jax.tree.map(jnp.asarray, jp), tp), monkeypatch,
                          "prefix", top_p=0.5, **kw)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    assert got.cache_length == ref.cache_length
    assert not any("wgu_p" in bp for bp in eng.params["vision"]["blocks"])
    if param_dtype == "int8":
        monkeypatch.delenv("QV_VISION_2D")
        prepped = LVUEngine(tp, TCFG, eng.lvu, dtype=torch.float32)
        assert all("wgu_p" in bp for bp in prepped.params["vision"]["blocks"])
