"""Continuation scoring in the PyTorch port against the JAX engine, on the
tiny preset in f32 with identical weights and inputs: the total
log-probability of each continuation within SCORE_ATOL of the JAX engine's
and the same is_greedy, for requests with a video, with an image beside it
and with an image alone; several continuations against one prefill equal
the single calls; LVU.loglikelihood(_multi) through both packages; and the
refused inputs (an empty suffix, ROADMAP C2; an empty or over-long
continuation)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quickvideo_tpu.api import LVU as JLVU
from quickvideo_tpu.prefill import LVUEngine as JEngine
from quickvideo_tpu.prefill import PrefillInputs as JInputs
from quickvideo_tpu_torch.api import LVU as TLVU
from quickvideo_tpu_torch.prefill import LVUEngine, PrefillInputs
from quickvideo_tpu_torch.utils.timing import SpanTimer

from test_torch_engine import CFG, TCFG, build_request, configs, params  # noqa: F401
from test_torch_images import _patch_readers, build_image_request

torch.set_num_threads(2)

# f32 on both sides: the two packages' sums differ in order only; measured
# differences are up to 7.6e-6 (the int8 cache's case)
SCORE_ATOL = 1e-4


def _request(kind):
    """(port inputs, JAX inputs) of a video, image-beside-video or
    image-only request."""
    if kind == "video":
        ids, grid, groups, grids = build_request()
        return (PrefillInputs(ids, grid, groups, grids, 2.0),
                JInputs(ids, grid, groups, grids, 2.0))
    pos = {"image after the video": "suffix", "image before the video":
           "prefix", "image only": "only"}[kind]
    ids, grid, groups, grids, img_grids, img_px = build_image_request(pos)
    kw = dict(image_grid_thw=img_grids, image_pixels=img_px)
    return (PrefillInputs(ids, grid, groups, grids, 2.0, **kw),
            JInputs(ids, grid, groups, grids, 2.0, **kw))


def _continuations(eng, inputs_fn):
    """Continuations of 1, 3 and 6 tokens, the last the greedy answer."""
    greedy = eng.generate(inputs_fn(), max_new_tokens=6).tokens.tolist()
    rng = np.random.default_rng(4)
    return [[int(rng.integers(5, 900))],
            rng.integers(5, 900, 3).tolist(), greedy]


def _jax_scores(jp, jlvu, jinputs, conts, monkeypatch, kernel_route):
    if kernel_route:
        monkeypatch.setenv("QV_PALLAS_INTERPRET", "1")
        jax.clear_caches()
    try:
        return JEngine(jp, CFG, jlvu, dtype=jnp.float32).score_continuations(
            jinputs, conts)
    finally:
        if kernel_route:
            monkeypatch.delenv("QV_PALLAS_INTERPRET")
            jax.clear_caches()


@pytest.mark.parametrize("kind,top_p,kv", [
    ("video", None, "bfloat16"), ("video", 0.5, "bfloat16"),
    ("video", 0.5, "int8"), ("image after the video", None, "bfloat16"),
    ("image before the video", 0.5, "bfloat16"),
    ("image only", None, "bfloat16"),
])
def test_scores_equal_the_jax_engines(params, monkeypatch, kind, top_p, kv):
    """Images and int8 caches on the JAX kernel route (interpret mode), as
    tests/test_torch_images.py and test_torch_engine.py run them."""
    jp, tp = params
    kernel_route = kind != "video" or kv != "bfloat16"
    jlvu, tlvu = configs(model_name_or_path="tiny", top_p=top_p,
                         max_decode_tokens=8, kv_cache_dtype=kv,
                         attention_impl="pallas" if kernel_route else "auto")
    eng = LVUEngine(tp, TCFG, tlvu, dtype=torch.float32)
    conts = _continuations(eng, lambda: _request(kind)[0])
    got = eng.score_continuations(_request(kind)[0], conts)
    want = _jax_scores(jp, jlvu, _request(kind)[1], conts, monkeypatch,
                       kernel_route)
    assert [g for _, g in got] == [g for _, g in want]
    np.testing.assert_allclose([t for t, _ in got], [t for t, _ in want],
                               atol=SCORE_ATOL, rtol=0)
    assert got[-1][1]  # the greedy answer is greedy
    assert all(np.isfinite(t) and t < 0 for t, _ in got)


def test_several_continuations_equal_single_calls(params):
    """One shared prefill with the lengths restored between options gives
    each option's own score; the lengths end as after the last option."""
    _, tp = params
    _, tlvu = configs(model_name_or_path="tiny", top_p=0.5,
                      max_decode_tokens=8)
    eng = LVUEngine(tp, TCFG, tlvu, dtype=torch.float32)
    conts = [[7, 8], [9], [10, 11, 12, 13], [7, 8]]
    multi = eng.score_continuations(_request("video")[0], conts)
    single = [eng.score_continuation(_request("video")[0], c) for c in conts]
    np.testing.assert_allclose([t for t, _ in multi], [t for t, _ in single],
                               atol=1e-6, rtol=0)
    assert [g for _, g in multi] == [g for _, g in single]
    assert multi[0] == multi[3]
    # the scored pass appends suffix + continuation; restored in between
    cache, state = eng.prefill(_request("video")[0])
    before = list(cache.lengths)
    eng._score_one(cache, state, np.array([7, 8]), SpanTimer(), restore=True)
    assert cache.lengths == before
    eng._score_one(cache, state, np.array([7, 8]), SpanTimer(), restore=False)
    suffix = state["L"] - state["suffix_start"]
    assert cache.lengths == [n + suffix + 2 for n in before]


def test_refused_inputs_raise(params):
    _, tp = params
    _, tlvu = configs(model_name_or_path="tiny", max_decode_tokens=8)
    eng = LVUEngine(tp, TCFG, tlvu, dtype=torch.float32)
    with pytest.raises(ValueError, match="empty"):
        eng.score_continuations(_request("video")[0], [[5], []])
    with pytest.raises(ValueError, match="max_decode_tokens"):
        eng.score_continuation(_request("video")[0], list(range(5, 14)))
    # C2: a request that ends with its video has no row to predict the
    # first continuation token (the JAX body drops its log-probability)
    ids, grid, groups, grids = build_request(n_post=0)
    ids = ids[:-1]  # drop the vision-end token too: the video ends the ids
    assert ids[-1] == CFG.video_token_id
    with pytest.raises(ValueError, match="ends with its video"):
        eng.score_continuation(PrefillInputs(ids, grid, groups, grids, 2.0),
                               [5, 6])


@pytest.mark.parametrize("model_type", ["qwen25_lvu", "qwen25_lvu_interleaved"])
def test_lvu_loglikelihood_matches_jax(params, monkeypatch, model_type):
    """LVU.loglikelihood and loglikelihood_multi of both packages, text and
    token-id continuations, with the video decoder replaced by the same
    fake."""
    jp, tp = params
    _patch_readers(monkeypatch)
    jcfg, tcfg = configs(model_name_or_path="tiny", model_type=model_type,
                         num_frames=8, video_group_size=4, top_p=0.5,
                         max_decode_tokens=8, decode_output="yuv420",
                         dtype="float32")
    jlvu, lvu = JLVU(jcfg, params=jp), TLVU(tcfg, params=tp, device="cpu")
    conts = [" A", " B.", [40, 41, 42]]
    want = jlvu.loglikelihood_multi("Which?", "clip.mp4", conts)
    got = lvu.loglikelihood_multi("Which?", "clip.mp4", conts)
    assert [g for _, g in got] == [g for _, g in want]
    np.testing.assert_allclose([t for t, _ in got], [t for t, _ in want],
                               atol=SCORE_ATOL, rtol=0)
    one = lvu.loglikelihood("Which?", "clip.mp4", " B.")
    assert one[1] == got[1][1] and abs(one[0] - got[1][0]) <= 1e-6
    # neither a video nor an image: both packages refuse the request
    for pkg in (jlvu, lvu):
        with pytest.raises(ValueError, match="no video tokens"):
            pkg.loglikelihood("Say it.", None, " yes")
