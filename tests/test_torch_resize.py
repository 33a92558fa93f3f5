"""The on-device resize (resize_on_device) of the PyTorch port against the
JAX package's, on the tiny preset in f32 with identical weights.

- `lanczos3_resize` against `jax.image.resize(..., "lanczos3",
  antialias=True)` over up- and down-scales: max abs <= 1e-3 on the 0..255
  scale (both sides in f32; they differ in sin's last bit and summation
  order);
- `vision_forward` with `native_hw` (packed yuv420 and RGB uint8 frames at
  the source size) against the JAX function, on its default and its
  kernel route (QV_PALLAS_INTERPRET=1), at the towers' f32 tolerance;
- the engine on source-size frames: greedy tokens, cache lengths and
  every retained index set equal to the JAX engine's;
- LVU.generate through the interleaved and the sync engine and a chat
  session, each package reading the same fake video at its source size
  through its own decoder registry: equal tokens.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quickvideo_tpu.api import LVU as JLVU
from quickvideo_tpu.models.qwen25_vl import model as jmodel
from quickvideo_tpu.models.qwen25_vl import vision as jvision
from quickvideo_tpu.prefill import LVUEngine as JEngine
from quickvideo_tpu.prefill import PrefillInputs as JInputs
from quickvideo_tpu.video import quickdecode as qd
from quickvideo_tpu.video import reader as jreader
from quickvideo_tpu_torch.api import LVU as TLVU
from quickvideo_tpu_torch.models.qwen25_vl import model as tmodel
from quickvideo_tpu_torch.models.qwen25_vl import vision as tvision
from quickvideo_tpu_torch.ops.resize import lanczos3_resize, lanczos3_weights
from quickvideo_tpu_torch.prefill import LVUEngine, PrefillInputs
from quickvideo_tpu_torch.video import quickdecode as tqd
from quickvideo_tpu_torch.video import reader as treader

from test_torch_engine import CFG, TCFG, configs, params  # noqa: F401
from test_torch_modes import _port_retained, jax_retained  # noqa: F401

torch.set_num_threads(2)

RESIZE_ATOL = 1e-3  # 0..255 scale
ATOL = RTOL = 1e-4  # the f32 towers' bound (test_torch_vision.py)


@pytest.mark.parametrize("src,out", [
    ((48, 86), (28, 56)),     # down both axes
    ((20, 30), (56, 84)),     # up both axes
    ((33, 17), (28, 28)),     # down one axis, up the other
    ((60, 28), (28, 28)),     # one axis unchanged (skipped, as in JAX)
    ((96, 170), (56, 112)),   # a 480p-like aspect, down by 1.7
    ((480, 854), (280, 504)),  # a 480p frame to the 7B's 280 x 504 grid
])
def test_lanczos3_resize_matches_jax_image_resize(src, out):
    """Against jax.image.resize evaluated op by op: under jit, XLA:CPU
    fuses the weight matrices into the products with a sin of its own
    and moves the result by up to 2.2e-3 at 480 x 854 -> 280 x 504
    (ROADMAP C19); op by op it computes the definition in f32."""
    x = np.random.default_rng(sum(src)).integers(
        0, 256, (2, 3, *src)).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jax.image.resize(
            jnp.asarray(x), (2, 3, *out), method="lanczos3",
            antialias=True))
    got = lanczos3_resize(torch.from_numpy(x), out).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)


@pytest.mark.parametrize("n_in,n_out", [(480, 280), (854, 504), (100, 280),
                                        (7, 3), (3, 7)])
def test_lanczos3_weights_match_jax(n_in, n_out):
    """The resampling matrix of jax/_src/image/scale.py (normalized rows,
    zeroed rows outside the input) to f32 rounding."""
    from jax._src.image import scale

    want = np.asarray(scale.compute_weight_mat(
        n_in, n_out, n_out / n_in, 0.0,
        scale._kernels[scale.ResizeMethod.LANCZOS3], True))
    got = lanczos3_weights(n_in, n_out).numpy().T
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _native_frames(fmt, n, h, w, seed):
    rng = np.random.default_rng(seed)
    if fmt == "yuv420":
        return rng.integers(0, 256, (n, h * w * 3 // 2), dtype=np.uint8)
    return rng.integers(0, 256, (n, 3, h, w), dtype=np.uint8)


@pytest.mark.parametrize("kernel_route", [False, True])
@pytest.mark.parametrize("fmt,native", [
    ("yuv420", (300, 330)), ("yuv420", (560, 420)), ("rgb", (250, 190)),
])
def test_vision_forward_resizes_native_frames_as_jax(params, monkeypatch,
                                                     fmt, native,
                                                     kernel_route):
    """vision_forward(..., native_hw) against the JAX function
    (vision.py:576): the source size goes to RGB f32, the lanczos3 resize
    to the grid, the clamp and the 0..255 normalize."""
    jp, tp = params
    grid = (2, 16, 20)  # a 224 x 280 model grid
    frames = _native_frames(fmt, 4, *native, seed=native[0])
    layout = tmodel.layout_for(TCFG, grid)
    if kernel_route:
        monkeypatch.setenv("QV_PALLAS_INTERPRET", "1")
    jax.clear_caches()
    try:
        want = np.asarray(jvision.vision_forward(
            jp["vision"], jnp.asarray(frames),
            jmodel.layout_for(CFG, grid), CFG.vision, native_hw=native,
        ))
    finally:
        monkeypatch.delenv("QV_PALLAS_INTERPRET", raising=False)
        jax.clear_caches()
    got = tvision.vision_forward(tp["vision"], torch.from_numpy(frames),
                                 layout, TCFG.vision, native_hw=native)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def build_native_request(fmt, native, seed=1, groups_t=(2, 2), n_post=7):
    """Like test_torch_engine.build_request, with frames at the source size
    `native` for the 224 x 280 model grid."""
    rng = np.random.default_rng(seed)
    h, w = 16, 20
    t = sum(groups_t)
    n_vid = t * (h // 2) * (w // 2)
    ids = np.concatenate([
        rng.integers(5, 900, 4), [CFG.vision_start_token_id],
        np.full(n_vid, CFG.video_token_id), [CFG.vision_end_token_id],
        rng.integers(5, 900, n_post),
    ]).astype(np.int64)
    frames = _native_frames(fmt, 2 * t, *native, seed=seed)
    groups, grids, off = [], [], 0
    for tg in groups_t:
        groups.append(frames[off : off + 2 * tg])
        grids.append((tg, h, w))
        off += 2 * tg
    return ids, (t, h, w), groups, grids


@pytest.mark.parametrize("fmt,native", [("yuv420", (300, 330)),
                                        ("rgb", (250, 190))])
def test_engine_on_native_frames_matches_jax(params, jax_retained,  # noqa: F811
                                             monkeypatch, fmt, native):
    """PrefillInputs.native_hw through both engines (top_p 0.5,
    key_norms_small, the JAX engine on its kernel route): greedy tokens,
    per-layer cache lengths and every retained index set."""
    jp, tp = params
    jcfg, tcfg = configs(model_name_or_path="tiny", top_p=0.5,
                         max_decode_tokens=8, attention_impl="pallas")
    ids, grid, groups, grids = build_native_request(fmt, native)
    monkeypatch.setenv("QV_PALLAS_INTERPRET", "1")
    jeng = JEngine(jp, CFG, jcfg, dtype=jnp.float32)
    ref = jeng.generate(JInputs(ids, grid, groups, grids, 2.0,
                                native_hw=native), max_new_tokens=6)
    want_sets = list(jax_retained)
    monkeypatch.delenv("QV_PALLAS_INTERPRET")
    eng = LVUEngine(tp, TCFG, tcfg, dtype=torch.float32)
    got = eng.generate(PrefillInputs(ids, grid, groups, grids, 2.0,
                                     native_hw=native), max_new_tokens=6)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    assert got.cache_length == ref.cache_length
    cache, st = eng.prefill(PrefillInputs(ids, grid, groups, grids, 2.0,
                                          native_hw=native))
    got_sets = _port_retained(st)
    assert len(got_sets) == len(want_sets) > 0
    for n, (a, b) in enumerate(zip(got_sets, want_sets)):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f"call {n}")


class NativeReader:
    """A decoder over seeded frames at a source size of SOURCE_HW, with
    the native readers' surface (InterleavedVideoReader for the stream,
    VideoReader.get_batch for the whole-video decode): frames come out at
    the size set in height / width, or at the source size when those are
    unset, packed yuv420 or RGB."""

    SOURCE_HW = (300, 330)
    instances = []

    def __init__(self, path, num_threads=8, num_intervals=64):
        self.source_height, self.source_width = self.SOURCE_HW
        self.height = self.width = self.interpolation = None
        self.output_format = "RGB"
        self.frame_iter = 1
        self._pos = 0
        self.decoded = 0  # frames decoded
        self.closed = False
        NativeReader.instances.append(self)

    def __len__(self):
        return 16

    def get_fps(self):
        return 4.0

    def process(self, indices):
        h = self.height or self.source_height
        w = self.width or self.source_width
        fmt = "yuv420" if self.output_format == "YUV420" else "rgb"
        self._frames = np.concatenate([
            _native_frames(fmt, 1, h, w, seed=int(i)) for i in indices
        ])
        self.decoded += len(indices)
        self._pos = 0

    def get_batch(self, indices):
        self.process(indices)
        return self._frames

    def __next__(self):
        block = self._frames[self._pos : self._pos + self.frame_iter]
        self._pos += len(block)
        if not len(block):
            raise StopIteration
        return block

    def close(self):
        self.closed = True


def patch_native_readers(monkeypatch):
    """NativeReader as the only decoder of both packages: the stream's
    interleaved reader and the registry's "native" backend, which the
    whole-video decode and the frame cache open."""
    for mod in (qd, tqd):
        monkeypatch.setattr(mod, "InterleavedVideoReader", NativeReader)
    for mod in (jreader, treader):
        monkeypatch.setitem(mod._BACKENDS, "native",
                            lambda path, threads: NativeReader(path))
    monkeypatch.setenv("FORCE_QWENVL_VIDEO_READER", "native")
    monkeypatch.setenv("QV_COMPILE_CACHE", "0")
    NativeReader.instances.clear()


def lvu_pair(params, **kw):  # noqa: F811
    jp, tp = params
    jcfg, tcfg = configs(
        model_name_or_path="tiny", num_frames=8, video_group_size=4,
        top_p=0.5, max_decode_tokens=8, dtype="float32", **kw,
    )
    return JLVU(jcfg, params=jp), TLVU(tcfg, params=tp, device="cpu")


@pytest.mark.parametrize("model_type,fmt", [
    ("qwen25_lvu_interleaved", "yuv420"),
    ("qwen25_lvu_interleaved", "rgb"),
    ("qwen25_lvu", "yuv420"),
])
def test_generate_with_resize_on_device_matches_jax(params, monkeypatch,
                                                    model_type, fmt):
    patch_native_readers(monkeypatch)
    jlvu, lvu = lvu_pair(params, model_type=model_type, decode_output=fmt,
                         resize_on_device=True)
    want = jlvu.generate("what moves?", "clip.mp4", max_new_tokens=5)
    assert lvu.generate("what moves?", "clip.mp4", max_new_tokens=5) == want
    np.testing.assert_array_equal(lvu.last_result.tokens,
                                  jlvu.last_result.tokens)
    assert lvu.last_result.cache_length == jlvu.last_result.cache_length
    # every reader decoded at the source size: none was given a size
    assert NativeReader.instances
    assert all(r.height is None and r.closed for r in NativeReader.instances)


def test_chat_session_with_resize_on_device_matches_jax(params, monkeypatch):
    patch_native_readers(monkeypatch)
    jlvu, lvu = lvu_pair(params, model_type="qwen25_lvu_interleaved",
                         decode_output="yuv420", resize_on_device=True)
    js, ts = jlvu.start_chat("clip.mp4"), lvu.start_chat("clip.mp4")
    for q in ("Describe the video.", "Why?"):
        assert ts.ask(q, max_new_tokens=4) == js.ask(q, max_new_tokens=4)
        assert ts.turns[-1]["tokens"] == js.turns[-1]["tokens"]
        assert ts._cache_len == js._cache_len
