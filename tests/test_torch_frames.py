"""Frames on their way to the tower, in the PyTorch port against the JAX
package, on the tiny preset in f32 with identical weights and the same
fake decoder:

- `prefetch_to_device=False` (ROADMAP C18): one decode thread feeds the
  consumer's queue and the stream yields CPU tensors, as the JAX stream
  yields host arrays; the tokens equal those of `True` and of the JAX
  engine;
- `resize_on_device`: the stream leaves the reader at the source size and
  exposes it as `native_hw`;
- the disk frame cache (`save_video_cache`): a request through the sync
  engine writes the decoded frames, a second one reads them and decodes
  none, with the JAX engine's tokens; an entry written by one package
  serves the other.
"""

import numpy as np
import pytest
import torch

from quickvideo_tpu_torch.config import LVUConfig as TLVUConfig
from quickvideo_tpu_torch.video.stream import AsyncPixelGroups

from test_torch_engine import params  # noqa: F401
from test_torch_resize import NativeReader, lvu_pair, patch_native_readers

torch.set_num_threads(2)


def _stream(**kw):
    cfg = TLVUConfig(model_name_or_path="tiny", num_frames=8,
                     video_group_size=4, decode_output="yuv420", **kw)
    return AsyncPixelGroups("clip.mp4", cfg, device="cpu",
                            reader=NativeReader("clip.mp4"))


@pytest.mark.parametrize("to_device", [True, False])
def test_stream_threads_and_blocks_follow_prefetch_to_device(to_device):
    stream = _stream(prefetch_to_device=to_device)
    try:
        names = [t.name for t in stream._threads]
        blocks = list(stream)
    finally:
        stream.close()
    if to_device:
        assert names == ["qv-decode", "qv-upload"]
        assert stream._rawq is not stream._q
    else:
        # one producer, whose queue is the consumer's
        assert names == ["qv-decode"]
        assert stream._rawq is stream._q
    assert [b.shape[0] for b in blocks] == stream.plan.group_frame_counts
    assert all(isinstance(b, torch.Tensor) and b.device.type == "cpu"
               and b.dtype == torch.uint8 for b in blocks)
    assert not any(t.is_alive() for t in stream._threads)


@pytest.mark.parametrize("resize", [False, True])
def test_stream_decodes_at_the_source_size_for_the_device_resize(resize):
    stream = _stream(resize_on_device=resize)
    try:
        blocks = list(stream)
    finally:
        stream.close()
    plan, reader = stream.plan, stream.reader
    if resize:
        assert stream.native_hw == NativeReader.SOURCE_HW
        assert reader.height is None and reader.width is None
        h, w = NativeReader.SOURCE_HW
        assert (h, w) != (plan.resized_height, plan.resized_width)
    else:
        assert stream.native_hw is None
        h, w = plan.resized_height, plan.resized_width
        assert (reader.height, reader.width) == (h, w)
    assert all(b.shape[1] == h * w * 3 // 2 for b in blocks)


def test_prefetch_to_device_false_gives_the_same_tokens(params,  # noqa: F811
                                                        monkeypatch):
    """The interleaved engine with prefetch_to_device=False against True
    and against the JAX engine with False."""
    patch_native_readers(monkeypatch)
    kw = dict(model_type="qwen25_lvu_interleaved", decode_output="yuv420")
    jlvu, lvu_off = lvu_pair(params, prefetch_to_device=False, **kw)
    _, lvu_on = lvu_pair(params, **kw)
    want = jlvu.generate("what moves?", "clip.mp4", max_new_tokens=5)
    for lvu in (lvu_off, lvu_on):
        assert lvu.generate("what moves?", "clip.mp4",
                            max_new_tokens=5) == want
        np.testing.assert_array_equal(lvu.last_result.tokens,
                                      jlvu.last_result.tokens)


@pytest.mark.parametrize("resize", [False, True])
def test_frame_cache_serves_the_second_request(params, monkeypatch,  # noqa: F811
                                               tmp_path, resize):
    """save_video_cache through the sync engine of both packages: the first
    request decodes and writes the entry, the second decodes no frame;
    tokens equal the JAX engine's each time. With resize_on_device the
    entry holds source-size frames under its own key."""
    patch_native_readers(monkeypatch)
    jlvu, lvu = lvu_pair(params, model_type="qwen25_lvu",
                         decode_output="yuv420", save_video_cache=True,
                         cache_dir=str(tmp_path / "port"),
                         resize_on_device=resize)
    jlvu.config = jlvu.config.replace(cache_dir=str(tmp_path / "jax"))
    want = jlvu.generate("what moves?", "clip.mp4", max_new_tokens=5)
    for turn in range(2):
        NativeReader.instances.clear()
        assert lvu.generate("what moves?", "clip.mp4",
                            max_new_tokens=5) == want
        np.testing.assert_array_equal(lvu.last_result.tokens,
                                      jlvu.last_result.tokens)
        decoded = sum(r.decoded for r in NativeReader.instances)
        assert decoded == (8 if turn == 0 else 0), (turn, decoded)
        assert all(r.closed for r in NativeReader.instances)
        assert lvu.last_result.timings["frame_fetch"] > 0
    (entry,) = (tmp_path / "port").iterdir()
    h, w = NativeReader.SOURCE_HW
    assert (f"_hw={h}x{w}_" in entry.name) == resize
    # the port's entry serves the JAX engine: no frame decoded
    NativeReader.instances.clear()
    jlvu.config = jlvu.config.replace(cache_dir=str(tmp_path / "port"))
    assert jlvu.generate("what moves?", "clip.mp4", max_new_tokens=5) == want
    assert sum(r.decoded for r in NativeReader.instances) == 0
