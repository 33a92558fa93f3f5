"""The port's spans: the ranges a trace shows inside a request, on the
tiny preset in f32 on the CPU.

One streamed request with pruning and several tokens runs under the
port's own trace (`utils/tracing.py::maybe_trace`, which records every
thread's ranges where this torch can). Checked: "frame_wait" once per
pixel group, "prune" once per layer and group that prunes, "decode_step"
once per token after the first with a "host_wait" inside each; the
stream threads' spans on their own threads; `timings` keeps its keys,
and the stream's totals are the sums of their spans. `SpanTimer` written
from two threads loses no span.
"""

import json
import threading

import numpy as np
import pytest
import torch

from quickvideo_tpu_torch.api import LVU
from quickvideo_tpu_torch.config import LVUConfig
from quickvideo_tpu_torch.models.qwen25_vl.config import get_config
from quickvideo_tpu_torch.models.qwen25_vl.convert import init_params
from quickvideo_tpu_torch.utils import timing
from quickvideo_tpu_torch.utils.tracing import _all_threads, maybe_trace
from quickvideo_tpu_torch.video import quickdecode as qd

torch.set_num_threads(2)

# the keys of a streamed request's timings before these spans existed
TIMING_KEYS = {"e2e", "rope", "cache_alloc", "vision", "prefill",
               "final_prefill", "decode", "decode_start", "frame_fetch",
               "processing"}
THREAD_SPANS = ("frame_fetch", "processing")


class SeededReader:
    """The native interleaved reader's surface over seeded yuv420 noise."""

    def __init__(self, path, num_threads=8, num_intervals=64):
        self.source_height, self.source_width = 280, 280
        self.height = self.width = self.interpolation = None
        self.output_format = "RGB"
        self.frame_iter = 1
        self._pos = 0

    def __len__(self):
        return 16

    def get_fps(self):
        return 4.0

    def process(self, indices):
        h = self.height or self.source_height
        w = self.width or self.source_width
        self._frames = np.stack([
            np.random.default_rng(int(i)).integers(
                0, 256, h * w * 3 // 2, dtype=np.uint8)
            for i in indices
        ])
        self._pos = 0

    def __next__(self):
        block = self._frames[self._pos : self._pos + self.frame_iter]
        self._pos += len(block)
        return block

    def close(self):
        pass


def _inside(inner, outer) -> bool:
    return (inner["tid"] == outer["tid"] and inner["ts"] >= outer["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


@pytest.fixture(scope="module")
def traced_request(tmp_path_factory):
    """(the request's result, its retained index sets, its user ranges in
    the Chrome trace, the main thread's id there, the traced spans)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(qd, "InterleavedVideoReader", SeededReader)
    try:
        cfg = LVUConfig(model_name_or_path="tiny", dtype="float32",
                        model_type="qwen25_lvu_interleaved", num_frames=8,
                        video_group_size=4, top_p=0.5, max_decode_tokens=8,
                        decode_output="yuv420")
        lvu = LVU(cfg, params=init_params(get_config("tiny"), 0,
                                          torch.float32), device="cpu")
        inner = lvu.engine.prefill
        box = {}

        def prefill(inputs, timer=None, extra_capacity=0):
            cache, state = inner(inputs, timer, extra_capacity)
            box["retained"] = state["retained"]
            return cache, state

        lvu.engine.prefill = prefill
        lvu.generate("what moves?", "clip.mp4", max_new_tokens=6)  # warm-up
        first = len(timing.traced_spans())
        with maybe_trace(str(tmp_path_factory.mktemp("trace"))) as path:
            with torch.profiler.record_function("request"):
                lvu.generate("what moves?", "clip.mp4", max_new_tokens=6)
        spans = timing.traced_spans()[first:]
    finally:
        mp.undo()
    events = [e for e in json.loads(open(path).read())["traceEvents"]
              if e.get("cat") == "user_annotation"]
    (request,) = [e for e in events if e["name"] == "request"]
    return lvu.last_result, box["retained"], events, request["tid"], spans


def _named(events, name):
    return [e for e in events if e["name"] == name]


def test_frame_wait_once_per_group(traced_request):
    res, retained, events, main, _ = traced_request
    waits = _named(events, "frame_wait")
    assert len(waits) == len(retained) == 2
    assert all(e["tid"] == main for e in waits)


def test_prune_once_per_pruning_layer_and_group(traced_request):
    _, retained, events, _, _ = traced_request
    pruned = sum(idx is not None for group in retained for idx in group)
    assert pruned > 0
    prunes = _named(events, "prune")
    assert len(prunes) == pruned
    prefills = _named(events, "prefill")
    assert all(any(_inside(p, f) for f in prefills) for p in prunes)


def test_decode_step_per_token_after_the_first_with_a_host_wait(
        traced_request):
    res, _, events, main, _ = traced_request
    assert len(res.tokens) >= 2
    steps = _named(events, "decode_step")
    assert len(steps) == len(res.tokens) - 1
    (decode,) = _named(events, "decode")
    waits = _named(events, "host_wait")
    for s in steps:
        assert s["tid"] == main and _inside(s, decode)
        assert sum(_inside(w, s) for w in waits) == 1


def test_stream_threads_record_on_their_own_threads(traced_request):
    if not _all_threads():
        pytest.skip("this torch's profiler records only the thread that "
                    "started it")
    _, _, events, main, _ = traced_request
    tids = {name: {e["tid"] for e in _named(events, name)}
            for name in THREAD_SPANS}
    assert all(tids[name] and main not in tids[name]
               for name in THREAD_SPANS)
    assert tids["frame_fetch"].isdisjoint(tids["processing"])
    assert {e["tid"] for e in _named(events, "decode_start")} == {main}


def test_timings_keep_their_keys_and_the_stream_totals(traced_request):
    res, retained, _, _, spans = traced_request
    assert set(res.timings) == TIMING_KEYS
    for name in THREAD_SPANS + ("decode_start",):
        # one a request, and one a pixel group on each stream thread
        got = [t1 - t0 for n, t0, t1, _ in spans if n == name]
        assert len(got) == (1 if name == "decode_start" else len(retained))
        assert res.timings[name] == pytest.approx(sum(got), rel=1e-9)
    threads = {n: {tid for m, _, _, tid in spans if m == n}
               for n in ("frame_fetch", "processing", "frame_wait")}
    assert len(set.union(*threads.values())) == 3


def test_no_span_kept_while_no_profiler_records():
    before = timing.traced_spans()
    with timing.span("frame_wait"):
        pass
    with timing.SpanTimer().span("prefill"):
        pass
    assert timing.traced_spans() == before


def test_span_timer_from_two_threads_loses_no_span():
    timer = timing.SpanTimer()
    n = 2000

    def work(name):
        for _ in range(n):
            with timer.span(name):
                pass
            timer.add("shared", 1.0)

    threads = [threading.Thread(target=work, args=(name,))
               for name in ("frame_fetch", "processing")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    counts = dict(line.rsplit(" (n=", 1) for line in
                  timer.report().splitlines())
    counts = {k.split(":")[0]: int(v.rstrip(")")) for k, v in counts.items()}
    assert counts == {"frame_fetch": n, "processing": n, "shared": 2 * n}
    assert timer.totals()["shared"] == 2.0 * n
