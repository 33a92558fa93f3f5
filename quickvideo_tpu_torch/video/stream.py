"""Overlapped decode -> upload -> prefill pipeline.

Counterpart of quickvideo_tpu/video/stream.py::AsyncPixelGroups: the same
two producer threads. The decode thread pulls frame blocks from the native
interleaved reader (video/quickdecode.py, the ctypes binding to the library
built from cpp/quickdecode); the upload thread copies each uint8 block from
pinned host memory to the device with `non_blocking=True` on a side CUDA
stream and records an event. The consumer (the engine's group loop) makes
its own stream wait on that event before it touches the block, so the copy
of group i+1 overlaps the compute of group i. On a CPU device the upload
stage only wraps the block in a tensor.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Iterator, Optional

import numpy as np
import torch

from quickvideo_tpu_torch.config import LVUConfig
from quickvideo_tpu_torch.video import preprocess as pp
from quickvideo_tpu_torch.video import quickdecode as qd
from quickvideo_tpu_torch.video.reader import plan_from_reader
from quickvideo_tpu_torch.utils.timing import SpanTimer

_SENTINEL = object()


class AsyncPixelGroups:
    """Iterator of per-group frame tensors on `device`, produced by
    background threads that consume the native interleaved decoder as
    blocks arrive. `reader` replaces the native reader (an object with the
    InterleavedVideoReader surface)."""

    def __init__(
        self,
        path: str,
        lvu: LVUConfig,
        device="cpu",
        plan: Optional[pp.VideoPlan] = None,
        timer: Optional[SpanTimer] = None,
        reader=None,
    ):
        if lvu.resize_on_device:
            raise NotImplementedError("on-device resize is not ported yet")
        self.lvu = lvu
        self.device = torch.device(device)
        self.timer = timer or SpanTimer()
        t0 = time.perf_counter()
        self.reader = reader or qd.InterleavedVideoReader(
            path,
            num_threads=lvu.decode_threads,
            num_intervals=lvu.decode_intervals,
        )
        self.plan = plan or plan_from_reader(self.reader, lvu)
        self.reader.height = self.plan.resized_height
        self.reader.width = self.plan.resized_width
        self.reader.interpolation = "LANCZOS"
        if lvu.decode_output.lower() == "yuv420":
            self.reader.output_format = "YUV420"
        # start the native decode of the sampled frames now: decode of group
        # i+1 overlaps prefill of group i
        self.reader.process(self.plan.indices.tolist())
        self.timer.add("decode_start", time.perf_counter() - t0)
        self._q: queue.Queue = queue.Queue(maxsize=lvu.prefetch_depth)
        self._rawq: queue.Queue = queue.Queue(maxsize=lvu.prefetch_depth)
        self._exc: Optional[BaseException] = None
        self._closed = False
        self._side = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda"
            else None
        )
        self._threads = [
            threading.Thread(target=self._produce_decode, daemon=True),
            threading.Thread(target=self._produce_upload, daemon=True),
        ]
        for t in self._threads:
            t.start()

    def _put(self, q: queue.Queue, item) -> bool:
        """Bounded put that gives up once close() was requested."""
        while not self._closed:
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _fail(self, e: BaseException):
        self._exc = e
        for q in (self._rawq, self._q):
            try:
                q.put_nowait(_SENTINEL)
            except queue.Full:
                pass

    def _produce_decode(self):
        try:
            for gi, cnt in enumerate(self.plan.group_frame_counts):
                if self._closed:
                    return
                self.reader.frame_iter = cnt
                t0 = time.perf_counter()
                block = next(self.reader)  # blocks on the native decode
                self.timer.add("frame_fetch", time.perf_counter() - t0)
                if block.shape[0] != cnt:
                    raise IOError(
                        f"group {gi}: expected {cnt} frames, got {block.shape[0]}"
                    )
                if not self._put(self._rawq, block):
                    return
            self._put(self._rawq, _SENTINEL)
        except BaseException as e:  # noqa: BLE001 — re-raised by the consumer
            if not self._closed:
                self._fail(e)

    def _upload(self, block: np.ndarray):
        """-> (tensor on the device, event to wait on or None). PyTorch's
        pinned-memory allocator keeps the host buffer until the copy that
        reads it has run."""
        host = torch.from_numpy(np.ascontiguousarray(block))
        if self._side is None:
            return host.to(self.device), None
        host = host.pin_memory()
        with torch.cuda.stream(self._side):
            dev = host.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._side)
        return dev, event

    def _produce_upload(self):
        try:
            while not self._closed:
                try:
                    block = self._rawq.get(timeout=0.1)
                except queue.Empty:
                    continue
                if block is _SENTINEL:
                    self._put(self._q, _SENTINEL)
                    return
                t0 = time.perf_counter()
                item = self._upload(block)
                self.timer.add("processing", time.perf_counter() - t0)
                if not self._put(self._q, item):
                    return
        except BaseException as e:  # noqa: BLE001
            if not self._closed:
                self._fail(e)

    def __iter__(self) -> Iterator[torch.Tensor]:
        while True:
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                if self._exc is not None:
                    raise self._exc
                continue
            if item is _SENTINEL:
                if self._exc is not None:
                    raise self._exc
                return
            tensor, event = item
            if event is not None:
                consumer = torch.cuda.current_stream(self.device)
                consumer.wait_event(event)
                # allocated on the side stream, used on the consumer's: keep
                # the caching allocator from reusing it too early
                tensor.record_stream(consumer)
            yield tensor

    def close(self):
        """Stop the producers, then close the native reader (closing first
        would free it under a producer blocked in a native call)."""
        self._closed = True
        for q in (self._q, self._rawq):
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
        for t in self._threads:
            t.join(timeout=60.0)
        if any(t.is_alive() for t in self._threads):
            logging.getLogger(__name__).warning(
                "AsyncPixelGroups.close(): producer did not exit within 60s; "
                "leaking the native reader handle"
            )
            return
        self.reader.close()
