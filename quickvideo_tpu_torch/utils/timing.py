"""Span timer for the engine's metric contract, and the spans inside it.

Counterpart of quickvideo_tpu/utils/timing.py. CUDA work is asynchronous,
so a span measures the time to enqueue unless it synchronizes: with
sync=True (or QV_SYNC_SPANS=1) both span edges call
`torch.cuda.synchronize()`, and the spans partition device time. Sync mode
removes the overlap the engine works for; it is for attribution, not for
headline timing. On a machine without CUDA the barrier does nothing.
Each span is also a named range of a torch.profiler trace
(utils/tracing.py), so a trace shows the spans the report sums.

`SpanTimer.span` sums a request's top-level spans ("vision", "prefill",
"final_prefill", "decode", ...) and the stream threads' ("decode_start",
"frame_fetch", "processing") into its totals, from any thread. The
module-level `span` names a range inside them without a total:
"frame_wait" (the group loop waiting for its next pixel group), "prune"
(a layer's selection and compaction), "decode_step" (one token after the
first) and, through `host_wait`, every point where the host waits for the
device. While a torch.profiler trace records, every closed span of either
kind is also kept, on `time.perf_counter`'s clock and with its thread,
for `traced_spans()`: readers that hold no trace of their own (the
benchmark's metric readers) take the spans from there.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, Tuple

import torch
import torch.autograd.profiler as _profiler

from quickvideo_tpu_torch.utils.tracing import annotate

# the newest spans closed while a profiler recorded: (name, start s,
# end s, system thread id, as a trace's tid)
TRACED_MAX = 1 << 17
_traced: deque = deque(maxlen=TRACED_MAX)
_traced_lock = threading.Lock()


def _closed(name: str, t0: float, t1: float) -> None:
    if getattr(_profiler, "_is_profiler_enabled", False):
        with _traced_lock:
            _traced.append((name, t0, t1, threading.get_native_id()))


def traced_spans() -> List[Tuple[str, float, float, int]]:
    """The spans closed while a torch.profiler trace recorded, oldest
    first (the newest TRACED_MAX): (name, start, end, system thread id),
    the times in seconds of `time.perf_counter`."""
    with _traced_lock:
        return list(_traced)


@contextlib.contextmanager
def span(name: str):
    """A range inside a SpanTimer span: a profiler range, and an entry of
    `traced_spans()` while a profiler records; no SpanTimer total."""
    t0 = time.perf_counter()
    try:
        with annotate(name):
            yield
    finally:
        _closed(name, t0, time.perf_counter())


def host_wait():
    """The span around a point where the host waits for the device (a
    device value read on the host, a copy from pageable host memory): it
    names the wait and neither adds nor removes one."""
    return span("host_wait")


def device_barrier() -> None:
    """Wait for all work queued on the current CUDA device (no-op on CPU)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class SpanTimer:
    def __init__(self, sync: bool | None = None):
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        # the stream's threads close their spans beside the main thread's
        self._lock = threading.Lock()
        self.sync = (
            os.environ.get("QV_SYNC_SPANS", "") == "1" if sync is None
            else sync
        )

    @contextlib.contextmanager
    def span(self, name: str):
        if self.sync:
            device_barrier()
        t0 = time.perf_counter()
        try:
            with annotate(name):
                yield
        finally:
            if self.sync:
                device_barrier()
            t1 = time.perf_counter()
            self.add(name, t1 - t0)
            _closed(name, t0, t1)

    def add(self, name: str, seconds: float):
        with self._lock:
            self._totals[name] += seconds
            self._counts[name] += 1

    def totals(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._totals)

    def report(self) -> str:
        """Reference-style breakdown, one line per span, longest first
        (quickvideo_tpu/utils/timing.py:76)."""
        with self._lock:
            rows = sorted(self._totals.items(), key=lambda kv: -kv[1])
            counts = dict(self._counts)
        return "\n".join(f"{name}: {tot:.2f}s (n={counts[name]})"
                         for name, tot in rows)
