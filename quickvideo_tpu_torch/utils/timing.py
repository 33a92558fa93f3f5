"""Span timer for the engine's metric contract.

Counterpart of quickvideo_tpu/utils/timing.py. CUDA work is asynchronous,
so a span measures the time to enqueue unless it synchronizes: with
sync=True (or QV_SYNC_SPANS=1) both span edges call
`torch.cuda.synchronize()`, and the spans partition device time. Sync mode
removes the overlap the engine works for; it is for attribution, not for
headline timing. On a machine without CUDA the barrier does nothing.
Each span is also a named range of a torch.profiler trace
(utils/tracing.py), so a trace shows the spans the report sums.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch

from quickvideo_tpu_torch.utils.tracing import annotate


def device_barrier() -> None:
    """Wait for all work queued on the current CUDA device (no-op on CPU)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class SpanTimer:
    def __init__(self, sync: bool | None = None):
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
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
            dt = time.perf_counter() - t0
            self._totals[name] += dt
            self._counts[name] += 1

    def add(self, name: str, seconds: float):
        self._totals[name] += seconds
        self._counts[name] += 1

    def totals(self) -> Dict[str, float]:
        return dict(self._totals)

    def report(self) -> str:
        """Reference-style breakdown, one line per span, longest first
        (quickvideo_tpu/utils/timing.py:76)."""
        lines = []
        for name, tot in sorted(self._totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name}: {tot:.2f}s (n={self._counts[name]})")
        return "\n".join(lines)
