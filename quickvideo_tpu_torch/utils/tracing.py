"""Structured tracing: torch.profiler around a block, named spans inside it.

Counterpart of quickvideo_tpu/utils/tracing.py (jax.profiler there). A
trace records the host's activity and, where a CUDA card is present, the
card's kernels, and is written as a Chrome trace (open it in Perfetto or
chrome://tracing) named after the process, so the ranks of a mesh each
write their own.

The CLI (lvu_cli.py) runs under `maybe_trace()`, so QV_TRACE_DIR traces
a CLI run; every span of utils/timing.py is an `annotate` range. Where
this torch can, the trace records every thread's ranges, so the frame
stream's "frame_fetch" and "processing" spans show on their own threads
(a profiler records only the thread that started it otherwise).

Usage:
    with maybe_trace("/tmp/qv_trace"):       # env QV_TRACE_DIR also works
        lvu.generate(...)
    with annotate("prefill_group"):          # nestable, cheap when off
        ...
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str] = None):
    """Profile the block and write its trace into `trace_dir` (or the
    QV_TRACE_DIR environment variable) as trace_<pid>_<ns>.json; with
    neither, run the block untouched. Yields the path written to, or
    None."""
    trace_dir = trace_dir or os.environ.get("QV_TRACE_DIR")
    if not trace_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir,
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    with profile(activities=activities, **_all_threads()) as prof:
        yield path
    prof.export_chrome_trace(path)


def _all_threads() -> dict:
    """profile() keywords that record every thread's ranges, where this
    torch has the switch (none otherwise)."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return {"experimental_config":
                _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


def annotate(name: str):
    """Named span visible in profiler timelines."""
    return torch.profiler.record_function(name)
