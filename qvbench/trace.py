"""The traced window: torch.profiler over it, reduced to what the readers use.

`Trace.from_profile` walks the profiler's raw events once and keeps:

  ops        every device operation (kernels, copies, sets): name, start,
             end and the span it ran under ("vision", "prefill",
             "final_prefill", "decode", ... or None): the device-side copy
             of the span (the profiler's range from the first to the last
             device operation launched inside the host range) that holds
             its start; the main stream runs the spans one after another
  spans      the host ranges of the program's SpanTimer spans (and the
             benchmark's own "qvbench.request"), by name
  window     the traced window's start and end on the same clock: the
             host range "qvbench.window" the harness opens around it

Busy time is the union of the device operations' intervals (a frozen copy
of chip_smoke.py --profile's arithmetic), applied to the whole window.

`profiler()` records the host side's user ranges alone (RecordScope
USER_SCOPE: the spans, not every aten operator), so that a window of
several long requests stays cheap to stop and to read and the host is
slowed less. Where this torch has no such switch the traced run fails:
recording every operator would change what the per-layer metrics read.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

SPAN_NAMES = ("vision", "prefill", "final_prefill", "decode", "rope",
              "cache_alloc")
REQUEST_SPAN = "qvbench.request"
WINDOW_SPAN = "qvbench.window"


def union(intervals) -> List[Tuple[int, int]]:
    """Sorted, merged (start, end) intervals."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(merged, lo: int, hi: int) -> int:
    """Length of [lo, hi) that the merged intervals cover."""
    total = 0
    i = max(0, bisect.bisect_right(merged, (lo, lo)) - 1)
    while i < len(merged) and merged[i][0] < hi:
        s, e = merged[i]
        total += max(0, min(e, hi) - max(s, lo))
        i += 1
    return total


class SpanIndex:
    """Which of a set of non-overlapping host ranges holds a time."""

    def __init__(self, ranges: Dict[str, List[Tuple[int, int]]]):
        flat = sorted((s, e, n) for n, rs in ranges.items() for s, e in rs)
        self.starts = [s for s, _, _ in flat]
        self.flat = flat

    def at(self, t: int) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.flat[i][1] >= t:
            return self.flat[i][2]
        return None


def profiler(device_type: str):
    """A started torch.profiler.profile over the host's user ranges and,
    on a CUDA device, the device's operations."""
    import torch.autograd.profiler as ap
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    inner = ap._enable_profiler
    scoped = []

    def user_ranges(config, activities, scopes=None):
        from torch._C._profiler import RecordScope

        out = inner(config, activities, {RecordScope.USER_SCOPE})
        scoped.append(True)
        return out

    ap._enable_profiler = user_ranges
    try:
        prof.start()
    finally:
        ap._enable_profiler = inner
    if not scoped:
        prof.stop()
        raise RuntimeError("torch.profiler started without the user-range "
                           "scope: this torch records every operator")
    return prof


@dataclass
class Op:
    name: str
    start: int  # ns
    end: int
    span: Optional[str]

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9

    @property
    def is_kernel(self) -> bool:
        return not self.name.startswith(("Memcpy", "Memset"))


@dataclass
class Trace:
    ops: List[Op]
    spans: Dict[str, List[Tuple[int, int]]]
    window: Tuple[int, int]
    busy: List[Tuple[int, int]] = field(default_factory=list)

    def __post_init__(self):
        lo, hi = self.window
        self.busy = union((max(o.start, lo), min(o.end, hi))
                          for o in self.ops if o.end > lo and o.start < hi)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    def kernel_seconds(self, span: Optional[str] = None,
                       names: Tuple[str, ...] = ()) -> float:
        """Device seconds of the kernels launched in `span` (any span where
        None) whose names hold one of `names` (any kernel where empty)."""
        return sum(o.seconds for o in self.ops if o.is_kernel
                   and (span is None or o.span == span)
                   and (not names or any(n in o.name for n in names)))

    def launches(self, name: str) -> int:
        """Launches of the kernels whose names hold `name`."""
        return sum(1 for o in self.ops if name in o.name)

    def busy_within(self, span: str) -> Tuple[float, float]:
        """(device-busy seconds, wall seconds) inside the host ranges of
        `span`."""
        wall = busy = 0
        for s, e in self.spans.get(span, ()):
            wall += e - s
            busy += covered(self.busy, s, e)
        return busy / 1e9, wall / 1e9

    def top_ops(self, n: int = 10):
        by: Dict[str, float] = {}
        for o in self.ops:
            by[o.name] = by.get(o.name, 0.0) + o.seconds
        return sorted(by.items(), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10):
        """Idle device time inside the window, summed by the host span open
        where each gap begins ("between spans" inside a request's range
        outside every span, "between requests" outside the requests)."""
        inner = SpanIndex({k: v for k, v in self.spans.items()
                           if k in SPAN_NAMES})
        outer = SpanIndex({REQUEST_SPAN: self.spans.get(REQUEST_SPAN, [])})
        by: Dict[str, float] = {}
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy for x in iv] + [hi]
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            label = inner.at(s) or ("between spans" if outer.at(s)
                                    else "between requests")
            by[label] = by.get(label, 0.0) + (e - s) / 1e9
        return sorted(by.items(), key=lambda kv: -kv[1])[:n]

    @classmethod
    def from_profile(cls, prof) -> "Trace":
        from torch.autograd import DeviceType

        host_spans: Dict[str, List[Tuple[int, int]]] = {}
        dev_spans: Dict[str, List[Tuple[int, int]]] = {}
        raw = []
        for e in prof.profiler.kineto_results.events():
            cpu = e.device_type() == DeviceType.CPU
            if cpu and not e.is_user_annotation():
                continue
            name, start = e.name(), e.start_ns()
            end = start + e.duration_ns()
            if cpu:
                host_spans.setdefault(name, []).append((start, end))
            elif e.is_user_annotation():
                dev_spans.setdefault(name, []).append((start, end))
            else:
                raw.append((name, start, end))
        window = host_spans[WINDOW_SPAN][0]
        keep = {k: v for k, v in host_spans.items()
                if k in SPAN_NAMES or k == REQUEST_SPAN}
        by_device = SpanIndex({k: v for k, v in dev_spans.items()
                               if k in SPAN_NAMES})
        ops = [Op(name, start, end, by_device.at(start))
               for name, start, end in raw]
        return cls(ops, keep, window)
