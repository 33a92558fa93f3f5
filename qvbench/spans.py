"""The program's own spans of each traced request, for the readers of the
host-side per-layer metrics.

The port keeps every span closed while a torch.profiler trace records
(`quickvideo_tpu_torch/utils/timing.py::traced_spans`: name, start, end
and thread, on `time.perf_counter`, the clock of the harness's request
times), nested ones included: "frame_wait", "prune", "decode_step" and
"host_wait" inside "vision", "prefill", "final_prefill" and "decode".
`by_request` gives each traced request the spans that start and end
inside its `LVU.generate` call. A port without that list gives None, and
so do the readers built on it.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

Span = Tuple[str, float, float, int]  # name, start s, end s, thread id


def by_request(ctx) -> Optional[List[Dict[str, List[Span]]]]:
    """For each request of `ctx.requests`, its spans by name (None where the
    program keeps none or ran no request)."""
    try:
        from quickvideo_tpu_torch.utils.timing import traced_spans
    except ImportError:
        return None
    spans = sorted(traced_spans(), key=lambda s: s[1])
    if not spans or not ctx.requests:
        return None
    starts = [s[1] for s in spans]
    out = []
    for r in ctx.requests:
        named: Dict[str, List[Span]] = {}
        lo = bisect.bisect_left(starts, r.t_call)
        hi = bisect.bisect_right(starts, r.t_done)
        for s in spans[lo:hi]:
            if s[2] <= r.t_done:
                named.setdefault(s[0], []).append(s)
        out.append(named)
    return out


def inside(inner: Span, outer: Span) -> bool:
    """Whether `inner` lies within `outer` on the same thread."""
    return (inner[3] == outer[3] and inner[1] >= outer[1]
            and inner[2] <= outer[2])


def seconds(spans: List[Span]) -> float:
    return sum(e - s for _, s, e, _ in spans)


def outside_waits(outer: Span, waits: List[Span]) -> float:
    """Seconds of `outer` outside the "host_wait" spans within it."""
    return (outer[2] - outer[1]) - seconds(
        [w for w in waits if inside(w, outer)])
