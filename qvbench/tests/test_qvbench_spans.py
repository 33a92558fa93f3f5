"""The host-side readers built on the program's spans, and the reduced
trace beside the spans nested inside the program's top-level ones.

- `qvbench/trace.py::Trace.from_profile` on a synthetic event list reads
  the same device operations' spans, host spans, busy time and idle gaps
  with the nested ranges ("frame_wait", "prune", "decode_step",
  "host_wait") as without them.
- Each reader of `qvbench/spans.py`'s spans on synthetic spans, against
  values worked out by hand; None where the program keeps no spans.
- The tiny cell, traced on the CPU through the harness, reads each of
  them.
"""

import json
import subprocess
import sys
import types

import pytest

from conftest import REPO, TINY_CELL, make_root

from qvbench import run
from qvbench.metrics import reader
from qvbench.trace import Trace

HOST_READERS = ("frame_wait_s", "host_waits", "final_prefill_launch_ms",
                "decode_launch_ms")


class Event:
    """One of the profiler's raw events, as Trace.from_profile reads it."""

    def __init__(self, name, start, end, device=False, annotation=True):
        self._name, self._start, self._dur = name, start, end - start
        self._device, self._annotation = device, annotation

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._device else DeviceType.CPU

    def is_user_annotation(self):
        return self._annotation


def profile(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


# host ranges (ns): a window holding one request of a vision span, a
# prefill span and a decode span; device ranges and operations below
TOP = [
    Event("qvbench.window", 0, 1000),
    Event("qvbench.request", 10, 990),
    Event("vision", 20, 200),
    Event("prefill", 200, 600),
    Event("decode", 650, 980),
    Event("vision", 40, 210, device=True),
    Event("prefill", 215, 640, device=True),
]
OPS = [
    Event("vision_kernel", 40, 120, device=True, annotation=False),
    Event("Memcpy HtoD", 125, 130, device=True, annotation=False),
    Event("vision_kernel", 150, 210, device=True, annotation=False),
    Event("gemm", 215, 300, device=True, annotation=False),
    Event("topk", 320, 360, device=True, annotation=False),
    Event("gemm", 380, 640, device=True, annotation=False),
    Event("decode_kernel", 700, 720, device=True, annotation=False),
    Event("argmax", 760, 765, device=True, annotation=False),
]
NESTED = [
    Event("frame_wait", 12, 20),
    Event("host_wait", 100, 104),
    Event("prune", 300, 340),
    Event("host_wait", 600, 610),
    Event("decode_step", 700, 800),
    Event("host_wait", 720, 790),
    Event("prune", 320, 360, device=True),
    Event("host_wait", 125, 130, device=True),
    Event("decode_step", 700, 765, device=True),
]


def test_nested_ranges_leave_the_reduced_trace_as_it_was():
    plain = Trace.from_profile(profile(TOP + OPS))
    nested = Trace.from_profile(profile(TOP + NESTED + OPS))
    assert [(o.name, o.start, o.end, o.span) for o in nested.ops] == \
        [(o.name, o.start, o.end, o.span) for o in plain.ops]
    assert nested.spans == plain.spans
    assert nested.busy == plain.busy
    assert nested.window == plain.window
    assert nested.idle_gaps() == plain.idle_gaps()
    assert [o.span for o in plain.ops] == ["vision"] * 3 + ["prefill"] * 3 \
        + [None] * 2


def ctx_with(monkeypatch, spans, requests):
    """A Context whose program kept `spans` (name, start, end, thread) and
    ran `requests` ((call, done) times)."""
    from quickvideo_tpu_torch.utils import timing

    monkeypatch.setattr(timing, "traced_spans", lambda: list(spans))
    recs = [run.Record(i, i, "q", call, t_done=done)
            for i, (call, done) in enumerate(requests)]
    return run.Context(None, recs, None, None, "bf16")


MAIN, DECODE_THREAD = 1, 2
# two requests, [0, 10) and [20, 30); seconds
SPANS = [
    # request 0: two groups, a final prefill with one wait, two steps
    ("frame_fetch", 0.5, 1.5, DECODE_THREAD),
    ("frame_wait", 1.0, 1.5, MAIN),
    ("host_wait", 1.6, 1.7, MAIN),
    ("frame_wait", 2.0, 2.25, MAIN),
    ("prune", 2.3, 2.4, MAIN),
    ("final_prefill", 3.0, 4.0, MAIN),
    ("host_wait", 3.0, 3.2, MAIN),
    ("decode", 4.0, 6.0, MAIN),
    ("host_wait", 4.0, 4.1, MAIN),  # the first token's read
    ("decode_step", 4.5, 5.0, MAIN),
    ("host_wait", 4.8, 5.0, MAIN),
    ("decode_step", 5.0, 5.4, MAIN),
    ("host_wait", 5.1, 5.4, MAIN),
    # request 1: one group, a final prefill without a wait, one step
    ("frame_wait", 21.0, 21.75, MAIN),
    ("host_wait", 22.0, 22.5, MAIN),
    ("final_prefill", 23.0, 23.5, MAIN),
    ("decode", 24.0, 25.0, MAIN),
    ("decode_step", 24.2, 24.6, MAIN),
    ("host_wait", 24.3, 24.6, MAIN),
    # outside both requests
    ("frame_wait", 12.0, 19.0, MAIN),
    ("host_wait", 35.0, 36.0, MAIN),
]
REQUESTS = [(0.0, 10.0), (20.0, 30.0)]


@pytest.mark.parametrize("name,want", [
    # (0.5 + 0.25) + 0.75 over 2 requests
    ("frame_wait_s", 0.75),
    # request 0: 1.6, 3.0 (the decode's three left out); request 1: 22.0
    ("host_waits", 1.5),
    # (1.0 - 0.2) + 0.5 over 2 requests, in ms
    ("final_prefill_launch_ms", 650.0),
    # (0.5 - 0.2), (0.4 - 0.3), (0.4 - 0.3) over 3 steps, in ms
    ("decode_launch_ms", 500.0 / 3),
])
def test_host_readers_match_the_hand_count(monkeypatch, name, want):
    ctx = ctx_with(monkeypatch, SPANS, REQUESTS)
    assert reader(name)(ctx) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name", HOST_READERS)
def test_host_readers_read_nothing_without_the_programs_spans(monkeypatch,
                                                              name):
    """An empty list (no profiler recorded), a request without such spans,
    and a program without the list (the parent commit's port): None."""
    assert reader(name)(ctx_with(monkeypatch, [], REQUESTS)) is None
    assert reader(name)(ctx_with(monkeypatch, SPANS, [(40.0, 50.0)])) is None
    from quickvideo_tpu_torch.utils import timing

    monkeypatch.delattr(timing, "traced_spans")
    ctx = run.Context(None, [run.Record(0, 0, "q", 0.0, t_done=10.0)],
                      None, None, "bf16")
    assert reader(name)(ctx) is None


def test_the_tiny_cell_traced_on_the_cpu_reads_each_host_metric(tmp_path):
    root = make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] in HOST_READERS:
            m["workloads"].append(TINY_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(root)!r})\n"
        f"sys.path.append({str(REPO)!r})\n"
        "from qvbench import run\n"
        f"cell = run.load_cell(run.Path({str(root)!r}), {TINY_CELL!r})\n"
        "sys.exit(run.report(cell, 2**31 + 7, 2.0, True, 'cpu'))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    metrics = json.loads(out.stdout.strip().splitlines()[-1])["metrics"]
    got = {k: metrics[k]["value"] for k in HOST_READERS}
    assert got["frame_wait_s"] > 0 and got["final_prefill_launch_ms"] > 0
    assert got["decode_launch_ms"] > 0
    # per request at least the rotary positions', the prompt's and the
    # question's copies, and each of the two groups' normalization copies
    assert got["host_waits"] >= 3 + 2
