"""Run one cell of the benchmark once and print its result line.

    python qvbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (BENCHMARK.json's `workloads` entry) names a configuration, whose
published config.json with the run's settings sits at the entry's `file`,
and a traffic mix (qvbench/traffic/<name>.json). One run:

  set-up    the weights made on the card from the seed, the port's `LVU`
            built on them (int8 codes made by the port where the
            configuration serves int8 weights), one request of the mix's
            shape; kernels load from the port's build directory inside the
            checkout (built there by a checkout's first run)
  window    for --seconds, one client sends the mix's requests through
            `LVU.generate`, each when the one before has finished; with
            --trace 1 under torch.profiler (CPU and CUDA)
  check     the program freed, a seeded sample of the finished requests
            (the longest question among them) goes through the plain
            PyTorch reference (qvbench/reference/); each number compared
            is printed beside its limit (qvbench/limits/<cell>.json)

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics, each read by qvbench/metrics/<name>.py),
`device`, with --trace 1 `breakdown`, and last `checks`. Without a CUDA
device, or with fewer than the cell asks for, it exits 2 and prints no
result. It exits 3, and prints no result, if jax, jaxlib, flax or
quickvideo_tpu is loaded once the run is over (the window, the metric
readers and the check), just before the result would be printed.

`--control` runs the cell's control instead of the program's check: for a
configuration of int8 weights it keeps the program's window and puts the
reference with int4 weights in its place. `--describe` prints what the
harness finds for the cell (configuration, mix, metric readers, limits)
and runs nothing.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
# the port's transformers-based paths must not pull in JAX
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "quickvideo_tpu")


def log(msg: str) -> None:
    print(f"[qvbench] {msg}", file=sys.stderr, flush=True)


def process_age() -> float:
    """Seconds between this process's start and T_START (0 where /proc
    does not say)."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK")
                   - (time.perf_counter() - T_START))
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# -- the cell -----------------------------------------------------------


@dataclass
class Cell:
    root: Path  # the checkout: BENCHMARK.json and the benchmark's folder
    name: str
    chips: int
    config_file: Path
    traffic: str
    end_to_end: List[str]
    per_layer: List[str]
    limits: Dict[str, float]
    units: Dict[str, str]


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[w["config"]]
    limits = json.loads((root / "qvbench" / "limits" / f"{workload}.json")
                        .read_text())
    return Cell(
        root=root, name=workload, chips=int(w["chips"]),
        config_file=root / config["file"], traffic=w["traffic"],
        end_to_end=[m["name"] for m in bench["end_to_end"]
                    if _applies(m, workload)],
        per_layer=[m["name"] for m in bench["per_layer"]
                   if _applies(m, workload)],
        limits=limits,
        units={m["name"]: m["unit"]
               for m in bench["end_to_end"] + bench["per_layer"]},
    )


# -- one request ------------------------------------------------------------


@dataclass
class Record:
    index: int
    video: int
    question: str
    t_call: float
    t_first: float = math.nan
    t_last: float = math.nan
    t_done: float = math.nan
    tokens: List[int] = field(default_factory=list)
    kv_bytes: int = 0
    cache_length: int = 0
    layer_lengths: List[int] = field(default_factory=list)
    retained: Optional[list] = None
    completed: bool = False

    @property
    def ttft(self) -> float:
        return self.t_first - self.t_call


def capture_retained(lvu) -> dict:
    """Keeps each request's retained sets (the engine's prefill state) in
    the returned box; references only, nothing is copied or waited for."""
    engine = lvu.engine
    inner = engine.prefill
    box = {}

    def prefill(inputs, timer=None, extra_capacity=0):
        cache, state = inner(inputs, timer, extra_capacity)
        box["retained"] = state["retained"]
        return cache, state

    engine.prefill = prefill
    return box


def serve(lvu, req, box) -> Record:
    import torch
    from qvbench.frames import parse_path
    from qvbench.trace import REQUEST_SPAN

    rec = Record(req.index, parse_path(req.path)[1], req.question,
                 time.perf_counter())
    arrivals = []

    def on_tokens(tokens):
        arrivals.append(time.perf_counter())

    with torch.profiler.record_function(REQUEST_SPAN):
        lvu.generate(req.question, req.path,
                     max_new_tokens=req.max_new_tokens, on_tokens=on_tokens)
    rec.t_done = time.perf_counter()
    res = lvu.last_result
    rec.t_first, rec.t_last = arrivals[0], arrivals[-1]
    rec.tokens = [int(t) for t in res.tokens]
    rec.kv_bytes, rec.cache_length = res.kv_cache_bytes, res.cache_length
    rec.layer_lengths = list(res.layer_lengths)
    rec.retained = box.pop("retained", None)
    return rec


# -- metrics ----------------------------------------------------------------


def quantile(values: List[float], q: float) -> float:
    """The q-quantile, linear between order statistics."""
    xs = sorted(values)
    pos = q * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def end_to_end(records: List[Record], peak: int, setup_s: float) -> dict:
    done = [r for r in records if r.completed]
    out = {"setup_s": (setup_s, "s"), "peak_mem_gib": (peak / 2**30, "GiB")}
    if done:
        ttfts = [r.ttft for r in done]
        out["ttft_s"] = (statistics.fmean(ttfts), "s")
        out["ttft_p90_s"] = (quantile(ttfts, 0.9), "s")
        out["request_s"] = (statistics.fmean(r.t_last - r.t_call
                                             for r in done), "s")
    return out


def kv_variant(spec, rec: Record) -> str:
    t = spec.text
    per = rec.kv_bytes / max(rec.cache_length, 1) / (t.layers * t.kv_heads)
    d = t.head_dim
    return {4 * d: "bf16", 2 * (d + 4): "int8", 3 * d + 4: "int8k"}.get(
        round(per), "bf16")


@dataclass
class Context:
    trace: object
    requests: List[Record]
    spec: object
    mix: object
    kv_variant: str


# -- the run --------------------------------------------------------------


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sample(records: List[Record], n: int, seed: int) -> List[Record]:
    """`n` finished requests drawn from the seed, the one with the longest
    question (the first of them) always among them."""
    done = [r for r in records if r.t_done == r.t_done]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.question), -r.index))
    rest = [r for r in done if r is not longest]
    random.Random(seed).shuffle(rest)
    return [longest] + rest[: max(0, n - 1)]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             control: bool = False):
    """One run of `cell`: returns (result dict, check lines)."""
    import torch
    from qvbench import frames as qframes
    from qvbench.frames import FramePool, seeded_videos
    from qvbench.metrics import reader
    from qvbench.reference.compare import NUMBERS, check_control, \
        check_program
    from qvbench.spec import load_spec
    from qvbench.trace import WINDOW_SPAN, Trace, profiler
    from qvbench.traffic import load_mix
    from qvbench.weights import make_params

    device = torch.device(device)
    spec = load_spec(cell.config_file)
    mix = load_mix(cell.root / "qvbench", cell.traffic)
    wseed = qframes.hash64(seed, 0x5EED)
    pool = FramePool(seed)
    video = mix.video
    if control and not spec.int8_weights:
        raise SystemExit(f"{spec.name}: a control is defined for int8 "
                         "weights only (the reference at int4)")
    settings = dict(spec.run)

    from quickvideo_tpu_torch.api import LVU
    from quickvideo_tpu_torch.config import LVUConfig

    cfg = LVUConfig(model_name_or_path=str(cell.config_file.parent),
                    model_type="qwen25_lvu_interleaved", seed=0,
                    **settings, **mix.lvu)
    failed = attempted = 0
    with seeded_videos(pool, video["frames"], video["fps"],
                       (video["height"], video["width"])):
        params = make_params(spec, wseed, device,
                             getattr(torch, settings["dtype"]))
        _sync(device)
        t_w = time.perf_counter()
        lvu = LVU(cfg, params=params, device=device)
        del params
        gc.collect()
        box = capture_retained(lvu)
        _sync(device)
        t_l = time.perf_counter()
        serve(lvu, mix.warmup_request(seed), box)
        _sync(device)
        log(f"set-up: to weights {t_w - T_START:.2f} s, LVU "
            f"{t_l - t_w:.2f} s, warm-up {time.perf_counter() - t_l:.2f} s")
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        prof = profiler(device.type) if trace else None
        requests = mix.requests(seed)
        records: List[Record] = []
        t0 = time.perf_counter()
        setup_s = t0 - T_START + process_age()
        end = t0 + seconds
        with torch.profiler.record_function(WINDOW_SPAN):
            while time.perf_counter() < end:
                req = next(requests)
                attempted += 1
                try:
                    rec = serve(lvu, req, box)
                except Exception:  # a failed request counts, the run goes on
                    failed += 1
                    traceback.print_exc()
                    continue
                rec.completed = rec.t_done <= end
                records.append(rec)
            _sync(device)
        t_end = time.perf_counter()
        if prof is not None:
            prof.stop()
            log(f"profiler stop {time.perf_counter() - t_end:.2f} s")
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
    log(f"window: {attempted} requests, "
        f"{sum(r.completed for r in records)} finished inside, "
        f"{t_end - t0:.2f} s")

    result = {"correct": False, "attempted": attempted, "failed": failed}
    metrics = {}
    if trace:
        t_p = time.perf_counter()
        tr = Trace.from_profile(prof)
        del prof
        log(f"trace read {time.perf_counter() - t_p:.2f} s")
        ctx = Context(tr, records, spec, mix,
                      kv_variant(spec, records[0]) if records else "bf16")
        for name in cell.per_layer:
            value = reader(name)(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": cell.units[name]}
        placed = sum(o.span is not None for o in tr.ops)
        log(f"trace: {len(tr.ops)} device ops, {placed} under a span, "
            f"busy {tr.busy_s:.4f} s of {tr.window_s:.4f} s")
        result["breakdown"] = {"device_ops": [list(x) for x in tr.top_ops()],
                               "idle_gaps": [list(x) for x in tr.idle_gaps()]}
        busy_window = (tr.busy_s, tr.window_s)
        del tr, ctx
    else:
        for name, (value, unit) in end_to_end(records, peak,
                                              setup_s).items():
            if name in cell.end_to_end:
                metrics[name] = {"value": value, "unit": unit}
    result["metrics"] = metrics
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": peak}
    if trace:
        dev["busy_s"], dev["window_s"] = busy_window
    result["device"] = dev

    # the check: the program freed first, then the reference
    checked = sample(records, mix.check_requests, seed)
    keep = {id(r) for r in checked}
    for r in records:
        if id(r) not in keep:
            r.retained = None
    del lvu, box
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    tree = make_params(spec, wseed, device, getattr(torch, spec.run["dtype"]))
    if not checked:
        readings = {k: math.inf for k in NUMBERS}
    elif control:
        readings = check_control(tree, spec, mix, pool, checked, device,
                                 "int4")
    else:
        readings = check_program(tree, spec, mix, pool, checked, device)
    del tree
    log(f"reference: {len(checked)} requests, "
        f"{sum(len(r.tokens) for r in checked)} tokens, "
        f"{time.perf_counter() - t_ref:.2f} s")
    # a number without a limit in the cell's file has no upper reading
    # there (PERF.md): it is printed, not compared
    for k in NUMBERS:
        if k not in cell.limits:
            log(f"{k} {readings[k]!r} (not compared in this cell)")
    checks = {k: {"value": readings[k], "limit": cell.limits[k]}
              for k in NUMBERS if k in cell.limits}
    result["correct"] = bool(
        checked and failed == 0
        and all(c["value"] <= c["limit"] for c in checks.values()))
    result["checks"] = checks
    lines = [f"check {k} {c['value']!r} limit {c['limit']!r}"
             for k, c in checks.items()]
    return result, lines


def describe(cell: Cell) -> dict:
    """What the harness finds for `cell`, by name, without running it."""
    from qvbench.metrics import reader
    from qvbench.spec import load_spec
    from qvbench.traffic import load_mix

    spec = load_spec(cell.config_file)
    mix = load_mix(cell.root / "qvbench", cell.traffic)
    return {
        "workload": cell.name, "config": spec.name,
        "layers": spec.text.layers, "traffic": mix.name,
        "frames": mix.video["frames"],
        "end_to_end": cell.end_to_end,
        "per_layer": {n: reader(n).__module__ for n in cell.per_layer},
        "limits": cell.limits,
    }


def report(cell: Cell, seed: int, seconds: float, trace: bool, device,
           control: bool = False) -> int:
    """Runs `cell` once and prints its result line; returns the exit code.
    The look for forbidden modules comes last, after the metric readers
    and the check have run, so that whatever they loaded is seen."""
    result, lines = run_cell(cell, seed, seconds, trace, device,
                             control=control)
    found = forbidden_modules()
    if found:
        log(f"loaded forbidden modules: {found}; no result")
        return 3
    for line in lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--describe", action="store_true")
    args = ap.parse_args(argv)
    root = REPO
    cell = load_cell(root, args.workload)
    if args.describe:
        print(json.dumps(describe(cell)))
        return 0
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"needs {cell.chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    return report(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
                  control=args.control)


if __name__ == "__main__":
    sys.exit(main())
