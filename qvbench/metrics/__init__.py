"""Per-layer metrics: one reader a file, found by the metric's name.

`qvbench/metrics/<name>.py` defines `read(ctx)`, which returns the
metric's value from the traced run, or None where the run gives it nothing
to read (the harness then leaves the metric out of the line). `ctx` is
qvbench.run.Context: the reduced trace (`ctx.trace`, qvbench/trace.py),
the requests run inside it (`ctx.requests`: question, tokens served, the
program's counters), the configuration (`ctx.spec`), its family
(`ctx.family`, qvbench/families/: the operation counts and kernel bounds),
the mix (`ctx.mix`) and the resolved KV cache kind (`ctx.kv_variant`).
"""

import importlib


def reader(name: str):
    return importlib.import_module(f"qvbench.metrics.{name}").read
