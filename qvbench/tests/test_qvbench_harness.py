"""The harness around the check: the end-to-end arithmetic, the look for
JAX after the whole run, and a traced window that records only the host's
user ranges."""

import json
import subprocess
import sys
from unittest import mock

import pytest

from conftest import REPO, TINY_CELL, make_root


def test_end_to_end_metrics_take_every_request_finished_in_the_window():
    from qvbench import run

    recs = []
    for i, (call, first, last, done) in enumerate(
            [(0.0, 1.0, 1.5, True), (2.0, 4.0, 4.5, True),
             (5.0, 5.2, 9.0, False)]):
        r = run.Record(i, i, "q", call, first, last, last, [1, 2, 3])
        r.completed = done
        recs.append(r)
    out = run.end_to_end(recs, 3 * 2**30, 12.5)
    assert out["ttft_s"] == (pytest.approx(1.5), "s")
    assert out["request_s"] == (pytest.approx(2.0), "s")
    assert out["setup_s"] == (12.5, "s")
    assert out["peak_mem_gib"] == (3.0, "GiB")
    assert "tpot_ms" not in out


def test_a_metric_reader_that_loads_the_jax_package_gives_no_result(
        tmp_path):
    """A per-layer reader, imported after the window, loads a module named
    `quickvideo_tpu` (a stand-in package in the checkout): the run exits 3
    and prints no result line."""
    root = make_root(tmp_path)
    (root / "quickvideo_tpu").mkdir()
    (root / "quickvideo_tpu" / "__init__.py").write_text("")
    (root / "qvbench/metrics/loads_jax_package.py").write_text(
        "import quickvideo_tpu  # noqa: F401\n\n\n"
        "def read(ctx):\n"
        "    return 1.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "loads_jax_package", "unit": "s", "better": "lower",
        "source": "program_counter", "layer": "device", "moves": "ttft_s",
        "workloads": [TINY_CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(root)!r})\n"
        f"sys.path.append({str(REPO)!r})\n"
        "from qvbench import run\n"
        f"cell = run.load_cell(run.Path({str(root)!r}), {TINY_CELL!r})\n"
        "assert 'quickvideo_tpu' not in sys.modules\n"
        "sys.exit(run.report(cell, 5, 0.5, True, 'cpu'))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 3, out.stderr[-3000:]
    assert "{" not in out.stdout
    assert "loaded forbidden modules: ['quickvideo_tpu']" in out.stderr


def test_a_torch_without_the_user_range_scope_fails_the_traced_run():
    import torch.autograd.profiler as ap

    from qvbench import trace

    real = ap._enable_profiler

    def no_scopes(config, activities, *scopes):
        if scopes:
            raise TypeError("no scopes in this torch")
        return real(config, activities)

    with mock.patch.object(ap, "_enable_profiler", no_scopes):
        with pytest.raises(TypeError):
            trace.profiler("cpu")
