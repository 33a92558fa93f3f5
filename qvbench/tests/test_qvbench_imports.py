"""What a run may import, and that a cell is found by its files' names."""

import hashlib
import json
import subprocess
import sys
from pathlib import Path

from conftest import REPO, TINY, TINY_CELL, make_root

FORBIDDEN = {"jax", "jaxlib", "flax", "quickvideo_tpu"}


def _modules(root: Path):
    pkg = root / "qvbench"
    return sorted(
        ".".join(p.relative_to(root).with_suffix("").parts)
        for p in pkg.rglob("*.py")
        if "tests" not in p.parts and p.name != "__init__.py"
    )


def _fresh(code: str, root: Path = REPO) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_a_run_imports_neither_jax_nor_the_jax_package(tmp_path):
    """Every module of the benchmark imported, and a tiny cell run on the
    CPU through the port, in a fresh interpreter."""
    root = make_root(tmp_path)
    mods = _modules(REPO)
    assert "qvbench.run" in mods and "qvbench.reference.model" in mods
    code = (
        "import sys, importlib, json\n"
        f"sys.path.insert(0, {str(root)!r})\n"
        f"sys.path.append({str(REPO)!r})\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "from qvbench import run\n"
        f"cell = run.load_cell(run.Path({str(root)!r}), {TINY_CELL!r})\n"
        "res, _ = run.run_cell(cell, 5, 0.5, False, 'cpu')\n"
        "assert res['correct'], res\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    top = set(json.loads(_fresh(code, root).strip().splitlines()[-1]))
    assert not top & FORBIDDEN, top & FORBIDDEN
    # compared whole: the port's own name begins with the JAX package's
    assert "quickvideo_tpu_torch" in top


def test_the_reference_loads_nothing_of_the_program():
    mods = [m for m in _modules(REPO) if m.startswith("qvbench.reference")]
    code = (
        "import sys, importlib, json\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    top = set(json.loads(_fresh(code).strip().splitlines()[-1]))
    assert not top & (FORBIDDEN | {"quickvideo_tpu_torch"})


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_config_mix_and_metric_are_found_by_name(tmp_path):
    root = make_root(tmp_path)
    before = _digests(root)
    # a new per-layer metric: its reader and its BENCHMARK.json entry
    (root / "qvbench/metrics/answer_tokens.py").write_text(
        "def read(ctx):\n"
        "    return float(sum(len(r.tokens) for r in ctx.requests))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "answer_tokens", "unit": "tokens", "better": "higher",
        "source": "program_counter", "layer": "decode loop",
        "moves": "ttft_s", "workloads": [TINY_CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run(
        [sys.executable, "qvbench/run.py", "--workload", TINY_CELL,
         "--describe"], cwd=root, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    found = json.loads(out.stdout.strip().splitlines()[-1])
    assert found["config"] == TINY and found["traffic"] == "clip8"
    assert found["layers"] == 3 and found["frames"] == 8
    assert found["per_layer"]["answer_tokens"] == "qvbench.metrics.answer_tokens"
    assert "vision_mlp_roofline_pct" not in found["per_layer"]
    assert found["limits"]["length_mismatch"] == 0
    after = _digests(root)
    changed = {k for k in before if before[k] != after.get(k)}
    # BENCHMARK.json gains entries; no file of the harness is edited
    assert changed == {"BENCHMARK.json"}
