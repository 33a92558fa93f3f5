"""A model family comes in as new files alone (qvbench/families/).

- A family `qwen_alias`, added to a checkout as a new package that
  re-exports `qwen2_5_vl` and records each name of the family contract the
  harness reaches, with a tiny configuration of that `model_type`: its
  cell serves the same tokens, reads the same checks (program and control)
  and reports the same metrics as the same cell under `qwen2_5_vl`; every
  name is reached; no file that was in the checkout changes.
- An unknown `model_type` stops the run, naming the missing folder, before
  any weights are made.
- `--control` on a configuration whose family has no control exits with
  the family's reason.
- A family without B1's bound: a traced line has no `b1_roofline_pct`,
  and its `mfu_pct` is that family's `request_ops` over the window.
- `--describe` of the benchmark's cells gives what it gave before there
  were families, with the `family` key beside it.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import REPO, TINY_CELL, make_root, tiny_config

from qvbench import families, run

SEED = 2**31 + 2203
WINDOW_S = 1.0
INT8_LIMITS = {"logit_gap": 0.05, "kept_off_share": 0.05,
               "length_mismatch": 0}

# A family package made of another: the names in LEFT_OUT are missing, the
# module's own definitions replace the base's, every other name is the
# base's, and each use of one is recorded in REACHED.
FAMILY = '''"""{doc}"""

import functools

from qvbench.families import qwen2_5_vl as base

REACHED = set()
LEFT_OUT = {left_out!r}


def __dir__():
    return sorted((set(dir(base)) | set(globals())) - set(LEFT_OUT))


def __getattr__(name):
    if name.startswith("_") or name in LEFT_OUT or not hasattr(base, name):
        raise AttributeError(name)
    value = getattr(base, name)
    if not callable(value):
        REACHED.add(name)
        return value

    @functools.wraps(value)
    def call(*args, **kw):
        REACHED.add(name)
        return value(*args, **kw)

    return call
{own}'''

NO_B1_OPS = '''

def request_ops(spec, mix, question, n_tokens):
    """One millisecond at the bf16 peak a request."""
    from qvbench.roofline import PEAK_OPS_PER_S

    return {"bf16": PEAK_OPS_PER_S["bf16"] * 1e-3}
'''

NO_CONTROL = '''

def control_unavailable(spec):
    return "no_control: this family brings no control"
'''

# Drives the harness in a fresh interpreter from the checkout `root`: each
# run's window holds exactly one request (each served request is held to
# the window's length); a traced run's reduced trace gains one B1 and one
# B3 kernel, so that the kernel readers have device time to read on the
# CPU. Prints one JSON line: per cell, each run's result and served tokens,
# and the names each family recorded.
DRIVER = '''
import json, sys, time
sys.path.insert(0, {root!r})
sys.path.append({repo!r})
from qvbench import families, run, trace

served = []
inner_serve = run.serve


def serve(lvu, req, box):
    rec = inner_serve(lvu, req, box)
    if req.index >= 0:
        served.append(rec.tokens)
        time.sleep(max(0.0, rec.t_call + {window} - time.perf_counter()))
    return rec


run.serve = serve
inner_read = trace.Trace.from_profile.__func__


def from_profile(cls, prof):
    tr = inner_read(cls, prof)
    lo = tr.window[0]
    tr.ops += [trace.Op("flash_prefill_kernel", lo, lo + 10**6, "prefill"),
               trace.Op("gemm_bias_kernel", lo, lo + 10**6, "vision")]
    return tr


trace.Trace.from_profile = classmethod(from_profile)
out = {{}}
for name, modes in {cells!r}:
    cell = run.load_cell(run.Path({root!r}), name)
    runs = []
    for mode in modes:
        del served[:]
        res, _ = run.run_cell(cell, {seed}, {window}, mode == "traced", "cpu",
                              control=mode == "control")
        runs.append({{"mode": mode, "result": res, "served": list(served)}})
    out[name] = {{"runs": runs,
                 "reached": sorted(getattr(cell.family, "REACHED", ()))}}
print(json.dumps(out))
'''


def _digests(root: Path) -> dict:
    import hashlib

    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def add_family(root: Path, name: str, left_out=(), own="") -> None:
    pkg = root / "qvbench" / "families" / name
    pkg.mkdir()
    (pkg / "__init__.py").write_text(FAMILY.format(
        doc=f"Qwen2.5-VL as the family {name}.", left_out=tuple(left_out),
        own=own))


def add_cell(root: Path, config_name: str, config: dict,
             limits=INT8_LIMITS) -> str:
    """A configuration and its cell under the tiny mix, as new files and
    BENCHMARK.json entries; every metric kept to some cells reads this one
    too."""
    cell = f"{config_name}.clip8"
    cdir = root / "qvbench" / "configs" / config_name
    cdir.mkdir()
    (cdir / "config.json").write_text(json.dumps(config))
    (root / "qvbench" / "limits" / f"{cell}.json").write_text(
        json.dumps(limits))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": config_name, "source": "test", "reduced": [], "why": "test",
        "file": f"qvbench/configs/{config_name}/config.json"})
    bench["workloads"].append({"name": cell, "config": config_name,
                               "traffic": "clip8", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell


def of_family(model_type=None, **kw) -> dict:
    config = tiny_config(**kw)
    if model_type is not None:
        config["model_type"] = model_type
    return config


def drive(root: Path, cells) -> dict:
    code = DRIVER.format(root=str(root), repo=str(REPO), seed=SEED,
                         window=WINDOW_S, cells=[list(c) for c in cells])
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_family_added_as_new_files_runs_the_tiny_cell_as_its_base(
        tmp_path):
    root = make_root(tmp_path)
    before = _digests(root)
    add_family(root, "qwen_alias")
    base = add_cell(root, "tiny-base", of_family(param_dtype="int8"))
    alias = add_cell(root, "tiny-alias",
                     of_family("qwen_alias", param_dtype="int8"))
    modes = ["untraced", "traced", "control"]
    got = drive(root, [(base, modes), (alias, modes)])

    for a, b in zip(got[base]["runs"], got[alias]["runs"]):
        ra, rb = a["result"], b["result"]
        assert ra["attempted"] == rb["attempted"] == 1, a["mode"]
        assert a["served"] == b["served"] and len(a["served"][0]) > 0
        assert ra["checks"] == rb["checks"], a["mode"]
        assert set(ra["metrics"]) == set(rb["metrics"]), a["mode"]
        assert ra["correct"] == rb["correct"] == (a["mode"] != "control")
    untraced, traced = (r["result"]["metrics"]
                        for r in got[alias]["runs"][:2])
    assert {"ttft_s", "request_s", "ttft_p90_s", "peak_mem_gib",
            "setup_s"} <= set(untraced)
    assert {"b1_roofline_pct", "vision_mlp_roofline_pct", "mfu_pct",
            "kv_cache_mib"} <= set(traced)
    assert got[base]["reached"] == []
    assert set(got[alias]["reached"]) == set(families.REQUIRED
                                             + families.OPTIONAL)

    after = _digests(root)
    assert {k for k in before if before[k] != after.get(k)} == {
        "BENCHMARK.json"}
    added = {Path(k).parts[1] for k in set(after) - set(before)}
    assert added == {"families", "configs", "limits"}


@pytest.mark.parametrize("how", ["load_cell", "describe"])
def test_an_unknown_model_type_stops_before_any_weights(tmp_path, how):
    root = make_root(tmp_path, of_family("no_such_family"))
    want = "qvbench/families/no_such_family/"
    if how == "load_cell":
        with pytest.raises(SystemExit, match=want):
            run.load_cell(root, TINY_CELL)
        return
    out = subprocess.run(
        [sys.executable, "qvbench/run.py", "--workload", TINY_CELL,
         "--describe"], cwd=root, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 1 and want in out.stderr
    assert "{" not in out.stdout


@pytest.mark.parametrize("family,reason", [
    ("no_control", "no_control: this family brings no control"),
    ("qwen2_5_vl", "a control is defined for int8 weights only"),
])
def test_control_without_one_exits_with_the_family_reason(tmp_path, family,
                                                          reason):
    """The no_control family; Qwen2.5-VL served with f32 weights."""
    root = make_root(tmp_path, of_family(family))
    add_family(root, "no_control", left_out=("check_control",),
               own=NO_CONTROL)
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(root)!r})\n"
        f"sys.path.append({str(REPO)!r})\n"
        "from qvbench import run\n"
        f"cell = run.load_cell(run.Path({str(root)!r}), {TINY_CELL!r})\n"
        f"sys.exit(run.report(cell, {SEED}, 0.3, False, 'cpu', "
        "control=True))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 1, out.stderr[-3000:]
    assert reason in out.stderr
    assert "set-up:" not in out.stderr and "{" not in out.stdout


def test_a_family_without_b1s_bound_leaves_b1_out_and_counts_its_own(
        tmp_path):
    root = make_root(tmp_path)
    add_family(root, "no_b1", left_out=("b1_group_bound_s",), own=NO_B1_OPS)
    cell = add_cell(root, "tiny-no-b1", of_family("no_b1",
                                                  param_dtype="int8"))
    res = drive(root, [(cell, ["traced"])])[cell]["runs"][0]["result"]
    assert res["correct"]
    assert "b1_roofline_pct" not in res["metrics"]
    assert "vision_mlp_roofline_pct" in res["metrics"]
    mfu = res["metrics"]["mfu_pct"]["value"]
    assert mfu == pytest.approx(100.0 * 1e-3 / res["device"]["window_s"],
                                rel=1e-12)


def _before_families(cell: str) -> dict:
    """What `--describe` printed before there were families, worked out
    from the files."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    w = {x["name"]: x for x in bench["workloads"]}[cell]
    c = {x["name"]: x for x in bench["configs"]}[w["config"]]
    raw = json.loads((REPO / c["file"]).read_text())
    mix = json.loads((REPO / "qvbench/traffic" / f"{w['traffic']}.json")
                     .read_text())

    def applies(m):
        return "workloads" not in m or cell in m["workloads"]

    return {
        "workload": cell, "config": Path(c["file"]).parent.name,
        "layers": raw.get("text_config", raw)["num_hidden_layers"],
        "traffic": w["traffic"], "frames": mix["video"]["frames"],
        "end_to_end": [m["name"] for m in bench["end_to_end"]
                       if applies(m)],
        "per_layer": {m["name"]: f"qvbench.metrics.{m['name']}"
                      for m in bench["per_layer"] if applies(m)},
        "limits": json.loads((REPO / "qvbench/limits" / f"{cell}.json")
                             .read_text()),
    }


@pytest.mark.parametrize("cell", ["qwen25-vl-7b-int8w.video1024",
                                  "qwen25-vl-7b-int8w.clip64"])
def test_describe_of_the_cells_is_as_before_with_the_family(cell):
    out = subprocess.run(
        [sys.executable, "qvbench/run.py", "--workload", cell,
         "--describe"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    found = json.loads(out.stdout.strip().splitlines()[-1])
    assert found.pop("family") == "qwen2_5_vl"
    assert found == _before_families(cell)
