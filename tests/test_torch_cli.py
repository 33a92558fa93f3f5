"""The port's CLI (quickvideo_tpu_torch/lvu_cli.py) against the JAX
package's (quickvideo_tpu/lvu_cli.py).

`build_parser`: every flag of the JAX parser with the same action, type,
default, choices and count, plus the port's `--device {cuda, cpu}`; the
same parse of the JAX CLI tests' argument lists. `main`: one-shot --json
answers, --stream text, and --interactive sessions saved with
--session_file and resumed (by either CLI), each printing what the JAX
CLI prints on the same weights and the same fake video (tiny preset, f32;
both packages' decoders replaced, so no decoder library is needed), with
the timing fields and lines dropped and answers that spell their token
ids.
"""

import argparse
import io
import json

import pytest
import torch

import quickvideo_tpu.api as japi
import quickvideo_tpu_torch.api as tapi
from quickvideo_tpu import lvu_cli as jcli
from quickvideo_tpu_torch import lvu_cli as tcli

from test_torch_engine import params  # noqa: F401
from test_torch_images import _patch_readers

torch.set_num_threads(2)


def _actions(parser):
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        out[a.dest] = (type(a).__name__, tuple(a.option_strings), a.type,
                       a.default, a.choices, a.nargs, a.const)
    return out


def test_parser_has_every_jax_flag_and_a_device_flag():
    want, got = _actions(jcli.build_parser()), _actions(tcli.build_parser())
    device = got.pop("device")
    assert got == want
    assert device[1:5] == (("--device",), None, "cuda", ["cuda", "cpu"])


ARGVS = [
    [],
    ["--model_name_or_path", "qwen25-vl-3b", "--model_type", "qwen25_lvu",
     "--video_path", "v.mp4", "--question", "q1", "--question", "q2",
     "--top_k", "64", "--top_p", "0.5", "--top_k_starting_layer", "2",
     "--video_group_size", "32", "--prefill_prune_starting_layer", "1",
     "--fps", "1.0", "--do_top_k_for_query", "--top_k_decay_type", "linear",
     "--top_k_decay_factor", "0.5", "--max_new_tokens", "64", "--json"],
    ["--no-adaptive_local_attention", "--no-sample_on_device", "--no-enable",
     "--align_resize_to_window"],
    ["--kv_cache_dtype", "int8", "--kv_cache_capacity", "65536",
     "--decode_output", "yuv420", "--mesh", "1,1,2,1", "--seed", "7",
     "--save_video_cache", "--cache_dir", "/tmp/qc", "--resize_on_device",
     "--param_dtype", "int8", "--stream", "--stream_chunk_tokens", "4",
     "--interactive", "--session_file", "s.npz", "--demo", "--use_tqdm"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_parses_like_the_jax_cli(argv):
    got = vars(tcli.build_parser().parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == vars(jcli.build_parser().parse_args(argv))
    assert tcli.build_parser().parse_args(
        argv + ["--device", "cpu"]).device == "cpu"
    with pytest.raises(SystemExit):
        tcli.build_parser().parse_args(argv + ["--device", "tpu"])


@pytest.mark.parametrize("argv,rc", [
    (["--demo", "--mesh", "2,2"], 2),   # the mesh wants four axes
    ([], 2),                            # neither a video nor --demo
])
def test_refusals_match_the_jax_cli(argv, rc, capsys):
    assert tcli.main(argv) == rc == jcli.main(argv)
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 2 and err[0] == err[1]


def test_a_mesh_is_refused_by_the_lvu(tmp_path):
    """A pipeline-parallel mesh whose stage count does not divide the tiny
    preset's 3 layers is refused before any process group is asked for
    (a mesh that fits runs under torchrun: tests/test_torch_parallel.py,
    tests/test_torch_pipeline.py)."""
    with pytest.raises(ValueError,
                       match="num_hidden_layers=3 not divisible by pp=2"):
        tcli.main(["--video_path", str(tmp_path / "v.mp4"), "--mesh",
                   "1,2,1,1", "--model_name_or_path", "tiny", "--device",
                   "cpu"])


@pytest.fixture
def clis(params, monkeypatch):  # noqa: F811
    """Both CLIs' LVU built on the shared weights, with the fake decoders,
    and run(cli, argv, capsys): main(argv) on an empty stdin, returning
    the printed lines without timings."""
    jp, tp = params
    _patch_readers(monkeypatch)
    built = []

    def spelled(lvu):
        monkeypatch.setattr(lvu.tokenizer, "decode",
                            lambda ids: "".join(f"<{int(t)}>" for t in ids))
        built.append(lvu)
        return lvu

    orig_j, orig_t = japi.LVU, tapi.LVU
    monkeypatch.setattr(japi, "LVU",
                        lambda cfg: spelled(orig_j(cfg, params=jp)))
    monkeypatch.setattr(tapi, "LVU", lambda cfg, device=None: spelled(
        orig_t(cfg, params=tp, device=device)))

    def run(cli, argv, capsys):
        monkeypatch.setattr("sys.stdin", io.StringIO(""))
        assert cli.main(argv) == 0
        lines = []
        for line in capsys.readouterr().out.splitlines():
            if line.startswith(("Time taken", "[e2e ")):
                continue
            if line.startswith("{"):
                row = json.loads(line)
                row.pop("timings", None)
                row.pop("turn_s", None)
                line = json.dumps(row)
            elif line.startswith("A ("):  # "A (1.2s): answer"
                line = "A: " + line.split("): ", 1)[1]
            lines.append(line)
        return lines

    run.built = built
    return run


BASE = ["--model_name_or_path", "tiny", "--dtype", "float32",
        "--num_frames", "8", "--video_group_size", "4",
        "--max_new_tokens", "4", "--decode_output", "yuv420"]


@pytest.mark.parametrize("extra", [
    ["--json"],
    ["--json", "--model_type", "qwen25_lvu", "--top_p", "0.5"],
    ["--stream"],
    [],
])
def test_main_prints_what_the_jax_cli_prints(clis, capsys, tmp_path, extra):
    argv = BASE + ["--video_path", str(tmp_path / "clip.mp4"),
                   "--question", "What moves?", "--question", "Why?"] + extra
    want = clis(jcli, argv, capsys)
    got = clis(tcli, argv + ["--device", "cpu"], capsys)
    assert got == want
    assert len(got) >= 2
    if "--json" in extra:
        rows = [json.loads(line) for line in got]
        assert [r["question"] for r in rows] == ["What moves?", "Why?"]
        assert all(r["tokens"] == 4 and r["cache_length"] > 0 for r in rows)
    assert clis.built[-1].device.type == "cpu"


@pytest.mark.parametrize("resumer", [jcli, tcli], ids=["jax", "port"])
def test_interactive_session_file_round_trip(clis, capsys, tmp_path, resumer):
    """--interactive with queued questions and an empty stdin, saved to
    --session_file by the port's CLI, then resumed by either CLI: the same
    lines as the JAX CLI's own save and resume."""
    lines = {}
    for name, cli in (("jax", jcli), ("port", tcli)):
        sess = str(tmp_path / f"{name}.npz")
        argv = BASE + ["--video_path", str(tmp_path / "clip.mp4"),
                       "--model_type", "qwen25_lvu", "--interactive",
                       "--json", "--session_file", sess]
        dev = ["--device", "cpu"] if cli is tcli else []
        first = clis(cli, argv + dev + ["--question", "Describe the clip.",
                                        "--question", "What else?"], capsys)
        second_cli = cli if name == "jax" else resumer
        dev2 = ["--device", "cpu"] if second_cli is tcli else []
        second = clis(second_cli, argv + dev2 + ["--question", "And then?"],
                      capsys)
        lines[name] = [ln.replace(sess, "SESSION") for ln in first + second]
    assert lines["port"] == lines["jax"]
    text = "\n".join(lines["port"])
    assert "session saved to SESSION" in text
    assert "resumed session from SESSION (2 prior turns)" in text
    rows = [json.loads(ln) for ln in lines["port"] if ln.startswith("{")]
    assert [r["question"] for r in rows] == ["Describe the clip.",
                                             "What else?", "And then?"]
