"""Process-level checks of the PyTorch port: neither the port (its video,
int8, pruning-mode and image requests; a chat session saved and resumed,
continuation scoring, a checkpoint load; the CLI, the HTTP server, the disk
frame cache and the on-device resize; the package's top-level names; each
rank of a gloo mesh and the parallel/ modules; the HTTP server on a mesh,
its leader and follower ranks; the full-sequence forward, the live-module
loader and the span report) nor
chip_smoke.py imports jax or any module of the JAX package
(quickvideo_tpu), and the port never needs the safetensors package, and
chip_smoke.py refuses to report a result without a CUDA card or outside a
checkout. Each needs a fresh interpreter (tests/conftest.py imports jax
into every test process), so they run subprocesses."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the modules a run must not have imported
FORBIDDEN = r"""
def forbidden():
    import sys
    return sorted(m for m in sys.modules
                  if m in ("jax", "quickvideo_tpu", "safetensors")
                  or m.startswith(("jax.", "flax", "jaxlib", "quickvideo_tpu.",
                                   "safetensors.")))
"""

SLICE = FORBIDDEN + r"""
import pkgutil, sys
assert not forbidden(), forbidden()
import numpy as np, torch
torch.set_num_threads(1)
import quickvideo_tpu_torch
for m in pkgutil.walk_packages(quickvideo_tpu_torch.__path__, "quickvideo_tpu_torch."):
    __import__(m.name)
from quickvideo_tpu_torch.config import LVUConfig
from quickvideo_tpu_torch.api import LVU
from quickvideo_tpu_torch.prefill import PrefillInputs
lvu = LVU(LVUConfig(model_name_or_path="tiny", top_p=0.5, dtype="float32",
                    max_decode_tokens=4), device="cpu")
cfg = lvu.model_config
rng = np.random.default_rng(0)
frames = rng.integers(0, 256, (4, 224 * 224 * 3 // 2), dtype=np.uint8)
n_vid = 2 * 8 * 8
ids = np.concatenate([[5, 6], [cfg.vision_start_token_id],
                      np.full(n_vid, cfg.video_token_id),
                      [cfg.vision_end_token_id], [7, 8, 9]]).astype(np.int64)
res = lvu.engine.generate(
    PrefillInputs(ids, (2, 16, 16), [frames[:2], frames[2:]],
                  [(1, 16, 16), (1, 16, 16)], 1.0),
    max_new_tokens=3,
)
assert len(res.tokens) == 3, res.tokens
lvu8 = LVU(LVUConfig(model_name_or_path="tiny", top_p=0.5, dtype="float32",
                     param_dtype="int8", max_decode_tokens=4), device="cpu")
res8 = lvu8.engine.generate(
    PrefillInputs(ids, (2, 16, 16), [frames[:2], frames[2:]],
                  [(1, 16, 16), (1, 16, 16)], 1.0),
    max_new_tokens=3,
)
assert len(res8.tokens) == 3, res8.tokens
# B1's lse and pure-past modes, a cascade and the local-only branch
for kw in (dict(top_k_predict_type="salient_tokens", kv_cache_dtype="int8"),
           dict(top_k_predict_type="query_attention_weights", query_based=True,
                top_k_decay_type="linear", prefill_prune_starting_layer=1),
           dict(adaptive_local_attention=False, top_k_predict_type="random")):
    res = LVU(LVUConfig(model_name_or_path="tiny", top_p=0.5, dtype="float32",
                        max_decode_tokens=4, **kw), device="cpu").engine.generate(
        PrefillInputs(ids, (2, 16, 16), [frames[:2], frames[2:]],
                      [(1, 16, 16), (1, 16, 16)], 1.0),
        max_new_tokens=2,
    )
    assert len(res.tokens) == 2, (kw, res.tokens)
# images: LVU.chat with an image alone, then an image before the video on
# the head-major vision route (kernel B5's plain version)
img = rng.integers(0, 256, (140, 140, 3), dtype=np.uint8)
out = lvu.chat([{"role": "user", "content": [
    {"type": "image", "image": img}, {"type": "text", "text": "What is it?"},
]}], max_new_tokens=2)
assert isinstance(out, list) and len(lvu.last_result.tokens) == 2
import os
os.environ["QV_VISION_2D"] = "0"
img_ids = np.concatenate([[cfg.vision_start_token_id],
                          np.full(25, cfg.image_token_id),
                          [cfg.vision_end_token_id]]).astype(np.int64)
res = lvu.engine.generate(
    PrefillInputs(np.concatenate([img_ids, ids]), (2, 16, 16),
                  [frames[:2], frames[2:]], [(1, 16, 16), (1, 16, 16)], 1.0,
                  image_grid_thw=np.array([(1, 10, 10)]),
                  image_pixels=[img.transpose(2, 0, 1)[None]]),
    max_new_tokens=2,
)
assert len(res.tokens) == 2, res.tokens
assert not forbidden(), forbidden()
print("NOJAX_OK")
"""

SESSION = FORBIDDEN + r"""
import os, sys, tempfile
assert not forbidden(), forbidden()
import numpy as np, torch
torch.set_num_threads(1)
from quickvideo_tpu_torch.config import LVUConfig
from quickvideo_tpu_torch.api import LVU
from quickvideo_tpu_torch.models.qwen25_vl.config import get_config
from quickvideo_tpu_torch.models.qwen25_vl.convert import init_params
from quickvideo_tpu_torch.testing import write_checkpoint
from quickvideo_tpu_torch.video import quickdecode as qd
from quickvideo_tpu_torch.video import reader as vreader


class Reader:
    # the native reader's surface over seeded frames
    def __init__(self, path, num_threads=8, num_intervals=64):
        self.source_height = self.source_width = 224
        self.height = self.width = self.interpolation = None
        self.output_format, self.frame_iter, self._pos = "RGB", 1, 0

    def __len__(self):
        return 8

    def get_fps(self):
        return 4.0

    def process(self, indices):
        # the size the plan asked for, else the source size
        h = self.height or self.source_height
        w = self.width or self.source_width
        n = h * w * 3 // 2
        self._frames = np.stack([np.random.default_rng(i).integers(
            0, 256, n, dtype=np.uint8) for i in indices])

    def __next__(self):
        block = self._frames[self._pos : self._pos + self.frame_iter]
        self._pos += len(block)
        if not len(block):
            raise StopIteration
        return block

    def close(self):
        pass


    def get_batch(self, indices):
        self.process(indices)
        return self._frames


qd.InterleavedVideoReader = Reader
vreader.register_backend("seeded", lambda path, threads: Reader(path))
os.environ["FORCE_QWENVL_VIDEO_READER"] = "seeded"
tmp = tempfile.mkdtemp()
cfg = get_config("tiny")
ckpt = write_checkpoint(os.path.join(tmp, "ckpt"), init_params(cfg, 1, torch.float32), cfg)
lvu = LVU(LVUConfig(model_name_or_path=ckpt, model_type="qwen25_lvu_interleaved",
                    num_frames=8, video_group_size=4, top_p=0.5,
                    max_decode_tokens=4, decode_output="yuv420", dtype="float32"),
          device="cpu")
s = lvu.start_chat("clip.mp4", reserve_turns=2)
s.ask("What?", max_new_tokens=2)
s.save(os.path.join(tmp, "s.npz"))
r = lvu.resume_chat(os.path.join(tmp, "s.npz"))
assert r.ask("And?", max_new_tokens=2) == s.ask("And?", max_new_tokens=2)
scores = lvu.loglikelihood_multi("Which?", "clip.mp4", [" A", " B"])
assert len(scores) == 2 and all(np.isfinite(t) for t, _ in scores)
out = lvu.generate("q", "clip.mp4", max_new_tokens=3, do_sample=True, top_p=0.9,
                   on_tokens=lambda t: None)
assert len(lvu.last_result.tokens) >= 1
# the CLI and the server, with the frame cache and the on-device resize
import contextlib, io, json, threading, urllib.request
from quickvideo_tpu_torch import lvu_cli
from quickvideo_tpu_torch.serving import make_http_server, ServerConfig
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    assert lvu_cli.main([
        "--video_path", "clip.mp4", "--model_name_or_path", ckpt,
        "--model_type", "qwen25_lvu", "--dtype", "float32",
        "--num_frames", "8", "--video_group_size", "4",
        "--max_new_tokens", "2", "--decode_output", "yuv420",
        "--resize_on_device", "--save_video_cache",
        "--cache_dir", os.path.join(tmp, "frames"), "--device", "cpu",
        "--json"]) == 0
row = json.loads(buf.getvalue().splitlines()[-1])
assert row["tokens"] == 2 and os.listdir(os.path.join(tmp, "frames")), row
video = os.path.join(tmp, "clip.mp4")
open(video, "wb").close()
httpd, server = make_http_server(lvu, ServerConfig(port=0, spill_dir=tmp))
threading.Thread(target=httpd.serve_forever, daemon=True).start()
req = urllib.request.Request(
    f"http://127.0.0.1:{httpd.server_address[1]}/v1/generate",
    data=json.dumps({"video": video, "question": "q",
                     "max_new_tokens": 2}).encode(),
    headers={"Content-Type": "application/json"})
with urllib.request.urlopen(req) as resp:
    assert resp.status == 200 and "answer" in json.loads(resp.read())
httpd.shutdown()
server.shutdown()
assert not forbidden(), forbidden()
print("NOJAX_OK")
"""

TOP_LEVEL = FORBIDDEN + r"""
import sys
from quickvideo_tpu_torch import LVUConfig, LVULayerConfig, __version__
assert "quickvideo_tpu_torch.api" not in sys.modules
assert "torch" not in sys.modules
assert not forbidden(), forbidden()
import quickvideo_tpu_torch
from quickvideo_tpu_torch.api import LVU
assert quickvideo_tpu_torch.LVU is LVU
assert LVUConfig is quickvideo_tpu_torch.config.LVUConfig
import quickvideo_tpu_torch.serving
assert not forbidden(), forbidden()
print("NOJAX_OK")
"""

CLI_HELP = FORBIDDEN + r"""
import runpy, sys
sys.argv = ["lvu_cli", "--help"]
try:
    runpy.run_module("quickvideo_tpu_torch.lvu_cli", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
assert not forbidden(), forbidden()
print("NOJAX_OK")
"""

SMOKE = FORBIDDEN + r"""
import sys
sys.path.insert(0, ".")
import chip_smoke
from quickvideo_tpu_torch.tokenization import load_tokenizer
cfg = chip_smoke.narrow_config()
chip_smoke._kernel_counters()
chip_smoke.make_request(cfg, load_tokenizer("", cfg), "q", 0, n_frames=2,
                        group_frames=2)
assert not forbidden(), forbidden()
print("NOJAX_OK")
"""


def _run(args, cwd, **env_over):
    env = dict(os.environ, **env_over)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_port_slice_runs_without_importing_jax():
    proc = _run(["-c", SLICE], ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NOJAX_OK" in proc.stdout


def test_port_session_scoring_and_checkpoint_load_import_no_jax():
    proc = _run(["-c", SESSION], ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NOJAX_OK" in proc.stdout


def test_mesh_ranks_import_nothing_of_jax(tmp_path):
    """Each rank of a gloo mesh (tp = 2 and sp = 2 on the tiny preset's
    deterministic weights, through the CLI: LVU's process-group init, sharded
    init, the tp and sp routes, parallel/*) holds no jax and no
    quickvideo_tpu module at its end; the parallel modules import alone
    without either."""
    from torch_mesh_ranks import run_ranks

    argv = ["--model_name_or_path", "tiny", "--dtype", "float32",
            "--num_frames", "8", "--video_group_size", "4",
            "--max_new_tokens", "2", "--decode_output", "yuv420",
            "--video_path", "clip.mp4", "--json", "--device", "cpu",
            "--mesh", "1,1,2,2"]
    ranks = run_ranks(tmp_path, "cli", 4, argv=argv)
    assert [r["forbidden"] for r in ranks] == [[]] * 4
    assert [r["rc"] for r in ranks] == [0] * 4
    proc = _run(["-c", FORBIDDEN + PARALLEL], ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NOJAX_OK" in proc.stdout


PARALLEL = r"""
import quickvideo_tpu_torch.parallel.mesh
import quickvideo_tpu_torch.parallel.comm
import quickvideo_tpu_torch.parallel.sharding
import quickvideo_tpu_torch.parallel.context_parallel
import quickvideo_tpu_torch.models.qwen25_vl.load
assert not forbidden(), forbidden()
print("NOJAX_OK")
"""


FULL_FORWARD = r"""
import numpy as np, torch
torch.set_num_threads(1)
from quickvideo_tpu_torch.models.qwen25_vl.config import get_config
from quickvideo_tpu_torch.models.qwen25_vl.convert import init_params
from quickvideo_tpu_torch.models.qwen25_vl.load import params_from_torch_model
from quickvideo_tpu_torch.models.qwen25_vl.model import forward_full_sequence
from quickvideo_tpu_torch.testing import hf_state_dict
from quickvideo_tpu_torch.utils.timing import SpanTimer
cfg = get_config("tiny")
params = init_params(cfg, 0, torch.float32)
ids = np.concatenate([[5, 6, cfg.vision_start_token_id],
                      np.full(2 * 8 * 8, cfg.video_token_id),
                      [cfg.vision_end_token_id, 7]]).astype(np.int64)
pixels = np.random.default_rng(0).standard_normal(
    (2 * 16 * 16, cfg.vision.patch_input_dim)).astype(np.float32)
logits = forward_full_sequence(params, cfg, ids, pixels,
                               np.array([(2, 16, 16)]), [2.0])
assert logits.shape == (len(ids), cfg.text.vocab_size)
state = hf_state_dict(params, cfg)
module = torch.nn.Module()
module.state_dict = lambda: state
again = params_from_torch_model(module, cfg, torch.float32)
assert torch.equal(again["language"]["layers"][0]["wq"],
                   params["language"]["layers"][0]["wq"])
timer = SpanTimer()
timer.add("vision", 0.5)
assert timer.report() == "vision: 0.50s (n=1)"
assert not forbidden(), forbidden()
print("NOJAX_OK")
"""


def test_mesh_server_and_the_model_functions_import_nothing_of_jax(
        tmp_path):
    """The HTTP server on a tp = 2 gloo mesh (tests/torch_mesh_ranks.py::
    case_serve on the preset's weights: the leader serves the script, the
    follower runs its jobs) holds no jax and no quickvideo_tpu module on
    either rank at its end; forward_full_sequence, params_from_torch_model
    and SpanTimer.report run in a fresh interpreter without either."""
    from torch_mesh_ranks import run_ranks

    video = tmp_path / "clip.mp4"
    video.write_bytes(b"")
    ranks = run_ranks(
        tmp_path, "serve", 2, video=str(video), spill=str(tmp_path / "spill"),
        lvu=dict(model_name_or_path="tiny", model_type="qwen25_lvu",
                 num_frames=8, video_group_size=4, top_p=0.5,
                 max_decode_tokens=8, decode_output="yuv420",
                 dtype="float32", mesh={"tp": 2}),
        control_timeout_s=60.0, heartbeat_s=1.0, idle_s=0.0)
    assert [r["role"] for r in ranks] == ["leader", "follower"]
    assert [r["forbidden"] for r in ranks] == [[]] * 2
    proc = _run(["-c", FORBIDDEN + FULL_FORWARD], ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NOJAX_OK" in proc.stdout


def test_top_level_names_import_nothing_of_jax_nor_the_model():
    """`from quickvideo_tpu_torch import LVUConfig` (ROADMAP C17) imports
    neither the model stack nor jax; `quickvideo_tpu_torch.LVU` resolves
    lazily to api.LVU; importing the serving package imports no jax."""
    proc = _run(["-c", TOP_LEVEL], ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NOJAX_OK" in proc.stdout


def test_cli_help_imports_nothing_of_jax():
    proc = _run(["-c", CLI_HELP], ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NOJAX_OK" in proc.stdout and "--device" in proc.stdout
    proc = _run(["-m", "quickvideo_tpu_torch.lvu_cli", "--help"], ROOT)
    assert proc.returncode == 0 and "--resize_on_device" in proc.stdout


def test_chip_smoke_imports_nothing_of_jax():
    """chip_smoke imported as a module, with the helpers that import the
    port run; and every import statement in it, its phases' lazy ones
    included, names jax-free modules outside the JAX package."""
    import ast

    proc = _run(["-c", SMOKE], ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NOJAX_OK" in proc.stdout
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert any(m.startswith("quickvideo_tpu_torch") for m in names)
    bad = [m for m in names
           if m.split(".")[0] in ("jax", "quickvideo_tpu", "safetensors")]
    assert not bad, bad


PRESET = FORBIDDEN + r"""
import torch
torch.set_num_threads(1)
from quickvideo_tpu_torch.config import LVUConfig
from quickvideo_tpu_torch.api import LVU
from quickvideo_tpu_torch.models.qwen25_vl.config import get_config
from quickvideo_tpu_torch.models.qwen25_vl.convert import (
    init_params_fast, init_params_fast_quantized)
for param_dtype, make in (("bfloat16", init_params_fast),
                          ("int8", init_params_fast_quantized)):
    lvu = LVU(LVUConfig(model_name_or_path="tiny", dtype="float32",
                        param_dtype=param_dtype, seed=7), device="cpu")
    want = make(get_config("tiny"), torch.float32)["language"]
    got = lvu.params["language"]
    for key in ("embed", "lm_head"):
        a, b = got[key], want[key]
        if isinstance(b, dict):
            a, b = a["q8"], b["q8"]
        assert torch.equal(a, b), (param_dtype, key)
assert not forbidden(), forbidden()
print("NOJAX_OK")
"""


def test_preset_weights_are_the_fast_init_and_import_no_jax():
    """LVU on a preset name without params (float and int8 weights) holds
    init_params_fast's / init_params_fast_quantized's leaves, whatever
    the seed, and imports no jax and no quickvideo_tpu module."""
    proc = _run(["-c", PRESET], ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NOJAX_OK" in proc.stdout


TRACING = FORBIDDEN + r"""
import glob, os, sys
import torch
from quickvideo_tpu_torch.utils.tracing import annotate, maybe_trace
out = sys.argv[1]
with maybe_trace(None if sys.argv[2] == "env" else out
                 if sys.argv[2] == "argument" else None) as path:
    with annotate("qv_fast_init_span"):
        torch.ones(8).sum()
files = glob.glob(os.path.join(out, "*"))
if sys.argv[2] == "neither":
    assert path is None and files == [], (path, files)
else:
    assert files == [path], (path, files)
    with open(path) as f:
        assert "qv_fast_init_span" in f.read()
assert not forbidden(), forbidden()
print("NOJAX_OK")
"""


@pytest.mark.parametrize("given", ["argument", "env", "neither"])
def test_tracing_writes_a_trace_only_when_asked(tmp_path, given):
    """utils/tracing.py: maybe_trace with a directory (or QV_TRACE_DIR)
    writes one trace holding the annotate span's name; with neither it
    writes nothing. No jax is imported."""
    out = tmp_path / "trace"
    out.mkdir()
    proc = _run(["-c", TRACING, str(out), given], ROOT,
                QV_TRACE_DIR=str(out) if given == "env" else "")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NOJAX_OK" in proc.stdout


def _no_result(proc):
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


def test_chip_smoke_fails_without_cuda():
    # no visible card, also where the test machine has one
    proc = _run(
        [os.path.join(ROOT, "chip_smoke.py")], ROOT, CUDA_VISIBLE_DEVICES=""
    )
    _no_result(proc)
    assert "cuda" in proc.stderr.lower()


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    proc = _run([str(tmp_path / "chip_smoke.py")], str(tmp_path))
    _no_result(proc)
