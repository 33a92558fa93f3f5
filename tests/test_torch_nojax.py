"""Process-level checks of the PyTorch port: neither the port (its video,
int8, pruning-mode and image requests; a chat session saved and resumed,
continuation scoring, a checkpoint load) nor chip_smoke.py imports jax or
any module of the JAX package (quickvideo_tpu), and the port never needs
the safetensors package,
and chip_smoke.py refuses to report a result without a CUDA card or outside
a checkout. Each needs a fresh interpreter (tests/conftest.py imports jax
into every test process), so they run subprocesses."""

import os
import shutil
import subprocess
import sys

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
        n = self.height * self.width * 3 // 2
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


def decode_video_batch(path, cfg):
    r = Reader(path)
    plan = vreader.plan_from_reader(r, cfg)
    r.height, r.width = plan.resized_height, plan.resized_width
    r.process(plan.indices.tolist())
    return r._frames, plan, None


qd.InterleavedVideoReader = Reader
vreader.decode_video_batch = decode_video_batch
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
