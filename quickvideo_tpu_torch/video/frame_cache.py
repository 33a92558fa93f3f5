"""Preprocessed-video disk cache.

The port's copy of quickvideo_tpu/video/frame_cache.py (the port imports
nothing of the JAX package); tests/test_torch_copies.py pins it to the
original, and either package reads the other's entries.

First-class, correct version of the reference's frame cache (reference
lvu/models/qwen25_lvu.py:552-592: per-frame JPEGs + a .pt metadata file under
~/.cache/video_cache/qwen25_vl, keyed by video stem + sampling params; the
reference's interleaved-engine copy of this path is dead/buggy code —
SURVEY.md section 5.9 — which this module supersedes).

Stored artifacts per key:
  frames.npy   — decoded+resized frames, TCHW uint8 (single mmap-able file
                 instead of thousands of JPEGs: no re-encode loss, O(1) open)
  meta.json    — plan parameters (indices, grid, fps, resize) for validation
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from quickvideo_tpu_torch.video.preprocess import VideoPlan


def default_cache_dir() -> Path:
    return Path(
        os.environ.get(
            "QV_VIDEO_CACHE", "~/.cache/video_cache/quickvideo_tpu"
        )
    ).expanduser()


def cache_key(
    video_path: str, plan: VideoPlan, native_hw=None
) -> str:
    """Stem + sampling/resize params (reference key scheme,
    lvu/models/qwen25_vl.py:365-369) + an index hash for exactness.
    `native_hw` set = frames stored at decoder-native size
    (resize_on_device), a distinct artifact from the resized frames."""
    stem = Path(video_path).stem
    h = hashlib.md5(
        json.dumps(
            {
                "n": plan.nframes,
                "h": plan.resized_height,
                "w": plan.resized_width,
                "native": list(native_hw) if native_hw else None,
                "idx0": int(plan.indices[0]),
                "idxN": int(plan.indices[-1]),
                "len": len(plan.indices),
            },
            sort_keys=True,
        ).encode()
    ).hexdigest()[:10]
    hw = native_hw or (plan.resized_height, plan.resized_width)
    return f"{stem}_n={plan.nframes}_hw={hw[0]}x{hw[1]}_{h}"


def save(video_path: str, plan: VideoPlan, frames: np.ndarray,
         cache_dir: Optional[str] = None, native_hw=None) -> Path:
    d = Path(cache_dir).expanduser() if cache_dir else default_cache_dir()
    d = d / cache_key(video_path, plan, native_hw)
    d.mkdir(parents=True, exist_ok=True)
    np.save(d / "frames.npy", frames)
    (d / "meta.json").write_text(json.dumps({
        "video": str(video_path),
        "nframes": plan.nframes,
        "resized_height": plan.resized_height,
        "resized_width": plan.resized_width,
        "sample_fps": plan.sample_fps,
        "second_per_grid_ts": plan.second_per_grid_ts,
        "indices": plan.indices.tolist(),
    }))
    return d


def load(video_path: str, plan: VideoPlan,
         cache_dir: Optional[str] = None,
         native_hw=None) -> Optional[np.ndarray]:
    d = Path(cache_dir).expanduser() if cache_dir else default_cache_dir()
    d = d / cache_key(video_path, plan, native_hw)
    f = d / "frames.npy"
    if not f.exists():
        return None
    frames = np.load(f, mmap_mode="r")
    h, w = native_hw or (plan.resized_height, plan.resized_width)
    rgb_shape = (plan.nframes, 3, h, w)
    yuv_shape = (plan.nframes, h * w * 3 // 2)
    if frames.shape not in (rgb_shape, yuv_shape):
        return None  # stale entry
    return frames
