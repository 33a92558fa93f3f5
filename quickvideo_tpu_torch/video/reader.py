"""Video reader backend registry + request building.

The port's copy of quickvideo_tpu/video/reader.py (the port imports nothing of the JAX
package); tests/test_torch_copies.py pins it to the original.

Mirrors the reference's backend selection contract
(lvu/models/qwen25_lvu.py:247-265): priority FORCE_QWENVL_VIDEO_READER env >
quickdecode (the native engine, deepcodec-equivalent) > registered fallbacks,
with DEEPCODEC_DISABLED disabling the native engine. On backend exception the
next backend in the chain is tried (reference fallback behavior, :344-348).

Also hosts the high-level `build_prefill_inputs` / `stream_prefill_inputs`
that turn (video path, question token layout, LVUConfig) into engine-ready
PrefillInputs — the TPU equivalents of the reference's fetch_video +
processor + group-split pipeline (sync: qwen25_lvu.py; streaming:
qwen25_lvu_interleaved.py).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from quickvideo_tpu_torch.config import LVUConfig
from quickvideo_tpu_torch.video import preprocess as pp
from quickvideo_tpu_torch.video import quickdecode as qd

# backend name -> factory(path, num_threads) returning a VideoReader-like
# object (len, get_fps, height/width/interpolation, get_batch)
_BACKENDS: Dict[str, Callable] = {}


def register_backend(name: str, factory: Callable):
    _BACKENDS[name] = factory


register_backend(
    "quickdecode", lambda path, threads: qd.VideoReader(path, num_threads=threads)
)
# alias so reference-style env values keep working
register_backend(
    "deepcodec", lambda path, threads: qd.VideoReader(path, num_threads=threads)
)


def _cv2_factory(path, threads):
    from quickvideo_tpu_torch.video.cv2_reader import Cv2VideoReader

    return Cv2VideoReader(path, num_threads=threads)


# the decord/torchvision-equivalent degradation path (reference
# qwen25_lvu.py:215-265): sequential OpenCV decode when the native engine is
# disabled/unavailable or fails mid-request. find_spec probes availability
# without paying the cv2 import at module-import time (the factory imports
# lazily on first fallback use).
import importlib.util as _ilu

if _ilu.find_spec("cv2") is not None:
    register_backend("opencv", _cv2_factory)


def backend_priority() -> List[str]:
    forced = os.environ.get("FORCE_QWENVL_VIDEO_READER")
    if forced:
        return [forced]
    names = []
    if qd.is_available():
        names.append("quickdecode")
    names.extend(n for n in _BACKENDS if n not in ("quickdecode", "deepcodec"))
    if not names:
        raise RuntimeError(
            "no video backend available (build cpp/quickdecode or register one)"
        )
    return names


def _resolve_threads(num_threads: Optional[int]) -> int:
    if num_threads is None:
        return int(os.environ.get("QUICKCODEC_CORES", "8"))
    return num_threads


def open_reader(path: str, num_threads: Optional[int] = None):
    num_threads = _resolve_threads(num_threads)
    errors = []
    for name in backend_priority():
        try:
            return name, _BACKENDS[name](path, num_threads)
        except Exception as e:  # noqa: BLE001 — fallback chain by design
            errors.append(f"{name}: {e}")
    raise IOError(f"all video backends failed for {path}: {errors}")


def plan_from_reader(reader, lvu: LVUConfig) -> pp.VideoPlan:
    extra = lvu.extra_kwargs or {}
    return pp.plan_video(
        total_frames=len(reader),
        video_fps=reader.get_fps(),
        height=reader.source_height,
        width=reader.source_width,
        video_group_size=lvu.video_group_size,
        nframes=None if lvu.fps is not None else lvu.num_frames,
        fps=lvu.fps,
        requested_max_pixels=extra.get("max_pixels", 360 * 420),
        align_to=112 if lvu.align_resize_to_window else None,
    )


def decode_video_batch(
    path: str, lvu: LVUConfig
) -> Tuple[np.ndarray, pp.VideoPlan, Optional[Tuple[int, int]]]:
    """Sync decode of all sampled frames with in-decoder resize ->
    (frames TCHW uint8, plan, native_hw). The qwen25_lvu engine path.

    The fallback chain covers the WHOLE decode, not just construction: a
    backend that opens a file but fails during get_batch (corrupt tail,
    unsupported feature mid-stream) falls through to the next backend, the
    reference's on-exception behavior (qwen25_lvu.py:344-348)."""
    num_threads = _resolve_threads(lvu.decode_threads)
    errors = []
    for name in backend_priority():
        reader = None
        try:
            reader = _BACKENDS[name](path, num_threads)
            plan = plan_from_reader(reader, lvu)
            native_hw = None
            if lvu.resize_on_device and hasattr(reader, "source_height"):
                # decode at native size; the vision program resamples on
                # device
                native_hw = (reader.source_height, reader.source_width)
            else:
                reader.height = plan.resized_height
                reader.width = plan.resized_width
                if hasattr(reader, "interpolation"):
                    reader.interpolation = "LANCZOS"
            if lvu.decode_output.lower() == "yuv420" and hasattr(
                reader, "output_format"
            ):
                reader.output_format = "YUV420"
            frames = reader.get_batch(plan.indices.tolist())
            reader.close()
            return frames, plan, native_hw
        except Exception as e:  # noqa: BLE001 — fallback chain by design
            errors.append(f"{name}: {e}")
            if reader is not None:
                try:
                    reader.close()
                except Exception:  # noqa: BLE001 — already failing
                    pass
    raise IOError(f"all video backends failed for {path}: {errors}")


def build_prefill_inputs_from_frames(
    frames: np.ndarray,  # (T, C, H, W) uint8 resized (or native w/ native_hw)
    plan: pp.VideoPlan,
    input_ids: np.ndarray,
    native_hw: Optional[Tuple[int, int]] = None,
):
    """Patchify per group -> PrefillInputs (sync list form)."""
    from quickvideo_tpu_torch.prefill.engine import PrefillInputs

    # raw uint8 frame blocks; patchify+normalize run on-device in the vision
    # program (host stays out of the per-pixel pipeline)
    groups = []
    off = 0
    for cnt in plan.group_frame_counts:
        groups.append(np.ascontiguousarray(frames[off : off + cnt]))
        off += cnt
    return PrefillInputs(
        input_ids=input_ids,
        video_grid_thw=plan.grid_thw,
        pixel_groups=groups,
        group_grids=plan.group_grids,
        second_per_grid_ts=plan.second_per_grid_ts,
        native_hw=native_hw,
    )
