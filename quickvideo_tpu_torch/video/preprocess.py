"""Frame sampling, resize policy, normalization and patchify.

The port's copy of quickvideo_tpu/video/preprocess.py (the port imports nothing of the JAX
package); tests/test_torch_copies.py pins it to the original.

Behavioral parity with the reference's qwen_vl_utils-based preprocessing as
patched by the reference engines:

  * `smart_nframes` — frame-count policy with the reference's raised cap
    FPS_MAX_FRAMES = 100_000 (reference lvu/models/qwen25_lvu.py:27, the
    enabler for hour-long 1-fps videos; upstream caps at 768).
  * `smart_resize` — factor-28 rounding with pixel budget (qwen_vl_utils
    semantics, engaged at reference lvu/models/qwen25_lvu.py:301-310).
  * `video_pixel_budget` — per-frame max_pixels from the total-pixel budget
    (reference lvu/models/qwen25_lvu.py:294-300).
  * `sample_indices` — linspace frame selection (reference :316).
  * `patchify_frames` — HF Qwen2VLImageProcessor patch layout: rescale 1/255,
    CLIP-mean/std normalize, then (t, h-unit, w-unit, merge, merge,
    C*tps*ps*ps) flatten — the merged-unit interleaved order the vision tower
    expects.

Everything here is host-side numpy; the TPU sees only the final
pixel_values arrays.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

# qwen_vl_utils constants (public upstream defaults; FPS_MAX_FRAMES carries
# the reference's override)
IMAGE_FACTOR = 28
MIN_PIXELS = 4 * 28 * 28
MAX_PIXELS = 16384 * 28 * 28
MAX_RATIO = 200
VIDEO_MIN_PIXELS = 128 * 28 * 28
VIDEO_MAX_PIXELS = 768 * 28 * 28
VIDEO_TOTAL_PIXELS = int(
    float(os.environ.get("VIDEO_MAX_PIXELS", 128000 * 28 * 28 * 0.9))
)
FRAME_FACTOR = 2
FPS = 2.0
FPS_MIN_FRAMES = 4
FPS_MAX_FRAMES = 100_000  # reference override (lvu/models/qwen25_lvu.py:27)

OPENAI_CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
OPENAI_CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def round_by_factor(x: float, factor: int) -> int:
    return round(x / factor) * factor


def ceil_by_factor(x: float, factor: int) -> int:
    return math.ceil(x / factor) * factor


def floor_by_factor(x: float, factor: int) -> int:
    return math.floor(x / factor) * factor


def smart_resize(
    height: int,
    width: int,
    factor: int = IMAGE_FACTOR,
    min_pixels: int = MIN_PIXELS,
    max_pixels: int = MAX_PIXELS,
) -> Tuple[int, int]:
    """Rescale (height, width) to multiples of `factor` within the pixel
    budget, preserving aspect ratio as closely as possible."""
    if max(height, width) / min(height, width) > MAX_RATIO:
        raise ValueError(
            f"aspect ratio must be < {MAX_RATIO}, got "
            f"{max(height, width) / min(height, width):.1f}"
        )
    h_bar = max(factor, round_by_factor(height, factor))
    w_bar = max(factor, round_by_factor(width, factor))
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, floor_by_factor(height / beta, factor))
        w_bar = max(factor, floor_by_factor(width / beta, factor))
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = ceil_by_factor(height * beta, factor)
        w_bar = ceil_by_factor(width * beta, factor)
    return h_bar, w_bar


def smart_nframes(
    *,
    total_frames: int,
    video_fps: float,
    nframes: Optional[int] = None,
    fps: Optional[float] = None,
    min_frames: int = FPS_MIN_FRAMES,
    max_frames: Optional[int] = None,
) -> int:
    """Number of frames to sample (reference lvu/models/qwen25_vl.py:211-250
    semantics, nframes takes precedence over fps)."""
    if nframes is not None and fps is not None:
        raise ValueError("Only accept either `fps` or `nframes`")
    if nframes is not None:
        n = round_by_factor(nframes, FRAME_FACTOR)
        n = min(n, total_frames)
        n -= n % FRAME_FACTOR
    else:
        fps = fps if fps is not None else FPS
        minf = ceil_by_factor(min_frames, FRAME_FACTOR)
        maxf = floor_by_factor(
            max_frames if max_frames is not None
            else min(FPS_MAX_FRAMES, total_frames),
            FRAME_FACTOR,
        )
        n = total_frames / video_fps * fps
        n = min(min(max(n, minf), maxf), total_frames)
        n = floor_by_factor(n, FRAME_FACTOR)
    if not (FRAME_FACTOR <= n <= total_frames):
        raise ValueError(
            f"nframes should be in [{FRAME_FACTOR}, {total_frames}], got {n}"
        )
    return int(n)


def video_pixel_budget(
    nframes: int,
    *,
    total_pixels: int = VIDEO_TOTAL_PIXELS,
    min_pixels: int = VIDEO_MIN_PIXELS,
    requested_max_pixels: Optional[int] = None,
) -> Tuple[int, int]:
    """(min_pixels, max_pixels) per frame (reference
    lvu/models/qwen25_lvu.py:294-300)."""
    max_pixels = max(
        min(VIDEO_MAX_PIXELS, total_pixels / nframes * FRAME_FACTOR),
        int(min_pixels * 1.05),
    )
    if requested_max_pixels is not None:
        max_pixels = min(requested_max_pixels, max_pixels)
    return int(min_pixels), int(max_pixels)


def sample_indices(total_frames: int, nframes: int) -> np.ndarray:
    """Evenly spaced frame indices (reference lvu/models/qwen25_lvu.py:316:
    torch.linspace(0, total-1, n).round().long())."""
    return np.round(np.linspace(0, total_frames - 1, nframes)).astype(np.int64)


def normalize_frames(frames: np.ndarray) -> np.ndarray:
    """uint8 (T, C, H, W) or (T, H, W, C) -> float32 normalized (T, C, H, W)."""
    f = np.asarray(frames)
    if f.ndim != 4:
        raise ValueError(f"expected 4D frames, got {f.shape}")
    if f.shape[-1] == 3 and f.shape[1] != 3:
        f = f.transpose(0, 3, 1, 2)
    f = f.astype(np.float32) / 255.0
    mean = OPENAI_CLIP_MEAN.reshape(1, 3, 1, 1)
    std = OPENAI_CLIP_STD.reshape(1, 3, 1, 1)
    return (f - mean) / std


def patchify_frames(
    frames: np.ndarray,  # normalized float32 (T, C, H, W), H/W multiples of 14
    patch_size: int = 14,
    temporal_patch_size: int = 2,
    merge_size: int = 2,
) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """HF Qwen2VL patch layout -> (grid_t*grid_h*grid_w, C*tps*ps*ps),
    (grid_t, grid_h, grid_w). Odd frame counts repeat the last frame."""
    t, c, h, w = frames.shape
    if t % temporal_patch_size != 0:
        pad = temporal_patch_size - t % temporal_patch_size
        frames = np.concatenate(
            [frames, np.repeat(frames[-1:], pad, axis=0)], axis=0
        )
        t = frames.shape[0]
    grid_t = t // temporal_patch_size
    grid_h, grid_w = h // patch_size, w // patch_size
    p = frames.reshape(
        grid_t,
        temporal_patch_size,
        c,
        grid_h // merge_size,
        merge_size,
        patch_size,
        grid_w // merge_size,
        merge_size,
        patch_size,
    )
    p = p.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    flat = p.reshape(
        grid_t * grid_h * grid_w, c * temporal_patch_size * patch_size ** 2
    )
    return np.ascontiguousarray(flat), (grid_t, grid_h, grid_w)


def patchify_frames_uint8(
    frames: np.ndarray,  # uint8 (T, C, H, W)
    patch_size: int = 14,
    temporal_patch_size: int = 2,
    merge_size: int = 2,
) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """uint8 patchify WITHOUT normalization — rescale/normalize run on the
    TPU instead (see patch_norm_scale_bias / vision_forward). 4x less host
    work and 4x less host->device traffic than the float path; the numbers
    are identical because normalize is a per-channel affine op."""
    f = np.asarray(frames)
    if f.dtype != np.uint8:
        raise ValueError(f"expected uint8 frames, got {f.dtype}")
    t, c, h, w = f.shape
    if t % temporal_patch_size != 0:
        pad = temporal_patch_size - t % temporal_patch_size
        f = np.concatenate([f, np.repeat(f[-1:], pad, axis=0)], axis=0)
        t = f.shape[0]
    grid_t = t // temporal_patch_size
    grid_h, grid_w = h // patch_size, w // patch_size
    p = f.reshape(
        grid_t, temporal_patch_size, c,
        grid_h // merge_size, merge_size, patch_size,
        grid_w // merge_size, merge_size, patch_size,
    ).transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    flat = p.reshape(
        grid_t * grid_h * grid_w, c * temporal_patch_size * patch_size ** 2
    )
    return np.ascontiguousarray(flat), (grid_t, grid_h, grid_w)


def patch_norm_scale_bias(
    patch_size: int = 14, temporal_patch_size: int = 2, in_channels: int = 3
) -> Tuple[np.ndarray, np.ndarray]:
    """(patch_input_dim,) f32 scale/bias implementing rescale(1/255) +
    CLIP-mean/std normalize for uint8 patches: x_norm = u8 * scale + bias.
    Within each flattened patch the layout is (C, tps, ps, ps), so channel c
    spans a contiguous tps*ps*ps block."""
    block = temporal_patch_size * patch_size ** 2
    scale = np.empty(in_channels * block, np.float32)
    bias = np.empty(in_channels * block, np.float32)
    for ch in range(in_channels):
        scale[ch * block : (ch + 1) * block] = 1.0 / (
            255.0 * OPENAI_CLIP_STD[ch]
        )
        bias[ch * block : (ch + 1) * block] = (
            -OPENAI_CLIP_MEAN[ch] / OPENAI_CLIP_STD[ch]
        )
    return scale, bias


def yuv420_frame_bytes(height: int, width: int) -> int:
    return height * width * 3 // 2


def resize_frames_bicubic(frames: np.ndarray, height: int, width: int) -> np.ndarray:
    """Fallback resize when the native decoder didn't resize in-loop
    (reference fallback uses torchvision BICUBIC,
    lvu/models/qwen25_lvu.py:377-382). Uses PIL (antialias) per frame."""
    from PIL import Image

    f = np.asarray(frames)
    if f.shape[1] == 3 and f.shape[-1] != 3:
        f = f.transpose(0, 2, 3, 1)
    out = np.empty((f.shape[0], height, width, 3), np.uint8)
    for i in range(f.shape[0]):
        out[i] = np.asarray(
            Image.fromarray(f[i]).resize((width, height), Image.BICUBIC)
        )
    return out.transpose(0, 3, 1, 2)


@dataclass
class VideoPlan:
    """Full host-side plan for one video: sampling, resize, grouping."""

    nframes: int
    indices: np.ndarray
    resized_height: int
    resized_width: int
    sample_fps: float
    second_per_grid_ts: float
    group_frame_counts: List[int]
    group_grids: List[Tuple[int, int, int]]

    @property
    def grid_thw(self) -> Tuple[int, int, int]:
        t = sum(g[0] for g in self.group_grids)
        return (t, self.group_grids[0][1], self.group_grids[0][2])

    @property
    def tokens_per_group(self) -> List[int]:
        return [
            t * (h // 2) * (w // 2) for (t, h, w) in self.group_grids
        ]


def plan_video(
    *,
    total_frames: int,
    video_fps: float,
    height: int,
    width: int,
    video_group_size: Optional[int],
    nframes: Optional[int] = None,
    fps: Optional[float] = None,
    requested_max_pixels: Optional[int] = None,
    temporal_patch_size: int = 2,
    factor: int = IMAGE_FACTOR,
    align_to: Optional[int] = None,  # snap resized dims down to multiples
) -> VideoPlan:
    """Build the decode/resize/grouping plan (mirrors the combined logic of
    reference fetch_video + group split, lvu/models/qwen25_lvu.py:267-325 and
    qwen25_vl.py:428-452)."""
    n = smart_nframes(
        total_frames=total_frames, video_fps=video_fps, nframes=nframes,
        fps=fps,
    )
    min_px, max_px = video_pixel_budget(
        n, requested_max_pixels=requested_max_pixels
    )
    rh, rw = smart_resize(
        height, width, factor=factor, min_pixels=min_px, max_pixels=max_px
    )
    if align_to:
        rh = max(align_to, rh - rh % align_to)
        rw = max(align_to, rw - rw % align_to)
    idx = sample_indices(total_frames, n)
    sample_fps = n / max(total_frames, 1e-6) * video_fps
    second_per_grid_ts = temporal_patch_size / max(sample_fps, 1e-6)

    # group split in frames (reference qwen25_vl.py:428-434: round UP to a
    # multiple of temporal_patch_size; group 0 may also carry prompt tokens
    # but that is engine-side)
    gsz = video_group_size
    if gsz is not None and gsz > 0:
        if gsz % temporal_patch_size != 0:
            gsz += temporal_patch_size - (gsz % temporal_patch_size)
        counts = [
            min(gsz, n - off) for off in range(0, n, gsz)
        ]
    else:
        counts = [n]
    grids = []
    gh, gw = rh // 14, rw // 14
    for cnt in counts:
        t_g = (cnt - 1) // temporal_patch_size + 1
        grids.append((t_g, gh, gw))
    return VideoPlan(
        nframes=n,
        indices=idx,
        resized_height=rh,
        resized_width=rw,
        sample_fps=sample_fps,
        second_per_grid_ts=second_per_grid_ts,
        group_frame_counts=counts,
        group_grids=grids,
    )
