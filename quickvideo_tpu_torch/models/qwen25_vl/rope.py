"""Multimodal 3D RoPE (mRoPE) for Qwen2.5-VL.

`get_rope_index`, `precompute_mrope_cos_sin` and `text_positions` are numpy
helpers copied from quickvideo_tpu/models/qwen25_vl/rope.py (that module
imports jax, so the port cannot import it); tests pin copy == original.
`mrope_cos_sin` builds the merged tables on the device, and `apply_rotary`
applies them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from quickvideo_tpu_torch.utils import timing


def get_rope_index(
    input_ids: np.ndarray,  # (L,) int — single sequence, no padding
    *,
    spatial_merge_size: int,
    image_token_id: int,
    video_token_id: int,
    vision_start_token_id: int,
    tokens_per_second: float,
    image_grid_thw: Optional[np.ndarray] = None,  # (n_img, 3)
    video_grid_thw: Optional[np.ndarray] = None,  # (n_vid, 3)
    second_per_grid_ts: Optional[Sequence[float]] = None,  # (n_vid,)
) -> Tuple[np.ndarray, int]:
    """3D rope positions for one packed sequence.

    Text tokens advance all three axes together; vision blocks get
    (temporal = grid_t scaled by second_per_grid * tokens_per_second,
    height, width) positions offset so each modality block starts right after
    the max position of everything before it. Returns ((3, L) int64, delta)
    where delta = max_pos + 1 - L (HF `rope_deltas`).
    """
    input_ids = np.asarray(input_ids)
    L = input_ids.shape[0]
    if image_grid_thw is None and video_grid_thw is None:
        pos = np.arange(L, dtype=np.int64)
        return np.stack([pos, pos, pos]), 0

    vis_starts = np.nonzero(input_ids == vision_start_token_id)[0]
    vis_kinds = input_ids[vis_starts + 1] if len(vis_starts) else np.array([])
    n_images = int(np.sum(vis_kinds == image_token_id))
    n_videos = int(np.sum(vis_kinds == video_token_id))

    tokens = input_ids.tolist()
    pos_chunks: List[np.ndarray] = []
    st = 0
    img_i = vid_i = 0
    remain_images, remain_videos = n_images, n_videos
    for _ in range(n_images + n_videos):
        ed_image = tokens.index(image_token_id, st) if (
            image_token_id in tokens[st:] and remain_images > 0
        ) else L + 1
        ed_video = tokens.index(video_token_id, st) if (
            video_token_id in tokens[st:] and remain_videos > 0
        ) else L + 1
        if ed_image < ed_video:
            t, h, w = (int(x) for x in image_grid_thw[img_i])
            second_per_grid_t = 0.0
            img_i += 1
            remain_images -= 1
            ed = ed_image
        else:
            t, h, w = (int(x) for x in video_grid_thw[vid_i])
            second_per_grid_t = (
                float(second_per_grid_ts[vid_i])
                if second_per_grid_ts is not None
                else 1.0
            )
            vid_i += 1
            remain_videos -= 1
            ed = ed_video
        gh, gw = h // spatial_merge_size, w // spatial_merge_size
        text_len = ed - st
        st_idx = int(pos_chunks[-1].max()) + 1 if pos_chunks else 0
        if text_len > 0:
            r = np.arange(text_len, dtype=np.int64) + st_idx
            pos_chunks.append(np.stack([r, r, r]))
        t_index = (
            (np.arange(t, dtype=np.float64)[:, None] * second_per_grid_t
             * tokens_per_second)
            .astype(np.int64)
            .repeat(gh * gw, axis=1)
            .reshape(-1)
        )
        h_index = np.tile(np.repeat(np.arange(gh, dtype=np.int64), gw), t)
        w_index = np.tile(np.arange(gw, dtype=np.int64), t * gh)
        pos_chunks.append(
            np.stack([t_index, h_index, w_index]) + text_len + st_idx
        )
        st = ed + t * gh * gw
    if st < L:
        st_idx = int(pos_chunks[-1].max()) + 1 if pos_chunks else 0
        r = np.arange(L - st, dtype=np.int64) + st_idx
        pos_chunks.append(np.stack([r, r, r]))
    positions = np.concatenate(pos_chunks, axis=1)
    assert positions.shape == (3, L), (positions.shape, L)
    delta = int(positions.max()) + 1 - L
    return positions, delta


def precompute_mrope_cos_sin(
    positions: np.ndarray,  # (3, L) int
    head_dim: int,
    mrope_section: Sequence[int],
    rope_theta: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Merged rotary tables (L, head_dim) float32, computed on the host in
    float64. The first half of head_dim is laid out as [t-sec, h-sec, w-sec]
    frequencies and the second half repeats it (HF's doubled sections)."""
    half = head_dim // 2
    assert sum(mrope_section) == half, (mrope_section, head_dim)
    inv_freq = 1.0 / (
        rope_theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim)
    )  # (half,)
    L = positions.shape[1]
    merged_half = np.empty((L, half), np.float64)
    off = 0
    for i, m in enumerate(mrope_section):
        axis = i % 3
        merged_half[:, off : off + m] = (
            positions[axis, :, None].astype(np.float64)
            * inv_freq[None, off : off + m]
        )
        off += m
    emb = np.concatenate([merged_half, merged_half], axis=-1)  # (L, head_dim)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


def text_positions(start: int, length: int) -> np.ndarray:
    """(3, length) positions for a pure-text continuation starting at
    `start` (used for decode: start = global_len + rope_delta)."""
    r = np.arange(start, start + length, dtype=np.int64)
    return np.stack([r, r, r])


def mrope_cos_sin(
    positions: np.ndarray,  # (3, L) int
    head_dim: int,
    mrope_section: Sequence[int],
    rope_theta: float,
    device,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merged (L, head_dim) f32 tables built ON the device from the (3, L)
    positions (only the positions cross to the device). f32 arithmetic, like
    the JAX package's precompute_mrope_cos_sin_device."""
    with timing.host_wait():  # a copy from pageable host memory
        pos = torch.as_tensor(np.asarray(positions), device=device).float()
    inv_freq = 1.0 / (
        rope_theta
        ** (torch.arange(0, head_dim, 2, device=device).float() / head_dim)
    )
    parts = []
    off = 0
    for i, m in enumerate(mrope_section):
        parts.append(pos[i % 3, :, None] * inv_freq[None, off : off + m])
        off += m
    merged = torch.cat(parts, dim=-1)  # (L, head_dim / 2)
    emb = torch.cat([merged, merged], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary(q, k, cos, sin):
    """q (Hq, L, D), k (Hkv, L, D); cos/sin (L, D) f32. Rotates in f32 and
    casts back to the input dtype (HF numerics)."""
    c = cos[None].float()
    s = sin[None].float()
    qf = q.float()
    kf = k.float()
    q_out = qf * c + rotate_half(qf) * s
    k_out = kf * c + rotate_half(kf) * s
    return q_out.to(q.dtype), k_out.to(k.dtype)
