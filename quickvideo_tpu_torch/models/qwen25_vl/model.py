"""Qwen2.5-VL assembled model glue: vision encode, embedding scatter, mRoPE.

Counterpart of quickvideo_tpu/models/qwen25_vl/model.py.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from quickvideo_tpu_torch.models.qwen25_vl.config import ModelConfig
from quickvideo_tpu_torch.models.qwen25_vl import rope
from quickvideo_tpu_torch.models.qwen25_vl.language import (
    embed_tokens,
    full_forward_logits,
)
from quickvideo_tpu_torch.models.qwen25_vl.vision import (
    build_layout,
    vision_forward,
)


def layout_for(cfg: ModelConfig, grid_thw: Tuple[int, int, int]):
    return build_layout(
        tuple(int(x) for x in grid_thw),
        cfg.vision.patch_size,
        cfg.vision.spatial_merge_size,
        cfg.vision.window_size,
        cfg.vision.head_dim,
    )


def encode_video_group(
    params: dict,
    cfg: ModelConfig,
    pixels: torch.Tensor,
    grid_thw: Tuple[int, int, int],
    lt: Optional[dict] = None,  # vision.layout_tensors of this grid
    native_hw: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Vision tower over one video group -> (S / merge_unit, text_hidden).
    `native_hw` set: the frames arrive at that source size and are resized
    to the grid on the device."""
    return vision_forward(
        params["vision"], pixels, layout_for(cfg, grid_thw), cfg.vision, lt,
        native_hw=native_hw,
    )


def merge_vision_embeddings(
    text_embeds: torch.Tensor,  # (L, C)
    vision_embeds: torch.Tensor,  # (n_vis, C)
    token_ids: torch.Tensor,  # (L,) on the same device
    video_token_id: int,
) -> torch.Tensor:
    """Fill the video-token slots with vision features in order (HF
    masked_scatter semantics), without a host round trip: slot j takes
    vision row (rank of j among the placeholders)."""
    is_vis = token_ids == video_token_id
    rank = torch.cumsum(is_vis.to(torch.int64), dim=0) - 1
    rank = rank.clamp(0, vision_embeds.shape[0] - 1)
    gathered = vision_embeds.index_select(0, rank).to(text_embeds.dtype)
    return torch.where(is_vis[:, None], gathered, text_embeds)


def rope_index_for(
    cfg: ModelConfig,
    input_ids: np.ndarray,
    video_grid_thw: Optional[np.ndarray] = None,
    image_grid_thw: Optional[np.ndarray] = None,
    second_per_grid_ts: Optional[Sequence[float]] = None,
):
    """Host-side mRoPE positions for a packed sequence."""
    return rope.get_rope_index(
        input_ids,
        spatial_merge_size=cfg.vision.spatial_merge_size,
        image_token_id=cfg.image_token_id,
        video_token_id=cfg.video_token_id,
        vision_start_token_id=cfg.vision_start_token_id,
        tokens_per_second=cfg.vision.tokens_per_second,
        image_grid_thw=image_grid_thw,
        video_grid_thw=video_grid_thw,
        second_per_grid_ts=second_per_grid_ts,
    )


def mrope_tables(
    cfg: ModelConfig, positions: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Host (numpy, float64-computed) merged rotary tables."""
    return rope.precompute_mrope_cos_sin(
        positions,
        cfg.text.head_dim,
        cfg.text.mrope_section,
        cfg.text.rope_theta,
    )


def forward_full_sequence(
    params: dict,
    cfg: ModelConfig,
    input_ids: np.ndarray,  # (L,)
    pixels=None,  # (S, patch_input_dim) patchified floats, or frames
    video_grid_thw: Optional[np.ndarray] = None,
    second_per_grid_ts: Optional[Sequence[float]] = None,
    image_pixels: Optional[Sequence] = None,  # per image
    image_grid_thw: Optional[np.ndarray] = None,  # (n_img, 3)
) -> torch.Tensor:
    """Ungrouped full forward -> logits (L, V) f32
    (quickvideo_tpu/models/qwen25_vl/model.py:145): the video's vision
    embeddings scatter into its `<|video_pad|>` slots, and the images',
    in image order, into the `<|image_pad|>` slots (HF masked_scatter
    semantics); then full_forward_logits. Inputs go to the device that
    holds the parameters."""
    lang = params["language"]
    dev = lang["norm"].device
    ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.int64,
                          device=dev)
    x = embed_tokens(lang, ids)
    if pixels is not None:
        vis = encode_video_group(
            params, cfg, torch.as_tensor(pixels, device=dev),
            tuple(int(v) for v in np.asarray(video_grid_thw)[0]))
        x = merge_vision_embeddings(x, vis, ids, cfg.video_token_id)
    if image_pixels is not None:
        embs = [
            encode_video_group(params, cfg, torch.as_tensor(p, device=dev),
                               tuple(int(v) for v in g))
            for p, g in zip(image_pixels, np.asarray(image_grid_thw))
        ]
        x = merge_vision_embeddings(x, torch.cat(embs), ids,
                                    cfg.image_token_id)
    positions, _ = rope_index_for(
        cfg, np.asarray(input_ids), video_grid_thw=video_grid_thw,
        image_grid_thw=image_grid_thw,
        second_per_grid_ts=second_per_grid_ts,
    )
    cos, sin = rope.mrope_cos_sin(positions, cfg.text.head_dim,
                                  cfg.text.mrope_section,
                                  cfg.text.rope_theta, dev)
    return full_forward_logits(lang, x, cos, sin, cfg.text)
