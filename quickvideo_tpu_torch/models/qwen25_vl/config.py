"""Qwen2.5-VL architecture configs.

The port's copy of quickvideo_tpu/models/qwen25_vl/config.py (the port imports nothing of the JAX
package); tests/test_torch_copies.py pins it to the original.

Values match the published HF model configs (3B/7B/72B) and the installed
`transformers` Qwen2_5_VLConfig defaults; `tiny` is a test-size config used
for numerics parity against the torch implementation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class VisionConfig:
    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    tokens_per_second: float = 2.0
    window_size: int = 112
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    out_hidden_size: int = 3584
    rms_norm_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_input_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size ** 2

    @property
    def spatial_merge_unit(self) -> int:
        return self.spatial_merge_size ** 2


@dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-6
    mrope_section: Tuple[int, int, int] = (16, 24, 24)
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 128000

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_kv_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads


@dataclass(frozen=True)
class ModelConfig:
    name: str = "qwen25-vl-7b"
    vision: VisionConfig = field(default_factory=VisionConfig)
    text: TextConfig = field(default_factory=TextConfig)
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    vision_end_token_id: int = 151653


def _mk(name, vision, text) -> ModelConfig:
    return ModelConfig(name=name, vision=vision, text=text)


PRESETS = {
    "qwen25-vl-3b": _mk(
        "qwen25-vl-3b",
        VisionConfig(out_hidden_size=2048),
        TextConfig(
            hidden_size=2048,
            intermediate_size=11008,
            num_hidden_layers=36,
            num_attention_heads=16,
            num_key_value_heads=2,
        ),
    ),
    "qwen25-vl-7b": _mk("qwen25-vl-7b", VisionConfig(), TextConfig()),
    "qwen25-vl-72b": _mk(
        "qwen25-vl-72b",
        VisionConfig(out_hidden_size=8192, tokens_per_second=4.0),
        TextConfig(
            hidden_size=8192,
            intermediate_size=29568,
            num_hidden_layers=80,
            num_attention_heads=64,
            num_key_value_heads=8,
            rms_norm_eps=1e-5,
        ),
    ),
    # Tiny config for tests: same structure, small dims. head_dim = 48/4 =
    # 12, so mrope sections sum to head_dim/2 = 6. Special token ids remapped
    # into the small vocab.
    "tiny": ModelConfig(
        name="tiny",
        vision=VisionConfig(
            depth=4,
            hidden_size=32,
            intermediate_size=64,
            num_heads=4,
            window_size=112,
            fullatt_block_indexes=(1, 3),
            out_hidden_size=48,
        ),
        text=TextConfig(
            vocab_size=1024,
            hidden_size=48,
            intermediate_size=96,
            num_hidden_layers=3,
            num_attention_heads=4,
            num_key_value_heads=2,
            mrope_section=(2, 2, 2),
        ),
        image_token_id=1001,
        video_token_id=1002,
        vision_start_token_id=1003,
        vision_end_token_id=1004,
    ),
}


def get_config(name_or_path: str) -> ModelConfig:
    """Resolve a preset name or an HF model dir (reads config.json)."""
    key = name_or_path.lower().rstrip("/")
    alias = {
        "qwen/qwen2.5-vl-3b-instruct": "qwen25-vl-3b",
        "qwen/qwen2.5-vl-7b-instruct": "qwen25-vl-7b",
        "qwen/qwen2.5-vl-72b-instruct": "qwen25-vl-72b",
    }
    key = alias.get(key, key)
    if key in PRESETS:
        return PRESETS[key]
    import json
    import os

    cfg_path = os.path.join(name_or_path, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            raw = json.load(f)
        return config_from_hf_dict(raw, name=os.path.basename(name_or_path))
    raise ValueError(f"Unknown model preset or path: {name_or_path}")


def config_from_hf_dict(raw: dict, name: str = "custom") -> ModelConfig:
    v = raw.get("vision_config", {})
    t = raw.get("text_config", raw)  # older configs inline text fields
    vision = VisionConfig(
        depth=v.get("depth", 32),
        hidden_size=v.get("hidden_size", 1280),
        intermediate_size=v.get("intermediate_size", 3420),
        num_heads=v.get("num_heads", 16),
        in_channels=v.get("in_channels", 3),
        patch_size=v.get("patch_size", 14),
        spatial_merge_size=v.get("spatial_merge_size", 2),
        temporal_patch_size=v.get("temporal_patch_size", 2),
        tokens_per_second=float(v.get("tokens_per_second", 2.0)),
        window_size=v.get("window_size", 112),
        fullatt_block_indexes=tuple(v.get("fullatt_block_indexes", (7, 15, 23, 31))),
        out_hidden_size=v.get("out_hidden_size", 3584),
    )
    text = TextConfig(
        vocab_size=t.get("vocab_size", 152064),
        hidden_size=t.get("hidden_size", 3584),
        intermediate_size=t.get("intermediate_size", 18944),
        num_hidden_layers=t.get("num_hidden_layers", 28),
        num_attention_heads=t.get("num_attention_heads", 28),
        num_key_value_heads=t.get("num_key_value_heads", 4),
        rope_theta=float(t.get("rope_theta", 1_000_000.0)),
        rms_norm_eps=float(t.get("rms_norm_eps", 1e-6)),
        mrope_section=tuple(
            (t.get("rope_scaling") or {}).get("mrope_section", (16, 24, 24))
        ),
        tie_word_embeddings=raw.get("tie_word_embeddings", False),
    )
    return ModelConfig(
        name=name,
        vision=vision,
        text=text,
        image_token_id=raw.get("image_token_id", 151655),
        video_token_id=raw.get("video_token_id", 151656),
        vision_start_token_id=raw.get("vision_start_token_id", 151652),
        vision_end_token_id=raw.get("vision_end_token_id", 151653),
    )
