"""A configuration's sizes, read from its published config.json.

The benchmark's own reading of a Qwen2.5-VL config (the keys of the
published Hugging Face files): the weights, the operation counts and the
reference take their shapes from here, never from the program. The
benchmark's run settings sit beside the published keys under "qvbench".
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Tuple


@dataclass(frozen=True)
class Vision:
    depth: int
    hidden: int
    intermediate: int
    heads: int
    patch: int
    merge: int
    temporal_patch: int
    window: int
    fullatt: Tuple[int, ...]
    out_hidden: int
    tokens_per_second: float
    in_channels: int = 3
    eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch * self.patch ** 2


@dataclass(frozen=True)
class Text:
    vocab: int
    hidden: int
    intermediate: int
    layers: int
    heads: int
    kv_heads: int
    rope_theta: float
    eps: float
    mrope_section: Tuple[int, int, int]
    tied: bool

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


@dataclass(frozen=True)
class ModelSpec:
    name: str
    path: Path  # the config.json
    vision: Vision
    text: Text
    image_token_id: int
    video_token_id: int
    vision_start_token_id: int
    vision_end_token_id: int
    run: dict  # the "qvbench" block: dtype, param_dtype, kv_cache_dtype

    @property
    def int8_weights(self) -> bool:
        return self.run.get("param_dtype") == "int8"


def load_spec(path) -> ModelSpec:
    path = Path(path)
    raw = json.loads(path.read_text())
    v, t = raw["vision_config"], raw.get("text_config", raw)
    vision = Vision(
        depth=v["depth"], hidden=v["hidden_size"],
        intermediate=v["intermediate_size"], heads=v["num_heads"],
        patch=v["patch_size"], merge=v["spatial_merge_size"],
        temporal_patch=v["temporal_patch_size"], window=v["window_size"],
        fullatt=tuple(v["fullatt_block_indexes"]),
        out_hidden=v["out_hidden_size"],
        tokens_per_second=float(v["tokens_per_second"]),
        in_channels=v.get("in_chans", 3),
    )
    text = Text(
        vocab=t["vocab_size"], hidden=t["hidden_size"],
        intermediate=t["intermediate_size"], layers=t["num_hidden_layers"],
        heads=t["num_attention_heads"], kv_heads=t["num_key_value_heads"],
        rope_theta=float(t["rope_theta"]), eps=float(t["rms_norm_eps"]),
        mrope_section=tuple(t["rope_scaling"]["mrope_section"]),
        tied=bool(raw.get("tie_word_embeddings", False)),
    )
    return ModelSpec(
        name=path.parent.name, path=path, vision=vision, text=text,
        image_token_id=raw["image_token_id"],
        video_token_id=raw["video_token_id"],
        vision_start_token_id=raw["vision_start_token_id"],
        vision_end_token_id=raw["vision_end_token_id"],
        run=dict(raw.get("qvbench", {})),
    )


def layer_shapes(spec: ModelSpec):
    """(one decoder layer's, one vision block's, the merger's) leaf
    shapes, matrices as (in, out): the layout the port's parameter tree
    takes (x @ w)."""
    t, v = spec.text, spec.vision
    c, hd, f = t.hidden, t.head_dim, t.intermediate
    hq, hkv = t.heads * hd, t.kv_heads * hd
    vc, vi, md = v.hidden, v.intermediate, v.hidden * v.merge ** 2
    layer = {
        "ln1": (c,), "ln2": (c,), "wq": (c, hq), "bq": (hq,),
        "wk": (c, hkv), "bk": (hkv,), "wv": (c, hkv), "bv": (hkv,),
        "wo": (hq, c), "wg": (c, f), "wu": (c, f), "wd": (f, c),
    }
    block = {
        "ln1": (vc,), "ln2": (vc,), "wqkv": (vc, 3 * vc), "bqkv": (3 * vc,),
        "wo": (vc, vc), "bo": (vc,), "wg": (vc, vi), "bg": (vi,),
        "wu": (vc, vi), "bu": (vi,), "wd": (vi, vc), "bd": (vc,),
    }
    merger = {"ln_q": (vc,), "w1": (md, md), "b1": (md,),
              "w2": (md, v.out_hidden), "b2": (v.out_hidden,)}
    return layer, block, merger
