"""Chat-template tokenization with pixel-free video-token expansion.

The port's copy of quickvideo_tpu/tokenization.py (the port imports nothing of the JAX
package); tests/test_torch_copies.py pins it to the original.

The reference tokenizes through HF AutoProcessor; its interleaved engine
additionally tokenizes WITHOUT pixels by expanding the `<|video_pad|>`
placeholder purely from grid metadata ("dummy_call", reference
lvu/models/qwen25_lvu_interleaved.py:522-638) so the full input_ids exist
before a single frame is decoded. Here that pixel-free expansion is the ONLY
path — the token count is always known from the video plan, which is what
lets decode overlap prefill from t=0.

When the model directory ships a real tokenizer, it is used; otherwise a
deterministic byte-level fallback keeps the engine runnable (benchmarks,
synthetic tests, environments without checkpoint downloads).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from quickvideo_tpu_torch.models.qwen25_vl.config import ModelConfig

# Qwen2.5 chat special tokens (fixed ids in the Qwen vocab)
IM_START = 151644
IM_END = 151645
NEWLINE = 198  # '\n' in Qwen BPE

DEFAULT_SYSTEM = "You are a helpful assistant."


class FallbackTokenizer:
    """Byte-level fallback: text token = 256 reserved base + byte value.
    Only used when no real tokenizer is available; round-trips exactly."""

    BASE = 10_000

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        if cfg.text.vocab_size < self.BASE + 256:
            self.BASE = 5  # tiny test vocabs: bytes at 5..260
        self.eos_token_id = special_ids(cfg)[1]

    def encode_text(self, text: str) -> List[int]:
        return [self.BASE + b for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        bs = bytes(
            int(i) - self.BASE for i in ids if self.BASE <= int(i) < self.BASE + 256
        )
        return bs.decode("utf-8", errors="replace")


class HFTokenizer:
    def __init__(self, path: str, cfg: ModelConfig):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(path)
        self.cfg = cfg
        self.eos_token_id = self.tok.eos_token_id or IM_END

    def encode_text(self, text: str) -> List[int]:
        return self.tok.encode(text, add_special_tokens=False)

    def decode(self, ids: Sequence[int]) -> str:
        return self.tok.decode(ids, skip_special_tokens=True)


def special_ids(cfg: ModelConfig):
    """(im_start, im_end, newline) — Qwen vocab ids, remapped for tiny test
    vocabs that can't hold the real ids."""
    if cfg.text.vocab_size > IM_END:
        return IM_START, IM_END, NEWLINE
    v = cfg.text.vocab_size
    return v - 2, v - 1, 270


def load_tokenizer(model_name_or_path: str, cfg: ModelConfig):
    for fname in ("tokenizer.json", "tokenizer_config.json"):
        if model_name_or_path and os.path.exists(
            os.path.join(model_name_or_path, fname)
        ):
            try:
                return HFTokenizer(model_name_or_path, cfg)
            except Exception:
                break
    return FallbackTokenizer(cfg)


def build_chat_ids(
    tokenizer,
    cfg: ModelConfig,
    question: str,
    n_video_tokens: int,
    system: str = DEFAULT_SYSTEM,
) -> np.ndarray:
    """Packed sequence for one user turn with one video, generation prompt
    appended — the template the reference's apply_chat_template produces
    (reference lvu/models/qwen25_vl.py:356-358), with `<|video_pad|>`
    pre-expanded to n_video_tokens."""
    messages = [
        {"role": "system", "content": system},
        {
            "role": "user",
            "content": [
                {"type": "video", "video": "<placeholder>"},
                {"type": "text", "text": question},
            ],
        },
    ]
    return build_chat_ids_from_messages(tokenizer, cfg, messages, n_video_tokens)


def build_chat_ids_from_messages(
    tokenizer,
    cfg: ModelConfig,
    messages,
    n_video_tokens: int,
    image_token_counts: Sequence[int] = (),
) -> np.ndarray:
    """Full multi-turn chat template (reference chat_lvu_model feeds the
    complete message list through apply_chat_template,
    lvu/models/qwen25_lvu.py:538-548): every system/user/assistant turn is
    rendered as `<|im_start|>role\\n...<|im_end|>\\n`, the single video item
    expands to `<|vision_start|><|video_pad|>*N<|vision_end|>`, each image
    item to `<|vision_start|><|image_pad|>*N_i<|vision_end|>` (the reference
    inherits image support from stock qwen_vl_utils.process_vision_info,
    lvu/models/qwen25_lvu.py:565), and the generation prompt
    `<|im_start|>assistant\\n` is appended.

    `image_token_counts[i]` = merged token count of the i-th image item in
    message order ((h/merge)*(w/merge) of its grid)."""
    im_start, im_end, newline = special_ids(cfg)
    ids: List[int] = []
    n_videos = 0
    n_images = 0
    if not messages or messages[0].get("role") != "system":
        ids += (
            [im_start]
            + tokenizer.encode_text("system\n" + DEFAULT_SYSTEM)
            + [im_end, newline]
        )
    for m in messages:
        role = m.get("role", "user")
        content = m.get("content", "")
        ids += [im_start] + tokenizer.encode_text(role + "\n")
        if isinstance(content, str):
            ids += tokenizer.encode_text(content)
        else:
            for item in content:
                t = item.get("type")
                if t == "video":
                    n_videos += 1
                    if n_videos > 1:
                        raise ValueError(
                            "engines support one video per conversation "
                            "(the reference asserts the same)"
                        )
                    ids += [cfg.vision_start_token_id]
                    ids += [cfg.video_token_id] * n_video_tokens
                    ids += [cfg.vision_end_token_id]
                elif t == "image":
                    if n_images >= len(image_token_counts):
                        raise ValueError(
                            f"image item #{n_images} has no entry in "
                            f"image_token_counts ({len(image_token_counts)} "
                            "given)"
                        )
                    ids += [cfg.vision_start_token_id]
                    ids += [cfg.image_token_id] * int(
                        image_token_counts[n_images]
                    )
                    ids += [cfg.vision_end_token_id]
                    n_images += 1
                elif t == "text":
                    ids += tokenizer.encode_text(item.get("text", ""))
                else:
                    raise ValueError(f"unsupported content item type {t!r}")
        ids += [im_end, newline]
    ids += [im_start] + tokenizer.encode_text("assistant\n")
    return np.asarray(ids, np.int64)
