"""The request's token sequence, as the benchmark and its reference build it.

Qwen2.5's chat template around one video and one question, with the
byte-level stand-in tokenizer a model directory without tokenizer files
gets (one token per UTF-8 byte, at 10,000 + byte): the system turn, the
user turn `<|vision_start|>` + video placeholders + `<|vision_end|>` +
question, and the generation prompt `<|im_start|>assistant\\n`. A test
vocabulary too small for Qwen's ids takes its last two ids for the turn
markers, 270 for the newline and 5 + byte for the bytes.
"""

from __future__ import annotations

from typing import List

import numpy as np

IM_START, IM_END, NEWLINE = 151644, 151645, 198
BYTE_BASE = 10_000
SYSTEM = "You are a helpful assistant."


def specials(spec):
    """(im_start, im_end, newline) of the spec's vocabulary."""
    v = spec.text.vocab
    return (IM_START, IM_END, NEWLINE) if v > IM_END else (v - 2, v - 1, 270)


def encode(spec, text: str) -> List[int]:
    base = BYTE_BASE if spec.text.vocab >= BYTE_BASE + 256 else 5
    return [base + b for b in text.encode("utf-8")]


def prefix_ids(spec) -> List[int]:
    """Everything before the first video placeholder."""
    s, e, nl = specials(spec)
    return ([s] + encode(spec, "system\n" + SYSTEM) + [e, nl]
            + [s] + encode(spec, "user\n") + [spec.vision_start_token_id])


def suffix_ids(spec, question: str) -> List[int]:
    """Everything after the last video placeholder."""
    s, e, nl = specials(spec)
    return ([spec.vision_end_token_id] + encode(spec, question) + [e, nl]
            + [s] + encode(spec, "assistant\n"))


def request_ids(spec, question: str, n_video: int) -> np.ndarray:
    return np.asarray(prefix_ids(spec) + [spec.video_token_id] * n_video
                      + suffix_ids(spec, question), np.int64)
