"""Qwen2.5-VL engines: sync (batch decode) and interleaved (overlap).

Counterpart of quickvideo_tpu/engines/qwen25.py for the slice: video + text
requests, greedy decode. Tokenization, the video plan and the CPU decoders
are the port's copies of the JAX package's jax-free modules (tokenization.py,
video/{reader, preprocess, quickdecode}.py).
"""

from __future__ import annotations

from typing import List

import numpy as np

from quickvideo_tpu_torch.tokenization import build_chat_ids_from_messages
from quickvideo_tpu_torch.video import reader as vreader
from quickvideo_tpu_torch.prefill.engine import PrefillInputs
from quickvideo_tpu_torch.utils.timing import SpanTimer


def init_lvu_model(lvu, config):
    """Engine init hook (registry parity); nothing to patch or warm."""
    return lvu


def _question_from_messages(messages) -> tuple:
    """(video_path, question, video_kwargs) from reference-style messages.
    Image items are not ported yet."""
    video_path, question, vkw = None, "", {}
    for m in messages:
        if m.get("role") != "user":
            continue
        content = m.get("content")
        if isinstance(content, str):
            question = content
            continue
        for item in content:
            if item.get("type") == "video":
                video_path = item["video"]
                vkw = {
                    k: v for k, v in item.items() if k not in ("type", "video")
                }
            elif item.get("type") == "image":
                raise NotImplementedError("image inputs are not ported yet")
            elif item.get("type") == "text":
                question = item.get("text", "")
    if video_path is None:
        raise NotImplementedError("requests without a video are not ported yet")
    return video_path, question, vkw


def _config_with_video_kwargs(lvu, vkw: dict, generation_kwargs: dict):
    """Per-request fps / num_frames from the video item or the generation
    kwargs (popped, not forwarded to decode)."""
    overrides = {}
    for src in (vkw, generation_kwargs):
        if "fps" in src:
            overrides["fps"] = src["fps"]
        if "nframes" in src:
            overrides["num_frames"] = src["nframes"]
        if "num_frames" in src:
            overrides["num_frames"] = src["num_frames"]
    for key in ("fps", "nframes", "num_frames"):
        generation_kwargs.pop(key, None)
    return lvu.config.replace(**overrides) if overrides else lvu.config


def _video_messages(question: str, video_path: str):
    return [
        {
            "role": "user",
            "content": [
                {"type": "video", "video": video_path},
                {"type": "text", "text": question},
            ],
        }
    ]


def run_sync(lvu, question: str, video_path: str, **generation_kwargs):
    return chat_sync(lvu, _video_messages(question, video_path),
                     **generation_kwargs)


def chat_sync(lvu, messages, **generation_kwargs) -> List[str]:
    """Decode every sampled frame first, then prefill group by group."""
    video_path, _question, vkw = _question_from_messages(messages)
    cfg = _config_with_video_kwargs(lvu, vkw, generation_kwargs)
    timer = SpanTimer()
    with timer.span("frame_fetch"):
        frames, plan, native_hw = vreader.decode_video_batch(video_path, cfg)
    ids = build_chat_ids_from_messages(
        lvu.tokenizer, lvu.model_config, messages, sum(plan.tokens_per_group)
    )
    groups, off = [], 0
    for cnt in plan.group_frame_counts:
        groups.append(np.ascontiguousarray(frames[off : off + cnt]))
        off += cnt
    inputs = PrefillInputs(
        input_ids=ids,
        video_grid_thw=plan.grid_thw,
        pixel_groups=groups,
        group_grids=plan.group_grids,
        second_per_grid_ts=plan.second_per_grid_ts,
        native_hw=native_hw,
    )
    return _generate(lvu, inputs, timer, generation_kwargs)


def run_interleaved(lvu, question: str, video_path: str, **generation_kwargs):
    return chat_interleaved(lvu, _video_messages(question, video_path),
                            **generation_kwargs)


def chat_interleaved(lvu, messages, **generation_kwargs) -> List[str]:
    """Overlapped driver: native interval decode and the upload to the card
    run ahead of the prefill loop (video/stream.py)."""
    from quickvideo_tpu_torch.video.stream import AsyncPixelGroups

    video_path, _question, vkw = _question_from_messages(messages)
    cfg = _config_with_video_kwargs(lvu, vkw, generation_kwargs)
    timer = SpanTimer()
    stream = AsyncPixelGroups(video_path, cfg, device=lvu.device, timer=timer)
    try:
        plan = stream.plan
        ids = build_chat_ids_from_messages(
            lvu.tokenizer, lvu.model_config, messages,
            sum(plan.tokens_per_group),
        )
        inputs = PrefillInputs(
            input_ids=ids,
            video_grid_thw=plan.grid_thw,
            pixel_groups=iter(stream),
            group_grids=plan.group_grids,
            second_per_grid_ts=plan.second_per_grid_ts,
        )
        return _generate(lvu, inputs, timer, generation_kwargs)
    finally:
        stream.close()


def _generate(lvu, inputs, timer, generation_kwargs) -> List[str]:
    eos = [lvu.tokenizer.eos_token_id]
    res = lvu.engine.generate(
        inputs,
        max_new_tokens=generation_kwargs.get("max_new_tokens"),
        eos_token_ids=eos,
        greedy=not generation_kwargs.get("do_sample", False),
        temperature=generation_kwargs.get("temperature", 1.0),
        top_p=generation_kwargs.get("top_p"),
        top_k=generation_kwargs.get("top_k"),
        on_tokens=generation_kwargs.get("on_tokens"),
    )
    for k, v in timer.totals().items():
        res.timings[k] = res.timings.get(k, 0.0) + v
    lvu.last_result = res
    if lvu.config.use_tqdm or generation_kwargs.get("verbose"):
        print(
            f"Time taken -- "
            f"frame fetch: {res.timings.get('frame_fetch', 0):.2f}s, "
            f"processing: {res.timings.get('processing', 0):.2f}s, "
            f"prefill: {res.timings.get('prefill', 0):.2f}s, "
            f"decode: {res.timings.get('decode', 0):.2f}s, "
            f"e2e: {res.timings.get('e2e', 0):.2f}s"
        )
    return [lvu.tokenizer.decode([t for t in res.tokens if t not in eos])]
