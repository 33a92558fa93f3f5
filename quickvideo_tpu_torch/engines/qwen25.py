"""Qwen2.5-VL engines: sync (batch decode) and interleaved (overlap).

Counterpart of quickvideo_tpu/engines/qwen25.py for the slice: requests
with a video, images or both, and text; greedy or sampled decode, streamed
through `on_tokens`; and continuation scoring (`score_chat`,
`score_chat_multi`). Tokenization, the video plan, the image resize and the
CPU decoders are the port's copies of the JAX package's jax-free modules
(tokenization.py, video/{reader, preprocess, quickdecode, frame_cache}.py).
With `save_video_cache` the sync path keeps the decoded frames on disk
(`_fetch_frames`); with `resize_on_device` frames arrive at the source size
and the vision tower resamples them (`native_hw`).

Under pipeline parallelism only the first stage runs the vision tower: on
the later stages `chat_interleaved` opens no decode stream (no thread
decodes or uploads frames that nothing would take); it reads the video's
plan from the reader's metadata alone (`_planned_inputs`). `chat_sync`
decodes on the host on every stage, and the engine uploads nothing on the
later ones.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from pathlib import Path
from typing import List

import numpy as np

from quickvideo_tpu_torch.tokenization import build_chat_ids_from_messages
from quickvideo_tpu_torch.video import preprocess as pp
from quickvideo_tpu_torch.video import reader as vreader
from quickvideo_tpu_torch.prefill.engine import PrefillInputs
from quickvideo_tpu_torch.utils.timing import SpanTimer


def init_lvu_model(lvu, config):
    """Engine init hook (registry parity); nothing to patch or warm."""
    return lvu


def _question_from_messages(messages) -> tuple:
    """(video_path, question, video_kwargs, image_items) from
    reference-style messages. Image items keep message order (their
    placeholder expansion and embedding scatter must line up)."""
    video_path, question, vkw = None, "", {}
    images = []
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
                images.append(item)
            elif item.get("type") == "text":
                question = item.get("text", "")
    return video_path, question, vkw, images


def _load_image(obj) -> np.ndarray:
    """Image item payload -> (H, W, 3) uint8 RGB: a numpy array (HWC or
    CHW), or a file path (read with PIL, imported here only)."""
    if isinstance(obj, np.ndarray):
        a = obj
        if a.ndim == 3 and a.shape[0] == 3 and a.shape[-1] != 3:
            a = a.transpose(1, 2, 0)
        if a.ndim != 3 or a.shape[-1] != 3:
            raise ValueError(f"image array must be HWC/CHW RGB, got {a.shape}")
        return np.ascontiguousarray(a, np.uint8)
    from PIL import Image

    with Image.open(obj) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def _prepare_images(model_cfg, image_items):
    """Load and smart-resize each image to its model grid. Returns (pixels,
    grids, token_counts): per image a (1, 3, H, W) uint8 frame (the vision
    tower repeats it across the temporal patch), its (1, h, w) patch grid,
    and its merged token count for the chat template."""
    ps = model_cfg.vision.patch_size
    ms = model_cfg.vision.spatial_merge_size
    pixels, grids, counts = [], [], []
    for item in image_items:
        img = _load_image(item["image"])
        h, w = img.shape[:2]
        if "resized_height" in item and "resized_width" in item:
            rh, rw = pp.smart_resize(
                int(item["resized_height"]), int(item["resized_width"]),
                factor=ps * ms,
            )
        else:
            rh, rw = pp.smart_resize(
                h, w, factor=ps * ms,
                min_pixels=int(item.get("min_pixels", pp.MIN_PIXELS)),
                max_pixels=int(item.get("max_pixels", pp.MAX_PIXELS)),
            )
        frame = img.transpose(2, 0, 1)[None]  # (1, 3, H, W)
        if (rh, rw) != (h, w):
            frame = pp.resize_frames_bicubic(frame, rh, rw)
        grid = (1, rh // ps, rw // ps)
        pixels.append(np.ascontiguousarray(frame, np.uint8))
        grids.append(grid)
        counts.append(grid[1] // ms * (grid[2] // ms))
    return pixels, np.asarray(grids, np.int64), counts


def _images(lvu, image_items, timer):
    """(pixels, grids, token counts) of the request's images, or (None,
    None, ()) without any."""
    if not image_items:
        return None, None, ()
    with timer.span("processing"):
        return _prepare_images(lvu.model_config, image_items)


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


def _fetch_frames(lvu, video_path, timer, cfg=None):
    """(frames, plan, native_hw) of the whole sampled video, through the
    disk frame cache when `save_video_cache` is set
    (quickvideo_tpu/engines/qwen25.py:236-259): a hit reads the frames the
    plan asks for from disk and decodes nothing."""
    from quickvideo_tpu_torch.video import frame_cache

    cfg = cfg or lvu.config
    if not cfg.save_video_cache:
        return vreader.decode_video_batch(video_path, cfg)
    _name, reader = vreader.open_reader(video_path, cfg.decode_threads)
    plan = vreader.plan_from_reader(reader, cfg)
    native_hw = (
        (reader.source_height, reader.source_width)
        if cfg.resize_on_device and hasattr(reader, "source_height")
        else None
    )
    reader.close()
    cached = frame_cache.load(video_path, plan, cfg.cache_dir, native_hw)
    if cached is not None:
        return np.asarray(cached), plan, native_hw
    frames, plan, native_hw = vreader.decode_video_batch(video_path, cfg)
    _publish_frames(video_path, plan, frames, cfg.cache_dir, native_hw)
    return frames, plan, native_hw


def _publish_frames(video_path, plan, frames, cache_dir, native_hw):
    """frame_cache.save, made whole in a directory of this process's own
    and renamed into place: a reader sees no entry or a complete one. The
    ranks of a mesh run each request at once and share the cache
    directory, so several may write one entry while another reads it."""
    from quickvideo_tpu_torch.video import frame_cache

    root = (Path(cache_dir).expanduser() if cache_dir
            else frame_cache.default_cache_dir())
    root.mkdir(parents=True, exist_ok=True)
    part = Path(tempfile.mkdtemp(prefix=".part-", dir=root))
    try:
        entry = frame_cache.save(video_path, plan, frames, str(part),
                                 native_hw)
        try:
            os.rename(entry, root / entry.name)
        except OSError:
            pass  # another writer published the same entry first
    finally:
        shutil.rmtree(part, ignore_errors=True)


def _video_inputs(lvu, messages, video_path, cfg, timer, images):
    """PrefillInputs of a request with a video, decoded whole."""
    img_px, img_grids, img_counts = images
    with timer.span("frame_fetch"):
        frames, plan, native_hw = _fetch_frames(lvu, video_path, timer, cfg)
    ids = build_chat_ids_from_messages(
        lvu.tokenizer, lvu.model_config, messages,
        sum(plan.tokens_per_group), image_token_counts=img_counts,
    )
    inputs = vreader.build_prefill_inputs_from_frames(
        frames, plan, ids, native_hw=native_hw
    )
    inputs.image_grid_thw = img_grids
    inputs.image_pixels = img_px
    return inputs


def _image_only_inputs(lvu, messages, images):
    """PrefillInputs of a request without a video: the whole sequence in
    one prefill."""
    img_px, img_grids, img_counts = images
    ids = build_chat_ids_from_messages(
        lvu.tokenizer, lvu.model_config, messages, 0,
        image_token_counts=img_counts,
    )
    return PrefillInputs(
        input_ids=ids, video_grid_thw=None, pixel_groups=[], group_grids=[],
        image_grid_thw=img_grids, image_pixels=img_px,
    )


def chat_sync(lvu, messages, **generation_kwargs) -> List[str]:
    """Decode every sampled frame first, then prefill group by group. Image
    items, alone or beside the video, ride the prefix or suffix prefill."""
    video_path, _question, vkw, image_items = _question_from_messages(
        messages
    )
    cfg = _config_with_video_kwargs(lvu, vkw, generation_kwargs)
    timer = SpanTimer()
    images = _images(lvu, image_items, timer)
    if video_path is None:
        inputs = _image_only_inputs(lvu, messages, images)
    else:
        inputs = _video_inputs(lvu, messages, video_path, cfg, timer, images)
    return _generate(lvu, inputs, timer, generation_kwargs)


def score_chat(lvu, messages, continuation) -> tuple:
    """Teacher-forced (total_logprob, is_greedy) of `continuation` (text or
    token ids) after the chat context: the lmms-eval `loglikelihood`
    contract, with chat_sync's input building."""
    return score_chat_multi(lvu, messages, [continuation])[0]


def score_chat_multi(lvu, messages, continuations) -> list:
    """Several continuations against one prefill of the chat context (the
    multiple-choice pattern): the video decodes and prefills once, and the
    engine restores the cache's lengths between options. Returns a list of
    (total_logprob, is_greedy)."""
    video_path, _question, vkw, image_items = _question_from_messages(
        messages
    )
    cfg = _config_with_video_kwargs(lvu, vkw, {})
    timer = SpanTimer()
    images = _images(lvu, image_items, timer)
    cont_ids = [
        lvu.tokenizer.encode_text(c) if isinstance(c, str)
        else [int(t) for t in c]
        for c in continuations
    ]
    if video_path is None:
        inputs = _image_only_inputs(lvu, messages, images)
    else:
        inputs = _video_inputs(lvu, messages, video_path, cfg, timer, images)
    return lvu.engine.score_continuations(inputs, cont_ids, timer=timer)


def run_interleaved(lvu, question: str, video_path: str, **generation_kwargs):
    return chat_interleaved(lvu, _video_messages(question, video_path),
                            **generation_kwargs)


def _planned_inputs(lvu, messages, video_path, cfg, images):
    """PrefillInputs of a video request without its pixels, for a pipeline
    stage past the first: the plan from the interleaved reader's metadata
    (as AsyncPixelGroups plans it), no frame decoded."""
    from quickvideo_tpu_torch.video import quickdecode as qd

    img_px, img_grids, img_counts = images
    reader = qd.InterleavedVideoReader(
        video_path, num_threads=cfg.decode_threads,
        num_intervals=cfg.decode_intervals,
    )
    try:
        plan = vreader.plan_from_reader(reader, cfg)
        native_hw = ((reader.source_height, reader.source_width)
                     if cfg.resize_on_device else None)
    finally:
        reader.close()
    ids = build_chat_ids_from_messages(
        lvu.tokenizer, lvu.model_config, messages,
        sum(plan.tokens_per_group), image_token_counts=img_counts,
    )
    return PrefillInputs(
        input_ids=ids, video_grid_thw=plan.grid_thw, pixel_groups=[],
        group_grids=plan.group_grids,
        second_per_grid_ts=plan.second_per_grid_ts, native_hw=native_hw,
        image_grid_thw=img_grids, image_pixels=img_px,
    )


def chat_interleaved(lvu, messages, **generation_kwargs) -> List[str]:
    """Overlapped driver: native interval decode and the upload to the card
    run ahead of the prefill loop (video/stream.py). A request without a
    video has nothing to stream and takes the sync path; a pipeline stage
    past the first opens no stream (module docstring)."""
    from quickvideo_tpu_torch.video.stream import AsyncPixelGroups

    video_path, _question, vkw, image_items = _question_from_messages(
        messages
    )
    if video_path is None:
        return chat_sync(lvu, messages, **generation_kwargs)
    cfg = _config_with_video_kwargs(lvu, vkw, generation_kwargs)
    timer = SpanTimer()
    images = _images(lvu, image_items, timer)
    if not lvu.engine.first_stage:
        inputs = _planned_inputs(lvu, messages, video_path, cfg, images)
        return _generate(lvu, inputs, timer, generation_kwargs)
    img_px, img_grids, img_counts = images
    stream = AsyncPixelGroups(video_path, cfg, device=lvu.device, timer=timer)
    try:
        plan = stream.plan
        ids = build_chat_ids_from_messages(
            lvu.tokenizer, lvu.model_config, messages,
            sum(plan.tokens_per_group), image_token_counts=img_counts,
        )
        inputs = PrefillInputs(
            input_ids=ids,
            video_grid_thw=plan.grid_thw,
            pixel_groups=iter(stream),
            group_grids=plan.group_grids,
            second_per_grid_ts=plan.second_per_grid_ts,
            native_hw=stream.native_hw,
            image_grid_thw=img_grids,
            image_pixels=img_px,
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
