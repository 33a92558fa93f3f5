"""Multi-turn chat over one video with incremental KV reuse.

Counterpart of quickvideo_tpu/chat.py. A session keeps the pruned video KV
cache (and every past turn's suffix and answer) on the device: the first
`ask` runs the grouped video prefill (streamed through AsyncPixelGroups)
with room reserved for later turns, and each follow-up appends only its
new template and question tokens before decoding. Causal attention keeps
earlier KV unchanged, so a follow-up attends the same (key, value,
position) set as a from-scratch request over the whole history.

`save` / `load` write and read the JAX package's .npz format
(SESSION_FORMAT_VERSION 1): the populated cache slots (bf16 as a uint16
view), the per-layer lengths, the consumed ids, the unappended last token,
the video/prefix mRoPE rows and a JSON `meta` with the config fingerprint.
A session saved by either package resumes in the other. int8 caches store
both scale tensors; an int8k cache (int8 K only) stores `k_scale` alone,
which the JAX package cannot write (ROADMAP C15) and the port reads back.

Under a mesh (quickvideo_tpu/chat.py:361-404) every rank runs the session.
`save` gathers the cache's tp heads and sp windows (parallel/comm.py) into
the same .npz a single device writes, which the request's first rank
writes; `load` rounds the saved capacity up to the engine's quantum
(4096 * sp) and gives each rank its heads and window, so a session moves
between a mesh and one device either way. Pipeline parallelism is
refused, as the JAX package refuses it (`refuse_pipeline`).

Usage:
    session = lvu.start_chat("movie.mp4")
    a1 = session.ask("What happens first?")       # full video prefill
    a2 = session.ask("Why did they do that?")     # incremental
    session.save("movie.npz"); lvu.resume_chat("movie.npz")
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np
import torch

from quickvideo_tpu_torch.models.qwen25_vl import rope
from quickvideo_tpu_torch.ops.kv_cache import KVCache
from quickvideo_tpu_torch.parallel.comm import all_gather
from quickvideo_tpu_torch.parallel.context_parallel import shard_cache_cp
from quickvideo_tpu_torch.parallel.sharding import shard_cache
from quickvideo_tpu_torch.tokenization import special_ids
from quickvideo_tpu_torch.utils.timing import SpanTimer

SESSION_FORMAT_VERSION = 1


def _session_fingerprint(lvu) -> dict:
    """Config fields a saved session's KV depends on: resuming under
    another value of any of them would change what the cache means."""
    c = lvu.config
    return {
        "model": c.model_name_or_path,
        "model_type": c.model_type,
        "predict_type": c.top_k_predict_type,
        "top_p": c.top_p,
        "top_k": c.top_k,
        "group": c.video_group_size,
        "dtype": c.dtype,
        "param_dtype": c.param_dtype,
        "kv_dtype": c.kv_cache_dtype,
        "decay": (c.top_k_decay_type, c.top_k_decay_factor),
        "prune_start": c.prefill_prune_starting_layer,
    }


def _pack(t: torch.Tensor):
    """(numpy array, dtype tag) of a tensor; bf16 as its uint16 bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _unpack(a: np.ndarray, tag: str) -> torch.Tensor:
    if tag == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a.astype(np.dtype(tag), copy=False))


def refuse_pipeline(lvu) -> None:
    """ValueError under pipeline parallelism, with the JAX package's
    message (quickvideo_tpu/chat.py:90-95), on every rank before any
    collective."""
    if lvu.config.mesh.pp > 1:
        raise ValueError(
            "chat sessions do not support pipeline parallelism yet "
            "(the session holds a KVCache value; pp keeps the cache "
            "slabbed inside the PipelinedStack)"
        )


class ChatSession:
    """One video, many turns; the KV cache persists across `ask` calls."""

    def __init__(self, lvu, video_path: str, reserve_turns: int = 8,
                 **video_kwargs):
        refuse_pipeline(lvu)
        if lvu.config.query_based or lvu.config.do_top_k_for_query:
            # question-dependent pruning makes the cached video KV specific
            # to the first question
            raise ValueError(
                "chat sessions do not support query-based predictors or "
                "do_top_k_for_query (the pruned cache would depend on the "
                "first question); use a norm-based predictor"
            )
        self.lvu = lvu
        self.video_path = video_path
        self.video_kwargs = video_kwargs
        # per reserved turn: a question suffix bucket + the decoded answer
        self._reserve = reserve_turns * (lvu.config.max_decode_tokens + 256)
        self._cache: Optional[KVCache] = None
        self._ids: Optional[np.ndarray] = None  # ids whose KV is cached
        self._tail: List[int] = []  # generated tokens whose KV is not
        self._cache_len = 0
        self._delta = 0
        self._pos_prefix = None  # (3, ss0) video/prefix mRoPE positions
        self._ss0 = 0
        self._session_tables = None  # (cos, sin) out to the reserve horizon
        self.turns: List[dict] = []

    def _eos(self):
        return [self.lvu.tokenizer.eos_token_id]

    def _tables(self, total_len: int):
        """cos/sin for the whole session, built once out to the reserve
        horizon (rows past the video are text: position = row + delta) and
        rebuilt only if a turn outgrows them."""
        cfg = self.lvu.model_config
        mdt = self.lvu.config.max_decode_tokens
        need = total_len + mdt + 32
        if (self._session_tables is not None
                and self._session_tables[0].shape[0] >= need):
            return self._session_tables
        horizon = max(need, total_len + self._reserve + mdt + 32)
        horizon += (-horizon) % 64
        text_rows = rope.text_positions(self._ss0 + self._delta,
                                        horizon - self._ss0)
        self._session_tables = rope.mrope_cos_sin(
            np.concatenate([self._pos_prefix, text_rows], axis=1),
            cfg.text.head_dim, cfg.text.mrope_section, cfg.text.rope_theta,
            self.lvu.device,
        )
        return self._session_tables

    def _decode_kwargs(self, gen: dict) -> dict:
        return dict(
            greedy=not gen.get("do_sample", False),
            temperature=gen.get("temperature", 1.0),
            top_p=gen.get("top_p"), top_k=gen.get("top_k"),
            on_tokens=gen.get("on_tokens"),
        )

    def _first_ask(self, question: str, max_new_tokens, gen):
        from quickvideo_tpu_torch.engines.qwen25 import (
            _config_with_video_kwargs,
        )
        from quickvideo_tpu_torch.prefill.engine import PrefillInputs
        from quickvideo_tpu_torch.tokenization import build_chat_ids
        from quickvideo_tpu_torch.video.stream import AsyncPixelGroups

        lvu = self.lvu
        cfg = _config_with_video_kwargs(lvu, self.video_kwargs, gen)
        timer = SpanTimer()
        with timer.span("e2e"):
            stream = AsyncPixelGroups(self.video_path, cfg,
                                      device=lvu.device, timer=timer)
            try:
                plan = stream.plan
                ids = build_chat_ids(lvu.tokenizer, lvu.model_config,
                                     question, sum(plan.tokens_per_group))
                inputs = PrefillInputs(
                    input_ids=ids,
                    video_grid_thw=plan.grid_thw,
                    pixel_groups=iter(stream),
                    group_grids=plan.group_grids,
                    second_per_grid_ts=plan.second_per_grid_ts,
                    native_hw=stream.native_hw,
                )
                cache, state = lvu.engine.prefill(
                    inputs, timer=timer, extra_capacity=self._reserve
                )
            finally:
                stream.close()
            self._delta = state["delta"]
            self._ss0 = state["suffix_start"]
            self._pos_prefix = np.asarray(state["positions"])[:, : self._ss0]
            toks, cache, cache_len = lvu.engine._generate_from_cache(
                cache, state, max_new_tokens, self._eos(), timer=timer,
                **self._decode_kwargs(gen),
            )
        return ids, toks, cache, cache_len, timer

    def _follow_up(self, question: str, max_new_tokens, gen):
        lvu = self.lvu
        tok = lvu.tokenizer
        im_start, im_end, newline = special_ids(lvu.model_config)
        suffix: List[int] = list(self._tail)
        if not suffix or suffix[-1] != im_end:
            # the previous answer hit max_new without EOS: close its turn as
            # the chat template would
            suffix += [im_end]
        suffix += [newline, im_start] + tok.encode_text("user\n")
        suffix += tok.encode_text(question)
        suffix += [im_end, newline, im_start] + tok.encode_text("assistant\n")
        full_ids = np.concatenate([self._ids, np.asarray(suffix, np.int64)])
        capacity = self._cache.capacity
        # the JAX package's bound, with its 32-row bucket of the suffix, so
        # that both packages refuse the same turn (the port writes the
        # exact suffix)
        bucket = max(32, -(-len(suffix) // 32) * 32)
        if (self._cache_len + bucket + lvu.config.max_decode_tokens
                > capacity):
            raise RuntimeError(
                f"chat session KV reserve exhausted after {len(self.turns)} "
                f"turns (capacity {capacity}); start a new session or raise "
                "reserve_turns"
            )
        cos, sin = self._tables(len(full_ids))
        state = {
            "cos": cos,
            "sin": sin,
            "suffix_start": len(self._ids),
            "L": len(full_ids),
            "delta": self._delta,
            "ids": full_ids,
            "cache_len": self._cache_len,
        }
        timer = SpanTimer()
        with timer.span("e2e"):
            toks, cache, cache_len = lvu.engine._generate_from_cache(
                self._cache, state, max_new_tokens, self._eos(), timer=timer,
                **self._decode_kwargs(gen),
            )
        return full_ids, toks, cache, cache_len, timer

    def ask(self, question: str, max_new_tokens: Optional[int] = None,
            **gen) -> str:
        """The answer to `question` (greedy unless do_sample=True; sampling
        and streaming keywords as for LVU.generate). The first call runs
        the video prefill; later calls append only their own tokens."""
        turn = self._first_ask if self._cache is None else self._follow_up
        ids, toks, cache, cache_len, timer = turn(question, max_new_tokens,
                                                  gen)
        out = [int(t) for t in toks]
        # the cache holds ids + out[:-1]; the last token is never appended
        self._ids = np.concatenate([ids, np.asarray(out[:-1], np.int64)])
        self._tail = out[-1:]
        self._cache = cache
        self._cache_len = cache_len
        eos = set(self._eos())
        text = self.lvu.tokenizer.decode([t for t in out if t not in eos])
        self.turns.append({
            "question": question,
            "answer": text,
            "tokens": out,
            "timings": dict(timer.totals()),
        })
        return text

    # -- persistence --------------------------------------------------------

    def save(self, path: str) -> None:
        """The session (populated cache slots and all turn state) as one
        .npz in the JAX package's format, for `LVU.resume_chat` in a later
        process, of either package."""
        if self._cache is None:
            raise RuntimeError(
                "nothing to save: ask at least one question first"
            )
        cache = self._cache
        mesh = self.lvu.mesh
        hi = max(cache.lengths)

        def whole(t):
            # the populated slots of every tp rank's heads and sp window
            if t is None:
                return None
            if mesh is not None:
                t = all_gather(t, mesh.group("sp"), dim=2)
                t = all_gather(t, mesh.group("tp"), dim=1)
            return t[:, :, :hi]

        k, k_dtype = _pack(whole(cache.k))
        v, v_dtype = _pack(whole(cache.v))
        arrays = {
            "k": k,
            "v": v,
            "length": np.asarray(cache.lengths, np.int32),
            "ids": self._ids,
            "tail": np.asarray(self._tail, np.int64),
            "pos_prefix": np.asarray(self._pos_prefix),
        }
        for name in ("k_scale", "v_scale"):
            scale = whole(getattr(cache, name))
            if scale is not None:
                arrays[name] = scale.cpu().numpy()
        meta = {
            "version": SESSION_FORMAT_VERSION,
            "fingerprint": _session_fingerprint(self.lvu),
            "k_dtype": k_dtype,
            "v_dtype": v_dtype,
            "capacity": cache.capacity,
            "cache_len": int(self._cache_len),
            "delta": int(self._delta),
            "ss0": int(self._ss0),
            "reserve": int(self._reserve),
            "video_path": self.video_path,
            "turns": [
                {k2: v2 for k2, v2 in t.items() if k2 != "timings"}
                for t in self.turns
            ],
        }
        if mesh is None or mesh.is_first:
            # written whole, then renamed into place: under dp each
            # replica's first rank writes the same file, and a reader
            # sees one complete copy
            part = f"{path}.{os.getpid()}.part"
            with open(part, "wb") as f:
                np.savez(f, meta=json.dumps(meta), **arrays)
            os.replace(part, path)
        if mesh is not None and mesh.model_group is not None:
            torch.distributed.barrier(group=mesh.model_group)

    @classmethod
    def load(cls, lvu, path: str) -> "ChatSession":
        """Rebuild a saved session under `lvu`, whose config must match the
        saved fingerprint. The cache is allocated at the saved capacity on
        the device, the saved slots copied in and the rest zero."""
        refuse_pipeline(lvu)
        data = np.load(path, allow_pickle=False)
        meta = json.loads(str(data["meta"]))
        if meta["version"] != SESSION_FORMAT_VERSION:
            raise ValueError(
                f"session file version {meta['version']} != "
                f"{SESSION_FORMAT_VERSION}"
            )
        # JSON turns tuples into lists: compare both through it
        want = json.loads(json.dumps(_session_fingerprint(lvu)))
        got = meta["fingerprint"]
        if want != got:
            diff = {k: (got.get(k), want[k]) for k in want
                    if got.get(k) != want[k]}
            raise ValueError(
                "saved session's config does not match this LVU's "
                f"(saved, current): {diff}"
            )
        session = cls(lvu, meta["video_path"])
        session._reserve = meta["reserve"]
        # under context parallelism the capacity rounds up to the quantum,
        # as a fresh prefill's does; the added slots lie past every length
        quantum = lvu.engine.capacity_quantum
        capacity = -(-meta["capacity"] // quantum) * quantum

        def grow(a: torch.Tensor) -> torch.Tensor:
            # zero past the saved slots, on the host
            full = torch.zeros(a.shape[:2] + (capacity,) + a.shape[3:],
                               dtype=a.dtype)
            full[:, :, : a.shape[2]].copy_(a)
            return full

        def scale(name):
            return grow(torch.from_numpy(data[name])) if name in data else None

        cache = KVCache(
            k=grow(_unpack(data["k"], meta["k_dtype"])),
            v=grow(_unpack(data["v"], meta["v_dtype"])),
            lengths=[int(n) for n in data["length"]],
            k_scale=scale("k_scale"),
            v_scale=scale("v_scale"),
        )
        mesh = lvu.mesh
        if mesh is not None:  # this rank's heads and capacity window
            cache = shard_cache_cp(shard_cache(cache, mesh.index("tp"),
                                               mesh.tp),
                                   mesh.index("sp"), mesh.sp)

        def put(t):
            return None if t is None else t.to(lvu.device)

        session._cache = dataclasses.replace(
            cache, k=put(cache.k), v=put(cache.v),
            k_scale=put(cache.k_scale), v_scale=put(cache.v_scale))
        session._cache_len = meta["cache_len"]
        session._delta = meta["delta"]
        session._ss0 = meta["ss0"]
        session._ids = np.asarray(data["ids"], np.int64)
        session._tail = [int(t) for t in data["tail"]]
        session._pos_prefix = np.asarray(data["pos_prefix"])
        session.turns = list(meta["turns"])
        return session
