"""Batched offline QA: one video prefill shared by several questions.

Counterpart of quickvideo_tpu/prefill/batch.py:52-157. For the lmms-eval
shape (one video, many questions) the video prefill is the same for every
question, so it runs once, through LVUEngine.prefill (the single-request
path with every pruning mode). Each question then runs its suffix prefill
and decode through `_generate_from_cache` against a length-reset fork of
the shared cache: every append of the engine writes at a layer's current
length and attention reads a layer only up to its length plus the call's
rows, so putting the per-layer lengths (host ints) back to their
post-video values makes the cache, as read, equal to a fresh one; the
previous question's rows above them are overwritten by the next.

Every request of a batch must share the video geometry and the tokens up
to the video's end; the questions after it may differ in content and
length. Query-based predictors are refused (their prompt rides with every
group). Sampling works as in LVUEngine.generate.

Pipeline parallelism is refused (ValueError): the JAX engine's batched path
reads `cache.length` where its pp engine returns no cache (it raises
AttributeError there, ROADMAP C23).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from quickvideo_tpu_torch.prefill.engine import LVUEngine, PrefillInputs
from quickvideo_tpu_torch.utils.timing import SpanTimer


class BatchedQAEngine:
    """Shared-video-prefill amortizer over an LVUEngine."""

    def __init__(self, engine: LVUEngine):
        self.eng = engine
        if engine.lvu.mesh.pp > 1:
            raise ValueError(
                "batched QA does not support pipeline parallelism (mesh "
                f"pp={engine.lvu.mesh.pp}): the JAX package's batched path "
                "reads the cache that its pp engine keeps in the stages; run "
                "each question with generate, or batch with pp=1"
            )
        if engine.lvu.query_based:
            raise ValueError("batched mode does not support query-based "
                             "predictors (per-sample prompt appends)")

    def generate_batch(
        self,
        requests: Sequence[PrefillInputs],
        max_new_tokens: int,
        eos_token_ids: Sequence[int] = (),
        greedy: bool = True,
        temperature: float = 1.0,
        top_p: Optional[float] = None,
        top_k: Optional[int] = None,
    ) -> List[np.ndarray]:
        eng = self.eng
        if not requests:
            raise ValueError("generate_batch needs at least one request")
        ids_list = [np.asarray(r.input_ids) for r in requests]
        vid = np.nonzero(ids_list[0] == eng.cfg.video_token_id)[0]
        if len(vid) == 0:
            raise ValueError(
                "request 0 contains no video tokens "
                f"(video_token_id={eng.cfg.video_token_id}); batched QA "
                "shares one video prefill across requests"
            )
        ss = int(vid[-1]) + 1  # suffix start, shared

        def geometry(r):
            return (tuple(int(x) for x in r.video_grid_thw),
                    [tuple(int(x) for x in g) for g in r.group_grids])

        for r, ids in zip(requests, ids_list):
            if geometry(r) != geometry(requests[0]):
                raise ValueError("batch requires identical video geometry")
            if len(ids) < ss or not np.array_equal(ids[:ss], ids_list[0][:ss]):
                raise ValueError(
                    "batch requires identical tokens up to the video end"
                )

        # the shared prefill, with rotary tables for the longest request:
        # rows past the video are text positions, so every shorter question
        # reads a prefix of the same tables. Only request 0's pixels are
        # consumed.
        lens = [len(ids) for ids in ids_list]
        r0 = requests[0]
        cache, state0 = eng.prefill(PrefillInputs(
            input_ids=ids_list[int(np.argmax(lens))],
            video_grid_thw=r0.video_grid_thw,
            pixel_groups=r0.pixel_groups,
            group_grids=r0.group_grids,
            second_per_grid_ts=r0.second_per_grid_ts,
            native_hw=r0.native_hw,
        ), SpanTimer())
        shared = list(cache.lengths)
        result = []
        for ids in ids_list:
            cache.lengths[:] = shared  # the fork
            state = dict(state0, ids=ids, L=len(ids))
            toks, cache, _ = eng._generate_from_cache(
                cache, state, max_new_tokens, list(eos_token_ids),
                greedy=greedy, temperature=temperature, timer=SpanTimer(),
                top_p=top_p, top_k=top_k,
            )
            result.append(np.asarray(toks, np.int64))
        return result
