"""Multiple-choice video-QA evaluation.

The port's copy of quickvideo_tpu/evaluation/qa.py (standard library only
at module level), its lazy imports pointed at the port;
tests/test_torch_copies.py pins it to the original by behaviour. Frames
come from `engines.qwen25._fetch_frames` (no disk frame cache). The
lmms-eval model registers as "quickvideo_tpu_torch".

Standalone runner with the benchmark conventions of the reference's eval
suite (VideoMME / LongVideoBench / LVBench / MLVU, reference
README.md:398-412): one video + MC question per sample, accuracy = exact
letter match after robust answer extraction. The reference threads LVU
options through lmms-eval model args (`adaptive_local_attention=True,
local_attention_group_size=16, top_k=64, predict_type=key_norms_small`);
here the LVU config is first-class.

When `lmms_eval` is installed, `register_lmms_model()` exposes the engine as
an lmms-eval model named "quickvideo_tpu_torch" so the reference's exact eval
commands port over; without it, `run_qa_eval` evaluates any iterable of
QASample (JSON-lines loader included) with DP sharding across processes left
to the caller (the reference's accelerate launch does the same —
communication-free eval DP).
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence


@dataclass
class QASample:
    video: str
    question: str
    options: Sequence[str]  # ["A. ...", "B. ...", ...] or bare texts
    answer: str  # "A" | "B" | ...
    id: Optional[str] = None
    meta: dict = field(default_factory=dict)


MC_PROMPT = (
    "Select the best answer to the following multiple-choice question based "
    "on the video. Respond with only the letter (A, B, C, or D) of the "
    "correct option.\n{question}\n{options}\nThe best answer is:"
)


def format_mc_question(sample: QASample) -> str:
    opts = []
    for i, o in enumerate(sample.options):
        letter = chr(ord("A") + i)
        o = str(o)
        opts.append(o if re.match(r"^[A-Z][.)]", o) else f"{letter}. {o}")
    return MC_PROMPT.format(question=sample.question, options="\n".join(opts))


def extract_choice(text: str, n_options: int = 4) -> Optional[str]:
    """Robust letter extraction (answer-matching conventions of the
    benchmark suites: leading letter, 'answer is X', parenthesized, etc.)."""
    letters = "".join(chr(ord("A") + i) for i in range(n_options))
    t = text.strip()
    m = re.match(rf"^\(?([{letters}])\)?[.):\s]", t + " ")
    if m:
        return m.group(1)
    m = re.search(rf"answer is\s*:?\s*\(?([{letters}])\)?", t, re.I)
    if m:
        return m.group(1).upper()
    m = re.search(rf"\(([{letters}])\)", t)
    if m:
        return m.group(1)
    m = re.search(rf"\b([{letters}])\b", t)
    if m:
        return m.group(1)
    return None


def load_jsonl(path: str) -> List[QASample]:
    out = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            d = json.loads(line)
            out.append(
                QASample(
                    video=d["video"],
                    question=d["question"],
                    options=d["options"],
                    answer=d["answer"],
                    id=d.get("id"),
                    meta=d.get("meta", {}),
                )
            )
    return out


def shard_samples(samples, rank: Optional[int] = None,
                  world: Optional[int] = None):
    """Communication-free eval data parallelism: each process takes every
    world-th sample (the reference achieves the same with `accelerate launch
    --num_processes 8`, README.md:405). Rank/world default from env
    (QV_RANK/QV_WORLD or accelerate's RANK/WORLD_SIZE)."""
    import os

    rank = rank if rank is not None else int(
        os.environ.get("QV_RANK", os.environ.get("RANK", "0"))
    )
    world = world if world is not None else int(
        os.environ.get("QV_WORLD", os.environ.get("WORLD_SIZE", "1"))
    )
    return [s for i, s in enumerate(samples) if i % world == rank]


def run_qa_eval(
    lvu,
    samples: Iterable[QASample],
    max_new_tokens: int = 16,
    verbose: bool = False,
) -> Dict:
    """Evaluate; returns {"accuracy", "n", "per_sample"}."""
    n = 0
    correct = 0
    per_sample = []
    for s in samples:
        prompt = format_mc_question(s)
        out = lvu.generate(prompt, s.video, max_new_tokens=max_new_tokens)
        pred = extract_choice(out[0], n_options=len(s.options))
        ok = pred == s.answer
        n += 1
        correct += int(ok)
        per_sample.append(
            {"id": s.id, "pred": pred, "answer": s.answer, "correct": ok,
             "raw": out[0][:200]}
        )
        if verbose:
            print(f"[{n}] pred={pred} gold={s.answer} ok={ok}")
    return {
        "accuracy": correct / max(n, 1),
        "n": n,
        "per_sample": per_sample,
    }


def run_qa_eval_batched(
    lvu,
    samples: Iterable[QASample],
    max_new_tokens: int = 16,
    batch_size: int = 8,
    verbose: bool = False,
) -> Dict:
    """Batched evaluation: questions that share a video prefill it ONCE
    and fork the pruned cache per question (quickvideo_tpu_torch.prefill.batch)
    — the throughput analogue of the reference's 8-process `accelerate
    launch` eval sharding (reference README.md:398-412), without extra
    hosts (4.7x/question at 4 questions/video measured).

    Samples are grouped by video path; each video's frames decode once and
    its questions batch up to `batch_size` at a time."""
    from collections import defaultdict

    from quickvideo_tpu_torch.engines.qwen25 import _fetch_frames
    from quickvideo_tpu_torch.prefill.batch import BatchedQAEngine
    from quickvideo_tpu_torch.tokenization import build_chat_ids
    from quickvideo_tpu_torch.utils.timing import SpanTimer
    from quickvideo_tpu_torch.video import reader as vreader

    by_video = defaultdict(list)
    for s in samples:
        by_video[s.video].append(s)

    beng = BatchedQAEngine(lvu.engine)
    eos = [lvu.tokenizer.eos_token_id]
    n = 0
    correct = 0
    per_sample = []
    for video, group in by_video.items():
        timer = SpanTimer()
        frames, plan, native_hw = _fetch_frames(lvu, video, timer)
        n_video_tokens = sum(plan.tokens_per_group)
        for i in range(0, len(group), batch_size):
            chunk = group[i : i + batch_size]
            reqs = []
            for s in chunk:
                ids = build_chat_ids(
                    lvu.tokenizer, lvu.model_config,
                    format_mc_question(s), n_video_tokens,
                )
                reqs.append(vreader.build_prefill_inputs_from_frames(
                    frames, plan, ids, native_hw=native_hw
                ))
            token_lists = beng.generate_batch(
                reqs, max_new_tokens, eos_token_ids=eos
            )
            for s, toks in zip(chunk, token_lists):
                try:
                    text = lvu.tokenizer.decode(
                        [int(t) for t in toks], skip_special_tokens=True
                    )
                except TypeError:  # FallbackTokenizer has no HF kwargs
                    text = lvu.tokenizer.decode([int(t) for t in toks])
                pred = extract_choice(text, n_options=len(s.options))
                ok = pred == s.answer
                n += 1
                correct += int(ok)
                per_sample.append(
                    {"id": s.id, "pred": pred, "answer": s.answer,
                     "correct": ok, "raw": text[:200]}
                )
                if verbose:
                    print(f"[{n}] pred={pred} gold={s.answer} ok={ok}")
    return {
        "accuracy": correct / max(n, 1),
        "n": n,
        "per_sample": per_sample,
    }


def register_lmms_model():  # pragma: no cover - optional integration
    """Register as an lmms-eval model when that package is available, so the
    reference's eval commands (README.md:398-412) work against this engine."""
    try:
        from lmms_eval.api.model import lmms
        from lmms_eval.api.registry import register_model
    except ImportError as e:
        raise ImportError(
            "lmms_eval is not installed; use run_qa_eval for standalone eval"
        ) from e

    from quickvideo_tpu_torch.api import LVU
    from quickvideo_tpu_torch.config import LVUConfig

    @register_model("quickvideo_tpu_torch")
    class QuickVideoTPU(lmms):
        def __init__(self, pretrained="qwen25-vl-7b", model_type="qwen25_lvu",
                     video_group_size=16, top_k=64,
                     predict_type="key_norms_small", **kw):
            super().__init__()
            self.lvu = LVU(LVUConfig(
                model_name_or_path=pretrained,
                model_type=model_type,
                video_group_size=int(video_group_size),
                top_k=int(top_k) if top_k else None,
                top_k_predict_type=predict_type,
            ))

        def generate_until(self, requests):
            out = []
            for req in requests:
                ctx, gen_kwargs, doc_to_visual, doc_id, task, split = req.args
                video = self._visual_to_video(
                    doc_to_visual(self.task_dict[task][split][doc_id])
                )
                out.append(
                    self.lvu.generate(
                        ctx, video,
                        max_new_tokens=gen_kwargs.get("max_new_tokens", 16),
                    )[0]
                )
            return out

        @staticmethod
        def _visual_to_video(visual):
            """doc_to_visual convention: a list (possibly empty for
            text-only docs), a single path, or None."""
            if isinstance(visual, list):
                return visual[0] if visual else None
            return visual

        def loglikelihood(self, requests):
            """Teacher-forced option scoring. Consecutive requests with the
            same (doc, context) — the multiple-choice pattern: N option
            continuations per doc — share ONE grouped video prefill via
            LVU.loglikelihood_multi; the cache rewinds between options, so
            a 4-option doc costs ~(1 prefill + 4 suffix passes) instead of
            4 full prefills. Only the per-option (logprob, is_greedy)
            scalars cross the transport."""
            out = []
            i = 0
            while i < len(requests):
                ctx, _, doc_to_visual, doc_id, task, split = (
                    requests[i].args
                )
                j = i
                conts = []
                while j < len(requests):
                    c2, cont, _, d2, t2, s2 = requests[j].args
                    if (c2, d2, t2, s2) != (ctx, doc_id, task, split):
                        break
                    doc = self.task_dict[t2][s2][d2]
                    if callable(cont):  # doc_to_target convention
                        cont = cont(doc)
                    conts.append(cont)
                    j += 1
                doc = self.task_dict[task][split][doc_id]
                video = self._visual_to_video(doc_to_visual(doc))
                out.extend(
                    self.lvu.loglikelihood_multi(ctx, video, conts)
                )
                i = j
            return out

        def generate_until_multi_round(self, requests):
            """Multi-round generation: one ChatSession per doc — the video
            KV prefills once and every later round appends incrementally
            (quickvideo_tpu_torch.chat.ChatSession), instead of the reference's
            full re-prefill per round. Only ONE session stays resident: a
            session's pruned video cache is hundreds of MB at 7B scale, so
            keeping one per doc would OOM the chip within a few docs; when
            the requests revisit an earlier doc out of order, its video
            simply re-prefills."""
            out = []
            cur_key, cur_session = None, None
            for req in requests:
                ctx, gen_kwargs, doc_to_visual, doc_id, task, split = req.args
                key = (task, split, doc_id)
                if key != cur_key:
                    cur_session = None  # drop the previous doc's KV cache
                    doc = self.task_dict[task][split][doc_id]
                    video = self._visual_to_video(doc_to_visual(doc))
                    cur_session = self.lvu.start_chat(video)
                    cur_key = key
                out.append(cur_session.ask(
                    ctx,
                    max_new_tokens=gen_kwargs.get("max_new_tokens", 16),
                ))
            return out

    return QuickVideoTPU
