"""Batched QA in the PyTorch port against the JAX package's, on the tiny
preset in f32 with identical weights and inputs: BatchedQAEngine's tokens
equal the JAX BatchedQAEngine's and each request's own generate, under
norm pruning, a decay schedule and the cascade; sampling repeats with a
seed; mismatched requests and query-based predictors are refused; the
port's run_qa_eval_batched predicts as its run_qa_eval does."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quickvideo_tpu.prefill import LVUEngine as JEngine
from quickvideo_tpu.prefill import PrefillInputs as JInputs
from quickvideo_tpu.prefill.batch import BatchedQAEngine as JBatched
from quickvideo_tpu_torch.prefill import LVUEngine, PrefillInputs
from quickvideo_tpu_torch.prefill.batch import BatchedQAEngine

from test_torch_engine import CFG, TCFG, build_request, configs, params  # noqa: F401
from test_torch_images import _patch_readers

torch.set_num_threads(2)


def requests(cls, n=4):
    """n questions of different lengths on one video (the tokens up to the
    video's end shared)."""
    ids, grid, groups, grids = build_request()
    ss = int(np.nonzero(ids == CFG.video_token_id)[0][-1]) + 1
    rng = np.random.default_rng(9)
    return [cls(np.concatenate([ids[:ss], rng.integers(5, 900, 3 + 2 * i)])
                .astype(np.int64), grid, groups, grids, 2.0)
            for i in range(n)]


@pytest.mark.parametrize("kw", [
    dict(top_p=0.5),
    dict(top_p=None),
    dict(top_p=0.5, top_k_decay_type="linear"),
    dict(top_p=0.5, top_k_decay_type="linear",
         prefill_prune_starting_layer=1),
])
def test_batched_tokens_equal_jax_and_single_requests(params, kw):
    jp, tp = params
    jlvu, tlvu = configs(model_name_or_path="tiny", max_decode_tokens=8, **kw)
    jeng = JEngine(jp, CFG, jlvu, dtype=jnp.float32)
    eng = LVUEngine(tp, TCFG, tlvu, dtype=torch.float32)
    want = JBatched(jeng).generate_batch(requests(JInputs), 6)
    got = BatchedQAEngine(eng).generate_batch(requests(PrefillInputs), 6)
    single = [eng.generate(r, max_new_tokens=6).tokens
              for r in requests(PrefillInputs)]
    assert len(got) == len(want) == 4
    for g, w, s in zip(got, want, single):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, s)


def test_batched_sampling_repeats_with_a_seed(params):
    _, tp = params
    outs = []
    for _ in range(2):
        _, tlvu = configs(model_name_or_path="tiny", max_decode_tokens=8,
                          top_p=0.5, seed=3)
        eng = LVUEngine(tp, TCFG, tlvu, dtype=torch.float32)
        outs.append(BatchedQAEngine(eng).generate_batch(
            requests(PrefillInputs, 2), 6, greedy=False, temperature=0.8,
            top_p=0.95))
    for a, b in zip(*outs):
        assert 1 <= len(a) <= 6
        np.testing.assert_array_equal(a, b)
    # top_k=1 sampling is greedy decode
    greedy = BatchedQAEngine(eng).generate_batch(requests(PrefillInputs, 2), 6)
    top1 = BatchedQAEngine(eng).generate_batch(requests(PrefillInputs, 2), 6,
                                               greedy=False, top_k=1)
    for a, b in zip(greedy, top1):
        np.testing.assert_array_equal(a, b)


def test_batched_refusals(params):
    _, tp = params
    eng = LVUEngine(tp, TCFG, configs(model_name_or_path="tiny")[1],
                    torch.float32)
    reqs = requests(PrefillInputs, 2)
    bad = PrefillInputs(reqs[1].input_ids[1:], reqs[1].video_grid_thw,
                        reqs[1].pixel_groups, reqs[1].group_grids, 2.0)
    with pytest.raises(ValueError, match="identical tokens"):
        BatchedQAEngine(eng).generate_batch([reqs[0], bad], 2)
    other = PrefillInputs(reqs[1].input_ids, (3, 20, 20),
                          reqs[1].pixel_groups, [(2, 20, 20), (1, 20, 20)])
    with pytest.raises(ValueError, match="geometry"):
        BatchedQAEngine(eng).generate_batch([reqs[0], other], 2)
    with pytest.raises(ValueError, match="no video tokens"):
        BatchedQAEngine(eng).generate_batch(
            [PrefillInputs(np.arange(5, 20), (2, 20, 20), [], [])], 2)
    qeng = LVUEngine(tp, TCFG, configs(
        model_name_or_path="tiny",
        top_k_predict_type="query_attention_weights")[1], torch.float32)
    with pytest.raises(ValueError, match="query-based"):
        BatchedQAEngine(qeng)


def test_run_qa_eval_batched_predicts_as_run_qa_eval(params, monkeypatch):
    """The port's copy of evaluation/qa.py end to end on the fake video:
    two questions batched on one video predict what one request each
    predicts."""
    from quickvideo_tpu_torch.api import LVU
    from quickvideo_tpu_torch.evaluation.qa import (
        QASample,
        run_qa_eval,
        run_qa_eval_batched,
    )

    _, tp = params
    _patch_readers(monkeypatch)
    lvu = LVU(configs(model_name_or_path="tiny", model_type="qwen25_lvu",
                      num_frames=8, video_group_size=4, top_p=0.5,
                      max_decode_tokens=8, decode_output="yuv420",
                      dtype="float32")[1], params=tp, device="cpu")
    samples = [
        QASample("clip.mp4", "What color dominates?", ["A. red", "B. blue"],
                 "A", id="s1"),
        QASample("clip.mp4", "Is there any motion at all?",
                 ["A. yes", "B. no"], "B", id="s2"),
    ]
    ref = run_qa_eval(lvu, samples, max_new_tokens=4)
    got = run_qa_eval_batched(lvu, samples, max_new_tokens=4, batch_size=2)
    assert got["n"] == ref["n"] == 2
    assert ([p["raw"] for p in got["per_sample"]]
            == [p["raw"] for p in ref["per_sample"]])
    assert got["accuracy"] == ref["accuracy"]
