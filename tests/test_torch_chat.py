"""Chat sessions in the PyTorch port against the JAX package's, on the tiny
preset in f32 with identical weights and the same fake video reader: the
tokens of every turn and the cache lengths after it, on the bf16 (here
f32), int8 and int8k caches; sessions saved by one package resume in the
other with the same next answer; a follow-up equals the from-scratch
request over the whole history; and the refusals (a config fingerprint
mismatch, an exhausted reserve, query-dependent pruning)."""

import contextlib

import numpy as np
import pytest
import torch

import jax

from quickvideo_tpu.api import LVU as JLVU
from quickvideo_tpu_torch.api import LVU as TLVU

from test_torch_engine import configs, params  # noqa: F401
from test_torch_images import _patch_readers

torch.set_num_threads(2)

QUESTIONS = ("Describe the video.", "What else?", "And then?", "Why?")


@contextlib.contextmanager
def jax_kernel_route(on: bool, monkeypatch):
    """The JAX engine on its kernel route in interpret mode (the int8
    caches' numerics the port follows), restored after the block."""
    if on:
        monkeypatch.setenv("QV_PALLAS_INTERPRET", "1")
        jax.clear_caches()
    try:
        yield
    finally:
        if on:
            monkeypatch.delenv("QV_PALLAS_INTERPRET")
            jax.clear_caches()


def make_pair(params, monkeypatch, **kw):
    """(JAX LVU, port LVU) over the same weights and config, with both
    packages' video decoders replaced by the same fake."""
    jp, tp = params
    _patch_readers(monkeypatch)
    kv = kw.get("kv_cache_dtype", "bfloat16")
    jcfg, tcfg = configs(
        model_name_or_path="tiny", model_type="qwen25_lvu_interleaved",
        num_frames=8, video_group_size=4, top_p=0.5, max_decode_tokens=8,
        decode_output="yuv420", dtype="float32",
        attention_impl="auto" if kv == "bfloat16" else "pallas", **kw,
    )
    return JLVU(jcfg, params=jp), TLVU(tcfg, params=tp, device="cpu")


def cache_lengths(session):
    c = session._cache
    return (list(c.lengths) if hasattr(c, "lengths")
            else np.asarray(c.length).tolist())


@pytest.mark.parametrize("kv", ["bfloat16", "int8", "int8k"])
def test_turns_equal_the_jax_sessions(params, monkeypatch, kv):
    jlvu, lvu = make_pair(params, monkeypatch, kv_cache_dtype=kv)
    with jax_kernel_route(kv != "bfloat16", monkeypatch):
        js = jlvu.start_chat("clip.mp4", reserve_turns=4)
        want = []
        for i, q in enumerate(QUESTIONS[:3]):
            answer = js.ask(q, max_new_tokens=4 + i)
            want.append((answer, js.turns[-1]["tokens"], js._cache_len,
                         cache_lengths(js)))
    ts = lvu.start_chat("clip.mp4", reserve_turns=4)
    for i, q in enumerate(QUESTIONS[:3]):
        answer = ts.ask(q, max_new_tokens=4 + i)
        got = (answer, ts.turns[-1]["tokens"], ts._cache_len,
               cache_lengths(ts))
        assert got == want[i], (i, got, want[i])
    assert ts._cache.capacity == int(js._cache.k.shape[2])
    assert ts._cache.quantized == {"bfloat16": False, "int8": True,
                                   "int8k": "k"}[kv]
    # follow-ups run no vision: their spans hold no frame decode or tower
    for turn in ts.turns[1:]:
        assert "vision" not in turn["timings"]
        assert "final_prefill" in turn["timings"]


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("saver", ["jax", "port"])
def test_saved_sessions_resume_across_packages(params, monkeypatch, tmp_path,
                                               kv, saver):
    """A session saved after two turns by one package, resumed by the
    other: the third answer equals the uninterrupted session's."""
    jlvu, lvu = make_pair(params, monkeypatch, kv_cache_dtype=kv)
    path = str(tmp_path / "session.npz")
    with jax_kernel_route(kv != "bfloat16", monkeypatch):
        js = jlvu.start_chat("clip.mp4", reserve_turns=4)
        for q in QUESTIONS[:2]:
            js.ask(q, max_new_tokens=5)
        if saver == "jax":
            js.save(path)
        third = js.ask(QUESTIONS[2], max_new_tokens=5)
        want = js.turns[-1]["tokens"]
    ts = lvu.start_chat("clip.mp4", reserve_turns=4)
    for q in QUESTIONS[:2]:
        ts.ask(q, max_new_tokens=5)
    if saver == "port":
        ts.save(path)
        with jax_kernel_route(kv != "bfloat16", monkeypatch):
            resumed = jlvu.resume_chat(path)
            assert resumed.ask(QUESTIONS[2], max_new_tokens=5) == third
            assert resumed.turns[-1]["tokens"] == want
    else:
        resumed = lvu.resume_chat(path)
        assert len(resumed.turns) == 2
        assert resumed.ask(QUESTIONS[2], max_new_tokens=5) == third
        assert resumed.turns[-1]["tokens"] == want
        assert resumed._cache.capacity == ts._cache.capacity
    # the live port session answers the same
    assert ts.ask(QUESTIONS[2], max_new_tokens=5) == third


def test_int8k_session_round_trips_in_the_port(params, monkeypatch,
                                               tmp_path):
    """An int8k cache (int8 K only) saves its K scales alone and resumes
    with them; the JAX package cannot save such a session (ROADMAP C15)."""
    jlvu, lvu = make_pair(params, monkeypatch, kv_cache_dtype="int8k")
    ts = lvu.start_chat("clip.mp4", reserve_turns=4)
    ts.ask(QUESTIONS[0], max_new_tokens=5)
    path = str(tmp_path / "k.npz")
    ts.save(path)
    data = np.load(path)
    assert "k_scale" in data and "v_scale" not in data
    assert data["v"].dtype == np.float32 and data["k"].dtype == np.int8
    third = ts.ask(QUESTIONS[1], max_new_tokens=5)
    resumed = lvu.resume_chat(path)
    assert resumed._cache.quantized == "k"
    assert resumed.ask(QUESTIONS[1], max_new_tokens=5) == third
    with jax_kernel_route(True, monkeypatch):
        js = jlvu.start_chat("clip.mp4", reserve_turns=4)
        js.ask(QUESTIONS[0], max_new_tokens=5)
        with pytest.raises(TypeError):
            js.save(str(tmp_path / "jax_k.npz"))


def test_follow_up_equals_the_full_history_request(params, monkeypatch):
    """Turn 2 answered incrementally gives the tokens, and within f32
    rounding the final-prefill logits, of one request over the whole
    history (turn 1's ids and answer and turn 2's template and question)
    on the same frames."""
    from quickvideo_tpu_torch.video import reader as treader

    _, lvu = make_pair(params, monkeypatch)
    eng = lvu.engine
    session = lvu.start_chat("clip.mp4", reserve_turns=4)
    session.ask(QUESTIONS[0], max_new_tokens=6)
    logits = []
    final_prefill = eng.final_prefill
    monkeypatch.setattr(eng, "final_prefill", lambda *a, **k: logits.append(
        final_prefill(*a, **k)) or logits[-1])
    session.ask(QUESTIONS[1], max_new_tokens=6)
    monkeypatch.setattr(eng, "final_prefill", final_prefill)
    t2 = session.turns[1]["tokens"]
    history = session._ids[: len(session._ids) - (len(t2) - 1)]
    frames, plan, _ = treader.decode_video_batch("clip.mp4", lvu.config)

    def inputs():
        return treader.build_prefill_inputs_from_frames(frames, plan,
                                                        history)

    res = eng.generate(inputs(), max_new_tokens=6)
    assert res.tokens.tolist() == t2
    assert res.cache_length == session._cache_len
    cache, state = eng.prefill(inputs())
    full = eng.final_prefill(cache, state)
    rel = ((logits[0] - full).norm() / full.norm()).item()
    assert rel <= 1e-5, rel


def test_sampled_and_streamed_turns(params, monkeypatch):
    """ask forwards sampling and streaming: top_k=1 sampling answers as
    greedy decode, and the streamed chunks make up the turn's tokens."""
    _, lvu = make_pair(params, monkeypatch)
    greedy = lvu.start_chat("clip.mp4", reserve_turns=4)
    sampled = lvu.start_chat("clip.mp4", reserve_turns=4)
    for q in QUESTIONS[:2]:
        chunks = []
        a = greedy.ask(q, max_new_tokens=5)
        b = sampled.ask(q, max_new_tokens=5, do_sample=True, top_k=1,
                        on_tokens=chunks.append)
        assert a == b
        assert sum(chunks, []) == sampled.turns[-1]["tokens"]


def test_refusals(params, monkeypatch, tmp_path):
    _, lvu = make_pair(params, monkeypatch)
    session = lvu.start_chat("clip.mp4", reserve_turns=0)
    with pytest.raises(RuntimeError, match="ask at least one"):
        session.save(str(tmp_path / "never.npz"))
    session.ask(QUESTIONS[0], max_new_tokens=4)
    path = str(tmp_path / "s.npz")
    session.save(path)
    # another pruning ratio: the saved KV means something else
    other = TLVU(lvu.config.replace(top_p=0.25), params=lvu.params,
                 device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        other.resume_chat(path)
    # the occupancy forced to the capacity edge
    session._cache_len = session._cache.capacity
    with pytest.raises(RuntimeError, match="reserve exhausted"):
        session.ask(QUESTIONS[1], max_new_tokens=4)
    for kw in (dict(top_k_predict_type="query_attention_weights"),
               dict(do_top_k_for_query=True)):
        qlvu = TLVU(lvu.config.replace(**kw), params=lvu.params,
                    device="cpu")
        with pytest.raises(ValueError, match="query-based"):
            qlvu.start_chat("clip.mp4")
