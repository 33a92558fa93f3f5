"""The port's copies of the JAX package's jax-free modules (the port imports
nothing of that package) against their originals, by behaviour: configs and
presets field by field, the resolution rules over grids of inputs, the video
plan over frame counts, rates and sizes, the chat token ids, the patch
normalization, the reader's plan and backend choice, the disk frame cache
(video/frame_cache.py: its keys, and entries written by either package
read by the other), and the QA evaluation helpers (evaluation/qa.py; its
dropped gen_kwargs, ROADMAP C3, are kept as they are and not compared)."""

import dataclasses
import itertools
import json

import numpy as np
import pytest

from quickvideo_tpu import config as jcfg
from quickvideo_tpu import tokenization as jtok
from quickvideo_tpu.evaluation import qa as jqa
from quickvideo_tpu.video import frame_cache as jfc
from quickvideo_tpu.models.qwen25_vl import config as jmc
from quickvideo_tpu.video import preprocess as jpp
from quickvideo_tpu.video import quickdecode as jqd
from quickvideo_tpu.video import reader as jreader
from quickvideo_tpu_torch import config as tcfg
from quickvideo_tpu_torch import tokenization as ttok
from quickvideo_tpu_torch.evaluation import qa as tqa
from quickvideo_tpu_torch.models.qwen25_vl import config as tmc
from quickvideo_tpu_torch.video import cv2_reader as tcv2
from quickvideo_tpu_torch.video import frame_cache as tfc
from quickvideo_tpu_torch.video import preprocess as tpp
from quickvideo_tpu_torch.video import quickdecode as tqd
from quickvideo_tpu_torch.video import reader as treader

PRESETS = sorted(jmc.PRESETS)


def outcome(fn, *args, **kw):
    """fn's result, or the type of the exception it raises."""
    try:
        return fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 - compared, not handled
        return type(e)


def assert_same_arrays(a, b):
    """Equal nested tuples / lists of arrays and scalars."""
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same_arrays(x, y)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", PRESETS + ["Qwen/Qwen2.5-VL-7B-Instruct"])
def test_every_preset_has_the_same_fields(name):
    assert sorted(tmc.PRESETS) == PRESETS
    assert dataclasses.asdict(tmc.get_config(name)) == dataclasses.asdict(
        jmc.get_config(name)
    )
    t, j = tmc.get_config(name), jmc.get_config(name)
    assert (t.text.head_dim, t.text.num_kv_groups, t.vision.head_dim) == (
        j.text.head_dim, j.text.num_kv_groups, j.vision.head_dim
    )


def test_hf_config_dicts_and_unknown_names_resolve_alike(tmp_path):
    raw = {"vision_config": {"depth": 2, "hidden_size": 64},
           "hidden_size": 128, "num_hidden_layers": 2,
           "num_attention_heads": 4, "num_key_value_heads": 2,
           "vocab_size": 999}
    assert dataclasses.asdict(tmc.config_from_hf_dict(raw, "x")) == (
        dataclasses.asdict(jmc.config_from_hf_dict(raw, "x"))
    )
    for mod in (tmc, jmc):
        with pytest.raises(ValueError, match="Unknown model preset"):
            mod.get_config(str(tmp_path / "nothing"))


LVU_KWARGS = [
    {},
    {"top_k_predict_type": "query_attention_weights", "top_p": 0.3},
    {"top_k_decay_type": "linear", "top_k": 100},
    {"top_k_decay_type": "exponential", "top_k_decay_factor": 0.8},
    {"mesh": {"tp": 2, "sp": 2}, "kv_cache_dtype": "int8k"},
    {"prefill_prune_starting_layer": 3, "reference_query_mask": True},
]


@pytest.mark.parametrize("kw", LVU_KWARGS)
def test_lvu_config_builds_alike(kw):
    t, j = tcfg.LVUConfig(**kw), jcfg.LVUConfig(**kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.needs_attn_stats == j.needs_attn_stats
    assert dataclasses.asdict(t.replace(seed=3)) == dataclasses.asdict(
        j.replace(seed=3)
    )
    layer = dict(layer_idx=4, total_layers=8)
    assert dataclasses.asdict(tcfg.LVULayerConfig(lvu_config=t, **layer)) == (
        dataclasses.asdict(jcfg.LVULayerConfig(lvu_config=j, **layer))
    )


def test_predictor_sets_and_rejections_are_the_same():
    for name in ("ATTN_STATS_PREDICTORS", "QUERY_PREDICTORS", "ALL_PREDICTORS"):
        assert getattr(tcfg, name) == getattr(jcfg, name)
    assert len(tcfg.ALL_PREDICTORS) == 19
    for bad in ({"top_k_predict_type": "nope"}, {"kv_cache_dtype": "fp8"}):
        for mod in (tcfg, jcfg):
            with pytest.raises(ValueError, match="Unknown"):
                mod.LVUConfig(**bad)
    for dt in ("bfloat16", "int8", "int8k"):
        assert tcfg.kv_quant_mode(dt) == jcfg.kv_quant_mode(dt)
    for mod in (tcfg, jcfg):
        with pytest.raises(ValueError, match="auto"):
            mod.kv_quant_mode("auto")


def test_resolve_effective_top_k_agrees_over_a_grid():
    grid = itertools.product(
        (None, 0, 7, 300),  # top_k
        (None, 0.0, 0.25, 0.5, 1.0),  # top_p
        (None, "linear", "exponential"),  # decay
        (None, 0, 2),  # top_k_starting_layer
        (True, False),  # enable
    )
    for top_k, top_p, decay, start, enable in grid:
        kw = dict(top_k=top_k, top_p=top_p, top_k_decay_type=decay,
                  top_k_starting_layer=start, enable=enable)
        t, j = tcfg.LVUConfig(**kw), jcfg.LVUConfig(**kw)
        for li, q_len in itertools.product((0, 1, 5, 27), (1, 64, 3600)):
            assert outcome(tcfg.resolve_effective_top_k, t, li, 28, q_len) == (
                outcome(jcfg.resolve_effective_top_k, j, li, 28, q_len)
            ), (kw, li, q_len)


def test_resolve_auto_kv_dtype_agrees_over_a_grid():
    for name in PRESETS:
        tt, jt = tmc.get_config(name).text, jmc.get_config(name).text
        for cap, wb, hbm, item in itertools.product(
            (4096, 65536, 65537, 131072), (0, 15 << 30, 70 << 30),
            (16 << 30, 80 << 30), (2, 4),
        ):
            assert tcfg.resolve_auto_kv_dtype(cap, tt, wb, hbm, item) == (
                jcfg.resolve_auto_kv_dtype(cap, jt, wb, hbm, item)
            )


def test_plan_video_agrees_over_frame_counts_rates_and_sizes():
    grid = itertools.product(
        (1, 7, 64, 1000, 86400),  # total frames
        (1.0, 23.976, 30.0),  # video fps
        ((224, 224), (1080, 1920), (360, 420), (101, 3000)),  # source size
        (None, 4, 31, 32),  # group size in frames
        ((32, None), (None, 2.0), (None, 0.5)),  # (nframes, fps)
        (None, 360 * 420, 1024 * 28 * 28),  # requested max pixels
        (None, 112),  # align_to
    )
    for total, vfps, (h, w), gsz, (nf, fps), mx, align in grid:
        kw = dict(total_frames=total, video_fps=vfps, height=h, width=w,
                  video_group_size=gsz, nframes=nf, fps=fps,
                  requested_max_pixels=mx, align_to=align)
        try:
            j = jpp.plan_video(**kw)
        except ValueError:
            with pytest.raises(ValueError):
                tpp.plan_video(**kw)
            continue
        t = tpp.plan_video(**kw)
        ta, ja = dataclasses.asdict(t), dataclasses.asdict(j)
        np.testing.assert_array_equal(ta.pop("indices"), ja.pop("indices"))
        assert ta == ja, kw
        assert t.grid_thw == j.grid_thw
        assert t.tokens_per_group == j.tokens_per_group


def test_frame_helpers_agree():
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (4, 3, 56, 84), dtype=np.uint8)
    for fn in ("normalize_frames", "patchify_frames", "patchify_frames_uint8",
               "patch_norm_scale_bias"):
        args = () if fn == "patch_norm_scale_bias" else (frames,)
        assert_same_arrays(getattr(tpp, fn)(*args), getattr(jpp, fn)(*args))
    np.testing.assert_array_equal(
        tpp.resize_frames_bicubic(frames, 28, 56),
        jpp.resize_frames_bicubic(frames, 28, 56),
    )
    assert tpp.yuv420_frame_bytes(420, 420) == jpp.yuv420_frame_bytes(420, 420)


@pytest.mark.parametrize("name", ["tiny", "qwen25-vl-7b"])
def test_chat_ids_are_the_same(name):
    tc, jc = tmc.get_config(name), jmc.get_config(name)
    tt, jt = ttok.load_tokenizer("", tc), jtok.load_tokenizer("", jc)
    assert type(tt).__name__ == type(jt).__name__ == "FallbackTokenizer"
    for q, n_vid in (("What happens?", 0), ("Which objects move, when?", 256),
                     ("", 3600)):
        np.testing.assert_array_equal(
            ttok.build_chat_ids(tt, tc, q, n_vid),
            jtok.build_chat_ids(jt, jc, q, n_vid),
        )
    messages = [
        {"role": "system", "content": "Be brief."},
        {"role": "user", "content": [
            {"type": "image", "image": "a.png"},
            {"type": "video", "video": "v.mp4"},
            {"type": "text", "text": "Compare them."},
        ]},
        {"role": "assistant", "content": "A cat."},
        {"role": "user", "content": "And then?"},
    ]
    np.testing.assert_array_equal(
        ttok.build_chat_ids_from_messages(tt, tc, messages, 64, (16,)),
        jtok.build_chat_ids_from_messages(jt, jc, messages, 64, (16,)),
    )
    ids = ttok.build_chat_ids(tt, tc, "héllo", 4)
    assert tt.decode(ids.tolist()) == jt.decode(ids.tolist())
    assert tt.eos_token_id == jt.eos_token_id


class _Reader:
    def __init__(self, n, fps, h, w):
        self._n, self._fps = n, fps
        self.source_height, self.source_width = h, w

    def __len__(self):
        return self._n

    def get_fps(self):
        return self._fps


@pytest.mark.parametrize("kw", LVU_KWARGS[:2] + [
    {"fps": 1.0, "num_frames": None, "video_group_size": 8},
    {"num_frames": 64, "video_group_size": 32,
     "extra_kwargs": {"max_pixels": 448 * 448}, "align_resize_to_window": True},
])
def test_reader_plans_and_backends_agree(kw, monkeypatch):
    reader = _Reader(900, 30.0, 720, 1280)
    t = treader.plan_from_reader(reader, tcfg.LVUConfig(**kw))
    j = jreader.plan_from_reader(reader, jcfg.LVUConfig(**kw))
    np.testing.assert_array_equal(t.indices, j.indices)
    assert t.group_grids == j.group_grids and t.sample_fps == j.sample_fps
    assert tqd.is_available() == jqd.is_available()
    assert tcv2.is_available() == (jreader._ilu.find_spec("cv2") is not None)
    monkeypatch.setenv("FORCE_QWENVL_VIDEO_READER", "opencv")
    assert treader.backend_priority() == jreader.backend_priority()
    monkeypatch.delenv("FORCE_QWENVL_VIDEO_READER")
    if tqd.is_available() or tcv2.is_available():
        assert treader.backend_priority() == jreader.backend_priority()


def test_prefill_inputs_from_frames_are_the_ports():
    from quickvideo_tpu_torch.prefill import PrefillInputs

    plan = tpp.plan_video(total_frames=8, video_fps=4.0, height=56, width=56,
                          video_group_size=4, nframes=8)
    frames = np.zeros((8, 3, plan.resized_height, plan.resized_width),
                      np.uint8)
    inputs = treader.build_prefill_inputs_from_frames(
        frames, plan, np.arange(5), native_hw=None
    )
    assert isinstance(inputs, PrefillInputs)
    assert [len(g) for g in inputs.pixel_groups] == plan.group_frame_counts


def test_vision_tiling_rule_agrees_over_spans_and_lengths():
    """The route choice's tiling rule (ops/vision_attention.py's copy of
    `_spans_per_tile` and `kernel_applicable`), over the spans the 7B
    layouts give (windows of 4-64 rows, frames up to a 1080p image's) and
    span counts around them."""
    from quickvideo_tpu.ops import vision_attention as jva
    from quickvideo_tpu_torch.ops import vision_attention as tva

    spans = [1, 4, 8, 12, 16, 24, 36, 48, 64, 100, 128, 900, 1024, 1280,
             1536, 1564, 2304, 4784, 10764]
    for span, nspan in itertools.product(spans, [1, 2, 3, 5, 7, 12, 20, 30]):
        assert tva._spans_per_tile(nspan, span) == jva._spans_per_tile(
            nspan, span
        ), (span, nspan)
        for s_len in (span * nspan, span * nspan + 4):
            for masked in (False, True):
                assert tva.kernel_applicable(s_len, span, masked) == (
                    jva.kernel_applicable(s_len, span, masked)
                ), (s_len, span, masked)


# -- evaluation/qa.py ---------------------------------------------------------

EXTRACT_CASES = [
    "A", "(B)", "C.", "D) because", "  b: yes", "The answer is C",
    "the answer is: (d)", "I think (B) is right", "maybe A or B", "E",
    "Answer: none", "", "option b", "ANSWER IS a", "x (C) y (A)", "AB",
    "B\nA", "answer is E", "(e)", "D.", "c) no",
]


@pytest.mark.parametrize("n_options", [2, 4, 5])
def test_extract_choice_agrees(n_options):
    for text in EXTRACT_CASES:
        assert tqa.extract_choice(text, n_options) == jqa.extract_choice(
            text, n_options), text


@pytest.mark.parametrize("options", [
    ["red", "blue"], ["A. red", "B) blue", "green", "D. x"],
    ["a. lower", "(B) paren"], [],
])
def test_format_mc_question_agrees(options):
    for question in ("What color?", "Q with {braces}\nand lines"):
        kw = dict(video="v.mp4", question=question, options=options,
                  answer="A", id="1")
        assert tqa.format_mc_question(tqa.QASample(**kw)) == (
            jqa.format_mc_question(jqa.QASample(**kw)))
    assert tqa.MC_PROMPT == jqa.MC_PROMPT


def test_load_jsonl_agrees(tmp_path):
    path = tmp_path / "qa.jsonl"
    rows = [
        {"video": "a.mp4", "question": "q1", "options": ["x", "y"],
         "answer": "A"},
        {"video": "b.mp4", "question": "q2", "options": ["A. x", "B. y"],
         "answer": "B", "id": "7", "meta": {"task": "mlvu"}},
    ]
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    got = tqa.load_jsonl(str(path))
    want = jqa.load_jsonl(str(path))
    assert ([dataclasses.asdict(s) for s in got]
            == [dataclasses.asdict(s) for s in want])
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"video": "a.mp4"}\n')
    assert outcome(tqa.load_jsonl, str(bad)) == outcome(jqa.load_jsonl,
                                                        str(bad))


@pytest.mark.parametrize("env", [
    {}, {"QV_RANK": "1", "QV_WORLD": "3"}, {"RANK": "2", "WORLD_SIZE": "4"},
    {"QV_RANK": "0", "RANK": "3", "WORLD_SIZE": "4"},
])
def test_shard_samples_agrees(env, monkeypatch):
    for k in ("QV_RANK", "QV_WORLD", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    samples = list(range(11))
    assert tqa.shard_samples(samples) == jqa.shard_samples(samples)
    for rank, world in itertools.product(range(3), (1, 3)):
        assert tqa.shard_samples(samples, rank, world) == jqa.shard_samples(
            samples, rank, world)


def test_run_qa_eval_agrees_on_a_stub():
    """run_qa_eval over the same stub model (its answers and the
    accuracy), and the package's exports."""
    answers = iter(["A", "The answer is B", "(c)", "no idea"] * 2)

    class Stub:
        def generate(self, prompt, video, max_new_tokens=16):
            return [next(answers)]

    def samples(mod):
        return [mod.QASample(f"{i}.mp4", "q", ["a", "b", "c"], "ABCA"[i])
                for i in range(4)]

    want = jqa.run_qa_eval(Stub(), samples(jqa))
    got = tqa.run_qa_eval(Stub(), samples(tqa))
    assert got == want and got["accuracy"] == 0.5
    from quickvideo_tpu import evaluation as jev
    from quickvideo_tpu_torch import evaluation as tev

    assert {n for n in dir(tev) if not n.startswith("_")} >= {
        n for n in dir(jev) if not n.startswith("_") and n != "qa"}


def _cache_plans():
    """Pairs of (JAX plan, port plan) from the same arguments: up to the
    source, down to the pixel budget, and by fps."""
    out = []
    for total, fps, h, w, kw in (
        (96, 24.0, 300, 330, dict(nframes=8)),
        (2400, 30.0, 1080, 1920, dict(nframes=64)),
        (3600, 30.0, 480, 854, dict(nframes=None, fps=2.0)),
    ):
        args = dict(total_frames=total, video_fps=fps, height=h, width=w,
                    video_group_size=4, **kw)
        out.append((jpp.plan_video(**args), tpp.plan_video(**args)))
    return out


@pytest.mark.parametrize("native_hw", [None, (480, 854)])
def test_frame_cache_keys_agree(native_hw):
    for jplan, tplan in _cache_plans():
        for path in ("/videos/a.mp4", "clip.mkv"):
            assert (tfc.cache_key(path, tplan, native_hw)
                    == jfc.cache_key(path, jplan, native_hw))
    assert tfc.default_cache_dir() == jfc.default_cache_dir()


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("layout", ["rgb", "yuv420"])
def test_frame_cache_entries_load_across_packages(tmp_path, writer, layout):
    """An entry written by one package loads in the other with equal
    frames and the same meta file; a plan of another shape misses, and a
    stale entry (frames of the wrong shape) reads as a miss on both."""
    (jplan, tplan), (jother, tother) = _cache_plans()[:2]
    h, w = jplan.resized_height, jplan.resized_width
    rng = np.random.default_rng(0)
    shape = ((jplan.nframes, 3, h, w) if layout == "rgb"
             else (jplan.nframes, h * w * 3 // 2))
    frames = rng.integers(0, 256, shape, dtype=np.uint8)
    save, load = ((jfc.save, tfc.load) if writer == "jax"
                  else (tfc.save, jfc.load))
    d = save("clip.mp4", jplan if writer == "jax" else tplan, frames,
             str(tmp_path))
    got = load("clip.mp4", tplan if writer == "jax" else jplan,
               str(tmp_path))
    np.testing.assert_array_equal(np.asarray(got), frames)
    meta = json.loads((d / "meta.json").read_text())
    d2 = (jfc.save if writer == "port" else tfc.save)(
        "clip.mp4", jplan if writer == "port" else tplan, frames,
        str(tmp_path / "other"))
    assert json.loads((d2 / "meta.json").read_text()) == meta
    for mod, plan in ((jfc, jother), (tfc, tother)):
        assert mod.load("clip.mp4", plan, str(tmp_path)) is None
    np.save(d / "frames.npy", frames[:2])
    for mod, plan in ((jfc, jplan), (tfc, tplan)):
        assert mod.load("clip.mp4", plan, str(tmp_path)) is None
