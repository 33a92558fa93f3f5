"""The frozen copies pinned to the shapes recorded on the card (PERF.md,
section 6) and to their sources' arithmetic."""

import json

import numpy as np
import pytest

from qvbench import counts, frames, roofline, template
from qvbench.spec import load_spec
from qvbench.traffic import load_mix

from conftest import REPO

SPEC_7B = REPO / "qvbench/configs/qwen25-vl-7b-int8w/config.json"


@pytest.mark.parametrize("g,length,causal,want,by", [
    (3600, 53744, True, 2.8985, "operations"),
    (3600, 53744, False, 2.8046, "operations"),
    (3600, 1807, True, 0.1883, "operations"),
])
def test_flash_bound_matches_the_recorded_bounds(g, length, causal, want, by):
    ms, kind = roofline.flash_bound(g, length, causal=causal)
    assert ms == pytest.approx(want, abs=5e-5)
    assert kind == by


def test_flash_bound_at_rep8_and_decode():
    ms, _ = roofline.flash_bound(3600, 1807, hq=16, hkv=2)
    assert ms == pytest.approx(0.1076, abs=5e-5)
    ms, kind = roofline.flash_bound(1, 57344)
    assert (round(ms, 4), kind) == (0.0351, "bytes")


def test_peaks_are_the_published_ones():
    assert roofline.HBM_BYTES_PER_S == 3.35e12
    assert roofline.PEAK_OPS_PER_S == {"bf16": 989e12, "int8": 1979e12}


def test_vision_mlp_bounds_at_the_recorded_rows():
    b3, b4 = counts.vision_mlp_bounds_s(load_spec(SPEC_7B), 14400)
    assert 1e3 * b3 == pytest.approx(0.0715, abs=5e-5)
    # the model's 3,420 columns (chip_smoke counted 3,456 padded ones:
    # 0.1288)
    assert 1e3 * b4 == pytest.approx(0.1274, abs=5e-5)


def test_request_operations_of_the_cells(tmp_path):
    """The 7B's count of a video1024 request, split by the peak each
    product is held to; served with bf16 weights the same operations all
    go to the bf16 peak."""
    mix = load_mix(REPO / "qvbench", "video1024")
    q = "q" * 24
    ops7 = counts.request_ops(load_spec(SPEC_7B), mix, q, 32)
    assert sum(ops7.values()) == pytest.approx(3.44e15, rel=0.02)
    assert ops7["bf16"] == pytest.approx(1.40e15, rel=0.02)
    raw = json.loads(SPEC_7B.read_text())
    raw["qvbench"]["param_dtype"] = "bfloat16"
    bf16 = tmp_path / "qwen25-vl-7b-bf16" / "config.json"
    bf16.parent.mkdir()
    bf16.write_text(json.dumps(raw))
    ops = counts.request_ops(load_spec(bf16), mix, q, 32)
    assert set(ops) == {"bf16"}
    assert ops["bf16"] == pytest.approx(sum(ops7.values()), rel=1e-12)


def test_group_shapes_of_the_mixes():
    spec = load_spec(SPEC_7B)
    mix = load_mix(REPO / "qvbench", "video1024")
    assert mix.group_tokens(spec) == [3600] * 32
    assert mix.patches_per_group(spec) == 14400
    rows = mix.group_rows(spec, "q" * 20)
    assert rows[0] == 3600 + len(template.prefix_ids(spec))
    assert [mix.keep(r) for r in rows[1:3]] == [1800, 1800]
    clip = load_mix(REPO / "qvbench", "clip64")
    assert clip.group_tokens(spec) == [3600, 3600]


def test_window_sizes_cover_the_grid():
    spec = load_spec(SPEC_7B)
    sizes = counts.window_sizes(spec, 16, 30, 30)
    assert sum(sizes) == 16 * 900
    assert sorted(set(sizes)) == [36, 48, 64]


def test_frames_are_fixed_by_seed_video_and_index():
    a, b = frames.FramePool(7, 1 << 20), frames.FramePool(7, 1 << 20)
    f1 = a.frames(3, [0, 5], (90,))
    assert np.array_equal(f1, b.frames(3, [0, 5], (90,)))
    assert not np.array_equal(f1, a.frames(4, [0, 5], (90,)))
    assert not np.array_equal(f1, frames.FramePool(8, 1 << 20)
                              .frames(3, [0, 5], (90,)))


def test_seeded_reader_streams_blocks_of_the_plan_size():
    pool = frames.FramePool(11, 1 << 20)
    frames.SeededReader.pool, frames.SeededReader.frames = pool, 6
    frames.SeededReader.source_hw = (28, 28)
    r = frames.SeededReader(frames.video_path(11, 2))
    assert len(r) == 6 and r.get_fps() == 2.0
    r.output_format, r.height, r.width = "YUV420", 28, 28
    r.process(range(6))
    r.frame_iter = 4
    first = next(r)
    assert first.shape == (4, 28 * 28 * 3 // 2)
    assert next(r).shape[0] == 2
    assert np.array_equal(first, pool.frames(2, range(4), (1176,)))
    with pytest.raises(StopIteration):
        next(r)


def test_question_lengths_cycle_through_the_range():
    mix = load_mix(REPO / "qvbench", "video1024")
    reqs = mix.requests(2**31 + 5)
    lengths = [len(next(reqs).question) for _ in range(17)]
    assert sorted(lengths) == list(range(16, 33))
