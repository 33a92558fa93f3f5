"""Fixtures of the benchmark's tests: a tiny cell in a temporary checkout.

These tests import nothing of JAX. Run them from the repository's root:

    python -m pytest -p no:cacheprovider qvbench/tests

Tests marked `cuda` need the card and skip without one (the decision is
taken inside the `card` fixture).
"""

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
TINY = "tiny-f32"
TINY_CELL = f"{TINY}.clip8"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's kernels)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def tiny_config(param_dtype="float32", dtype="float32"):
    """The port's `tiny` test sizes as a Qwen2.5-VL config.json."""
    return {
        "hidden_size": 48, "intermediate_size": 96, "num_hidden_layers": 3,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "vocab_size": 1024, "rms_norm_eps": 1e-6, "rope_theta": 1e6,
        "tie_word_embeddings": False,
        "rope_scaling": {"type": "mrope", "mrope_section": [2, 2, 2]},
        "image_token_id": 1001, "video_token_id": 1002,
        "vision_start_token_id": 1003, "vision_end_token_id": 1004,
        "vision_config": {
            "depth": 4, "hidden_size": 32, "intermediate_size": 64,
            "num_heads": 4, "in_chans": 3, "out_hidden_size": 48,
            "patch_size": 14, "spatial_merge_size": 2,
            "temporal_patch_size": 2, "window_size": 112,
            "fullatt_block_indexes": [1, 3], "tokens_per_second": 2,
        },
        "qvbench": {"dtype": dtype, "param_dtype": param_dtype,
                    "kv_cache_dtype": "auto"},
    }


def narrow_config(param_dtype="int8", dtype="bfloat16"):
    """Two decoder layers at head_dim 128 (7 q heads, 1 kv head) and two
    vision blocks at head_dim 80: the smallest model the port's card
    kernels take (chip_smoke.py::narrow_config)."""
    return {
        "hidden_size": 896, "intermediate_size": 1024, "num_hidden_layers": 2,
        "num_attention_heads": 7, "num_key_value_heads": 1,
        "vocab_size": 2048, "rms_norm_eps": 1e-6, "rope_theta": 1e6,
        "tie_word_embeddings": False,
        "rope_scaling": {"type": "mrope", "mrope_section": [16, 24, 24]},
        "image_token_id": 2040, "video_token_id": 2041,
        "vision_start_token_id": 2042, "vision_end_token_id": 2043,
        "vision_config": {
            "depth": 2, "hidden_size": 160, "intermediate_size": 256,
            "num_heads": 2, "in_chans": 3, "out_hidden_size": 896,
            "patch_size": 14, "spatial_merge_size": 2,
            "temporal_patch_size": 2, "window_size": 112,
            "fullatt_block_indexes": [1], "tokens_per_second": 2,
        },
        "qvbench": {"dtype": dtype, "param_dtype": param_dtype,
                    "kv_cache_dtype": "auto"},
    }


TINY_MIX = {
    "loop": "closed", "clients": 1,
    "video": {"frames": 8, "fps": 2.0, "height": 336, "width": 336},
    "question_tokens": [16, 20],
    "max_new_tokens": 4,
    "lvu": {"video_group_size": 4, "num_frames": 8,
            "top_k_predict_type": "key_norms_small", "top_p": 0.5,
            "max_decode_tokens": 8, "decode_output": "yuv420",
            "prefetch_to_device": True, "resize_on_device": False},
    "check_requests": 2,
}

TINY_LIMITS = {"logit_gap": 1e-3, "kept_off_share": 1e-3,
               "length_mismatch": 0}


def make_root(tmp: Path, config=None, limits=TINY_LIMITS) -> Path:
    """A checkout in `tmp`: the repository's BENCHMARK.json and benchmark
    folder, with a tiny configuration, mix and cell added as files."""
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(REPO / "qvbench", tmp / "qvbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cdir = tmp / "qvbench" / "configs" / TINY
    cdir.mkdir()
    (cdir / "config.json").write_text(json.dumps(config or tiny_config()))
    (tmp / "qvbench" / "traffic" / "clip8.json").write_text(
        json.dumps(TINY_MIX))
    (tmp / "qvbench" / "limits" / f"{TINY_CELL}.json").write_text(
        json.dumps(limits))
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": TINY, "source": "test", "reduced": [], "why": "test",
        "file": f"qvbench/configs/{TINY}/config.json"})
    bench["workloads"].append({"name": TINY_CELL, "config": TINY,
                               "traffic": "clip8", "chips": 1,
                               "why": "test"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
