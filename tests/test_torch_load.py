"""Checkpoint loading in the PyTorch port against the JAX package's loader:
a tiny safetensors checkpoint written here (safetensors.torch.save_file, or
the port's own writer) loads into the same tree, bit for bit, in both HF key
layouts and with tied embeddings; LVU(dir) generates the JAX LVU(dir)'s
tokens; a malformed file raises."""

import dataclasses
import functools
import json
import os
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quickvideo_tpu.api import LVU as JLVU
from quickvideo_tpu.config import LVUConfig as JLVUConfig
from quickvideo_tpu.models.qwen25_vl import get_config as jget_config
from quickvideo_tpu.models.qwen25_vl.load import load_params as jload_params
from quickvideo_tpu_torch.api import LVU
from quickvideo_tpu_torch.config import LVUConfig
from quickvideo_tpu_torch.models.qwen25_vl.config import get_config
from quickvideo_tpu_torch.models.qwen25_vl.convert import (
    init_params,
    params_from_jax,
)
from quickvideo_tpu_torch.models.qwen25_vl.load import (
    SafetensorsFile,
    load_params,
    params_from_state_dict,
)
from quickvideo_tpu_torch.ops.quantization import quantize_model_params
from quickvideo_tpu_torch.testing import (
    hf_config,
    hf_state_dict,
    write_checkpoint,
)

torch.set_num_threads(2)

TINY = get_config("tiny")


def _tiny(tied: bool):
    return dataclasses.replace(TINY, text=dataclasses.replace(
        TINY.text, tie_word_embeddings=tied))


def save_hf_checkpoint(directory, layout, tied, dtype, seed=0):
    """A tiny checkpoint written by the safetensors package, over two
    shards. Returns the config the directory describes."""
    from safetensors.torch import save_file

    cfg = _tiny(tied)
    params = init_params(cfg, seed, torch.float32)
    if tied:
        params["language"]["lm_head"] = params["language"]["embed"].t()
    state = {k: t.to(dtype) for k, t in
             hf_state_dict(params, cfg, layout).items()}
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(hf_config(cfg), f)
    names = sorted(state)
    for i, part in enumerate((names[::2], names[1::2])):
        save_file({k: state[k] for k in part},
                  os.path.join(directory, f"model-{i}.safetensors"))
    return cfg


def assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_trees_equal(x, y, f"{path}[{i}]")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                           b.dtype)
        assert torch.equal(a, b), path
        # float leaves are contiguous (in, out); int8 codes keep their
        # column-major layout
        assert a.is_contiguous() or a.dtype == torch.int8, path


@pytest.mark.parametrize("file_dtype,load_dtype", [
    (torch.float32, "float32"), (torch.bfloat16, "bfloat16"),
    (torch.bfloat16, "float32"), (torch.float16, "float32"),
    (torch.float32, "bfloat16"),
])
@pytest.mark.parametrize("layout,tied", [
    ("modern", False), ("legacy", False), ("modern", True),
])
def test_loaded_tree_equals_the_jax_loaders(tmp_path, layout, tied,
                                            file_dtype, load_dtype):
    save_hf_checkpoint(str(tmp_path), layout, tied, file_dtype)
    jcfg = jget_config(str(tmp_path))
    cfg = get_config(str(tmp_path))
    assert cfg.text.tie_word_embeddings == tied
    want = params_from_jax(jax.tree.map(np.asarray, jload_params(
        str(tmp_path), jcfg, getattr(jnp, load_dtype)
    )))
    got = load_params(str(tmp_path), cfg, getattr(torch, load_dtype))
    assert_trees_equal(got, want)


def test_state_dict_and_own_writer_give_the_same_tree(tmp_path):
    """params_from_state_dict (tensors or numpy arrays) and a checkpoint
    from the port's writer both give the tree the state came from."""
    params = init_params(TINY, 3, torch.float32)
    state = hf_state_dict(params, TINY)
    assert_trees_equal(params_from_state_dict(state, TINY, torch.float32),
                       params)
    as_np = {k: t.numpy() for k, t in state.items()}
    assert_trees_equal(params_from_state_dict(as_np, TINY, torch.float32),
                       params)
    d = write_checkpoint(str(tmp_path), params, TINY, "legacy", shards=3)
    assert_trees_equal(load_params(d, get_config(d), torch.float32), params)
    # the port's files are valid for the safetensors package too
    from safetensors.torch import load_file

    state = hf_state_dict(params, TINY, "legacy")
    files = sorted(f for f in os.listdir(d) if f.endswith(".safetensors"))
    merged = {}
    for f in files:
        merged.update(load_file(os.path.join(d, f)))
    assert set(merged) == set(state)
    for k, t in merged.items():
        assert torch.equal(t, state[k]), k


def test_missing_weight_raises(tmp_path):
    params = init_params(TINY, 0, torch.float32)
    state = hf_state_dict(params, TINY)
    del state["model.language_model.layers.1.mlp.up_proj.weight"]
    with pytest.raises(KeyError, match="layers.1.mlp.up_proj"):
        params_from_state_dict(state, TINY)
    with pytest.raises(FileNotFoundError):
        load_params(str(tmp_path), TINY)


def _write_raw(path, header: bytes, data: bytes, n=None):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(header) if n is None else n))
        f.write(header)
        f.write(data)


@pytest.mark.parametrize("case", [
    "short", "header_past_end", "bad_json", "not_a_dict", "dtype",
    "shape_mismatch", "data_past_end",
])
def test_malformed_file_raises(tmp_path, case):
    path = str(tmp_path / "m.safetensors")
    ok = {"w": {"dtype": "F32", "shape": [2, 3], "data_offsets": [0, 24]}}
    data = bytes(24)
    if case == "short":
        open(path, "wb").write(b"\x10\x00")
    elif case == "header_past_end":
        _write_raw(path, json.dumps(ok).encode(), data, n=10_000)
    elif case == "bad_json":
        _write_raw(path, b"{not json", data)
    elif case == "not_a_dict":
        _write_raw(path, b"[1, 2]", data)
    elif case == "dtype":
        _write_raw(path, json.dumps({"w": {**ok["w"], "dtype": "I64"}})
                   .encode(), data)
    elif case == "shape_mismatch":
        _write_raw(path, json.dumps({"w": {**ok["w"], "shape": [4, 3]}})
                   .encode(), data)
    else:  # the data stops before the last tensor does
        _write_raw(path, json.dumps(ok).encode(), data[:20])
    with pytest.raises(ValueError, match="safetensors|tensor 'w'"):
        SafetensorsFile(path)


def test_truncated_shard_raises_through_lvu(tmp_path):
    params = init_params(TINY, 0, torch.float32)
    d = write_checkpoint(str(tmp_path), params, TINY, shards=2)
    shard = os.path.join(d, sorted(os.listdir(d))[-1])
    size = os.path.getsize(shard)
    with open(shard, "r+b") as f:
        f.truncate(size - 5)
    with pytest.raises(ValueError, match="truncated"):
        LVU(LVUConfig(model_name_or_path=d, dtype="float32"), device="cpu")


def test_unaligned_tensor_reads_right(tmp_path):
    """The format does not promise aligned tensors: a 2-byte one before an
    f32 one leaves it off its alignment."""
    path = str(tmp_path / "u.safetensors")
    a = torch.tensor([1.5], dtype=torch.float16)
    b = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    header = {"a": {"dtype": "F16", "shape": [1], "data_offsets": [0, 2]},
              "b": {"dtype": "F32", "shape": [2, 3], "data_offsets": [2, 26]}}
    _write_raw(path, json.dumps(header).encode(),
               a.view(torch.uint8).numpy().tobytes()
               + b.view(torch.uint8).numpy().tobytes())
    with SafetensorsFile(path) as f:
        assert torch.equal(f.tensor("a"), a)
        assert torch.equal(f.tensor("b"), b)


@pytest.fixture
def fake_video(monkeypatch):
    """Both packages' whole-video decoder replaced by the seeded fake of
    tests/test_torch_engine.py."""
    from quickvideo_tpu.video import reader as jreader
    from quickvideo_tpu_torch.video import reader as treader
    from test_torch_engine import _fake_decode_video_batch

    for mod in (jreader, treader):
        monkeypatch.setattr(mod, "decode_video_batch", functools.partial(
            _fake_decode_video_batch, mod.plan_from_reader
        ))
    monkeypatch.setenv("QV_COMPILE_CACHE", "0")


@pytest.mark.parametrize("layout,tied", [("modern", False), ("legacy", True)])
def test_lvu_from_a_directory_generates_the_jax_tokens(tmp_path, fake_video,
                                                        layout, tied):
    save_hf_checkpoint(str(tmp_path), layout, tied, torch.float32, seed=2)
    kw = dict(model_name_or_path=str(tmp_path), model_type="qwen25_lvu",
              num_frames=8, video_group_size=4, top_p=0.5,
              max_decode_tokens=8, decode_output="yuv420", dtype="float32")
    jlvu = JLVU(JLVUConfig(**kw))
    want = jlvu.generate("what moves?", "clip.mp4", max_new_tokens=5)
    lvu = LVU(LVUConfig(**kw), device="cpu")
    assert lvu.generate("what moves?", "clip.mp4", max_new_tokens=5) == want
    np.testing.assert_array_equal(lvu.last_result.tokens,
                                  jlvu.last_result.tokens)


def test_int8_load_equals_the_quantized_tree(tmp_path, monkeypatch):
    """param_dtype="int8": the loaded tree quantized, as the port quantizes
    a float tree (QV_VISION_2D=0: no B4 weight prep on top)."""
    monkeypatch.setenv("QV_VISION_2D", "0")
    d = write_checkpoint(str(tmp_path), init_params(TINY, 4, torch.float32),
                         TINY)
    lvu = LVU(LVUConfig(model_name_or_path=d, dtype="float32",
                        param_dtype="int8"), device="cpu")
    want = quantize_model_params(load_params(d, get_config(d), torch.float32))
    assert_trees_equal(lvu.params, want)
