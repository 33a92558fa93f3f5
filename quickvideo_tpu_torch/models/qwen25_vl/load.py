"""Safetensors checkpoint -> the port's parameter state.

Counterpart of quickvideo_tpu/models/qwen25_vl/load.py:21-130
(`_normalize_key`, `params_from_state_dict`, `load_params`). Both HF key
layouts load: the modern one (`model.language_model.*` / `model.visual.*`,
transformers >= 4.52) and the legacy one (`model.*` / `visual.*`); with
`tie_word_embeddings` the head is the embedding's transpose. The tree is
the port's (convert.py): per-layer lists, matrices in the JAX (in, out)
layout, contiguous.

The `safetensors` package is not needed: `SafetensorsFile` reads the
format itself (an 8-byte little-endian header length, a JSON header, then
the raw tensors; BF16, F16 and F32). Each shard is memory-mapped and each
leaf is copied from the mapping straight to `device` as it is needed, so a
shard never sits in host memory as a second copy and the tree is never
stacked on the host. A truncated or malformed file raises ValueError.
`load_params_sharded` (a mesh) is not ported.
"""

from __future__ import annotations

import json
import math
import mmap
import os
import struct
from typing import Callable, Dict, Mapping

import numpy as np
import torch

from quickvideo_tpu_torch.models.qwen25_vl.config import ModelConfig

DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32}


def _normalize_key(k: str) -> str:
    for pre, post in (
        ("model.language_model.", "language."),
        ("model.visual.", "visual."),
        ("model.layers.", "language.layers."),
        ("model.embed_tokens.", "language.embed_tokens."),
        ("model.norm.", "language.norm."),
        ("visual.", "visual."),
        ("lm_head.", "lm_head."),
        ("language_model.", "language."),
    ):
        if k.startswith(pre):
            return post + k[len(pre):]
    return k


class SafetensorsFile:
    """One .safetensors file: its header is read and checked at once; a
    tensor is read through a private memory map of the file. Use as a
    context manager (or call `close`): tensors from `tensor` view the map
    and must be copied before it closes."""

    def __init__(self, path: str):
        self.path = path
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            raw = f.read(8)
            if len(raw) < 8:
                raise ValueError(
                    f"{path}: truncated safetensors file ({size} bytes, no "
                    "header length)"
                )
            (n,) = struct.unpack("<Q", raw)
            if n > size - 8:
                raise ValueError(
                    f"{path}: truncated safetensors file (header of {n} "
                    f"bytes, {size - 8} after the length)"
                )
            try:
                header = json.loads(f.read(n))
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                raise ValueError(f"{path}: malformed safetensors header: {e}")
        if not isinstance(header, dict):
            raise ValueError(f"{path}: malformed safetensors header")
        header.pop("__metadata__", None)
        self._base = 8 + n
        data_len = size - self._base
        self.entries = {}
        for name, e in header.items():
            try:
                dtype = DTYPES[e["dtype"]]
                shape = tuple(int(d) for d in e["shape"])
                begin, end = (int(o) for o in e["data_offsets"])
            except KeyError as err:
                raise ValueError(
                    f"{path}: tensor {name!r}: unsupported or missing "
                    f"{err} (dtypes {sorted(DTYPES)})"
                ) from None
            except (TypeError, ValueError):
                raise ValueError(f"{path}: tensor {name!r}: malformed entry "
                                 f"{e!r}") from None
            nbytes = math.prod(shape) * dtype.itemsize
            if not 0 <= begin <= end or end - begin != nbytes:
                raise ValueError(
                    f"{path}: tensor {name!r}: offsets {begin}..{end} do not "
                    f"hold shape {shape} of {e['dtype']}"
                )
            if end > data_len:
                raise ValueError(
                    f"{path}: truncated safetensors file: tensor {name!r} "
                    f"ends at byte {end} of {data_len} data bytes"
                )
            self.entries[name] = (dtype, shape, begin, end)
        self._map = None

    def keys(self):
        return self.entries.keys()

    def tensor(self, name: str) -> torch.Tensor:
        """A CPU tensor over the mapped bytes of `name` (no copy)."""
        dtype, shape, begin, end = self.entries[name]
        if end == begin:
            return torch.empty(shape, dtype=dtype)
        if self._map is None:
            with open(self.path, "rb") as f:
                # copy-on-write: writable for torch.frombuffer, never written
                self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        off = self._base + begin
        buf = self._map
        if off % dtype.itemsize:  # the format does not promise alignment
            buf, off = bytearray(self._map[off : self._base + end]), 0
        t = torch.frombuffer(buf, dtype=dtype, count=(end - begin)
                             // dtype.itemsize, offset=off)
        return t.view(shape)

    def close(self):
        if self._map is not None:
            self._map.close()
            self._map = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _as_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def params_from_fetch(
    fetch: Callable[[str], torch.Tensor], cfg: ModelConfig,
    dtype=torch.bfloat16, device="cpu",
) -> dict:
    """The port's tree from `fetch(normalized name)` -> a tensor in the HF
    (out, in) layout. Each leaf is copied to `device` and `dtype` as it is
    fetched (a matrix is transposed there)."""
    t, v = cfg.text, cfg.vision

    def leaf(name, transpose=False, reshape=None):
        x = fetch(name)
        if reshape is not None:
            x = x.reshape(reshape)
        # a copy, also on the CPU: the fetched tensor may view a file map
        x = x.to(device=device, dtype=dtype, copy=True)
        return x.t().contiguous() if transpose else x

    def lang_layer(i):
        pre = f"language.layers.{i}."
        out = {
            "ln1": leaf(pre + "input_layernorm.weight"),
            "ln2": leaf(pre + "post_attention_layernorm.weight"),
        }
        for name in ("q", "k", "v"):
            out[f"w{name}"] = leaf(pre + f"self_attn.{name}_proj.weight", True)
            out[f"b{name}"] = leaf(pre + f"self_attn.{name}_proj.bias")
        out["wo"] = leaf(pre + "self_attn.o_proj.weight", True)
        for name, hf in (("wg", "gate"), ("wu", "up"), ("wd", "down")):
            out[name] = leaf(pre + f"mlp.{hf}_proj.weight", True)
        return out

    def vision_block(i):
        pre = f"visual.blocks.{i}."
        out = {"ln1": leaf(pre + "norm1.weight"),
               "ln2": leaf(pre + "norm2.weight")}
        for name, hf in (("qkv", "attn.qkv"), ("o", "attn.proj"),
                         ("g", "mlp.gate_proj"), ("u", "mlp.up_proj"),
                         ("d", "mlp.down_proj")):
            out[f"w{name}"] = leaf(pre + hf + ".weight", True)
            out[f"b{name}"] = leaf(pre + hf + ".bias")
        return out

    language = {
        "embed": leaf("language.embed_tokens.weight"),
        "layers": [lang_layer(i) for i in range(t.num_hidden_layers)],
        "norm": leaf("language.norm.weight"),
        "lm_head": leaf(
            "language.embed_tokens.weight" if t.tie_word_embeddings
            else "lm_head.weight", True,
        ),
    }
    vision = {
        "patch_embed": leaf("visual.patch_embed.proj.weight", True,
                            reshape=(v.hidden_size, -1)),
        "blocks": [vision_block(i) for i in range(v.depth)],
        "merger": {
            "ln_q": leaf("visual.merger.ln_q.weight"),
            "w1": leaf("visual.merger.mlp.0.weight", True),
            "b1": leaf("visual.merger.mlp.0.bias"),
            "w2": leaf("visual.merger.mlp.2.weight", True),
            "b2": leaf("visual.merger.mlp.2.bias"),
        },
    }
    return {"language": language, "vision": vision}


def _missing(name, have):
    return KeyError(f"missing weight {name!r}; have e.g. {sorted(have)[:8]}")


def params_from_state_dict(
    state: Mapping, cfg: ModelConfig, dtype=torch.bfloat16, device="cpu",
) -> dict:
    """A flat HF state dict (tensors or numpy arrays) -> the port's tree."""
    state = {_normalize_key(k): v for k, v in state.items()}

    def fetch(name):
        if name not in state:
            raise _missing(name, state)
        return _as_tensor(state[name])

    return params_from_fetch(fetch, cfg, dtype, device)


def load_params(model_dir: str, cfg: ModelConfig, dtype=torch.bfloat16,
                device="cpu") -> dict:
    """Every *.safetensors shard of an HF snapshot directory, read leaf by
    leaf onto `device`."""
    shards = sorted(
        f for f in os.listdir(model_dir) if f.endswith(".safetensors")
    )
    if not shards:
        raise FileNotFoundError(f"no safetensors in {model_dir}")
    files = []
    try:
        index: Dict[str, tuple] = {}
        for shard in shards:
            f = SafetensorsFile(os.path.join(model_dir, shard))
            files.append(f)
            for k in f.keys():
                index[_normalize_key(k)] = (f, k)

        def fetch(name):
            if name not in index:
                raise _missing(name, index)
            f, key = index[name]
            return f.tensor(key)

        return params_from_fetch(fetch, cfg, dtype, device)
    finally:
        for f in files:
            f.close()
