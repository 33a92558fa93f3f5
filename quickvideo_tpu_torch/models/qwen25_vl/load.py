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

`params_from_torch_model` (load.py:259) takes a live module's state dict.
`load_params_sharded` (quickvideo_tpu/models/qwen25_vl/load.py:133) gives
a tensor-parallel rank its part of the tree (parallel/sharding.py): each
split tensor is narrowed on the file's map before it is copied, so only
the rank's slice is read and copied, and the host holds one leaf at a
time. Under pipeline parallelism a rank reads only the tensors of its
stage: its layers, the vision tower and embedding on the first stage, the
final norm and lm_head on the last (the embedding too, where lm_head is
tied to it).
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
from quickvideo_tpu_torch.ops.quantization import (
    LANG_LAYER_KEYS,
    quantize_language_params,
)
from quickvideo_tpu_torch.parallel.sharding import (
    COL,
    LANGUAGE_RULES,
    LAYER_RULES,
    ROW,
    shard_leaf,
    stage_holds,
    stage_layers,
    stage_of,
)

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
    dtype=torch.bfloat16, device="cpu", tp_rank=(0, 1), int8: bool = False,
    stage=(0, 1),
) -> dict:
    """The port's tree from `fetch(normalized name)` -> a tensor in the HF
    (out, in) layout. Each leaf is copied to `device` and `dtype` as it is
    fetched (a matrix is transposed there). `tp_rank` = (index, tp): the
    language matrices that tensor parallelism splits are narrowed to the
    rank's slice first (HF dim 0 for a column split, dim 1 for a row
    split). `int8` quantizes the language layers as they load; a row-split
    matrix is then read whole, quantized (its scales span the whole
    contraction) and sliced after. `stage` = (index, stages): only the
    stage's tensors are fetched (parallel/sharding.py::stage_params)."""
    t, v = cfg.text, cfg.vision
    tpi, tpn = tp_rank
    st, stages = stage
    late = ROW if int8 else None  # split after quantization

    def leaf(name, transpose=False, reshape=None, rule=None):
        x = fetch(name)
        if reshape is not None:
            x = x.reshape(reshape)
        if rule is not None and rule != late and tpn > 1:
            dim = 0 if rule == COL else 1
            w = x.shape[dim] // tpn
            if w * tpn != x.shape[dim]:
                raise ValueError(f"{name}: dim {dim} of {tuple(x.shape)} "
                                 f"does not split over tp={tpn}")
            x = x.narrow(dim, tpi * w, w)
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
            out[f"w{name}"] = leaf(pre + f"self_attn.{name}_proj.weight", True,
                                   rule=LAYER_RULES[f"w{name}"])
            out[f"b{name}"] = leaf(pre + f"self_attn.{name}_proj.bias",
                                   rule=LAYER_RULES[f"b{name}"])
        out["wo"] = leaf(pre + "self_attn.o_proj.weight", True,
                         rule=LAYER_RULES["wo"])
        for name, hf in (("wg", "gate"), ("wu", "up"), ("wd", "down")):
            out[name] = leaf(pre + f"mlp.{hf}_proj.weight", True,
                             rule=LAYER_RULES[name])
        if int8:
            quantize_language_params({"layers": [out]})
            for name in LANG_LAYER_KEYS:
                if LAYER_RULES[name] == late:
                    out[name] = shard_leaf(out[name], late, tpi, tpn)
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

    def holds(part, key):
        return stage_holds(part, key, st, stages)

    language = {}
    if holds("language", "embed"):
        language["embed"] = leaf("language.embed_tokens.weight")
    language["layers"] = [lang_layer(i) for i in
                          stage_layers(t.num_hidden_layers, st, stages)]
    if holds("language", "norm"):
        language["norm"] = leaf("language.norm.weight")
    if holds("language", "lm_head"):
        language["lm_head"] = leaf(
            "language.embed_tokens.weight" if t.tie_word_embeddings
            else "lm_head.weight", True, rule=LANGUAGE_RULES["lm_head"],
        )
    if not holds("vision", None):
        return {"language": language}
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


def params_from_torch_model(torch_model, cfg: ModelConfig,
                            dtype=torch.bfloat16, device="cpu") -> dict:
    """The tree of a live module whose state_dict() has HF names (a
    Qwen2_5_VLForConditionalGeneration; transformers is not imported
    here), through params_from_state_dict
    (quickvideo_tpu/models/qwen25_vl/load.py:259)."""
    state = {k: v.detach().to("cpu").float()
             for k, v in torch_model.state_dict().items()}
    return params_from_state_dict(state, cfg, dtype, device)


def load_params(model_dir: str, cfg: ModelConfig, dtype=torch.bfloat16,
                device="cpu", tp_rank=(0, 1), int8: bool = False,
                stage=(0, 1)) -> dict:
    """Every *.safetensors shard of an HF snapshot directory, read leaf by
    leaf onto `device` (`tp_rank`, `int8`, `stage`: see params_from_fetch;
    the rest of the tree is quantized by ops/quantization.py's
    quantize_model_params, which keeps the quantized leaves)."""
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

        return params_from_fetch(fetch, cfg, dtype, device, tp_rank, int8,
                                 stage)
    finally:
        for f in files:
            f.close()


def load_params_sharded(model_dir: str, cfg: ModelConfig, mesh,
                        dtype=torch.bfloat16, device=None,
                        int8: bool = False) -> dict:
    """This rank's part of a checkpoint directory: its pipeline stage's
    tensors, tensor-parallel slices of them (module docstring), on
    `device` (default the mesh's)."""
    return load_params(
        model_dir, cfg, dtype, mesh.device if device is None else device,
        tp_rank=(mesh.index("tp"), mesh.tp), int8=int8,
        stage=stage_of(mesh),
    )
